"""The PyTorch port's streaming path against the JAX reference.

The reference cannot be imported into this process (``repro.streaming``
needs names jax moved out of ``jax.core``; aliasing them here would change
other tests' outcomes with import order), so a module fixture runs it in a
child process (tests/torch_ref_child.py) that writes its inputs, states
and metrics to an ``.npz``.  Each chunk of each scenario is then replayed
by the port from the SAME state (carried over by
``repro_torch.convert.state_from_numpy``) and compared field by field.

Tolerances, and why:
* band, sums, counts, rho and the stage outputs: rtol 1e-5, atol 1e-5 —
  the same fp32 sums in another order;
* after a refresh (``did_refresh``) the basis comes out of Cholesky and
  ``eigh``: columns are compared after sign alignment at atol 1e-4, the
  stage outputs that depend on it at rtol/atol 1e-4, λ̂ at rtol 1e-4;
* flags and alarms: exact wherever the reconstruction error is more than
  1e-4 from ε (or the statistic more than 1e-4 relative from its
  threshold); the packet books then differ by exactly the entries allowed
  to flip, and are compared at rtol 1e-6 after that correction;
* the detector's window moments and thresholds: rtol 1e-4, and 1e-3 on
  refresh chunks (they sum squares of statistics of the refreshed basis);
* refreshes, rounds, did_refresh, liveness: exact (the data keep a margin
  from the drift threshold);
* comm_packets: rtol 1e-6, accumulated in fp32 as in the reference;
* T² where the reference's λ̂ of a component is at or below
  ``min_lambda`` (a negative Rayleigh quotient of a masked estimate,
  inverted as ``1 / min_lambda``): that component adds ``z_c² / min_lambda``
  to T², so the scores' own tolerance is propagated to it,
  ``2 sqrt(T² il_c) atol + atol² il_c``; every other component stays at
  the T² tolerance above;
* quantized scores (``score_bits=4``): a 1-ulp difference in a score can
  move ``round(z / scale)`` across a half-integer and change a code by
  one level.  Scores are compared to within one level; the codes that
  flipped are counted against a budget of ``QUANT_FLIP_BUDGET`` per chunk,
  their rows are left out of the reconstruction and flag comparisons
  (a flipped code moves x̂ by up to ``scale * |W|``), and the rest is
  compared as above.  The ε guarantee does not depend on any of this.
* the bf16 tile mode (``fused_bf16*``): both sides round the same fp32
  chunk and basis to bf16 (to nearest even) and compute in fp32, so every
  tolerance above holds unchanged; a flag is decided on the bf16-rounded
  reading, so the margin from ε is measured on that reading.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.costs as ref_costs
from repro.core.events import _norm_quantile as ref_norm_quantile
from repro.core.faults import expected_transmissions as ref_expected_tx
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import costs
from repro_torch.core.events import _norm_quantile
from repro_torch.core.faults import expected_transmissions
from repro_torch.kernels import ops
from repro_torch.streaming import (StreamConfig, batched_stream_init,
                                   batched_stream_run, chunk_stream_step,
                                   chunked_stream_run, fleet_chunk_step,
                                   fleet_round_step, stream_init, stream_run,
                                   stream_step)
from repro_torch.streaming.compressor import quantize_scores
from repro_torch.streaming.detector import (detection_packet_split,
                                            detector_init, row_liveness)
from repro_torch.streaming.driver import random_bases, tree_map
from repro_torch.streaming.online_cov import (online_init, online_update,
                                              stream_covariance)

from torch_parity import config_from_json, run_reference

ROOT = Path(__file__).resolve().parents[1]
SCENARIOS = ["fused", "fused_masked", "compress_masked", "monitor", "band",
             "band_masked", "split", "split_masked", "quant", "quant_masked",
             "fused_bf16", "fused_bf16_masked"]
ROUND_SCENARIOS = ["r_stages", "r_stages_masked", "r_band", "r_quant"]
QUANT_FLIP_BUDGET = 2
N_CHUNKS = 6
N_ROUNDS = 16
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_REFRESH = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("streaming",
                         tmp_path_factory.mktemp("ref") / "streaming.npz")


@pytest.fixture(scope="module")
def ref_rounds(tmp_path_factory):
    return run_reference("rounds",
                         tmp_path_factory.mktemp("ref") / "rounds.npz")


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


def _chunk_inputs(ref, name, c):
    K = 4
    x = torch.from_numpy(ref[f"{name}/x"][c * K:(c + 1) * K])
    masks = (torch.from_numpy(ref[f"{name}/masks"][c * K:(c + 1) * K])
             if f"{name}/masks" in ref else None)
    rv = (torch.from_numpy(ref[f"{name}/rv"][c])
          if bool(ref[f"{name}/c{c}/has_rv"]) else None)
    return x, masks, rv


def _sign_align(W_port, W_ref):
    sgn = np.sign(np.sum(W_port * W_ref, axis=0))
    sgn[sgn == 0] = 1.0
    return sgn


def _flip_budget(x, fl_p, fl_r, sink_p, sink_r, eps, margin=1e-4):
    """Entries whose flag differs must sit within ``margin`` of ε on the
    side that did not flag; returns port-minus-reference flag count."""
    diff = fl_p != fl_r
    if diff.any():
        unflagged_sink = np.where(fl_p > 0, sink_r, sink_p)
        err = np.abs(x - unflagged_sink)[diff]
        assert np.all(err > eps - margin), (err, eps)
    return float(fl_p.sum() - fl_r.sum())


def _code_flips(z_p, z_r, bits, tol):
    """Dequantized scores agree except where a code flipped by one level;
    returns the (rows,) mask of rows holding a flipped code."""
    levels = (1 << (bits - 1)) - 1
    scale = np.abs(z_r).max(0) / levels
    d = np.abs(z_p - z_r)
    flipped = d > 0.5 * scale
    assert np.all(d[flipped] <= 1.001 * scale[None, :].repeat(
        len(d), 0)[flipped]), (d[flipped], scale)
    assert flipped.sum() <= QUANT_FLIP_BUDGET, flipped.sum()
    _close(z_p[~flipped], z_r[~flipped], **tol)
    return flipped.any(-1)


def _t2_close(t2_p, t2_r, lam_r, cfg, tol):
    """T² against the reference (see the module docstring for the clamped
    components' share of the tolerance)."""
    clamped = lam_r <= cfg.detection.min_lambda
    il = 1.0 / cfg.detection.min_lambda
    t2_r = np.asarray(t2_r, np.float64)
    extra = clamped.sum() * (2 * np.sqrt(np.abs(t2_r) * il) * tol["atol"]
                             + tol["atol"] ** 2 * il)
    bound = tol["atol"] + tol["rtol"] * np.abs(t2_r) + extra
    d = np.abs(np.asarray(t2_p, np.float64) - t2_r)
    assert np.all(d <= bound), (d.max(), bound[d.argmax()])


def _plain_calls_of(cfg, masks, per_round=False):
    """The kernels one step of ``cfg`` calls, with their counts: one fold
    (chunk or round), one launch per stage and 1 + refresh_iters + 2
    banded products for the decision."""
    fold = ("band_round" if per_round else "band_fold") \
        + ("" if masks is None else "_masked")
    calls = {"banded_matmul": cfg.refresh_iters + 3}
    if cfg.use_fused and not per_round:
        kernel = ("fused_stream_bf16" if cfg.precision == "bf16"
                  else "fused_stream")
        return dict(calls, **{kernel: 1})
    calls[fold] = 1
    if cfg.compression is not None:
        calls.update(dict.fromkeys(
            ("pca_project", "pca_reconstruct") if cfg.compression.score_bits
            else ("supervised_compress",), 1))
    if cfg.detection is not None:
        calls["pca_monitor"] = 1
    return calls


def _event_budget(stat_p, thr, ev_p, ev_r, margin=1e-4):
    diff = ev_p != ev_r
    if diff.any():
        assert np.all(np.abs(stat_p[diff] - thr) <= margin * abs(thr) + 1e-6)
    return float(ev_p.sum() - ev_r.sum())


@pytest.mark.parametrize("c", range(N_CHUNKS))
@pytest.mark.parametrize("name", SCENARIOS)
def test_chunk_step_matches_reference(ref, name, c):
    cfg = config_from_json(ref[f"{name}/cfg"])
    pre = state_from_numpy(ref, device="cpu", prefix=f"{name}/c{c}/pre.")
    x, masks, rv = _chunk_inputs(ref, name, c)
    ops.reset_counts()
    new, m = chunk_stream_step(cfg, pre, x, masks, rv)
    assert _plain_calls() == _plain_calls_of(cfg, masks)
    _check_step(ref, f"{name}/c{c}", cfg, x, new, m)


def _plain_calls():
    return {k: v for k, v in ops.PLAIN_CALLS.items() if v}


def _check_step(ref, key, cfg, x, new, m):
    """One step of the port (state ``new``, metrics ``m`` on inputs
    ``x``) against the reference's step under ``key`` (``{name}/c{i}``
    or ``{name}/r{i}``), field by field, at the tolerances of the module
    docstring."""
    got = state_to_numpy(new)
    post = lambda k: ref[f"{key}/post.{k}"]
    met = lambda k: ref[f"{key}/m.{k}"]

    fired = bool(met("did_refresh"))
    assert bool(m.did_refresh) == fired
    assert int(m.refreshes) == int(met("refreshes"))
    for k in ("rounds", "sched.refreshes", "alive"):
        np.testing.assert_array_equal(got[k], post(k))
    for k in ("cov.t", "cov.s", "cov.band", "cov.t_band"):
        _close(got[k], post(k))
    _close(m.rho, met("rho"))
    W_p, W_r = got["sched.W"], post("sched.W")
    sgn = _sign_align(W_p, W_r)
    _close(W_p * sgn, W_r, **(TOL_REFRESH if fired else dict(rtol=0, atol=0)))
    _close(got["sched.lam"], post("sched.lam"), rtol=1e-4, atol=1e-6)
    _close(got["sched.rho_ref"], post("sched.rho_ref"))
    tol = TOL_REFRESH if fired else TOL

    d_extra = d_alarms = 0.0
    if cfg.compression is not None:
        xv = x.reshape(-1, cfg.p).numpy()
        cp = m.compression
        bits = cfg.compression.score_bits
        z_p = cp.z.numpy() * sgn[None, :]
        ok = np.ones(len(xv), bool)
        if bits:
            ok = ~_code_flips(z_p, met("compression.z"), bits, tol)
        else:
            _close(z_p, met("compression.z"), **tol)
        fl_p, fl_r = cp.flagged.numpy(), met("compression.flagged")
        sink_p, sink_r = cp.x_sink.numpy(), met("compression.x_sink")
        # the reading the flag was decided on: bf16-rounded in that mode
        x_dec = (torch.from_numpy(xv).to(torch.bfloat16).float().numpy()
                 if cfg.use_fused and cfg.precision == "bf16" else xv)
        _flip_budget(x_dec[ok], fl_p[ok], fl_r[ok], sink_p[ok], sink_r[ok],
                     cfg.compression.epsilon)
        d_extra = float(fl_p.sum() - fl_r.sum())
        same = (fl_p == fl_r) & ok[:, None]
        _close(sink_p[same], sink_r[same], **tol)
        _close(float(cp.extra_packets) - d_extra,
               met("compression.extra_packets"), rtol=1e-6, atol=0)
        for k in ("score_packets", "feedback_packets"):
            _close(getattr(cp, k), met(f"compression.{k}"), rtol=1e-6)
        _close(float(cp.bits_on_air)
               - d_extra * cfg.compression.word_bits,
               met("compression.bits_on_air"), rtol=1e-6)
        if d_extra == 0 and ok.all():
            _close(cp.max_err, met("compression.max_err"), **tol)
    if cfg.detection is not None:
        dt = m.detection
        _t2_close(dt.t2, met("detection.t2"), post("sched.lam"), cfg, tol)
        _close(dt.spe, met("detection.spe"), **tol)
        thr_t2 = float(met("detection.t2_threshold"))
        thr_spe = float(met("detection.spe_threshold"))
        _close(dt.t2_threshold, thr_t2, rtol=1e-4)   # set before this chunk
        _close(dt.spe_threshold, thr_spe, rtol=1e-4)
        assert bool(dt.calibrating) == bool(met("detection.calibrating"))
        ev_p, ev_r = dt.events.numpy(), met("detection.events")
        diff = ev_p != ev_r
        if diff.any():
            rel = lambda s, thr: np.abs(s[diff] - thr) / abs(thr)
            near = np.minimum(rel(dt.t2.numpy(), thr_t2),
                              rel(dt.spe.numpy(), thr_spe))
            assert np.all(near <= 1e-4), near
        d_alarms = float(ev_p.sum() - ev_r.sum())
        _close(float(dt.alarms) - d_alarms, met("detection.alarms"),
               rtol=1e-6, atol=0)
        for k in ("t2_threshold", "spe_threshold", "t2_sum", "spe_sum",
                  "t2_sumsq", "spe_sumsq", "count"):
            # squares of statistics of a refreshed basis: the eigh-level
            # differences of z enter twice (rtol 1e-3 on refresh chunks)
            _close(got[f"det.{k}"], post(f"det.{k}"),
                   rtol=1e-3 if fired else 1e-4, atol=1e-5)
        np.testing.assert_array_equal(got["det.calib_left"],
                                      post("det.calib_left"))
    _, per_alarm = (detection_packet_split(cfg.q, cfg.c_max)
                    if cfg.detection is not None else (0.0, 0.0))
    factor = expected_transmissions(cfg.link_loss, cfg.max_retries)
    _close(float(m.comm_packets) - (d_extra + d_alarms * per_alarm) * factor,
           met("comm_packets"), rtol=1e-6, atol=0)


def test_scenarios_cover_refreshes_flags_and_alarms(ref):
    """The data exercise what the comparisons claim to cover: drift and
    churn refreshes beyond the first, flagged readings and alarms."""
    fired = {n: [bool(ref[f"{n}/c{c}/m.did_refresh"])
                 for c in range(N_CHUNKS)] for n in SCENARIOS}
    assert all(sum(v) >= 2 for v in fired.values()), fired
    for n in ("fused", "split", "split_masked", "quant", "quant_masked",
              "fused_bf16", "fused_bf16_masked"):
        assert sum(float(ref[f"{n}/c{c}/m.compression.extra_packets"])
                   for c in range(N_CHUNKS)) > 0, n
    assert ref["fused/c5/m.compression.extra_packets"] > 0
    for names in (("fused", "fused_masked", "monitor"),
                  ("split", "split_masked", "quant")):
        total_alarms = sum(float(ref[f"{n}/c{c}/m.detection.alarms"])
                           for n in names for c in range(N_CHUNKS))
        assert total_alarms > 0, names


@pytest.mark.parametrize("name", ["fused", "fused_masked", "band_masked",
                                  "split", "split_masked", "quant",
                                  "quant_masked", "fused_bf16",
                                  "fused_bf16_masked"])
def test_whole_run_matches_reference(ref, name):
    """``chunked_stream_run`` from the reference's initial state over the
    whole stream, against the reference's chunk-by-chunk trajectory."""
    cfg = config_from_json(ref[f"{name}/cfg"])
    st = state_from_numpy(ref, device="cpu", prefix=f"{name}/c0/pre.")
    R = int(ref[f"{name}/rv"].sum())
    xs = torch.from_numpy(ref[f"{name}/x"][:R])
    masks = (torch.from_numpy(ref[f"{name}/masks"][:R])
             if f"{name}/masks" in ref else None)
    new, m = chunked_stream_run(cfg, st, xs, masks, chunk=4)
    last = N_CHUNKS - 1
    np.testing.assert_array_equal(
        m.did_refresh.numpy(),
        [bool(ref[f"{name}/c{c}/m.did_refresh"]) for c in range(N_CHUNKS)])
    np.testing.assert_array_equal(
        m.refreshes.numpy(),
        [int(ref[f"{name}/c{c}/m.refreshes"]) for c in range(N_CHUNKS)])
    _close(m.rho.numpy(),
           [float(ref[f"{name}/c{c}/m.rho"]) for c in range(N_CHUNKS)],
           rtol=1e-4, atol=1e-5)
    _close(m.comm_packets.numpy(),
           [float(ref[f"{name}/c{c}/m.comm_packets"])
            for c in range(N_CHUNKS)], rtol=1e-6)
    assert int(new.rounds) == int(ref[f"{name}/c{last}/post.rounds"]) == R
    _close(new.cov.band, ref[f"{name}/c{last}/post.cov.band"], rtol=1e-4,
           atol=1e-4)


def test_fleet_step_is_per_network_step(ref):
    """One fleet step over three networks equals three single-network
    steps: the slot axis adds nothing (floats at rtol/atol 1e-5 — batched
    and single products may sum in another order — the rest exactly)."""
    name = "fused_masked"
    cfg = config_from_json(ref[f"{name}/cfg"])
    states = [state_from_numpy(ref, device="cpu", prefix=f"{name}/c{c}/pre.")
              for c in (1, 3, 5)]
    ins = [_chunk_inputs(ref, name, c) for c in (1, 3, 5)]
    rvs = [torch.ones(4) if rv is None else rv for _, _, rv in ins]
    fleet = tree_map(lambda *a: torch.stack(a), *states)
    new, m = fleet_chunk_step(cfg, fleet, torch.stack([i[0] for i in ins]),
                              torch.stack([i[1] for i in ins]),
                              torch.stack(rvs))
    def same(a, b):
        tol = TOL if a.is_floating_point() else dict(rtol=0, atol=0)
        torch.testing.assert_close(a[s], b, **tol)

    for s, (st, (x, mk, _)) in enumerate(zip(states, ins)):
        one, m1 = chunk_stream_step(cfg, st, x, mk, rvs[s])
        tree_map(same, new, one)
        tree_map(same, m, m1)


def test_refresh_select_keeps_quiet_slots_unchanged(ref):
    """A slot whose scheduler does not fire keeps its basis, λ̂ and
    ρ_ref exactly while another slot of the same step refreshes."""
    name = "fused"
    cfg = config_from_json(ref[f"{name}/cfg"])
    fires = [c for c in range(N_CHUNKS)
             if bool(ref[f"{name}/c{c}/m.did_refresh"])]
    quiet = [c for c in range(N_CHUNKS)
             if not bool(ref[f"{name}/c{c}/m.did_refresh"])]
    cs = (fires[-1], quiet[-1])
    states = [state_from_numpy(ref, device="cpu", prefix=f"{name}/c{c}/pre.")
              for c in cs]
    fleet = tree_map(lambda *a: torch.stack(a), *states)
    xs = torch.stack([_chunk_inputs(ref, name, c)[0] for c in cs])
    new, m = fleet_chunk_step(cfg, fleet, xs)
    assert m.did_refresh.tolist() == [True, False]
    for k in ("W", "lam", "rho_ref"):
        torch.testing.assert_close(getattr(new.sched, k)[1],
                                   getattr(states[1].sched, k),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_quantize_scores_matches_reference(ref, bits):
    """The quantizer on the same scores: same scales, same codes (the
    division, the half-to-even rounding and the clip are exact IEEE
    operations on both sides), so equal bits.  Its fleet form quantizes
    each slot over its own rows."""
    z = torch.from_numpy(ref["quantize/z"])
    zq, scale = quantize_scores(z, bits)
    np.testing.assert_array_equal(zq.numpy(), ref[f"quantize/b{bits}/z"])
    np.testing.assert_array_equal(scale.numpy(),
                                  ref[f"quantize/b{bits}/scale"])
    fleet, fscale = quantize_scores(torch.stack([z, 2 * z]), bits)
    assert torch.equal(fleet[0], zq) and torch.equal(fscale[0], scale)
    assert torch.equal(fleet[1], quantize_scores(2 * z, bits)[0])
    assert quantize_scores(z, 0) == (z, None)


@pytest.mark.parametrize("name", ["fused", "fused_masked",
                                  "compress_masked", "monitor"])
def test_split_plain_path_is_fused_plain_path_bit_for_bit(ref, name):
    """``fused=False`` on the CPU gives the same bits as the fused body:
    both plain paths fold with the same band expressions, decide on the
    same covariance and run the same stage expressions against the
    post-decision basis (the fused body by its per-slot select) — the
    counterpart of the reference's fused-vs-split differential.  Over the
    whole stream, and one fleet step whose slots refresh and stay."""
    cfg = config_from_json(ref[f"{name}/cfg"])
    split = dataclasses.replace(cfg, fused=False)
    R = int(ref[f"{name}/rv"].sum())
    xs = torch.from_numpy(ref[f"{name}/x"][:R])
    masks = (torch.from_numpy(ref[f"{name}/masks"][:R])
             if f"{name}/masks" in ref else None)
    same = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0)
    runs = [chunked_stream_run(c, state_from_numpy(
        ref, device="cpu", prefix=f"{name}/c0/pre."), xs, masks, chunk=4)
        for c in (cfg, split)]
    tree_map(same, *(r[0] for r in runs))
    tree_map(same, *(r[1] for r in runs))
    cs = (1, 3, 5)
    fleet = tree_map(lambda *a: torch.stack(a), *[
        state_from_numpy(ref, device="cpu", prefix=f"{name}/c{c}/pre.")
        for c in cs])
    ins = [_chunk_inputs(ref, name, c) for c in cs]
    mk = None if ins[0][1] is None else torch.stack([i[1] for i in ins])
    rv = torch.stack([torch.ones(4) if i[2] is None else i[2] for i in ins])
    steps = [fleet_chunk_step(c, fleet, torch.stack([i[0] for i in ins]),
                              mk, rv) for c in (cfg, split)]
    assert 0 < int(steps[0][1].did_refresh.sum()) < len(cs)
    tree_map(same, *(st[0] for st in steps))
    tree_map(same, *(st[1] for st in steps))


def _round_inputs(ref, name):
    x = torch.from_numpy(ref[f"{name}/x"])
    masks = (torch.from_numpy(ref[f"{name}/masks"])
             if f"{name}/masks" in ref else None)
    return x, masks


@pytest.mark.parametrize("r", range(N_ROUNDS))
@pytest.mark.parametrize("name", ROUND_SCENARIOS)
def test_round_step_matches_reference(ref_rounds, name, r):
    """``stream_step`` replayed from the reference's state before round r:
    the per-round fold, decision, stages and books, as the chunk test."""
    ref = ref_rounds
    cfg = config_from_json(ref[f"{name}/cfg"])
    pre = state_from_numpy(ref, device="cpu", prefix=f"{name}/r{r}/pre.")
    x, masks = _round_inputs(ref, name)
    mask = None if masks is None else masks[r]
    ops.reset_counts()
    new, m = stream_step(cfg, pre, x[r], mask)
    assert _plain_calls() == _plain_calls_of(cfg, mask, per_round=True)
    _check_step(ref, f"{name}/r{r}", cfg, x[r], new, m)


def test_round_scenarios_cover_refreshes_flags_and_alarms(ref_rounds):
    fired = {n: sum(bool(ref_rounds[f"{n}/r{r}/m.did_refresh"])
                    for r in range(N_ROUNDS)) for n in ROUND_SCENARIOS}
    assert all(v >= 3 for v in fired.values()), fired
    total = lambda n, k: sum(float(ref_rounds[f"{n}/r{r}/m.{k}"])
                             for r in range(N_ROUNDS))
    for n in ("r_stages", "r_stages_masked", "r_quant"):
        assert total(n, "compression.extra_packets") > 0, n
    for n in ("r_stages", "r_stages_masked"):
        assert total(n, "detection.alarms") > 0, n


def _check_run(ref, key, new, m, fired_ref, rounds):
    """A whole run against the reference's: decisions and counts exactly,
    rho rtol 1e-4 / atol 1e-5 (refresh after refresh), the books rtol
    1e-6, the final band rtol/atol 1e-4."""
    np.testing.assert_array_equal(m.did_refresh.numpy(), fired_ref)
    np.testing.assert_array_equal(m.refreshes.numpy(),
                                  ref[f"{key}/m.refreshes"])
    _close(m.rho.numpy(), ref[f"{key}/m.rho"], rtol=1e-4, atol=1e-5)
    _close(m.comm_packets.numpy(), ref[f"{key}/m.comm_packets"], rtol=1e-6)
    np.testing.assert_array_equal(new.rounds.numpy(), rounds)
    np.testing.assert_array_equal(new.alive.numpy(),
                                  ref[f"{key}/final.alive"])
    _close(new.cov.band, ref[f"{key}/final.cov.band"], rtol=1e-4, atol=1e-4)
    if m.compression is not None:
        np.testing.assert_array_equal(
            m.compression.extra_packets.numpy(),
            ref[f"{key}/m.compression.extra_packets"])
    if m.detection is not None:
        np.testing.assert_array_equal(m.detection.alarms.numpy(),
                                      ref[f"{key}/m.detection.alarms"])


@pytest.mark.parametrize("name", ROUND_SCENARIOS)
def test_stream_run_matches_reference(ref_rounds, name):
    """``stream_run`` from the reference's initial state over the whole
    stream, against the reference's ``stream_run``."""
    cfg = config_from_json(ref_rounds[f"{name}/cfg"])
    st = state_from_numpy(ref_rounds, device="cpu", prefix=f"{name}/r0/pre.")
    x, masks = _round_inputs(ref_rounds, name)
    new, m = stream_run(cfg, st, x, masks)
    _check_run(ref_rounds, f"{name}/run", new, m,
               ref_rounds[f"{name}/run/m.did_refresh"], N_ROUNDS)


@pytest.mark.parametrize("chunk", [None, 4])
def test_batched_stream_run_matches_reference(ref_rounds, chunk):
    """``batched_stream_run`` of a three-network fleet (liveness masks;
    14 rounds, so ``chunk=4`` pads its tail) from the reference's
    ``batched_stream_init`` state, against the reference's run."""
    ref = ref_rounds
    cfg = config_from_json(ref["batched/cfg"])
    states = state_from_numpy(ref, device="cpu", prefix="batched/init.")
    assert states.sched.W.shape == (3, cfg.p, cfg.q)
    xs = torch.from_numpy(ref["batched/x"])
    masks = torch.from_numpy(ref["batched/masks"])
    ops.reset_counts()
    new, m = batched_stream_run(cfg, states, xs, masks, chunk=chunk)
    label = "round" if chunk is None else "chunk"
    decisions = xs.shape[1] if chunk is None else -(-xs.shape[1] // chunk)
    assert m.rho.shape == (3, decisions)
    fold = "band_round_masked" if chunk is None else "fused_stream"
    assert ops.PLAIN_CALLS[fold] == decisions
    _check_run(ref, f"batched/{label}", new, m,
               ref[f"batched/{label}/m.did_refresh"], [xs.shape[1]] * 3)


@pytest.mark.parametrize("kind", ["none", "live", "drop"])
def test_online_update_matches_reference(ref_rounds, kind):
    """``online_update`` round by round under each mask kind against the
    reference's (rtol/atol 1e-5: the same fp32 sums in another order);
    the dropout mask's pairwise counts take a second, unmasked fold."""
    ref = ref_rounds
    x = torch.from_numpy(ref["online/x"])
    mk = (torch.from_numpy(ref[f"online/{kind}/mask"])
          if f"online/{kind}/mask" in ref else None)
    st = online_init(x.shape[-1], 3, device="cpu")
    for r in range(x.shape[0]):
        ops.reset_counts()
        st = online_update(st, x[r], 0.9, None if mk is None else mk[r])
        assert _plain_calls() == {
            "none": {"band_round": 1}, "live": {"band_round_masked": 1},
            "drop": {"band_round_masked_drop": 1, "band_round": 1}}[kind]
        for f, v in zip(st._fields, st):
            _close(v, ref[f"online/{kind}/r{r}.{f}"])


def test_online_update_fleet_is_per_network():
    """Leading axes add nothing: a (3, n, p) fleet round under each mask
    kind equals three single-network rounds, bit for bit."""
    rng = np.random.default_rng(8)
    T = lambda a: torch.from_numpy(a.astype(np.float32))
    x = T(rng.normal(size=(3, 6, 37)))
    for mk in (None, T(rng.random((3, 37)) > 0.2),
               T(rng.random((3, 6, 37)) > 0.2)):
        st = online_init(37, 3, (3,), device="cpu")
        fleet = online_update(st, x, 0.9, mk)
        for s in range(3):
            one = online_update(online_init(37, 3, device="cpu"), x[s], 0.9,
                                None if mk is None else mk[s])
            for a, b in zip(fleet, one):
                assert torch.equal(a[s], b)


def test_stream_covariance_matches_reference(ref_rounds):
    x = torch.from_numpy(ref_rounds["online/x"])
    st, trace = stream_covariance(online_init(x.shape[-1], 3, device="cpu"),
                                  x, 0.9)
    _close(trace, ref_rounds["stream_cov/trace"])
    for f, v in zip(st._fields, st):
        _close(v, ref_rounds[f"stream_cov/state.{f}"])


@pytest.mark.parametrize("name", ROUND_SCENARIOS)
def test_probe_every_one_is_stream_run_bit_for_bit(ref_rounds, name):
    """``chunked_stream_run(probe_every=1)`` gives ``stream_run``'s bits
    on the plain path, states and metrics (the reference's differential
    guarantee, tests/test_chunked_streaming.py): a one-round chunk folds,
    decides, stages and books as a round does."""
    cfg = config_from_json(ref_rounds[f"{name}/cfg"])
    x, masks = _round_inputs(ref_rounds, name)
    runs = [run(cfg, state_from_numpy(ref_rounds, device="cpu",
                                      prefix=f"{name}/r0/pre."), x, masks)
            for run in (stream_run, lambda *a: chunked_stream_run(
                *a, chunk=4, probe_every=1))]
    same = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0)
    tree_map(same, runs[0][0], runs[1][0])
    tree_map(same, runs[0][1], runs[1][1])


def test_fleet_round_step_is_per_network_step(ref_rounds):
    """One per-round fleet step over three networks equals three
    single-network steps (floats rtol/atol 1e-5 — batched and single
    products may sum in another order — the rest exactly)."""
    name = "r_stages_masked"
    ref = ref_rounds
    cfg = config_from_json(ref[f"{name}/cfg"])
    rs = (6, 9, 13)
    states = [state_from_numpy(ref, device="cpu", prefix=f"{name}/r{r}/pre.")
              for r in rs]
    x, masks = _round_inputs(ref, name)
    fleet = tree_map(lambda *a: torch.stack(a), *states)
    new, m = fleet_round_step(cfg, fleet, x[list(rs)], masks[list(rs)])
    assert 0 < int(m.did_refresh.sum()) < len(rs)

    def same(a, b):
        tol = TOL if a.is_floating_point() else dict(rtol=0, atol=0)
        torch.testing.assert_close(a[s], b, **tol)

    for s, r in enumerate(rs):
        one, m1 = stream_step(cfg, states[s], x[r], masks[r])
        tree_map(same, new, one)
        tree_map(same, m, m1)


class TestPrecisionOnlyOnFusedBody:
    """``precision`` acts on the fused chunk body and its recompute alone,
    as in the reference (``repro/streaming/driver.py:294-297``): every
    other body and every per-round path runs in fp32 whatever it says,
    and so gives, on the CPU, the bits of its fp32 twin."""

    @pytest.mark.parametrize("path", ["split_masked", "quant_masked",
                                      "band_masked", "stream_run",
                                      "batched_rounds"])
    def test_bf16_config_gives_fp32_bits(self, ref, ref_rounds, path):
        if path == "stream_run":
            name, run = "r_stages_masked", stream_run
            src, prefix = ref_rounds, "r_stages_masked/r0/pre."
            xs, masks = _round_inputs(src, name)
        elif path == "batched_rounds":
            name, src, prefix = "batched", ref_rounds, "batched/init."
            run = lambda c, s, x, m: batched_stream_run(c, s, x, m)
            xs, masks = (torch.from_numpy(src[f"batched/{k}"])
                         for k in ("x", "masks"))
        else:
            name, src, prefix = path, ref, f"{path}/c0/pre."
            run = lambda c, s, x, m: chunked_stream_run(c, s, x, m, chunk=4)
            R = int(src[f"{name}/rv"].sum())
            xs = torch.from_numpy(src[f"{name}/x"][:R])
            masks = torch.from_numpy(src[f"{name}/masks"][:R])
        cfg = config_from_json(src[f"{name}/cfg"])
        if path not in ("stream_run", "batched_rounds"):
            assert not cfg.use_fused          # a chunk body off the kernel
        runs = []
        for c in (cfg, dataclasses.replace(cfg, precision="bf16")):
            ops.reset_counts()
            runs.append(run(c, state_from_numpy(src, device="cpu",
                                                prefix=prefix), xs, masks))
            assert ops.PLAIN_CALLS["fused_stream"] == 0
            assert ops.PLAIN_CALLS["fused_stream_bf16"] == 0
        same = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0)
        tree_map(same, runs[0][0], runs[1][0])
        tree_map(same, runs[0][1], runs[1][1])

    def test_no_precision_refusal_left(self):
        """No configuration check refuses bf16, and no
        ``NotImplementedError`` of the port speaks of precision."""
        assert not hasattr(StreamConfig, "check_ported")
        for f in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
            for node in ast.walk(ast.parse(f.read_text())):
                if isinstance(node, ast.Raise) and node.exc is not None:
                    text = ast.unparse(node.exc)
                    if "NotImplementedError" in text:
                        assert "precision" not in text, (f, text)
                        assert "bf16" not in text, (f, text)


class TestNotPortedRaises:
    BASE = dict(p=8, q=2, halfwidth=1)

    def test_driver_arguments_checked(self):
        """The drivers take per-round liveness masks, as the reference's
        do, and ``probe_every`` only with ``chunk``."""
        cfg = StreamConfig(**self.BASE)
        st = batched_stream_init(cfg, 2, device="cpu")
        with pytest.raises(ValueError, match="probe_every requires chunk"):
            batched_stream_run(cfg, st, torch.zeros((2, 4, 3, 8)),
                               probe_every=2)
        with pytest.raises(ValueError, match="liveness masks"):
            fleet_round_step(cfg, st, torch.zeros((2, 3, 8)),
                             torch.ones((2, 3, 8)))
        with pytest.raises(ValueError, match="liveness masks"):
            fleet_chunk_step(cfg, st, torch.zeros((2, 4, 3, 8)),
                             torch.ones((2, 4, 3, 8)))

    def test_cuda_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            stream_init(StreamConfig(**self.BASE))

    @pytest.mark.parametrize("entry", [
        lambda: online_init(8, 1),
        lambda: detector_init((2,)),
        lambda: row_liveness(None, 4),
        lambda: random_bases(2, 8, 2),
        lambda: batched_stream_init(StreamConfig(p=8, q=2, halfwidth=1), 2),
    ], ids=["online_init", "detector_init", "row_liveness", "random_bases",
            "batched_stream_init"])
    def test_state_entry_points_default_to_cuda(self, entry):
        """Each state constructor runs on the card unless given
        ``device='cpu'``; without a card that default raises."""
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()


class TestCopiesEqualReference:
    """The pure-Python modules copied into the port stay equal to the
    reference: same values, and the same code up to docstrings and the
    package name."""

    @pytest.mark.parametrize("rel", [
        "core/costs.py", "runtime/health.py", "runtime/elastic.py",
        "serve/queue.py", "serve/telemetry.py", "core/topology.py",
        "core/faults.py", "core/events.py", "core/compression.py",
        "core/spatiotemporal.py", "sensors/dataset.py",
        "sensors/__init__.py", "configs/__init__.py", "configs/base.py",
        "data/tokens.py",
        *(f"configs/{m}.py" for m in (
            "chameleon_34b", "granite_moe_3b", "hymba_1p5b", "llama3_405b",
            "llama3p2_1b", "lm100m", "mamba2_2p7b", "moonshot_v1_16b",
            "phi3_medium_14b", "qwen2_7b", "seamless_m4t_medium",
            "wsn_1m"))])
    def test_same_code(self, rel):
        def code(path, pkg):
            tree = ast.parse(path.read_text().replace(pkg, "repro"))
            for node in ast.walk(tree):
                body = getattr(node, "body", None)
                if (isinstance(body, list) and body
                        and isinstance(body[0], ast.Expr)
                        and isinstance(body[0].value, ast.Constant)
                        and isinstance(body[0].value.value, str)):
                    node.body = body[1:] or [ast.Pass()]
            return ast.dump(tree)
        assert (code(ROOT / "src/repro_torch" / rel, "repro_torch")
                == code(ROOT / "src/repro" / rel, "repro"))

    def test_cost_values(self):
        args = dict(p=64, q=4, n_max=8, c_max=4, iters=8)
        for lr in (0.0, 0.1):
            a = costs.lossy_refresh_cost(64, 4, 8, 4, 8, lr, 3)
            b = ref_costs.lossy_refresh_cost(64, 4, 8, 4, 8, lr, 3)
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
            assert expected_transmissions(lr, 3) == ref_expected_tx(lr, 3)
        assert (dataclasses.astuple(costs.streaming_round_cost(8, 4, 4))
                == dataclasses.astuple(ref_costs.streaming_round_cost(8, 4, 4)))
        rows = lambda mod: {k: dataclasses.astuple(v) for k, v in
                            mod.table1(64, 10, 4, 8, 4, args["iters"]).items()}
        assert rows(costs) == rows(ref_costs)

    @pytest.mark.parametrize("u", [1e-5, 0.01, 0.3, 0.5, 0.9, 0.999])
    def test_norm_quantile(self, u):
        assert _norm_quantile(u) == ref_norm_quantile(u)
