"""The PyTorch port's ``StreamingPCAEngine`` against the JAX reference.

The reference engine serves 6 requests on 4 slots (one request carrying a
liveness schedule whose sensors die mid-stream; request i is region i) in
a child process (tests/torch_ref_child.py, see
tests/test_torch_streaming.py for why), on the fused stage path —
synchronous and pipelined (``pipeline=True``), each with its
``fleet_summary`` — with quantized scores (``score_bits=4``, the split
path) and on the fused path in the bf16 tile mode (``precision="bf16"``);
the port's engine serves the same requests from the same initial bases on
the CPU, and every ``StreamResult`` field is compared.  The fleet summary:
the selection (region, column) exactly, energies and the retained
fraction rtol 1e-4, the dense basis sign-aligned atol 1e-3 (the bases'
tolerance), the merge bill rtol 1e-6.

The reference's own suite for the pipelined engine
(tests/test_engine_async.py) is ported below on the port alone: the
pipelined engine gives the synchronous engine's bits across its matrix
(masked and unmasked streams, partial tail chunks, a mid-chunk dead
retirement with revival, several submission waves, compression and
detection books), prestages in steady state, never pulls in the hot loop,
and uploads owned copies (poisoned staging buffers change nothing).

Tolerances, and why: counts (rounds, refreshes, flagged readings, alarms,
steps) exactly — the data keep flags and alarms far from their thresholds;
comm_packets and bits rtol 1e-6 (fp32 books, as in the reference); the
retained fraction, energies and total variance rtol 1e-4, the bases
(sign-aligned) atol 1e-3 and the worst sink error (the max of |x - x̂|)
rtol 1e-3 — a whole run carries refresh after refresh through Cholesky
and ``eigh``, whose fp32 differences compound; the
detector thresholds rtol 1e-3 (moment sums of squared statistics).  With
quantized scores a score that differs by an ulp may round to the next
code, which moves x̂ by a quantization level; the flagged-reading count
may then differ by up to ``QUANT_FLAG_BUDGET`` per request (the bits on
air and the bill by the same readings' worth), and the ε bound holds on
both sides.  The bf16 tile mode is held to the fp32 run's tolerances: both
sides round the same fp32 readings and bases to bf16 and compute in fp32.
Its books read the fp32 readings, so its worst sink error may pass ε by
the bf16 rounding of a reading, 2⁻⁸·max|x| (the reference's own bound).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import costs
from repro_torch.kernels import ops
from repro_torch.serve.engine import StreamingPCAEngine, StreamRequest
from repro_torch.serve.queue import QueuePolicy
from repro_torch.streaming import (CompressionConfig, DetectionConfig,
                                   StreamConfig)

from torch_parity import config_from_json, run_reference

N_REQ, SLOTS, K = 6, 4, 4
QUANT_FLAG_BUDGET = 2


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("engine", tmp_path_factory.mktemp("ref") / "e.npz")


def _requests(ref, prefix=""):
    return [StreamRequest(rounds=ref[f"{prefix}req{i}/rounds"],
                          liveness=ref.get(f"{prefix}req{i}/liveness"),
                          region=i)
            for i in range(N_REQ)]


def _serve(ref, prefix="", cfg=None, pipeline=False):
    cfg = cfg or config_from_json(ref[f"{prefix}cfg"])
    eng = StreamingPCAEngine(
        cfg, slots=SLOTS, seed=0, chunk=K, pipeline=pipeline,
        init_bases=torch.from_numpy(ref[f"{prefix}init_bases"]),
        device="cpu", telemetry=True)
    reqs = _requests(ref, prefix)
    for r in reqs:
        eng.submit(r)
    ops.reset_counts()
    eng.run_until_done()
    counts = (dict(ops.PLAIN_CALLS), dict(ops.LAUNCHES))
    return eng, reqs, counts


@pytest.fixture(scope="module")
def served(ref):
    return _serve(ref)


@pytest.fixture(scope="module")
def served_pipe(ref):
    return _serve(ref, "pipe/", pipeline=True)


@pytest.fixture(scope="module")
def served_quant(ref):
    return _serve(ref, "quant/")


@pytest.fixture(scope="module")
def served_bf16(ref):
    return _serve(ref, "bf16/")


def test_engine_steps_and_retirements_match(ref, served):
    eng, reqs, _ = served
    assert eng._clock == int(ref["steps"])
    assert all(r.done for r in reqs)


def _check_result(res, g, flag_budget=0, eps_slack=0.0):
    assert res.rounds == int(g("rounds"))
    assert res.reason == str(g("reason"))
    assert res.refreshes == int(g("refreshes"))
    d_flags = res.compression_extra_packets - float(
        g("compression_extra_packets"))
    assert abs(d_flags) <= flag_budget, d_flags
    # a flagged reading is one 32-bit word and, without link loss, one
    # packet of the bill
    np.testing.assert_allclose(res.compression_bits_on_air - d_flags * 32,
                               g("compression_bits_on_air"), rtol=1e-6)
    np.testing.assert_allclose(res.comm_packets - d_flags,
                               g("comm_packets"), rtol=1e-6)
    np.testing.assert_allclose(res.retained, g("retained"), rtol=1e-4)
    np.testing.assert_allclose(res.energies, g("energies"), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(res.total_variance, g("total_variance"),
                               rtol=1e-4)
    W, W_r = res.components, g("components")
    sgn = np.sign(np.sum(W * W_r, axis=0))
    np.testing.assert_allclose(W * sgn, W_r, atol=1e-3)
    if d_flags == 0:
        np.testing.assert_allclose(res.compression_max_err,
                                   g("compression_max_err"), rtol=1e-3)
    bound = 1.0 + eps_slack
    assert res.compression_max_err <= bound
    assert g("compression_max_err") <= bound
    assert res.detection_events == float(g("detection_events"))
    np.testing.assert_allclose(res.detection_alarm_packets,
                               g("detection_alarm_packets"), rtol=1e-6)
    for f in ("detection_t2_threshold", "detection_spe_threshold"):
        np.testing.assert_allclose(getattr(res, f), g(f), rtol=1e-3)


@pytest.mark.parametrize("i", range(N_REQ))
def test_stream_result_matches_reference(ref, served, i):
    _, reqs, _ = served
    _check_result(reqs[i].result, lambda f: ref[f"req{i}/result.{f}"])


@pytest.mark.parametrize("i", range(N_REQ))
def test_quantized_stream_result_matches_reference(ref, served_quant, i):
    _, reqs, _ = served_quant
    _check_result(reqs[i].result, lambda f: ref[f"quant/req{i}/result.{f}"],
                  flag_budget=QUANT_FLAG_BUDGET)


@pytest.mark.parametrize("i", range(N_REQ))
def test_bf16_stream_result_matches_reference(ref, served_bf16, i):
    _, reqs, _ = served_bf16
    slack = 2.0 ** -8 * float(np.abs(reqs[i].rounds).max())
    _check_result(reqs[i].result, lambda f: ref[f"bf16/req{i}/result.{f}"],
                  eps_slack=slack)


def test_bf16_engine_takes_bf16_kernel_every_step(ref, served_bf16, served):
    """Every step of the bf16 engine calls kernel 1 in its bf16 tile mode
    and never the fp32 one; its results are not the fp32 engine's (the
    mode is not a no-op) and stay within the reference's 0.02 of them."""
    eng, reqs, (plain, launches) = served_bf16
    folded = sum(1 for r in eng.telemetry.steps if r.live > 0)
    assert plain["fused_stream_bf16"] == folded > 0
    assert plain["fused_stream"] == 0
    assert sum(launches.values()) == 0
    assert config_from_json(ref["bf16/cfg"]).precision == "bf16"
    diff = [abs(a.result.retained - b.result.retained)
            for a, b in zip(reqs, served[1])]
    assert max(diff) > 0
    assert max(diff) <= 0.02


def test_quantized_engine_takes_split_kernels_every_step(served_quant):
    eng, _, (plain, launches) = served_quant
    folded = sum(1 for r in eng.telemetry.steps if r.live > 0)
    for k in ("pca_project", "pca_reconstruct", "pca_monitor"):
        assert plain[k] == folded > 0, k
    assert plain["band_fold"] + plain["band_fold_masked"] == folded
    assert plain["fused_stream"] == plain["supervised_compress"] == 0
    assert sum(launches.values()) == 0


def test_split_engine_is_fused_engine_bit_for_bit(ref, served):
    """``fused=False`` serves the same requests to the same bits as the
    fused body on the CPU, through one band-fold, one supervised-compression
    and one monitoring call per step."""
    cfg = dataclasses.replace(config_from_json(ref["cfg"]), fused=False)
    eng, reqs, (plain, _) = _serve(ref, cfg=cfg)
    folded = sum(1 for r in eng.telemetry.steps if r.live > 0)
    assert plain["supervised_compress"] == plain["pca_monitor"] == folded
    assert plain["fused_stream"] == 0
    for a, b in zip(reqs, served[1]):
        for f in dataclasses.fields(a.result):
            va, vb = getattr(a.result, f.name), getattr(b.result, f.name)
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))


def test_run_covers_flags_and_refreshes(ref):
    """The request set exercises what the comparison claims to cover."""
    refreshes = [int(ref[f"req{i}/result.refreshes"]) for i in range(N_REQ)]
    assert max(refreshes) >= 2
    assert sum(float(ref[f"req{i}/result.compression_extra_packets"])
               for i in range(N_REQ)) > 0


def test_cpu_engine_takes_plain_path_every_step(served):
    eng, _, (plain, launches) = served
    folded = sum(1 for r in eng.telemetry.steps if r.live > 0)
    assert plain["fused_stream"] == folded > 0
    assert sum(launches.values()) == 0
    summary = eng.telemetry.summary()
    assert summary["retired"] == N_REQ
    assert summary["rounds"] == sum(r.rounds.shape[0] for r in
                                    served[1])


@pytest.mark.parametrize("which", ["fused", "quant"])
def test_one_banded_product_per_retirement(served, served_quant, which):
    """Every decision runs 1 + refresh_iters + 2 banded products (kernel
    10's plain version on the CPU) and every retirement exactly one: the
    retained fraction and the energies share one ``C W``."""
    eng, reqs, (plain, launches) = served if which == "fused" \
        else served_quant
    decisions = sum(1 for r in eng.telemetry.steps if r.live > 0)
    per_decision = eng.cfg.refresh_iters + 3
    assert decisions > 0 and eng.telemetry.summary()["retired"] == len(reqs)
    assert plain["banded_matmul"] == per_decision * decisions + len(reqs)
    assert launches["banded_matmul"] == 0


def test_band_only_engine_uses_band_kernels(ref):
    cfg = StreamConfig(p=64, q=4, halfwidth=3, warmup_rounds=3)
    eng = StreamingPCAEngine(cfg, slots=SLOTS, chunk=K, device="cpu",
                             telemetry=True)
    for r in _requests(ref):
        eng.submit(r)
    ops.reset_counts()
    eng.run_until_done()
    assert ops.PLAIN_CALLS["fused_stream"] == 0
    assert ops.PLAIN_CALLS["band_fold"] + ops.PLAIN_CALLS[
        "band_fold_masked"] == sum(1 for r in eng.telemetry.steps
                                   if r.live > 0)
    assert ops.PLAIN_CALLS["band_fold_masked"] >= 1


def test_priority_admission_and_backpressure(ref):
    cfg = config_from_json(ref["cfg"])
    eng = StreamingPCAEngine(cfg, slots=1, chunk=K, device="cpu",
                             queue=QueuePolicy(capacity=2))
    reqs = _requests(ref)[:3]
    reqs[1].priority = 5
    assert eng.submit(reqs[0]) and eng.submit(reqs[1])
    assert not eng.submit(reqs[2])
    eng.step()
    assert eng.active[0] is reqs[1]


# -- pipelined engine and fleet summary against the reference ---------------
@pytest.mark.parametrize("i", range(N_REQ))
def test_pipelined_stream_result_matches_reference(ref, served_pipe, i):
    _, reqs, _ = served_pipe
    _check_result(reqs[i].result, lambda f: ref[f"pipe/req{i}/result.{f}"])


def test_pipelined_ledger_matches_reference(ref, served_pipe):
    """The port's pipelined engine takes the reference's steps, prestage
    hits and misses and transfer fences, retires in its order, and pulls
    only at retirement."""
    eng, reqs, (plain, launches) = served_pipe
    assert eng._clock == int(ref["pipe/steps"])
    assert [eng._prestage_hits, eng._prestage_misses,
            eng._transfer_fences] == ref["pipe/prestage"].tolist()
    assert eng._prestage_hits >= 1
    assert [reqs.index(q) for q, _ in eng.retired_log] \
        == ref["pipe/retired"].tolist()
    assert eng.pulls["hot"] == 0
    assert eng.pulls["retire"] == len(eng.retired_log)
    folded = sum(1 for r in eng.telemetry.steps if r.live > 0)
    assert plain["fused_stream"] == folded > 0
    assert sum(launches.values()) == 0


def test_pipelined_engine_is_sync_engine_bit_for_bit(served, served_pipe):
    (e_sync, r_sync, c_sync), (e_pipe, r_pipe, c_pipe) = served, served_pipe
    for a, b in zip(r_sync, r_pipe, strict=True):
        assert_results_identical(a, b)
    ledger = lambda eng, reqs: [(reqs.index(q), why)
                                for q, why in eng.retired_log]
    assert ledger(e_sync, r_sync) == ledger(e_pipe, r_pipe)
    assert c_sync == c_pipe              # the same kernel calls


FLEET_SUMMARIES = [(4, None), (12, 2), (24, None)]


@pytest.mark.parametrize("prefix", ["", "pipe/"], ids=["sync", "pipelined"])
@pytest.mark.parametrize("q_fleet,c_regions", FLEET_SUMMARIES)
def test_fleet_summary_matches_reference(ref, served, served_pipe, prefix,
                                         q_fleet, c_regions):
    eng = (served if prefix == "" else served_pipe)[0]
    pulls = eng.pulls["merge"]
    summ = eng.fleet_summary(q_fleet, c_regions)
    assert eng.pulls["merge"] == pulls + 1 and eng.pulls["hot"] == 0
    g = lambda f: ref[f"{prefix}fleet/q{q_fleet}/{f}"]
    assert summ.regions == tuple(g("regions").tolist()) == tuple(
        range(N_REQ))
    np.testing.assert_array_equal(summ.region, g("region"))
    np.testing.assert_array_equal(summ.col, g("col"))
    assert summ.region.dtype == summ.col.dtype == np.int32
    np.testing.assert_allclose(summ.lam, g("lam"), rtol=1e-4)
    np.testing.assert_allclose(summ.rho, g("rho"), rtol=1e-4)
    B, B_r = summ.basis, g("basis")
    assert B.shape == B_r.shape == (N_REQ * 64, q_fleet)
    sgn = np.sign(np.sum(B * B_r, axis=0))
    np.testing.assert_allclose(B * sgn, B_r, atol=1e-3)
    np.testing.assert_allclose(summ.merge_packets, g("merge_packets"),
                               rtol=1e-6)


def test_fleet_summary_is_the_selection_of_the_results(served):
    """The summary is the stable top-q selection of the retired regions'
    energies, embedded: its basis columns are the selected regions' basis
    columns, orthonormal; its bill is the cost model's."""
    eng = served[0]
    summ = eng.fleet_summary(12, 2)
    table = np.stack([eng.region_results[r].energies for r in summ.regions])
    order = np.argsort(-table.reshape(-1), kind="stable")[:12]
    np.testing.assert_array_equal(summ.region, order // eng.cfg.q)
    np.testing.assert_array_equal(summ.col, order % eng.cfg.q)
    np.testing.assert_array_equal(summ.lam, table.reshape(-1)[order])
    p = eng.cfg.p
    for j, (r, c) in enumerate(zip(summ.region, summ.col)):
        col = np.zeros(len(summ.regions) * p, np.float32)
        col[r * p:(r + 1) * p] = eng.region_results[r].components[:, c]
        np.testing.assert_array_equal(summ.basis[:, j], col)
    np.testing.assert_allclose(summ.basis.T.astype(np.float64)
                               @ summ.basis, np.eye(12), atol=1e-5)
    assert summ.merge_packets == costs.lossy_merge_cost(
        eng.cfg.q, 2, eng.cfg.link_loss, eng.cfg.max_retries).communication


def test_fleet_summary_empty_raises(ref):
    eng = StreamingPCAEngine(config_from_json(ref["cfg"]), slots=2,
                             device="cpu")
    with pytest.raises(ValueError, match="no retired region"):
        eng.fleet_summary()


# -- the reference's pipelined-engine suite, on the port ---------------------
P8, Q2, N4 = 8, 2, 4


def _mcfg(**kw):
    base = dict(p=P8, q=Q2, halfwidth=1, forgetting=0.9, drift_threshold=0.1,
                warmup_rounds=2)
    base.update(kw)
    return StreamConfig(**base)


def _mreq(rng, rounds=6, liveness=None, **kw):
    x = rng.normal(size=(rounds, N4, P8)).astype(np.float32)
    return StreamRequest(rounds=x, liveness=liveness, **kw)


def _result_fields(res):
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
            if f.name not in ("components", "energies")}


def assert_results_identical(a: StreamRequest, b: StreamRequest):
    assert a.done == b.done
    assert (a.result is None) == (b.result is None)
    pairs = list(zip(a.retirements, b.retirements, strict=True))
    if a.result is not None:
        pairs.append((a.result, b.result))
    for ra, rb in pairs:
        np.testing.assert_array_equal(ra.components, rb.components)
        np.testing.assert_array_equal(ra.energies, rb.energies)
        assert _result_fields(ra) == _result_fields(rb)


def _run_matrix(pipeline: bool, *, cfg=None, schedule=None, seed=3,
                slots=3, chunk=2, poison=False):
    """One deterministic serving run; ``schedule`` maps a step index to the
    requests submitted before it (step 0: before the first step).  With
    ``poison`` every staging buffer is overwritten after each step."""
    eng = StreamingPCAEngine(cfg or _mcfg(), slots=slots, seed=0,
                             chunk=chunk, pipeline=pipeline, telemetry=True,
                             device="cpu")
    rng = np.random.default_rng(seed)
    schedule = schedule or {0: [dict(rounds=6) for _ in range(6)]}
    reqs, step = [], 0

    def run_step():
        live = eng.step()
        if poison:
            for bufs in eng._staging:
                if bufs is not None:
                    for buf in bufs.views():
                        buf.fill(np.float32(1e9))
        return live

    for wave_step in sorted(schedule):
        while step < wave_step:
            run_step()
            step += 1
        for kw in schedule[wave_step]:
            r = _mreq(rng, **kw)
            reqs.append(r)
            eng.submit(r)
    while run_step() or eng.queue:
        pass
    return eng, reqs


def _assert_parity(**kw):
    e_sync, r_sync = _run_matrix(False, **kw)
    e_pipe, r_pipe = _run_matrix(True, **kw)
    for a, b in zip(r_sync, r_pipe, strict=True):
        assert_results_identical(a, b)
    ledger = lambda eng, reqs: [(reqs.index(q), why)
                                for q, why in eng.retired_log]
    assert ledger(e_sync, r_sync) == ledger(e_pipe, r_pipe)
    assert e_pipe.pulls["hot"] == e_sync.pulls["hot"] == 0
    assert e_pipe._prestage_hits >= 1
    return e_sync, e_pipe


class TestPipelineParity:
    """Pipelined == synchronous bit for bit (the reference's
    ``TestParity``), with the pull ledger and the prestage hits."""

    def test_unmasked(self):
        _assert_parity()

    @pytest.mark.parametrize("chunk", [2, 3])
    def test_partial_tail_chunks(self, chunk):
        # lengths 5..10 against chunk 2 and 3: tails of 1 and 2 rounds
        _assert_parity(schedule={0: [dict(rounds=5 + i) for i in range(6)]},
                       chunk=chunk)

    def test_masked_liveness(self):
        rng = np.random.default_rng(7)
        waves = [dict(rounds=7, liveness=(
            (rng.uniform(size=(7, P8)) > 0.2).astype(np.float32)
            if i % 2 == 0 else None)) for i in range(5)]
        _assert_parity(schedule={0: waves})

    def test_mid_chunk_dead_retirement_and_revival(self):
        # every sensor dies at round 3 (mid-chunk at K=2) and revives at
        # round 11: long enough for the 2.5-step stall verdict
        lv = np.ones((16, P8), np.float32)
        lv[3:11] = 0.0
        e_sync, _ = _assert_parity(
            schedule={0: [dict(rounds=16, liveness=lv), dict(rounds=16)]},
            slots=2)
        assert "dead" in [why for _, why in e_sync.retired_log]

    def test_multiple_submission_waves(self):
        # a wave that fills an idle slot moves the plan under the
        # prestaged chunk: the pipelined engine must restage it
        _, e_pipe = _assert_parity(
            schedule={0: [dict(rounds=6)], 2: [dict(rounds=5),
                                               dict(rounds=7)],
                      4: [dict(rounds=6)]}, slots=2)
        assert e_pipe._prestage_misses > 1

    def test_compression_and_detection_books(self):
        cfg = _mcfg(compression=CompressionConfig(epsilon=0.5,
                                                  emit_reconstruction=False),
                    detection=DetectionConfig(alpha=1e-3, calib_rounds=2))
        _assert_parity(cfg=cfg,
                       schedule={0: [dict(rounds=8) for _ in range(5)]})

    def test_pipelined_prestages_in_steady_state(self):
        _, e_pipe = _assert_parity(
            schedule={0: [dict(rounds=10) for _ in range(3)]}, slots=3)
        assert e_pipe._prestage_hits >= 3
        assert e_pipe._transfer_fences >= 1   # the buffers really cycle

    def test_sync_engine_stages_through_the_same_buffers(self):
        """The synchronous engine stages every step inline (a miss each)
        through the same two buffers, fenced on refill."""
        eng, _ = _run_matrix(False)
        folded = sum(1 for r in eng.telemetry.steps if r.live > 0)
        assert eng._prestage_hits == 0
        assert eng._prestage_misses == folded > 2
        assert eng._transfer_fences == folded - 2


class TestNoAliasing:
    def test_upload_is_owned_copy(self):
        eng = StreamingPCAEngine(_mcfg(), slots=1, device="cpu")
        host = np.ones((4, 4), np.float32)
        dev = eng._upload(host)
        host[:] = 777.0                  # poison right after the upload
        np.testing.assert_array_equal(dev.numpy(), np.ones((4, 4)))

    @pytest.mark.parametrize("pipeline", [False, True])
    def test_poisoned_staging_buffers_leave_results_unchanged(self,
                                                              pipeline):
        """Every staging buffer (batch, masks, round validity) overwritten
        after each step — the prestaged chunk's too — changes no result."""
        def run(poison):
            rng = np.random.default_rng(11)
            lv = (rng.uniform(size=(7, P8)) > 0.2).astype(np.float32)
            return _run_matrix(pipeline, slots=2, seed=12, poison=poison,
                               schedule={0: [dict(rounds=7, liveness=lv),
                                             dict(rounds=6),
                                             dict(rounds=5)]})[1]

        for a, b in zip(run(False), run(True), strict=True):
            assert_results_identical(a, b)


class TestPipelineTelemetry:
    def test_sync_engine_has_zero_overlap(self):
        eng, _ = _run_matrix(False, slots=2,
                             schedule={0: [dict(rounds=6)] * 3})
        s = eng.telemetry.summary()
        assert s["overlap_fraction"] == 0.0
        assert all(r.overlap_s == 0.0 for r in eng.telemetry.steps)
        assert s["prestage_hit_rate"] == 0.0
        assert s["retired"] == 3 and s["rounds"] == 18

    def test_pipelined_engine_reports_overlap_and_hits(self):
        eng, _ = _run_matrix(True, slots=2,
                             schedule={0: [dict(rounds=6)] * 3})
        s = eng.telemetry.summary()
        assert s["prestage_hit_rate"] > 0.5
        assert s["overlap_fraction"] > 0.0
        assert any(r.overlap_s > 0.0 for r in eng.telemetry.steps)
        assert eng.pulls["hot"] == 0 and eng.pulls["retire"] == 3


class TestNotPorted:
    def test_cuda_without_card_raises(self, ref):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamingPCAEngine(config_from_json(ref["cfg"]), slots=2)
