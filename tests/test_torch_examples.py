"""The port's examples (``repro_torch.examples``) against the reference's
(``examples/*.py``), on the CPU.

The four streaming examples' reference runs go in child processes
(tests/torch_ref_child.py: ``repro.streaming`` needs names jax 0.9 moved
out of ``jax.core``), all four at once, started when this module is set
up; each writes its own ``jax.random`` draws (streams, initial bases,
the engine's bases) beside its results, and the port example's ``run``
takes those draws (``streams=``, ``init_bases=``, ``masks=``,
``engine_bases=``).  The gate tests on the port's own seeded draws run
while the children work.  ``quickstart`` and ``event_detection`` are held
against ``repro.core`` in this process, as tests/test_torch_core.py does.

Tolerances, and why:

* decisions (``did_refresh``), refresh and round counts, flags, alarms,
  retirements and mesh plans: equal — where a flag or an alarm differs it
  must sit within 1e-4 of ε or of its threshold (the helpers of
  tests/test_torch_streaming.py), and the counts then differ by exactly
  those entries;
* ``rho``: atol 1e-4 (rtol 1e-4) — fp32 refreshes in another order;
* ``comm_packets`` and the other books: rtol 1e-6, fp32 sums of the same
  Python-float prices;
* the worst sink error: within 1e-4 of the reference's, and <= ε;
* detector thresholds: rtol 1e-4;
* the low-variance detector (``event_detection``): its chi-square
  threshold rtol 1e-6 (it depends on the degrees of freedom only); its
  calibrated threshold, an empirical quantile of sum(z^2 / lambda) over
  components 10..29, rtol 5e-2.  Those eigenvalues of the fp32
  covariance of ~24 C readings agree between the packages only to ~5e-3
  (each side is 3e-3 to 5e-3 from float64 eigh), components of near-equal
  eigenvalues rotate into each other, and the port's own threshold moves
  over 73.1..75.2 (the reference's: 74.7) with torch's CPU thread count
  alone, its false-alarm rate over 0.85%..1.31%.  So the rates are
  compared, not the epochs: the detection rate within 2 of the 40 event
  epochs, the false-alarm rate within 0.01, the median statistic rtol
  2e-2;
* ``quickstart``'s fit: as tests/test_torch_core.py holds
  ``DistributedPCA`` (eigenvalues rtol 1e-3, components |cos| >= 1 - 1e-4,
  iteration counts and ``valid`` equal), retained variance atol 1e-4,
  the PCAg scores atol 1e-3 (they inherit the components' tolerance
  times readings of ~25 C), packets and loads equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import costs as r_costs
from repro.core.compression import (SupervisedCompressor as RSupervised,
                                    scores_in_network as r_scores)
from repro.core.events import LowVarianceDetector as RDetector
from repro.core.pca import DistributedPCA as RPCA
from repro.core.pca import retained_variance as r_retained
from repro.core.topology import build_topology as r_build_topology
from repro_torch.examples import (compression_fleet, event_detection,
                                  event_fleet, faulty_fleet, quickstart,
                                  streaming_pca)
from repro_torch.sensors.dataset import berkeley_surrogate, kfold_blocks
from repro_torch.streaming import CompressionConfig
from test_torch_streaming import _event_budget, _flip_budget
from torch_parity import finish_reference, start_reference

STREAMING = ("streaming_pca", "faulty_fleet", "compression_fleet",
             "event_fleet")
SWEEPS = ([(f"eps{e}", e, 0) for e in compression_fleet.EPSILONS]
          + [(f"bits{b}", compression_fleet.EPS_FOR_BITS, b)
             for b in compression_fleet.BIT_WIDTHS])
EXAMPLES = {"streaming_pca": streaming_pca, "faulty_fleet": faulty_fleet,
            "compression_fleet": compression_fleet,
            "event_fleet": event_fleet, "quickstart": quickstart,
            "event_detection": event_detection}


@pytest.fixture(scope="module", autouse=True)
def children(tmp_path_factory):
    """The four reference runs, started together at module set-up; this
    process computes on two threads meanwhile (the examples' tensors are
    small: more threads only contend with the children)."""
    tmp = tmp_path_factory.mktemp("examples")
    procs = {m: (start_reference(m, tmp / f"{m}.npz"), tmp / f"{m}.npz")
             for m in STREAMING}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield procs
    torch.set_num_threads(threads)
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


_REFS: dict = {}


@pytest.fixture(scope="module")
def ref(children):
    """``ref(mode)``: the reference child's results (waited for once)."""
    def get(mode):
        if mode not in _REFS:
            _REFS[mode] = finish_reference(*children[mode])
        return _REFS[mode]
    return get


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


# --------------------------------------------------------------------------
# the gates on the port's own seeded draws (run while the children work)
@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_gate_on_its_own_draws(name, capsys):
    """``main(["--device", "cpu"])``: the report and the reference's gate at
    its thresholds, on the port's own draws (a torch.Generator on the
    device, or the ported numpy helpers)."""
    EXAMPLES[name].main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip()
    if name not in ("quickstart", "event_detection"):
        assert "OK:" in out


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_card_unless_asked(name):
    """``run()`` defaults to ``cuda`` and raises without a card: no
    example falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        EXAMPLES[name].run()


def test_own_draws_are_seeded():
    """The same seed gives the same streams; another seed others."""
    a = streaming_pca.fleet_streams("cpu", seed=0)
    b = streaming_pca.fleet_streams("cpu", seed=0)
    c = streaming_pca.fleet_streams("cpu", seed=1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (64, 120, 8, 32)


# --------------------------------------------------------------------------
# the streaming examples fed the reference's draws
def test_streaming_pca_matches_reference(ref):
    r = ref("streaming_pca")
    p = streaming_pca.run("cpu", streams=r["x"], init_bases=r["W0"])
    np.testing.assert_array_equal(p["did_refresh"], r["m.did_refresh"])
    np.testing.assert_array_equal(p["refreshes"],
                                  r["final.sched.refreshes"])
    _close(p["rho"], r["m.rho"], rtol=1e-4, atol=1e-4)
    _close(p["comm_packets"], r["final.sched.comm_packets"], rtol=1e-6)
    assert p["total_refreshes"] == int(r["final.sched.refreshes"].sum()) >= 1
    assert p["first_post_shift"] >= streaming_pca.SHIFT_ROUND


def test_faulty_fleet_matches_reference(ref):
    r = ref("faulty_fleet")
    p = faulty_fleet.run("cpu", streams=r["x"], init_bases=r["W0"],
                         masks=r["masks"], engine_bases=r["engine/W0"])
    for tag in ("clean", "fault"):
        np.testing.assert_array_equal(p[f"did_refresh_{tag}"],
                                      r[f"{tag}/m.did_refresh"])
        np.testing.assert_array_equal(p[f"refreshes_{tag}"],
                                      r[f"{tag}/final.sched.refreshes"])
        _close(p[f"rho_{tag}"], r[f"{tag}/m.rho"][:, -1], rtol=1e-4,
               atol=1e-4)
        _close(p[f"bill_{tag}"], r[f"{tag}/final.sched.comm_packets"],
               rtol=1e-6)
    assert (p["rel_gap"] <= 0.05).all() and (p["bill_ratio"] <= 2.0).all()
    # the engine coda: the stall verdict, the re-plans, every result
    assert p["plans"] == [tuple(x) for x in r["engine/plans"].tolist()]
    assert p["dead_rounds"] == r["engine/dead_rounds"].tolist()
    assert p["dead_reasons"] == r["engine/dead_reasons"].tolist() == ["dead"]
    for i, res in enumerate(p["results"]):
        assert res["rounds"] == int(r[f"engine/r{i}/rounds"])
        assert res["reason"] == str(r[f"engine/r{i}/reason"])
        assert res["refreshes"] == int(r[f"engine/r{i}/refreshes"])
        _close(res["comm_packets"], r[f"engine/r{i}/comm_packets"],
               rtol=1e-6)
        _close(res["retained"], r[f"engine/r{i}/retained"], atol=1e-4)


@pytest.fixture(scope="module")
def compression_port(ref):
    """The port's whole example on the reference's draws, once."""
    r = ref("compression_fleet")
    return compression_fleet.run("cpu", streams=r["x"], init_bases=r["W0"])


@pytest.mark.parametrize("tag,eps,bits", SWEEPS)
def test_compression_fleet_sweep_matches_reference(ref, compression_port,
                                                   tag, eps, bits):
    """One sweep entry, per reading: decisions equal, flags equal away
    from ε, the extra packets by exactly the flags that flipped, the worst
    sink error within 1e-4 of the reference's and <= ε; the example's
    report row the same numbers."""
    r = ref("compression_fleet")
    key = f"{tag}/m.compression"
    fin, met = compression_fleet.run_fleet(
        CompressionConfig(epsilon=eps, score_bits=bits),
        torch.from_numpy(r["x"]), torch.from_numpy(r["W0"]))
    np.testing.assert_array_equal(met.did_refresh.numpy(),
                                  r[f"{tag}/m.did_refresh"])
    c = met.compression
    N, R = c.max_err.shape
    x = r["x"].reshape(N, R, -1, r["x"].shape[-1])
    flips = _flip_budget(x, c.flagged.numpy(), r[f"{key}.flagged"],
                         c.x_sink.numpy(), r[f"{key}.x_sink"], eps)
    extras = float(c.extra_packets.sum())
    assert extras == float(r[f"{key}.extra_packets"].sum()) + flips
    worst = float(c.max_err.max())
    assert worst <= eps + 1e-6
    assert abs(worst - float(r[f"{key}.max_err"].max())) <= 1e-4
    if flips == 0:
        _close(c.bits_on_air.numpy(), r[f"{key}.bits_on_air"], rtol=1e-6)
        _close(fin.sched.comm_packets.numpy(),
               r[f"{tag}/final.sched.comm_packets"], rtol=1e-6)
    row = (compression_port["eps"][compression_fleet.EPSILONS.index(eps)]
           if tag.startswith("eps") else
           compression_port["bits"][compression_fleet.BIT_WIDTHS.index(bits)])
    assert row["worst"] == worst and row["extras"] == extras


def test_event_fleet_matches_reference(ref):
    """The numpy draws and the injected events equal the reference's bit
    for bit; the alarms equal away from the thresholds; TPR/FPR, the
    thresholds and the bills as the reference's."""
    from repro_torch.core.topology import berkeley_like_layout
    r = ref("event_fleet")
    xs, truth = event_fleet.inject_events(
        event_fleet.fleet_streams(),
        berkeley_like_layout(p=event_fleet.P, seed=7))
    np.testing.assert_array_equal(xs, r["x"])
    np.testing.assert_array_equal(truth, r["truth"])
    p = event_fleet.run("cpu", init_bases=r["W0"])
    ev_r = r["m.detection.events"] > 0.5
    stat = np.maximum(r["m.detection.t2"] / r["m.detection.t2_threshold"]
                      [..., None],
                      r["m.detection.spe"] / r["m.detection.spe_threshold"]
                      [..., None])
    flips = _event_budget(stat, 1.0, p["events"].astype(float),
                          ev_r.astype(float))
    assert p["events"].sum() == ev_r.sum() + flips
    _close(p["t2_threshold"], r["final.det.t2_threshold"], rtol=1e-4)
    _close(p["spe_threshold"], r["final.det.spe_threshold"], rtol=1e-4)
    _close(p["bills"], r["final.sched.comm_packets"], rtol=1e-6)
    if flips == 0:
        calibrating = r["m.detection.calibrating"] > 0.5
        armed = ~calibrating
        armed[:, :event_fleet.WARMUP + 1] = False
        armed_e = np.repeat(armed[:, :, None], event_fleet.N_PER_ROUND, 2)
        assert p["tpr"] == ev_r[truth & armed_e].mean()
        assert p["fpr"] == ev_r[~truth & armed_e].mean()
    assert p["tpr"] > 0.8 and p["fpr"] < 0.05


# --------------------------------------------------------------------------
# quickstart and event_detection against repro.core in this process
def _power_init(seed, p, q):
    """The reference's draws for 'power': normal(split(key, q)[k], (p,))."""
    keys = jax.random.split(jax.random.PRNGKey(seed), q)
    return np.stack([np.asarray(jax.random.normal(k, (p,), jnp.float32))
                     for k in keys])


def _aligned_cos(A, B):
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    return np.abs((A * B).sum(0)) / (np.linalg.norm(A, axis=0)
                                     * np.linalg.norm(B, axis=0))


def test_quickstart_matches_reference():
    """examples/quickstart.py's steps with repro.core, from the
    reference's own initial draws, against the port's quickstart."""
    data = berkeley_surrogate(p=quickstart.P, n_epochs=quickstart.N_EPOCHS,
                              seed=0)
    tr, te = kfold_blocks(data.n_epochs, k=10)[0]
    train, test = data.measurements[tr], data.measurements[te]
    topo = r_build_topology(data.positions, radio_range=quickstart.RADIO)
    res = RPCA(q=5, method="power", t_max=30, delta=1e-3, cov_mode="masked",
               mask=np.asarray(topo.covariance_mask())).fit(train)
    kept = res.components[:, res.valid]
    z, packets = r_scores(topo.tree, kept, test[0], mean=res.mean)
    out = RSupervised(kept, res.mean, epsilon=0.5).run(test[:1000])

    p = quickstart.run("cpu", init=_power_init(0, quickstart.P,
                                               quickstart.Q))
    fit = p["fit"]
    np.testing.assert_allclose(fit.eigenvalues, res.eigenvalues, rtol=1e-3)
    assert (_aligned_cos(fit.components, res.components) >= 1 - 1e-4).all()
    np.testing.assert_array_equal(fit.valid, res.valid)
    np.testing.assert_array_equal(np.asarray(fit.iterations),
                                  np.asarray(res.iterations))
    assert abs(p["retained"] - r_retained(test, kept, res.mean)) <= 1e-4
    sign = np.sign((fit.components * res.components).sum(0))[res.valid]
    np.testing.assert_allclose(p["scores"] * sign, z, atol=1e-3)
    np.testing.assert_array_equal(p["packets"], packets)
    assert p["max_sink_error"] <= 0.5
    assert abs(p["notification_rate"] - out.flagged.mean()) <= 1e-3
    c_max = int(topo.tree.children_counts().max())
    assert p["loads"] == [(q, r_costs.pcag_epoch_load(q, c_max),
                           r_costs.pcag_beats_default(q, 6, 52))
                          for q in quickstart.LOAD_QS]
    assert p["default_load"] == r_costs.default_epoch_load(52)


def test_event_detection_matches_reference():
    """examples/event_detection.py with repro.core against the port's:
    the thresholds, the rates and the median statistic agree and both
    sides pass the gate (tolerances in the module docstring)."""
    X = berkeley_surrogate(p=52, n_epochs=7200, seed=0).measurements
    train, cal, test = X[:3600], X[3600:4800], X[4800:].copy()
    res = RPCA(q=52, method="eigh").fit(train)
    W_low, lam_low = res.components[:, 10:30], res.eigenvalues[10:30]
    det = RDetector(W_low, lam_low, res.mean, alpha=1e-3)
    chi2 = det.threshold
    det.calibrate(cal)
    pattern = W_low[:, 3] + 0.5 * W_low[:, 7]
    test[1000:1040] += (pattern / np.abs(pattern).max() * 1.2)[None, :]
    out = det.detect(test)
    p = event_detection.run("cpu", measurements=X)
    _close(p["chi2_threshold"], chi2, rtol=1e-6)
    _close(p["threshold"], det.threshold, rtol=5e-2)
    window = np.zeros(len(test), bool)
    window[1000:1040] = True
    tpr, fpr = out.events[window].mean(), out.events[~window].mean()
    assert tpr > 0.8 and p["tpr"] > 0.8
    assert fpr < 0.05 and p["fpr"] < 0.05
    assert abs(p["tpr"] - tpr) <= 2 / 40          # two of the 40 epochs
    assert abs(p["fpr"] - fpr) <= 0.01
    _close(p["median_outside"], np.median(out.statistic[~window]),
           rtol=2e-2)
