"""The PyTorch port's ``StreamingPCAEngine`` against the JAX reference.

The reference engine serves 6 requests on 4 slots (one request carrying a
liveness schedule whose sensors die mid-stream) in a child process
(tests/torch_ref_child.py, see tests/test_torch_streaming.py for why),
on the fused stage path, with quantized scores (``score_bits=4``, the
split path) and on the fused path in the bf16 tile mode
(``precision="bf16"``); the port's engine serves the same
requests from the same initial bases on the CPU, and every
``StreamResult`` field is compared.

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

from repro_torch.kernels import ops
from repro_torch.serve.engine import StreamingPCAEngine, StreamRequest
from repro_torch.serve.queue import QueuePolicy
from repro_torch.streaming import StreamConfig

from torch_parity import config_from_json, run_reference

N_REQ, SLOTS, K = 6, 4, 4
QUANT_FLAG_BUDGET = 2


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("engine", tmp_path_factory.mktemp("ref") / "e.npz")


def _requests(ref, prefix=""):
    return [StreamRequest(rounds=ref[f"{prefix}req{i}/rounds"],
                          liveness=ref.get(f"{prefix}req{i}/liveness"))
            for i in range(N_REQ)]


def _serve(ref, prefix="", cfg=None):
    cfg = cfg or config_from_json(ref[f"{prefix}cfg"])
    eng = StreamingPCAEngine(
        cfg, slots=SLOTS, seed=0, chunk=K,
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


class TestNotPorted:
    def test_pipeline_raises(self, ref):
        with pytest.raises(NotImplementedError, match="pipeline"):
            StreamingPCAEngine(config_from_json(ref["cfg"]), pipeline=True,
                               device="cpu")

    def test_fleet_summary_raises(self, ref):
        eng = StreamingPCAEngine(config_from_json(ref["cfg"]), slots=2,
                                 device="cpu")
        with pytest.raises(NotImplementedError, match="merge_fleet"):
            eng.fleet_summary()

    def test_cuda_without_card_raises(self, ref):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamingPCAEngine(config_from_json(ref["cfg"]), slots=2)
