"""The port's program contracts, work model and lints
(``repro_torch.analysis``) on the CPU: the counterparts of
tests/test_analysis.py, tests/test_resources.py and
tests/test_repolint.py.

* every required contract id is registered and passes here (tiny sizes;
  the card runs them at the engine's widths, tests/test_torch_cuda.py);
* break detection: a second kernel call in a chunk body, an extra
  ``all_reduce``, a ``.item()`` in the hot loop, a float64 op, a bf16
  state, a state reallocated instead of updated in place, and a run that
  raises — each fails exactly the rule it targets;
* the work model reproduces PERF.md's bounds (the numbers phase 3 of
  ``chip_smoke.py`` printed), and every kernel call moves one pass;
* repolint: each rule flags its fixture with file and line, the allow
  comment (with a reason) exempts it, and the repository is clean;
* every public ``*_cost`` of ``repro_torch.core.costs`` equals the
  reference's, named one by one.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core.costs as ref_costs
from repro_torch.analysis import check, contracts, op_lint, repolint, resources
from repro_torch.core import costs
from repro_torch.kernels import ops
from repro_torch.serve import engine
from repro_torch.streaming import driver, hierarchy, scheduler

REQUIRED = ("chunk.body", "chunk.fused.fp32", "chunk.fused.bf16",
            "chunk.body.split", "driver.hot-loop", "dtype.policy",
            "engine.step", "engine.step.pipelined", "hierarchy.refresh",
            "scheduler.bill")


def _failed(results):
    """The rules that failed, without their variant labels."""
    return {r.rule.split("[")[0] for r in results if not r.ok}


def test_required_contracts_registered():
    reg = contracts.load_entry_points()
    assert set(REQUIRED) <= set(reg)
    assert contracts.ENTRY_POINT_MODULES == (
        "repro_torch.streaming.driver", "repro_torch.streaming.hierarchy",
        "repro_torch.serve.engine")
    with pytest.raises(KeyError, match="no contract"):
        contracts.get_contract("no.such.contract")


@pytest.mark.parametrize("cid", REQUIRED)
def test_contract_passes_on_cpu(cid):
    results = contracts.check_contract(contracts.get_contract(cid), "cpu")
    assert results and all(r.ok for r in results), \
        [r.line() for r in results if not r.ok]


# --------------------------------------------------------------------------
# break detection: each break fails exactly the rule it targets
def _check(cid):
    return contracts.check_contract(contracts.get_contract(cid), "cpu")


def test_second_kernel_call_in_the_body_fails_the_kernel_budget(
        monkeypatch):
    orig = ops.cov_band_update_chunk_batched

    @functools.wraps(orig)
    def twice(*a, **k):
        orig(*a, **k)
        return orig(*a, **k)
    monkeypatch.setattr(ops, "cov_band_update_chunk_batched", twice)
    assert _failed(_check("chunk.body")) == {"kernels:band_fold"}


def test_extra_all_reduce_fails_the_collective_budget(monkeypatch):
    orig = hierarchy.hierarchical_stream_run

    def extra(cfg, group, *a, **k):
        out = orig(cfg, group, *a, **k)
        dist.all_reduce(torch.zeros(1), group=group)
        hierarchy.COLLECTIVES["all_reduce"] += 1
        return out
    monkeypatch.setattr(hierarchy, "hierarchical_stream_run", extra)
    assert _failed(_check("hierarchy.refresh")) == {"collectives:hierarchy"}


def test_item_in_the_hot_loop_fails_no_host_read(monkeypatch):
    orig = driver.fleet_chunk_step

    def pulls(cfg, state, x, *a, **k):
        x.sum().item()
        return orig(cfg, state, x, *a, **k)
    monkeypatch.setattr(driver, "fleet_chunk_step", pulls)
    assert _failed(_check("driver.hot-loop")) == {"host-read"}


def test_float64_op_fails_no_f64(monkeypatch):
    orig = scheduler.retained_fraction

    def wide(band, W, tv, cw=None):
        return orig(band, W, tv.double(), cw).float()
    monkeypatch.setattr(scheduler, "retained_fraction", wide)
    assert _failed(_check("dtype.policy")) == {"dtype:no-f64"}


def test_bf16_state_fails_fp32_accumulators(monkeypatch):
    orig = driver._decide_and_stage

    def narrow(*a, **k):
        new, metrics = orig(*a, **k)
        sched = new.sched._replace(rho_ref=new.sched.rho_ref.bfloat16())
        return new._replace(sched=sched), metrics
    monkeypatch.setattr(driver, "_decide_and_stage", narrow)
    assert _failed(_check("chunk.fused.bf16")) \
        == {"dtype:fp32-accumulators"}


def test_reallocated_state_fails_in_place(monkeypatch):
    monkeypatch.setattr(engine.StreamingPCAEngine, "_commit",
                        lambda self, new: setattr(self, "states", new))
    assert _failed(_check("engine.step")) == {"state:in-place"}


def test_run_that_raises_is_a_failed_rule():
    def boom():
        raise ValueError("moved")
    c = contracts.Contract(id="t.raise", where="tests", claim="raises",
                           run=lambda dev: {"v": boom},
                           rules=(op_lint.NoF64(),))
    (res,) = contracts.check_contract(c, "cpu")
    assert not res.ok and res.rule == "run[v]" and "moved" in res.detail
    c = contracts.Contract(id="t.builder", where="tests", claim="raises",
                           run=lambda dev: boom())
    (res,) = contracts.check_contract(c, "cpu")
    assert not res.ok and res.rule == "run"


# --------------------------------------------------------------------------
# the recorder
def test_record_counts_kernels_ops_and_sites():
    x = torch.randn(2, 5, 12)

    def run():
        band = ops.cov_band_update_batched(x, 2)
        return float(band.sum())
    rec = op_lint.record(run, label="t")
    assert rec.kernel_count("band_round") == 1 and rec.launches == {}
    reads = [e for e in rec.ops if e.host_read]
    assert len(reads) == 1 and "test_torch_analysis.py" in reads[0].site
    assert [c.kernel for c in rec.calls] == ["band_round"]
    assert not op_lint.NoHostRead().check(rec).ok
    assert op_lint.NoHostRead(allowed_sites=("run",)).check(rec).ok


def test_record_does_not_nest():
    with pytest.raises(RuntimeError, match="does not nest"):
        op_lint.record(lambda: op_lint.record(lambda: None))


def test_rules_report_budget_and_count():
    rec = op_lint.record(lambda: ops.banded_matmul(
        torch.zeros(1, 5, 8), torch.zeros(1, 8, 3)))
    rep = op_lint.KernelBudget("banded_matmul", exact=2).check(rec)
    assert not rep.ok and "banded_matmul 1 (want == 2)" in rep.detail
    rep = op_lint.KernelBudget("banded_matmul", max=1).check(rec)
    assert rep.ok


# --------------------------------------------------------------------------
# the work model
# (kernel, dims, bound ms as PERF.md's kernel table prints it, bound by)
BOUNDS = [
    ("fused_stream", dict(S=256, K=8, n=32, p=1024, h=128, q=32, mask=True),
     0.3705, "operations"),
    ("fused_stream_bf16", dict(S=256, K=8, n=32, p=1024, h=128, q=32,
                               mask=True), 0.3705, "operations"),
    ("band_fold", dict(S=256, K=8, n=32, p=1024, h=128), 0.2423,
     "operations"),
    ("band_fold_masked", dict(S=256, K=8, n=32, p=1024, h=128,
                              mask_elems=256 * 8 * 1024), 0.2423,
     "operations"),
    ("supervised_compress", dict(S=256, R=256, p=1024, q=32,
                                 mask_elems=256 * 8 * 1024), 0.1956,
     "bytes"),
    ("supervised_compress", dict(S=256, R=32, p=1024, q=32,
                                 mask_elems=256 * 1024), 0.0335, "bytes"),
    ("pca_monitor", dict(S=256, R=256, p=1024, q=32,
                         mask_elems=256 * 8 * 1024), 0.1282, "operations"),
    ("pca_monitor", dict(S=256, R=32, p=1024, q=32, mask_elems=256 * 1024),
     0.0210, "bytes"),
    ("band_round", dict(S=256, n=32, p=1024, h=128), 0.0905, "bytes"),
    ("band_round_masked", dict(S=256, n=32, p=1024, h=128,
                               mask_elems=256 * 1024), 0.0908, "bytes"),
    ("band_round_masked_drop", dict(S=256, n=32, p=1024, h=128,
                                    mask_elems=256 * 32 * 1024), 0.1005,
     "bytes"),
    ("pca_project", dict(S=256, R=256, p=1024, q=32), 0.0927, "bytes"),
    ("pca_reconstruct", dict(S=256, R=256, p=1024, q=32), 0.0927, "bytes"),
    ("banded_matmul", dict(S=256, p=1024, h=128, q=32), 0.0954, "bytes"),
    ("banded_matmul", dict(S=1, p=1024, h=128, q=32), 0.00037, "bytes"),
    ("banded_matvec", dict(S=256, p=1024, h=128), 0.0760, "bytes"),
    ("band_round", dict(S=1, n=256, p=1_048_576, h=128), 1.0336,
     "operations"),
    ("banded_matmul", dict(S=1, p=1_048_576, h=128, q=32), 0.4019,
     "bytes"),
    ("banded_matvec", dict(S=1, p=1_048_576, h=128), 0.3243, "bytes"),
]


@pytest.mark.parametrize("kernel,dims,ms,by", BOUNDS,
                         ids=[f"{b[0]}-{i}" for i, b in enumerate(BOUNDS)])
def test_kernel_work_reproduces_perf_bounds(kernel, dims, ms, by):
    got, got_by = resources.bound(*resources.kernel_work(kernel, **dims))
    digits = len(str(ms).split(".")[1])
    assert round(got, digits) == ms and got_by == by


def test_bound_helpers():
    assert resources.band_entries(1024, 128) == 257 * 1024 - 128 * 129
    assert resources.band_entries(4, 9) == 16          # h clipped to p - 1
    assert resources.fold_flops(1, 1, 3, 1) == 2.0 * 5
    assert resources.H100.smem_per_block == 227 * 1024
    assert resources.H100.regs_per_thread == 255


def test_every_kernel_call_moves_one_pass():
    rows = resources.check_traffic("cpu")
    assert len(rows) == len(ops.LAUNCHES) + len(resources.CASE_COUNTERS)
    assert all(r.ok for r in rows), [r.line() for r in rows if not r.ok]


def test_traffic_budget_catches_a_wider_operand():
    call = op_lint.KernelCall(
        "banded_matmul", {"band": ((2, 5, 8), torch.float32),
                          "V": ((2, 8, 3), torch.float64)},
        {"vec": False}, (((2, 8, 3), torch.float32),))
    _, model, got = resources.call_work(call)
    assert got == model + 2 * 8 * 3 * 4
    rec = op_lint.Record(label="t", device=torch.device("cpu"), calls=[call])
    assert not resources.HbmTrafficBudget().check(rec).ok


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _Z10stage_rowsv
    32 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 2048 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_parsing():
    funcs = resources.ptxas_functions(PTXAS_LOG)
    assert funcs["_Z6kernelPf"] == dict(kind="entry", stack=0,
                                        spill_stores=0, spill_loads=0,
                                        registers=128, smem=2048)
    assert funcs["_Z10stage_rowsv"] == dict(kind="device", stack=32,
                                            spill_stores=8, spill_loads=4)
    assert resources.ptxas_summary(PTXAS_LOG) == [
        "_Z10stage_rowsv (device function): 32 bytes stack frame, 8 bytes "
        "spill stores, 4 bytes spill loads",
        "_Z6kernelPf: 128 registers; 0 bytes stack frame, 0 bytes spill "
        "stores, 0 bytes spill loads"]


def test_card_part_limits_and_baseline():
    """The card part's checks on a bill (no card needed to judge one):
    within the limits, stage_rows without spills, equal to a baseline."""
    bill = dict(build={"pca_project": resources.ptxas_functions(
        PTXAS_LOG.replace("_Z10stage_rowsv", "_Z10stage_rowsv_ok")
        .replace("8 bytes spill stores, 4", "0 bytes spill stores, 0"))},
        launch={"pca_project": dict(function="kernel", registers=128,
                                    shared_memory=4096,
                                    dynamic_shared_memory=2048)})
    assert all(r.ok for r in resources._limits(bill))
    assert all(r.ok for r in resources._against(bill, bill))
    other = json.loads(json.dumps(bill))
    other["launch"]["pca_project"]["shared_memory"] = 8192
    bad = [r for r in resources._against(bill, other) if not r.ok]
    assert [r.rule for r in bad] == ["baseline:launch[pca_project]"]
    spilled = dict(bill, build={"pca_project": resources.ptxas_functions(
        PTXAS_LOG)})
    assert [r.rule for r in resources._limits(spilled) if not r.ok] == [
        "no-spill:stage_rows"]


def test_card_part_skips_without_toolkit():
    if resources.have_toolkit():
        pytest.skip("a CUDA toolkit is present")
    (row,) = resources.check_card("cpu")
    assert row.ok and row.detail == "skipped: no CUDA toolkit"


def test_bless_refuses_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="never from the CPU"):
        resources.bless(tmp_path / "r.json", device="cpu")
    assert not (tmp_path / "r.json").exists()


# --------------------------------------------------------------------------
# repolint
FIXTURES = {
    "host-pull": ("mod.py", 'HOT_PATHS = ("f",)\n\n\ndef f(x):\n'
                  "    return x.sum().item()\n", 5),
    "import-time-tensor": ("mod.py", "import torch\nX = torch.zeros(3)\n", 2),
    "no-jax": ("mod.py", "import os\nimport jax.numpy as jnp\n", 2),
    "no-try-around-kernel": (
        "mod.py", "def f():\n    try:\n        load_library('x')\n"
        "    except OSError:\n        pass\n", 2),
    "kernel-counts": (
        "kernels/ops.py", "def w(x):\n    LAUNCHES['k'] += 1\n"
        "    _check(0, 'k')\n    return ref.k(x)\n", 1),
    "span-gate": (
        "mod.py", "import torch\n\n\ndef f(x):\n"
        "    with torch.autograd.profiler.record_function('f'):\n"
        "        return x\n", 5),
}


def _lint(rule, text):
    name, _, _ = FIXTURES[rule]
    return [f for f in repolint.lint_source(Path(name), text, name, {"k"})
            if f.rule == rule]


@pytest.mark.parametrize("rule", list(FIXTURES))
def test_repolint_flags_its_fixture(rule):
    name, text, line = FIXTURES[rule]
    (f,) = _lint(rule, text)
    assert (f.file, f.line) == (name, line)
    assert f.text().startswith(f"{name}:{line}: {rule}: ")


@pytest.mark.parametrize("rule", list(FIXTURES))
def test_repolint_allow_comment_exempts(rule):
    name, text, line = FIXTURES[rule]
    lines = text.splitlines()
    lines[line - 1] += f"  # repolint: allow-{rule} a reason"
    assert _lint(rule, "\n".join(lines) + "\n") == []
    # without a reason the comment exempts nothing
    bare = text.splitlines()
    bare[line - 1] += f"  # repolint: allow-{rule}"
    assert len(_lint(rule, "\n".join(bare) + "\n")) == 1


def test_repolint_host_pull_takes_plain_names_for_host_scalars():
    text = 'HOT_PATHS = ("f",)\n\n\ndef f(x, q):\n    return float(q)\n'
    assert repolint.lint_source(Path("m.py"), text) == []
    assert repolint.lint_source(Path("m.py"), text.replace(
        "float(q)", "float(x.max())"))[0].rule == "host-pull"


CU_BAD = """extern "C" {
int entry_f32(const float* x, void* stream) {
  kernel<<<1, 1, 0, (cudaStream_t)stream>>>(x);  // launch
  return 0;
}
int entry_max_q(int device) { return 7; }
}
"""


def test_repolint_kernel_error_check():
    (f,) = repolint.lint_cuda(Path("k.cu"), CU_BAD, "k.cu",
                              repolint._c_bodies(CU_BAD))
    assert (f.rule, f.line) == ("kernel-error-check", 2)
    good = CU_BAD.replace("return 0;", "return (int)cudaGetLastError();")
    assert repolint.lint_cuda(Path("k.cu"), good, "k.cu",
                              repolint._c_bodies(good)) == []
    via = ("static int launch(const float* x) {\n  return "
           "(int)cudaGetLastError();\n}\n" + CU_BAD.replace(
               "return 0;", "return launch(x);"))
    assert repolint.lint_cuda(Path("k.cu"), via, "k.cu",
                              repolint._c_bodies(via)) == []


def test_repolint_unreferenced_cost_helper(tmp_path):
    pkg, tests = tmp_path / "pkg", tmp_path / "tests"
    (pkg / "core").mkdir(parents=True)
    tests.mkdir()
    (pkg / "core" / "costs.py").write_text(
        "def a_cost():\n    pass\n\n\ndef _b_cost():\n    pass\n")
    (f,) = repolint.run_repolint(pkg, tests)
    assert (f.rule, f.file, f.line) == ("unreferenced-cost-helper",
                                        "pkg/core/costs.py", 1)
    (tests / "test_torch_x.py").write_text("a_cost\n")
    assert repolint.run_repolint(pkg, tests) == []


def test_repolint_span_gate_spares_spans_py_alone():
    """``record_function`` is flagged wherever it is named (an import, a
    bare name) but in the package's ``spans.py``; ``torch.profiler``
    itself stays allowed."""
    text = FIXTURES["span-gate"][1]
    spans = Path("src/repro_torch/spans.py")
    assert repolint.lint_source(spans, text) == []
    other = Path("src/repro_torch/streaming/spans.py")
    assert [f.rule for f in repolint.lint_source(other, text)] == [
        "span-gate"]
    imported = ("from torch.autograd.profiler import record_function\n"
                "with record_function('x'):\n    pass\n")
    assert [f.line for f in repolint.lint_source(Path("m.py"), imported)
            if f.rule == "span-gate"] == [1, 2]
    profiler = ("from torch.profiler import ProfilerActivity, profile\n"
                "p = profile(activities=[ProfilerActivity.CPU])\n")
    assert repolint.lint_source(Path("m.py"), profiler) == []


def test_repo_is_clean():
    findings = repolint.run_repolint()
    assert findings == [], [f.text() for f in findings]


def test_no_jax_rule_matches_the_import_test():
    """The AST rule and tests/test_torch_kernels.py::TestNoJaxInPort agree:
    the port imports neither jax nor repro."""
    assert [f for f in repolint.run_repolint() if f.rule == "no-jax"] == []


# --------------------------------------------------------------------------
# the cost helpers, each named (repolint's unreferenced-cost-helper)
COST_CASES = {
    "streaming_round_cost": (8, 3, 4),
    "streaming_refresh_cost": (32, 3, 8, 4, 8),
    "supervised_round_cost": (3, 4),
    "quantized_supervised_round_cost": (3, 4, 8),
    "detection_round_cost": (3, 4),
    "merge_round_cost": (3, 4),
    "lossy_merge_cost": (3, 4, 0.1, 3),
    "lossy_round_cost": (8, 3, 4, 0.1, 3),
    "lossy_refresh_cost": (32, 3, 8, 4, 8, 0.1, 3),
}


@pytest.mark.parametrize("name", list(COST_CASES))
def test_cost_helper_equals_reference(name):
    args = COST_CASES[name]
    mine, theirs = getattr(costs, name)(*args), getattr(ref_costs,
                                                        name)(*args)
    assert (mine.communication, mine.computation, mine.memory) == (
        theirs.communication, theirs.computation, theirs.memory)


def test_every_cost_helper_has_a_case():
    public = {n for n in dir(costs) if n.endswith("_cost")
              and not n.startswith("_")}
    assert public == set(COST_CASES)


# --------------------------------------------------------------------------
# the check CLI
def test_check_cli_passes_on_cpu(tmp_path, capsys):
    out = tmp_path / "rows.json"
    assert check.main(["--device", "cpu", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "== OK:" in text and "[FAIL]" not in text
    rows = json.loads(out.read_text())
    assert all(r["ok"] for r in rows)
    assert {r["contract"] for r in rows} >= set(REQUIRED) | {
        "resources", "repolint"}


def test_check_cli_lists_the_contracts(capsys):
    assert check.main(["--list"]) == 0
    listed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert set(REQUIRED) <= set(listed)


def test_check_cli_fails_on_a_violation(monkeypatch, capsys):
    monkeypatch.setattr(engine.StreamingPCAEngine, "_commit",
                        lambda self, new: setattr(self, "states", new))
    assert check.main(["--only", "engine.step", "--device", "cpu"]) == 1
    assert "engine.step/state:in-place" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a card: the default device is the card")
def test_check_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA device was asked for"):
        check.run_checks(only="engine.step", echo=lambda *_: None)
    with pytest.raises(RuntimeError, match="CUDA device was asked for"):
        check.main(["--only", "engine.step"])


def test_bill_matches_cost_model_rows():
    rows = _check("scheduler.bill")
    assert len(rows) == 2 and all(r.ok for r in rows)
    assert {r.rule for r in rows} == {"bill[link_loss=0.0]",
                                      "bill[link_loss=0.1]"}
    np.testing.assert_allclose(
        scheduler.RecomputeScheduler(q=3).round_cost(),
        costs.lossy_round_cost(8, 3, 4, 0.0, 3).communication)
