"""``repro_torch.launch`` and the LM sharding plan against the reference.

* The sharding rules: ``param_rules``/``act_rules`` equal the reference's
  dicts, and ``param_pspecs`` gives the reference's ``PartitionSpec``
  entries for every leaf of every config's schema at the 16x16 and
  2x16x16 sizes (the multi-pod FSDP axes, the divisibility fallback);
  ``logical_to_pspec`` maps them to DTensor placements.
* The plan: ``analytic.cell_model`` (whole-job FLOPs and HBM bytes) and
  ``roofline.model_flops`` equal ``repro.launch.analytic``'s and
  ``repro.launch.roofline``'s for every cell at 256 and 512 chips
  (``hier_merge`` raising on both sides); ``terms()`` equal after the
  ratio of the machine constants (v5e there, H100 here); the ring wire
  model equal for every kind and group size.
* The cell list: ``all_cells()``/``skipped_cells()`` equal the
  reference's, taken from ``python -m repro.launch.dryrun --list`` in a
  child (the reference's dry run forces 512 host devices at import).
* The fake dry run, in children (``python -m repro_torch.launch.dryrun``):
  the five wsn-1m cells at full width and llama3.2-1b's and
  granite-moe-3b-a800m's ``decode_32k`` at both meshes — the record's
  keys the reference's, per-device FLOPs x chips at least the whole job's
  model FLOPs (kernel 6's at its unique half of the symmetric band), the
  dense decode's counted FLOPs within 10% of the
  analytic model once the work the reference's own fallback replicates is
  taken out (8 KV heads do not divide over 16 model ranks, so every model
  rank projects all of them for its batch shard) — and granite's
  expert-parallel branch taken: one all-reduce over the 16 model ranks
  for each MoE layer (``inspect_collectives``).
* ``tiling``: the tiles and the q limits (276 / 208 / 276 / 224 from the
  H100's 227 KB per block); the card's C entries are held to the same
  numbers in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro import configs as ref_configs
from repro.distributed import sharding as RS
from repro.launch import analytic as RA
from repro.launch import hlo_analysis as RH
from repro.launch import roofline as RR
from repro.models import params as RP
from repro.models import transformer as RT

from repro_torch import configs
from repro_torch.distributed import sharding as S
from repro_torch.launch import analytic as A
from repro_torch.launch import collectives as C
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch import tiling
from repro_torch.models import transformer as T
from repro_torch.models.params import param_pspecs, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
SIZES = {"16x16": {"data": 16, "model": 16},
         "2x16x16": {"pod": 2, "data": 16, "model": 16}}
ARCHS = sorted(configs.ARCHS)
# the reference's run_cell record (src/repro/launch/dryrun.py:297-355)
REF_KEYS = {"arch", "shape", "opt_level", "mesh", "ok", "lower_s",
            "compile_s", "memory", "cost", "collectives", "roofline",
            "total_s"}
REF_SUBKEYS = {
    "memory": {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_per_device"},
    "cost": {"flops", "bytes accessed"},
    "collectives": {"counts", "wire_bytes", "total_wire_bytes",
                    "unknown_trips"},
    "roofline": {"compute_s", "memory_s", "collective_s", "dominant"}}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


# --------------------------------------------------------------------------
# sharding rules
@pytest.mark.parametrize("multi_pod", [False, True])
def test_rules_equal_reference(multi_pod):
    assert S.param_rules(multi_pod) == RS.param_rules(multi_pod)
    assert S.param_rules(multi_pod, fsdp=False) == \
        RS.param_rules(multi_pod, fsdp=False)
    for seq in (False, True):
        assert S.act_rules(multi_pod, seq) == RS.act_rules(multi_pod, seq)
    assert S.PARAM_RULES == RS.PARAM_RULES and S.ACT_RULES == RS.ACT_RULES


@pytest.mark.parametrize("mesh", list(SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_reference(arch, mesh):
    sizes = SIZES[mesh]
    rules = RS.param_rules(multi_pod="pod" in sizes)
    want = dict(tree_leaves(RP.param_pspecs(
        RT.model_schema(ref_configs.get(arch)), rules, sizes)))
    got = dict(tree_leaves(param_pspecs(
        T.model_schema(configs.get(arch)), rules, sizes)))
    assert set(got) == set(want)
    for path, spec in want.items():
        assert got[path] == tuple(spec), (path, got[path], spec)


class _StubMesh:
    """What ``to_placements`` reads of a DeviceMesh: its dims' names and
    sizes (no process group needed)."""

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


@pytest.mark.parametrize("mesh", list(SIZES))
def test_logical_to_pspec_placements(mesh):
    from torch.distributed.tensor import Replicate, Shard
    sizes = SIZES[mesh]
    stub = _StubMesh(sizes)
    multi = "pod" in sizes
    prules, arules = S.param_rules(multi), S.act_rules(multi)
    cases = [(("embed", "heads", "head_dim"), prules, (2048, 32, 64)),
             (("embed", "kv_heads", "head_dim"), prules, (2048, 8, 64)),
             (("vocab", "embed"), prules, (128256, 2048)),
             (("batch", "seq", "act_heads", None), arules, (128, 1, 32, 64)),
             (("batch", "seq", "act_embed"), arules, (1, 16, 64))]
    for axes, rules, dims in cases:
        entries = S.spec_entries(axes, rules, sizes, dims)
        # the reference's rule without a mesh: the same entries where
        # every dim divides
        nodiv = tuple(RS.logical_to_pspec(axes, rules))
        for e, n, d in zip(entries, nodiv, dims):
            assert e == n or e is None
        pl = S.logical_to_pspec(axes, rules, stub, dims)
        want = [Replicate()] * len(stub.mesh_dim_names)
        for d, e in enumerate(entries):
            for name in ((e,) if isinstance(e, str) else e or ()):
                want[stub.mesh_dim_names.index(name)] = Shard(d)
        assert list(pl) == want, (axes, pl)
    # FSDP over both pod and data: Shard(0) on each, major to minor
    pl = S.logical_to_pspec(("embed", "mlp"), prules, stub, (2048, 8192))
    if multi:
        assert pl == (Shard(0), Shard(0), Shard(1))
    else:
        assert pl == (Shard(0), Shard(1))


# --------------------------------------------------------------------------
# the analytic plan
def _cells():
    return [c for c in D.all_cells() if c[1] != "hier_merge"]


@pytest.mark.parametrize("chips", [256, 512])
def test_cell_models_equal_reference(chips):
    for arch, shape in _cells():
        for m in (1, 4):
            got = A.cell_model(arch, shape, chips, microbatches=m)
            want = RA.cell_model(arch, shape, chips, microbatches=m)
            for k in ("flops_global", "hbm_bytes_global",
                      "collective_scale"):
                assert math.isclose(getattr(got, k), getattr(want, k),
                                    rel_tol=1e-12), (arch, shape, k)
            assert R.model_flops(arch, shape) == pytest.approx(
                RR.model_flops(arch, shape), rel=1e-12)
            tg, tw = got.terms(chips, 1e9), want.terms(chips, 1e9)
            peak = C.PEAK_FP32 if arch == "wsn-1m" else C.PEAK_BF16
            assert tg["compute_s"] == pytest.approx(
                tw["compute_s"] * RH.PEAK_FLOPS / peak, rel=1e-12)
            assert tg["memory_s"] == pytest.approx(
                tw["memory_s"] * RH.HBM_BW / C.HBM_BW, rel=1e-12)
            assert tg["collective_s"] == pytest.approx(
                tw["collective_s"] * RH.ICI_BW / C.LINK_BW, rel=1e-12)
    for fn in (A.cell_model, RA.cell_model):
        with pytest.raises(KeyError):
            fn("wsn-1m", "hier_merge", chips)
    for fn in (R.model_flops, RR.model_flops):
        with pytest.raises(KeyError):
            fn("wsn-1m", "hier_merge")


@pytest.mark.parametrize("kind", C.KINDS)
def test_ring_wire_bytes_equal_reference(kind):
    for g in (1, 2, 3, 16, 32, 256, 512):
        for n in (0, 1, 4096, 3.5e9):
            assert C.ring_wire_bytes(kind, n, g) == \
                RH.ring_wire_bytes(kind, n, g)


def test_machine_constants():
    from repro_torch.analysis.resources import H100
    assert C.PEAK_FP32 is H100.peak_fp32 and C.HBM_BW is H100.peak_bytes
    assert (C.PEAK_BF16, C.LINK_BW, C.HBM_BYTES) == (989.4e12, 450e9, 80e9)
    assert R.n_chips("16x16") == 256 and R.n_chips("2x16x16") == 512


def test_cell_list_equals_reference(capsys):
    env = _env()
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-m", "repro.launch.dryrun",
                           "--list"], capture_output=True, text=True,
                          timeout=120, cwd=str(ROOT), env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert D.main(["--list"]) == 0
    assert capsys.readouterr().out == proc.stdout
    assert len(D.all_cells()) == 37 and len(D.skipped_cells()) == 8
    assert sum(a == "wsn-1m" for a, _ in D.all_cells()) == 5


# --------------------------------------------------------------------------
# the fake dry run
RUNS = {"wsn": ["--arch", "wsn-1m"],
        "llama": ["--arch", "llama3.2-1b", "--shape", "decode_32k"],
        "granite": ["--arch", "granite-moe-3b-a800m", "--shape",
                    "decode_32k"]}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {}
    for name, args in RUNS.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--mesh", "both", "--out", str(tmp / f"{name}.jsonl")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(ROOT), env=_env())
    procs["inspect"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.inspect_collectives",
         "--arch", "granite-moe-3b-a800m", "--shape", "decode_32k",
         "--top", "60"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=str(ROOT), env=_env())
    outs = {k: p.communicate(timeout=240)[0] for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, outs[k][-3000:]
    recs = {}
    for name in RUNS:
        for line in (tmp / f"{name}.jsonl").read_text().splitlines():
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs, outs["inspect"]


CELLS = [("wsn-1m", s) for s in D.WSN_SHAPES] + [
    ("llama3.2-1b", "decode_32k"), ("granite-moe-3b-a800m", "decode_32k")]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_fake_cell_record(records, cell, mesh):
    recs, _ = records
    rec = recs[(*cell, mesh)]
    assert rec["ok"], rec.get("error")
    assert set(rec) == REF_KEYS
    for k, sub in REF_SUBKEYS.items():
        assert set(rec[k]) == sub, k
    assert rec["collectives"]["unknown_trips"] == []
    chips = R.n_chips(mesh)
    mem = rec["memory"]
    assert mem["peak_per_device"] >= mem["argument_bytes"] > 0
    if cell[1] != "hier_merge":
        want = R.model_flops(*cell)
        if cell[1] == "cov_update":
            # kernel 6 folds the unique half of the symmetric band (h + 1
            # of its 2h + 1 diagonals) and mirrors it
            h = D.WSN.halfwidth
            want *= (h + 1) / (2 * h + 1)
        assert rec["cost"]["flops"] * chips >= want * (1 - 1e-9)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_dense_decode_flops_near_analytic(records, mesh):
    recs, _ = records
    rec = recs[("llama3.2-1b", "decode_32k", mesh)]
    cfg = configs.get("llama3.2-1b")
    chips = R.n_chips(mesh)
    B = configs.SHAPES["decode_32k"].global_batch
    n_dp = chips // 16
    counted = rec["cost"]["flops"] * chips
    # K and V projected for all 8 KV heads on each of the 16 model ranks:
    # 15/16 of that work duplicates another rank's
    kv = 2 * 2 * (B // n_dp) * cfg.d_model * cfg.n_kv_heads * cfg.head_dim
    duplicated = chips * cfg.n_layers * kv * (1 - 1 / 16)
    want = A.cell_model("llama3.2-1b", "decode_32k", chips).flops_global
    assert abs(counted - duplicated - want) <= 0.1 * want, \
        (counted, duplicated, want)


def test_granite_decode_takes_expert_parallel(records):
    recs, inspect = records
    cfg = configs.get("granite-moe-3b-a800m")
    lines = [ln for ln in inspect.splitlines() if "all-reduce" in ln
             and "_moe_ep" in ln]
    assert len(lines) == 1, inspect
    assert re.search(rf"x{cfg.n_layers}\s+g=16\b", lines[0]), lines[0]
    for mesh in ("16x16", "2x16x16"):
        assert recs[("granite-moe-3b-a800m", "decode_32k",
                     mesh)]["collectives"]["counts"]["all-reduce"] >= \
            cfg.n_layers


# --------------------------------------------------------------------------
# tiling
def test_block_targets():
    for kind in ("cov", "stage", "fused", "banded"):
        t = tiling.block_targets(kind)
        assert t["rows"] == 64 and t == tiling.block_targets(kind, "bf16")
    assert tiling.block_targets("banded")["rows_small"] == 16
    with pytest.raises(ValueError):
        tiling.block_targets("attention")


def test_q_limits_from_shared_memory():
    assert tiling.SMEM_BYTES == 227 * 1024
    assert [tiling.max_q(e) for e in ("fused_stream", "fused_stream_bf16",
                                      "stage_tile", "pca_reconstruct")] \
        == [276, 208, 276, 224]
    assert tiling.max_q("stage_tile", 48 * 1024) < 276


def test_roofline_table(records, tmp_path, capsys):
    recs, _ = records
    path = tmp_path / "recs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs.values()))
    R.main([str(path), "--md", "--mesh", "16x16"])
    out = capsys.readouterr()
    rows = [ln for ln in out.out.splitlines() if ln.startswith("| ")
            and "16x16" in ln]
    # every 16x16 cell but hier_merge, which has no analytic model
    assert len(rows) == 6 and "hier_merge" in out.err
    for ln in rows:
        assert ln.rstrip().endswith("| y |"), ln
    row = R.analyze(recs[("llama3.2-1b", "decode_32k", "16x16")])
    assert row["fits_h100"] and row["dominant"] == max(
        ("compute", "memory", "collective"), key=lambda k: row[f"{k}_s"])
    assert row["useful_ratio"] == pytest.approx(
        R.model_flops("llama3.2-1b", "decode_32k")
        / A.cell_model("llama3.2-1b", "decode_32k", 256).flops_global)
