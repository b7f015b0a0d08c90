"""Each cell end to end at a tiny size on the CPU through the port's plain
path: the reference agrees; with the timed path broken underneath, the
comparison says so; a new cell comes from new files alone."""

from __future__ import annotations

import hashlib
import json
import shutil

import pytest
import torch

from wsnbench import harness
from wsnbench.tests.tiny import CELLS, ROOT, run_tiny, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference(name):
    out = run_tiny(tiny_cell(name))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    for m in out["metrics"].values():
        assert m["value"] > 0


# the faults a one-card cell can have, planted in the program
def _fleet_fault(kind):
    from wsnbench.drivers import fleet

    class Broken(fleet.Program):
        def run(self, state, xs):
            if kind == "half":
                xs = xs.clone()
                n = xs.shape[2]
                xs[:, :, n // 2:] = xs[:, :, :n // 2]
            new, out = super().run(state, xs)
            if kind == "unchanged":
                return state, out
            if kind == "altered":
                out.compression.x_sink[0, -1, 0, 0] += 3.0
            return new, out
    return Broken


def _flat_fault(kind):
    from wsnbench import flat

    class Broken(flat.Program):
        def fold(self, state, x):
            if kind == "unchanged":
                return state
            if kind == "half":
                x = torch.cat([x[: x.shape[0] // 2]] * 2)
            return super().fold(state, x)

        def transform(self, W, mean, x):
            z = super().transform(W, mean, x)
            if kind == "altered":
                z = z.clone()
                z[0, 0] += 1.0
            return z

        def refit(self, band, v0):
            W, lam, it = super().refit(band, v0)
            if kind == "altered":
                lam = lam * 1.01
            return W, lam, it
    return Broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, kind):
    broken = (_fleet_fault if name == "regions-fleet" else _flat_fault)(kind)
    out = run_tiny(tiny_cell(name), program=broken)
    assert not out["correct"], out["checks"]


def _tree_digest(path):
    h = hashlib.sha256()
    for f in sorted(path.rglob("*")):
        if f.is_file() and "__pycache__" not in f.parts:
            h.update(str(f.relative_to(path)).encode())
            h.update(f.read_bytes())
    return h.hexdigest()


def test_a_new_cell_from_new_files_alone(tmp_path):
    """A copy of the benchmark gains a traffic mix, a configuration, a
    limits file and a per-layer metric as new files and entries: the
    harness runs the new cell, and no file the copy had changed."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "wsnbench", tmp_path / "wsnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_digest(tmp_path / "wsnbench")
    base = tmp_path / "wsnbench"
    with open(base / "configs" / "wsn-1m-flat.json") as f:
        conf = json.load(f)
    conf.update(name="wsn-small-flat", p=384, halfwidth=4, q=4,
                batch_epochs=16, source="https://arxiv.org/abs/1003.1967v1")
    (base / "configs" / "wsn-small-flat.json").write_text(json.dumps(conf))
    (base / "traffic" / "stream-shallow.json").write_text(json.dumps(
        {"driver": "stream", "pool_batches": 2, "in_flight": 1}))
    shutil.copy(base / "limits" / "flat-stream.json",
                base / "limits" / "small-stream.json")
    (base / "metrics" / "batches_per_s.py").write_text(
        "def read(ctx):\n"
        "    return ctx.record['batches'] / ctx.record['seconds']\n")
    with open(tmp_path / "BENCHMARK.json") as f:
        b = json.load(f)
    b["configs"].append({"name": "wsn-small-flat",
                         "source": conf["source"],
                         "file": "wsnbench/configs/wsn-small-flat.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "small-stream", "config": "wsn-small-flat",
                           "traffic": "stream-shallow", "chips": 1,
                           "why": "a test"})
    b["end_to_end"].append({"name": "batches_per_s", "unit": "batches/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["small-stream"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.find_cell("small-stream", tmp_path)
    assert cell.base == base
    out = run_tiny(cell, seconds=0.1)
    assert out["correct"], out["checks"]
    assert out["metrics"]["batches_per_s"]["value"] > 0
    # the new files are all that changed
    for f in ("configs/wsn-small-flat.json", "traffic/stream-shallow.json",
              "limits/small-stream.json", "metrics/batches_per_s.py"):
        (base / f).unlink()
    assert _tree_digest(base) == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference in the port's place, float32 with TF32 products,
    at a size a test run holds: the comparison must fail it.  TF32 exists
    only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 products exist only on a CUDA card")
    import torch as t
    from wsnbench import run
    cell = harness.find_cell(name)
    if name == "regions-fleet":
        cell.config["n_regions"] = 16
        cell.traffic["segment_rounds"] = 16
    else:
        cell.config["p"] = 1 << 16
        cell.traffic = dict(cell.traffic, setup_batches=4, starts=2)
    mod = harness.driver_module(cell)
    for seed in (2**32 + 1, 2**32 + 2, 2**32 + 3):
        out = run.execute(cell, seed, 1.0, False, t.device("cuda", 0),
                          program=mod.Control)
        assert not out["correct"], (seed, out["checks"])
