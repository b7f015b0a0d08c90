"""The LM under a mesh: DTensor parameters over four gloo ranks, the
expert-parallel MoE against the reference's, and the dry run's smoke cells.

* Four gloo ranks (tests/torch_dist_child.py, its ``lm/`` scenarios) run
  the smoke widths of llama3.2-1b (and an MQA cut of it, one KV head, so
  each rank's query heads read a replicated KV head), granite-moe-3b-a800m
  and mamba2-2.7b in fp32 on a (2, 2) (data, model) mesh, parameters
  placed by ``param_pspecs(param_rules(...))`` and the decode state as the
  dry run places it (KV caches sequence-sharded over ``model``): forward,
  prefill, 3 decode steps, and lm_loss with every gradient (remat on).
  Each result is held against the single-device port on the same seeded
  inputs within 1e-5 of its largest magnitude.  Granite runs at capacity
  factor 8: the expert-parallel branch's capacity per data shard then
  drops no token the single device keeps (the reference's own EP test
  runs at 8 for the same reason).
* The expert-parallel ``moe_apply`` (its ``_moe_ep``) on the same four
  ranks against the reference's ``_moe_ep_shard_map`` under a 4-device
  CPU mesh, run in a child with forced host devices (as
  tests/test_moe_shardmap.py runs it): E = 4 on (2, 2) and (1, 4), and
  the gcd subgroups of E = 6 on (1, 4) (g = 2, each subgroup on two
  ranks) and on (2, 2), at capacity factor 8, within that test's 2e-5.
* ``python -m repro_torch.launch.dryrun --smoke --device cpu``: the five
  wsn-1m cells at ``WSN.smoke()`` on one gloo rank, each ok and equal to
  the unsharded step, kernels 6, 10 and 11 taking their plain versions.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "torch_dist_child.py"
WORLD = 4
SPAWN_TIMEOUT = 240
ARCHS = ["llama3.2-1b", "llama3.2-1b:mqa", "granite-moe-3b-a800m",
         "mamba2-2.7b"]
EP_CASES = [{"E": 4, "mesh": [2, 2]}, {"E": 4, "mesh": [1, 4]},
            {"E": 6, "mesh": [1, 4]}, {"E": 6, "mesh": [2, 2]}]

REF_EP = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    sys.path.insert(0, "src")
    from repro import configs
    from repro.models import moe as MOE
    from repro.models.params import init_params
    from repro.distributed.sharding import activation_sharding, act_rules
    out = {}
    for case in json.loads(sys.argv[1]):
        E, shape = case["E"], tuple(case["mesh"])
        key = f"moe/{E}_{shape[0]}x{shape[1]}"
        cfg = dataclasses.replace(
            configs.get("granite-moe-3b-a800m").smoke(),
            n_experts=E, top_k=2, capacity_factor=8.0)
        p = init_params(MOE.moe_schema(cfg), jax.random.PRNGKey(0))
        x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, cfg.d_model))
        mesh = jax.make_mesh(shape, ("data", "model"))
        with mesh, activation_sharding(mesh, act_rules(False)):
            y, _ = jax.jit(lambda p, x: MOE.moe_apply(p, cfg, x))(p, x)
        for k, v in p.items():
            out[f"{key}/p/{k}"] = np.asarray(v)
        out[f"{key}/x"] = np.asarray(x)
        out[f"{key}/y_ref"] = np.asarray(y)
    np.savez(sys.argv[2], **out)
""")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + [p for p in [env.get("PYTHONPATH")] if p])
    return env


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh")
    ref = tmp / "ref_ep.npz"
    env = _env()
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", REF_EP,
                           json.dumps(EP_CASES), str(ref)],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    inputs = dict(np.load(ref))
    inputs["lm/archs"] = np.array(json.dumps(ARCHS))
    inputs["moe/cases"] = np.array(json.dumps(EP_CASES))
    src = tmp / "in.npz"
    np.savez(src, **inputs)
    store = tmp / "store"
    store.mkdir()
    procs = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(CHILD), str(r), str(WORLD), str(store),
                 str(src), str(tmp / f"rank{r}.npz")],
                env=_env(), stdout=log, stderr=subprocess.STDOUT,
                cwd=str(ROOT)))
    try:
        for p in procs:
            p.wait(timeout=SPAWN_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp / f"rank{r}.log").read_text()[-4000:]
    return inputs, [dict(np.load(tmp / f"rank{r}.npz"))
                    for r in range(WORLD)]


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_lm_matches_single_device(four_ranks, name):
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_dist_child as child
    want = child.lm_run(*child.lm_inputs(name))
    _, ranks = four_ranks
    for r, got in enumerate(ranks):
        for key, w in want.items():
            g = got[f"lm/{name}/{key}"]
            assert g.shape == w.shape, (name, key)
            tol = 1e-5 * max(float(np.abs(w).max()), 1e-30)
            err = float(np.abs(g - w).max())
            assert err <= tol, (name, key, r, err, tol)


@pytest.mark.parametrize("case", EP_CASES,
                         ids=lambda c: f"E{c['E']}_{c['mesh'][0]}x"
                                       f"{c['mesh'][1]}")
def test_expert_parallel_matches_reference(four_ranks, case):
    inputs, ranks = four_ranks
    key = f"moe/{case['E']}_{case['mesh'][0]}x{case['mesh'][1]}"
    want = inputs[f"{key}/y_ref"]
    for got in ranks:
        err = float(np.abs(got[f"{key}/y"] - want).max())
        assert err < 2e-5, (key, err)


@pytest.fixture(scope="module")
def smoke_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_smoke") / "smoke.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env=_env())
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return {r["shape"]: r for r in map(json.loads,
                                       out.read_text().splitlines())}


SMOKE_KERNELS = {"cov_update": "band_round", "pim_block": "banded_matmul",
                 "pim_deflated": "banded_matvec", "transform": None,
                 "hier_merge": None}


@pytest.mark.parametrize("shape", list(SMOKE_KERNELS))
def test_dryrun_smoke_cell_equals_unsharded(smoke_records, shape):
    rec = smoke_records[shape]
    assert rec["ok"] and rec["equal_unsharded"], rec.get("error")
    assert rec["mesh"] == "local1" and rec["launches"] == {}
    kernel = SMOKE_KERNELS[shape]
    assert rec["plain_calls"] == ({kernel: 1} if kernel else {})
    assert rec["memory"]["peak_per_device"] >= \
        rec["memory"]["argument_bytes"] > 0
    assert rec["collectives"]["unknown_trips"] == []
