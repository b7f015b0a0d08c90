"""The port's pipeline schedule (``repro_torch.distributed.pipeline``)
against the JAX reference's (``repro.distributed.pipeline``), on the CPU.

* ``bubble_fraction`` equal to the reference's on a grid.
* One stage in this process (no process group) against the reference's
  single-stage run under shard_map (tests/test_distributed.py's
  ``test_single_stage_identity``), and bit for bit against the same layer
  function applied microbatch by microbatch, forward and gradients.
* 1, 2 and 4 stages on four gloo ranks (tests/torch_dist_child.py's
  ``pipe/`` scenarios: every rank alone, the pairs {0, 1} and {2, 3},
  all four) against the reference under shard_map on 1, 2 and 4 forced
  host devices (tests/torch_ref_child.py ``pipeline``, its gradients by
  ``jax.grad`` under ``jax.set_mesh``), with M in {1, 3, 4, 8}
  microbatches (M < S and M > S both occur), for two layer functions:
  tanh(h @ W_s) and llama3.2-1b's smoke layer (one a stage).  The last
  stage's output, the gradient of every stage's parameters (each on its
  own rank) and of x (on stage 0; zeros elsewhere) within 1e-5 of the
  larger of 1 and the reference's largest magnitude, in fp32 (measured
  5e-7 of it: the same sums in another order), and the other stages'
  outputs zeros, as the reference returns.
* A batch the microbatches do not divide raises ``ValueError``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply
from repro_torch.models.params import tree_leaves, tree_map, unflatten

from torch_parity import run_reference

ROOT = Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "torch_dist_child.py"
WORLD = 4
SPAWN_TIMEOUT = 240
STAGES = (1, 2, 4)
MICRO = (1, 3, 4, 8)
FNS = ("tanh", "dense")
TOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's results and each gloo rank's."""
    tmp = tmp_path_factory.mktemp("pipe")
    ref = run_reference("pipeline", tmp / "ref.npz", env=dict(
        XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    inputs = {k: v for k, v in ref.items()
              if k.split("/")[2] in ("x", "cot") or
              k.split("/")[2].split(".")[0] == "p"}
    inputs["pipe/fns"] = np.array(json.dumps(FNS))
    inputs["pipe/stages"] = np.array(json.dumps(STAGES))
    inputs["pipe/micro"] = np.array(json.dumps(MICRO))
    src = tmp / "in.npz"
    np.savez(src, **inputs)
    store = tmp / "store"
    store.mkdir()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + [p for p in [env.get("PYTHONPATH")] if p])
    procs = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(CHILD), str(r), str(WORLD), str(store),
                 str(src), str(tmp / f"rank{r}.npz")],
                env=env, stdout=log, stderr=subprocess.STDOUT,
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
    return ref, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def _close(got, want, what):
    """Within TOL of the larger of 1 and the reference's largest magnitude
    (a parameter's gradient sums 24 rows' products through up to four
    layers: its largest is ~50)."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def test_bubble_fraction_equals_reference():
    from repro.distributed.pipeline import bubble_fraction as ref
    for s in (1, 2, 3, 4, 8, 16):
        for m in (1, 2, 3, 4, 8, 12, 32):
            assert bubble_fraction(s, m) == ref(s, m), (s, m)
    assert bubble_fraction(4, 12) == pytest.approx(3 / 15)
    assert bubble_fraction(1, 8) == 0.0


def test_single_stage_in_process_equals_reference():
    """The reference's own single-stage check (tanh(x @ w), two
    microbatches) against the port with no process group."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec
    from repro.distributed.pipeline import pipeline_apply as ref_apply
    w = np.random.default_rng(0).normal(size=(8, 8)).astype(np.float32)
    x = np.random.default_rng(1).normal(size=(4, 8)).astype(np.float32)
    mesh = jax.make_mesh((1,), ("pipe",), devices=jax.devices()[:1])
    fm = shard_map(lambda p, h: ref_apply(lambda a, b: jnp.tanh(b @ a), p,
                                          h, n_microbatches=2,
                                          axis_name="pipe"),
                   mesh=mesh, in_specs=(PartitionSpec(), PartitionSpec()),
                   out_specs=PartitionSpec(), check_rep=False)
    want = np.asarray(fm(jnp.asarray(w), jnp.asarray(x)))
    got = pipeline_apply(lambda a, b: torch.tanh(b @ a), torch.tensor(w),
                         torch.tensor(x), n_microbatches=2)
    _close(got.numpy(), want, "one stage")
    _close(got.numpy(), np.tanh(x @ w), "one stage vs tanh(x @ w)")


@pytest.mark.parametrize("M", MICRO)
def test_single_stage_bit_for_bit_with_microbatch_loop(M):
    """One stage: the output and the gradients of the parameters and of
    x equal, to the bit, the layer applied microbatch by microbatch."""
    g = torch.Generator().manual_seed(M)
    w0 = torch.randn(16, 16, generator=g) / 4
    x0 = torch.randn(24, 5, 16, generator=g)
    cot = torch.randn(24, 5, 16, generator=g)
    layer = lambda p, h: torch.tanh(h @ p["w"]) * p["s"]
    runs = []
    for piped in (True, False):
        p = {"w": w0.clone().requires_grad_(True),
             "s": torch.ones(16).requires_grad_(True)}
        x = x0.clone().requires_grad_(True)
        if piped:
            y = pipeline_apply(layer, p, x, n_microbatches=M)
        else:
            y = torch.cat([layer(p, m) for m in x.chunk(M)])
        grads = torch.autograd.grad((y * cot).sum(), [x, p["w"], p["s"]])
        runs.append([y.detach(), *grads])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_indivisible_batch_raises():
    x = torch.zeros(6, 3)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(lambda p, h: h, None, x, n_microbatches=4)


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("S", STAGES)
@pytest.mark.parametrize("M", MICRO)
def test_stages_equal_reference(ranks, fn, S, M):
    ref, outs = ranks
    key = f"pipe/{fn}/{S}/{M}"
    grad_keys = sorted(k[len(key) + 1:] for k in ref
                       if k.startswith(key + "/gp"))
    for first in range(0, WORLD, S):
        group = outs[first:first + S]
        _close(group[-1][f"{key}/out"], ref[f"{key}/out"], f"{key} out")
        for r in group[:-1]:
            assert not r[f"{key}/out"].any(), f"{key}: a non-last output"
        _close(group[0][f"{key}/gx"], ref[f"{key}/gx"], f"{key} gx")
        for r in group[1:]:
            assert not r[f"{key}/gx"].any(), f"{key}: gx off stage 0"
        for gk in grad_keys:
            whole = np.concatenate([r[f"{key}/{gk}"] for r in group])
            _close(whole, ref[f"{key}/{gk}"], f"{key} {gk}")


def test_dense_layer_stage_params_are_the_reference_slices(ranks):
    """The port's stages ran on the reference's parameters: each rank's
    gradient has its stage's shapes (one layer a stage)."""
    ref, outs = ranks
    pre = "pipe/dense/p."
    flat = {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}
    assert flat and all(v.shape[0] == 4 for v in flat.values())
    tree = unflatten(flat)
    for path, leaf in tree_leaves(tree_map(lambda a: a[:1], tree)):
        assert outs[0][f"pipe/dense/4/4/gp.{path}"].shape == leaf.shape
