"""The port's D/A/F collectives, halo exchange and sharded production steps
(``repro_torch.core.aggregation``, ``repro_torch.core.production``) over
``torch.distributed``.

Two gloo ranks (tests/torch_dist_child.py, spawned with a ``file://``
store and a timeout) run every collective and every sharded step on their
slices of one set of seeded inputs; this process holds each result
against its definition: ``a_op`` the sum of the ranks' records, ``f_op``
the root's record, ``d_op`` the records stacked or concatenated,
``halo_exchange`` the neighbours' edge columns with zeros at the ends of
a broken ring, exactly (a sum of two fp32 records in either order is one
rounding).  The sharded steps are held, gathered over the ranks, against
the one-rank steps of ``repro_torch.core.production`` and against the
reference's steps (``repro.core.production``, plain jnp, run in this
process) on the whole width at rtol/atol 1e-5 (their Gram matrices, norms
and dot products are sums of two partials), and their collectives
counted: one halo exchange a product, one all_reduce a block step, two a
deflated step (one when k = 1).  The distributed Algorithm 2 and
orthogonal iteration (``a_op`` as ``aggregate``, the halo product as
``matvec``), started from the reference's own ``jax.random`` draws, match
the one-process runs and the reference's ``repro.core.power_iteration``
on the same band at eigenvalues rtol 1e-4, components |cos| >= 1 - 1e-4
and equal iteration counts.  In this process a one-rank gloo group gives
the sharded steps the unsharded ones' bits.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import covariance as r_cov
from repro.core import power_iteration as r_pim
from repro.core import production as r_prod

from repro_torch.core import aggregation as agg
from repro_torch.core import covariance as cov
from repro_torch.core import power_iteration as pim
from repro_torch.core import production as prod
from repro_torch.kernels import ops
from repro_torch.launch.mesh import init_fleet_process_group

ROOT = Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "torch_dist_child.py"
WORLD = 2
SPAWN_TIMEOUT = 300
P, H, Q, N, HALO = 48, 3, 4, 16, 2
SEED = 11                             # the reference's PRNGKey for v0, V0
TOL = dict(rtol=1e-5, atol=1e-5)
ORDER = ("all_reduce", "broadcast", "all_gather", "halo_exchange")


def _inputs():
    """Seeded inputs: per-rank records, a banded covariance (the estimate
    of a seeded batch, so it is symmetric positive semi-definite), the
    iterates, and the reference's initial draws for ``power`` (q = 3) and
    ``ortho``."""
    rng = np.random.default_rng(5)
    f32 = lambda a: np.asarray(a, np.float32)
    x = f32(rng.standard_normal((N * 8, P)) @ np.diag(np.linspace(2, .5, P)))
    x[:, 1:] += 0.6 * x[:, :-1]                   # neighbour correlation
    st = cov.banded_update(cov.banded_init(P, H, device="cpu"),
                           torch.from_numpy(x))
    band = cov.banded_estimate(st).numpy()
    w_prev = np.linalg.qr(rng.standard_normal((P, 2)))[0]
    return {
        "core/records": f32(rng.standard_normal((WORLD, 3, HALO + 2))),
        "core/halo": np.array(HALO),
        "core/band": band,
        "core/v": f32(rng.standard_normal(P)),
        "core/w_prev": f32(w_prev),
        "core/V": f32(rng.standard_normal((P, Q))),
        "core/v0": np.stack([np.asarray(jax.random.normal(k, (P,)))
                             for k in jax.random.split(
                                 jax.random.PRNGKey(SEED), 3)]),
        "core/V0": np.array(jax.random.normal(jax.random.PRNGKey(SEED),
                                              (P, Q))),
    }


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The ``core/`` scenarios in WORLD gloo ranks; each rank's outputs."""
    tmp = tmp_path_factory.mktemp("core_ranks")
    src = tmp / "in.npz"
    np.savez(src, **inputs)
    store = tmp / "store"
    store.mkdir()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(CHILD), str(r), str(WORLD), str(store),
                 str(src), str(tmp / f"rank{r}.npz")],
                env=env, stdout=log, stderr=subprocess.STDOUT))
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
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def _counts(rank_out, name):
    return dict(zip(ORDER, rank_out[f"core/{name}/collectives"].tolist()))


def _gathered(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _t(inputs, key):
    return torch.from_numpy(inputs[f"core/{key}"])


class TestCollectives:
    def test_a_op_sums_every_rank(self, inputs, ranks):
        want = inputs["core/records"].sum(0)
        for r in ranks:
            np.testing.assert_array_equal(r["core/a_op/0"], want)
            assert _counts(r, "a_op") == dict(all_reduce=1, broadcast=0,
                                              all_gather=0, halo_exchange=0)

    @pytest.mark.parametrize("root", range(WORLD))
    def test_f_op_floods_the_root(self, inputs, ranks, root):
        for r in ranks:
            np.testing.assert_array_equal(r[f"core/f_op{root}/0"],
                                          inputs["core/records"][root])
            assert _counts(r, f"f_op{root}")["broadcast"] == 1

    @pytest.mark.parametrize("tiled", [False, True])
    def test_d_op_gathers_in_rank_order(self, inputs, ranks, tiled):
        rec = inputs["core/records"]
        want = np.concatenate(rec) if tiled else rec
        for r in ranks:
            got = r["core/d_op_tiled/0" if tiled else "core/d_op/0"]
            np.testing.assert_array_equal(got, want)
            assert _counts(r, "d_op_tiled" if tiled else "d_op")[
                "all_gather"] == 1

    @pytest.mark.parametrize("wrap", [False, True])
    def test_halo_exchange_edges_and_zero_ends(self, inputs, ranks, wrap):
        """As tests/test_distributed.py::TestHaloExchange holds the
        reference: rank r receives rank r-1's right edge from the left and
        rank r+1's left edge from the right; a broken ring's ends get
        zeros, a wrapped one its far end's edges."""
        rec = inputs["core/records"]
        for i, r in enumerate(ranks):
            left, right = (r[f"core/halo_wrap{int(wrap)}/{j}"]
                           for j in (0, 1))
            lo, hi = i - 1, i + 1
            if wrap:
                lo, hi = lo % WORLD, hi % WORLD
            want_l = rec[lo][..., -HALO:] if 0 <= lo < WORLD \
                else np.zeros_like(rec[i][..., :HALO])
            want_r = rec[hi][..., :HALO] if 0 <= hi < WORLD \
                else np.zeros_like(rec[i][..., :HALO])
            np.testing.assert_array_equal(left, want_l)
            np.testing.assert_array_equal(right, want_r)
            assert _counts(r, f"halo_wrap{int(wrap)}") == dict(
                all_reduce=0, broadcast=0, all_gather=0, halo_exchange=1)

    def test_halo_wider_than_the_slice_raises(self):
        with pytest.raises(ValueError, match="halo"):
            agg.halo_exchange(torch.zeros(3, 4), 5)


class TestShardedSteps:
    @pytest.mark.parametrize("k", [0, 1, 2])
    def test_deflated_step_equals_one_rank(self, inputs, ranks, k):
        band, v, W = (_t(inputs, n) for n in ("band", "v", "w_prev"))
        v_next, lam = prod.pim_deflated_step(band, v, W[:, :k])
        np.testing.assert_allclose(_gathered(ranks, f"core/deflated{k}/0"),
                                   v_next.numpy(), **TOL)
        for r in ranks:
            np.testing.assert_allclose(r[f"core/deflated{k}/1"],
                                       lam.numpy(), **TOL)
            assert _counts(r, f"deflated{k}") == dict(
                all_reduce=2 if k else 1, broadcast=0, all_gather=0,
                halo_exchange=1)

    def test_block_step_equals_one_rank(self, inputs, ranks):
        band, V = _t(inputs, "band"), _t(inputs, "V")
        v_next, ray = prod.pim_block_step(band, V)
        np.testing.assert_allclose(_gathered(ranks, "core/block/0"),
                                   v_next.numpy(), **TOL)
        for r in ranks:
            np.testing.assert_allclose(r["core/block/1"], ray.numpy(), **TOL)
            assert _counts(r, "block") == dict(
                all_reduce=1, broadcast=0, all_gather=0, halo_exchange=1)

    @pytest.mark.parametrize("k", [0, 1, 2])
    def test_deflated_step_equals_reference(self, inputs, ranks, k):
        band, v, W = (jnp.asarray(inputs[f"core/{n}"])
                      for n in ("band", "v", "w_prev"))
        v_next, lam = r_prod.pim_deflated_step(band, v, W[:, :k])
        np.testing.assert_allclose(_gathered(ranks, f"core/deflated{k}/0"),
                                   np.asarray(v_next), **TOL)
        for r in ranks:
            np.testing.assert_allclose(r[f"core/deflated{k}/1"],
                                       np.asarray(lam), **TOL)

    def test_block_step_equals_reference(self, inputs, ranks):
        band, V = (jnp.asarray(inputs[f"core/{n}"]) for n in ("band", "V"))
        v_next, ray = r_prod.pim_block_step(band, V)
        np.testing.assert_allclose(_gathered(ranks, "core/block/0"),
                                   np.asarray(v_next), **TOL)
        for r in ranks:
            np.testing.assert_allclose(r["core/block/1"], np.asarray(ray),
                                       **TOL)

    def test_distributed_power_iteration_equals_one_process(self, inputs,
                                                            ranks):
        band, v0 = _t(inputs, "band"), _t(inputs, "v0")
        res = pim.deflated_power_iteration(
            lambda u: ops.banded_matvec(band, u), P, v0.shape[0], v0=v0,
            device="cpu")
        W = _gathered(ranks, "core/power/0")
        cos = np.abs((W * res.W.numpy()).sum(0))
        assert cos.min() >= 1 - 1e-4, cos
        for r in ranks:
            np.testing.assert_allclose(r["core/power/1"],
                                       res.eigenvalues.numpy(), rtol=1e-4)
            np.testing.assert_array_equal(r["core/power/2"],
                                          res.valid.numpy())
            np.testing.assert_array_equal(r["core/power/3"],
                                          res.iterations.numpy())

    def test_distributed_orthogonal_iteration_equals_one_process(
            self, inputs, ranks):
        band, V0 = _t(inputs, "band"), _t(inputs, "V0")
        res = pim.orthogonal_iteration(
            lambda U: ops.banded_matmul(band, U), P, Q, v0=V0, device="cpu")
        W = _gathered(ranks, "core/ortho/0")
        cos = np.abs((W * res.W.numpy()).sum(0))
        assert cos.min() >= 1 - 1e-4, cos
        for r in ranks:
            np.testing.assert_allclose(r["core/ortho/1"],
                                       res.eigenvalues.numpy(), rtol=1e-4)
            assert int(r["core/ortho/2"]) == res.iterations

    def test_distributed_power_iteration_equals_reference(self, inputs,
                                                          ranks):
        band = jnp.asarray(inputs["core/band"])
        res = r_pim.deflated_power_iteration(
            lambda u: r_cov.banded_matvec_ref(band, u), P, 3,
            jax.random.PRNGKey(SEED))
        W = _gathered(ranks, "core/power/0")
        cos = np.abs((W * np.asarray(res.W)).sum(0))
        assert cos.min() >= 1 - 1e-4, cos
        for r in ranks:
            np.testing.assert_allclose(r["core/power/1"],
                                       np.asarray(res.eigenvalues),
                                       rtol=1e-4)
            np.testing.assert_array_equal(r["core/power/2"],
                                          np.asarray(res.valid))
            np.testing.assert_array_equal(r["core/power/3"],
                                          np.asarray(res.iterations))

    def test_distributed_orthogonal_iteration_equals_reference(
            self, inputs, ranks):
        band = jnp.asarray(inputs["core/band"])
        res = r_pim.orthogonal_iteration(
            lambda U: r_cov.banded_matmul_ref(band, U), P, Q,
            jax.random.PRNGKey(SEED))
        W = _gathered(ranks, "core/ortho/0")
        cos = np.abs((W * np.asarray(res.W)).sum(0))
        assert cos.min() >= 1 - 1e-4, cos
        for r in ranks:
            np.testing.assert_allclose(r["core/ortho/1"],
                                       np.asarray(res.eigenvalues),
                                       rtol=1e-4)
            assert int(r["core/ortho/2"]) == int(res.iterations)

    def test_shard_band_checks(self):
        band = torch.zeros((2 * H + 1, P))
        with pytest.raises(ValueError, match="divisible"):
            prod.shard_band(band, 0, 5)
        with pytest.raises(ValueError, match="halo"):
            prod.shard_band(band, 0, P // 2)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo group in this process, destroyed after the module."""
    init_fleet_process_group(0, 1, tmp_path_factory.mktemp("core_world1"),
                             device="cpu", timeout_s=60.0)
    try:
        yield
    finally:
        dist.destroy_process_group()


class TestOneRank:
    """On a ring of one the halo is zeros (or, wrapped, the rank's own
    far edges) and every collective the identity: the sharded steps give
    the unsharded ones' bits."""

    @pytest.mark.parametrize("k", [0, 2])
    def test_deflated_step_bits(self, inputs, world1, k):
        band, v, W = (_t(inputs, n) for n in ("band", "v", "w_prev"))
        got = prod.sharded_pim_deflated_step(prod.shard_band(band, 0, 1), v,
                                             W[:, :k])
        for a, b in zip(got, prod.pim_deflated_step(band, v, W[:, :k])):
            assert torch.equal(a, b)

    def test_block_step_bits(self, inputs, world1):
        band, V = _t(inputs, "band"), _t(inputs, "V")
        got = prod.sharded_pim_block_step(prod.shard_band(band, 0, 1), V)
        for a, b in zip(got, prod.pim_block_step(band, V)):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("wrap", [False, True])
    def test_halo_on_a_ring_of_one(self, world1, wrap):
        block = torch.arange(12.0).reshape(2, 6)
        left, right = agg.halo_exchange(block, 2, wrap=wrap)
        if wrap:
            assert torch.equal(left, block[:, -2:])
            assert torch.equal(right, block[:, :2])
        else:
            assert not left.any() and not right.any()
