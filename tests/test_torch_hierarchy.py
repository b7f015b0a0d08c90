"""The port's two-level fleet merge and distributed drivers against the JAX
reference.

The reference runs in a child process (tests/torch_ref_child.py
``hierarchy``, see tests/test_torch_streaming.py for why) on a
two-device CPU mesh (``XLA_FLAGS=--xla_force_host_platform_device_count=2``
in the child's environment): ``merge_fleet`` and ``fleet_basis_dense`` on
energy tables with ties, ``hierarchical_stream_run`` over 4 regions on a
``region`` axis of 2 devices, and ``sharded_stream_run`` over 4 networks
on a ``data`` axis of 2.  The port runs the same scenarios from the same
initial states in two gloo ranks (tests/torch_dist_child.py, spawned with
a timeout; each rank streams 2 regions or networks) and in this process
with a one-rank group.

Tolerances, and why: the merge's selection (region, column), its energies
and the dense basis exactly (a selection of the same numbers), the
retained fraction rtol 1e-6 (one sum in another order); whole runs as in
tests/test_torch_streaming.py — decisions, counts, flags and alarms
exactly, rho rtol 1e-4 / atol 1e-5, the books rtol 1e-6, the band
rtol/atol 1e-4, the bases (sign-aligned) atol 1e-3 (refresh after
refresh through Cholesky and ``eigh``); the merge of a run at the same
tolerances (the energies come out of the run), ``merge_epochs`` exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.distributed.sharding import shard_networks, shard_regions
from repro_torch.launch.mesh import (init_fleet_process_group,
                                     make_fleet_mesh, mesh_axis_sizes)
from repro_torch.streaming import (FleetBasis, batched_stream_run,
                                   fleet_basis_dense,
                                   hierarchical_stream_init,
                                   hierarchical_stream_run, merge_fleet)
from repro_torch.streaming.driver import tree_map
from repro_torch.streaming.hierarchy import COLLECTIVES, reset_collectives

from torch_parity import config_from_json, run_reference

ROOT = Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "torch_dist_child.py"
WORLD = 2
SPAWN_TIMEOUT = 300
HIER = ["h_chunk", "h_round", "h_quiet"]
SHARD = ["s_round", "s_chunk"]
MERGE_CASES = [("ties", q) for q in range(1, 13)] \
    + [("random", q) for q in range(1, 16)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(
        "hierarchy", tmp_path_factory.mktemp("ref") / "hierarchy.npz",
        env={"XLA_FLAGS": "--xla_force_host_platform_device_count=2"})


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    """Every two-level and sharded scenario in WORLD gloo ranks; each
    rank's outputs."""
    tmp = tmp_path_factory.mktemp("ranks")
    src = tmp / "in.npz"
    np.savez(src, **{k: v for k, v in ref.items()
                     if k.startswith(("h_", "s_"))})
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


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo group in this process, destroyed after the module."""
    init_fleet_process_group(0, 1, tmp_path_factory.mktemp("world1"),
                             device="cpu", timeout_s=60.0)
    try:
        yield make_fleet_mesh()
    finally:
        dist.destroy_process_group()


def _gathered(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _check_run(ref, name, get):
    """A whole run (``get(field)`` the port's, all regions or networks)
    against the reference's at the parity tolerances."""
    eq = np.testing.assert_array_equal
    eq(get("m.did_refresh"), ref[f"{name}/m.did_refresh"])
    eq(get("m.refreshes"), ref[f"{name}/m.refreshes"])
    _close(get("m.rho"), ref[f"{name}/m.rho"], rtol=1e-4, atol=1e-5)
    _close(get("m.comm_packets"), ref[f"{name}/m.comm_packets"], rtol=1e-6)
    eq(get("final.rounds"), ref[f"{name}/final.rounds"])
    eq(get("final.alive"), ref[f"{name}/final.alive"])
    _close(get("final.cov.band"), ref[f"{name}/final.cov.band"], rtol=1e-4,
           atol=1e-4)
    W, W_r = get("final.sched.W"), ref[f"{name}/final.sched.W"]
    sgn = np.sign(np.sum(W * W_r, axis=-2, keepdims=True))
    _close(W * sgn, W_r, atol=1e-3)
    for key in ("m.compression.extra_packets", "m.detection.alarms"):
        if f"{name}/{key}" in ref:
            eq(get(key), ref[f"{name}/{key}"])


def _check_merge(fleet, ref, name):
    """A run's merge (``fleet(field)``) against the reference's."""
    pre = f"{name}/fleet"
    for f in ("basis.region", "basis.col", "merge_epochs"):
        np.testing.assert_array_equal(fleet(f), ref[f"{pre}.{f}"])
    for f in ("basis.lam", "basis.rho", "basis.total_variance"):
        _close(fleet(f), ref[f"{pre}.{f}"], rtol=1e-4)
    _close(fleet("basis.lam_table"), ref[f"{pre}.basis.lam_table"],
           rtol=1e-4, atol=1e-5)
    _close(fleet("merge_packets"), ref[f"{pre}.merge_packets"], rtol=1e-6)


class TestMerge:
    @pytest.mark.parametrize("case,q", MERGE_CASES)
    def test_merge_fleet_matches_reference(self, ref, case, q):
        """Ties within and across regions pick the reference's components:
        the sort is stable, lower (region, column) first."""
        pre = f"merge/{case}"
        basis = merge_fleet(torch.from_numpy(ref[f"{pre}/table"]),
                            torch.from_numpy(ref[f"{pre}/total"]), q)
        for f in ("region", "col", "lam", "lam_table", "total_variance"):
            np.testing.assert_array_equal(getattr(basis, f).numpy(),
                                          ref[f"{pre}/q{q}.{f}"])
        assert basis.region.dtype == basis.col.dtype == torch.int32
        _close(basis.rho.numpy(), ref[f"{pre}/q{q}.rho"], rtol=1e-6)

    @pytest.mark.parametrize("case,q", MERGE_CASES)
    def test_fleet_basis_dense_matches_reference(self, ref, case, q):
        pre = f"merge/{case}"
        basis = FleetBasis(*(torch.from_numpy(ref[f"{pre}/q{q}.{f}"])
                             for f in FleetBasis._fields))
        dense = fleet_basis_dense(basis, torch.from_numpy(ref[f"{pre}/W"]))
        np.testing.assert_array_equal(dense.numpy(), ref[f"{pre}/q{q}/dense"])

    def test_merge_fleet_q_limit_raises(self, ref):
        table = torch.from_numpy(ref["merge/ties/table"])
        with pytest.raises(ValueError, match="q_fleet=13"):
            merge_fleet(table, table.sum(), 13)

    def test_tables_cover_ties(self, ref):
        """The tie table really has equal energies across regions at the
        selection boundary, and the port's selection keeps them in
        (region, column) order."""
        table = ref["merge/ties/table"]
        assert len(np.unique(table)) < table.size
        region, col = ref["merge/ties/q2.region"], ref["merge/ties/q2.col"]
        assert list(zip(region, col)) == [(0, 0), (1, 0)]


class TestTwoRanks:
    @pytest.mark.parametrize("name", HIER)
    def test_hierarchical_run_matches_reference(self, ref, ranks, name):
        _check_run(ref, name, lambda f: _gathered(ranks, f"{name}/{f}"))
        _check_merge(lambda f: ranks[0][f"{name}/fleet.{f}"], ref, name)

    @pytest.mark.parametrize("name", HIER)
    def test_merge_replicated_one_gather_one_reduce(self, ranks, name):
        """Every rank holds the same merge, after exactly one all_gather
        and one all_reduce."""
        keys = [k for k in ranks[0] if k.startswith(f"{name}/fleet.")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
        for r in ranks:
            np.testing.assert_array_equal(r[f"{name}/collectives"], [1, 1])

    @pytest.mark.parametrize("name", HIER)
    def test_merge_epochs_exact(self, ref, ranks, name):
        """One merge per decision boundary at which any region refreshed,
        at least one."""
        fired = _gathered(ranks, f"{name}/m.did_refresh").any(0).sum()
        epochs = int(ranks[0][f"{name}/fleet.merge_epochs"])
        assert epochs == max(int(fired), 1)
        assert epochs == int(ref[f"{name}/fleet.merge_epochs"])

    def test_scenarios_cover_merges(self, ref):
        epochs = [int(ref[f"{n}/fleet.merge_epochs"]) for n in HIER]
        assert min(epochs) == 1 and max(epochs) > 2, epochs
        assert "h_chunk/masks" in ref

    @pytest.mark.parametrize("name", SHARD)
    def test_sharded_run_matches_reference(self, ref, ranks, name):
        _check_run(ref, name, lambda f: _gathered(ranks, f"{name}/{f}"))
        for r in ranks:
            np.testing.assert_array_equal(r[f"{name}/collectives"], [0, 0])

    @pytest.mark.parametrize("name", SHARD)
    def test_sharded_run_is_unsharded_run(self, ref, ranks, name):
        """The ranks' slices, put together, are the one-process
        ``batched_stream_run`` of the whole fleet bit for bit."""
        cfg = config_from_json(ref[f"{name}/cfg"])
        chunk = int(ref[f"{name}/chunk"])
        fin, m = batched_stream_run(
            cfg, state_from_numpy(ref, device="cpu", prefix=f"{name}/init."),
            torch.from_numpy(ref[f"{name}/x"]),
            chunk=None if chunk < 0 else chunk)
        flat = {**state_to_numpy(fin, "final."), **state_to_numpy(m, "m.")}
        for key, value in flat.items():
            np.testing.assert_array_equal(
                _gathered(ranks, f"{name}/{key}"), value, err_msg=key)


class TestOneRank:
    @pytest.mark.parametrize("chunk", [None, 4])
    def test_one_region_is_flat_driver(self, ref, world1, chunk):
        """One region on a one-rank group IS ``batched_stream_run`` bit for
        bit, and the merge selects that region's q columns by energy."""
        cfg = config_from_json(ref["h_chunk/cfg"])
        xs = torch.from_numpy(ref["h_chunk/x"][:1])
        masks = torch.from_numpy(ref["h_chunk/masks"][:1])
        st = hierarchical_stream_init(cfg, 1, seed=3, device="cpu")
        reset_collectives()
        fin, m, fleet = hierarchical_stream_run(cfg, world1.region, st, xs,
                                                masks, chunk=chunk)
        assert COLLECTIVES == {"all_gather": 1, "all_reduce": 1}
        fin_f, m_f = batched_stream_run(cfg, st, xs, masks, chunk=chunk)
        same = lambda a, b: np.testing.assert_array_equal(a.numpy(),
                                                          b.numpy())
        tree_map(same, fin, fin_f)
        tree_map(same, m, m_f)
        assert (fleet.basis.region == 0).all()
        assert sorted(fleet.basis.col.tolist()) == list(range(cfg.q))
        assert (fleet.basis.lam[:-1] >= fleet.basis.lam[1:]).all()
        assert int(fleet.merge_epochs) == max(
            int(m_f.did_refresh.any(0).sum()), 1)

    def test_hierarchical_q_limit_raises(self, ref, world1):
        cfg = config_from_json(ref["h_quiet/cfg"])
        st = hierarchical_stream_init(cfg, 2, device="cpu")
        xs = torch.from_numpy(ref["h_quiet/x"][:2])
        reset_collectives()
        with pytest.raises(ValueError, match="q_fleet"):
            hierarchical_stream_run(cfg, world1.region, st, xs,
                                    q_fleet=2 * cfg.q + 1)
        assert COLLECTIVES == {"all_gather": 0, "all_reduce": 0}

    def test_fleet_mesh_layout(self, world1):
        assert mesh_axis_sizes(world1) == {"region": 1, "data": 1}
        assert dist.get_world_size(world1.region) == 1
        with pytest.raises(ValueError, match="does not cover"):
            make_fleet_mesh(region=2)


class TestSharding:
    def test_contiguous_slices(self):
        x = torch.arange(12).reshape(6, 2)
        assert shard_networks(x, 1, 3).tolist() == [[4, 5], [6, 7]]
        assert shard_regions(x, 0, 2).tolist() == x[:3].tolist()

    @pytest.mark.parametrize("fn,what", [(shard_networks, "networks"),
                                         (shard_regions, "regions")])
    def test_counts_must_divide(self, fn, what):
        with pytest.raises(ValueError, match=f"5 {what} not divisible by 2"):
            fn(torch.zeros(5, 3), 0, 2)
        with pytest.raises(ValueError, match="rank 2 outside"):
            fn(torch.zeros(4, 3), 2, 2)
