"""One rank of the port's distributed drivers, for tests/test_torch_hierarchy.py
and tests/test_torch_core_dist.py.

    python tests/torch_dist_child.py RANK WORLD STORE_DIR IN.npz OUT.npz

Joins a gloo process group of WORLD ranks through a ``file://`` store in
STORE_DIR (with a timeout, so a lost peer fails the run instead of
hanging it), then runs every scenario of IN.npz (the reference's inputs
and initial states, written by tests/torch_ref_child.py): each two-level
scenario (``h_*``) through ``hierarchical_stream_run`` over the mesh's
``region`` group, each sharded one (``s_*``) through
``sharded_stream_run`` over a (1, WORLD) mesh's ``data`` group.  Writes
this rank's final states and metrics, the merge and the collectives each
run issued to OUT.npz.  When IN.npz holds ``core/`` inputs (written by
tests/test_torch_core_dist.py) it first runs the D/A/F collectives, the
halo exchange and the sharded production steps and power iterations of
``repro_torch.core`` on them (:func:`core_scenarios`).  Imports no JAX.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import aggregation as agg
from repro_torch.core import power_iteration as pim
from repro_torch.core import production as prod
from repro_torch.launch.mesh import init_fleet_process_group, make_fleet_mesh
from repro_torch.streaming import (hierarchical_stream_run,
                                   sharded_stream_run)
from repro_torch.streaming.hierarchy import COLLECTIVES, reset_collectives

from torch_parity import config_from_json


def scenario(data, name):
    cfg = config_from_json(data[f"{name}/cfg"])
    states = state_from_numpy(data, device="cpu", prefix=f"{name}/init.")
    xs = torch.from_numpy(data[f"{name}/x"])
    chunk = int(data[f"{name}/chunk"])
    return cfg, states, xs, None if chunk < 0 else chunk


def core_scenarios(data, rank, world):
    """``repro_torch.core``'s collectives and sharded steps on this
    rank's slice of the ``core/`` inputs, in the default group; each
    output beside the collectives it issued (``*/collectives``: all_reduce,
    broadcast, all_gather, halo_exchange)."""
    out = {}

    def counted(name, fn):
        agg.reset_collectives()
        res = fn()
        out[f"core/{name}/collectives"] = np.array(
            [agg.COLLECTIVES[k] for k in ("all_reduce", "broadcast",
                                          "all_gather", "halo_exchange")])
        for i, r in enumerate(res if isinstance(res, tuple) else (res,)):
            out[f"core/{name}/{i}"] = r.numpy()

    get = lambda k: torch.from_numpy(data[f"core/{k}"])
    mine = get("records")[rank]                   # (3, halo + 2) a rank
    halo = int(data["core/halo"])
    counted("a_op", lambda: agg.a_op(mine))
    for root in range(world):
        counted(f"f_op{root}", lambda: agg.f_op(mine, root=root))
    counted("d_op", lambda: agg.d_op(mine))
    counted("d_op_tiled", lambda: agg.d_op(mine, tiled=True))
    for wrap in (False, True):
        counted(f"halo_wrap{int(wrap)}",
                lambda: agg.halo_exchange(mine, halo, wrap=wrap))

    band, v, W, V = get("band"), get("v"), get("w_prev"), get("V")
    v0, V0 = get("v0"), get("V0")
    local = band.shape[1] // world
    rows = slice(rank * local, (rank + 1) * local)
    bp = prod.shard_band(band, rank, world)
    for k in range(W.shape[1] + 1):
        counted(f"deflated{k}", lambda: prod.sharded_pim_deflated_step(
            bp, v[rows], W[rows, :k]))
    counted("block", lambda: prod.sharded_pim_block_step(bp, V[rows]))
    counted("power", lambda: tuple(pim.deflated_power_iteration(
        lambda u: prod.halo_matvec(bp, u), local, v0.shape[0],
        v0=v0[:, rows], aggregate=agg.a_op, device="cpu")))

    def ortho():
        res = pim.orthogonal_iteration(
            lambda U: prod.halo_matmul(bp, U), local, V0.shape[1],
            v0=V0[rows], aggregate=agg.a_op, device="cpu")
        return res.W, res.eigenvalues, torch.tensor(res.iterations)

    counted("ortho", ortho)
    return out


def main(rank, world, store_dir, path_in, path_out):
    data = dict(np.load(path_in))
    names = sorted({k.split("/")[0] for k in data
                    if k.startswith(("h_", "s_"))})
    out = {}
    init_fleet_process_group(rank, world, store_dir, device="cpu",
                             timeout_s=60.0)
    try:
        if any(k.startswith("core/") for k in data):
            out.update(core_scenarios(data, rank, world))
        regions = make_fleet_mesh()                    # (WORLD, 1)
        networks = make_fleet_mesh(region=1, data=world)
        for name in names:
            cfg, states, xs, chunk = scenario(data, name)
            reset_collectives()
            if name.startswith("h_"):
                masks = (torch.from_numpy(data[f"{name}/masks"])
                         if f"{name}/masks" in data else None)
                qf = int(data[f"{name}/q_fleet"])
                fin, m, fleet = hierarchical_stream_run(
                    cfg, regions.region, states, xs, masks,
                    q_fleet=None if qf < 0 else qf, chunk=chunk)
                out.update(state_to_numpy(fleet, f"{name}/fleet."))
            else:
                fin, m = sharded_stream_run(cfg, networks.data, states, xs,
                                            chunk=chunk)
            out.update(state_to_numpy(fin, f"{name}/final."))
            out.update(state_to_numpy(m, f"{name}/m."))
            out[f"{name}/collectives"] = np.array(
                [COLLECTIVES["all_gather"], COLLECTIVES["all_reduce"]])
    finally:
        dist.destroy_process_group()
    np.savez(path_out, **out)


if __name__ == "__main__":
    r, w, store, src, dst = sys.argv[1:6]
    main(int(r), int(w), store, src, dst)
