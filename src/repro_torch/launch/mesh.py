"""Meshes (counterpart of ``repro.launch.mesh``).

The LM's pod meshes are ``torch.distributed.device_mesh.DeviceMesh``es
with the reference's axis names over the default process group's ranks:
16x16 = 256 ranks ``("data", "model")`` for one pod, 2x16x16 = 512
``("pod", "data", "model")`` for two (:func:`make_production_mesh`; the
dry run opens a fake group of that many ranks), and a (data, model) mesh
over however many ranks there are (:func:`make_local_mesh`).

The fleet's process-group layout (``make_fleet_mesh``): the reference
lays its devices out as a (region, data) mesh; here one
process per device takes that place, rank ``r * data + d`` at mesh
coordinate (r, d) as ``jax.make_mesh`` numbers them, and each axis is a
process group over the ranks that differ only along it.  Every process
group is opened with a ``file://`` store and a timeout, so no run waits on
a network port or hangs.
"""

from __future__ import annotations

import dataclasses
import datetime
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["FleetMesh", "init_fleet_process_group", "make_fleet_mesh",
           "make_production_mesh", "make_local_mesh", "mesh_axis_sizes"]


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """This rank's groups along the two fleet axes: ``region`` (the only
    axis the merge collectives cross) and ``data`` (the networks within a
    shard)."""

    region: dist.ProcessGroup
    data: dist.ProcessGroup
    sizes: tuple[tuple[str, int], ...]


def init_fleet_process_group(rank: int, world: int, store_dir, *,
                             device="cuda",
                             timeout_s: float = 120.0) -> torch.device:
    """Join the default process group: NCCL on a CUDA ``device`` (the
    rank's card, ``rank % device_count``), gloo on the CPU; a ``file://``
    store under ``store_dir`` (shared by every rank, removed by the
    caller) and a timeout of ``timeout_s`` seconds.  Returns the rank's
    device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=(Path(store_dir).resolve() / "store").as_uri(),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_fleet_mesh(region: int | None = None, data: int = 1) -> FleetMesh:
    """The (region, data) layout over the default group's ranks;
    ``region=None`` spreads the region axis over every rank.  Every rank
    must call it (each group is created by all ranks, in one order)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world // data if region is None else region
    if n * data != world:
        raise ValueError(f"a {n} x {data} mesh does not cover {world} ranks")
    region_group = data_group = None
    for d in range(data):
        ranks = [r * data + d for r in range(n)]
        g = dist.new_group(ranks)
        if rank in ranks:
            region_group = g
    for r in range(n):
        ranks = [r * data + d for d in range(data)]
        g = dist.new_group(ranks)
        if rank in ranks:
            data_group = g
    return FleetMesh(region=region_group, data=data_group,
                     sizes=(("region", n), ("data", data)))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """16x16 = 256 ranks per pod; 2x16x16 = 512 for two pods, over the
    default group (which must hold that many ranks).

    Axes: 'data' carries DP/FSDP, 'model' carries TP/EP; 'pod' (multi-pod)
    carries the cross-pod data-parallel / FSDP dimension.
    """
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, device_type: str = "cpu"):
    """A (data, model) mesh over the default group's ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a :class:`FleetMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, FleetMesh):
        return dict(mesh.sizes)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
