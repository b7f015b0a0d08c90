"""Sharding policy (counterpart of ``repro.distributed.sharding``).

Two halves:

* the LM's FSDP + TP plan: logical-axis rules (:func:`param_rules`,
  :func:`act_rules`, the reference's dicts), mapped onto a
  ``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
  names (``("data", "model")`` for 16x16, ``("pod", "data", "model")`` for
  2x16x16).  A ``PartitionSpec`` entry becomes DTensor placements: a mesh
  axis named in tensor dim d's entry is ``Shard(d)`` on that mesh dim, a
  tuple such as ``("pod", "data")`` is ``Shard(d)`` on each, in the mesh's
  major-to-minor order, and every other mesh dim is ``Replicate()``.
  Model code never names mesh axes: it calls :func:`shard_activation`
  with logical axes, which inside an :func:`activation_sharding` context
  redistributes a DTensor to its placements (the counterpart of
  ``with_sharding_constraint``) and is a no-op outside one or on a plain
  tensor.  :func:`unshard_fsdp` gathers a layer's FSDP-sharded weights
  before use, the all-gather GSPMD inserts for the reference;
* contiguous sharding of a fleet's leading axis over ranks
  (:func:`shard_networks` / :func:`shard_regions`): the reference places
  a networks- or regions-leading pytree on a mesh axis (device d holds the
  d-th contiguous block); with one process per device, rank r takes that
  same block of every leaf, and the count must divide by the ranks.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch

from repro_torch.streaming.driver import tree_map

__all__ = [
    "PARAM_RULES", "ACT_RULES", "FSDP_AXES", "param_rules", "act_rules",
    "activation_sharding", "current_mesh", "logical_to_pspec",
    "spec_entries", "to_placements", "shard_window", "shard_activation",
    "unshard_fsdp", "is_dtensor", "from_local",
    "shard_networks", "shard_regions",
]

FSDP_AXES = ("pod", "data")


# -- parameter logical axes -------------------------------------------------
# "embed" carries FSDP (ZeRO-3) sharding; everything wide goes to TP.
def param_rules(multi_pod: bool, fsdp: bool = True) -> dict:
    fsdp_axes = (("pod", "data") if multi_pod else ("data",)) if fsdp else None
    return {
        "embed": fsdp_axes,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "state": None,
        "conv": None,
        "layers": None,
        "expert_mlp": None,          # per-expert ffn dim (sharded via experts)
    }


def act_rules(multi_pod: bool, seq_shard: bool = False) -> dict:
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch_axes,
        "seq": "data" if seq_shard else None,
        "kv_seq": None,
        "act_embed": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        "act_experts": "model",
        "act_ssm_inner": "model",
        "act_ssm_heads": "model",
        "act_state": None,
        "capacity": None,
    }


PARAM_RULES = param_rules(multi_pod=False)
ACT_RULES = act_rules(multi_pod=False)


# -- activation constraint context ------------------------------------------
class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict | None = None


_CTX = _Ctx()


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict):
    """Make :func:`shard_activation` redistribute within (``mesh`` a
    ``DeviceMesh`` with named dims)."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    """The mesh of the active activation_sharding context (None outside)."""
    return _CTX.mesh


def _mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_entries(axes: Sequence[str | None], rules: dict,
                 sizes: dict[str, int] | None = None,
                 dims: Sequence[int] | None = None) -> tuple:
    """The reference's ``PartitionSpec`` entries for logical ``axes``: the
    rule's mesh axis (a name, or a tuple of names for more than one), or
    None where the rule says none or, given ``sizes`` and ``dims``, where
    the dimension does not divide by the product of the mesh axes (it is
    replicated: 8 KV heads over a 16-way model axis)."""
    entries = []
    for i, ax in enumerate(axes):
        mesh_axes = rules.get(ax) if ax is not None else None
        if mesh_axes is None:
            entries.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        if dims is not None and sizes:
            total = 1
            for m in mesh_axes:
                total *= sizes.get(m, 1)
            if total == 0 or dims[i] % total != 0:
                entries.append(None)
                continue
        entries.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    return tuple(entries)


def to_placements(entries: Sequence, mesh) -> tuple:
    """DTensor placements of ``PartitionSpec`` entries on ``mesh``: mesh dim
    m is ``Shard(d)`` where its name is in entry d, else ``Replicate()``.
    A mesh axis the mesh lacks (``"pod"`` on a 16x16 mesh) is skipped, as
    a size-1 axis would be."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() for _ in mesh.mesh_dim_names]
    for d, e in enumerate(entries):
        if e is None:
            continue
        for name in ((e,) if isinstance(e, str) else e):
            if name in mesh.mesh_dim_names:
                pl[mesh.mesh_dim_names.index(name)] = Shard(d)
    return tuple(pl)


def shard_window(shape, mesh, placements) -> tuple[tuple, tuple]:
    """(local shape, global offset of each dim) of this rank's shard of a
    tensor of global ``shape``: ``Shard(d)`` splits dim d as
    ``torch.chunk`` does (pieces of ``ceil(n/k)``), mesh dims in order,
    major to minor.  Plain integer arithmetic, so it holds on fake
    tensors too."""
    from torch.distributed.tensor import Shard
    size, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            d, k = p.dim, mesh.shape[m]
            c = -(-size[d] // k)
            lo = min(coord[m] * c, size[d])
            off[d] += lo
            size[d] = min(lo + c, size[d]) - lo
    return tuple(size), tuple(off)


def logical_to_pspec(axes: Sequence[str | None], rules: dict, mesh,
                     dims: Sequence[int] | None = None) -> tuple:
    """The placements on ``mesh`` of a tensor with logical ``axes`` (and
    sizes ``dims``, for the reference's divisibility fallback)."""
    return to_placements(spec_entries(axes, rules, _mesh_sizes(mesh), dims),
                         mesh)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def from_local(t: torch.Tensor, mesh, placements, shape=None):
    """A DTensor of global ``shape`` (default: ``t``'s, replicated) whose
    shard on this rank is ``t`` (made contiguous), with contiguous global
    strides: no communication, no check across ranks.  Shards may be
    uneven, so the shape is given, not inferred."""
    from torch.distributed.tensor import DTensor
    shape = tuple(t.shape if shape is None else shape)
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return DTensor.from_local(t.contiguous(), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


class _ConstrainGrad(torch.autograd.Function):
    """The identity, whose backward redistributes the gradient to the
    activation's placements: ``with_sharding_constraint`` constrains the
    cotangent as well.  Without it a gradient that arrives as a partial
    sum over ``model`` stays one, and the products behind it gather their
    weights rather than reduce it."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def shard_activation(x: torch.Tensor, axes: Sequence[str | None]):
    """Redistribute an activation (and, in the backward pass, its
    gradient) to its logical placements inside an
    :func:`activation_sharding` context; a no-op outside one or on a plain
    tensor."""
    if _CTX.mesh is None or _CTX.rules is None or not is_dtensor(x):
        return x
    pl = logical_to_pspec(axes, _CTX.rules, _CTX.mesh, dims=x.shape)
    if tuple(x.placements) != pl:
        x = x.redistribute(_CTX.mesh, pl)
    if not x.requires_grad:
        return x
    return _ConstrainGrad.apply(x, pl)


def unshard_fsdp(tree):
    """Inside an :func:`activation_sharding` context, each DTensor leaf of
    ``tree`` with its FSDP mesh dims (``pod``, ``data``) made
    ``Replicate()``: the all-gather of a layer's weights before its use,
    which the reference's compiler inserts (its backward is the gradient's
    reduce-scatter).  Plain tensors and other placements are untouched."""
    mesh = _CTX.mesh
    if mesh is None:
        return tree
    from torch.distributed.tensor import Replicate
    fsdp = [i for i, n in enumerate(mesh.mesh_dim_names) if n in FSDP_AXES]

    def gather(x):
        if not is_dtensor(x) or all(x.placements[i].is_replicate()
                                     for i in fsdp):
            return x
        pl = list(x.placements)
        for i in fsdp:
            pl[i] = Replicate()
        return x.redistribute(x.device_mesh, pl)

    from repro_torch.models.params import tree_map as map_dict
    return map_dict(gather, tree)


# -- fleet axes -------------------------------------------------------------
def _shard(tree, rank: int, world: int, what: str):
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")

    def local(t):
        n = t.shape[0]
        if n % world != 0:
            raise ValueError(f"{n} {what} not divisible by {world} ranks")
        size = n // world
        return t[rank * size:(rank + 1) * size]

    return tree_map(local, tree)


def shard_networks(tree, rank: int, world: int):
    """Rank ``rank``'s contiguous block of a networks-leading tree (a
    tensor, or NamedTuples of tensors such as a ``StreamState``)."""
    return _shard(tree, rank, world, "networks")


def shard_regions(tree, rank: int, world: int):
    """Rank ``rank``'s contiguous block of a regions-leading tree."""
    return _shard(tree, rank, world, "regions")
