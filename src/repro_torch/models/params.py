"""Parameter schema system (counterpart of ``repro.models.params``).

A model's parameters are described once as a nested dict of :class:`P`
descriptors (shape + logical axis names + init law).  From the schema
:func:`init_params` materializes tensors on a device and
:func:`param_pspecs` derives the reference's ``PartitionSpec`` entries
for any rule set and mesh size (a tree of tuples, one entry a dim);
:func:`distribute_params` places a tree of tensors on a ``DeviceMesh`` as
DTensors by those entries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

__all__ = ["P", "init_params", "param_pspecs", "distribute_params",
           "tree_size", "tree_leaves", "tree_map", "unflatten"]


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter leaf: shape + logical axes + initialization."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis names, len == ndim
    init: str = "normal"                  # normal | zeros | ones
    fan_in_axes: tuple[int, ...] = ()     # dims whose product is fan-in
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(dotted path, leaf)`` of a nested dict, keys sorted at every level
    (the order ``jax.tree.flatten`` gives a dict)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves(tree[k], f"{prefix}{k}.")
        return out
    return [(prefix[:-1], tree)]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over every leaf of a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# a normal leaf whose fp32 draw would pass this many bytes is drawn block
# by block along its first axis (see _materialize)
DRAW_LIMIT = 2 * 2 ** 30


def _materialize(leaf: P, gen: torch.Generator, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """One leaf by its law: fp32 normal draws times ``scale / sqrt(fan_in)``
    (the whole leaf's fan-in), cast to ``dtype``.  A leaf whose fp32 draw
    would pass :data:`DRAW_LIMIT` is allocated once in ``dtype`` and drawn
    in blocks of its first (layer) axis, each block the most slices whose
    fp32 draw stays within the limit (one slice at least): the draw's peak
    is then one block, not the whole stack in fp32 beside its cast.  On
    the card such a leaf's values are other draws of the same law than a
    whole draw's, and the generator ends elsewhere."""
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=dtype, device=device)
    fan_in = 1
    for ax in leaf.fan_in_axes:
        fan_in *= leaf.shape[ax]
    std = leaf.scale / math.sqrt(max(fan_in, 1))
    if 4 * math.prod(leaf.shape) <= DRAW_LIMIT:
        w = torch.randn(leaf.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return w.mul_(std).to(dtype)
    out = torch.empty(leaf.shape, dtype=dtype, device=device)
    per = max(1, DRAW_LIMIT // (4 * math.prod(leaf.shape[1:])))
    for i in range(0, leaf.shape[0], per):
        block = out[i:i + per]
        block.copy_(torch.randn(block.shape, generator=gen,
                                dtype=torch.float32, device=device).mul_(std))
    return out


def init_params(schema: dict, gen: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None) -> dict:
    """Materialize a schema into tensors on ``device`` (default: the
    generator's device, which it must be): fp32 normal draws times
    ``scale / sqrt(fan_in)`` cast to ``dtype``, as the reference's law
    (a leaf past :data:`DRAW_LIMIT` in blocks, :func:`_materialize`);
    leaves drawn in sorted path order from ``gen``.  The draws are not
    ``jax.random``'s: a test that wants the reference's weights carries
    them across
    (:func:`repro_torch.convert.lm_params_from_numpy`)."""
    dev = gen.device if device is None else torch.device(device)
    return unflatten({path: _materialize(leaf, gen, dtype, dev)
                      for path, leaf in tree_leaves(schema)})


def unflatten(flat: dict[str, Any]) -> dict:
    """The nested dict of ``{dotted path: leaf}`` (inverse of
    :func:`tree_leaves`)."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, last = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def param_pspecs(schema: dict,
                 rules: dict[str, str | tuple[str, ...] | None],
                 mesh_axis_sizes: dict[str, int] | None = None) -> dict:
    """The ``PartitionSpec`` entries (a tuple a leaf) from logical-axis
    rules.

    ``rules`` maps logical axis name -> mesh axis (or tuple / None).  When
    ``mesh_axis_sizes`` is given, a mapping is dropped (replicated) if the
    dimension size is not divisible by the mesh-axis product: 8 KV heads
    cannot shard over a 16-way model axis, so they replicate.
    """
    from repro_torch.distributed.sharding import spec_entries
    return tree_map(lambda leaf: spec_entries(leaf.axes, rules,
                                              mesh_axis_sizes, leaf.shape),
                    schema)


def distribute_params(params: dict, specs: dict, mesh) -> dict:
    """``params`` (a tree of full tensors, the same on every rank) as
    DTensors on ``mesh`` by ``specs`` (from :func:`param_pspecs`): each
    rank keeps its own shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import to_placements
    flat = dict(tree_leaves(specs))
    return unflatten({
        path: distribute_tensor(t, mesh, to_placements(flat[path], mesh),
                                src_data_rank=None)
        for path, t in tree_leaves(params)})


def tree_size(tree: Any) -> int:
    """Total number of elements in a nested dict of tensors or P leaves."""
    def leaf_size(x):
        if isinstance(x, P):
            return math.prod(x.shape)
        return x.numel()
    return sum(leaf_size(x) for _, x in tree_leaves(tree))
