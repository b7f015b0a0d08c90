"""Parameter schema system (counterpart of ``repro.models.params``).

A model's parameters are described once as a nested dict of :class:`P`
descriptors (shape + logical axis names + init law); :func:`init_params`
materializes a schema into tensors on a device.  The reference's
``param_pspecs`` (a GSPMD partitioning rule) waits with ``launch/``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

__all__ = ["P", "init_params", "tree_size", "tree_leaves", "tree_map",
           "unflatten"]


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


def _materialize(leaf: P, gen: torch.Generator, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=dtype, device=device)
    fan_in = 1
    for ax in leaf.fan_in_axes:
        fan_in *= leaf.shape[ax]
    std = leaf.scale / math.sqrt(max(fan_in, 1))
    w = torch.randn(leaf.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(std).to(dtype)


def init_params(schema: dict, gen: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None) -> dict:
    """Materialize a schema into tensors on ``device`` (default: the
    generator's device, which it must be): fp32 normal draws times ``scale / sqrt(fan_in)`` cast to
    ``dtype``, as the reference's law; leaves drawn in sorted path order
    from ``gen``.  The draws are not ``jax.random``'s: a test that wants
    the reference's weights carries them across
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


def tree_size(tree: Any) -> int:
    """Total number of elements in a nested dict of tensors or P leaves."""
    def leaf_size(x):
        if isinstance(x, P):
            return math.prod(x.shape)
        return x.numel()
    return sum(leaf_size(x) for _, x in tree_leaves(tree))
