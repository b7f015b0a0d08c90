"""Contiguous sharding of a fleet's leading axis over ranks (counterpart of
``repro.distributed.sharding.shard_networks`` / ``shard_regions``).

The reference places a networks- or regions-leading pytree on a mesh axis
(``PartitionSpec(axis)``: device d holds the d-th contiguous block).  With
one process per device, rank r takes that same block of every leaf; the
count must divide by the ranks, as the reference's ``n % axis_size``
checks require.
"""

from __future__ import annotations

from repro_torch.streaming.driver import tree_map

__all__ = ["shard_networks", "shard_regions"]


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
