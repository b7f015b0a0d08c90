"""Aggregation service primitives (counterpart of ``repro.core.aggregation``).

An aggregation service is defined by three primitives (paper Sec. 2.1.2):
``init`` turns a local measurement into a partial state record, ``f``
merges two records (associative and commutative) and ``e`` evaluates the
root record into the requested result.

This module holds

1. a copy of the reference's **routing-tree simulator**
   (:func:`aggregate_tree`, :func:`lossy_aggregate_tree`,
   :func:`tree_aggregate_fn`: numpy, definition for definition the same
   code, held equal by tests/test_torch_core.py), which executes
   init/f/e along a :class:`~repro_torch.core.topology.RoutingTree` and
   counts the packets each node processes, and

2. the paper's **D / A / F operations over a process group**
   (:func:`a_op`, :func:`d_op`, :func:`f_op`, :func:`halo_exchange`),
   the ``torch.distributed`` form of the reference's mesh collectives: one
   rank per device, ``group`` in place of the mesh axis name (None: the
   default group).  ``a_op`` fuses A (aggregate up) and F (flood down),
   as ``all_reduce`` delivers the sum to every rank.  Each call adds one
   to :data:`COLLECTIVES` under the collective it issues.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.topology import RoutingTree

__all__ = [
    "AggregationPrimitives", "NORM_PRIMITIVES", "aggregate_tree",
    "TreeAggregationResult", "LossyAggregationResult", "lossy_aggregate_tree",
    "a_op", "d_op", "f_op", "halo_exchange",
    "tree_aggregate_fn", "COLLECTIVES", "reset_collectives",
]


@dataclasses.dataclass(frozen=True)
class AggregationPrimitives:
    """The (init, f, e) triple of Sec. 2.1.2."""

    init: Callable[[Any], Any]
    merge: Callable[[Any, Any], Any]
    evaluate: Callable[[Any], Any]
    record_size: Callable[[Any], int] = lambda record: int(np.size(record))


NORM_PRIMITIVES = AggregationPrimitives(
    init=lambda x: np.asarray(x, dtype=np.float64) ** 2,
    merge=lambda a, b: a + b,
    evaluate=lambda rec: np.sqrt(rec),
)


@dataclasses.dataclass(frozen=True)
class TreeAggregationResult:
    value: Any                    # e(root record)
    packets: np.ndarray           # (p,) packets processed per node (rx + tx)
    record_sizes: np.ndarray      # (p,) size of the record each node sent


def aggregate_tree(tree: RoutingTree, values: Sequence[Any],
                   primitives: AggregationPrimitives) -> TreeAggregationResult:
    """Execute one epoch of the aggregation service on the routing tree.

    Nodes are processed deepest-first; each node merges its children's partial
    state records into its own ``init`` record and transmits the result to its
    parent (paper Fig. 2/3).  Packet accounting matches Sec. 2.1.3's A
    operation: node i transmits ``q`` packets (q = record size) and receives
    the records of its direct children.
    """
    p = tree.p
    records: list[Any] = [primitives.init(values[i]) for i in range(p)]
    rx = np.zeros(p, dtype=np.int64)
    tx = np.zeros(p, dtype=np.int64)
    sizes = np.zeros(p, dtype=np.int64)

    order = np.argsort(-tree.depth)          # deepest first
    for i in order:
        i = int(i)
        par = int(tree.parent[i])
        size = primitives.record_size(records[i])
        sizes[i] = size
        if par >= 0:
            records[par] = primitives.merge(records[par], records[i])
            tx[i] += size
            rx[par] += size
    # the root transmits the final record to the base station
    tx[tree.root] += sizes[tree.root]
    return TreeAggregationResult(
        value=primitives.evaluate(records[tree.root]),
        packets=rx + tx,
        record_sizes=sizes,
    )


# --------------------------------------------------------------------------
# Lossy links: the same epoch under per-hop Bernoulli loss + ARQ
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LossyAggregationResult:
    """One lossy epoch: value, packets (incl. retransmissions), delivery map.

    ``attempts[i]`` is the number of transmissions node i spent on its
    parent hop (0 for the root and for inactive nodes); ``delivered[i]``
    marks whether its record arrived within the retry budget.  A failed hop
    loses the node's *merged subtree record* — exactly the blast radius a
    real TAG epoch suffers.
    """

    value: Any
    packets: np.ndarray           # (p,) rx + tx per node, retransmissions incl.
    record_sizes: np.ndarray      # (p,) size of the record each node sent
    delivered: np.ndarray         # (p,) bool — record reached the parent
    attempts: np.ndarray          # (p,) transmissions spent on the parent hop
    active: np.ndarray            # (p,) bool — nodes that took part


def lossy_aggregate_tree(tree: RoutingTree, values: Sequence[Any],
                         primitives: AggregationPrimitives,
                         fault, rng: np.random.Generator,
                         active: np.ndarray | None = None,
                         ) -> LossyAggregationResult:
    """One epoch of the aggregation service over lossy links.

    Same deepest-first schedule as :func:`aggregate_tree`; every parent hop
    runs the :class:`repro.core.faults.FaultModel` ARQ policy
    (``fault.transmit``): each attempt books ``record_size`` tx packets at
    the sender, only the delivered attempt books rx packets at the parent
    (a lost packet never reaches the radio on the other side; acks are not
    counted).  ``active`` masks out dead / detached nodes — pass the
    ``attached`` mask from :func:`repro.core.topology.repair_tree` after a
    node-death wave, with the tree being the *repaired* tree.

    At ``fault.link_loss == 0`` and full ``active`` this is **bit-identical**
    to :func:`aggregate_tree` in value and packet counts (no randomness is
    consumed), which is the differential anchor in tests/test_faults.py.
    The root's uplink to the base station is wired, hence reliable.
    """
    p = tree.p
    if active is None:
        active = np.ones(p, dtype=bool)
    active = np.asarray(active, dtype=bool)
    if not active[tree.root]:
        raise ValueError("the root must be active")
    # fail fast on an inconsistent mask: an active node routing through a
    # dead/detached parent means the caller passed a raw alive mask where
    # the tree needs repair_tree's `attached` mask
    parents = tree.parent
    for i in range(p):
        if active[i] and i != tree.root and (
                parents[i] < 0 or not active[parents[i]]):
            raise ValueError(
                f"active node {i} has a dead or detached parent; repair the "
                f"tree first and pass repair_tree's `attached` mask")

    records: list[Any] = [primitives.init(values[i]) if active[i] else None
                          for i in range(p)]
    rx = np.zeros(p, dtype=np.int64)
    tx = np.zeros(p, dtype=np.int64)
    sizes = np.zeros(p, dtype=np.int64)
    delivered = np.zeros(p, dtype=bool)
    attempts = np.zeros(p, dtype=np.int64)

    order = np.argsort(-tree.depth)          # deepest first
    for i in order:
        i = int(i)
        if not active[i]:
            continue
        par = int(tree.parent[i])
        size = primitives.record_size(records[i])
        sizes[i] = size
        if par >= 0:
            ok, n_tries = fault.transmit(rng)
            attempts[i] = n_tries
            tx[i] += size * n_tries
            if ok:
                delivered[i] = True
                rx[par] += size
                records[par] = primitives.merge(records[par], records[i])
    # the root transmits the final record to the base station (wired uplink)
    delivered[tree.root] = True
    tx[tree.root] += sizes[tree.root]
    return LossyAggregationResult(
        value=primitives.evaluate(records[tree.root]),
        packets=rx + tx,
        record_sizes=sizes,
        delivered=delivered,
        attempts=attempts,
        active=active,
    )


def tree_aggregate_fn(tree: RoutingTree,
                      primitives: AggregationPrimitives) -> Callable:
    """An ``aggregate`` callable (for power_iteration) backed by the simulator.

    Takes a per-node array of local partial sums (axis 0 = node) and returns
    the tree-aggregated total, mimicking an A+F round trip.  Only used in the
    WSN simulation/tests — the production path uses :func:`a_op`.
    """

    def aggregate(local: np.ndarray) -> np.ndarray:
        res = aggregate_tree(tree, list(np.asarray(local)), primitives)
        return res.value

    return aggregate


# --------------------------------------------------------------------------
# D / A / F operations as torch.distributed collectives
# --------------------------------------------------------------------------
COLLECTIVES = {"all_reduce": 0, "broadcast": 0, "all_gather": 0,
               "halo_exchange": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def _global(group, rank: int) -> int:
    """The default group's rank of ``group``'s rank ``rank``."""
    return rank if group is None else dist.get_global_rank(group, rank)


def a_op(x: torch.Tensor, group=None) -> torch.Tensor:
    """A operation (+ fused F): the sum over the group's ranks, delivered
    to every rank (one ``all_reduce``; ``x`` itself is left as it was)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["all_reduce"] += 1
    return out


def f_op(x: torch.Tensor, group=None, root: int = 0) -> torch.Tensor:
    """F operation: flood the value of the group's rank ``root`` to every
    rank (one ``broadcast``: what the reference's masked psum, in which
    only the root contributes, delivers)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=_global(group, root), group=group)
    COLLECTIVES["broadcast"] += 1
    return out


def d_op(x: torch.Tensor, group=None, tiled: bool = False) -> torch.Tensor:
    """D operation (default collection): every rank's raw record, stacked
    on a new leading axis in rank order, or concatenated along axis 0
    when ``tiled`` (one ``all_gather``)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.cat(parts) if tiled else torch.stack(parts)


def halo_exchange(block: torch.Tensor, halo: int, group=None,
                  wrap: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbour exchange of boundary columns over the ring of ranks.

    The paper's 'node broadcasts v_t[i] and receives v_t[j], j in N_i'
    (Sec. 3.4.3): each rank sends its right edge to its right neighbour
    and its left edge to its left neighbour, in one
    ``batch_isend_irecv``.

    Parameters
    ----------
    block: (..., local_p) this rank's slice of the feature axis.
    halo: number of boundary columns to exchange (at most local_p).
    wrap: if False (default) the ring is broken at its ends (the block
        boundary of a banded matrix): the first rank receives zeros from
        the left, the last from the right.

    Returns
    -------
    (from_left, from_right): the ``halo`` columns received from the left
    and right neighbours, shaped (..., halo).
    """
    if not 0 < halo <= block.shape[-1]:
        raise ValueError(f"halo {halo} outside [1, {block.shape[-1]}] "
                         f"(the local width)")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    right_edge = block[..., -halo:].contiguous()
    left_edge = block[..., :halo].contiguous()
    from_left = torch.zeros_like(right_edge)
    from_right = torch.zeros_like(left_edge)
    if n == 1:                               # a ring of one: no peer
        if wrap:
            from_left.copy_(right_edge)
            from_right.copy_(left_edge)
    else:
        left, right = r - 1, r + 1
        if wrap:
            left, right = left % n, right % n
        ops = []

        def p2p(op, tensor, peer):
            if 0 <= peer < n:
                ops.append(dist.P2POp(op, tensor, _global(group, peer),
                                      group))

        # rightward traffic first, then leftward, on every rank: two
        # messages between the same two ranks (a wrapped ring of two)
        # meet in one order
        p2p(dist.isend, right_edge, right)
        p2p(dist.irecv, from_left, left)
        p2p(dist.isend, left_edge, left)
        p2p(dist.irecv, from_right, right)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    COLLECTIVES["halo_exchange"] += 1
    return from_left, from_right
