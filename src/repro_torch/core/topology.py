"""Copy of ``repro.core.topology`` for the PyTorch port
(held equal to it by tests/test_torch_streaming.py).

Network topology: sensor layouts, radio neighborhoods, routing trees.

Implements the network model of the paper (Sec. 2.1 and 4.2):

* a static network of ``p`` sensors at fixed 2-D positions,
* a *radio range* ``r`` defining the neighborhood
  ``N_i = { j != i : ||pos_i - pos_j|| <= r }``,
* a shortest-path routing tree rooted at the sink-connected node, built exactly
  as in Sec. 4.2: starting from the root, sensors attach to the in-range parent
  that is closest (in hops, then distance) to the base station,
* per-node packet counts for the three network operations of Sec. 2.1.3:
  D (default collection), A (aggregation), F (feedback).

The TPU mapping (DESIGN.md Sec. 2) replaces the irregular neighborhood graph by
a banded layout; :func:`bandwidth_reduce` provides the (reverse Cuthill-McKee)
ordering that justifies that regularization for arbitrary sensor graphs.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Sequence

import numpy as np

__all__ = [
    "SensorTopology",
    "RoutingTree",
    "grid_layout",
    "berkeley_like_layout",
    "build_topology",
    "bandwidth_reduce",
    "repair_tree",
]


def grid_layout(rows: int, cols: int, spacing: float = 1.0, jitter: float = 0.0,
                seed: int = 0) -> np.ndarray:
    """Regular ``rows x cols`` sensor grid with optional positional jitter."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(cols), np.arange(rows))
    pos = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64) * spacing
    if jitter > 0:
        pos = pos + rng.uniform(-jitter, jitter, size=pos.shape)
    return pos


def berkeley_like_layout(p: int = 52, seed: int = 7) -> np.ndarray:
    """A 2-D layout statistically similar to the Intel-Berkeley lab deployment.

    The lab floorplan is roughly a 40 m x 30 m rectangle with sensors placed
    along walls/desk rows.  We generate a perturbed double-ring + interior rows
    layout in a 40x30 box.  The exact trace geometry is not redistributable
    offline (DESIGN.md Sec. 7); the surrogate preserves what the paper's
    analysis depends on: a connected graph at radio range >= ~6 m and distant
    pairs ~45 m apart.
    """
    rng = np.random.default_rng(seed)
    pos = []
    # perimeter ring
    n_ring = p // 2
    t = np.linspace(0, 1, n_ring, endpoint=False)
    ring = np.stack([
        20 + 19 * np.cos(2 * np.pi * t),
        15 + 13 * np.sin(2 * np.pi * t),
    ], axis=1)
    pos.append(ring)
    # interior desk rows
    n_rows = p - n_ring
    xs = rng.uniform(4, 36, size=n_rows)
    ys = np.tile(np.array([7.5, 15.0, 22.5]), n_rows // 3 + 1)[:n_rows]
    pos.append(np.stack([xs, ys], axis=1))
    out = np.concatenate(pos, axis=0)[:p]
    out = out + rng.uniform(-0.8, 0.8, size=out.shape)
    return out


@dataclasses.dataclass(frozen=True)
class RoutingTree:
    """Routing tree (paper Fig. 1/6): ``parent[i]`` is -1 for the root."""

    parent: np.ndarray          # (p,) int, parent[root] == -1
    root: int
    depth: np.ndarray           # (p,) int, hop distance to root

    @property
    def p(self) -> int:
        return int(self.parent.shape[0])

    def children_counts(self) -> np.ndarray:
        """C_i: number of direct children of node i."""
        counts = np.zeros(self.p, dtype=np.int64)
        for i, par in enumerate(self.parent):
            if par >= 0:
                counts[par] += 1
        return counts

    def subtree_sizes(self) -> np.ndarray:
        """RT_i: size of the subtree rooted at node i (including i)."""
        sizes = np.ones(self.p, dtype=np.int64)
        # process nodes from deepest to shallowest
        order = np.argsort(-self.depth)
        for i in order:
            par = self.parent[i]
            if par >= 0:
                sizes[par] += sizes[i]
        return sizes

    # ---- Packet accounting, paper Sec. 2.1.3 ------------------------------
    def load_default(self) -> np.ndarray:
        """D operation per-node load: 2*RT_i - 1 packets/epoch."""
        return 2 * self.subtree_sizes() - 1

    def load_aggregation(self, q: int = 1) -> np.ndarray:
        """A operation per-node load: q*(C_i + 1) packets/epoch."""
        return q * (self.children_counts() + 1)

    def load_feedback(self) -> np.ndarray:
        """F operation: 2 packets for non-leaves (recv+fwd), 1 for leaves."""
        counts = self.children_counts()
        load = np.where(counts > 0, 2, 1)
        load[self.root] = 1  # root only transmits downward (receives from sink)
        return load.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class SensorTopology:
    """Sensor positions + radio-range neighborhood graph + routing tree."""

    positions: np.ndarray        # (p, 2)
    radio_range: float
    adjacency: np.ndarray        # (p, p) bool, no self loops
    tree: RoutingTree

    @property
    def p(self) -> int:
        return int(self.positions.shape[0])

    def neighborhoods(self) -> list[np.ndarray]:
        """N_i for every node (indices, excluding i)."""
        return [np.nonzero(self.adjacency[i])[0] for i in range(self.p)]

    def neighborhood_sizes(self) -> np.ndarray:
        return self.adjacency.sum(axis=1).astype(np.int64)

    def covariance_mask(self) -> np.ndarray:
        """Local covariance hypothesis mask: allowed (i, j) entries.

        c_ij is kept iff j in N_i or j == i (paper Sec. 3.3).
        """
        return self.adjacency | np.eye(self.p, dtype=bool)

    def load_covariance_update(self) -> np.ndarray:
        """Per-epoch load of the distributed covariance update (Sec. 3.3.2).

        Node i sends 1 packet (its measurement, local broadcast) and receives
        |N_i| packets.
        """
        return 1 + self.neighborhood_sizes()

    def load_pim_iteration(self, k: int = 1) -> np.ndarray:
        """Per-node load of one distributed PIM iteration for component k.

        Sec. 3.4.5: Cv needs 1 send + |N_i| receives;  the normalization is one
        A + one F op; the orthogonalization against the k-1 previous
        eigenvectors is k-1 A ops + k-1 F ops (partial state records of size
        k-1 counted element-wise, as in the paper's q^2 term).
        """
        halo = 1 + self.neighborhood_sizes()
        agg = self.tree.load_aggregation(q=1) + self.tree.load_feedback()
        return halo + k * agg

    def load_pim_total(self, q: int, iters_per_component: Sequence[int]) -> np.ndarray:
        """Total PIM load for extracting q components (paper Fig. 14)."""
        if len(iters_per_component) != q:
            raise ValueError("need one iteration count per component")
        total = np.zeros(self.p, dtype=np.int64)
        for k in range(1, q + 1):
            total += iters_per_component[k - 1] * self.load_pim_iteration(k=k)
        return total


def _bfs_depths(adj: np.ndarray, root: int) -> np.ndarray:
    p = adj.shape[0]
    depth = np.full(p, -1, dtype=np.int64)
    depth[root] = 0
    dq = deque([root])
    while dq:
        u = dq.popleft()
        for v in np.nonzero(adj[u])[0]:
            if depth[v] < 0:
                depth[v] = depth[u] + 1
                dq.append(v)
    return depth


def build_topology(positions: np.ndarray, radio_range: float,
                   root: int | None = None) -> SensorTopology:
    """Build the neighborhood graph and shortest-path routing tree (Sec. 4.2).

    The root defaults to the sensor closest to the top-right corner of the
    bounding box (the paper's sink-connected node in Fig. 6).
    Raises if the graph is disconnected at this radio range (the paper's
    minimum viable range is the smallest r that connects all sensors).
    """
    positions = np.asarray(positions, dtype=np.float64)
    p = positions.shape[0]
    d2 = ((positions[:, None, :] - positions[None, :, :]) ** 2).sum(-1)
    adj = d2 <= radio_range ** 2
    np.fill_diagonal(adj, False)

    if root is None:
        corner = positions.max(axis=0)
        root = int(np.argmin(((positions - corner) ** 2).sum(axis=1)))

    depth = _bfs_depths(adj, root)
    if (depth < 0).any():
        missing = int((depth < 0).sum())
        raise ValueError(
            f"radio range {radio_range} leaves {missing} sensors disconnected")

    # Shortest-path parent choice: in-range node with smallest depth, ties by
    # Euclidean distance to the root (Sec. 4.2's 'closest to the base station').
    parent = np.full(p, -1, dtype=np.int64)
    droot = ((positions - positions[root]) ** 2).sum(axis=1)
    for i in range(p):
        if i == root:
            continue
        nbrs = np.nonzero(adj[i])[0]
        up = nbrs[depth[nbrs] == depth[i] - 1]
        parent[i] = int(up[np.argmin(droot[up])])

    tree = RoutingTree(parent=parent, root=root, depth=depth)
    return SensorTopology(positions=positions, radio_range=float(radio_range),
                          adjacency=adj, tree=tree)


def repair_tree(topo: SensorTopology,
                alive: np.ndarray) -> tuple[RoutingTree, np.ndarray]:
    """Rebuild the routing tree on the alive subgraph (Sec. 4.2 re-run).

    When nodes die, the subtrees they carried are orphaned.  Repair re-applies
    the paper's tree-construction rule on the subgraph induced by ``alive``:
    BFS depths from the root over alive nodes only, then every alive node
    re-attaches to the in-range *alive* parent one hop closer to the root,
    ties broken by Euclidean distance to the root — exactly how the original
    tree was built, so a fault-free repair is a no-op.

    Returns ``(tree, attached)``.  ``attached[i]`` marks alive nodes with a
    radio path to the root; alive-but-unreachable nodes (their only routes
    ran through dead nodes) are *network-dead*: ``parent == -2``,
    ``depth == -1``, and they take no part in aggregation until a revival
    reconnects them.  Raises if the root itself is dead — there is no tree
    to repair, the network is gone.
    """
    alive = np.asarray(alive, dtype=bool)
    if alive.shape != (topo.p,):
        raise ValueError(f"alive mask shape {alive.shape} != ({topo.p},)")
    root = topo.tree.root
    if not alive[root]:
        raise ValueError("root (sink-connected node) is dead; no repair possible")

    adj = topo.adjacency & alive[None, :] & alive[:, None]
    depth = _bfs_depths(adj, root)
    attached = depth >= 0

    parent = np.full(topo.p, -2, dtype=np.int64)
    parent[root] = -1
    droot = ((topo.positions - topo.positions[root]) ** 2).sum(axis=1)
    for i in range(topo.p):
        if i == root or not attached[i]:
            continue
        nbrs = np.nonzero(adj[i])[0]
        up = nbrs[depth[nbrs] == depth[i] - 1]
        parent[i] = int(up[np.argmin(droot[up])])

    return RoutingTree(parent=parent, root=root, depth=depth), attached


def bandwidth_reduce(adjacency: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of a neighborhood graph.

    Returns a permutation ``perm`` such that relabelling sensors by ``perm``
    concentrates the covariance mask near the diagonal — this is the bridge
    from the paper's irregular WSN graph to the banded layout used by the TPU
    kernels (DESIGN.md Sec. 2.1).
    """
    p = adjacency.shape[0]
    degrees = adjacency.sum(axis=1)
    visited = np.zeros(p, dtype=bool)
    order: list[int] = []
    while len(order) < p:
        # lowest-degree unvisited seed
        seed = int(np.argmin(np.where(visited, p + 1, degrees)))
        visited[seed] = True
        dq = deque([seed])
        order.append(seed)
        while dq:
            u = dq.popleft()
            nbrs = np.nonzero(adjacency[u] & ~visited)[0]
            nbrs = nbrs[np.argsort(degrees[nbrs], kind="stable")]
            for v in nbrs:
                visited[v] = True
                order.append(int(v))
                dq.append(int(v))
    return np.array(order[::-1], dtype=np.int64)


def graph_bandwidth(adjacency: np.ndarray, perm: np.ndarray | None = None) -> int:
    """Bandwidth of the adjacency under an ordering (max |i-j| over edges)."""
    adj = adjacency
    if perm is not None:
        adj = adj[np.ix_(perm, perm)]
    ii, jj = np.nonzero(adj)
    if ii.size == 0:
        return 0
    return int(np.abs(ii - jj).max())
