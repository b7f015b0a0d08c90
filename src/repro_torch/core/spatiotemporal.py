"""Copy of ``repro.core.spatiotemporal`` for the PyTorch port
(held equal to it by tests/test_torch_streaming.py).

Spatiotemporal principal component aggregation (paper Sec. Conclusion).

The paper closes with: *"We plan to extend this work by showing that
spatiotemporal aggregation ... can also be formulated in the same
framework."*  This module provides that formulation.

Each node holds its own trailing window of ``w`` measurements (no extra
communication — the history is local).  The feature vector at epoch t is the
stacked window ``[x_1[t..t-w+1], ..., x_p[t..t-w+1]] in R^{p*w}``, and the
aggregation primitives generalize verbatim (Sec. 2.3):

    init_i(history_i) = < sum_tau W[(i,tau), k] * x_i[t - tau] >_k
    f = elementwise sum,  e = identity

— the partial state record is *still* q scalars per epoch, so the network
cost of spatiotemporal PCAg equals plain PCAg; only node-local compute/
memory grow by the factor w (each node stores its w x q weight block and w
recent samples).  The local covariance hypothesis extends as
``c_{(i,s),(j,tau)} = 0 unless j in N_i`` — a block mask: full temporal
coupling within a neighborhood, zero across distant sensors
(kron(spatial_mask, ones(w, w))).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.aggregation import AggregationPrimitives, aggregate_tree
from repro_torch.core.pca import DistributedPCA, PCAResult
from repro_torch.core.topology import RoutingTree

__all__ = ["stack_windows", "spatiotemporal_mask", "SpatioTemporalPCA",
           "st_pcag_primitives", "st_scores_in_network"]


def stack_windows(x: np.ndarray, w: int) -> np.ndarray:
    """(N, p) epochs -> (N - w + 1, p * w) stacked windows.

    Column layout is sensor-major: features [i*w : (i+1)*w] belong to sensor
    i, ordered lag 0 (current) .. lag w-1 — each node owns a contiguous
    block, which is what makes the in-network formulation local."""
    n, p = x.shape
    if w < 1 or w > n:
        raise ValueError("window must be in [1, n_epochs]")
    out = np.empty((n - w + 1, p * w), dtype=x.dtype)
    for lag in range(w):
        sl = x[w - 1 - lag: n - lag]           # (N-w+1, p), lag steps back
        out[:, lag::w] = sl
    return out


def spatiotemporal_mask(spatial_mask: np.ndarray, w: int) -> np.ndarray:
    """Local covariance hypothesis on the stacked space: kron(mask, 1_wxw)."""
    return np.kron(spatial_mask, np.ones((w, w), dtype=bool))


class SpatioTemporalPCA:
    """DistributedPCA over stacked windows with the block-local mask."""

    def __init__(self, q: int, window: int, method: str = "eigh",
                 spatial_mask: np.ndarray | None = None, **kw):
        self.window = window
        mask = None
        cov_mode = "full"
        if spatial_mask is not None:
            mask = spatiotemporal_mask(np.asarray(spatial_mask, bool), window)
            cov_mode = "masked"
        self._pca = DistributedPCA(q=q, method=method, cov_mode=cov_mode,
                                   mask=mask, **kw)

    def fit(self, x: np.ndarray) -> PCAResult:
        return self._pca.fit(stack_windows(x, self.window))

    def transform(self, result: PCAResult, x: np.ndarray) -> np.ndarray:
        return DistributedPCA.transform(result, stack_windows(x, self.window))

    def reconstruct_current(self, result: PCAResult,
                            x: np.ndarray) -> np.ndarray:
        """Reconstruct the lag-0 (current-epoch) measurements only.

        The number of sensors is recovered from the fitted basis (the stacked
        feature space has ``p * window`` columns in sensor-major layout), so
        no shape argument is needed — the lag-0 slice ``full[:, 0::window]``
        is exactly the (N - w + 1, p) current-epoch block.
        """
        z = self.transform(result, x)
        full = DistributedPCA.inverse_transform(result, z)
        return full[:, 0::self.window]         # lag-0 columns, sensor-major


def st_pcag_primitives(W: np.ndarray, w: int) -> AggregationPrimitives:
    """In-network primitives: node i contributes its w-window projected
    through its (w, q) weight block; records stay q-dimensional."""
    W = np.asarray(W, dtype=np.float64)

    return AggregationPrimitives(
        init=lambda ih: W[ih[0] * w:(ih[0] + 1) * w].T @ ih[1],
        merge=lambda a, b: a + b,
        evaluate=lambda rec: rec,
    )


def st_scores_in_network(tree: RoutingTree, W: np.ndarray, histories,
                         w: int):
    """Compute spatiotemporal scores by running the aggregation service.

    histories: per-node arrays of shape (w,) — lag 0 first.
    Returns (scores (q,), per-node packet counts) — same packet counts as
    plain PCAg with the same q."""
    prim = st_pcag_primitives(W, w)
    res = aggregate_tree(tree, [(i, np.asarray(h, np.float64))
                                for i, h in enumerate(histories)], prim)
    return np.asarray(res.value), res.packets
