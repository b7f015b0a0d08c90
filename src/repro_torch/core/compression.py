"""Copy of ``repro.core.compression`` for the PyTorch port
(held equal to it by tests/test_torch_streaming.py).

Principal component aggregation & supervised compression (paper Sec. 2.3-2.4).

* :func:`pcag_primitives` — the exact aggregation primitives of Sec. 2.3:
  ``init(x_i) = <w_i1 x_i; ...; w_iq x_i>``, merge = elementwise sum.  Running
  them on the routing-tree simulator computes the scores *in-network*.
* :func:`scores` / :func:`reconstruct` — the linear algebra of Eq. (5)-(6).
* :class:`SupervisedCompressor` — the +/- epsilon guarantee of Sec. 2.4.1:
  scores are fed back (F op); every node reconstructs its own measurement
  approximation locally and raises a notification when the error exceeds
  epsilon; flagged nodes transmit their raw measurement so the sink is always
  within +/- epsilon of the truth.

Epsilon convention (shared with the device tier in kernels/pca_project.py
and streaming/compressor.py, so differential tests can compare exactly):
a node notifies on the *strict* ``err > eps``, hence every un-flagged entry
satisfies the *closed* bound ``|x - x_hat| <= eps`` — the guarantee is
always asserted as ``<= eps``.

This module is the host-side NumPy **oracle**: the serving hot loop runs the
fused Pallas tier (:func:`repro.kernels.ops.supervised_compress`); the
functions here define the semantics the device tier is tested against.
``dtype`` defaults to the input's dtype so the oracle can be evaluated at
fp32 for exact comparison with the device path (or at float64 for
reference-precision studies).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.aggregation import AggregationPrimitives, aggregate_tree
from repro_torch.core.topology import RoutingTree

__all__ = ["pcag_primitives", "scores", "reconstruct", "SupervisedCompressor",
           "SupervisedResult"]


def _resolve_dtype(x: np.ndarray, dtype) -> np.dtype:
    """Input dtype for floating inputs, float64 otherwise (ints, lists)."""
    if dtype is not None:
        return np.dtype(dtype)
    if np.issubdtype(x.dtype, np.floating):
        return x.dtype
    return np.dtype(np.float64)


def pcag_primitives(W: np.ndarray) -> AggregationPrimitives:
    """Sec. 2.3 primitives.  ``W`` is (p, q); node i uses row W[i].

    ``init`` receives the pair (i, x_i) so each node can select its own row —
    in the real deployment the row is stored on the node (the initialization
    the paper's Sec. 3 distributes).
    """
    W = np.asarray(W, dtype=np.float64)

    return AggregationPrimitives(
        init=lambda ix: W[ix[0]] * ix[1],
        merge=lambda a, b: a + b,
        evaluate=lambda rec: rec,
    )


def scores(W: np.ndarray, x: np.ndarray, mean: np.ndarray | None = None,
           dtype=None) -> np.ndarray:
    """z = W^T (x - mean); x may be (p,) or (N, p).

    ``dtype`` defaults to x's dtype (float64 for non-float input), so an
    fp32 caller gets fp32 arithmetic — comparable with the device tier,
    and no silent float64 constant under jit without x64.
    """
    x = np.asarray(x)
    dt = _resolve_dtype(x, dtype)
    x = x.astype(dt, copy=False)
    if mean is not None:
        x = x - np.asarray(mean, dtype=dt)
    return x @ np.asarray(W, dtype=dt)


def reconstruct(W: np.ndarray, z: np.ndarray, mean: np.ndarray | None = None,
                dtype=None) -> np.ndarray:
    """x_hat = W z (+ mean); dtype defaults to z's dtype (see scores)."""
    z = np.asarray(z)
    dt = _resolve_dtype(z, dtype)
    out = z.astype(dt, copy=False) @ np.asarray(W, dtype=dt).T
    if mean is not None:
        out = out + np.asarray(mean, dtype=dt)
    return out


def scores_in_network(tree: RoutingTree, W: np.ndarray, x: np.ndarray,
                      mean: np.ndarray | None = None):
    """Compute z[t] by actually running the aggregation service (tests/bench).

    Returns (z, per-node packet counts)."""
    xc = np.asarray(x, dtype=np.float64)
    if mean is not None:
        xc = xc - mean
    prim = pcag_primitives(W)
    res = aggregate_tree(tree, [(i, xc[i]) for i in range(tree.p)], prim)
    return np.asarray(res.value), res.packets


@dataclasses.dataclass(frozen=True)
class SupervisedResult:
    x_hat: np.ndarray          # (N, p) sink-side reconstruction, epsilon-true
    flagged: np.ndarray        # (N, p) bool — nodes that raised a notification
    extra_packets: np.ndarray  # (p,) raw-measurement packets sent per node


class SupervisedCompressor:
    """Supervised compression (Sec. 2.4.1): guarantee |x_i - x_hat_i| <= eps.

    Protocol per epoch: scores are aggregated (A), fed back (F); node i
    locally computes x_hat_i = sum_k z_k w_ik + mean_i; if the error
    *strictly exceeds* eps it sends its raw measurement up the tree (counted
    in extra_packets), and the sink substitutes the exact value — so every
    sink entry satisfies the closed bound ``|x - x_hat| <= eps`` (the
    module-level epsilon convention, shared with the device tier).

    ``dtype`` defaults to W's dtype (float64 for non-float input): pass
    ``np.float32`` (or an fp32 basis) to make this oracle bit-comparable
    with the fused device path.
    """

    def __init__(self, W: np.ndarray, mean: np.ndarray, epsilon: float,
                 dtype=None):
        W = np.asarray(W)
        self.dtype = _resolve_dtype(W, dtype)
        self.W = W.astype(self.dtype, copy=False)
        self.mean = np.asarray(mean, dtype=self.dtype)
        self.epsilon = float(epsilon)

    def run(self, x: np.ndarray) -> SupervisedResult:
        x = np.asarray(x).astype(self.dtype, copy=False)
        z = scores(self.W, x, self.mean, dtype=self.dtype)
        x_hat = reconstruct(self.W, z, self.mean, dtype=self.dtype)
        err = np.abs(x - x_hat)
        flagged = err > self.epsilon
        x_out = np.where(flagged, x, x_hat)
        extra = flagged.sum(axis=0).astype(np.int64)
        return SupervisedResult(x_hat=x_out, flagged=flagged, extra_packets=extra)
