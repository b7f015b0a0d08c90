"""Low-rank gradient compression by distributed power iteration
(counterpart of ``repro.distributed.compression``).

The paper's algorithm — distributed PIM with tree aggregation (Sec. 3.4) —
applied to the *gradient matrix* of data-parallel training.  This is the
PowerSGD scheme (Vogels et al., 2019), one warm-started iteration of
Algorithm 1 per step with the A operation realized as an average over the
data-parallel replicas:

    P = G Q          (local matvec block — the 'Cv' step)
    P = A(P)         (aggregation: the replicas' mean; q*r elements
                      instead of the full n*m gradient)
    P = orth(P)      (Gram-Cholesky orthonormalization — the paper's
                      normalization step)
    Q = G^T P ;  Q = A(Q)
    G_hat = P Q^T    (rank-r approximation)

plus **error feedback**: the compression residual is added to the next
step's gradient.  Communication per step drops from n*m to r*(n+m) per
matrix.

Matrices with stacked leading dims ((L, n, m), the layer stacks) are
handled as batches of matrices; small and 1-D tensors (norms, biases)
bypass compression and are reduced exactly.  Trees are nested dicts with
``None`` where a leaf has no factor.  The Q draws come from a
``torch.Generator``, or are given (a test feeds the reference's
``jax.random`` draws); :func:`all_reduce_mean` is ``reduce_fn`` over a
``torch.distributed`` group.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.models.params import tree_leaves, unflatten

__all__ = ["CompressorState", "init_compressor", "compress_gradients",
           "compression_ratio", "all_reduce_mean"]

Reduce = Callable[[torch.Tensor], torch.Tensor]


def _eligible(x, rank: int) -> bool:
    if x.ndim < 2:
        return False
    n, m = x.shape[-2], x.shape[-1]
    # compress only when it actually shrinks traffic
    return n * m > 2 * rank * (n + m)


class CompressorState(NamedTuple):
    q: dict          # per-leaf Q factor (or None)
    error: dict      # per-leaf error-feedback buffer (or None)
    rank: int


def init_compressor(params, rank: int,
                    gen: torch.Generator | None = None,
                    q: Mapping[str, np.ndarray] | None = None
                    ) -> CompressorState:
    """Q factors (..., m, rank) in fp32 for every eligible leaf — drawn
    from ``gen`` (standard normal, leaves in sorted-path order) or taken
    from ``q`` (dotted path -> array, e.g. the reference's draws) — and
    zero error buffers."""
    qs, errs = {}, {}
    for path, x in tree_leaves(params):
        if not _eligible(x, rank):
            qs[path] = errs[path] = None
            continue
        shape = (*x.shape[:-2], x.shape[-1], rank)
        if q is not None:
            qs[path] = torch.tensor(np.asarray(q[path], np.float32),
                                    device=x.device)
            if tuple(qs[path].shape) != shape:
                raise ValueError(f"{path}: Q of shape "
                                 f"{tuple(qs[path].shape)}, wanted {shape}")
        else:
            qs[path] = torch.randn(shape, generator=gen, dtype=torch.float32,
                                   device=x.device)
        errs[path] = torch.zeros_like(x, dtype=torch.float32)
    return CompressorState(q=unflatten(qs), error=unflatten(errs), rank=rank)


def _orthonormalize(p: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Gram-Cholesky orthonormalization of the columns of p (..., n, r):
    X with X L^T = P, L the Cholesky factor of P^T P + eps I."""
    g = p.mT @ p
    r = p.shape[-1]
    l, _ = torch.linalg.cholesky_ex(
        g + eps * torch.eye(r, dtype=p.dtype, device=p.device))
    return torch.linalg.solve_triangular(l.mT, p, upper=True, left=False)


def _compress_leaf(g: torch.Tensor, q: torch.Tensor, e: torch.Tensor,
                   reduce_fn: Reduce):
    """One warm-started distributed power-iteration round on one matrix
    (or a stack of them)."""
    g32 = g.float() + e                               # error feedback
    p = g32 @ q
    p = _orthonormalize(reduce_fn(p))                 # A op + normalization
    q_new = reduce_fn(g32.mT @ p)                     # A op
    g_hat = p @ q_new.mT
    e_new = g32 - g_hat                               # next-step feedback
    return g_hat.to(g.dtype), q_new, e_new


@torch.no_grad()
def compress_gradients(grads, state: CompressorState,
                       reduce_fn: Reduce | None = None):
    """Compress + reduce a gradient tree.

    ``reduce_fn`` averages across data-parallel replicas
    (:func:`all_reduce_mean`; the identity for single-process use).
    Uncompressed leaves are passed through ``reduce_fn`` exactly.
    Returns (new_grads, new_state).
    """
    reduce_fn = reduce_fn or (lambda x: x)
    flat_q = dict(tree_leaves(state.q))
    flat_e = dict(tree_leaves(state.error))
    new_g, new_q, new_e = {}, {}, {}
    for path, g in tree_leaves(grads):
        q = flat_q.get(path)
        if q is None:
            new_g[path], new_q[path], new_e[path] = reduce_fn(g), None, None
        else:
            new_g[path], new_q[path], new_e[path] = _compress_leaf(
                g, q, flat_e[path], reduce_fn)
    return unflatten(new_g), CompressorState(
        q=unflatten(new_q), error=unflatten(new_e), rank=state.rank)


def compression_ratio(params, rank: int) -> float:
    """Bytes on the wire: compressed / uncompressed (lower is better)."""
    full = 0
    compressed = 0
    for _, x in tree_leaves(params):
        n = x.numel()
        full += n
        if _eligible(x, rank):
            rows, cols = x.shape[-2], x.shape[-1]
            batch = n // (rows * cols)
            compressed += batch * rank * (rows + cols)
        else:
            compressed += n
    return compressed / max(full, 1)


def all_reduce_mean(group=None) -> Reduce:
    """``reduce_fn`` over a ``torch.distributed`` group: the replicas'
    mean, summed in place into the tensor given (``all_reduce`` with SUM;
    ``ReduceOp.AVG`` is NCCL's alone, and the CPU tests run gloo) and
    divided by the group's size."""
    import torch.distributed as dist

    def reduce(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x.div_(dist.get_world_size(group))
    return reduce
