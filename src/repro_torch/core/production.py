"""Production-scale distributed PCA steps (counterpart of
``repro.core.production``: the paper's system at wsn-1m's width).

The feature axis (p "virtual sensors") carries the banded covariance
(local covariance hypothesis after bandwidth reduction) as 2h+1
diagonals.  The four steps, on one device:

    cov_update_step    Eq. (10) from an epoch batch        kernel 6
    pim_block_step     one blocked orthogonal-iteration round  kernel 10
    pim_deflated_step  one deflated single-vector PIM round    kernel 11
    transform_step     PCAg scores of an epoch batch       torch.matmul

and the four steps' sharded forms over a process group, the port's form
of what GSPMD makes of the reference's steps (collective-permute halos
plus all-reduce): each rank holds a contiguous slice of p.  The update
(:func:`sharded_cov_update_step`) keeps the band slice unpadded, takes
x's h edge columns from its neighbours (one halo exchange) and folds the
padded batch in one launch of kernel 6, keeping the middle columns; the
transform (:func:`sharded_transform_step`) sums the slices' partial
scores with one all-reduce.  The iterations hold the band slice stored
padded with h zero columns a side (:func:`shard_band`).  An iteration runs one
:func:`~repro_torch.core.aggregation.halo_exchange` of the iterate, one
launch of kernel 11 (or 10) on the padded width, and keeps the middle
columns; the Gram matrix and the norm are
:func:`~repro_torch.core.aggregation.a_op` sums.  The existing kernels
serve without a new entry point: a middle row of the padded product sums
the same diagonals in the same order as the unsharded one, the halo
standing in for the neighbours' columns and zeros for the ends of the
ring.
"""

from __future__ import annotations

import torch

from repro_torch.core import covariance as cov
from repro_torch.core.aggregation import a_op, halo_exchange
from repro_torch.core.power_iteration import orthonormalize
from repro_torch.kernels import ops

__all__ = ["cov_update_step", "pim_block_step", "pim_deflated_step",
           "transform_step", "shard_band", "halo_matvec", "halo_matmul",
           "sharded_cov_update_step", "sharded_pim_block_step",
           "sharded_pim_deflated_step", "sharded_transform_step"]


def cov_update_step(state: cov.BandedCovState,
                    x: torch.Tensor) -> cov.BandedCovState:
    """Fold an (n, p) epoch batch into the banded sufficient statistics
    (one launch of kernel 6)."""
    return cov.banded_update(state, x)


def pim_block_step(band: torch.Tensor, v: torch.Tensor, eps: float = 1e-8,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One blocked orthogonal-iteration round: ``v`` (p, q) -> (v_next
    orthonormal, Rayleigh eigenvalue estimates ``diag(v^T C v)``).
    ``C v`` is one launch of kernel 10; the Gram matrix is the round's one
    aggregation (q^2 scalars); ``CV inv(L)^T`` keeps the update row-local
    (the reference's form)."""
    cv = ops.banded_matmul(band, v)
    v_next = orthonormalize(cv, cv.T @ cv, eps)
    return v_next, (v * cv).sum(0)


def _deflate(cv, w_prev, coeff):
    """``cv`` less its part along the earlier components."""
    return cv if w_prev.shape[1] == 0 else cv - w_prev @ coeff


def _deflated_tail(cv, nrm2, sign_sum):
    """Normalise, and sign the eigenvalue by the paper's criterion."""
    nrm = torch.sqrt(nrm2)
    return cv / nrm.clamp(min=1e-30), torch.sign(sign_sum) * nrm


def pim_deflated_step(band: torch.Tensor, v: torch.Tensor,
                      w_prev: torch.Tensor,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Algorithm-2 inner iteration for one component: ``v`` (p,),
    ``w_prev`` (p, k-1) the components found so far.  ``C v`` (one launch
    of kernel 11), the deflation's k-1 dot products, the norm and the
    paper's sign criterion.  Returns (v_next, eigenvalue estimate)."""
    cv = ops.banded_matvec(band, v)
    cv = _deflate(cv, w_prev, w_prev.T @ cv)
    return _deflated_tail(cv, (cv * cv).sum(),
                          torch.sign(v * cv).sum())


def transform_step(w: torch.Tensor, mean: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """PCAg scores Z = (X - mean) W for an (n, p) epoch batch, a plain
    product as in the reference."""
    return (x - mean[None, :]) @ w


# --------------------------------------------------------------------------
# Sharded forms over a process group
# --------------------------------------------------------------------------
def shard_band(band: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s slice of a (2h+1, p) band, stored padded with h
    zero columns a side: (2h+1, p/world + 2h).  p must divide by the
    ranks and each slice hold at least h columns (its neighbours' halo)."""
    nb, p = band.shape
    h = (nb - 1) // 2
    if p % world:
        raise ValueError(f"p={p} not divisible by {world} ranks")
    local = p // world
    if local < h:
        raise ValueError(f"a slice of {local} columns cannot carry a halo "
                         f"of h={h}")
    out = band.new_zeros((nb, local + 2 * h))
    out[:, h:h + local] = band[:, rank * local:(rank + 1) * local]
    return out


def _padded(block: torch.Tensor, h: int, group) -> torch.Tensor:
    """``block`` (..., local) with its neighbours' h edge columns on both
    sides (zeros at the ends of the ring): one halo exchange."""
    if h == 0:
        return block
    left, right = halo_exchange(block, h, group)
    return torch.cat([left, block, right], dim=-1)


def _halfwidth(band_pad: torch.Tensor) -> int:
    return (band_pad.shape[0] - 1) // 2


def halo_matvec(band_pad: torch.Tensor, v: torch.Tensor,
                group=None) -> torch.Tensor:
    """``C v`` on this rank's rows (``band_pad`` from :func:`shard_band`,
    ``v`` (local,)): one halo exchange of v, one launch of kernel 11 on
    the padded width, the middle kept."""
    h = _halfwidth(band_pad)
    local = v.shape[0]
    return ops.banded_matvec(band_pad, _padded(v, h, group))[h:h + local]


def halo_matmul(band_pad: torch.Tensor, V: torch.Tensor,
                group=None) -> torch.Tensor:
    """``C V`` on this rank's rows (``V`` (local, q)): one halo exchange
    of V's edge rows, one launch of kernel 10 on the padded width, the
    middle kept."""
    h = _halfwidth(band_pad)
    local = V.shape[0]
    vp = _padded(V.T, h, group).T.contiguous()
    return ops.banded_matmul(band_pad, vp)[h:h + local]


def sharded_cov_update_step(state: cov.BandedCovState, x: torch.Tensor,
                            group=None) -> cov.BandedCovState:
    """:func:`cov_update_step` on this rank's columns: ``state`` holds the
    slice (``s`` (local,), ``band`` (2h+1, local)), ``x`` (n, local).  One
    halo exchange of x's h edge columns, one launch of kernel 6 on the
    padded (n, local + 2h) batch, the middle columns kept: a middle
    column's diagonals pair it with the same neighbours, in the same row
    order, as the unsharded fold."""
    h = state.halfwidth
    local = x.shape[-1]
    delta = ops.cov_band_update(_padded(x, h, group), h)[:, h:h + local]
    return cov.BandedCovState(t=state.t + x.shape[0], s=state.s + x.sum(0),
                              band=state.band + delta, halfwidth=h)


def sharded_transform_step(w: torch.Tensor, mean: torch.Tensor,
                           x: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`transform_step` on this rank's rows of W (``w`` (local, q),
    ``mean`` (local,), ``x`` (n, local)): the partial scores summed over
    the ranks by ONE all_reduce of the (n, q) table."""
    return a_op((x - mean[None, :]) @ w, group)


def sharded_pim_block_step(band_pad: torch.Tensor, v: torch.Tensor,
                           group=None, eps: float = 1e-8,
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`pim_block_step` on this rank's rows: ``band_pad`` from
    :func:`shard_band`, ``v`` (local, q).  :func:`halo_matmul`, then ONE
    all_reduce carrying the Gram matrix and the Rayleigh partials
    together."""
    q = v.shape[1]
    cv = halo_matmul(band_pad, v, group)
    summed = a_op(torch.cat([(cv.T @ cv).reshape(-1), (v * cv).sum(0)]),
                  group)
    v_next = orthonormalize(cv, summed[:q * q].reshape(q, q), eps)
    return v_next, summed[q * q:]


def sharded_pim_deflated_step(band_pad: torch.Tensor, v: torch.Tensor,
                              w_prev: torch.Tensor, group=None,
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`pim_deflated_step` on this rank's rows: ``v`` (local,),
    ``w_prev`` (local, k-1).  :func:`halo_matvec`, one all_reduce of the
    k-1 deflation coefficients (none when k = 1) and one of the norm and
    sign-criterion partials together."""
    cv = halo_matvec(band_pad, v, group)
    if w_prev.shape[1]:
        cv = _deflate(cv, w_prev, a_op(w_prev.T @ cv, group))
    parts = a_op(torch.stack([(cv * cv).sum(), torch.sign(v * cv).sum()]),
                 group)
    return _deflated_tail(cv, parts[0], parts[1])

