"""Streaming covariance estimation (counterpart of
``repro.core.covariance``), in PyTorch on an explicit device.

Two layouts, as in the reference:

* **Masked dense** (:class:`CovState`): the full ``p x p`` sufficient
  statistic under the local covariance hypothesis mask (paper Sec. 3.3).
  Its ``x^T x`` is a plain ``torch.matmul``, as the reference computes it
  outside any kernel.
* **Banded** (:class:`BandedCovState`): after a bandwidth-reducing
  relabelling the mask is a band of half-width ``h``, stored as ``2h+1``
  diagonals, ``band[k, i] = C[i, i + k - h]`` for ``k in [0, 2h]``;
  entries whose column ``i + k - h`` falls outside ``[0, p)`` are zero.
  :func:`banded_update` folds a batch with the per-round band-fold kernel
  (kernel 6), which computes the reference's ``sum_t x[t, i] x[t, i + k -
  h]`` and, for an fp32 band on the card, adds it to the band in its
  write-out (:func:`repro_torch.kernels.ops.cov_band_accumulate`).

Both keep the sufficient statistics of Eq. (9)-(10): ``t``,
``S_i = sum_tau x_i[tau]`` and ``S_ij``, so ``c_ij = S_ij/t - S_i S_j/t^2``
can be updated from batches of any size.  A batch given as numpy (or on
another device) is moved to the state's device and dtype.  The banded
helpers below take leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import as_tensor, resolve_device

__all__ = ["CovState", "cov_init", "cov_update", "cov_estimate",
           "BandedCovState", "banded_init", "banded_update",
           "banded_estimate", "dense_to_band", "mask_from_band",
           "_shifted", "shifted_stack", "band_valid", "band_to_dense",
           "banded_matmul_ref", "banded_matvec_ref"]


# --------------------------------------------------------------------------
# Masked dense layout (paper-faithful)
# --------------------------------------------------------------------------
class CovState(NamedTuple):
    t: torch.Tensor          # () number of epochs seen
    s: torch.Tensor          # (p,) S_i
    sxy: torch.Tensor        # (p, p) S_ij, only entries allowed by the mask
    mask: torch.Tensor       # (p, p) bool; True where c_ij may be nonzero


def cov_init(p: int, mask=None, dtype=torch.float32,
             device="cuda") -> CovState:
    dev = resolve_device(device)
    if mask is None:
        mask = torch.ones((p, p), dtype=torch.bool, device=dev)
    mask = as_tensor(mask, torch.bool, dev)
    return CovState(t=torch.zeros((), dtype=dtype, device=dev),
                    s=torch.zeros((p,), dtype=dtype, device=dev),
                    sxy=torch.zeros((p, p), dtype=dtype, device=dev),
                    mask=mask)


def cov_update(state: CovState, x) -> CovState:
    """Fold a batch ``x`` (n, p) into the sufficient statistics: n
    applications of Eq. (10), the full outer product masked (the oracle
    semantics of the reference)."""
    x = as_tensor(x, state.s.dtype, state.s.device)
    sxy = state.sxy + torch.where(state.mask, x.T @ x, 0.0)
    return CovState(t=state.t + x.shape[0], s=state.s + x.sum(0), sxy=sxy,
                    mask=state.mask)


def cov_estimate(state: CovState) -> torch.Tensor:
    """Eq. (9): c_ij = S_ij/t - S_i S_j / t^2, masked."""
    t = state.t.clamp(min=1.0)
    c = state.sxy / t - torch.outer(state.s, state.s) / (t * t)
    return torch.where(state.mask, c, 0.0)


# --------------------------------------------------------------------------
# Banded layout
# --------------------------------------------------------------------------
class BandedCovState(NamedTuple):
    t: torch.Tensor          # ()
    s: torch.Tensor          # (p,)
    band: torch.Tensor       # (2h+1, p): band[k, i] = S_{i, i+k-h}
    halfwidth: int


def banded_init(p: int, halfwidth: int, dtype=torch.float32,
                device="cuda") -> BandedCovState:
    dev = resolve_device(device)
    return BandedCovState(
        t=torch.zeros((), dtype=dtype, device=dev),
        s=torch.zeros((p,), dtype=dtype, device=dev),
        band=torch.zeros((2 * halfwidth + 1, p), dtype=dtype, device=dev),
        halfwidth=halfwidth)


def banded_update(state: BandedCovState, x) -> BandedCovState:
    """Banded Eq. (10): ``band[k, i] += sum_t x[t, i] x[t, i + k - h]``.
    An fp32 band takes one launch of kernel 6 that adds the batch's sums
    to it in the write-out (its plain version on the CPU); an fp64 state
    adds kernel 6's fp32 delta.  Both give ``band + delta`` rounded once,
    the same bits, in a new band."""
    # imported here: the kernels' plain versions import this module
    from repro_torch.kernels import ops
    x = as_tensor(x, state.s.dtype, state.s.device)
    h = state.halfwidth
    band = (ops.cov_band_accumulate(state.band, x, h)
            if state.band.dtype == torch.float32
            else state.band + ops.cov_band_update(x, h))
    return BandedCovState(t=state.t + x.shape[0], s=state.s + x.sum(0),
                          band=band, halfwidth=h)


def banded_estimate(state: BandedCovState) -> torch.Tensor:
    """Banded covariance diagonals: ``c_band[k, i] = C[i, i + k - h]``,
    zero out of range.  The mean term ``s[i] s[i + k - h]`` comes from a
    strided view of ``s`` (no per-diagonal copy), and the arithmetic runs
    in place on one (2h+1, p) buffer besides it."""
    t = state.t.clamp(min=1.0)
    h = state.halfwidth
    s = state.s
    mean_term = s * shifted_stack(s, h)
    band = state.band / t
    band.sub_(mean_term.div_(t * t))
    del mean_term
    valid = band_valid(s.shape[-1], h, device=s.device, dtype=torch.bool)
    return band.masked_fill_(~valid, 0.0)


def dense_to_band(c: torch.Tensor, halfwidth: int) -> torch.Tensor:
    """Dense (p, p) -> (2h+1, p) diagonals (entries outside the band
    dropped)."""
    p = c.shape[-1]
    h = halfwidth
    i = torch.arange(p, device=c.device)[None, :]
    j = i + torch.arange(2 * h + 1, device=c.device)[:, None] - h
    valid = (j >= 0) & (j < p)
    return torch.where(valid, c[i.expand_as(j), j.clamp(0, p - 1)], 0.0)


def mask_from_band(p: int, halfwidth: int) -> np.ndarray:
    """Dense bool mask equivalent to a band of half-width h."""
    i = np.arange(p)
    return np.abs(i[:, None] - i[None, :]) <= halfwidth


def _shifted(x: torch.Tensor, offset: int) -> torch.Tensor:
    """Column j of the result is ``x[..., j + offset]``, zero out of range."""
    p = x.shape[-1]
    out = torch.zeros_like(x)
    lo, hi = max(0, -offset), min(p, p - offset)
    if hi > lo:
        out[..., lo:hi] = x[..., lo + offset:hi + offset]
    return out


def shifted_stack(x: torch.Tensor, halfwidth: int) -> torch.Tensor:
    """``out[..., k, j] = x[..., j + k - h]`` for every diagonal k — all
    2h+1 :func:`_shifted` copies in one (..., 2h+1, p) view-and-copy."""
    h = halfwidth
    p = x.shape[-1]
    return F.pad(x, (h, h)).unfold(-1, p, 1)


def band_valid(p: int, halfwidth: int, device="cuda",
               dtype=torch.float32) -> torch.Tensor:
    """(2h+1, p) 0/1 in-range indicator of the diagonal layout."""
    h = halfwidth
    j = torch.arange(p, device=device)[None, :]
    k = torch.arange(2 * h + 1, device=device)[:, None]
    return ((j + k - h >= 0) & (j + k - h < p)).to(dtype)


def band_to_dense(band: torch.Tensor) -> torch.Tensor:
    """(..., 2h+1, p) diagonals -> dense (..., p, p), one scatter.

    Row i of the dense matrix is exactly what :func:`banded_matmul_ref`
    contracts against for output row i, so ``band_to_dense(b) @ V`` is the
    banded product up to the order of the sums (the tests' yardstick)."""
    nb, p = band.shape[-2:]
    h = (nb - 1) // 2
    dev = band.device
    i = torch.arange(p, device=dev)[None, :]
    k = torch.arange(nb, device=dev)[:, None]
    j = i + k - h
    valid = ((j >= 0) & (j < p)).reshape(-1)
    dst = (i * p + j).reshape(-1)[valid]
    lead = band.shape[:-2]
    dense = band.new_zeros(lead + (p * p,))
    dense[..., dst] = band.reshape(lead + (nb * p,))[..., valid]
    return dense.reshape(lead + (p, p))


def banded_matmul_ref(band: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``Y[i, c] = sum_k band[k, i] V[i + k - h, c]`` — C @ V for V (p, q),
    as the reference writes it: one shifted multiply-add per diagonal,
    k = 0..2h in order into one fp32 accumulator, each over its in-range
    rows only (a halo row outside [0, p) adds nothing).  No (p, p) or
    (q, 2h+1, p) intermediate."""
    nb, p = band.shape[-2:]
    h = (nb - 1) // 2
    band, V = band.float(), V.float()
    lead = torch.broadcast_shapes(band.shape[:-2], V.shape[:-2])
    acc = V.new_zeros(lead + V.shape[-2:])
    for k in range(nb):
        off = k - h
        lo, hi = max(0, -off), min(p, p - off)
        if hi > lo:
            acc[..., lo:hi, :] += (band[..., k, lo:hi, None]
                                   * V[..., lo + off:hi + off, :])
    return acc


def banded_matvec_ref(band: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(Cv)[i] = sum_k band[k, i] v[i + k - h]`` — the paper's
    neighbour-local Cv, for v (p,): :func:`banded_matmul_ref` with one
    column."""
    return banded_matmul_ref(band, v[..., None])[..., 0]
