"""Banded-layout helpers of ``repro.core.covariance``, in PyTorch.

Layout: ``band[k, i] = C[i, i + k - h]`` for ``k in [0, 2h]``; entries
whose column ``i + k - h`` falls outside ``[0, p)`` are zero.  Every
function takes leading batch axes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["_shifted", "shifted_stack", "band_valid", "band_to_dense",
           "banded_matmul_ref", "banded_matvec_ref"]


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
