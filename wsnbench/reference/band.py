"""Banded covariance, written as blocked dense products.

Band layout: ``band[..., k, i] = C[i, i + k - h]`` for the 2h+1
diagonals, zero where ``i + k - h`` lies outside [0, p).  The fold and
the product go through ``torch.matmul`` on blocks of B columns, so that
float64 gives a reference to float32's rounding and TF32 (the control)
shows in every sum."""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def _blocks(p: int) -> tuple[int, int]:
    b = min(BLOCK, p)
    return b, -(-p // b)


def fold(x: torch.Tensor, h: int, w: torch.Tensor | None = None,
         ) -> torch.Tensor:
    """``band[..., h + d, i] = sum_r w_r x[..., r, i] x[..., r, i + d]``
    (and its mirror below the centre) of readings ``x`` (..., R, p) with
    row weights ``w`` (..., R) or unit weight."""
    *lead, R, p = x.shape
    B, nb = _blocks(p)
    pad = nb * B - p
    xw = x if w is None else x * w[..., None]
    xs = F.pad(x, (0, pad + h)).reshape(-1, R, nb * B + h)
    xw = F.pad(xw, (0, pad)).reshape(-1, R, nb, B)
    # column block c against the columns c .. c + B + h of every row
    win = xs.unfold(-1, B + h, B)[..., :nb, :]          # (L, R, nb, B+h)
    P = torch.matmul(xw.permute(0, 2, 3, 1), win.permute(0, 2, 1, 3))
    band = x.new_zeros((P.shape[0], 2 * h + 1, p))
    for d in range(h + 1):
        diag = torch.diagonal(P, offset=d, dim1=-2, dim2=-1)   # (L, nb, B)
        upper = diag.reshape(-1, nb * B)[:, :p - d] if d < p else None
        if upper is None:
            continue
        band[:, h + d, :p - d] = upper
        band[:, h - d, d:] = upper
    return band.reshape(*lead, 2 * h + 1, p)


def valid(p: int, h: int, device) -> torch.Tensor:
    """(2h+1, p) bool: the in-range entries of the band layout."""
    j = torch.arange(p, device=device)[None, :]
    k = torch.arange(2 * h + 1, device=device)[:, None]
    return (j + k - h >= 0) & (j + k - h < p)


def shifted(v: torch.Tensor, h: int) -> torch.Tensor:
    """``out[..., k, i] = v[..., i + k - h]``, zero out of range."""
    p = v.shape[-1]
    return F.pad(v, (h, h)).unfold(-1, p, 1)


def dense_blocks(band: torch.Tensor) -> torch.Tensor:
    """C's rows in blocks of B, each against the columns it touches:
    (..., nb, B, B + 2h) with ``D[b, i, i + k] = band[k, bB + i]``."""
    *lead, nd, p = band.shape
    h = (nd - 1) // 2
    B, nb = _blocks(p)
    bb = F.pad(band, (0, nb * B - p)).reshape(-1, nd, nb, B)
    D = band.new_zeros((bb.shape[0], nb, B, B + 2 * h))
    i = torch.arange(B, device=band.device)
    for k in range(nd):
        D[:, :, i, i + k] = bb[:, k]
    return D.reshape(*lead, nb, B, B + 2 * h)


def product(D: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``C V`` for ``D`` from :func:`dense_blocks` and V (..., p, q)."""
    *lead, nb, B, W = D.shape
    h = (W - B) // 2
    p, q = V.shape[-2:]
    Vp = F.pad(V, (0, 0, h, nb * B - p + h))             # (..., nbB+2h, q)
    win = Vp.unfold(-2, W, B)                             # (..., nb, q, W)
    Y = torch.matmul(D, win.transpose(-1, -2))            # (..., nb, B, q)
    return Y.reshape(*lead, nb * B, q)[..., :p, :]
