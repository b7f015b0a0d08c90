"""Plain PyTorch versions of the port's kernels.

Each function is the definition of one CUDA kernel in ``csrc/`` written
with ordinary tensor ops; the wrappers in :mod:`repro_torch.kernels.ops`
take it for CPU tensors, and ``chip_smoke.py`` holds each kernel against
it on the card.  Counterpart of ``repro.kernels.ref``.

Shapes: a chunk is ``xs`` (..., K, n, p) — K rounds of n epochs each —
with per-round weights (..., K); a mask is (..., K, p) per-round liveness
or (..., K, n, p) per-reading dropout.  Leading axes (the fleet's slot
axis) broadcast through every function.  Band layout:
``band[..., k, i] = C[i, i + k - h]``.
"""

from __future__ import annotations

import torch

# Kernels 10 and 11: ``Y[i, c] = sum_k band[k, i] V[i + k - h, c]``, the
# diagonals in order, each a multiply and an add into a (..., p, q)
# accumulator (``repro.core.covariance.banded_matmul_ref``).
from repro_torch.core.covariance import banded_matmul_ref as banded_matmul
from repro_torch.core.covariance import banded_matvec_ref as banded_matvec

__all__ = ["band_fold", "cov_band_update",
           "cov_band_update_chunk", "cov_band_update_chunk_masked",
           "supervised_compress", "pca_monitor", "pca_project",
           "pca_reconstruct", "fused_stages", "fused_stream",
           "banded_matmul", "banded_matvec"]


def _row_mask(masks: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """A (..., K, p) or (..., K, n, p) mask as a (..., K, n, p) tensor."""
    masks = masks.to(xs.dtype)
    if masks.dim() == xs.dim() - 1:
        masks = masks.unsqueeze(-2)
    return masks.expand(xs.shape)


def band_fold(xs: torch.Tensor, weights: torch.Tensor, halfwidth: int,
              masks: torch.Tensor | None = None) -> torch.Tensor:
    """``delta[..., k, i] = sum_{t,r} w[t] (m x)[t,r,i] (m x)[t,r,i+k-h]``:
    the forgetting-weighted banded outer-product sum of a chunk (Eq. 10,
    masked and weighted), one shifted product per diagonal."""
    h = halfwidth
    *lead, K, n, p = xs.shape
    xm = xs.float() if masks is None else xs.float() * _row_mask(masks, xs)
    xw = xm * weights.float()[..., :, None, None]
    xm = xm.reshape(*lead, K * n, p)
    xw = xw.reshape(*lead, K * n, p)
    band = xs.new_zeros((*lead, 2 * h + 1, p), dtype=torch.float32)
    for k in range(2 * h + 1):
        off = k - h
        lo, hi = max(0, -off), min(p, p - off)
        if hi > lo:
            band[..., k, lo:hi] = (xw[..., lo:hi]
                                   * xm[..., lo + off:hi + off]).sum(-2)
    return band


def cov_band_update(x: torch.Tensor, halfwidth: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """One round (..., n, p) folded with unit weight (``repro.kernels.ref``
    lines 52 and 61), ``mask`` (..., p) liveness, (..., n, p) dropout or
    None: the chunk fold at K = 1, w = 1, so a round and a one-round chunk
    give the same bits."""
    if mask is not None:
        mask = mask[..., None, :] if mask.dim() == x.dim() - 1 \
            else mask[..., None, :, :]
    return band_fold(x[..., None, :, :], x.new_ones(x.shape[:-2] + (1,)),
                     halfwidth, mask)


def cov_band_update_chunk(xs: torch.Tensor, weights: torch.Tensor,
                          halfwidth: int) -> torch.Tensor:
    """Multi-round weighted Eq. 10 (``repro.kernels.ref`` line 70)."""
    return band_fold(xs, weights, halfwidth)


def cov_band_update_chunk_masked(xs: torch.Tensor, masks: torch.Tensor,
                                 weights: torch.Tensor,
                                 halfwidth: int) -> torch.Tensor:
    """Masked chunk variant: ``delta = sum_t w[t] band(xs[t] * m[t])``."""
    return band_fold(xs, weights, halfwidth, masks)


def _project_back(x, w, mean, m):
    """The expressions every stage shares: ``xc = (x - mean) m``,
    ``z = xc W`` and ``xh_r = z W^T`` (x̂ before the mean is added back)."""
    w = w.float()
    xc = (x.float() - mean.float()[..., None, :]) * m
    z = xc @ w
    return xc, z, z @ w.transpose(-1, -2)


def _compress_tail(x, mean, m, xh_r, epsilon):
    xh = xh_r + mean.float()[..., None, :]
    return xh, ((x.float() - xh).abs() > epsilon) & (m > 0.0)


def _monitor_tail(xc, z, xh_r, m, inv_lam):
    resid = (xc - xh_r) * m
    t2 = (z * z * inv_lam.float()[..., None, :]).sum(-1)
    return t2, (resid * resid).sum(-1)


def _ones_or(mask, x):
    return torch.ones_like(x, dtype=torch.float32) if mask is None \
        else mask.float()


def supervised_compress(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor,
                        mask: torch.Tensor | None, epsilon: float,
                        ) -> tuple[torch.Tensor, ...]:
    """The supervised-compression epoch (``repro.kernels.ref`` line 107):
    ``Z = ((X - mean) m) W``; ``X_hat = Z W^T + mean``;
    ``flags = (|X - X_hat| > eps) & m`` (strict, bool).  ``x`` (..., R, p),
    ``w`` (..., p, q), ``mean`` (..., p), ``mask`` (..., R, p) or None."""
    m = _ones_or(mask, x)
    _, z, xh_r = _project_back(x, w, mean, m)
    xh, flags = _compress_tail(x, mean, m, xh_r, epsilon)
    return z, xh, flags


def pca_monitor(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor,
                inv_lam: torch.Tensor, mask: torch.Tensor | None,
                ) -> tuple[torch.Tensor, ...]:
    """The monitoring epoch (``repro.kernels.ref`` line 130): ``Z``,
    ``T2 = sum_c Z_c^2 inv_lam_c`` and ``SPE = ||((X - mean) m - Z W^T)
    m||^2``; shapes as :func:`supervised_compress`, ``inv_lam`` (..., q)."""
    m = _ones_or(mask, x)
    xc, z, xh_r = _project_back(x, w, mean, m)
    t2, spe = _monitor_tail(xc, z, xh_r, m, inv_lam)
    return z, t2, spe


def pca_project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``Z = X W`` over any leading axes (``repro.kernels.ref`` line 97)."""
    return x.float() @ w.float()


def pca_reconstruct(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``X_hat = Z W^T`` over any leading axes (``repro.kernels.ref``
    line 102)."""
    return z.float() @ w.float().transpose(-1, -2)


def fused_stages(xs: torch.Tensor, w: torch.Tensor, mean: torch.Tensor,
                 inv_lam: torch.Tensor, epsilon: float,
                 masks: torch.Tensor | None = None,
                 ) -> tuple[torch.Tensor, ...]:
    """The per-row stages of the fused chunk pass, at the exact width p:
    :func:`supervised_compress` and :func:`pca_monitor` on the flattened
    rows (..., K*n, ...), sharing their projection.  ``xs`` and ``w`` may
    be bf16 (the bf16 tile mode): they are widened to fp32 before any
    product, so the arithmetic is the fp32 one.  Returns
    ``(z, x_hat, flags, t2, spe)``."""
    *lead, K, n, p = xs.shape
    xs, w = xs.float(), w.float()
    x = xs.reshape(*lead, K * n, p)
    m = (torch.ones_like(x) if masks is None
         else _row_mask(masks, xs).reshape(*lead, K * n, p))
    xc, z, xh_r = _project_back(x, w, mean, m)
    xh, flags = _compress_tail(x, mean, m, xh_r, epsilon)
    t2, spe = _monitor_tail(xc, z, xh_r, m, inv_lam)
    return z, xh, flags, t2, spe


def fused_stream(xs: torch.Tensor, weights: torch.Tensor, w: torch.Tensor,
                 mean: torch.Tensor, inv_lam: torch.Tensor, halfwidth: int,
                 epsilon: float, masks: torch.Tensor | None = None,
                 ) -> tuple[torch.Tensor, ...]:
    """The one-pass fused chunk epoch, unfused: the band fold of
    :func:`band_fold` plus :func:`fused_stages` — returns
    ``(band, z, x_hat, flags, t2, spe)`` (``repro.kernels.ref`` line 156).
    bf16 ``xs`` and ``w`` (the bf16 tile mode) are widened to fp32 first:
    no product is taken in bf16."""
    xs, w = xs.float(), w.float()
    band = band_fold(xs, weights, halfwidth, masks)
    return (band,) + fused_stages(xs, w, mean, inv_lam, epsilon, masks)
