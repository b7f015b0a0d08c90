"""Wrappers around the port's CUDA kernels (counterpart of
``repro.kernels.ops``).

Every wrapper dispatches on the device of its tensors: a CUDA tensor
launches the hand-written kernel (``csrc/``) or raises; a CPU tensor takes
the kernel's plain PyTorch version (:mod:`repro_torch.kernels.ref`).  There
is no fallback from one to the other.  Each launch adds one to
``LAUNCHES[kernel]`` and each plain call one to ``PLAIN_CALLS[kernel]``, so
a run can show which path it took (:func:`reset_counts`).

Kernels launch on PyTorch's current stream, do not synchronise, and
allocate nothing: the wrapper allocates every output with ``torch.empty``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import load_library

__all__ = ["LAUNCHES", "PLAIN_CALLS", "reset_counts",
           "cov_band_update_chunk", "cov_band_update_chunk_batched",
           "fused_stream_update", "fused_stream_stages_blocked"]

LAUNCHES = {"fused_stream": 0, "band_fold": 0, "band_fold_masked": 0}
PLAIN_CALLS = {"fused_stream": 0, "band_fold": 0, "band_fold_masked": 0}

_MAX_SLOTS = 65535              # grid y
_STAGE_ROWS = 8                 # kRows in fused_stream.cu
_MAX_SMEM = 232448              # bytes of shared memory a Hopper block can use


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _check(ret: int, kernel: str) -> None:
    if ret != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {ret}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _cuda_f32(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"operand on {t.device}, kernel input on {device}")
    return t.to(torch.float32).contiguous()


def _mask_rows(mask: torch.Tensor, B: int, K: int, n: int, p: int,
               ) -> tuple[torch.Tensor, int]:
    """A (B, K, p) liveness or (B, K, n, p) dropout mask as the kernel's
    mask operand plus its ``per_reading`` flag (1 for dropout)."""
    if mask.shape == (B, K, p):
        return mask, 0
    if mask.shape == (B, K, n, p):
        return mask.reshape(B, K * n, p), 1
    raise ValueError(f"mask shape {tuple(mask.shape)} is neither "
                     f"{(B, K, p)} nor {(B, K, n, p)}")


def cov_band_update_chunk_batched(xs: torch.Tensor, weights: torch.Tensor,
                                  halfwidth: int, *,
                                  mask: torch.Tensor | None = None,
                                  ) -> torch.Tensor:
    """Fold each network's (K, n, p) chunk into its delta band in ONE
    launch for the whole fleet: ``xs`` (B, K, n, p), ``weights`` (B, K) or
    (K,) per-round forgetting weights (0 marks a padded round), ``mask``
    (B, K, p) liveness, (B, K, n, p) dropout, or None.  Returns the
    (B, 2h+1, p) fp32 bands
    ``delta[b, k, i] = sum_t w[b,t] sum_r (m x)[b,t,r,i] (m x)[b,t,r,i+k-h]``.
    Kernels 2 and 3 (``csrc/band_fold.cu``)."""
    if xs.dim() != 4:
        raise ValueError(f"expected (networks, chunk, n, p), got "
                         f"{tuple(xs.shape)}")
    B, K, n, p = xs.shape
    h = int(halfwidth)
    if weights.dim() == 1:
        weights = weights[None, :].expand(B, K)
    if weights.shape != (B, K):
        raise ValueError(f"weights shape {tuple(weights.shape)} != {(B, K)}")
    kernel = "band_fold" if mask is None else "band_fold_masked"
    if mask is not None:
        _mask_rows(mask, B, K, n, p)
    if not xs.is_cuda:
        PLAIN_CALLS[kernel] += 1
        if mask is None:
            return ref.cov_band_update_chunk(xs, weights, h)
        return ref.cov_band_update_chunk_masked(xs, mask, weights, h)
    if B > _MAX_SLOTS:
        raise ValueError(f"{B} networks exceed the grid's {_MAX_SLOTS}")
    dev = xs.device
    x = _cuda_f32(xs, dev)
    w = _cuda_f32(weights, dev)
    band = torch.empty((B, 2 * h + 1, p), device=dev, dtype=torch.float32)
    lib = load_library("band_fold")
    if mask is None:
        ret = lib.band_fold_f32(x.data_ptr(), w.data_ptr(), B, K, n, p, h,
                                band.data_ptr(), _stream())
    else:
        m, per_reading = _mask_rows(_cuda_f32(mask, dev), B, K, n, p)
        ret = lib.band_fold_masked_f32(x.data_ptr(), w.data_ptr(),
                                       m.data_ptr(), B, K, n, per_reading, p,
                                       h, band.data_ptr(), _stream())
    _check(ret, kernel)
    LAUNCHES[kernel] += 1
    return band


def cov_band_update_chunk(xs: torch.Tensor, weights: torch.Tensor,
                          halfwidth: int, *,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """One network's (K, n, p) chunk folded into a (2h+1, p) delta band:
    :func:`cov_band_update_chunk_batched` with a fleet of one."""
    if xs.dim() != 3:
        raise ValueError(f"expected (chunk, n, p), got {tuple(xs.shape)}")
    return cov_band_update_chunk_batched(
        xs[None], weights[None], halfwidth,
        mask=None if mask is None else mask[None])[0]


def _fused_prep(x, basis, mean, inv_lam, precision):
    """Operand rules shared by the fused wrapper and its stage-only twin
    (``repro.kernels.ops._fused_prep``): fp32 canonical forms, zero mean
    and unit inverse eigenvalues by default.  The bf16 tile mode has no
    kernel in the port yet and raises."""
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"precision must be 'fp32' or 'bf16', "
                         f"got {precision!r}")
    if precision == "bf16":
        raise NotImplementedError(
            "precision='bf16' needs the bf16 form of kernel "
            "fused_stream_pallas, which is not ported yet")
    S, _, _, p = x.shape
    q = basis.shape[-1]
    mean = (x.new_zeros((S, p), dtype=torch.float32) if mean is None
            else mean.to(torch.float32))
    inv_lam = (x.new_ones((S, q), dtype=torch.float32) if inv_lam is None
               else inv_lam.to(torch.float32))
    return x.to(torch.float32), basis.to(torch.float32), mean, inv_lam


def fused_stream_update(x: torch.Tensor, weights: torch.Tensor,
                        basis: torch.Tensor,
                        mean: torch.Tensor | None = None,
                        inv_lam: torch.Tensor | None = None, *,
                        halfwidth: int, epsilon: float = 0.0,
                        with_compress: bool, with_monitor: bool,
                        mask: torch.Tensor | None = None,
                        precision: str = "fp32"):
    """ONE launch over every slot's chunk: the forgetting-weighted band
    fold plus the configured per-row stages (kernel 1,
    ``csrc/fused_stream.cu``).

    ``x`` (S, K, n, p) chunks, ``weights`` (S, K) per-round weights,
    ``basis`` (S, p, q), ``mean`` (S, p), ``inv_lam`` (S, q), ``mask``
    (S, K, p) per-round liveness × round validity, or None (all live).
    Returns ``(band, z, x_hat, flagged, t2, spe)``: band
    (S, 2h+1, p); z (S, K*n, q); x_hat (S, K*n, p) and bool flagged
    (compression, else None); t2, spe (S, K*n) (monitoring, else None).
    The flattened (K*n) row order is the reference's chunk view."""
    if not (with_compress or with_monitor):
        raise ValueError("band-only chunk: use cov_band_update_chunk")
    if x.dim() != 4:
        raise ValueError(f"expected (slots, chunk, n, p), got "
                         f"{tuple(x.shape)}")
    x, basis, mean, inv_lam = _fused_prep(x, basis, mean, inv_lam,
                                          precision)
    S, K, n, p = x.shape
    q = basis.shape[-1]
    h = int(halfwidth)
    if weights.shape != (S, K) or basis.shape != (S, p, q) \
            or mean.shape != (S, p) or inv_lam.shape != (S, q):
        raise ValueError(
            f"operand shapes weights {tuple(weights.shape)}, basis "
            f"{tuple(basis.shape)}, mean {tuple(mean.shape)}, inv_lam "
            f"{tuple(inv_lam.shape)} do not match x {(S, K, n, p)}")
    if mask is not None and mask.shape != (S, K, p):
        raise ValueError(f"mask shape {tuple(mask.shape)} is not the "
                         f"per-round {(S, K, p)}")
    if not x.is_cuda:
        PLAIN_CALLS["fused_stream"] += 1
        band, z, xh, fl, t2, spe = ref.fused_stream(
            x, weights, basis, mean, inv_lam, h, float(epsilon), mask)
    else:
        if S > _MAX_SLOTS:
            raise ValueError(f"{S} slots exceed the grid's {_MAX_SLOTS}")
        if 4 * _STAGE_ROWS * (p + q) > _MAX_SMEM:
            raise ValueError(f"p={p} exceeds the stage block's shared "
                             f"memory")
        dev = x.device
        xx, w = _cuda_f32(x, dev), _cuda_f32(weights, dev)
        bs, mu, il = (_cuda_f32(basis, dev), _cuda_f32(mean, dev),
                      _cuda_f32(inv_lam, dev))
        R = K * n
        f32 = dict(device=dev, dtype=torch.float32)
        band = torch.empty((S, 2 * h + 1, p), **f32)
        z = torch.empty((S, R, q), **f32)
        xh = torch.empty((S, R, p), **f32) if with_compress else None
        fl = (torch.empty((S, R, p), device=dev, dtype=torch.bool)
              if with_compress else None)
        t2 = torch.empty((S, R), **f32) if with_monitor else None
        spe = torch.empty((S, R), **f32) if with_monitor else None
        m = None if mask is None else _cuda_f32(mask, dev)
        ptr = lambda t: None if t is None else t.data_ptr()
        ret = load_library("fused_stream").fused_stream_f32(
            xx.data_ptr(), w.data_ptr(), ptr(m), bs.data_ptr(), mu.data_ptr(),
            il.data_ptr(), S, K, n, p, q, h, float(epsilon),
            int(with_compress), int(with_monitor), band.data_ptr(),
            z.data_ptr(), ptr(xh), ptr(fl), ptr(t2), ptr(spe), _stream())
        _check(ret, "fused_stream")
        LAUNCHES["fused_stream"] += 1
    return (band, z, xh if with_compress else None,
            fl if with_compress else None,
            t2 if with_monitor else None, spe if with_monitor else None)


def fused_stream_stages_blocked(x: torch.Tensor, basis: torch.Tensor,
                                mean: torch.Tensor | None = None,
                                inv_lam: torch.Tensor | None = None, *,
                                epsilon: float = 0.0,
                                with_compress: bool, with_monitor: bool,
                                mask: torch.Tensor | None = None,
                                precision: str = "fp32"):
    """The fused kernel's STAGE arithmetic in plain torch, on any device —
    the chunk step's post-refresh recompute against the rotated basis (the
    fold does not depend on the basis, so only the stages are redone).
    Same shapes as :func:`fused_stream_update`; returns
    ``(z, x_hat, flagged, t2, spe)`` with None for disabled stages."""
    x, basis, mean, inv_lam = _fused_prep(x, basis, mean, inv_lam,
                                          precision)
    z, xh, fl, t2, spe = ref.fused_stages(x, basis, mean, inv_lam,
                                          float(epsilon), mask)
    return (z, xh if with_compress else None,
            fl if with_compress else None,
            t2 if with_monitor else None, spe if with_monitor else None)
