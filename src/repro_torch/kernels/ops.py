"""Wrappers around the port's CUDA kernels (counterpart of
``repro.kernels.ops``).

Every wrapper dispatches on the device of its tensors: a CUDA tensor
launches the hand-written kernel (``csrc/``) or raises; a CPU tensor takes
the kernel's plain PyTorch version (:mod:`repro_torch.kernels.ref`).  There
is no fallback from one to the other.  Each launch adds one to
``LAUNCHES[kernel]`` and each plain call one to ``PLAIN_CALLS[kernel]``, so
a run can show which path it took (:func:`reset_counts`); a launch that
also adds its result to a state in the kernel's write-out adds one to
``IN_KERNEL_ADDS[kernel]`` besides.

Kernels launch on PyTorch's current stream, do not synchronise, and
allocate nothing: the wrapper allocates every output with ``torch.empty``.

A dry run (``repro_torch.launch.dryrun``) hands the wrappers of kernels 6,
7, 10 and 11 fake tensors (``FakeTensorMode``: shapes, no data).  Such a
call neither launches nor runs the plain version: it appends the call
(kernel, operand shapes and dtypes, parameters, output) to
:data:`PLANNED`, which the dry run prices with
``analysis.resources.call_work``, and returns an empty output of the
kernel's shape.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import ref
from repro_torch.kernels.build import load_library

__all__ = ["LAUNCHES", "PLAIN_CALLS", "IN_KERNEL_ADDS", "PLANNED",
           "reset_counts",
           "SEGMENT_ROWS", "LONG_ROUND_ROWS", "RoundPlan", "band_pairs",
           "band_round_plan", "MatvecPlan", "banded_matvec_plan",
           "cov_band_update", "cov_band_update_batched",
           "cov_band_accumulate",
           "cov_band_update_chunk", "cov_band_update_chunk_batched",
           "fused_tiles", "fused_stream_update",
           "fused_stream_stages_blocked",
           "supervised_compress", "pca_monitor", "pca_project",
           "pca_reconstruct", "banded_matmul", "banded_matvec"]

_KERNELS = ("fused_stream", "fused_stream_bf16", "band_fold",
            "band_fold_masked", "band_round", "band_round_masked",
            "band_round_masked_drop", "supervised_compress", "pca_monitor", "pca_project",
            "pca_reconstruct", "banded_matmul", "banded_matvec")
LAUNCHES = dict.fromkeys(_KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(_KERNELS, 0)
# folds whose add to the state ran in the kernel (cov_band_accumulate)
IN_KERNEL_ADDS = {"band_round": 0}

_MAX_SLOTS = 65535              # grid y


PLANNED: list = []


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS, IN_KERNEL_ADDS):
        for k in d:
            d[k] = 0
    PLANNED.clear()


def _planned(kernel: str, operands: dict, params: dict,
             out: torch.Tensor) -> torch.Tensor:
    """A call on fake tensors: recorded in :data:`PLANNED`, ``out``
    returned as it is (empty)."""
    PLANNED.append((kernel, {k: (tuple(t.shape), t.dtype)
                             for k, t in operands.items()},
                    params, ((tuple(out.shape), out.dtype),)))
    return out


def _check(ret: int, kernel: str) -> None:
    if ret != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {ret}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _cuda_operand(t: torch.Tensor, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``t`` as a kernel operand: on ``device`` (else raises), in ``dtype``,
    contiguous."""
    if t.device != device:
        raise ValueError(f"operand on {t.device}, kernel input on {device}")
    return t.to(dtype).contiguous()


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _cuda_checks(S, R):
    """What a launch over every slot cannot take: more slots than grid y,
    or no rows."""
    if S > _MAX_SLOTS:
        raise ValueError(f"{S} slots exceed the grid's {_MAX_SLOTS}")
    if R < 1:
        raise ValueError("no rows to launch over")


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    """The card's SM count, queried once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _max_q(library: str, entry: str, *args: int) -> int:
    """The largest q a C entry (``*_max_q``) reports for a device (and
    mode), queried once: a device attribute does not change."""
    return getattr(load_library(library), entry)(*args)


def _stage_tile_library(S, R, q, device):
    """The library of kernels 4 and 5 once their launch checks pass: q up
    to the stage tile's shared memory (``stage_tile_max_q``, 276 on the
    H100; any p)."""
    _cuda_checks(S, R)
    lib = load_library("pca_project")
    max_q = _max_q("pca_project", "stage_tile_max_q", device.index)
    if q > max_q:
        raise ValueError(f"q={q} exceeds the stage tile's shared memory "
                         f"(q <= {max_q})")
    return lib


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


# The band folds' order of sums (csrc/band_syrk.cuh): a round's rows in
# segments of SEGMENT_ROWS (kSegRows), folded in order; kernels 6 and 7
# take the round's shape up to LONG_ROUND_ROWS (kLongRound) rows.
SEGMENT_ROWS = 64
LONG_ROUND_ROWS = 64
_TILE_COLS = 64                 # the SYRK tile's T (kSyrkT)
# the split fold (band_fold.cu's band_pair_kernel) takes bands whose
# columns times diagonal groups of SPLIT_DIAGS (kPairDiags) fit a block of
# SPLIT_MAX_THREADS (kPairThreads), and p up to SPLIT_MAX_P (kPairMaxP),
# on launches whose tile grid is smaller than the card's SM count
SPLIT_MAX_THREADS = 512
SPLIT_DIAGS = 4
SPLIT_MAX_P = 128
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """How kernels 6 and 7 fold one launch of S rounds of n rows (p, h):
    ``segments`` of the order of sums (n alone fixes them), ``shape``
    ("round", "long" or "split"), the ``blocks`` a slot's launch has (the
    split fold's first kernel: one a segment), and the split fold's
    ``workspace_bytes`` (0 otherwise)."""
    segments: int
    shape: str
    blocks: int
    workspace_bytes: int


def band_pairs(p: int, h: int) -> int:
    """Unique pairs (i, j), i <= j <= i + h, j < p, of a (2h+1, p) band."""
    d = min(h, p - 1)
    return (d + 1) * p - d * (d + 1) // 2


def _split_threads(p: int, h: int) -> int:
    """Threads of the split fold's first kernel: a column times each group
    of SPLIT_DIAGS diagonals (``pair_threads`` in csrc/band_fold.cu)."""
    return p * -(-(min(h, p - 1) + 1) // SPLIT_DIAGS)


def band_round_plan(S: int, n: int, p: int, h: int,
                    sms: int = H100_SMS) -> RoundPlan:
    """The shape ``csrc/band_fold.cu`` gives a launch (its ``launch_round``,
    with the wrapper's choice of a workspace): the round's shape up to
    LONG_ROUND_ROWS rows; beyond, kernel 2's tile at unit weight ("long",
    on the same grid of tiles), unless that grid (S x tiles) is smaller
    than the card's ``sms`` and the band is small (SPLIT_MAX_P columns, a
    block of SPLIT_MAX_THREADS), where each segment gets a block of its own
    (the split fold) and the partials, one float a pair and segment, a
    workspace."""
    segments = -(-n // SEGMENT_ROWS)
    tiles = -(-p // _TILE_COLS)
    blocks = tiles * (min(-(-h // _TILE_COLS), tiles - 1) + 1)
    if n <= LONG_ROUND_ROWS:
        return RoundPlan(segments, "round", blocks, 0)
    if (S * blocks < sms and p <= SPLIT_MAX_P
            and _split_threads(p, h) <= SPLIT_MAX_THREADS):
        return RoundPlan(segments, "split", segments,
                         4 * S * segments * band_pairs(p, h))
    return RoundPlan(segments, "long", blocks, 0)


# Kernel 11's plan (csrc/banded.cu, constants kMatvec*, kBandedThreads):
# "slot" (banded_matvec_slot_f32) stages a slot whole in a block of at
# most MATVEC_SLOT_THREADS where its in-range diagonals and v fit
# MATVEC_SLOT_MAX_BYTES and its grid, a block a slot, is smaller than the
# card; else "thread" (banded_matvec_f32), one output a thread in blocks
# of MATVEC_THREADS.
MATVEC_SLOT_THREADS = 256
MATVEC_SLOT_MAX_BYTES = 48 * 1024
MATVEC_THREADS = 256


@dataclasses.dataclass(frozen=True)
class MatvecPlan:
    """How kernel 11 runs one launch: its ``shape`` ("slot" or "thread"),
    ``threads`` a block, ``blocks`` a slot (grid x; the slots are grid y)
    and ``smem_bytes`` of dynamic shared memory."""
    shape: str
    threads: int
    blocks: int
    smem_bytes: int


def _matvec_slot_bytes(p: int, h: int) -> int:
    """The slot shape's shared memory: the diagonals that hold an in-range
    entry (|k - h| <= p - 1), p floats each, then v at a 16-byte
    boundary."""
    kd = min(2 * h, h + p - 1) - max(0, h - p + 1) + 1
    return 4 * (-(-kd * p // 4) * 4 + p)


def banded_matvec_plan(S: int, p: int, h: int,
                       sms: int = H100_SMS) -> MatvecPlan:
    """The shape and grid of a kernel-11 launch of S slots of a (2h+1, p)
    band on a card of ``sms`` SMs: "slot" where the band's in-range
    diagonals and v fit MATVEC_SLOT_MAX_BYTES and S < ``sms`` (one block a
    slot; the shape was timed only on such grids), else "thread"."""
    slot_bytes = _matvec_slot_bytes(p, h)
    if slot_bytes <= MATVEC_SLOT_MAX_BYTES and S < sms:
        return MatvecPlan("slot", min(-(-p // 32) * 32, MATVEC_SLOT_THREADS),
                          1, slot_bytes)
    return MatvecPlan("thread", MATVEC_THREADS, -(-p // MATVEC_THREADS), 0)


def cov_band_update_batched(x: torch.Tensor, halfwidth: int, *,
                            mask: torch.Tensor | None = None,
                            ) -> torch.Tensor:
    """Fold each network's round into its delta band in ONE launch for
    the whole fleet: ``x`` (B, n, p), ``mask`` (B, p) liveness — read once
    for all n rows, never broadcast in device memory — (B, n, p) dropout,
    or None.  Returns the (B, 2h+1, p) fp32 bands
    ``delta[b, k, i] = sum_r (m x)[b,r,i] (m x)[b,r,i+k-h]``: the chunk
    fold at K = 1 with unit weight.  Kernels 6 and 7
    (``csrc/band_fold.cu``: the tile of ``csrc/band_syrk.cuh`` in its round
    shape, half the band summed and mirrored, so the band is exactly
    symmetric and carries the chunk fold's bits at K = 1).  Kernel 7 counts
    under ``band_round_masked`` with a liveness row and under
    ``band_round_masked_drop`` with a dropout mask."""
    if x.dim() != 3:
        raise ValueError(f"expected (networks, n, p), got {tuple(x.shape)}")
    B, n, p = x.shape
    h = int(halfwidth)
    kernel = ("band_round" if mask is None else "band_round_masked"
              if mask.dim() == 2 else "band_round_masked_drop")
    if mask is not None and mask.shape not in ((B, p), (B, n, p)):
        raise ValueError(f"mask shape {tuple(mask.shape)} is neither "
                         f"{(B, p)} nor {(B, n, p)}")
    if isinstance(x, FakeTensor):
        ops_ = {"x": x} if mask is None else {"x": x, "mask": mask}
        return _planned(kernel, ops_, {"halfwidth": h}, x.new_empty(
            (B, 2 * h + 1, p), dtype=torch.float32))
    if not x.is_cuda:
        PLAIN_CALLS[kernel] += 1
        return ref.cov_band_update(x, h, mask)
    if B > _MAX_SLOTS:
        raise ValueError(f"{B} networks exceed the grid's {_MAX_SLOTS}")
    dev = x.device
    xx = _cuda_operand(x, dev)
    band = torch.empty((B, 2 * h + 1, p), device=dev, dtype=torch.float32)
    plan = band_round_plan(B, n, p, h, _sms(dev))
    ws = (torch.empty(plan.workspace_bytes // 4, device=dev,
                      dtype=torch.float32) if plan.shape == "split" else None)
    lib = load_library("band_fold")
    if mask is None:
        ret = lib.band_round_f32(xx.data_ptr(), B, n, p, h, _ptr(ws),
                                 band.data_ptr(), _stream())
    else:
        m = _cuda_operand(mask, dev)
        ret = lib.band_round_masked_f32(xx.data_ptr(), m.data_ptr(), B, n,
                                        int(m.dim() == 3), p, h, _ptr(ws),
                                        band.data_ptr(), _stream())
    _check(ret, kernel)
    LAUNCHES[kernel] += 1
    return band


def cov_band_update(x: torch.Tensor, halfwidth: int, *,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """One network's (n, p) round folded into a (2h+1, p) delta band,
    ``mask`` (p,) liveness, (n, p) dropout or None:
    :func:`cov_band_update_batched` with a fleet of one."""
    if x.dim() != 2:
        raise ValueError(f"expected (n, p), got {tuple(x.shape)}")
    return cov_band_update_batched(
        x[None], halfwidth, mask=None if mask is None else mask[None])[0]


def cov_band_accumulate(band: torch.Tensor, x: torch.Tensor,
                        halfwidth: int) -> torch.Tensor:
    """``band + cov_band_update(x, halfwidth)`` in ONE launch of kernel 6:
    one network's (n, p) round folded into its (2h+1, p) fp32 band, the add
    done in the kernel's write-out (``band_round_acc_f32``), each entry one
    fp32 add of the sum the delta form computes, so the two-step form's
    bits.  Returns a new band; ``band`` is left as it was.  Counts under
    ``LAUNCHES["band_round"]`` and ``IN_KERNEL_ADDS["band_round"]``; on the
    CPU the two steps, under ``PLAIN_CALLS["band_round"]``."""
    if x.dim() != 2:
        raise ValueError(f"expected (n, p), got {tuple(x.shape)}")
    n, p = x.shape
    h = int(halfwidth)
    if tuple(band.shape) != (2 * h + 1, p):
        raise ValueError(f"band shape {tuple(band.shape)} is not "
                         f"{(2 * h + 1, p)}")
    if isinstance(x, FakeTensor) or isinstance(band, FakeTensor):
        return _planned("band_round", {"band": band, "x": x},
                        {"halfwidth": h}, band.new_empty(
                            band.shape, dtype=torch.float32))
    if not x.is_cuda:
        PLAIN_CALLS["band_round"] += 1
        return band + ref.cov_band_update(x, h)
    dev = x.device
    if band.device != dev or band.dtype != torch.float32:
        raise ValueError(f"band {band.dtype} on {band.device}: the kernel "
                         f"adds into an fp32 band on {dev}")
    xx, prior = _cuda_operand(x, dev), band.contiguous()
    out = torch.empty_like(prior)
    plan = band_round_plan(1, n, p, h, _sms(dev))
    ws = (torch.empty(plan.workspace_bytes // 4, device=dev,
                      dtype=torch.float32) if plan.shape == "split" else None)
    ret = load_library("band_fold").band_round_acc_f32(
        xx.data_ptr(), prior.data_ptr(), 1, n, p, h, _ptr(ws),
        out.data_ptr(), _stream())
    _check(ret, "band_round")
    LAUNCHES["band_round"] += 1
    IN_KERNEL_ADDS["band_round"] += 1
    return out


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
    Kernels 2 and 3 (``csrc/band_fold.cu``, tiled in ``csrc/band_syrk.cuh``:
    half the band summed per round, weighted, and mirrored, so the band is
    exactly symmetric)."""
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
    x = _cuda_operand(xs, dev)
    w = _cuda_operand(weights, dev)
    band = torch.empty((B, 2 * h + 1, p), device=dev, dtype=torch.float32)
    lib = load_library("band_fold")
    if mask is None:
        ret = lib.band_fold_f32(x.data_ptr(), w.data_ptr(), B, K, n, p, h,
                                band.data_ptr(), _stream())
    else:
        m, per_reading = _mask_rows(_cuda_operand(mask, dev), B, K, n, p)
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


_TILE = {"fp32": torch.float32, "bf16": torch.bfloat16}


def fused_tiles(t: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """``t`` as a tile operand of kernel 1 (x or the basis): fp32, or with
    ``precision="bf16"`` rounded to bf16 from fp32 (to nearest even, as
    XLA's convert does in ``repro.kernels.ops._fused_prep``).  A tensor
    already in the tile type is returned as it is, so a chunk rounded once
    serves both the kernel and the post-refresh recompute."""
    if precision not in _TILE:
        raise ValueError(f"precision must be 'fp32' or 'bf16', "
                         f"got {precision!r}")
    tile = _TILE[precision]
    return t if t.dtype == tile else t.to(torch.float32).to(tile)


def _fused_prep(x, basis, mean, inv_lam, precision):
    """Operand rules shared by the fused wrapper and its stage-only twin
    (``repro.kernels.ops._fused_prep``): x and the basis as tile operands
    (:func:`fused_tiles`); zero mean and unit inverse eigenvalues by
    default, fp32.  The mask, the weights and every output stay fp32."""
    x, basis = fused_tiles(x, precision), fused_tiles(basis, precision)
    S, _, _, p = x.shape
    q = basis.shape[-1]
    mean = (x.new_zeros((S, p), dtype=torch.float32) if mean is None
            else mean.to(torch.float32))
    inv_lam = (x.new_ones((S, q), dtype=torch.float32) if inv_lam is None
               else inv_lam.to(torch.float32))
    return x, basis, mean, inv_lam


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
    ``csrc/fused_stream.cu``: ``fused_stream_f32``, or ``fused_stream_bf16``
    with ``precision="bf16"``, counted under its own key).  The fold is
    kernel 3's banded SYRK tile (``csrc/band_syrk.cuh``), the stages a
    register tile over 64 rows (``csrc/stage_tile.cuh``) that reads the
    basis as it lies; any p, and q up to the stage tile's shared memory
    (``fused_stream_max_q``: a ``ValueError`` beyond it).

    ``x`` (S, K, n, p) chunks, ``weights`` (S, K) per-round weights,
    ``basis`` (S, p, q), ``mean`` (S, p), ``inv_lam`` (S, q), ``mask``
    (S, K, p) per-round liveness × round validity, or None (all live).
    ``precision="bf16"`` rounds x and the basis to bf16 (:func:`fused_tiles`);
    the kernel widens each element to fp32 as it loads it and computes in
    fp32.  Returns ``(band, z, x_hat, flagged, t2, spe)``: band
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
    kernel = "fused_stream_bf16" if precision == "bf16" else "fused_stream"
    if not x.is_cuda:
        PLAIN_CALLS[kernel] += 1
        band, z, xh, fl, t2, spe = ref.fused_stream(
            x, weights, basis, mean, inv_lam, h, float(epsilon), mask)
    else:
        _cuda_checks(S, K * n)
        dev = x.device
        lib = load_library("fused_stream")
        max_q = _max_q("fused_stream", "fused_stream_max_q", dev.index,
                       int(precision == "bf16"))
        if q > max_q:
            raise ValueError(f"q={q} exceeds kernel 1's shared memory "
                             f"(q <= {max_q} with {precision} tiles)")
        xx, bs = (_cuda_operand(t, dev, x.dtype) for t in (x, basis))
        w, mu, il = (_cuda_operand(t, dev) for t in (weights, mean, inv_lam))
        R = K * n
        f32 = dict(device=dev, dtype=torch.float32)
        band = torch.empty((S, 2 * h + 1, p), **f32)
        z = torch.empty((S, R, q), **f32)
        xh = torch.empty((S, R, p), **f32) if with_compress else None
        fl = (torch.empty((S, R, p), device=dev, dtype=torch.bool)
              if with_compress else None)
        t2 = torch.empty((S, R), **f32) if with_monitor else None
        spe = torch.empty((S, R), **f32) if with_monitor else None
        m = None if mask is None else _cuda_operand(mask, dev)
        entry = getattr(lib, "fused_stream_bf16" if precision == "bf16"
                        else "fused_stream_f32")
        ret = entry(
            xx.data_ptr(), w.data_ptr(), _ptr(m), bs.data_ptr(),
            mu.data_ptr(), il.data_ptr(), S, K, n, p, q, h,
            float(epsilon), int(with_compress), int(with_monitor),
            band.data_ptr(), z.data_ptr(), _ptr(xh), _ptr(fl), _ptr(t2),
            _ptr(spe), _stream())
        _check(ret, kernel)
        LAUNCHES[kernel] += 1
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
    Same shapes and operand rules as :func:`fused_stream_update` (with
    ``precision="bf16"``, pass the x the kernel was given: it is not rounded
    again); returns ``(z, x_hat, flagged, t2, spe)`` with None for disabled
    stages."""
    x, basis, mean, inv_lam = _fused_prep(x, basis, mean, inv_lam,
                                          precision)
    z, xh, fl, t2, spe = ref.fused_stages(x, basis, mean, inv_lam,
                                          float(epsilon), mask)
    return (z, xh if with_compress else None,
            fl if with_compress else None,
            t2 if with_monitor else None, spe if with_monitor else None)


def _stage_operands(x, basis, mean, inv_lam=None, *, monitor=False):
    """Shape checks and fp32 defaults shared by the split-path wrappers:
    ``x`` (S, R, p), ``basis`` (S, p, q), ``mean`` (S, p) or None (zero),
    and with ``monitor`` ``inv_lam`` (S, q) or None (ones; else None)."""
    if x.dim() != 3:
        raise ValueError(f"expected (slots, rows, p), got {tuple(x.shape)}")
    S, R, p = x.shape
    q = basis.shape[-1]
    mean = (x.new_zeros((S, p), dtype=torch.float32) if mean is None
            else mean.to(torch.float32))
    if monitor:
        inv_lam = (x.new_ones((S, q), dtype=torch.float32) if inv_lam is None
                   else inv_lam.to(torch.float32))
    if basis.shape != (S, p, q) or mean.shape != (S, p) \
            or (monitor and inv_lam.shape != (S, q)):
        raise ValueError(
            f"operand shapes basis {tuple(basis.shape)}, mean "
            f"{tuple(mean.shape)}, inv_lam "
            f"{None if inv_lam is None else tuple(inv_lam.shape)} do not "
            f"match x {(S, R, p)}")
    return S, R, p, q, mean, inv_lam


def _stage_mask(mask, S, R, p, n):
    """A stage mask and the row divisor the kernel reads it with: (S, R, p)
    per row (``n`` None, divisor 1), or (S, R / n, p) per round (divisor
    n: row r reads mask row r // n); None means every reading live."""
    if mask is None:
        return None, 1
    div = 1 if n is None else int(n)
    if div < 1 or R % div or mask.shape != (S, R // div, p):
        raise ValueError(f"mask shape {tuple(mask.shape)} with n={n} does "
                         f"not fit rows {(S, R, p)}")
    return mask, div


def _plain_mask(m, div):
    return m if m is None or div == 1 else m.repeat_interleave(div, dim=-2)


def supervised_compress(x: torch.Tensor, basis: torch.Tensor,
                        mean: torch.Tensor | None = None, *,
                        epsilon: float, mask: torch.Tensor | None = None,
                        n: int | None = None):
    """ONE launch over every slot: ``z = ((x - mean) m) W``,
    ``x_hat = z W^T + mean``, ``flags = (|x - x_hat| > eps) & m``
    (kernel 4, ``csrc/pca_project.cu``: kernel 1's stage tile,
    ``csrc/stage_tile.cuh``, which reads the basis as it lies; any p, and q
    up to the tile's shared memory, ``stage_tile_max_q``: a ``ValueError``
    beyond).  ``x`` (S, R, p), ``basis`` (S, p, q), ``mean`` (S, p);
    ``mask`` (S, R, p) per row, (S, R / n, p) per round with ``n`` given,
    or None.  Returns ``(z, x_hat, flagged)``: (S, R, q), (S, R, p) fp32
    and (S, R, p) bool."""
    S, R, p, q, mean, _ = _stage_operands(x, basis, mean)
    m, div = _stage_mask(mask, S, R, p, n)
    if not x.is_cuda:
        PLAIN_CALLS["supervised_compress"] += 1
        return ref.supervised_compress(x, basis, mean, _plain_mask(m, div),
                                       float(epsilon))
    dev = x.device
    lib = _stage_tile_library(S, R, q, dev)
    xx, bs, mu = (_cuda_operand(t, dev) for t in (x, basis, mean))
    mm = None if m is None else _cuda_operand(m, dev)
    z = torch.empty((S, R, q), device=dev, dtype=torch.float32)
    xh = torch.empty((S, R, p), device=dev, dtype=torch.float32)
    fl = torch.empty((S, R, p), device=dev, dtype=torch.bool)
    ret = lib.supervised_compress_f32(
        xx.data_ptr(), _ptr(mm), bs.data_ptr(), mu.data_ptr(), S, R, p, q,
        div, float(epsilon), z.data_ptr(), xh.data_ptr(), fl.data_ptr(),
        _stream())
    _check(ret, "supervised_compress")
    LAUNCHES["supervised_compress"] += 1
    return z, xh, fl


def pca_monitor(x: torch.Tensor, basis: torch.Tensor,
                mean: torch.Tensor | None = None,
                inv_lam: torch.Tensor | None = None, *,
                mask: torch.Tensor | None = None, n: int | None = None):
    """ONE launch over every slot: ``z``, ``T2 = sum_c z_c^2 inv_lam_c``
    and ``SPE = ||((x - mean) m - z W^T) m||^2``; x̂ never reaches device
    memory (kernel 5, ``csrc/pca_project.cu``: the stage tile, as kernel
    4).  Operands and limits as :func:`supervised_compress`, ``inv_lam``
    (S, q) (default ones).
    Returns ``(z, t2, spe)``: (S, R, q), (S, R), (S, R) fp32."""
    S, R, p, q, mean, inv_lam = _stage_operands(x, basis, mean, inv_lam,
                                                monitor=True)
    m, div = _stage_mask(mask, S, R, p, n)
    if not x.is_cuda:
        PLAIN_CALLS["pca_monitor"] += 1
        return ref.pca_monitor(x, basis, mean, inv_lam, _plain_mask(m, div))
    dev = x.device
    lib = _stage_tile_library(S, R, q, dev)
    xx, bs, mu, il = (_cuda_operand(t, dev) for t in (x, basis, mean, inv_lam))
    mm = None if m is None else _cuda_operand(m, dev)
    f32 = dict(device=dev, dtype=torch.float32)
    z = torch.empty((S, R, q), **f32)
    t2, spe = torch.empty((S, R), **f32), torch.empty((S, R), **f32)
    ret = lib.pca_monitor_f32(
        xx.data_ptr(), _ptr(mm), bs.data_ptr(), mu.data_ptr(), il.data_ptr(),
        S, R, p, q, div, z.data_ptr(), t2.data_ptr(), spe.data_ptr(),
        _stream())
    _check(ret, "pca_monitor")
    LAUNCHES["pca_monitor"] += 1
    return z, t2, spe


def pca_project(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """``Z = X W`` for every slot in ONE launch, fp32 accumulation over p
    in increasing order (kernel 8, ``csrc/pca_project.cu``: a register-tiled
    product that streams p through shared memory, so any p fits): ``x``
    (S, R, p) rows, already centred and masked, ``basis`` (S, p, q)
    -> (S, R, q)."""
    if x.dim() != 3:
        raise ValueError(f"expected (slots, rows, p), got {tuple(x.shape)}")
    S, R, p = x.shape
    q = basis.shape[-1]
    if basis.shape != (S, p, q):
        raise ValueError(f"operand shapes basis {tuple(basis.shape)} do "
                         f"not match x {(S, R, p)}")
    if not x.is_cuda:
        PLAIN_CALLS["pca_project"] += 1
        return ref.pca_project(x, basis)
    _cuda_checks(S, R)
    dev = x.device
    xx, bs = _cuda_operand(x, dev), _cuda_operand(basis, dev)
    z = torch.empty((S, R, q), device=dev, dtype=torch.float32)
    ret = load_library("pca_project").pca_project_f32(
        xx.data_ptr(), bs.data_ptr(), S, R, p, q, z.data_ptr(), _stream())
    _check(ret, "pca_project")
    LAUNCHES["pca_project"] += 1
    return z


def pca_reconstruct(z: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """``X_hat = Z W^T`` for every slot in ONE launch, fp32 accumulation
    over q in increasing order (kernel 9, ``csrc/pca_project.cu``: a
    register-tiled product that reads the (S, p, q) basis itself, with no
    transposed copy; q is bounded by its shared memory, 224 on the H100):
    ``z`` (S, R, q), ``basis`` (S, p, q) -> (S, R, p) fp32."""
    if z.dim() != 3 or basis.dim() != 3 or basis.shape[0] != z.shape[0] \
            or basis.shape[2] != z.shape[2]:
        raise ValueError(f"scores {tuple(z.shape)} do not match basis "
                         f"{tuple(basis.shape)}")
    S, R, q = z.shape
    p = basis.shape[1]
    if not z.is_cuda:
        PLAIN_CALLS["pca_reconstruct"] += 1
        return ref.pca_reconstruct(z, basis)
    _cuda_checks(S, R)
    dev = z.device
    lib = load_library("pca_project")
    max_q = _max_q("pca_project", "pca_reconstruct_max_q", dev.index)
    if q > max_q:
        raise ValueError(f"q={q} exceeds kernel 9's shared memory "
                         f"(q <= {max_q})")
    zz, bs = _cuda_operand(z, dev), _cuda_operand(basis, dev)
    xh = torch.empty((S, R, p), device=dev, dtype=torch.float32)
    ret = lib.pca_reconstruct_f32(zz.data_ptr(), bs.data_ptr(), S, R, p, q,
                                  xh.data_ptr(), _stream())
    _check(ret, "pca_reconstruct")
    LAUNCHES["pca_reconstruct"] += 1
    return xh


def _banded(band: torch.Tensor, V: torch.Tensor, vec: bool) -> torch.Tensor:
    """Kernels 10 (``vec`` False: V (..., p, q)) and 11 (``vec`` True:
    v (..., p)) over the leading axes of ``band`` (..., 2h+1, p), which V
    shares; the leading axes are flattened onto the grid's y axis."""
    kernel = "banded_matvec" if vec else "banded_matmul"
    nb, p = band.shape[-2:]
    lead = band.shape[:-2]
    q = 1 if vec else V.shape[-1]
    want = lead + ((p,) if vec else (p, q))
    if nb % 2 == 0 or V.shape != want:
        raise ValueError(f"{kernel}: band {tuple(band.shape)} (2h+1 "
                         f"diagonals) and operand {tuple(V.shape)} do not "
                         f"fit (want {tuple(want)})")
    if isinstance(band, FakeTensor):
        return _planned(kernel, {"band": band, "V": V}, {},
                        band.new_empty(want, dtype=torch.float32))
    if not band.is_cuda:
        PLAIN_CALLS[kernel] += 1
        return (ref.banded_matvec if vec else ref.banded_matmul)(band, V)
    B = math.prod(lead)
    if not 1 <= B <= _MAX_SLOTS or q < 1:
        raise ValueError(f"{kernel}: {B} leading entries and {q} columns "
                         f"do not fit the grid")
    dev = band.device
    bb, vv = _cuda_operand(band, dev), _cuda_operand(V, dev)
    Y = torch.empty(want, device=dev, dtype=torch.float32)
    lib = load_library("banded")
    h = (nb - 1) // 2
    if vec:
        slot = banded_matvec_plan(B, p, h, _sms(dev)).shape == "slot"
        ret = (lib.banded_matvec_slot_f32 if slot else lib.banded_matvec_f32)(
            bb.data_ptr(), vv.data_ptr(), B, p, h, Y.data_ptr(), _stream())
    else:
        ret = lib.banded_matmul_f32(bb.data_ptr(), vv.data_ptr(), B, p, h, q,
                                    Y.data_ptr(), _stream())
    _check(ret, kernel)
    LAUNCHES[kernel] += 1
    return Y


def banded_matmul(band: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``Y = C V`` for every leading index in ONE launch (kernel 10,
    ``csrc/banded.cu``): ``band`` (..., 2h+1, p) diagonals
    (``band[k, i] = C[i, i + k - h]``), ``V`` (..., p, q) with the same
    leading axes -> (..., p, q) fp32,
    ``Y[..., i, c] = sum_k band[..., k, i] V[..., i + k - h, c]`` with the
    diagonals summed in order."""
    return _banded(band, V, vec=False)


def banded_matvec(band: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``y = C v`` for every leading index in ONE launch (kernel 11,
    ``csrc/banded.cu``, in the shape :func:`banded_matvec_plan` gives):
    ``band`` (..., 2h+1, p), ``v`` (..., p) -> (..., p) fp32, the
    diagonals summed in order as :func:`banded_matmul` sums them."""
    return _banded(band, v, vec=True)
