#!/usr/bin/env python3
"""Drive the PyTorch port of the streaming-PCA serving path on one GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from src/repro_torch/kernels/csrc (one nvcc per
     source, in parallel, into build/repro_torch/), with each kernel
     function's registers and spills, and the spills of kernel 1's two
     device functions (its fold and stage blocks, not inlined);
  3. each kernel against its plain PyTorch version on the card, at the
     engine's widths (256 slots, p=1024, h=128, q=32, K*n=8*32 rows, masks
     per round; the per-round folds at n=32 rows, the banded products on
     the refresh's (256, 257, 1024) band), with its time (CUDA events,
     warmed up) beside its bound and, where one PyTorch call computes the
     same function, that call's time on the same inputs (torch.bmm, TF32
     off; for the banded products on the dense (p, p) matrix formed
     outside the timing; for the band folds (kernels 2, 3, 6, 7) the dense
     (S, p, p) product of the weighted or masked rows, formed outside the
     timing, its band checked against the kernel's; kernels 8 and 9 and
     their torch.bmm over 50 calls, on a row-major basis, the layout the
     engine's refresh gives them; kernel 10 over 50 calls, and again at
     the retirement's single slot over 500, beside torch.bmm on the dense
     (1, p, p) matrix, as banded_matmul_s1; kernels 6 and 7 over 50 calls
     beside their torch.bmm, kernel 7 with a (S, p) liveness row and, as
     band_round_masked_drop, with a (S, n, p) dropout mask); kernel 1 also
     in its bf16 tile mode, with the bf16 cast of x (outside the kernel, as
     in the reference) timed on its own; kernels 2, 3, 6 and 7's bands
     checked exactly symmetric and equal over two launches, kernel 1's band
     (fp32 and bf16 tiles) equal bit for bit to kernel 3's on the same
     operands, and kernel 6's and 7's equal bit for bit to kernel 2's and
     3's at K = 1, w = 1; kernel 1's other outputs (both tile modes) bit
     for bit against the kernels whose order of sums they keep: z kernel
     8's on the centred, masked rows, x_hat kernel 9's plus the mean, T2
     and SPE kernel 5's, the flags kernel 4's; and a second launch of
     kernel 1 equal bit for bit;
     plus a small engine run on the card against the same run on the CPU;
  4. the main path: StreamingPCAEngine with compression and detection on
     256 slots at one wsn-1m region's width, serving 320 requests of 24
     rounds (slots retire and readmit; the last 64 carry a liveness
     schedule); the fused kernel's launch count must equal the engine's
     step count with no plain call, and kernel 10's 1 + refresh_iters + 2
     a decision plus exactly one a retired request;
  5. the band-only engine (no stages) on the same requests' first 16
     rounds: the band-fold kernels, plain and masked;
  6. the split stage engine (fused=False) on the same requests: one
     band-fold, one supervised-compression and one monitoring launch per
     step;
  7. the quantized-score engine (score_bits=8): one band-fold, one
     projection, one reconstruction and one monitoring launch per step;
  8. the per-round fleet path: batched_stream_run(chunk=None) on 256
     networks x 24 rounds with compression and detection, the last 64
     networks carrying the death wave, the others all-ones masks: every
     round one masked per-round fold (liveness: no dropout launch), one
     supervised-compression and one monitoring launch and 1 +
     refresh_iters + 2 banded products; plus a small per-round fleet on
     the card against the same fleet on the CPU; a repeat under
     torch.profiler gives the device time of each of the port's kernels;
  9. the band-only per-round path without masks: one per-round fold and
     1 + refresh_iters + 2 banded products a round, profiled as phase 8;
 10. the engine of phase 4 in the bf16 tile mode (precision="bf16") on the
     same requests: one fused_stream_bf16 launch per step, no plain call,
     the worst sink error within eps + 2^-8 max|x| (the flag is decided on
     the bf16-rounded reading, the books read the fp32 one); its rate,
     step time, flagged readings and refreshes beside phase 4's;
 11. kernels 1 (fp32 and bf16 tiles), 2, 3, 6, 7 (both masks), 8, 9 and
     10 (at 256 slots and at one) and the folds' and products' torch.bmm
     again at phase 3's shapes, on inputs drawn anew (a dense
     product's time does not depend on the values), under torch.profiler:
     each one's device time a call over 50 calls, beside its event time,
     so the wrapper's host time cannot hide in the figure (last, so that no
     profiler run comes ahead of phase 4's measured run, and no tensor is
     kept for it through phases 4-10).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA card, or without the rest
of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
P, H, Q, K, N = 1024, 128, 32, 8, 32          # one wsn-1m region per slot
SLOTS, REQUESTS, ROUNDS = 256, 320, 24        # 256 of wsn-1m's 1024 regions
EPS = 1.0
PEAK_FP32 = 67e12                             # H100 SXM, CUDA cores, dense
PEAK_BYTES = 3.35e12                          # H100 SXM HBM3
_SPLIT = "src/repro_torch/kernels/csrc/pca_project.cu"
KERNELS = {
    "fused_stream": ("src/repro_torch/kernels/csrc/fused_stream.cu",
                     "src/repro/kernels/fused_stream.py:206"),
    "fused_stream_bf16": ("src/repro_torch/kernels/csrc/fused_stream.cu",
                          "src/repro/kernels/fused_stream.py:206"),
    "band_fold": ("src/repro_torch/kernels/csrc/band_fold.cu",
                  "src/repro/kernels/cov_update.py:171"),
    "band_fold_masked": ("src/repro_torch/kernels/csrc/band_fold.cu",
                         "src/repro/kernels/cov_update.py:228"),
    "supervised_compress": (_SPLIT, "src/repro/kernels/pca_project.py:216"),
    "pca_monitor": (_SPLIT, "src/repro/kernels/pca_project.py:171"),
    "pca_project": (_SPLIT, "src/repro/kernels/pca_project.py:61"),
    "pca_reconstruct": (_SPLIT, "src/repro/kernels/pca_project.py:89"),
    "band_round": ("src/repro_torch/kernels/csrc/band_fold.cu",
                   "src/repro/kernels/cov_update.py:53"),
    "band_round_masked": ("src/repro_torch/kernels/csrc/band_fold.cu",
                          "src/repro/kernels/cov_update.py:108"),
    # kernel 7 with a (S, n, p) dropout mask, counted apart from the
    # liveness row; the fleet drivers pass liveness masks only
    "band_round_masked_drop": ("src/repro_torch/kernels/csrc/band_fold.cu",
                               "src/repro/kernels/cov_update.py:108"),
    "banded_matmul": ("src/repro_torch/kernels/csrc/banded.cu",
                      "src/repro/kernels/banded_matvec.py:85"),
    # kernel 10 at the retirement's single slot (S = 1)
    "banded_matmul_s1": ("src/repro_torch/kernels/csrc/banded.cu",
                         "src/repro/kernels/banded_matvec.py:85"),
    "banded_matvec": ("src/repro_torch/kernels/csrc/banded.cu",
                      "src/repro/kernels/banded_matvec.py:52"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_mem = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def fold_flops(S, R, p, h):
    """2 flops per multiply-add over R rows for each UNIQUE pair
    (i, j), i <= j <= i + h, j < p: the band is symmetric
    (band[h-d, i] = band[h+d, i-d]), so its lower diagonals are copies."""
    h = min(h, p - 1)
    pairs = (h + 1) * p - h * (h + 1) // 2
    return 2.0 * S * R * pairs


def signal(rng, R, n, p, rank, *, noise=0.05, spike_rate=3e-4):
    """A spatially local field (``rank`` smooth bumps, so the covariance is
    banded), small noise and rare +-5 spikes that the stages flag."""
    j = np.arange(p)
    centres = np.linspace(0.1, 0.9, rank) * p
    U = np.exp(-0.5 * ((j[:, None] - centres[None, :]) / 1.2) ** 2)
    U /= np.linalg.norm(U, axis=0)
    scale = np.linspace(0.9, 0.4, rank)
    g = rng.standard_normal((R, n, rank)).astype(np.float32) * scale
    x = g @ U.T.astype(np.float32) + rng.standard_normal(p).astype(np.float32)
    x += noise * rng.standard_normal(x.shape, dtype=np.float32)
    spikes = rng.random(x.shape, dtype=np.float32) < spike_rate
    x += spikes * np.where(rng.random(x.shape, dtype=np.float32) < 0.5,
                           -5.0, 5.0).astype(np.float32)
    return x.astype(np.float32)


def compare(name, out, plain, rtol, atol):
    err = (out - plain).abs()
    ok = bool((err <= atol + rtol * plain.abs()).all())
    print(f"   {name}: max_abs_err {err.max().item():.3e} "
          f"(tol {atol:g} + {rtol:g}|plain|) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} disagrees with its plain version")
    return err.max().item()


def _dev_time(e) -> float:
    """Device self time (us) of a torch.profiler key_averages() row."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(fn, iters: int) -> tuple[float, str]:
    """The device time of one call of ``fn`` (ms), from torch.profiler
    over ``iters`` calls after one warm-up call: the device events' time
    over the calls the profiler caught (the most events of one name; it
    may miss the first few), so the host time of a wrapper cannot hide in
    it; and the names and counts of those events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and _dev_time(e) > 0]
    names = "; ".join(f"{e.key[:48]} x{e.count}" for e in rows)
    caught = max((e.count for e in rows), default=iters)
    return sum(_dev_time(e) for e in rows) / 1e3 / caught, names


def profile_breakdown(run, top: int = 8) -> None:
    """Where an engine run's device time goes: the kernels and copies with
    the most device time, every kernel of the port's below them, and the
    device's busy share of the run's wall time (the run is a repeat of the
    measured one, under torch.profiler).  Only device events count: an
    operator's row carries the time of the kernels it launched, which have
    rows of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU and _dev_time(e) > 0),
                  key=_dev_time, reverse=True)
    busy = sum(_dev_time(e) for e in rows) / 1e6
    print(f"   profile: device busy {busy:.3f} s of {wall:.3f} s wall "
          f"({100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%)")
    ours = [e for e in rows[top:] if "repro_torch::" in e.key]
    for e in rows[:top] + ours:
        print(f"     {_dev_time(e) / 1e3:10.1f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


def ptxas_summary(log: str) -> list[str]:
    """One line a kernel function of an ``nvcc -Xptxas -v`` log: its
    (mangled) name, registers and spills; and one line a device function
    that is not inlined (kernel 1's two kinds of block): its stack frame
    and spills."""
    out, name, spill, callee = [], "?", "", None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        f = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill, callee = m[1], "", None
        elif f:
            callee = None if f[1] == name else f[1]
        elif "spill" in line:
            if callee is not None:
                out.append(f"{callee} (device function): {line.strip()}")
            else:
                spill = line.strip()
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs[1] if regs else '?'} registers; "
                       f"{spill}")
    return out


def mirrored(band: torch.Tensor, h: int) -> bool:
    """The band is exactly symmetric: band[h - d, i + d] == band[h + d, i]
    for every d in 1..h and i + d < p."""
    p = band.shape[-1]
    return all(torch.equal(band[:, h - d, d:], band[:, h + d, :p - d])
               for d in range(1, min(h, p - 1) + 1))


def band_of(dense: torch.Tensor, h: int) -> torch.Tensor:
    """The (S, 2h+1, p) band ``band[k, i] = dense[i, i + k - h]`` of a
    (S, p, p) matrix, zero where i + k - h falls outside [0, p)."""
    S, p, _ = dense.shape
    band = dense.new_zeros((S, 2 * h + 1, p))
    for k in range(2 * h + 1):
        d = torch.diagonal(dense, offset=k - h, dim1=1, dim2=2)
        lo = max(0, h - k)
        band[:, k, lo:lo + d.shape[-1]] = d
    return band


def dense_fold(rec: dict, name: str, out, xw, xm, h: int,
               iters: int = 10) -> None:
    """A band fold's library call: one torch.bmm forming the dense
    (S, p, p) product ``sum_r xw[r]^T xm[r]`` of the weighted or masked
    rows (formed outside the timing); its band, extracted outside the
    timing, is held against the kernel's ``out`` at the fold's tolerance,
    and the bmm's time over ``iters`` calls is ``rec["library_ms"]``."""
    lib = lambda: torch.bmm(xw.transpose(1, 2), xm)
    compare(f"{name} vs the band of torch.bmm's dense product", out,
            band_of(lib(), h), 1e-4, 1e-3)
    rec["library_ms"] = time_ms(lib, iters)
    S, R, p = xw.shape
    print(f"   {name}: torch.bmm forming the dense ({S}, {p}, {p}) product "
          f"of {R} rows a slot {rec['library_ms']:.3f} ms")


def fused_bf16(record, x, w, basis, mean, il, masks, eps) -> None:
    """Kernel 1 in its bf16 tile mode against its plain version at the
    slice shape: x and W rounded to bf16 by the wrapper's rule (the cast of
    x timed on its own, beside its bound), the kernel and the plain version
    both fed the rounded tensors."""
    from repro_torch.kernels import ops, ref
    S, Kc, Nc, p = x.shape
    R, q = Kc * Nc, basis.shape[-1]
    cast = lambda: ops.fused_tiles(x, "bf16")
    xb, bb = cast(), ops.fused_tiles(basis, "bf16")
    run = lambda: ops.fused_stream_update(
        xb, w, bb, mean, il, halfwidth=H, epsilon=eps, with_compress=True,
        with_monitor=True, mask=masks, precision="bf16")
    plain_fn = lambda: ref.fused_stream(xb, w, bb, mean, il, H, eps, masks)
    out = run()
    torch.cuda.synchronize()
    plain = plain_fn()
    errs = [compare(f"fused_bf16 {name}", out[i], plain[i], 1e-4, 1e-3)
            for i, name in ((0, "band"), (1, "z"), (2, "x_hat"), (4, "t2"),
                            (5, "spe"))]
    fused_yardsticks("fused_bf16", out, xb.float(), w, bb.float(), mean, il,
                     masks, eps)
    xv = xb.float().reshape(S, R, p)
    clear = ((xv - plain[2]).abs() - eps).abs() > 1e-3
    bad = int(((out[3] != plain[3]) & clear).sum())
    print(f"   fused_bf16 flags: {int(out[3].sum())} set, {bad} disagree "
          f"away from eps (want 0)")
    check(bad == 0, "fused_bf16 flags disagree")
    del out, plain, xv, clear
    ms = time_ms(run, 10)
    plain_ms = time_ms(plain_fn, 2, 1)
    cast_ms = time_ms(cast, 10)
    flops = fold_flops(S, R, p, H) + 2.0 * 2 * S * R * p * q
    nbytes = (2.0 * (xb.numel() + bb.numel())                 # bf16 tiles
              + 4.0 * (w.numel() + masks.numel() + mean.numel() + il.numel()
                       + S * (2 * H + 1) * p + S * R * q      # band, z
                       + S * R * p + 2 * S * R)               # x_hat, T2, SPE
              + 1.0 * S * R * p)                              # bool flags
    b_ms, b_by = bound(flops, nbytes)
    cast_bound, _ = bound(0.0, 6.0 * x.numel())     # fp32 read, bf16 written
    print(f"   fused_bf16 S={S} R={R} p={p} h={H} q={q}: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e9:.3f} GB); bf16 cast of x "
          f"{cast_ms:.3f} ms, bound {cast_bound:.4f} ms (bytes; "
          f"{6.0 * x.numel() / 1e9:.3f} GB)")
    record["fused_stream_bf16"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, cast_ms=cast_ms,
        cast_bound_ms=cast_bound)
    del xb, bb


def fused_yardsticks(label, out, x, w, basis, mean, il, masks, eps) -> None:
    """Kernel 1's outputs ``out`` (all stages) bit for bit against the
    kernels whose order of sums each keeps, on the same (widened) operands:
    the band kernel 3's, z kernel 8's on the centred, masked rows formed in
    torch, x_hat kernel 9's on that z plus the mean, and T2, SPE and the
    flags kernels 5's and 4's (the stage arithmetic kernel 1 had before its
    stage tile)."""
    from repro_torch.kernels import ops
    S, Kc, Nc, p = x.shape
    R = Kc * Nc
    wr = basis.contiguous()
    xv = x.reshape(S, R, p)
    xc = ((xv - mean[:, None, :]) * masks.repeat_interleave(Nc, dim=1))
    z8 = ops.pca_project(xc, wr)
    del xc
    xh9 = ops.pca_reconstruct(z8, wr) + mean[:, None, :]
    _, _, fl4 = ops.supervised_compress(xv, wr, mean, epsilon=eps,
                                        mask=masks, n=Nc)
    _, t25, spe5 = ops.pca_monitor(xv, wr, mean, il, mask=masks, n=Nc)
    same = {
        "band == band_fold_masked's (kernel 3)": torch.equal(
            out[0], ops.cov_band_update_chunk_batched(x, w, H, mask=masks)),
        "z == pca_project's (kernel 8) on (x - mean) m": torch.equal(
            out[1], z8),
        "x_hat == pca_reconstruct's (kernel 9) + mean": torch.equal(
            out[2], xh9),
        "flags == supervised_compress's (kernel 4)": torch.equal(out[3], fl4),
        "t2 == pca_monitor's (kernel 5)": torch.equal(out[4], t25),
        "spe == pca_monitor's (kernel 5)": torch.equal(out[5], spe5),
    }
    for what, ok in same.items():
        print(f"   {label} {what} (bit for bit): {ok}")
        check(ok, f"{label}: {what} does not hold")
    del z8, xh9, fl4, t25, spe5


def products_8_9(xc, z8, wr) -> dict:
    """Kernels 8 and 9 on ``xc`` (S, R, p), ``z8`` (S, R, q) and the
    row-major basis ``wr`` (S, p, q): ``{name: (kernel call, plain call,
    torch.bmm call)}``."""
    from repro_torch.kernels import ops, ref
    wt = wr.transpose(1, 2)
    return {
        "pca_project": (lambda: (ops.pca_project(xc, wr),),
                        lambda: (ref.pca_project(xc, wr),),
                        lambda: torch.bmm(xc, wr)),
        "pca_reconstruct": (lambda: (ops.pca_reconstruct(z8, wr),),
                            lambda: (ref.pca_reconstruct(z8, wr),),
                            lambda: torch.bmm(z8, wt)),
    }


def split_kernels(record, xv, masks, basis, mean, il, eps) -> None:
    """Kernels 4, 5, 8 and 9 against their plain versions at the slice
    shape, per-round masks read at row r // N; times beside bounds, and
    torch.bmm (TF32 off) beside the projection and reconstruction.  Those
    two and their torch.bmm are timed over 50 calls (some 5 ms: a 0.1 ms
    kernel's time is not the event timer's or the launch gaps'), on the
    basis made row-major, as the engine's refresh leaves it."""
    from repro_torch.kernels import ops, ref
    S, R, p = xv.shape
    q = basis.shape[-1]
    rows_mask = masks.repeat_interleave(N, dim=1)
    xc = (xv - mean[:, None, :]) * rows_mask
    f32 = 4.0
    x_b, w_b, m_b = S * R * p * f32, S * p * q * f32, masks.numel() * f32
    z_b, stat_b = S * R * q * f32, 2 * S * R * f32
    prod = 2.0 * S * R * p * q
    cases = {
        "supervised_compress": (
            lambda: ops.supervised_compress(xv, basis, mean, epsilon=eps,
                                            mask=masks, n=N),
            lambda: ref.supervised_compress(xv, basis, mean, rows_mask, eps),
            2 * prod, x_b + m_b + w_b + S * p * f32 + z_b + x_b + S * R * p,
            None),
        "pca_monitor": (
            lambda: ops.pca_monitor(xv, basis, mean, il, mask=masks, n=N),
            lambda: ref.pca_monitor(xv, basis, mean, il, rows_mask),
            2 * prod, x_b + m_b + w_b + S * (p + q) * f32 + z_b + stat_b,
            None),
    }
    wr = basis.contiguous()
    z8 = ref.pca_project(xc, wr)
    for name, (run, plain_fn, lib) in products_8_9(xc, z8, wr).items():
        cases[name] = (run, plain_fn, prod, x_b + w_b + z_b, lib)
    for name, (run, plain_fn, flops, nbytes, lib) in cases.items():
        out = run()
        torch.cuda.synchronize()
        plain = plain_fn()
        errs = []
        for i, (a, b) in enumerate(zip(out, plain)):
            if a.dtype == torch.bool:
                xh = plain[1]
                clear = ((xv - xh).abs() - eps).abs() > 1e-3
                bad = int(((a != b) & clear).sum())
                print(f"   {name} flags: {int(a.sum())} set, {bad} disagree "
                      f"away from eps (want 0)")
                check(bad == 0, f"{name} flags disagree")
                continue
            errs.append(compare(f"{name}[{i}]", a, b, 1e-4, 1e-3))
        del out, plain
        iters = 10 if lib is None else 50
        ms = time_ms(run, iters)
        plain_ms = time_ms(plain_fn, 3, 1)
        b_ms, b_by = bound(flops, nbytes)
        rec = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        lib_txt = ""
        if lib is not None:
            rec["library_ms"] = time_ms(lib, iters)
            lib_txt = (f", torch.bmm {rec['library_ms']:.4f} ms ({iters} "
                       f"calls each)")
        print(f"   {name} S={S} R={R} p={p} q={q}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms{lib_txt}, bound {b_ms:.4f} ms "
              f"({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e9:.3f} GB)")
        record[name] = rec
    del xc, rows_mask, z8, wr


def band_entries(p, h):
    """In-range entries of a (2h+1, p) band: (2h+1)p - h(h+1)."""
    h = min(h, p - 1)
    return (2 * h + 1) * p - h * (h + 1)


def round_operands(dev, g):
    """One round of n=32 rows a slot, a (S, p) liveness row and a
    (S, n, p) dropout mask: ``{record name: (x, mask)}`` for kernels 6, 7
    and 7 with dropout."""
    x = torch.randn((SLOTS, N, P), device=dev, generator=g)
    live = (torch.rand((SLOTS, P), device=dev, generator=g) > 0.05).float()
    drop = (torch.rand((SLOTS, N, P), device=dev, generator=g)
            > 0.05).float()
    return {"band_round": (x, None), "band_round_masked": (x, live),
            "band_round_masked_drop": (x, drop)}


def round_rows(x, m):
    """The rows of a round as its fold multiplies them: ``x`` masked by a
    (S, p) liveness row or a (S, n, p) dropout mask."""
    return x if m is None else x * (m[:, None, :] if m.dim() == 2 else m)


def round_and_banded_kernels(record, dev, g) -> None:
    """Kernels 6, 7 (the per-round folds: one round of n=32 rows per
    slot, a (S, p) liveness row or a (S, n, p) dropout mask) and 10, 11
    (the banded products on the refresh's band) against their plain
    versions; times beside bounds, and torch.bmm on the dense (p, p)
    matrix beside the banded products.  The round folds' bands must be
    exactly symmetric, equal over two launches and equal bit for bit to
    kernel 2's or 3's at K = 1, w = 1; they and their torch.bmm are timed
    over 50 calls (a ~0.2 ms kernel)."""
    from repro_torch.core.covariance import band_to_dense, band_valid
    from repro_torch.kernels import ops, ref
    from repro_torch.streaming.driver import random_bases
    S = SLOTS
    f32 = 4.0
    band_b = S * (2 * H + 1) * P * f32
    ones = torch.ones((S, 1), device=dev)
    for name, (x, m) in round_operands(dev, g).items():
        run = lambda: ops.cov_band_update_batched(x, H, mask=m)
        plain_fn = lambda: ref.cov_band_update(x, H, m)
        out = run()
        torch.cuda.synchronize()
        kind = ("" if m is None else " liveness (S, p)" if m.dim() == 2
                else " dropout (S, n, p)")
        err = compare(f"{name}{kind}", out, plain_fn(), 1e-4, 1e-3)
        sym, again = mirrored(out, H), torch.equal(out, run())
        chunk = ops.cov_band_update_chunk_batched(
            x[:, None], ones, H, mask=None if m is None else m[:, None])
        same = torch.equal(out, chunk)
        print(f"   {name}{kind}: band exactly symmetric {sym}; a second "
              f"launch gives equal bits {again}; == the chunk fold's band "
              f"at K = 1, w = 1 (bit for bit) {same}")
        check(sym and again and same, f"{name}{kind}: band not mirrored, "
              f"not repeatable or not the chunk fold's at K = 1")
        del chunk
        ms = time_ms(run, 50)
        plain_ms = time_ms(plain_fn, 3, 1)
        nbytes = x.numel() * f32 + band_b + (0 if m is None
                                             else m.numel() * f32)
        b_ms, b_by = bound(fold_flops(S, N, P, H), nbytes)
        print(f"   {name}{kind} S={S} n={N} p={P} h={H}: kernel {ms:.4f} "
              f"ms (50 calls), plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by}; {nbytes / 1e9:.3f} GB)")
        record[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by)
        xm = round_rows(x, m)
        dense_fold(record[name], f"{name}{kind}", out, xm, xm, H, iters=50)
        del xm, out
    del x, m
    band = torch.randn((S, 2 * H + 1, P), device=dev, generator=g) \
        * band_valid(P, H, device=dev)
    # row-major, as the refresh passes it (QR's column-major basis would
    # be copied contiguous by the wrapper inside the timing)
    V = random_bases(S, P, Q, seed=2, device=dev).contiguous()
    dense = band_to_dense(band)
    torch.cuda.synchronize()
    dense_ms = time_ms(lambda: band_to_dense(band), 3, 1)
    print(f"   band_to_dense (S={S}, p={P}): {dense_ms:.3f} ms, "
          f"{dense.numel() * f32 / 1e9:.2f} GB")
    entries = band_entries(P, H)
    for name, operand, width in (("banded_matmul", V, Q),
                                 ("banded_matvec", V[..., 0].contiguous(),
                                  1)):
        vec = width == 1
        run = (lambda: ops.banded_matvec(band, operand)) if vec \
            else (lambda: ops.banded_matmul(band, operand))
        plain_fn = (lambda: ref.banded_matvec(band, operand)) if vec \
            else (lambda: ref.banded_matmul(band, operand))
        lib = (lambda: torch.bmm(dense, operand[..., None])) if vec \
            else (lambda: torch.bmm(dense, operand))
        out = run()
        torch.cuda.synchronize()
        plain = plain_fn()
        err = compare(name, out, plain, 1e-5, 1e-5)
        same = bool(torch.equal(out, plain))
        print(f"   {name}: equal bits to the plain version: {same}")
        compare(f"{name} vs torch.bmm on the dense matrix", out,
                lib().reshape(out.shape), 1e-4, 1e-4)
        iters = 10 if vec else 50
        ms = time_ms(run, iters)
        plain_ms = time_ms(plain_fn, 3, 1)
        lib_ms = time_ms(lib, iters)
        flops = 2.0 * S * width * entries
        nbytes = S * entries * f32 + 2 * S * P * width * f32
        b_ms, b_by = bound(flops, nbytes)
        print(f"   {name} S={S} p={P} h={H} q={width}: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, torch.bmm on dense {lib_ms:.3f} ms "
              f"(+ band_to_dense {dense_ms:.3f} ms), bound {b_ms:.4f} ms "
              f"({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e9:.3f} GB)")
        record[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del out, plain
    record["banded_matmul_s1"] = banded_one_slot(band[:1].contiguous(),
                                                 V[:1].contiguous(),
                                                 dense[:1])
    del band, V, dense
    torch.cuda.empty_cache()


def banded_one_slot(band, V, dense) -> dict:
    """Kernel 10 at the retirement's shape (one slot): equal bits to its
    plain version, its time over 500 calls beside torch.bmm on the dense
    (1, p, p) matrix and its bound.  At this size the wrapper's host time
    may exceed the device's; phase 11 gives the device time."""
    from repro_torch.kernels import ops, ref
    run = lambda: ops.banded_matmul(band, V)
    plain_fn = lambda: ref.banded_matmul(band, V)
    lib = lambda: torch.bmm(dense, V)
    out = run()
    torch.cuda.synchronize()
    plain = plain_fn()
    err = compare("banded_matmul S=1", out, plain, 1e-5, 1e-5)
    check(bool(torch.equal(out, plain)),
          "banded_matmul S=1: bits differ from the plain version")
    compare("banded_matmul S=1 vs torch.bmm on the dense matrix", out,
            lib(), 1e-4, 1e-4)
    ms, plain_ms, lib_ms = (time_ms(run, 500), time_ms(plain_fn, 10, 2),
                            time_ms(lib, 500))
    entries = band_entries(P, H)
    flops = 2.0 * Q * entries
    nbytes = 4.0 * (entries + 2 * P * Q)
    b_ms, b_by = bound(flops, nbytes)
    print(f"   banded_matmul S=1 p={P} h={H} q={Q}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, torch.bmm on dense {lib_ms:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}; {flops / 1e6:.2f} MFLOP, "
          f"{nbytes / 1e6:.3f} MB); equal bits to the plain version")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.covariance import band_to_dense, band_valid
    from repro_torch.kernels import build, ops, ref
    from repro_torch.serve.engine import StreamingPCAEngine, StreamRequest
    from repro_torch.streaming import (CompressionConfig, DetectionConfig,
                                       StreamConfig, batched_stream_init,
                                       batched_stream_run)
    from repro_torch.streaming.driver import random_bases

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}")

    phase("2 build")
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"   built {sorted(logs)} in {time.perf_counter() - t0:.1f} s "
          f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for name, info in logs.items():
        for line in ptxas_summary(info["log"]):
            print(f"   {name}: {line}")

    phase("3 kernels vs plain at slice width")
    record: dict[str, dict] = {}
    g = torch.Generator(device=dev).manual_seed(0)
    S, R = SLOTS, K * N
    x = torch.randn((S, K, N, P), device=dev, generator=g)
    w = torch.rand((S, K), device=dev, generator=g) * 0.5 + 0.5
    masks = (torch.rand((S, K, P), device=dev, generator=g) > 0.05).float()
    basis = random_bases(S, P, Q, seed=1, device=dev)
    mean = 0.1 * torch.randn((S, P), device=dev, generator=g)
    il = torch.rand((S, Q), device=dev, generator=g) + 0.5
    eps = 2.5                          # some of these N(0,1) readings flag
    for stages in ("cm", "c", "m"):
        wc, wm = "c" in stages, "m" in stages
        run = lambda: ops.fused_stream_update(
            x, w, basis, mean, il, halfwidth=H, epsilon=eps,
            with_compress=wc, with_monitor=wm, mask=masks)
        out = run()
        torch.cuda.synchronize()
        plain = ref.fused_stream(x, w, basis, mean, il, H, eps, masks)
        errs = [compare(f"fused[{stages}] band", out[0], plain[0], 1e-4,
                        1e-3),
                compare(f"fused[{stages}] z", out[1], plain[1], 1e-4, 1e-3)]
        if wc:
            errs.append(compare(f"fused[{stages}] x_hat", out[2], plain[2],
                                1e-4, 1e-3))
            xv = x.reshape(S, R, P)
            clear = ((xv - plain[2]).abs() - eps).abs() > 1e-3
            bad = int(((out[3] != plain[3]) & clear).sum())
            print(f"   fused[{stages}] flags: {int(out[3].sum())} set, "
                  f"{bad} disagree away from eps (want 0)")
            check(bad == 0, "fused flags disagree")
        if wm:
            errs.append(compare(f"fused[{stages}] t2", out[4], plain[4],
                                1e-4, 1e-3))
            errs.append(compare(f"fused[{stages}] spe", out[5], plain[5],
                                1e-4, 1e-3))
        ms = time_ms(run, 10)
        plain_ms = time_ms(lambda: ref.fused_stream(x, w, basis, mean, il,
                                                    H, eps, masks), 2, 1)
        flops = fold_flops(S, R, P, H) + 2.0 * 2 * S * R * P * Q
        nbytes = (4.0 * (x.numel() + w.numel() + masks.numel()
                         + basis.numel() + mean.numel() + il.numel()
                         + out[0].numel() + out[1].numel()
                         + (S * R * P if wc else 0)          # x_hat
                         + (2 * S * R if wm else 0))         # T2, SPE
                  + (1.0 * S * R * P if wc else 0))          # bool flags
        b_ms, b_by = bound(flops, nbytes)
        print(f"   fused[{stages}] S={S} R={R} p={P} h={H} q={Q}: kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e9:.3f} GB)")
        if stages == "cm":
            fused_yardsticks("fused[cm]", out, x, w, basis, mean, il, masks,
                             eps)
            again = run()
            same = all(torch.equal(a, b) for a, b in zip(out, again))
            print(f"   fused[cm]: a second launch gives equal bits {same}")
            check(same, "kernel 1 is not repeatable")
            del again
            record["fused_stream"] = dict(max_abs_err=max(errs), ms=ms,
                                          plain_ms=plain_ms, bound_ms=b_ms,
                                          bound_by=b_by)
        del out, plain
    fused_bf16(record, x, w, basis, mean, il, masks, eps)
    for p, Kb, Nb in ((P, K, N), (1021, 10, 25)):
        xb = torch.randn((S, Kb, Nb, p), device=dev, generator=g)
        wb = torch.rand((S, Kb), device=dev, generator=g)
        mb = (torch.rand((S, Kb, p), device=dev, generator=g) > 0.05).float()
        for name, m in (("band_fold", None), ("band_fold_masked", mb)):
            run = lambda: ops.cov_band_update_chunk_batched(xb, wb, H,
                                                            mask=m)
            out = run()
            torch.cuda.synchronize()
            plain = ref.band_fold(xb, wb, H, m)
            err = compare(f"{name} p={p} rows={Kb * Nb}", out, plain, 1e-4,
                          1e-3)
            sym, again = mirrored(out, H), torch.equal(out, run())
            print(f"   {name} p={p}: band exactly symmetric {sym}; a second "
                  f"launch gives equal bits {again}")
            check(sym and again, f"{name} p={p}: band not mirrored or not "
                  f"repeatable")
            ms = time_ms(run, 10)
            plain_ms = time_ms(lambda: ref.band_fold(xb, wb, H, m), 2, 1)
            nbytes = 4.0 * (xb.numel() + wb.numel() + out.numel()
                            + (0 if m is None else m.numel()))
            b_ms, b_by = bound(fold_flops(S, Kb * Nb, p, H), nbytes)
            print(f"   {name} S={S} rows={Kb * Nb} p={p}: kernel {ms:.3f} "
                  f"ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
                  f"({b_by})")
            if p == P:
                record[name] = dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by)
                xm = xb if m is None else xb * m[:, :, None, :]
                xw = (xm * wb[:, :, None, None]).reshape(S, Kb * Nb, p)
                dense_fold(record[name], name, out, xw,
                           xm.reshape(S, Kb * Nb, p), H)
                del xm, xw
        del xb, out, plain
    split_kernels(record, x.reshape(S, R, P), masks, basis, mean, il, eps)
    del x, masks, basis
    torch.cuda.empty_cache()
    round_and_banded_kernels(record, dev, g)

    # a small engine on the card against the same engine on the CPU
    small = StreamConfig(p=64, q=4, halfwidth=3, forgetting=0.98,
                         warmup_rounds=3, drift_threshold=0.05,
                         compression=CompressionConfig(epsilon=EPS),
                         detection=DetectionConfig(alpha=1e-3,
                                                   calib_rounds=2))
    rng = np.random.default_rng(7)
    sreqs = [signal(rng, r, 8, 64, 3) for r in (10, 13, 16, 9, 12, 14)]
    live = np.ones((16, 64), np.float32)
    live[6:, 20:28] = 0.0
    bases = random_bases(4, 64, 4, seed=3, device="cpu")
    results = {}
    for where in ("cuda", "cpu"):
        eng = StreamingPCAEngine(small, slots=4, chunk=4, device=where,
                                 init_bases=bases)
        reqs = [StreamRequest(rounds=a, liveness=live if i == 2 else None)
                for i, a in enumerate(sreqs)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        results[where] = [r.result for r in reqs]
    for a, b in zip(results["cuda"], results["cpu"]):
        check(a.rounds == b.rounds and a.refreshes == b.refreshes
              and a.compression_extra_packets == b.compression_extra_packets
              and a.detection_events == b.detection_events,
              f"small engine counts differ card vs CPU: {a} {b}")
        check(abs(a.comm_packets - b.comm_packets) <= 1e-5 * b.comm_packets
              and abs(a.retained - b.retained) <= 1e-3 * abs(b.retained),
              f"small engine books differ card vs CPU: {a} {b}")
    print(f"   small engine (6 requests, 4 slots, p=64): card == CPU on "
          f"rounds, refreshes, flags, alarms; comm_packets rtol 1e-5, "
          f"retained rtol 1e-3")

    phase("4 engine: compression + detection")
    cfg = StreamConfig(p=P, q=Q, halfwidth=H, forgetting=0.99,
                       warmup_rounds=K - 1, drift_threshold=0.05,
                       compression=CompressionConfig(
                           epsilon=EPS, emit_reconstruction=True),
                       detection=DetectionConfig(alpha=1e-3,
                                                 calib_rounds=2))
    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    data = [signal(rng, ROUNDS, N, P, 16) for _ in range(REQUESTS)]
    sched = np.ones((ROUNDS, P), np.float32)
    sched[ROUNDS // 2:, 100:140] = 0.0           # a death wave mid-stream
    print(f"   made {REQUESTS} requests of {ROUNDS} rounds x {N} epochs x "
          f"{P} sensors in {time.perf_counter() - t0:.1f} s")

    rates = {}                      # label -> (rounds/s, step ms)

    def serve(config, rounds, label):
        eng = StreamingPCAEngine(config, slots=SLOTS, chunk=K, seed=0,
                                 device="cuda", telemetry=True)
        reqs = [StreamRequest(rounds=d[:rounds],
                              liveness=(sched[:rounds] if i >= SLOTS
                                        else None))
                for i, d in enumerate(data)]
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        t = time.perf_counter()
        eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        steps = sum(1 for s in eng.telemetry.steps if s.live > 0)
        folded = sum(s.rounds for s in eng.telemetry.steps)
        res = [r.result for r in reqs]
        rates[label] = (folded / wall, 1e3 * wall / steps)
        print(f"   {label}: {steps} steps, {folded} rounds in {wall:.2f} s "
              f"= {folded / wall:.1f} rounds/s ({folded * N / wall:.0f} "
              f"epochs/s), step {1e3 * wall / steps:.1f} ms; refreshes "
              f"{sum(r.refreshes for r in res)}; "
              f"launches {launches}; plain calls {plain}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        check(all(r.done for r in reqs), f"{label}: not every request done")
        check(all(r.rounds == rounds for r in res),
              f"{label}: rounds streamed")
        check(sum(plain.values()) == 0, f"{label}: plain path was taken")
        for r in res:
            check(r.components.shape == (P, Q)
                  and np.isfinite(r.components).all()
                  and np.isfinite([r.retained, r.comm_packets]).all()
                  and r.refreshes >= 1 and r.retained > 0.0,
                  f"{label}: bad result {r.retained} {r.refreshes}")
        return steps, launches, res

    steps, launches, res = serve(cfg, ROUNDS, "stages engine")
    check(launches["fused_stream"] == steps,
          f"fused launches {launches['fused_stream']} != steps {steps}")
    # 1 + refresh_iters + 2 banded products a decision (one a step, all
    # slots at once), and one a retirement (a single slot)
    per_decision = cfg.refresh_iters + 3
    retired = launches["banded_matmul"] - per_decision * steps
    print(f"   banded products: {launches['banded_matmul']} = "
          f"{per_decision} x {steps} decisions + {retired} for "
          f"{len(res)} retirements")
    check(retired == len(res) == REQUESTS,
          f"{launches['banded_matmul']} banded products, want "
          f"{per_decision} x {steps} + {REQUESTS}")
    record["banded_matmul_s1"]["launches"] = retired
    worst = max(r.compression_max_err for r in res)
    flagged = sum(r.compression_extra_packets for r in res)
    alarms = sum(r.detection_events for r in res)
    print(f"   worst sink error {worst:.4f} <= eps {EPS} over "
          f"{flagged:.0f} flagged readings; {alarms:.0f} alarmed epochs")
    check(worst <= EPS, "the eps guarantee was broken")
    check(flagged > 0, "no reading flagged")
    record["fused_stream"]["launches"] = launches["fused_stream"]
    fp32_books = (flagged, sum(r.refreshes for r in res), alarms)
    profile_breakdown(lambda: serve(cfg, ROUNDS, "profiled stages engine"))

    phase("5 engine: band only")
    band_cfg = StreamConfig(p=P, q=Q, halfwidth=H, forgetting=0.99,
                            warmup_rounds=K - 1, drift_threshold=0.05)
    steps, launches, _ = serve(band_cfg, 16, "band-only engine")
    check(launches["band_fold"] >= 1 and launches["band_fold_masked"] >= 1
          and launches["band_fold"] + launches["band_fold_masked"] == steps
          and launches["fused_stream"] == 0,
          f"band-only launches {launches} vs {steps} steps")
    for name in ("band_fold", "band_fold_masked"):
        record[name]["launches"] = launches[name]

    def sink_books(res, label):
        worst = max(r.compression_max_err for r in res)
        flagged = sum(r.compression_extra_packets for r in res)
        bits = sum(r.compression_bits_on_air for r in res)
        alarms = sum(r.detection_events for r in res)
        print(f"   {label}: worst sink error {worst:.4f} <= eps {EPS}; "
              f"{flagged:.0f} flagged readings, {bits:.6g} bits on air, "
              f"{alarms:.0f} alarmed epochs")
        check(worst <= EPS, f"{label}: the eps guarantee was broken")
        return flagged, bits

    def stage_launches(launches, steps, kernels, label):
        folds = launches["band_fold"] + launches["band_fold_masked"]
        check(folds == steps and launches["fused_stream"] == 0
              and all(launches[k] == steps for k in kernels),
              f"{label}: launches {launches} vs {steps} steps")

    phase("6 engine: split stages")
    split_cfg = dataclasses.replace(cfg, fused=False)
    steps, launches, res = serve(split_cfg, ROUNDS, "split stages engine")
    stage_launches(launches, steps, ("supervised_compress", "pca_monitor"),
                   "split")
    check(launches["pca_project"] == launches["pca_reconstruct"] == 0,
          "split engine launched the quantized-score kernels")
    split_books = sink_books(res, "split")
    for name in ("supervised_compress", "pca_monitor"):
        record[name]["launches"] = launches[name]

    phase("7 engine: quantized scores")
    quant_cfg = dataclasses.replace(cfg, compression=CompressionConfig(
        epsilon=EPS, score_bits=8, emit_reconstruction=True))
    steps, launches, res = serve(quant_cfg, ROUNDS,
                                 "quantized-score engine")
    stage_launches(launches, steps,
                   ("pca_project", "pca_reconstruct", "pca_monitor"), "quant")
    check(launches["supervised_compress"] == 0,
          "quantized engine launched the supervised-compression kernel")
    flagged, bits = sink_books(res, "quantized (score_bits=8)")
    print(f"   flagged readings {flagged:.0f} (unquantized split "
          f"{split_books[0]:.0f}); bits on air {bits:.6g} (unquantized "
          f"split {split_books[1]:.6g})")
    for name in ("pca_project", "pca_reconstruct"):
        record[name]["launches"] = launches[name]
    del res

    phase("8 per-round fleet: compression + detection")
    # a small per-round fleet on the card against the same fleet on the CPU
    rng = np.random.default_rng(8)
    sx = torch.from_numpy(np.stack([signal(rng, 12, 8, 64, 3)
                                    for _ in range(4)]))
    smask = torch.ones((4, 12, 64))
    smask[3, 6:, 20:28] = 0.0
    sbases = random_bases(4, 64, 4, seed=4, device="cpu")
    small_runs = {}
    for where in ("cuda", "cpu"):
        st = batched_stream_init(small, 4, W0=sbases, device=where)
        small_runs[where] = batched_stream_run(small, st, sx.to(where),
                                               smask.to(where))[1]
    mg, mc = small_runs["cuda"], small_runs["cpu"]
    check(torch.equal(mg.did_refresh.cpu(), mc.did_refresh)
          and torch.equal(mg.compression.extra_packets.cpu(),
                          mc.compression.extra_packets)
          and torch.equal(mg.detection.alarms.cpu(), mc.detection.alarms),
          "small per-round fleet: decisions or counts differ card vs CPU")
    check(bool(torch.allclose(mg.comm_packets.cpu(), mc.comm_packets,
                              rtol=1e-5, atol=0))
          and bool(torch.allclose(mg.rho.cpu(), mc.rho, rtol=1e-3,
                                  atol=1e-6)),
          "small per-round fleet: books or retained fraction differ")
    print(f"   small per-round fleet (4 networks x 12 rounds, p=64): card "
          f"== CPU on decisions, flags, alarms; comm_packets rtol 1e-5, "
          f"rho rtol 1e-3; {int(mg.did_refresh.sum())} refreshes")

    xs = torch.from_numpy(np.stack(data[:SLOTS])).to(dev)
    live = torch.ones((SLOTS, ROUNDS, P), device=dev)
    live[SLOTS - 64:] = torch.from_numpy(sched).to(dev)
    print(f"   fleet {tuple(xs.shape)} on the card "
          f"({xs.numel() * 4 / 1e6:.0f} MB), liveness {tuple(live.shape)}")

    def fleet_run(config, rounds, masks, label):
        st = batched_stream_init(config, SLOTS, seed=0, device="cuda")
        torch.cuda.synchronize()
        ops.reset_counts()
        t = time.perf_counter()
        fin, met = batched_stream_run(config, st, xs[:, :rounds],
                                      None if masks is None
                                      else masks[:, :rounds])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        print(f"   {label}: {SLOTS} networks x {rounds} rounds in "
              f"{wall:.2f} s = {SLOTS * rounds / wall:.1f} rounds/s, "
              f"{1e3 * wall / rounds:.1f} ms a round; refreshes "
              f"{int(met.did_refresh.sum())}; launches "
              f"{ {k: v for k, v in launches.items() if v} }; plain calls "
              f"{sum(plain.values())}")
        check(sum(plain.values()) == 0, f"{label}: plain path was taken")
        check(launches["banded_matmul"] == rounds * per_decision,
              f"{label}: {launches['banded_matmul']} banded products, want "
              f"{rounds} x {per_decision}")
        check(bool(torch.isfinite(met.rho).all())
              and bool(torch.isfinite(met.comm_packets).all())
              and bool(torch.isfinite(fin.sched.W).all())
              and bool(torch.isfinite(fin.cov.band).all())
              and bool((fin.sched.refreshes >= 1).all())
              and bool((fin.rounds == rounds).all()),
              f"{label}: results not finite or not streamed")
        return fin, met, launches

    fin, met, launches = fleet_run(cfg, ROUNDS, live, "per-round fleet")
    check(launches["band_round_masked"] == ROUNDS
          and launches["band_round"] == 0
          and launches["band_round_masked_drop"] == 0
          and launches["supervised_compress"] == ROUNDS
          and launches["pca_monitor"] == ROUNDS
          and launches["fused_stream"] == launches["band_fold"]
          == launches["band_fold_masked"] == 0,
          f"per-round fleet launches {launches} vs {ROUNDS} rounds")
    worst = float(met.compression.max_err.max())
    print(f"   worst sink error {worst:.4f} <= eps {EPS} over "
          f"{float(met.compression.extra_packets.sum()):.0f} flagged "
          f"readings; {float(met.detection.alarms.sum()):.0f} alarmed "
          f"epochs; rho of the last round "
          f"{float(met.rho[:, -1].min()):.4f}..{float(met.rho[:, -1].max()):.4f}")
    check(worst <= EPS, "per-round fleet: the eps guarantee was broken")
    for name in ("band_round_masked", "band_round_masked_drop",
                 "banded_matmul", "banded_matvec"):
        record[name]["launches"] = launches[name]
    del fin, met
    profile_breakdown(lambda: fleet_run(cfg, ROUNDS, live,
                                        "profiled per-round fleet"))

    phase("9 per-round fleet: band only")
    _, _, launches = fleet_run(band_cfg, 16, None, "band-only per-round fleet")
    check(launches["band_round"] == 16 and launches["band_round_masked"] == 0
          and launches["band_round_masked_drop"] == 0
          and launches["band_fold"] == launches["band_fold_masked"] == 0,
          f"band-only per-round launches {launches}")
    record["band_round"]["launches"] = launches["band_round"]
    profile_breakdown(lambda: fleet_run(band_cfg, 16, None,
                                        "profiled band-only per-round fleet"))
    del xs, live

    phase("10 engine: fused stages, bf16 tiles")
    bf16_cfg = dataclasses.replace(cfg, precision="bf16")
    steps, launches, res = serve(bf16_cfg, ROUNDS, "bf16 stages engine")
    check(launches["fused_stream_bf16"] == steps
          and launches["fused_stream"] == 0,
          f"bf16 launches {launches} vs {steps} steps")
    slack = 2.0 ** -8 * max(float(np.abs(d).max()) for d in data)
    worst = max(r.compression_max_err for r in res)
    flagged = sum(r.compression_extra_packets for r in res)
    refreshes = sum(r.refreshes for r in res)
    alarms = sum(r.detection_events for r in res)
    print(f"   worst sink error {worst:.4f} <= eps {EPS} + 2^-8 max|x| "
          f"{slack:.4f}; {flagged:.0f} flagged readings (fp32, phase 4: "
          f"{fp32_books[0]:.0f}); refreshes {refreshes} (fp32: "
          f"{fp32_books[1]}); {alarms:.0f} alarmed epochs (fp32: "
          f"{fp32_books[2]:.0f})")
    check(worst <= EPS + slack, "bf16: the eps + bf16 rounding bound broke")
    check(flagged > 0, "bf16: no reading flagged")
    (r32, s32), (r16, s16) = (rates["stages engine"],
                              rates["bf16 stages engine"])
    print(f"   bf16 vs fp32 (phase 4): {r16:.1f} vs {r32:.1f} rounds/s, "
          f"step {s16:.1f} vs {s32:.1f} ms")
    record["fused_stream_bf16"]["launches"] = launches["fused_stream_bf16"]
    profile_breakdown(lambda: serve(bf16_cfg, ROUNDS,
                                    "profiled bf16 stages engine"))
    del res

    phase("11 device time of kernels 1 (fp32, bf16), 2, 3, 6, 7, 8, 9 and 10 "
          "(torch.profiler)")
    xb = torch.randn((SLOTS, K, N, P), device=dev, generator=g)
    wb = torch.rand((SLOTS, K), device=dev, generator=g)
    mb = (torch.rand((SLOTS, K, P), device=dev, generator=g) > 0.05).float()
    basis = random_bases(SLOTS, P, Q, seed=7, device=dev).contiguous()
    mean = 0.1 * torch.randn((SLOTS, P), device=dev, generator=g)
    il = torch.rand((SLOTS, Q), device=dev, generator=g) + 0.5
    for name, prec in (("fused_stream", "fp32"), ("fused_stream_bf16",
                                                  "bf16")):
        xt, bt = ops.fused_tiles(xb, prec), ops.fused_tiles(basis, prec)
        rec = record[name]
        rec["device_ms"], names = device_ms(
            lambda: ops.fused_stream_update(
                xt, wb, bt, mean, il, halfwidth=H, epsilon=2.5,
                with_compress=True, with_monitor=True, mask=mb,
                precision=prec), 50)
        print(f"   {name}: device time a call over 50 calls: kernel "
              f"{rec['device_ms']:.4f} ms [{names}] (events "
              f"{rec['ms']:.4f}); bound {rec['bound_ms']:.4f} ms")
        del xt, bt
    del basis, mean, il
    for name, m in (("band_fold", None), ("band_fold_masked", mb)):
        xm = xb if m is None else xb * m[:, :, None, :]
        xw = (xm * wb[:, :, None, None]).reshape(SLOTS, K * N, P)
        xm = xm.reshape(SLOTS, K * N, P)
        rec = record[name]
        rec["device_ms"], names = device_ms(
            lambda: ops.cov_band_update_chunk_batched(xb, wb, H, mask=m), 50)
        rec["library_device_ms"], lib_names = device_ms(
            lambda: torch.bmm(xw.transpose(1, 2), xm), 50)
        print(f"   {name}: device time a call over 50 calls: kernel "
              f"{rec['device_ms']:.4f} ms [{names}] (events "
              f"{rec['ms']:.4f}); torch.bmm forming the dense product "
              f"{rec['library_device_ms']:.4f} ms [{lib_names}] (events "
              f"{rec['library_ms']:.4f})")
        del xm, xw
    del xb, wb, mb
    for name, (xr, m) in round_operands(dev, g).items():
        xm = round_rows(xr, m)
        rec = record[name]
        rec["device_ms"], names = device_ms(
            lambda: ops.cov_band_update_batched(xr, H, mask=m), 50)
        rec["library_device_ms"], lib_names = device_ms(
            lambda: torch.bmm(xm.transpose(1, 2), xm), 50)
        print(f"   {name}: device time a call over 50 calls: kernel "
              f"{rec['device_ms']:.4f} ms [{names}] (events "
              f"{rec['ms']:.4f}); torch.bmm forming the dense product "
              f"{rec['library_device_ms']:.4f} ms [{lib_names}] (events "
              f"{rec['library_ms']:.4f})")
        del xm
    del xr, m
    xc = torch.randn((SLOTS, K * N, P), device=dev, generator=g)
    wr = random_bases(SLOTS, P, Q, seed=5, device=dev).contiguous()
    calls = products_8_9(xc, ref.pca_project(xc, wr), wr)
    for name, (run, _, lib) in calls.items():
        rec = record[name]
        rec["device_ms"], names = device_ms(run, 50)
        rec["library_device_ms"], lib_names = device_ms(lib, 50)
        print(f"   {name}: device time a call over 50 calls: kernel "
              f"{rec['device_ms']:.4f} ms [{names}] (events "
              f"{rec['ms']:.4f}); torch.bmm {rec['library_device_ms']:.4f} "
              f"ms [{lib_names}] (events {rec['library_ms']:.4f})")
    del calls, xc, wr
    band = torch.randn((SLOTS, 2 * H + 1, P), device=dev, generator=g) \
        * band_valid(P, H, device=dev)
    V = random_bases(SLOTS, P, Q, seed=6, device=dev).contiguous()
    dense = band_to_dense(band)
    for name, b, v, d in (("banded_matmul", band, V, dense),
                          ("banded_matmul_s1", band[:1].contiguous(),
                           V[:1].contiguous(), dense[:1])):
        rec = record[name]
        rec["device_ms"], names = device_ms(
            lambda: ops.banded_matmul(b, v), 50)
        rec["library_device_ms"], lib_names = device_ms(
            lambda: torch.bmm(d, v), 50)
        print(f"   {name}: device time a call over 50 calls: kernel "
              f"{rec['device_ms']:.4f} ms [{names}] (events "
              f"{rec['ms']:.4f}); torch.bmm on the dense matrix "
              f"{rec['library_device_ms']:.4f} ms [{lib_names}] (events "
              f"{rec['library_ms']:.4f})")
    del band, V, dense

    print(f"   total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0],
             replaces=KERNELS[name][1], launches=rec["launches"],
             max_abs_err=rec["max_abs_err"], ms=rec["ms"],
             plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
             bound_by=rec["bound_by"], library_ms=rec.get("library_ms"),
             **{k: rec[k] for k in ("cast_ms", "cast_bound_ms", "device_ms",
                                    "library_device_ms") if k in rec})
        for name, rec in record.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
