#!/usr/bin/env python3
"""Drive the PyTorch port of the streaming-PCA serving path on one GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from src/repro_torch/kernels/csrc (one nvcc per
     source, in parallel, into build/repro_torch/), with each kernel
     function's registers and spills, and the spills of the device
     functions that are not inlined: kernel 1's fold and stage blocks and
     kernels 4 and 5's stage tile (stage_rows; kernels 4 and 5 must not
     spill);
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
     kernel 1 equal bit for bit; kernels 4 and 5 (kernel 1's stage tile)
     at the engine's chunk and again at the per-round fleet's round (one
     round of 32 rows a slot, a (S, 1, p) liveness row; ``*_r32``), each
     timed over 50 calls on the row-major basis, and at both shapes bit
     for bit, with the per-round mask, its per-row expansion and none: z
     == kernel 8's on (x - mean) m, kernel 4's x_hat == kernel 9's plus the
     mean, a second launch, the per-row expansion == the per-round mask,
     the flags, T2 and SPE == kernel 1's on the same rows;
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
 11. kernels 1 (fp32 and bf16 tiles), 2, 3, 4 and 5 (at the chunk and
     at the round), 6, 7 (both masks), 8, 9 and 10 (at 256 slots and at
     one) and the folds' and products' torch.bmm again at phase 3's
     shapes, on inputs drawn anew (a dense product's time does not depend
     on the values), under torch.profiler: each one's device time a call
     over 50 calls, beside its event time, and the device time of a step
     of the fused body's plain-torch stage recompute (every slot's stages
     against the post-refresh basis, ``ops.fused_stream_stages_blocked``),
     so the wrapper's host time cannot hide in the figure (last, so that no
     profiler run comes ahead of phase 4's measured run, and no tensor is
     kept for it through phases 4-10);
 12. the engine of phase 4 with pipelined staging (pipeline=True: the chunk
     of step t+1 filled and uploaded from pinned memory on the copy stream
     right after step t is dispatched), timed back to back with the
     synchronous engine: every StreamResult field and the retirement order
     equal to phase 4's bit for bit, the same launches, no pull in the hot
     loop, at least one prestage hit; the band-only engine of phase 5
     pipelined, equal to phase 5 bit for bit; the pipelined run profiled
     (its host-to-device copies and idle share); the host syncs a step, by
     call site, from a separate run under
     torch.cuda.set_sync_debug_mode("warn") (only the refresh's eigh, the
     retirement pull and the transfer fence may sync); fleet_summary at
     q_fleet 32 and 256 after phases 4 and 12 (request i is region i):
     equal between the two engines, the selection equal to a numpy stable
     argsort of the pulled energies, the dense basis's columns equal to
     the selected regions' columns and orthonormal to 1e-5, the bill equal
     to lossy_merge_cost;
 13. the distributed drivers on one card, in an NCCL group of one rank
     (file store, timeout; destroyed at the end, on failure too):
     sharded_stream_run over phase 8's 256 networks (without masks: the
     reference's sharded driver takes none) equal bit for bit to
     batched_stream_run on the same inputs, with no collective (and, for the
     192 networks phase 8 streamed under all-ones masks, which fields equal
     phase 8's books); hierarchical_stream_run over those networks as 256
     regions of p=1024, chunk 8, with phase 8's liveness: one all_gather
     and one all_reduce, one banded product more than the chunk steps'
     (the region records), the merge equal to a numpy stable argsort of the
     gathered energy table;
 14. the paper's pipeline (repro_torch.core, repro_torch.sensors): the
     quickstart's steps at the paper's deployment (the Berkeley surrogate,
     p=52, 14,400 epochs, fold 0, 10 m radio range; DistributedPCA q=5 by
     masked power, banded power and banded ortho after the RCM
     relabelling, each equal to the same fit on the CPU in its iteration
     counts, its held-out retained variance beside numpy float64 eigh;
     supervised compression's eps exactly and the PCAg packets through
     repro_torch.examples.quickstart's steps, the low-variance detector
     through repro_torch.examples.event_detection on this trace), then
     wsn-1m's production steps at full width
     (p=1,048,576, h=128, q=32, 256-epoch batches: cov_update_step x 4,
     pim_block_step to convergence, pim_deflated_step for 3 components,
     transform_step; the planted subspace recovered) and the sharded
     block and deflated steps on one NCCL rank; kernels 6, 10 and 11 at
     both widths against their plain versions (by column window at 1M),
     with their times, bounds and one library call's: torch.bmm where the
     dense matrix fits, else cuSPARSE on the band's own pattern (SDDMM,
     SpMM, SpMV) (``*_berkeley``, ``*_wsn1m``); kernel 6's accumulating
     form, what banded_update launches, at both batches into a random
     band: against band_in + the plain delta, bit for bit band_in + the
     delta form, band_in unchanged, its time beside the two steps'
     (``band_round_acc_*``; the folds' launches under ``paper_pipeline``
     and ``wsn1m_production`` are its, with one add in the kernel each);
 15. the six examples of repro_torch.examples (streaming_pca,
     faulty_fleet, compression_fleet, event_fleet, quickstart,
     event_detection) at their own configurations from their seeded
     draws, each at its reference gate, with no plain call; each kernel's
     launches recorded under the example's name in ``launches_by_path``;
 16. the checker (repro_torch.analysis.check --device cuda, in this
     process): the ten program contracts at the engine's widths (8 slots,
     p=1024, h=128, q=32, K=8, n=32; the engine's with the host syncs by
     call site), every kernel call one pass over HBM, the build's and the
     launches' registers, spills and shared memory within the H100's
     limits and equal to analysis/baselines/resources.json, the lints;
 17. the LM serving path (repro_torch.models, the LM Engine) at the full
     width of the six dense and MoE configurations that fit one card
     (llama3.2-1b, granite-moe-3b-a800m, qwen2-7b, phi3-medium-14b,
     moonshot-v1-16b-a3b, chameleon-34b), one at a time, random bf16
     weights from a seed (the draw's peak beside the weights; leaves past
     2 GiB in fp32 drawn in blocks of layers): an 8-slot engine
     (512-position fp32 cache) serving 16 (past 5 B parameters 8, the
     time limit's cut) requests of 16-256 prompt tokens, 32 new tokens
     each (tokens/s,
     prefill ms by bucket, the decode step's ms beside its bytes bound,
     peak memory); two requests (one past 5 B) through a one-slot
     engine equal to a
     direct prefill + decode_step loop; the dense model's bucketed
     prefill against the exact-length one; the first two layers in fp32,
     card against CPU (``lm_serving``);
 18. the LM training path (repro_torch.train, distributed.compression,
     models.transformer.lm_loss with remat, data.tokens) at lm100m's full
     width and depth (examples/train_lm.py's configuration: random bf16
     weights from a seed, fp32 moments, AdamW lr 3e-4 wd 0.01, warmup 20,
     remat, TokenPipeline(seed=0) batches of 8 x 256): 30 steps
     uncompressed and 30 with rank-4 PowerSGD over a one-rank NCCL group,
     the loss falling in both (step ms, tokens/s, model TFLOP/s as
     6 N tokens / step time, peak memory; a profile of two steps); bitwise
     resume (6 steps straight == 3, save, a fresh Trainer, resume, 3);
     3 compressed steps of a 2-layer fp32 cut of lm100m and of
     granite-moe-3b-a800m's smoke MoE card vs CPU from the same numpy
     weights (and the MoE's twice on the card, bit for bit); llama3.2-1b
     at full width and depth, 5 compressed steps (``lm_training``);
     then the SSM, hybrid and encoder-decoder families at full width
     (mamba2-2.7b's first 32 of 64 layers, hymba-1.5b, seamless-m4t-medium
     with 8 x 256 encoder frames): 16 steps plain and 16 with rank-4
     PowerSGD each, the loss falling (step ms, tokens/s, model TFLOP/s
     from the dry run's meter over one more plain step, peak memory, a
     profile), 2 compressed steps of each family's fp32 depth cut card vs
     CPU (the losses, and the state after the first step), and bitwise
     resume on a 4-layer cut of hymba (``family_training``).
 19. the SSM, hybrid and encoder-decoder families (repro_torch.models.ssm,
     the three branches of models.transformer) at the full width of
     mamba2-2.7b, hymba-1.5b and seamless-m4t-medium, random bf16 weights
     from a seed: mamba2 and hymba through the LM Engine (8 slots, a
     512-position fp32 cache; 16 requests, 32 new tokens each: tokens/s,
     prefill ms by length, the decode step's ms beside its bytes bound
     with the fp32 SSM state read and written, peak memory, a profile; a
     one-slot engine == a direct prefill + decode_step loop for two
     requests); seamless's batched prefill of 8 x 16 tokens beside 256
     encoder frames and 32 decode steps (encoder, prefill and decode ms,
     bound, peak memory); each at a depth cut in fp32, card vs CPU
     (mamba2 2 layers over a 256-token prompt, two SSD chunks; hymba 4
     layers, layer 2 windowed, over 1,280 tokens, past the 1,024 window;
     seamless 2 + 2 layers), no kernel launch, no plain call
     (``lm_families``).
 20. the dry run (repro_torch.launch): ``dryrun --smoke`` on a one-rank
     NCCL mesh, the five wsn-1m cells at WSN.smoke() (p = 4096, h = 8,
     q = 8, n = 8) each within 1e-6 of the unsharded step through the
     kernels' plain versions on the CPU (max abs and rel err, and whether
     bit for bit), kernels 6, 10 and 11 launched (under
     ``launches_by_path["dryrun_smoke"]``) and no plain call; the full
     fake dry run of llama3.2-1b and granite-moe-3b-a800m decode_32k (the
     expert-parallel branch) and wsn-1m pim_block on the 16x16 mesh, a
     row each (peak GB per device, FLOPs, wire bytes, roofline terms at
     the H100 datasheet's rates); the planner against the card: phase
     18's lm100m step (8 x 256) run once for real under the dry run's
     meter and FlopCounterMode and once planned on a one-rank fake mesh,
     the three FLOP counts equal and the planned peak within 10% of
     max_memory_allocated over what earlier phases hold
     (``dryrun_on_card``);
 21. the pipeline schedule (repro_torch.distributed.pipeline) on a
     one-rank NCCL group: llama3.2-1b's 16 layers at full width as the
     one stage over 8 x 256 embedded bf16 tokens in 4 microbatches, the
     output and every gradient equal bit for bit to the microbatch loop,
     no point-to-point call, the time beside the loop's and the bubble
     fraction (``pipeline_on_card``).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA card, or without the rest
of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
P, H, Q, K, N = 1024, 128, 32, 8, 32          # one wsn-1m region per slot
SLOTS, REQUESTS, ROUNDS = 256, 320, 24        # 256 of wsn-1m's 1024 regions
EPS = 1.0
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
    # kernels 4 and 5 at the per-round fleet's round (R = n = 32 rows)
    "supervised_compress_r32": (_SPLIT,
                                "src/repro/kernels/pca_project.py:216"),
    "pca_monitor_r32": (_SPLIT, "src/repro/kernels/pca_project.py:171"),
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
    # kernels 6, 10 and 11 at one slot on the paper pipeline's widths
    # (phase 14): the Berkeley deployment and wsn-1m
    "band_round_berkeley": ("src/repro_torch/kernels/csrc/band_fold.cu",
                            "src/repro/kernels/cov_update.py:53"),
    "banded_matmul_berkeley": ("src/repro_torch/kernels/csrc/banded.cu",
                               "src/repro/kernels/banded_matvec.py:85"),
    "banded_matvec_berkeley": ("src/repro_torch/kernels/csrc/banded.cu",
                               "src/repro/kernels/banded_matvec.py:52"),
    "band_round_wsn1m": ("src/repro_torch/kernels/csrc/band_fold.cu",
                         "src/repro/kernels/cov_update.py:53"),
    # kernel 6's accumulating form (band_in + the round's sums), what
    # banded_update launches, at the same two batches
    "band_round_acc_berkeley": ("src/repro_torch/kernels/csrc/band_fold.cu",
                                "src/repro/kernels/cov_update.py:53"),
    "band_round_acc_wsn1m": ("src/repro_torch/kernels/csrc/band_fold.cu",
                             "src/repro/kernels/cov_update.py:53"),
    "banded_matmul_wsn1m": ("src/repro_torch/kernels/csrc/banded.cu",
                            "src/repro/kernels/banded_matvec.py:85"),
    "banded_matvec_wsn1m": ("src/repro_torch/kernels/csrc/banded.cu",
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
    if not rows:
        print(f"   profile: the profiler caught no device event in "
              f"{wall:.3f} s wall (device time not measured)")
        return
    busy = sum(_dev_time(e) for e in rows) / 1e6
    print(f"   profile: device busy {busy:.3f} s of {wall:.3f} s wall "
          f"({100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%)"
          f"; {sum(e.count for e in rows)} device events")
    print(f"   host-to-device copies: {h2d_copies(rows)}")
    ours = [e for e in rows[top:] if "repro_torch::" in e.key]
    for e in rows[:top] + ours:
        print(f"     {_dev_time(e) / 1e3:10.1f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


def h2d_copies(rows) -> str:
    """The host-to-device copies among a profile's device rows: each kind
    (pinned, pageable) with its device time and count."""
    kinds = [e for e in rows if "HtoD" in e.key]
    if not kinds:
        return "none"
    return "; ".join(f"{e.key}: {_dev_time(e) / 1e3:.1f} ms ({e.count}x)"
                     for e in kinds)


def different_fields(a: list, b: list) -> list[str]:
    """The fields that differ between two lists of dataclasses (two runs'
    StreamResults, two FleetSummaries), compared bit for bit."""
    bad = set()
    for ra, rb in zip(a, b, strict=True):
        for f in dataclasses.fields(ra):
            va, vb = getattr(ra, f.name), getattr(rb, f.name)
            if not np.array_equal(np.asarray(va), np.asarray(vb)):
                bad.add(f.name)
    return sorted(bad)


def fleet_yardstick(eng, summ, q_fleet: int, dev) -> None:
    """``summ`` (``eng.fleet_summary(q_fleet)``) against a numpy stable
    argsort of the retired regions' pulled energies: the selection and its
    energies equal, each dense column the selected region's column at its
    offset, the basis orthonormal to 1e-5 (its Gram matrix in fp64 on the
    card), the bill the cost model's."""
    from repro_torch.core import costs
    regions = sorted(eng.region_results)
    check(summ.regions == tuple(regions), "fleet_summary regions")
    table = np.stack([eng.region_results[r].energies for r in regions])
    order = np.argsort(-table.reshape(-1), kind="stable")[:q_fleet]
    q, p = table.shape[1], eng.cfg.p
    check(np.array_equal(summ.region, order // q)
          and np.array_equal(summ.col, order % q)
          and np.array_equal(summ.lam, table.reshape(-1)[order]),
          f"fleet_summary({q_fleet}): selection differs from numpy's")
    for j, (r, c) in enumerate(zip(summ.region, summ.col)):
        col = summ.basis[:, j]
        check(np.array_equal(col[r * p:(r + 1) * p],
                             eng.region_results[regions[r]].components[:, c])
              and not col[:r * p].any() and not col[(r + 1) * p:].any(),
              f"fleet_summary({q_fleet}): column {j} is not region {r}'s "
              f"column {c}")
    b = torch.from_numpy(summ.basis).to(dev, torch.float64)
    gram_err = float((b.T @ b - torch.eye(q_fleet, device=dev,
                                          dtype=torch.float64)).abs().max())
    del b
    bill = costs.lossy_merge_cost(eng.cfg.q, eng.cfg.c_max,
                                  eng.cfg.link_loss,
                                  eng.cfg.max_retries).communication
    print(f"   fleet_summary(q_fleet={q_fleet}) over {len(regions)} regions: "
          f"basis {summ.basis.shape}, rho {summ.rho:.6f}, lam "
          f"{summ.lam[0]:.4f}..{summ.lam[-1]:.4f}, {len(set(summ.region))} "
          f"regions chosen; == numpy stable argsort of the pulled energies; "
          f"|B^T B - I| {gram_err:.2e}; merge packets {summ.merge_packets} "
          f"(lossy_merge_cost {bill})")
    check(gram_err <= 1e-5, f"fleet_summary({q_fleet}) basis not orthonormal")
    check(summ.merge_packets == bill, "fleet_summary merge bill")


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


def stage_cases(xv, m, n, wr, mean, il, eps) -> dict:
    """Kernels 4 and 5 on rows ``xv`` (S, R, p) with a per-round mask ``m``
    (S, R / n, p), read at row r // n, and the row-major basis ``wr``:
    ``{name: (kernel call, plain call, flops, bytes)}``, the bytes each
    input read once and each output written once."""
    from repro_torch.kernels import ops, ref
    S, R, p = xv.shape
    q = wr.shape[-1]
    rows_mask = m.repeat_interleave(n, dim=1)
    f32 = 4.0
    x_b, w_b, m_b = S * R * p * f32, S * p * q * f32, m.numel() * f32
    z_b, stat_b = S * R * q * f32, 2 * S * R * f32
    prod = 2.0 * S * R * p * q
    return {
        "supervised_compress": (
            lambda: ops.supervised_compress(xv, wr, mean, epsilon=eps,
                                            mask=m, n=n),
            lambda: ref.supervised_compress(xv, wr, mean, rows_mask, eps),
            2 * prod, x_b + m_b + w_b + S * p * f32 + z_b + x_b + S * R * p),
        "pca_monitor": (
            lambda: ops.pca_monitor(xv, wr, mean, il, mask=m, n=n),
            lambda: ref.pca_monitor(xv, wr, mean, il, rows_mask),
            2 * prod, x_b + m_b + w_b + S * (p + q) * f32 + z_b + stat_b),
    }


def stage_yardsticks(label, xv, m, n, wr, mean, il, eps) -> None:
    """Kernels 4 and 5 bit for bit against the kernels whose order of sums
    each output keeps, with the per-round mask ``m`` (S, R / n, p), its
    per-row expansion and no mask: z == kernel 8's on (x - mean) m formed
    in torch, kernel 4's x_hat == kernel 9's on that z plus the mean, a
    second launch equal, the per-row expansion equal to the per-round
    mask, and (per-round mask or none: kernel 1 takes no per-row mask)
    the flags, T2 and SPE == kernel 1's on the same rows as a chunk of
    R / n rounds."""
    from repro_torch.kernels import ops
    S, R, p = xv.shape
    rows_m = m.repeat_interleave(n, dim=1)
    same, first = {}, None
    for kind, mk, d in (("per-round mask", m, n),
                        ("per-row mask", rows_m, None),
                        ("no mask", None, None)):
        run = lambda: (ops.supervised_compress(xv, wr, mean, epsilon=eps,
                                               mask=mk, n=d)
                       + ops.pca_monitor(xv, wr, mean, il, mask=mk, n=d))
        out = run()
        xc = xv - mean[:, None, :]
        if mk is not None:
            xc = xc * rows_m
        z8 = ops.pca_project(xc, wr)
        del xc
        xh9 = ops.pca_reconstruct(z8, wr) + mean[:, None, :]
        same[f"{kind}: z of kernels 4 and 5 == pca_project's (kernel 8) "
             f"on (x - mean) m"] = (torch.equal(out[0], z8)
                                    and torch.equal(out[3], z8))
        same[f"{kind}: x_hat == pca_reconstruct's (kernel 9) + mean"] = \
            torch.equal(out[1], xh9)
        del z8, xh9
        same[f"{kind}: a second launch gives equal bits"] = all(
            torch.equal(a, b) for a, b in zip(out, run()))
        if first is None:
            first = out
        elif d is None and mk is not None:
            same["the per-row expansion == the per-round mask"] = all(
                torch.equal(a, b) for a, b in zip(out, first))
        if mk is None or d is not None:
            K = R // n
            fused = ops.fused_stream_update(
                xv.reshape(S, K, n, p), torch.ones((S, K), device=xv.device),
                wr, mean, il, halfwidth=H, epsilon=eps, with_compress=True,
                with_monitor=True, mask=mk)
            same[f"{kind}: flags, T2 and SPE == fused_stream's (kernel 1) "
                 f"on {K} rounds of {n}"] = (
                torch.equal(fused[3], out[2]) and torch.equal(fused[4], out[4])
                and torch.equal(fused[5], out[5]))
            del fused
        del out
    del first
    for what, ok in same.items():
        print(f"   {label} {what} (bit for bit): {ok}")
        check(ok, f"{label}: {what} does not hold")


def split_kernels(record, xv, masks, basis, mean, il, eps, g) -> None:
    """Kernels 4, 5, 8 and 9 against their plain versions at the slice
    shape, per-round masks read at row r // N, and kernels 4 and 5 again at
    the per-round fleet's round (one round of N rows a slot, a (S, 1, p)
    liveness row; recorded as ``*_r32``), each with its bit identities
    (:func:`stage_yardsticks`); times beside bounds, and torch.bmm (TF32
    off) beside the projection and reconstruction.  Every kernel is timed
    over 50 calls (a 0.1 ms kernel's time is not the event timer's or the
    launch gaps'; at the round the wrapper's host time may exceed the
    device's, which phase 11 gives), on the basis made row-major, as the
    engine's refresh leaves it."""
    from repro_torch.kernels import ops, ref
    S, R, p = xv.shape
    q = basis.shape[-1]
    wr = basis.contiguous()
    rx = torch.randn((S, N, p), device=xv.device, generator=g)
    live = (torch.rand((S, 1, p), device=xv.device, generator=g)
            > 0.05).float()
    cases = {}
    for suffix, (x, m) in (("", (xv, masks)), ("_r32", (rx, live))):
        stage_yardsticks(f"stages R={x.shape[1]}", x, m, N, wr, mean, il,
                         eps)
        for name, case in stage_cases(x, m, N, wr, mean, il, eps).items():
            cases[name + suffix] = (x,) + case + (None,)
    rows_mask = masks.repeat_interleave(N, dim=1)
    xc = (xv - mean[:, None, :]) * rows_mask
    del rows_mask
    f32 = 4.0
    prod = 2.0 * S * R * p * q
    z8 = ref.pca_project(xc, wr)
    for name, (run, plain_fn, lib) in products_8_9(xc, z8, wr).items():
        cases[name] = (xc, run, plain_fn, prod,
                       f32 * (S * R * p + S * p * q + S * R * q), lib)
    for name, (x, run, plain_fn, flops, nbytes, lib) in cases.items():
        out = run()
        torch.cuda.synchronize()
        plain = plain_fn()
        errs = []
        for i, (a, b) in enumerate(zip(out, plain)):
            if a.dtype == torch.bool:
                xh = plain[1]
                clear = ((x - xh).abs() - eps).abs() > 1e-3
                bad = int(((a != b) & clear).sum())
                print(f"   {name} flags: {int(a.sum())} set, {bad} disagree "
                      f"away from eps (want 0)")
                check(bad == 0, f"{name} flags disagree")
                continue
            errs.append(compare(f"{name}[{i}]", a, b, 1e-4, 1e-3))
        del out, plain
        iters = 50
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
        print(f"   {name} S={S} R={x.shape[1]} p={p} q={q}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms{lib_txt}, bound "
              f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e9:.3f} GB)")
        record[name] = rec
    del cases, xc, z8, wr, rx, live


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
        check(same, f"{name}: bits differ from the plain version at the "
              f"refresh's band")
        if vec:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            print(f"   {name}: plan {ops.banded_matvec_plan(S, P, H, sms)}")
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


# the paper's deployment (paper Sec. 4: the Berkeley surrogate, 52
# sensors, 14,400 epochs, 10 m radio range, q = 5, eps = 0.5 C) and
# wsn-1m's production width (configs/wsn_1m.py: p, halfwidth, q,
# batch_epochs)
BERKELEY_P, BERKELEY_EPOCHS, BERKELEY_Q = 52, 14_400, 5
RADIO, EPS_C = 10.0, 0.5
WSN_P, WSN_H, WSN_Q, WSN_N = 1_048_576, 128, 32, 256
WINDOW = 4096                         # columns a window of the 1M checks
DENSE_MAX_BYTES = 2 ** 30             # a dense (p, p) yardstick up to 1 GiB


def path_counts() -> tuple[dict, int]:
    """The kernel launches since the last ``ops.reset_counts()``, and the
    plain calls (a path on the card makes none)."""
    from repro_torch.kernels import ops
    return ({k: v for k, v in ops.LAUNCHES.items() if v},
            sum(ops.PLAIN_CALLS.values()))


def windows(name, out, plain, axis) -> None:
    """The largest error in column windows at both edges and the middle of
    the width (``axis``): where 32-bit index products would first go
    wrong.  Widths below three windows are compared whole only."""
    p = out.shape[axis]
    if p < 3 * WINDOW:
        return
    errs = []
    for lo in (0, p // 2 - WINDOW // 2, p - WINDOW):
        err = out.narrow(axis, lo, WINDOW) - plain.narrow(axis, lo, WINDOW)
        errs.append(f"[{lo}, {lo + WINDOW}) {err.abs().max().item():.3e}")
    print(f"   {name}: max_abs_err in windows {'; '.join(errs)}")


def small_device_times(rec, name, run, lib) -> None:
    """At a width this small a call's event time is the wrapper's host
    time: the device time a call of the kernel and of its torch.bmm
    (``device_ms``, 50 calls each)."""
    rec["device_ms"], _ = device_ms(run, 50)
    rec["library_device_ms"], _ = device_ms(lib, 50)
    print(f"   {name}: device time a call {rec['device_ms']:.4f} ms, "
          f"torch.bmm's {rec['library_device_ms']:.4f} ms")


def band_csr(band):
    """A (2h+1, p) band's (p, p) CSR form, int32 indices, row i holding
    columns i-h..i+h in order (``band[k, i]`` at column i + k - h), and
    the (p, 2h+1) mask of the band's entries inside the matrix: the
    sparse yardstick where the dense matrix does not fit, built once
    outside any timing."""
    nb, p = band.shape
    h = (nb - 1) // 2
    i32 = dict(dtype=torch.int32, device=band.device)
    cols = (torch.arange(p, **i32)[:, None]
            + torch.arange(-h, h + 1, **i32)[None])
    valid = (cols >= 0) & (cols < p)
    crow = torch.zeros(p + 1, **i32)
    crow[1:] = valid.sum(1).cumsum(0)
    with warnings.catch_warnings():         # "sparse CSR support is beta"
        warnings.simplefilter("ignore")
        csr = torch.sparse_csr_tensor(crow, cols[valid], band.T[valid],
                                      size=(p, p), check_invariants=False)
    return csr, valid


def one_slot_fold(name, x, h, iters, plain_iters) -> dict:
    """Kernel 6's delta form on one (n, p) batch (``ops.cov_band_update``,
    what the sharded fold and an fp64 state launch): against its plain
    version on the card (1e-4 / 1e-3, the fold
    tolerance; by window at 1M), its band exactly symmetric and kernel 2's
    bits at K = 1, w = 1; its time beside the plain version's, its bound
    and, where the (p, p) product fits in ``DENSE_MAX_BYTES``, torch.bmm's
    dense product, else torch.sparse.sampled_addmm on the band's pattern
    (3 calls: cuSPARSE's SDDMM is slow); the segments of its order of sums
    and the shape and grid the launch took (``ops.band_round_plan``)."""
    from repro_torch.kernels import ops, ref
    n, p = x.shape
    run = lambda: ops.cov_band_update(x, h)
    plain_fn = lambda: ref.cov_band_update(x, h)
    out = run()
    torch.cuda.synchronize()
    plain = plain_fn()
    err = compare(f"{name} n={n} p={p} h={h}", out, plain, 1e-4, 1e-3)
    windows(name, out, plain, 1)
    del plain
    chunk = ops.cov_band_update_chunk_batched(
        x[None, None], torch.ones((1, 1), device=x.device), h)[0]
    sym, same = mirrored(out[None], h), torch.equal(out, chunk)
    print(f"   {name}: band exactly symmetric {sym}; == kernel 2's at "
          f"K = 1, w = 1 (bit for bit) {same}")
    check(sym and same, f"{name}: band not mirrored or not kernel 2's")
    del chunk
    ms, plain_ms = time_ms(run, iters), time_ms(plain_fn, plain_iters, 1)
    nbytes = 4.0 * (x.numel() + out.numel())
    b_ms, b_by = bound(fold_flops(1, n, p, h), nbytes)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None)
    if 4.0 * p * p <= DENSE_MAX_BYTES:
        dense_fold(rec, name, out[None], x[None], x[None], h, iters)
        small_device_times(rec, name, run, lambda: torch.bmm(
            x[None].transpose(1, 2), x[None]))
    else:
        # the dense (p, p) product does not fit: cuSPARSE's SDDMM on the
        # band's own pattern computes the same sums
        pattern, valid = band_csr(out)
        lib = lambda: torch.sparse.sampled_addmm(pattern, x.T, x, beta=0.0)
        got = out.new_zeros(valid.shape)
        got[valid] = lib().values()
        compare(f"{name} vs torch.sparse.sampled_addmm on the band's "
                f"pattern", out, got.T, 1e-4, 1e-3)
        del got
        rec["library_ms"] = time_ms(lib, 3, 1)
        print(f"   {name}: torch.sparse.sampled_addmm (SDDMM) "
              f"{rec['library_ms']:.3f} ms (the dense ({p}, {p}) product "
              f"would take {4.0 * p * p / 1e9:,.0f} GB)")
        del pattern, valid
    plan = ops.band_round_plan(1, n, p, h, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    rec.update(shape=plan.shape, segments=plan.segments, blocks=plan.blocks)
    print(f"   {name} n={n} p={p} h={h}: kernel {ms:.4f} ms ({iters} "
          f"calls), plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{nbytes / 1e9:.4f} GB); {plan.segments} segments of "
          f"{ops.SEGMENT_ROWS} rows, shape {plan.shape}, grid {plan.blocks} "
          f"blocks (workspace {plan.workspace_bytes} B)")
    return rec


def one_slot_acc_fold(name, x, h, iters, plain_iters) -> dict:
    """Kernel 6's accumulating form on one (n, p) batch, as
    ``banded_update`` launches it (``ops.cov_band_accumulate``), into a
    random band that is not symmetric, so every entry, the corners too, has
    a value of its own: against band_in + the plain delta on the card (the
    fold tolerance; by window at 1M), equal bits to band_in + the delta
    form, band_in left as it was, one launch and one add in the kernel; its
    time beside the two steps' (band_in + the delta form) and the plain
    version's, and its bound (the delta form's bytes and a read of
    band_in)."""
    from repro_torch.kernels import ops, ref
    n, p = x.shape
    g = torch.Generator(device=x.device).manual_seed(n + p)
    band_in = torch.randn((2 * h + 1, p), device=x.device, generator=g)
    kept = band_in.clone()
    torch.cuda.synchronize()
    ops.reset_counts()
    out = ops.cov_band_accumulate(band_in, x, h)
    torch.cuda.synchronize()
    launched, plain_n = path_counts()
    adds = ops.IN_KERNEL_ADDS["band_round"]
    check(launched == {"band_round": 1} and adds == 1 and plain_n == 0,
          f"{name}: launches {launched}, adds in the kernel {adds}, plain "
          f"{plain_n}")
    plain_fn = lambda: band_in + ref.cov_band_update(x, h)
    plain = plain_fn()
    err = compare(f"{name} n={n} p={p} h={h} (band_in + the plain delta)",
                  out, plain, 1e-4, 1e-3)
    windows(name, out, plain, 1)
    del plain
    two = lambda: band_in + ops.cov_band_update(x, h)
    same, untouched = torch.equal(out, two()), torch.equal(band_in, kept)
    print(f"   {name}: == band_in + the delta form (bit for bit) {same}; "
          f"band_in unchanged {untouched}")
    check(same and untouched, f"{name}: bits differ from band_in + the "
          f"delta form, or band_in was written")
    del kept, out
    run = lambda: ops.cov_band_accumulate(band_in, x, h)
    ms, two_ms = time_ms(run, iters), time_ms(two, iters)
    plain_ms = time_ms(plain_fn, plain_iters, 1)
    nbytes = 4.0 * (x.numel() + 2 * band_in.numel())
    b_ms, b_by = bound(fold_flops(1, n, p, h), nbytes)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None, two_step_ms=two_ms)
    if 4.0 * p * p <= DENSE_MAX_BYTES:
        # at this width a call's event time is the wrapper's host time
        rec["device_ms"], _ = device_ms(run, 50)
        rec["two_step_device_ms"], _ = device_ms(two, 50)
        print(f"   {name}: device time a call {rec['device_ms']:.4f} ms, "
              f"band_in + the delta form's {rec['two_step_device_ms']:.4f} "
              f"ms")
    print(f"   {name} n={n} p={p} h={h}: kernel {ms:.4f} ms ({iters} "
          f"calls), band_in + the delta form {two_ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{nbytes / 1e9:.4f} GB)")
    return rec


def one_slot_product(name, band, V, iters, plain_iters) -> dict:
    """Kernel 10 (V (p, q)) or 11 (v (p,)) at one slot, as
    ``repro_torch.core`` launches it: equal bits to its plain version on
    the card (by window at 1M), its time beside the plain version's, its
    bound and, where the (p, p) matrix fits, torch.bmm on it, else the
    band's CSR form times the vector or matrix (cuSPARSE)."""
    from repro_torch.core.covariance import band_to_dense
    from repro_torch.kernels import ops, ref
    vec = V.dim() == 1
    kernel = ops.banded_matvec if vec else ops.banded_matmul
    plain_op = ref.banded_matvec if vec else ref.banded_matmul
    run, plain_fn = lambda: kernel(band, V), lambda: plain_op(band, V)
    out = run()
    torch.cuda.synchronize()
    plain = plain_fn()
    nb, p = band.shape
    h, width = (nb - 1) // 2, 1 if vec else V.shape[1]
    if vec:
        sms = torch.cuda.get_device_properties(
            band.device).multi_processor_count
        print(f"   {name}: plan {ops.banded_matvec_plan(1, p, h, sms)}")
    err = compare(f"{name} p={p} h={h} q={width}", out, plain, 1e-5, 1e-5)
    windows(name, out, plain, 0)
    same = torch.equal(out, plain)
    print(f"   {name}: equal bits to the plain version {same}")
    check(same, f"{name}: bits differ from the plain version")
    del plain
    ms, plain_ms = time_ms(run, iters), time_ms(plain_fn, plain_iters, 1)
    entries = band_entries(p, h)
    flops = 2.0 * width * entries
    nbytes = 4.0 * (entries + 2 * p * width)
    b_ms, b_by = bound(flops, nbytes)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None)
    if 4.0 * p * p <= DENSE_MAX_BYTES:
        dense = band_to_dense(band)[None]
        V3 = V.reshape(1, p, width)
        lib = lambda: torch.bmm(dense, V3)
        compare(f"{name} vs torch.bmm on the dense matrix", out,
                lib().reshape(out.shape), 1e-4, 1e-4)
        rec["library_ms"] = time_ms(lib, iters)
        lib_txt = f"torch.bmm on dense {rec['library_ms']:.4f} ms"
        small_device_times(rec, name, run, lib)
    else:
        # the dense (p, p) matrix does not fit: cuSPARSE's SpMV / SpMM on
        # the band's CSR form
        csr, _ = band_csr(band)
        lib = lambda: csr @ V
        compare(f"{name} vs the band's CSR form", out, lib(), 1e-4, 1e-4)
        rec["library_ms"] = time_ms(lib, iters)
        lib_txt = (f"CSR @ {'v' if vec else 'V'} (cuSPARSE) "
                   f"{rec['library_ms']:.4f} ms (the dense ({p}, {p}) "
                   f"matrix would take {4.0 * p * p / 1e9:,.0f} GB)")
        del csr
    print(f"   {name} S=1 p={p} h={h} q={width}: kernel {ms:.4f} ms "
          f"({iters} calls), plain {plain_ms:.3f} ms, {lib_txt}, bound "
          f"{b_ms:.5f} ms ({b_by}; {flops / 1e6:.2f} MFLOP, "
          f"{nbytes / 1e6:.3f} MB)")
    return rec


def eigh64_retained(train, test, mask, q, method) -> float:
    """The yardstick of a fit's held-out retained variance: numpy float64
    eigh of the same masked covariance (a banded or masked covariance need
    not be positive semi-definite), its q eigenvalues of largest
    magnitude — those both iterations converge to — kept as the fit keeps
    them: 'power' up to the first negative one (Algorithm 2's stop),
    'ortho' the positive ones."""
    from repro_torch.core.pca import retained_variance
    x = np.asarray(train, np.float64)
    mu = x.mean(0)
    xc = x - mu
    lam, U = np.linalg.eigh(np.where(mask, xc.T @ xc / len(x), 0.0))
    lam, U = lam[np.argsort(-np.abs(lam))[:q]], U[:, np.argsort(
        -np.abs(lam))[:q]]
    keep = (np.cumprod(lam > 0).astype(bool) if method == "power"
            else lam > 0)
    return retained_variance(test, U[:, keep], mu)


def paper_pipeline(record, dev) -> None:
    """Phase 14, the paper's deployment: the quickstart's steps on the card —
    the Berkeley surrogate (p = 52, 14,400 epochs), fold 0 of the block
    K-fold, the 10 m topology; DistributedPCA q = 5 by masked power
    iteration, and after the RCM relabelling by banded power (kernel 6
    once, kernel 11 once an iteration) and banded ortho (kernel 6 once,
    kernel 10 once an iteration and once more); each fit against the same
    fit on the CPU from the same start (iteration counts and valid equal,
    eigenvalues rtol 1e-3: the fp32 covariance cancels ~24 C means), its
    held-out retained variance within 2e-3 of numpy float64 eigh on the
    same mask (:func:`eigh64_retained`); supervised compression's eps
    guarantee exactly, the PCAg packets of scores_in_network, the
    low-variance detector on an injected event at
    examples/event_detection.py's gate; then kernels 6, 10 and 11 at these
    shapes against their plain versions and torch.bmm."""
    from repro_torch.core import covariance as cov
    from repro_torch.core import power_iteration as pim
    from repro_torch.core.pca import DistributedPCA, retained_variance
    from repro_torch.examples import event_detection, quickstart
    from repro_torch.core.topology import (bandwidth_reduce, build_topology,
                                           graph_bandwidth)
    from repro_torch.kernels import ops
    from repro_torch.sensors.dataset import berkeley_surrogate, kfold_blocks
    t0 = time.perf_counter()
    ds = berkeley_surrogate(p=BERKELEY_P, n_epochs=BERKELEY_EPOCHS, seed=0)
    tr, te = kfold_blocks(ds.n_epochs, 10)[0]
    train, test = ds.measurements[tr], ds.measurements[te]
    net = build_topology(ds.positions, radio_range=RADIO)
    perm = bandwidth_reduce(net.adjacency)
    hb = graph_bandwidth(net.adjacency, perm)
    p, q = BERKELEY_P, BERKELEY_Q
    rng = np.random.default_rng(0)
    init = {"power": rng.standard_normal((q, p)).astype(np.float32),
            "ortho": rng.standard_normal((p, q)).astype(np.float32)}
    print(f"   Berkeley surrogate p={p}, {ds.n_epochs} epochs (made in "
          f"{time.perf_counter() - t0:.1f} s); fold 0: train {len(tr)}, "
          f"held out {len(te)}; radio {RADIO} m: tree depth "
          f"{net.tree.depth.max()}, max children "
          f"{net.tree.children_counts().max()}; RCM bandwidth h={hb}")
    banded_mask = np.abs(np.subtract.outer(np.arange(p), np.arange(p))) <= hb
    runs = {"masked power": ("power", "masked", train, test,
                             net.covariance_mask()),
            "banded power": ("power", "banded", train[:, perm],
                             test[:, perm], banded_mask),
            "banded ortho": ("ortho", "banded", train[:, perm],
                             test[:, perm], banded_mask)}
    paths = collections.Counter()
    fits = {}
    for label, (method, mode, xtr, xte, mask) in runs.items():
        kw = dict(q=q, method=method, cov_mode=mode, init=init[method],
                  mask=mask if mode == "masked" else None,
                  halfwidth=hb if mode == "banded" else None)
        torch.cuda.synchronize()
        ops.reset_counts()
        pim.reset_host_reads()
        t = time.perf_counter()
        res = DistributedPCA(device="cuda", **kw).fit(xtr)
        wall = time.perf_counter() - t
        launches, plain = path_counts()
        adds = ops.IN_KERNEL_ADDS["band_round"]
        reads = sum(pim.HOST_READS.values())
        cpu = DistributedPCA(device="cpu", **kw).fit(xtr)
        it = np.asarray(res.iterations)
        n_it = int(it.sum())
        want = ({} if mode == "masked" else
                {"band_round": 1, "banded_matvec": n_it} if method == "power"
                else {"band_round": 1, "banded_matmul": n_it + 1})
        kept = res.components[:, res.valid]
        rv = retained_variance(xte, kept, res.mean)
        rv64 = eigh64_retained(xtr, xte, mask, q, method)
        print(f"   {label}: iterations {it.tolist()} (CPU "
              f"{np.asarray(cpu.iterations).tolist()}), valid "
              f"{res.valid.tolist()}, eigenvalues "
              f"{np.round(res.eigenvalues, 4).tolist()}; held-out retained "
              f"variance {rv:.6f} (float64 eigh {rv64:.6f}); {wall:.3f} s, "
              f"{reads} host reads of the loop test; launches {launches}, "
              f"plain calls {plain}")
        check(plain == 0 and launches == want
              and adds == want.get("band_round", 0),
              f"{label}: launches {launches} (want {want}), adds in the "
              f"kernel {adds}, plain {plain}")
        check(np.array_equal(it, np.asarray(cpu.iterations))
              and np.array_equal(res.valid, cpu.valid),
              f"{label}: card and CPU differ in iterations or valid")
        check(np.allclose(res.eigenvalues, cpu.eigenvalues, rtol=1e-3),
              f"{label}: eigenvalues card {res.eigenvalues} CPU "
              f"{cpu.eigenvalues}")
        check(abs(rv - rv64) <= 2e-3, f"{label}: retained variance {rv} vs "
              f"float64 eigh {rv64}")
        paths.update(launches)
        fits[label] = res

    # the quickstart's steps (repro_torch.examples.quickstart) on the
    # masked power fit: supervised compression over every held-out epoch
    # and PCAg's scores of the first, against numpy
    res = fits["masked power"]
    qs = quickstart.evaluate(res, net, test, compress_epochs=None)
    kept = qs["kept"]
    want_packets = kept.shape[1] * (net.tree.children_counts() + 1)
    print(f"   supervised compression (eps {EPS_C} C) over {len(test)} "
          f"held-out epochs: notification rate "
          f"{qs['notification_rate']:.4f}, worst sink error "
          f"{qs['max_sink_error']:.6f}; PCAg epoch: packets a node max "
          f"{qs['packets'].max()} == q (C_i + 1) "
          f"{np.array_equal(qs['packets'], want_packets)}")
    check(qs["max_sink_error"] <= EPS_C, "the eps guarantee was broken")
    check(np.array_equal(qs["packets"], want_packets)
          and np.allclose(qs["scores"], (test[0] - res.mean) @ kept,
                          rtol=1e-9, atol=1e-9),
          "scores_in_network packets or scores")
    # repro_torch.examples.event_detection on the card with this trace:
    # its split (2.5 days train, 10 h calibration, 20 h deployment),
    # components 10..29 of the full eigh fit, an event coherent across the
    # network in their span (1.2 C at most)
    ed = event_detection.run(dev, measurements=ds.measurements)
    print(f"   low-variance detector (components 10..29 of the card's full "
          f"eigh fit on 3600 epochs, calibrated on 1200): injected event "
          f"flagged in {ed['tpr']:.3f} of its 40 epochs, false alarms "
          f"{ed['fpr']:.4f}")
    check(ed["tpr"] > 0.8 and ed["fpr"] < 0.05, "the low-variance "
          "detector's gate (examples/event_detection.py: > 0.8 detected, "
          "< 0.05 false)")

    # kernels 6 (both forms), 10, 11 at the Berkeley shapes
    xb = torch.tensor(train[:, perm], dtype=torch.float32, device=dev)
    band = cov.banded_estimate(cov.banded_update(
        cov.banded_init(p, hb, device=dev), xb))
    V = torch.randn((p, q), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(52))
    record["band_round_berkeley"] = one_slot_fold(
        "band_round_berkeley", xb, hb, 200, 20)
    record["band_round_acc_berkeley"] = one_slot_acc_fold(
        "band_round_acc_berkeley", xb, hb, 200, 20)
    record["banded_matmul_berkeley"] = one_slot_product(
        "banded_matmul_berkeley", band, V, 500, 20)
    record["banded_matvec_berkeley"] = one_slot_product(
        "banded_matvec_berkeley", band, V[:, 0].contiguous(), 500, 20)
    # banded_update launches the accumulating form: the fits' folds are
    # its launches, the delta form's record has none on this path
    record["band_round_berkeley"]["launches_by_path"] = {}
    for kernel in ("band_round_acc", "banded_matmul", "banded_matvec"):
        record[f"{kernel}_berkeley"]["launches_by_path"] = {
            "paper_pipeline": paths[kernel.removesuffix("_acc")]}


def planted_field(p, q, n, dev, g):
    """wsn-1m's field: q planted local modes — mode k a Gaussian bump (sd 8
    sensors, cut at +-32, unit norm) centred at (k + 1/2) p / q, so its
    outer product lies inside the band and no two modes share a band row —
    with score variances 4, 2, 1, 0.5 and then 0.45 x 0.97^i (the first
    components apart by factors of 2 for the deflated iteration, the
    subspace far above the noise), i.i.d. noise sd 0.01 (the sample
    eigenvectors then lie within ~0.01 rad of the planted modes) and a
    per-sensor mean. Returns the (p, q) modes, their variances and a maker
    of (n, p) batches."""
    j = torch.arange(-32, 33, device=dev)
    bump = torch.exp(-0.5 * (j.float() / 8) ** 2)
    bump /= bump.norm()
    centres = ((torch.arange(q, device=dev) + 0.5) * (p / q)).long()
    U = torch.zeros((p, q), device=dev)
    U[centres[None, :] + j[:, None],
      torch.arange(q, device=dev)[None, :]] = bump[:, None]
    lam = torch.tensor([4.0, 2.0, 1.0, 0.5]
                       + [0.45 * 0.97 ** i for i in range(q - 4)],
                       device=dev)
    mu = 0.5 * torch.randn(p, device=dev, generator=g)

    def batch():
        s = torch.randn((n, q), device=dev, generator=g) * lam.sqrt()
        x = s @ U.T
        x += 0.01 * torch.randn((n, p), device=dev, generator=g)
        return x.add_(mu)

    return U, lam, batch


def subspace_cos(U, V) -> float:
    """The cosine of the largest principal angle between span(U) and
    span(V) (both orthonormal), from fp64."""
    return float(torch.linalg.svdvals(U.T.double() @ V.double()).min())


def wsn1m_production(record, dev, p=WSN_P) -> None:
    """Phase 14, wsn-1m's production steps on one card at its full width
    (configs/wsn_1m.py: p = 1,048,576, h = 128, q = 32, 256-epoch
    batches): four cov_update_steps (kernel 6, the band's add in its
    write-out) on the planted field and banded_estimate; pim_block_step
    (kernel 10) to convergence (the subspace moving less than 1e-4, at
    most 50 steps) and pim_deflated_step (kernel 11) for the first 3
    components (Algorithm 2's rule, d <= 1e-3, at most 50 steps each);
    transform_step.  Checks: no plain call, one launch a step (and one add
    in the kernel a fold); |V^T V - I|; the planted subspace recovered by
    both iterations (largest principal angle, and each deflated component,
    within cos 1 - 1e-3); the scores against fp64; then kernels 6, 10 and
    11 at these shapes against their plain versions (by window) and the
    sharded steps on one NCCL rank equal to the unsharded ones."""
    from repro_torch.core import aggregation as agg
    from repro_torch.core import covariance as cov
    from repro_torch.core import production as prod
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_fleet_process_group
    import torch.distributed as dist
    h, q, n = WSN_H, WSN_Q, WSN_N
    g = torch.Generator(device=dev).manual_seed(1)
    U, lam, batch = planted_field(p, q, n, dev, g)
    V0 = torch.linalg.qr(torch.randn((p, q), device=dev, generator=g)).Q
    v0 = torch.randn(3, p, device=dev, generator=g)
    state = cov.banded_init(p, h, device=dev)
    x0 = batch()
    torch.cuda.synchronize()
    ops.reset_counts()
    t = time.perf_counter()
    for i in range(4):
        state = prod.cov_update_step(state, x0 if i == 0 else batch())
    est = cov.banded_estimate(state)
    torch.cuda.synchronize()
    t_cov = time.perf_counter() - t
    launches_cov, plain = path_counts()
    adds = ops.IN_KERNEL_ADDS["band_round"]    # the band's add in kernel 6
    check(plain == 0 and launches_cov == {"band_round": 4} and adds == 4,
          f"cov_update_step launches {launches_cov}, adds in the kernel "
          f"{adds}, plain {plain}")

    ops.reset_counts()
    t = time.perf_counter()
    V, block_steps, reads = V0, 0, 0
    for _ in range(50):
        V_next, ray = prod.pim_block_step(est, V)
        moved = V_next - V @ (V.T @ V_next)
        moved = float(moved.norm() / q ** 0.5)         # one host read
        V, block_steps, reads = V_next, block_steps + 1, reads + 1
        if moved <= 1e-4:
            break
    W = torch.zeros((p, 0), device=dev)
    defl_steps, lams = [], []
    for k in range(3):
        v = v0[k] / v0[k].norm()
        for s in range(1, 51):
            v_next, lam_k = prod.pim_deflated_step(est, v, W)
            d = float(((v_next * torch.sign(lam_k) - v) ** 2).sum().sqrt())
            v, reads = v_next, reads + 1
            if d <= 1e-3:
                break
        defl_steps.append(s)
        lams.append(float(lam_k))
        W = torch.cat([W, v[:, None]], dim=1)
    torch.cuda.synchronize()
    t_pim = time.perf_counter() - t
    launches_pim, plain = path_counts()
    check(plain == 0 and launches_pim == {"banded_matmul": block_steps,
                                          "banded_matvec": sum(defl_steps)},
          f"pim launches {launches_pim}, plain {plain}")
    mean = state.s / state.t
    ops.reset_counts()
    z = prod.transform_step(V, mean, x0)
    torch.cuda.synchronize()
    check(path_counts() == ({}, 0), "transform_step launched a kernel")
    z64 = (x0.double() - mean.double()) @ V.double()
    z_err = float((z - z64).abs().max())
    del z64
    orth = float((V.T @ V - torch.eye(q, device=dev)).abs().max())
    sub_cos = subspace_cos(U, V)
    defl_cos = (W * U[:, :3]).sum(0).abs().tolist()
    print(f"   wsn-1m p={p} h={h} q={q}: 4 cov_update_steps of {n} epochs "
          f"+ banded_estimate {t_cov:.3f} s; pim_block_step x{block_steps} "
          f"(the subspace moved {moved:.1e} at the last) and "
          f"pim_deflated_step x{defl_steps} {t_pim:.3f} s, {reads} host "
          f"reads; launches {launches_cov} {launches_pim}; plain calls 0")
    print(f"   block: |V^T V - I| {orth:.2e}; planted subspace: cos of the "
          f"largest principal angle {sub_cos:.6f}; Rayleigh quotients "
          f"{ray.sort(descending=True).values[:4].tolist()} (planted "
          f"{lam[:4].tolist()}); deflated: eigenvalues {lams}, |cos| to the "
          f"planted modes {defl_cos}; transform_step ({n}, {q}) vs fp64 "
          f"max err {z_err:.2e}")
    check(orth <= 1e-4, f"|V^T V - I| = {orth}")
    check(sub_cos >= 1 - 1e-3, f"block iteration: subspace cos {sub_cos}")
    check(min(defl_cos) >= 1 - 1e-3, f"deflated: cos {defl_cos}")
    check(z_err <= 1e-3, f"transform_step error {z_err}")
    profile_breakdown(lambda: [prod.pim_block_step(est, V)
                               for _ in range(5)]
                      + [prod.pim_deflated_step(est, v, W[:, :2])
                         for _ in range(20)])

    # the kernels at wsn-1m's shapes against their plain versions
    record["band_round_wsn1m"] = one_slot_fold("band_round_wsn1m", x0, h,
                                               10, 2)
    record["band_round_acc_wsn1m"] = one_slot_acc_fold(
        "band_round_acc_wsn1m", x0, h, 10, 2)
    record["banded_matmul_wsn1m"] = one_slot_product(
        "banded_matmul_wsn1m", est, V.contiguous(), 20, 2)
    record["banded_matvec_wsn1m"] = one_slot_product(
        "banded_matvec_wsn1m", est, v, 20, 2)
    record["band_round_wsn1m"]["launches_by_path"] = {}
    for kernel, n in (("band_round_acc", launches_cov["band_round"]),
                      ("banded_matmul", block_steps),
                      ("banded_matvec", sum(defl_steps))):
        record[f"{kernel}_wsn1m"]["launches_by_path"] = {
            "wsn1m_production": n}
    del x0

    # the sharded steps on one NCCL rank: halo zeros, collectives the
    # identity, kernels 10 and 11 on the padded width p + 2h
    with tempfile.TemporaryDirectory() as store:
        init_fleet_process_group(0, 1, store, device=dev, timeout_s=180)
        try:
            bp = prod.shard_band(est, 0, 1)
            torch.cuda.synchronize()
            ops.reset_counts()
            agg.reset_collectives()
            a = prod.sharded_pim_deflated_step(bp, v, W[:, :2])
            coll_d = dict(agg.COLLECTIVES)
            agg.reset_collectives()
            b = prod.sharded_pim_block_step(bp, V)
            coll_b = dict(agg.COLLECTIVES)
            torch.cuda.synchronize()
            launches, plain = path_counts()
            ua = prod.pim_deflated_step(est, v, W[:, :2])
            ub = prod.pim_block_step(est, V)
            bits = all(torch.equal(x, y) for x, y in zip(a + b, ua + ub))
            close = all(torch.allclose(x, y, rtol=1e-6, atol=1e-7)
                        for x, y in zip(a + b, ua + ub))
            print(f"   sharded steps, one NCCL rank, padded width "
                  f"{bp.shape[1]}: == the unsharded steps (rtol 1e-6) "
                  f"{close}, bit for bit {bits}; collectives deflated "
                  f"{coll_d}, block {coll_b}; launches {launches}")
            check(close, "sharded steps differ from the unsharded ones")
            check(plain == 0 and launches == {"banded_matmul": 1,
                                              "banded_matvec": 1},
                  f"sharded launches {launches}")
            check(coll_d["halo_exchange"] == coll_b["halo_exchange"] == 1
                  and coll_d["all_reduce"] == 2
                  and coll_b["all_reduce"] == 1,
                  f"sharded collectives {coll_d} {coll_b}")
            for name in ("banded_matmul_wsn1m", "banded_matvec_wsn1m"):
                record[name]["launches_by_path"][
                    "wsn1m_production sharded (one rank)"] = 1
        finally:
            dist.destroy_process_group()


def examples_on_card(record) -> None:
    """Phase 15: the six examples (repro_torch.examples) on the card at
    their own configurations, from their seeded draws, through their
    ``main``: each prints the reference example's report (the numbers its
    gate reads) and asserts the gate at the reference's thresholds (the
    quickstart has none; phase 14 holds its ε).  No plain call; each
    kernel's launches recorded under the example's name in
    ``launches_by_path``."""
    from repro_torch.examples import (compression_fleet, event_detection,
                                      event_fleet, faulty_fleet, quickstart,
                                      streaming_pca)
    from repro_torch.kernels import ops
    for mod in (streaming_pca, faulty_fleet, compression_fleet, event_fleet,
                quickstart, event_detection):
        name = mod.__name__.rsplit(".", 1)[1]
        print(f"   -- {name} " + "-" * (60 - len(name)), flush=True)
        torch.cuda.synchronize()
        ops.reset_counts()
        t = time.perf_counter()
        mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches, plain = path_counts()
        print(f"   {name}: main() returned in {wall:.2f} s; launches "
              f"{launches}; plain calls {plain}")
        check(plain == 0, f"{name}: a plain version ran on the card")
        for kernel, n in launches.items():
            record[kernel].setdefault("launches_by_path", {})[name] = n


def checker_on_card() -> None:
    """Phase 16: ``python -m repro_torch.analysis.check --device cuda`` in
    this process — every contract at the engine's widths (with the host
    syncs by call site on the engine's), the kernel calls' traffic, the
    build's and the launches' resource bill against the H100's limits and
    the committed baseline, and the lints; every row must pass."""
    from repro_torch.analysis import check as analysis_check
    rows = analysis_check.run_checks("cuda",
                                     echo=lambda line: print(f"   {line}"))
    failed = [f"{r['contract']}/{r['rule']}" for r in rows if not r["ok"]]
    print(f"   checker: {len(rows) - len(failed)}/{len(rows)} rules pass")
    check(not failed, f"the checker failed: {failed}")


# the LM serving path (phase 17): the six dense and MoE configurations the
# repo ships that fit one card, at full width (configs/llama3p2_1b.py,
# granite_moe_3b.py, qwen2_7b.py, phi3_medium_14b.py, moonshot_v1_16b.py,
# chameleon_34b.py), smallest first, random weights from a seed; the
# reference engine's default ServeConfig (llama3-405b, 810 GB in bf16,
# runs in the dry run only)
LM_ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "qwen2-7b",
            "phi3-medium-14b", "moonshot-v1-16b-a3b", "chameleon-34b")
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW = 8, 512, 16, 32
# the time limit's cut: the four configurations past 5 B parameters serve
# one wave of 8 requests, and one request through the one-slot engine
LM_BIG, LM_BIG_REQUESTS, LM_BIG_ONE_SLOT = 5e9, 8, 1
LM_CUT = 2                 # layers of the card-vs-CPU depth cut
LM_CUT_ATOL = 1e-3         # fp32 both sides, TF32 off: sums in other orders
LM_BUCKET_ATOL = 0.125     # bf16 weights: a padded prefill's other shapes


def _pow2_bucket(eng, s_len: int) -> int:
    return 1 << (max(eng._bucket_len(s_len), 1) - 1).bit_length()


def _lm_burst(eng, prompts, key=_pow2_bucket) -> dict:
    """Serve ``prompts`` (LM_NEW tokens each) through ``eng``; the wall
    time, each prefill's time by ``key(eng, prompt length)`` (by default
    its power-of-two length bucket), and the time of every step that
    decoded all slots and admitted no request."""
    from repro_torch.serve.engine import Request
    prefill_ms: dict = collections.defaultdict(list)
    inner = eng._prefill_slot

    def timed(slot, req):
        t = time.perf_counter()
        inner(slot, req)                 # ends in a host read of the token
        prefill_ms[key(eng, len(req.prompt))].append(
            1e3 * (time.perf_counter() - t))

    eng._prefill_slot = timed
    reqs = [Request(prompt=p, max_new_tokens=LM_NEW) for p in prompts]
    for r in reqs:
        eng.submit(r)
    steps, decode_ms = 0, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while any(not r.done for r in reqs):
        before = sum(map(len, prefill_ms.values()))
        t = time.perf_counter()
        live = eng.step()                # ends in a host read of the tokens
        dt = 1e3 * (time.perf_counter() - t)
        steps += 1
        if live == eng.scfg.slots and sum(map(len, prefill_ms.values())) \
                == before:
            decode_ms.append(dt)
        check(live > 0 or not eng.queue, "the engine stalled")
    wall = time.perf_counter() - t0
    del eng._prefill_slot
    return dict(requests=reqs, wall=wall, steps=steps, decode_ms=decode_ms,
                prefill_ms=dict(prefill_ms))


def _lm_direct(T, params, cfg, prompt, bucket, n_new, dev):
    """A direct prefill (the engine's bucketed one) and greedy decode_step
    loop at one row; the tokens and whether every logit was finite."""
    padded = np.zeros(bucket, np.int32)
    padded[:len(prompt)] = prompt
    state = T.init_decode_state(cfg, 1, LM_MAX_LEN, dtype=torch.float32,
                                device=dev)
    logits, state = T.prefill(params, cfg, torch.tensor(padded[None],
                                                        device=dev),
                              state, valid_len=len(prompt))
    toks, finite = [int(torch.argmax(logits, -1)[0])], []
    finite.append(torch.isfinite(logits).all())
    for t in range(len(prompt), len(prompt) + n_new - 1):
        logits, state = T.decode_step(
            params, cfg, torch.tensor([[toks[-1]]], device=dev), state, t)
        finite.append(torch.isfinite(logits).all())
        toks.append(int(torch.argmax(logits, -1)[0]))
    return toks, bool(torch.stack(finite).all())


def host_free_gb() -> float:
    """The host's available memory (GB), from /proc/meminfo."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def lm_serving(dev, smi: str) -> None:
    """Phase 17: the LM serving path (repro_torch.models,
    repro_torch.serve.engine.Engine) at the full width of the six dense
    and MoE configurations of LM_ARCHS (llama3.2-1b, granite-moe-3b-a800m,
    qwen2-7b with its q/k/v biases, phi3-medium-14b, moonshot-v1-16b-a3b
    with 64 experts top-6, chameleon-34b with QK-norm), random bf16
    weights from a seeded generator on the card (the leaves past 2 GiB in
    fp32 drawn layer block by layer block; the draw's peak printed), one
    model at a time, each freed before the next.

    1. An Engine of 8 slots and a 512-position fp32 cache (the reference's
       ServeConfig) serves 16 requests (8 for the models past LM_BIG
       parameters: the time limit's cut) (prompts of 16-256 tokens from a
       numpy seed, 32 new tokens each) after a one-request warm-up: wall
       time, tokens/s, prefill ms by power-of-two length bucket, the
       decode step's ms at 8 live slots beside its bytes bound (every
       weight but the embedding table, its 8 gathered rows, and the whole
       KV cache read once, over the H100's 3.35 TB/s),
       and the peak memory; 4 more decode steps at 8 live slots under
       torch.profiler (the device's busy share, its largest items).
    2. Two of the requests (one past LM_BIG) through a one-slot engine
       == a direct prefill
       (the engine's bucket) and decode_step loop, token for token; for
       the dense model the bucketed prefill's first token == the
       exact-length prefill's, the logits within LM_BUCKET_ATOL (a first
       token may differ only where the exact logits' top two lie within
       twice the measured difference of each other: a tie at bf16).
    3. The first LM_CUT layers at full width, the same weights in fp32 on
       the card (TF32 off) and on the CPU: the teacher-forced logits of
       ``forward`` within LM_CUT_ATOL (the rest of the model freed first;
       the host's free memory printed before the copy).
    Every request done, every token in [0, vocab), every logit finite, no
    kernel launch and no plain call (the LM path has no Pallas kernel)."""
    from repro_torch import configs
    from repro_torch.analysis.resources import H100
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.params import (DRAW_LIMIT, tree_leaves, tree_map,
                                           tree_size)
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    ops.reset_counts()
    for name in LM_ARCHS:
        cfg = configs.get(name)
        print(f"   -- {name} ({cfg.family}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
              f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
              + (f", {cfg.n_experts} experts top-{cfg.top_k}"
                 if cfg.family == "moe" else "") + ")"
              + (f"; cut for time: {LM_BIG_REQUESTS} requests, "
                 f"{LM_BIG_ONE_SLOT} through the one-slot engine"
                 if cfg.param_count() > LM_BIG else ""), flush=True)
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()    # earlier phases' tensors
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        params = T.init_params(
            cfg, torch.Generator(device=dev).manual_seed(17), device=dev)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t
        n = tree_size(params)
        wbytes = sum(w.numel() * w.element_size()
                     for _, w in tree_leaves(params))
        sliced = [path for path, leaf in tree_leaves(T.model_schema(cfg))
                  if leaf.init == "normal"
                  and 4 * math.prod(leaf.shape) > DRAW_LIMIT]
        draw_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        print(f"   {name}: {n:,} parameters (the schema's leaves; "
              f"param_count() {cfg.param_count():,}), {wbytes / 1e9:.3f} GB "
              f"in {cfg.dtype}, drawn in {draw_s:.2f} s; the draw's peak "
              f"{draw_peak:.3f} GB over the {held / 1e9:.3f} GB held before "
              f"it (the weights {wbytes / 1e9:.3f} GB); drawn in blocks of "
              f"layers: {sliced or 'none'} [{smi}]")
        # the caching allocator rounds each block up to 2 MiB
        slack = 2 ** 21 * (len(tree_leaves(params)) + 1)
        check(draw_peak * 1e9 <= wbytes + DRAW_LIMIT + slack,
              f"{name}: the draw's peak passes the weights and one block")
        check(n == tree_size(T.model_schema(cfg)), f"{name}: parameters")

        rng = np.random.default_rng(17)
        big = cfg.param_count() > LM_BIG
        n_req = LM_BIG_REQUESTS if big else LM_REQUESTS
        lengths = rng.integers(16, 257, n_req)
        prompts = [rng.integers(0, cfg.vocab_size, s).astype(np.int32)
                   for s in lengths]
        scfg = ServeConfig(slots=LM_SLOTS, max_len=LM_MAX_LEN)
        warm = Engine(cfg, params, scfg, device=dev)
        warm.submit(Request(prompt=prompts[0][:16], max_new_tokens=4))
        warm.run_until_done()
        del warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, params, scfg, device=dev)
        run = _lm_burst(eng, prompts)
        reqs = run["requests"]
        tokens = sum(len(r.output) for r in reqs)
        check(all(r.done and len(r.output) == LM_NEW for r in reqs),
              f"{name}: a request not done")
        check(all(0 <= tok < cfg.vocab_size for r in reqs for tok in r.output),
              f"{name}: a token outside the vocabulary")
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        cache = sum(c.numel() * c.element_size() for c in eng.state.attn)
        dms = sorted(run["decode_ms"])
        check(len(dms) > 0, f"{name}: no step at {LM_SLOTS} live slots")
        med = dms[len(dms) // 2]
        # a step reads every weight once but gathers only LM_SLOTS rows of
        # the embedding table
        emb = params["embed"]
        step_w = (wbytes - emb.numel() * emb.element_size()
                  + LM_SLOTS * emb.shape[1] * emb.element_size())
        bound_ms = 1e3 * (step_w + cache) / H100.peak_bytes
        print(f"   {name} engine: {n_req} requests, {tokens} tokens in "
              f"{run['wall']:.3f} s = {tokens / run['wall']:.1f} tokens/s; "
              f"decode step {med:.2f} ms (median of {len(dms)} steps at "
              f"{LM_SLOTS} live slots; min {dms[0]:.2f}, max {dms[-1]:.2f}); "
              f"{run['steps']} steps [{smi}]")
        print(f"   {name}: prefill ms by bucket (prompt length rounded up "
              f"to a power of two; "
              + ("the engine pads to it" if cfg.family == "dense"
                 else "MoE prefills exact lengths") + "): "
              + ", ".join(f"{b}: {np.mean(v):.2f} x{len(v)}"
                          for b, v in sorted(run["prefill_ms"].items())))
        print(f"   {name}: decode step bound {bound_ms:.3f} ms (weights "
              f"{step_w / 1e9:.3f} GB: every leaf but the embedding table, "
              f"and its {LM_SLOTS} gathered rows; + the fp32 KV cache "
              f"{cache / 1e9:.3f} GB; read once at "
              f"{H100.peak_bytes / 1e12:.2f} TB/s); measured "
              f"/ bound {med / bound_ms:.2f}x; peak memory "
              f"{peak:.3f} GB (max_memory_allocated less the "
              f"{held / 1e9:.3f} GB earlier phases hold) [{smi}]")
        del eng

        # where a decode step's time goes: 4 steps at 8 live slots under
        # torch.profiler (device busy share, the largest device items)
        eng = Engine(cfg, params, scfg, device=dev)
        for p_ in prompts[:LM_SLOTS]:
            eng.submit(Request(prompt=p_, max_new_tokens=LM_NEW))
        eng.step()                       # admits every slot
        print(f"   {name}: 4 decode steps at {LM_SLOTS} live slots, "
              f"profiled:")
        profile_breakdown(lambda: [eng.step() for _ in range(4)], top=6)
        del eng

        # 2. two requests: a one-slot engine == the direct loop
        for i in range(LM_BIG_ONE_SLOT if big else 2):
            one = Engine(cfg, params, ServeConfig(slots=1, max_len=LM_MAX_LEN),
                         device=dev)
            req = Request(prompt=prompts[i], max_new_tokens=LM_NEW)
            one.submit(req)
            one.run_until_done()
            direct, finite = _lm_direct(T, params, cfg, prompts[i],
                                        one._bucket_len(len(prompts[i])),
                                        LM_NEW, dev)
            same8 = sum(a == b for a, b in zip(req.output, reqs[i].output))
            print(f"   {name} request {i} (prompt {len(prompts[i])}): "
                  f"one-slot engine == direct prefill + decode_step "
                  f"{req.output == direct} ({LM_NEW} tokens); the 8-slot "
                  f"burst's tokens equal in {same8} of {LM_NEW}")
            check(req.output == direct, f"{name}: engine != direct decode")
            check(finite, f"{name}: a non-finite logit")
            del one
        if cfg.family == "dense":
            eng = Engine(cfg, params, scfg, device=dev)
            for p_ in prompts[:4]:
                bucket = eng._bucket_len(len(p_))
                st = T.init_decode_state(cfg, 1, LM_MAX_LEN,
                                         dtype=torch.float32, device=dev)
                exact, _ = T.prefill(params, cfg,
                                     torch.tensor(p_[None], device=dev), st)
                padded = np.zeros(bucket, np.int32)
                padded[:len(p_)] = p_
                st = T.init_decode_state(cfg, 1, LM_MAX_LEN,
                                         dtype=torch.float32, device=dev)
                bucketed, _ = T.prefill(
                    params, cfg, torch.tensor(padded[None], device=dev), st,
                    valid_len=len(p_))
                diff = float((exact - bucketed).abs().max())
                top2 = exact[0].topk(2).values
                gap = float(top2[0] - top2[1])
                same = int(exact.argmax()) == int(bucketed.argmax())
                print(f"   {name} prompt {len(p_)} (bucket {bucket}): first "
                      f"token equal {same}; logits max |d| {diff:.3e} "
                      f"(tolerance {LM_BUCKET_ATOL}); top-2 gap {gap:.3e}")
                check(bool(torch.isfinite(exact).all()
                           and torch.isfinite(bucketed).all()),
                      f"{name}: a non-finite prefill logit")
                check(diff <= LM_BUCKET_ATOL, f"{name}: bucketed prefill")
                check(same or gap <= 2 * diff,
                      f"{name}: bucketed first token differs off a tie")
            del eng

        # 3. the depth cut, card vs CPU in fp32 (the other layers freed)
        cut = dataclasses.replace(cfg, n_layers=LM_CUT)
        cut_params = dict(params, layers=tree_map(
            lambda a: a[:LM_CUT].clone(), params["layers"]))
        del params
        torch.cuda.empty_cache()
        card = tree_map(lambda a: a.float(), cut_params)
        del cut_params
        cut_bytes = sum(a.numel() * a.element_size()
                        for _, a in tree_leaves(card))
        print(f"   {name}: the cut's fp32 weights {cut_bytes / 1e9:.3f} GB "
              f"to the host, {host_free_gb():.1f} GB free there")
        cpu = tree_map(lambda a: a.cpu(), card)
        toks = rng.integers(0, cfg.vocab_size, (2, 64))
        lc, _ = T.forward(card, cut, torch.tensor(toks, device=dev))
        lh, _ = T.forward(cpu, cut, torch.tensor(toks))
        d = float((lc.cpu() - lh).abs().max())
        print(f"   {name} first {LM_CUT} layers, fp32, (2, 64) tokens: card "
              f"vs CPU logits max |d| {d:.3e} (tolerance {LM_CUT_ATOL}); "
              f"max |logit| {float(lh.abs().max()):.3f}")
        check(bool(torch.isfinite(lc).all()), f"{name}: non-finite logits")
        check(d <= LM_CUT_ATOL, f"{name}: card vs CPU on the depth cut")
        del card, cpu, lc, lh, run, reqs
        torch.cuda.empty_cache()
        print(f"   {name} freed: {torch.cuda.memory_allocated() / 1e9:.3f} "
              f"GB held")
    launches, plain = path_counts()
    print(f"   LM path: kernel launches {launches or 'none'}; plain calls "
          f"{plain}")
    check(plain == 0 and not launches, "the LM path ran a kernel wrapper")


# the LM training path (phase 18): examples/train_lm.py's configuration on
# lm100m at full width and depth (configs/lm100m.py), random bf16 weights
# from a seed; llama3.2-1b (configs/llama3p2_1b.py) at full width too
TRAIN_ARCH, TRAIN_BIG = "lm100m", "llama3.2-1b"
TRAIN_STEPS, TRAIN_WARM, TRAIN_BIG_STEPS, TRAIN_RESUME = 30, 2, 5, 3
TRAIN_RANK = 4             # train_lm --compress
TRAIN_CUT = 2              # layers of lm100m's card-vs-CPU cut
TRAIN_CUT_BATCH = (2, 64)  # its batch (the CPU runs it too)
# fp32 on both sides with TF32 off: the same products and sums in another
# order.  The cut runs without warm-up, so every step moves the weights by
# train_lm's lr.  Its losses are held within TRAIN_CUT_RTOL (measured
# 8.9e-8, an fp32 ulp), and every leaf of the final state within
# TRAIN_CUT_LEAF of the leaf's largest CPU magnitude, as the CPU tests
# hold PowerSGD to the reference: AdamW's moments, the Q factors and the
# error buffers (the gradients' sizes; 5.4e-5 measured) everywhere, the
# parameters at all but TRAIN_CUT_SHARE of their elements.  AdamW divides
# each gradient element by its own size, so where an element is within
# roundoff of 0 at some step its weight may move up to 2 lr one way on the
# card and the other on the CPU (68 of lm100m's 61.7 M; 0 and 1 of the MoE
# smoke's 254,784 over 3 steps and over 1; measured on the H100).
TRAIN_CUT_RTOL = 1e-5
TRAIN_CUT_LEAF = 1e-4
TRAIN_CUT_SHARE = 3e-5
TRAIN_STATE_PARTS = ("params", "opt.mu", "opt.nu", "comp.q", "comp.error")


def _train_config(steps: int, rank: int, ckpt: str | None = None):
    """examples/train_lm.py's TrainConfig (AdamW lr 3e-4, wd 0.01, warmup
    20, remat) for ``steps`` steps, compressed at ``rank`` (0: off)."""
    from repro_torch.examples import train_lm as ex
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig
    return TrainConfig(optimizer=AdamWConfig(lr=ex.LR, weight_decay=ex.WD),
                       warmup_steps=ex.WARMUP, total_steps=steps,
                       compress_rank=rank, checkpoint_dir=ckpt,
                       checkpoint_every=ex.CKPT_EVERY, remat=True)


def _trainer(cfg, tcfg, dev, batch=(8, 256), **kw):
    """A Trainer on ``dev`` over TokenPipeline(seed=0) batches, its weights
    (and Q factors) drawn from a generator seeded 0 unless given."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.train.trainer import Trainer
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=batch[1],
                         global_batch=batch[0], seed=0)
    if "params" not in kw:
        kw["gen"] = torch.Generator(device=dev).manual_seed(0)
    return Trainer(cfg, tcfg, pipe, device=dev, **kw)


def _train_rates(label, cfg, hist, held, smi, batch=(8, 256),
                 flops: float | None = None) -> float:
    """Print a run's step time (median after TRAIN_WARM warm-up steps; a
    step ends in the host read of its metrics), tokens/s, model TFLOP/s
    (``flops`` a step where given, the dry run's meter's count of a plain
    step; else 6 N tokens, N = ``param_count()``) and peak memory beyond
    what earlier phases hold; returns the step ms."""
    secs = sorted(h["seconds"] for h in hist[TRAIN_WARM:])
    ms = 1e3 * secs[len(secs) // 2]
    tokens = batch[0] * batch[1]
    n = cfg.param_count()
    six = 6 * n * tokens
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    count = (f"{flops:.6g} FLOPs a plain step by the dry run's meter; "
             f"6 N D {six:.6g}" if flops else f"6 x {n:,} x {tokens} / step")
    print(f"   {label}: step {ms:.2f} ms (median of {len(secs)} after "
          f"{TRAIN_WARM} warm-up; min {1e3 * secs[0]:.2f}, max "
          f"{1e3 * secs[-1]:.2f}), {tokens / (ms / 1e3):,.0f} tokens/s, "
          f"model {(flops or six) / (ms / 1e3) / 1e12:.2f} TFLOP/s "
          f"({count}); peak memory {peak:.3f} GB [{smi}]")
    return ms


def _loss_falls(label, hist, every: bool = False) -> None:
    losses = [h["loss"] for h in hist]
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    print(f"   {label}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; mean of "
          f"the first 4 {first:.4f}, of the last 4 {last:.4f}; lr "
          f"{hist[0]['lr']:.2e} .. {hist[-1]['lr']:.2e}"
          + (f"; losses {np.round(losses, 4).tolist()}" if every else ""))
    check(all(np.isfinite(losses)), f"{label}: a non-finite loss")
    check(last < first, f"{label}: the loss did not fall")


def _bitwise_resume(label: str, make) -> None:
    """2 x TRAIN_RESUME steps straight == TRAIN_RESUME steps,
    ``save(async_=False)``, a fresh Trainer's ``try_resume``, TRAIN_RESUME
    steps: the losses, parameters and Q factors equal to the bit.
    ``make(ckpt_dir)`` builds a rank-TRAIN_RANK Trainer checkpointing
    there."""
    import os
    from repro_torch.models.params import tree_leaves
    with tempfile.TemporaryDirectory() as d:
        full = make(os.path.join(d, "a"))
        full.run(2 * TRAIN_RESUME, log_every=0)
        part = make(os.path.join(d, "b"))
        part.run(TRAIN_RESUME, log_every=0)
        t = time.perf_counter()
        part.save(async_=False)
        save_s = time.perf_counter() - t
        first = [h["loss"] for h in part.history]
        del part
        res = make(os.path.join(d, "b"))
        t = time.perf_counter()
        check(res.try_resume() and res.state.step == TRAIN_RESUME,
              f"{label} resume")
        load_s = time.perf_counter() - t
        res.run(TRAIN_RESUME, log_every=0)
        size = sum(f.stat().st_size for f in Path(d, "b").rglob("*")
                   if f.is_file())
        same_loss = [h["loss"] for h in full.history] == \
            first + [h["loss"] for h in res.history]
        same_params = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_leaves(full.state.params), tree_leaves(res.state.params)))
        same_q = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_leaves(full.state.comp_state.q),
            tree_leaves(res.state.comp_state.q)) if a is not None)
    print(f"   {label} bitwise resume, rank-{TRAIN_RANK} "
          f"compressed: {2 * TRAIN_RESUME} steps straight vs "
          f"{TRAIN_RESUME} + save ({size / 1e9:.3f} GB in {save_s:.2f} s) + "
          f"a fresh Trainer's resume ({load_s:.2f} s) + {TRAIN_RESUME}: "
          f"losses equal {same_loss}, parameters equal {same_params}, Q "
          f"factors equal {same_q}")
    check(same_loss and same_params and same_q, f"{label} bitwise resume")


def _state_gaps(card, host) -> dict[str, dict]:
    """Two runs' final training states (``train_state_to_numpy``) leaf by
    leaf: for each of TRAIN_STATE_PARTS the largest gap over the leaf's
    largest magnitude on the CPU, the elements beyond TRAIN_CUT_LEAF of it
    and all the elements."""
    check(sorted(card) == sorted(host) and
          int(card["opt.step"]) == int(host["opt.step"]) and
          all(any(k.startswith(part + ".") for k in host)
              for part in TRAIN_STATE_PARTS),
          "card vs CPU: the training states differ in their leaves or step")
    gaps = {}
    for part in TRAIN_STATE_PARTS:
        g = dict(worst=0.0, leaf="", over=0, size=0)
        for k in (k for k in host if k.startswith(part + ".")):
            scale = float(np.max(np.abs(host[k]))) or 1.0
            diff = np.abs(card[k].astype(np.float64) - host[k]) / scale
            if diff.max() > g["worst"]:
                g["worst"], g["leaf"] = float(diff.max()), k[len(part) + 1:]
            g["over"] += int(np.count_nonzero(diff > TRAIN_CUT_LEAF))
            g["size"] += diff.size
        gaps[part] = g
    return gaps


def _train_card_vs_cpu(dev) -> None:
    """3 compressed steps of a TRAIN_CUT-layer fp32 cut of lm100m and of
    granite-moe-3b-a800m's smoke MoE, on the card and on the CPU from the
    same numpy weights, Q factors and tokens, train_lm's AdamW without
    warm-up: each loss within TRAIN_CUT_RTOL, the final state's moments, Q
    factors and error buffers within TRAIN_CUT_LEAF of each leaf's largest
    magnitude, its parameters too at all but TRAIN_CUT_SHARE of their
    elements; the MoE run twice on the card, equal to the bit."""
    from repro_torch import configs
    from repro_torch.convert import (lm_params_from_numpy,
                                     lm_params_to_numpy,
                                     train_state_to_numpy)
    from repro_torch.distributed import compression as GC
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_leaves

    cfg = configs.get(TRAIN_ARCH)
    tcfg = dataclasses.replace(_train_config(3, TRAIN_RANK), warmup_steps=0)
    cuts = (("lm100m 2-layer fp32 cut", dataclasses.replace(
                cfg, n_layers=TRAIN_CUT, dtype="float32")),
            ("granite-moe-3b-a800m smoke",
             configs.get("granite-moe-3b-a800m").smoke()))
    for label, cut in cuts:
        host = T.init_params(cut, torch.Generator().manual_seed(5),
                             device="cpu")
        weights = lm_params_to_numpy(host)
        comp = GC.init_compressor(host, TRAIN_RANK,
                                  torch.Generator().manual_seed(6))
        q = {k: v.numpy() for k, v in tree_leaves(comp.q) if v is not None}
        runs = []
        for d in (dev, torch.device("cpu"),
                  *((dev,) if cut.family == "moe" else ())):
            tr = _trainer(cut, tcfg, d, batch=TRAIN_CUT_BATCH,
                          params=lm_params_from_numpy(cut, weights, d), q=q)
            tr.run(3, log_every=0)
            runs.append(tr)
        lc = np.array([h["loss"] for h in runs[0].history])
        lh = np.array([h["loss"] for h in runs[1].history])
        gap = float(np.max(np.abs(lc - lh) / np.abs(lh)))
        print(f"   {label}: 3 rank-{TRAIN_RANK} steps at "
              f"{TRAIN_CUT_BATCH[0]} x {TRAIN_CUT_BATCH[1]} (lr "
              f"{runs[1].history[0]['lr']:.2e} .. "
              f"{runs[1].history[-1]['lr']:.2e}), card vs CPU losses "
              f"{lc.round(6).tolist()} vs {lh.round(6).tolist()}: max "
              f"relative gap {gap:.3e} (tolerance {TRAIN_CUT_RTOL})")
        check(np.all(np.isfinite(lc)) and gap <= TRAIN_CUT_RTOL,
              f"{label}: card vs CPU losses")
        card = train_state_to_numpy(runs[0].state)
        gaps = _state_gaps(card, train_state_to_numpy(runs[1].state))
        print(f"   {label}: final state card vs CPU, largest gap over each "
              f"leaf's largest magnitude (elements beyond "
              f"{TRAIN_CUT_LEAF} of all): " + ", ".join(
                  f"{part} {g['worst']:.3e} at {g['leaf']} ({g['over']} of "
                  f"{g['size']:,})" for part, g in gaps.items()))
        pars = gaps.pop("params")
        check(all(g["over"] == 0 for g in gaps.values()) and
              pars["over"] <= TRAIN_CUT_SHARE * pars["size"],
              f"{label}: card vs CPU final state")
        if len(runs) == 3:
            again = [h["loss"] for h in runs[2].history] == lc.tolist() \
                and all(np.array_equal(v, card[k]) for k, v in
                        train_state_to_numpy(runs[2].state).items())
            print(f"   {label}: two runs on the card equal to the bit "
                  f"{again}")
            check(again, f"{label}: the card's steps are not repeatable")
        del runs, tr


def lm_training(dev, smi: str) -> None:
    """Phase 18: the LM training path on the card.

    1. lm100m at full width and depth (12 layers, d_model 768, 12 heads /
       4 kv, d_ff 2048, vocab 32,000), random bf16 weights, fp32 moments,
       examples/train_lm.py's TrainConfig on TokenPipeline(seed=0) batches
       of 8 x 256: (a) TRAIN_STEPS steps uncompressed, (b) TRAIN_STEPS
       steps with rank-4 PowerSGD, ``reduce_fn`` an all-reduce mean over a
       one-rank NCCL group; in both the mean loss of the last 4 steps below
       that of the first 4; (c) bitwise resume: 2 x TRAIN_RESUME steps
       straight == TRAIN_RESUME steps, ``save(async_=False)``, a fresh
       Trainer, ``try_resume``, TRAIN_RESUME steps (losses and final
       parameters equal to the bit).
    2. Card vs CPU (:func:`_train_card_vs_cpu`).
    3. llama3.2-1b at full width and depth (bf16), TRAIN_BIG_STEPS steps
       with rank-4 compression.
    4. The SSM, hybrid and encoder-decoder families
       (:func:`family_training`).
    No kernel of the port launches (the training path has no Pallas
    kernel)."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.distributed import compression as GC
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_fleet_process_group

    ops.reset_counts()
    cfg = configs.get(TRAIN_ARCH)
    print(f"   -- {TRAIN_ARCH} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}; {cfg.param_count():,} "
          f"parameters in {cfg.dtype}), batch 8 x 256", flush=True)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()

    # (a) uncompressed
    torch.cuda.reset_peak_memory_stats()
    tr = _trainer(cfg, _train_config(TRAIN_STEPS, 0), dev)
    t = time.perf_counter()
    hist = tr.run(TRAIN_STEPS, log_every=0)
    print(f"   (a) {TRAIN_STEPS} steps uncompressed in "
          f"{time.perf_counter() - t:.2f} s")
    _loss_falls("(a) lm100m", hist)
    _train_rates("(a) lm100m", cfg, hist, held, smi)
    print(f"   (a) lm100m: 2 more steps, profiled:")
    profile_breakdown(lambda: tr.run(2, log_every=0), top=6)
    del tr

    # (b) rank-4 PowerSGD, reduce_fn over a one-rank NCCL group
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as store:
        init_fleet_process_group(0, 1, store, device=dev, timeout_s=180)
        try:
            tr = _trainer(cfg, _train_config(TRAIN_STEPS, TRAIN_RANK), dev,
                          reduce_fn=GC.all_reduce_mean())
            t = time.perf_counter()
            hist = tr.run(TRAIN_STEPS, log_every=0)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    ratio = GC.compression_ratio(tr.state.params, TRAIN_RANK)
    print(f"   (b) {TRAIN_STEPS} steps with rank-{TRAIN_RANK} PowerSGD over "
          f"a one-rank NCCL group in {time.perf_counter() - t:.2f} s; "
          f"compression_ratio {ratio:.6f}")
    _loss_falls("(b) lm100m compressed", hist)
    _train_rates("(b) lm100m compressed", cfg, hist, held, smi)
    del tr

    # (c) bitwise resume
    torch.cuda.empty_cache()
    _bitwise_resume("(c)", lambda ckpt: _trainer(cfg, _train_config(
        TRAIN_STEPS, TRAIN_RANK, ckpt), dev))

    # 2. card vs CPU from the same numpy weights, Q factors and tokens
    _train_card_vs_cpu(dev)

    # 3. llama3.2-1b at full width and depth
    big = configs.get(TRAIN_BIG)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    tr = _trainer(big, _train_config(TRAIN_BIG_STEPS, TRAIN_RANK), dev)
    torch.cuda.synchronize()
    print(f"   -- {TRAIN_BIG} ({big.n_layers} layers, d_model "
          f"{big.d_model}, vocab {big.vocab_size}; {big.param_count():,} "
          f"parameters in {big.dtype}), batch 8 x 256, rank-{TRAIN_RANK} "
          f"PowerSGD; state made in {time.perf_counter() - t:.2f} s",
          flush=True)
    hist = tr.run(TRAIN_BIG_STEPS, log_every=0)
    losses = [h["loss"] for h in hist]
    print(f"   {TRAIN_BIG}: losses {np.round(losses, 4).tolist()}")
    check(all(np.isfinite(losses)), f"{TRAIN_BIG}: a non-finite loss")
    _train_rates(TRAIN_BIG, big, hist, held, smi)
    del tr
    torch.cuda.empty_cache()

    # 4. the SSM, hybrid and encoder-decoder families
    family_training(dev, smi)
    launches, plain = path_counts()
    print(f"   LM training path: kernel launches {launches or 'none'}; "
          f"plain calls {plain}")
    check(plain == 0 and not launches, "the training path ran a kernel "
          "wrapper")


# the SSM, hybrid and encoder-decoder families trained (phase 18, part 4)
# at full width (configs/mamba2_2p7b.py, hymba_1p5b.py,
# seamless_m4t_medium.py), batches of 8 x 256 tokens; mamba2's whole stack
# (2.83 B parameters, ~82 GB at llama3.2-1b's 29 B a parameter) passes
# the card, so it trains its first FAM_TRAIN_LAYERS layers
FAM_TRAIN_ARCHS = ("mamba2-2.7b", "hymba-1.5b", "seamless-m4t-medium")
FAM_TRAIN_LAYERS = {"mamba2-2.7b": 32}
FAM_TRAIN_STEPS = 16
FAM_ENC_FRAMES = 256       # seamless's encoder frames a row
FAM_RESUME_ARCH, FAM_RESUME_LAYERS = "hymba-1.5b", 4    # global and
# windowed layers (windows [0, 0, 1024, 0] at full width)
FAM_TRAIN_CUTS = {         # arch: (layers, (rows, tokens)) of the card-vs-CPU cut
    "mamba2-2.7b": (2, (2, 64)),
    "hymba-1.5b": (2, (2, 128)),          # 128 meta tokens + 128: 2 chunks
    "seamless-m4t-medium": (2, (2, 64)),  # 2 + 2 layers, 64 frames
}


def _fam_batches(cfg, rows: int, length: int, frames: int, dev, seed=0):
    """Batch i: TokenPipeline(seed)'s tokens and, for encdec, ``frames``
    encoder frames a row (numpy normals seeded by i) in the weights'
    dtype."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.transformer import torch_dtype
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=length,
                         global_batch=rows, seed=seed)

    def batch(i):
        out = {"tokens": torch.from_numpy(pipe.batch_at(i)).to(dev)}
        if cfg.family == "encdec":
            enc = np.random.default_rng((seed, i)).standard_normal(
                (rows, frames, cfg.d_model), dtype=np.float32)
            out["enc_input"] = torch.from_numpy(enc).to(
                dev, torch_dtype(cfg.dtype))
        return out
    return batch


def _fam_steps(cfg, tcfg, state, batch, n: int) -> list[dict]:
    """``n`` steps of ``make_train_step(cfg, tcfg)`` on ``state`` (a
    TrainState, updated) over ``batch(i)``; each step's metrics (one host
    read, which waits for the step) and seconds."""
    from repro_torch.train.trainer import _to_host, make_train_step
    step = make_train_step(cfg, tcfg)
    hist = []
    for _ in range(n):
        t = time.perf_counter()
        (state.params, state.opt_state, state.comp_state, m) = step(
            state.params, state.opt_state, state.comp_state,
            batch(state.step), state.step)
        state.step += 1
        rec = _to_host(m)
        rec["seconds"] = time.perf_counter() - t
        hist.append(rec)
    return hist


def _meter_flops(cfg, tcfg, state, batch) -> float:
    """The dry run's meter (launch/dryrun.py) over one more real step of
    ``state`` (updated): that step's FLOPs."""
    from repro_torch.launch import dryrun as D
    from repro_torch.train.trainer import make_train_step
    step = make_train_step(cfg, tcfg)
    b = batch(state.step)
    real = D.measure(lambda p, o, c: step(p, o, c, b, state.step),
                     (state.params, state.opt_state, state.comp_state))
    state.params, state.opt_state, state.comp_state, _ = real.result
    state.step += 1
    del real.result
    torch.cuda.synchronize()
    return real.flops


def _fam_train_cut(cfg, dev) -> None:
    """2 rank-4 PowerSGD steps of an fp32 depth cut (FAM_TRAIN_CUTS) at
    full width, no warm-up, on the card and on the CPU from the same
    weights and Q factors (drawn on the card, carried as numpy) and
    batches (encdec's with its encoder frames): both losses within
    TRAIN_CUT_RTOL, and the state after the first step as
    :func:`_train_card_vs_cpu` holds lm100m's final state (its error
    buffers and moments carry that step's gradients).  Later states are
    not held: at these widths the few weights AdamW moves by +-lr on a
    gradient at roundoff (hundreds to thousands, within TRAIN_CUT_SHARE)
    change the next gradients near them, and PowerSGD's products spread
    that over whole Q factors and error buffers (after 3 steps up to
    1.4e-3 of a leaf's largest magnitude, the first step's gradients
    within 2e-5 of it; measured on the H100)."""
    from repro_torch.convert import (lm_params_from_numpy,
                                     lm_params_to_numpy,
                                     train_state_to_numpy)
    from repro_torch.distributed import compression as GC
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.trainer import TrainState
    n_layers, (rows, length) = FAM_TRAIN_CUTS[cfg.name]
    cut = dataclasses.replace(
        cfg, n_layers=n_layers, dtype="float32",
        enc_layers=n_layers if cfg.family == "encdec" else 0)
    tcfg = dataclasses.replace(_train_config(2, TRAIN_RANK), warmup_steps=0)
    gen = torch.Generator(device=dev).manual_seed(5)
    drawn = T.init_params(cut, gen, device=dev)
    weights = lm_params_to_numpy(drawn)
    comp = GC.init_compressor(drawn, TRAIN_RANK, gen)
    q = {k: v.cpu().numpy() for k, v in tree_leaves(comp.q)
         if v is not None}
    del drawn, comp
    frames = 64 if cfg.family == "encdec" else 0
    runs = {}
    for d in (dev, torch.device("cpu")):
        t = time.perf_counter()
        state = TrainState.create(cut, tcfg, device=d, q=q,
                                  params=lm_params_from_numpy(cut, weights,
                                                              d))
        batch = _fam_batches(cut, rows, length, frames, d)
        hist = _fam_steps(cut, tcfg, state, batch, 1)
        first = {k: np.array(v) for k, v in
                 train_state_to_numpy(state).items()}
        hist += _fam_steps(cut, tcfg, state, batch, 1)
        runs[d.type] = (np.array([h["loss"] for h in hist]), first,
                        time.perf_counter() - t)
        del state
    (lc, card, tc), (lh, host, th) = runs[dev.type], runs["cpu"]
    gap = float(np.max(np.abs(lc - lh) / np.abs(lh)))
    gaps = _state_gaps(card, host)
    print(f"   {cfg.name} {n_layers}-layer fp32 cut"
          + (f" (+ {n_layers} encoder layers, {frames} frames)"
             if frames else "")
          + f": 2 rank-{TRAIN_RANK} steps at {rows} x {length}, card vs CPU "
          f"losses {lc.round(6).tolist()} vs {lh.round(6).tolist()}: max "
          f"relative gap {gap:.3e} (tolerance {TRAIN_CUT_RTOL}); the state "
          f"after step 1, largest gap over each leaf's largest magnitude "
          f"(elements beyond {TRAIN_CUT_LEAF} of all): " + ", ".join(
              f"{part} {g['worst']:.3e} at {g['leaf']} ({g['over']} of "
              f"{g['size']:,})" for part, g in gaps.items())
          + f"; card {tc:.2f} s, CPU {th:.1f} s")
    check(np.all(np.isfinite(lc)) and gap <= TRAIN_CUT_RTOL,
          f"{cfg.name}: card vs CPU training losses")
    pars = gaps.pop("params")
    check(all(g["over"] == 0 for g in gaps.values()) and
          pars["over"] <= TRAIN_CUT_SHARE * pars["size"],
          f"{cfg.name}: card vs CPU training state after a step")


def _fam_resume(cfg, dev) -> None:
    """:func:`_bitwise_resume` on a FAM_RESUME_LAYERS-layer cut of ``cfg``
    at full width (bf16, through Trainer)."""
    from repro_torch.models import transformer as T
    cut = dataclasses.replace(cfg, n_layers=FAM_RESUME_LAYERS)
    torch.cuda.empty_cache()
    _bitwise_resume(
        f"{cfg.name} {FAM_RESUME_LAYERS}-layer cut (windows "
        f"{[int(w) for w in T.layer_windows(cut)]})",
        lambda ckpt: _trainer(cut, _train_config(FAM_TRAIN_STEPS, TRAIN_RANK,
                                                 ckpt), dev))


def family_training(dev, smi: str) -> None:
    """Phase 18, part 4: the SSM, hybrid and encoder-decoder families
    trained on the card at full width (random bf16 weights, fp32
    moments), batches of 8 x 256 TokenPipeline(seed=0) tokens, seamless's
    beside 8 x FAM_ENC_FRAMES encoder frames of d_model (numpy draws; no
    Trainer passes them, as in the reference, so seamless runs through
    ``make_train_step`` alone), examples/train_lm.py's TrainConfig:
    FAM_TRAIN_STEPS steps plain and FAM_TRAIN_STEPS with rank-4
    PowerSGD, through Trainer for mamba2
    (its first FAM_TRAIN_LAYERS layers) and hymba; in each run the mean
    loss of the last 4 steps below that of the first 4; step ms, tokens/s,
    model TFLOP/s (the dry run's meter over one more plain step), peak
    memory and 2 plain steps profiled.  Then each family's fp32 depth cut card
    vs CPU (:func:`_fam_train_cut`) and hymba's bitwise resume
    (:func:`_fam_resume`)."""
    from repro_torch import configs
    from repro_torch.train.trainer import TrainState
    for name in FAM_TRAIN_ARCHS:
        cfg = configs.get(name)
        if name in FAM_TRAIN_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=FAM_TRAIN_LAYERS[name])
        print(f"   -- {name} training ({cfg.family}: {cfg.n_layers} layers"
              + (f" of {configs.get(name).n_layers} (cut)"
                 if name in FAM_TRAIN_LAYERS else "")
              + (f" + {cfg.enc_layers} encoder layers"
                 if cfg.family == "encdec" else "")
              + f", d_model {cfg.d_model}, vocab {cfg.vocab_size}; "
              f"{cfg.param_count():,} parameters in {cfg.dtype}), batch "
              f"8 x 256" + (f" + 8 x {FAM_ENC_FRAMES} frames"
                            if cfg.family == "encdec" else ""), flush=True)
        batch = _fam_batches(cfg, 8, 256, FAM_ENC_FRAMES, dev)
        for rank in (0, TRAIN_RANK):
            label = f"{name} " + (f"rank-{rank} PowerSGD" if rank
                                  else "plain")
            tcfg = _train_config(FAM_TRAIN_STEPS, rank)
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            if cfg.family == "encdec":
                state = TrainState.create(
                    cfg, tcfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
                hist = _fam_steps(cfg, tcfg, state, batch, FAM_TRAIN_STEPS)
            else:
                tr = _trainer(cfg, tcfg, dev)
                hist = tr.run(FAM_TRAIN_STEPS, log_every=0)
                state = tr.state
            print(f"   {label}: {FAM_TRAIN_STEPS} steps in "
                  f"{time.perf_counter() - t:.2f} s (state made and run)")
            _loss_falls(label, hist, every=True)
            if not rank:
                # one more plain step under the meter (its FLOPs serve the
                # compressed run too: PowerSGD's products add ~0.2%)
                t = time.perf_counter()
                flops = _meter_flops(cfg, tcfg, state, batch)
                print(f"   {label}: one more step under the dry run's "
                      f"meter in {time.perf_counter() - t:.2f} s")
            _train_rates(label, cfg, hist, held, smi, flops=flops)
            if not rank:
                print(f"   {label}: 2 more steps, profiled:")
                profile_breakdown(lambda: _fam_steps(cfg, tcfg, state,
                                                     batch, 2), top=6)
            del state, hist
            if cfg.family != "encdec":
                del tr
        torch.cuda.empty_cache()
        t = time.perf_counter()
        _fam_train_cut(configs.get(name), dev)
        print(f"   {name} cut: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _fam_resume(configs.get(FAM_RESUME_ARCH), dev)
    print(f"   {FAM_RESUME_ARCH} resume: {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()


# the SSM, hybrid and encoder-decoder families (phase 19): the three
# configurations the repo ships for them at full width
# (configs/mamba2_2p7b.py, configs/hymba_1p5b.py,
# configs/seamless_m4t_medium.py), random bf16 weights from a seed
FAM_ENGINE_ARCHS = ("mamba2-2.7b", "hymba-1.5b")
FAM_ENC_ARCH = "seamless-m4t-medium"
FAM_CHUNK = 128            # the SSD's prefill chunk: longer prompts tile it
FAM_ENC_ROWS, FAM_ENC_PROMPT, FAM_ENC_FRAMES = 8, 16, 256
FAM_CUT_ATOL = 1e-3        # logits, fp32 both sides, TF32 off
FAM_CUT_LEAF = 1e-4        # each cache leaf, of its largest magnitude
FAM_CUTS = {               # arch: (layers, prompt tokens, rows)
    "mamba2-2.7b": (2, 256, 2),           # two SSD chunks: the scan runs
    "hymba-1.5b": (4, 1280, 1),           # layer 2 windowed; 1,408 positions
    "seamless-m4t-medium": (2, FAM_ENC_PROMPT, 2),    # 2 + 2 layers
}
FAM_CUT_STEPS = 4


def _chunk_key(eng, s_len: int) -> int:
    """A prompt's length rounded up to the SSD chunk."""
    return -(-s_len // FAM_CHUNK) * FAM_CHUNK


def _fam_prompts(cfg, rng) -> list:
    """LM_REQUESTS prompts: for mamba2 lengths in 16-128 and one each of
    256 and 384, in a shuffled order; for hymba 128, 256 or 384 (with its
    128 meta tokens every prompt must tile the SSD's 128-position
    chunks)."""
    if cfg.family == "hybrid":
        lengths = rng.choice([128, 256, 384], LM_REQUESTS)
    else:
        lengths = rng.permutation(np.concatenate(
            [rng.integers(16, 129, LM_REQUESTS - 2), [256, 384]]))
    return [rng.integers(0, cfg.vocab_size, int(s)).astype(np.int32)
            for s in lengths]


def _state_bytes(state) -> dict:
    """A decode state's bytes by field (``attn``, ``ssm``, ``cross_k``,
    ``cross_v``)."""
    out = {}
    for name, field in zip(state._fields, state):
        leaves = [field] if isinstance(field, torch.Tensor) else list(field)
        out[name] = sum(c.numel() * c.element_size() for c in leaves)
    return out


def _decode_bound(params, state, rows: int):
    """The bytes a decode step must move and its bound (ms) at the H100's
    3.35 TB/s: every weight it reads once (all but the embedding table,
    of which its ``rows`` gathered rows, hymba's meta tokens and the
    encoder, which prefill consumed), the KV and cross caches read once,
    the SSM state and conv history read once and written once.  Returns
    (bound ms, weights, attention caches, SSM state, cross caches)."""
    from repro_torch.analysis.resources import H100
    from repro_torch.models.params import tree_leaves
    skip = ("embed", "meta_tokens", "enc_layers.", "enc_final_norm")
    emb = params["embed"]
    w = (sum(a.numel() * a.element_size() for path, a in tree_leaves(params)
             if not path.startswith(skip))
         + rows * emb.shape[1] * emb.element_size())
    sb = _state_bytes(state)
    total = w + sb["attn"] + 2 * sb["ssm"] + sb["cross_k"] + sb["cross_v"]
    return (1e3 * total / H100.peak_bytes, w, sb["attn"], sb["ssm"],
            sb["cross_k"] + sb["cross_v"])


def _fam_cut_vs_cpu(T, cfg, params, dev) -> None:
    """The card against the CPU in fp32 at a depth cut (FAM_CUTS), the
    weights the full model's first layers widened to fp32: a prefill and
    FAM_CUT_STEPS decode steps fed the CPU's greedy tokens, every logit
    within FAM_CUT_ATOL and every cache leaf within FAM_CUT_LEAF of its
    largest magnitude on the CPU, the positions exactly."""
    from repro_torch.convert import decode_state_to_numpy
    from repro_torch.models.params import tree_map
    n_layers, length, rows = FAM_CUTS[cfg.name]
    enc_layers = n_layers if cfg.family == "encdec" else 0
    cut = dataclasses.replace(cfg, n_layers=n_layers, enc_layers=enc_layers)
    card = {k: (tree_map(lambda a: a[:n_layers].float(), v)
                if k in ("layers", "enc_layers")
                else tree_map(lambda a: a.float(), v))
            for k, v in params.items()}
    host = tree_map(lambda a: a.cpu(), card)
    rng = np.random.default_rng(19)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (rows, length)))
    enc_len = FAM_ENC_FRAMES if cfg.family == "encdec" else 0
    enc = (torch.tensor(rng.normal(size=(rows, enc_len, cfg.d_model)),
                        dtype=torch.float32) if enc_len else None)
    runs = {}
    for d, p in ((torch.device("cpu"), host), (dev, card)):
        t = time.perf_counter()
        state = T.init_decode_state(cut, rows, length + FAM_CUT_STEPS,
                                    dtype=torch.float32, device=d,
                                    enc_len=enc_len)
        logits, state = T.prefill(p, cut, toks.to(d), state,
                                  enc_input=None if enc is None
                                  else enc.to(d))
        seq = [logits.cpu()]
        for i in range(FAM_CUT_STEPS):
            # both sides decode the CPU's greedy tokens
            src = seq[-1] if d.type == "cpu" else runs["cpu"][1][i]
            logits, state = T.decode_step(
                p, cut, src.argmax(-1, keepdim=True).to(d), state,
                length + i)
            seq.append(logits.cpu())
        runs[d.type] = (decode_state_to_numpy(state), seq,
                        time.perf_counter() - t)
    (sh, qh, th), (sc, qc, tc) = runs["cpu"], runs[dev.type]
    check(all(bool(torch.isfinite(a).all()) for a in qc),
          f"{cfg.name}: a non-finite logit on the depth cut")
    d_logit = max(float((a - b).abs().max()) for a, b in zip(qc, qh))
    leaf = {}
    for k, v in sh.items():
        if k.endswith("pos"):
            check(np.array_equal(sc[k], v), f"{cfg.name}: the cut's {k}")
        else:
            leaf[k] = float(np.abs(sc[k] - v).max()
                            / (np.abs(v).max() or 1.0))
    print(f"   {cfg.name} cut ({n_layers} layers"
          + (f" + {enc_layers} encoder layers, {enc_len} frames"
             if enc_len else "")
          + (f"; windows {[int(w) for w in T.layer_windows(cut)]}"
             if cfg.family == "hybrid" else "")
          + f"; fp32, {rows} x {length} tokens, {FAM_CUT_STEPS} decode "
          f"steps): card vs CPU logits max |d| {d_logit:.3e} (tolerance "
          f"{FAM_CUT_ATOL}; max |logit| "
          f"{max(float(a.abs().max()) for a in qh):.3f}); "
          "cache leaves max |d| / max |CPU|: "
          + ", ".join(f"{k} {v:.2e}" for k, v in leaf.items())
          + f" (tolerance {FAM_CUT_LEAF}); CPU {th:.1f} s, card {tc:.2f} s")
    check(d_logit <= FAM_CUT_ATOL, f"{cfg.name}: card vs CPU logits")
    check(all(v <= FAM_CUT_LEAF for v in leaf.values()),
          f"{cfg.name}: card vs CPU caches")


def _fam_draw(T, cfg, dev):
    """The model's random bf16 weights on the card, with a line naming its
    shape; (params, the bytes earlier phases hold)."""
    from repro_torch.models.params import tree_leaves, tree_size
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()        # earlier phases' tensors
    t = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(19),
                           device=dev)
    torch.cuda.synchronize()
    n = tree_size(params)
    wbytes = sum(w.numel() * w.element_size()
                 for _, w in tree_leaves(params))
    glob = [int(i) for i in np.flatnonzero(T.layer_windows(cfg) == 0)]
    extra = {"ssm": f"d_inner {cfg.d_inner} in {cfg.n_ssm_heads} heads "
                    f"of {cfg.ssm_headdim}, state {cfg.d_state}",
             "hybrid": f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, d_ff "
                       f"{cfg.d_ff}, SSM {cfg.n_ssm_heads} heads of "
                       f"{cfg.ssm_headdim}, state {cfg.d_state}, "
                       f"{cfg.n_meta_tokens} meta tokens, window "
                       f"{cfg.swa_window}, global layers {glob}",
             "encdec": f"{cfg.enc_layers} encoder layers, {cfg.n_heads} "
                       f"heads / {cfg.n_kv_heads} kv, d_ff "
                       f"{cfg.d_ff}"}[cfg.family]
    print(f"   -- {cfg.name} ({cfg.family}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {extra}, vocab {cfg.vocab_size}): {n:,} "
          f"parameters, {wbytes / 1e9:.3f} GB in {cfg.dtype}, drawn in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    check(n == tree_size(T.model_schema(cfg)), f"{cfg.name}: parameters")
    return params, held


def lm_families(dev, smi: str) -> None:
    """Phase 19: the SSM, hybrid and encoder-decoder families
    (repro_torch.models.ssm and the three branches of
    repro_torch.models.transformer) at the full width of mamba2-2.7b,
    hymba-1.5b and seamless-m4t-medium, random bf16 weights from a seeded
    generator on the card, one model at a time.

    1. mamba2-2.7b and hymba-1.5b through the LM Engine (8 slots, a
       512-position fp32 cache, the SSM state fp32): 16 requests of 32 new
       tokens after a one-request warm-up (mamba2's prompts 16-128 tokens
       and one each of 256 and 384, hymba's 128, 256 or 384, from a numpy
       seed): tokens/s, prefill ms by length (rounded up to the SSD's
       128-position chunk), the decode step's ms at 8 live slots beside
       its bytes bound (:func:`_decode_bound`), the peak memory, and 4
       decode steps profiled; two requests through a one-slot engine ==
       a direct prefill + decode_step loop, token for token.
    2. seamless-m4t-medium, which no Engine serves (as in the reference):
       a batched prefill of 8 rows of 16 tokens beside 256 encoder frames
       of width 1,024 (numpy draws), then 32 greedy decode steps at one
       shared position: the encoder's ms, the prefill's, the decode
       step's beside its bytes bound, the peak memory.
    3. Each model's depth cut in fp32, card vs CPU (:func:`_fam_cut_vs_cpu`).
    Every request done, every token in [0, vocab), every logit finite, no
    kernel launch and no plain call (these paths have no Pallas kernel)."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    ops.reset_counts()
    for name in FAM_ENGINE_ARCHS:
        cfg = configs.get(name)
        params, held = _fam_draw(T, cfg, dev)
        rng = np.random.default_rng(19)
        prompts = _fam_prompts(cfg, rng)
        scfg = ServeConfig(slots=LM_SLOTS, max_len=LM_MAX_LEN)
        warm = Engine(cfg, params, scfg, device=dev)
        warm.submit(Request(prompt=prompts[0], max_new_tokens=4))
        warm.run_until_done()
        del warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, params, scfg, device=dev)
        run = _lm_burst(eng, prompts, key=_chunk_key)
        reqs = run["requests"]
        tokens = sum(len(r.output) for r in reqs)
        check(all(r.done and len(r.output) == LM_NEW for r in reqs),
              f"{name}: a request not done")
        check(all(0 <= tok < cfg.vocab_size for r in reqs
                  for tok in r.output), f"{name}: a token outside the "
              f"vocabulary")
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        dms = sorted(run["decode_ms"])
        check(len(dms) > 0, f"{name}: no step at {LM_SLOTS} live slots")
        med = dms[len(dms) // 2]
        bound_ms, w, attn, ssm, _ = _decode_bound(params, eng.state, LM_SLOTS)
        print(f"   {name} engine: {LM_REQUESTS} requests, {tokens} tokens "
              f"in {run['wall']:.3f} s = {tokens / run['wall']:.1f} "
              f"tokens/s; decode step {med:.2f} ms (median of {len(dms)} "
              f"steps at {LM_SLOTS} live slots; min {dms[0]:.2f}, max "
              f"{dms[-1]:.2f}); {run['steps']} steps [{smi}]")
        print(f"   {name}: prefill ms by prompt length (rounded up to the "
              f"SSD's {FAM_CHUNK}-position chunk; exact lengths"
              + (f", {cfg.n_meta_tokens} meta tokens ahead"
                 if cfg.family == "hybrid" else "") + "): "
              + ", ".join(f"{b}: {np.mean(v):.2f} x{len(v)}"
                          for b, v in sorted(run["prefill_ms"].items())))
        print(f"   {name}: decode step bound {bound_ms:.3f} ms (weights "
              f"{w / 1e9:.3f} GB: every leaf but the embedding table, and "
              f"its {LM_SLOTS} gathered rows"
              + (", not the meta tokens" if cfg.family == "hybrid" else "")
              + (f"; the fp32 KV cache {attn / 1e9:.3f} GB read once"
                 if attn else "")
              + f"; the fp32 SSM state and conv history {ssm / 1e9:.3f} GB "
              f"({ssm / LM_SLOTS / 1e6:.1f} MB a slot) read and written "
              f"once; at 3.35 TB/s); measured / bound {med / bound_ms:.2f}x; "
              f"peak memory {peak:.3f} GB (max_memory_allocated less the "
              f"{held / 1e9:.3f} GB earlier phases hold) [{smi}]")
        del eng

        eng = Engine(cfg, params, scfg, device=dev)
        for p_ in prompts[:LM_SLOTS]:
            eng.submit(Request(prompt=p_, max_new_tokens=LM_NEW))
        eng.step()                       # admits every slot
        print(f"   {name}: 4 decode steps at {LM_SLOTS} live slots, "
              f"profiled:")
        profile_breakdown(lambda: [eng.step() for _ in range(4)], top=6)
        del eng

        for i in (0, 1):
            one = Engine(cfg, params,
                         ServeConfig(slots=1, max_len=LM_MAX_LEN), device=dev)
            req = Request(prompt=prompts[i], max_new_tokens=LM_NEW)
            one.submit(req)
            one.run_until_done()
            direct, finite = _lm_direct(T, params, cfg, prompts[i],
                                        len(prompts[i]), LM_NEW, dev)
            same8 = sum(a == b for a, b in zip(req.output, reqs[i].output))
            print(f"   {name} request {i} (prompt {len(prompts[i])}): "
                  f"one-slot engine == direct prefill + decode_step "
                  f"{req.output == direct} ({LM_NEW} tokens); the 8-slot "
                  f"burst's tokens equal in {same8} of {LM_NEW}")
            check(req.output == direct, f"{name}: engine != direct decode")
            check(finite, f"{name}: a non-finite logit")
            del one
        _fam_cut_vs_cpu(T, cfg, params, dev)
        del params

    # seamless-m4t-medium: a direct batched prefill and decode
    cfg = configs.get(FAM_ENC_ARCH)
    params, held = _fam_draw(T, cfg, dev)
    rng = np.random.default_rng(19)
    rows, s_len = FAM_ENC_ROWS, FAM_ENC_PROMPT
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (rows, s_len)),
                        device=dev)
    frames = torch.tensor(rng.normal(size=(rows, FAM_ENC_FRAMES,
                                           cfg.d_model)),
                          dtype=torch.bfloat16, device=dev)

    def once():
        state = T.init_decode_state(cfg, rows, s_len + LM_NEW,
                                    dtype=torch.float32, device=dev,
                                    enc_len=FAM_ENC_FRAMES)
        t = time.perf_counter()
        logits, state = T.prefill(params, cfg, toks, state, enc_input=frames)
        nxt = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        pre = 1e3 * (time.perf_counter() - t)
        out, finite, steps = [nxt], [torch.isfinite(logits).all()], []
        for i in range(LM_NEW):
            t = time.perf_counter()
            logits, state = T.decode_step(params, cfg, nxt, state, s_len + i)
            nxt = logits.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            steps.append(1e3 * (time.perf_counter() - t))
            out.append(nxt)
            finite.append(torch.isfinite(logits).all())
        return state, pre, steps, torch.cat(out, 1), bool(
            torch.stack(finite).all())

    once()                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    enc_out = T.encode(params, cfg, frames, remat=False)
    torch.cuda.synchronize()
    enc_ms = 1e3 * (time.perf_counter() - t)
    check(bool(torch.isfinite(enc_out).all()), f"{cfg.name}: encoder")
    del enc_out
    state, pre_ms, steps, out, finite = once()
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    check(finite, f"{cfg.name}: a non-finite logit")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"{cfg.name}: a token outside the vocabulary")
    steps = sorted(steps)
    med = steps[len(steps) // 2]
    bound_ms, w, attn, _, cross = _decode_bound(params, state, rows)
    print(f"   {cfg.name} ({rows} rows of {s_len} tokens, {FAM_ENC_FRAMES} "
          f"encoder frames of width {cfg.d_model}): encoder {enc_ms:.2f} ms; "
          f"prefill (encoder included) {pre_ms:.2f} ms; decode step "
          f"{med:.2f} ms (median of {LM_NEW}; min {steps[0]:.2f}, max "
          f"{steps[-1]:.2f}) = {rows * LM_NEW / (sum(steps) / 1e3):.1f} "
          f"tokens/s [{smi}]")
    print(f"   {cfg.name}: decode step bound {bound_ms:.3f} ms (the "
          f"decoder's weights and the head {w / 1e9:.3f} GB with {rows} "
          f"gathered embedding rows; the fp32 self cache {attn / 1e9:.3f} GB "
          f"and cross K/V {cross / 1e9:.3f} GB read once; at 3.35 TB/s); "
          f"measured / bound {med / bound_ms:.2f}x; peak memory "
          f"{peak:.3f} GB (less the {held / 1e9:.3f} GB earlier phases "
          f"hold) [{smi}]")
    del state
    _fam_cut_vs_cpu(T, cfg, params, dev)
    del params
    launches, plain = path_counts()
    print(f"   LM families path: kernel launches {launches or 'none'}; "
          f"plain calls {plain}")
    check(plain == 0 and not launches, "the LM families path ran a kernel "
          "wrapper")


DRYRUN_CELLS = [("llama3.2-1b", "decode_32k"),
                ("granite-moe-3b-a800m", "decode_32k"),
                ("wsn-1m", "pim_block")]
SMOKE_KERNELS = {"cov_update": "band_round", "pim_block": "banded_matmul",
                 "pim_deflated": "banded_matvec"}


def dryrun_on_card(record, dev, smi: str) -> None:
    """Phase 20: the dry run (``repro_torch.launch``) on and for the card.

    1. ``dryrun --smoke``: the five wsn-1m cells at ``WSN.smoke()`` on a
       one-rank NCCL mesh, each ok (within 1e-6 of its largest magnitude
       of the unsharded step, run on CPU copies of the operands through
       the kernels' plain versions), the sharded cov_update, pim_block
       and pim_deflated each launching kernel 6, 10 or 11 once (recorded
       under ``launches_by_path["dryrun_smoke"]``) and no sharded step a
       plain call.
    2. The fake dry run of :data:`DRYRUN_CELLS` on the 16x16 mesh (a fake
       process group of 256 ranks; fake tensors, nothing allocated), one
       row each.
    3. The planner against the card: phase 18's lm100m step (bf16
       weights, fp32 moments, remat, 8 x 256 tokens) run once for real
       under the dry run's meter and torch's ``FlopCounterMode``, then
       planned on a one-rank fake mesh: the FLOPs of all three equal, and
       the planned peak of live bytes within 10% of
       ``max_memory_allocated`` over what earlier phases hold."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import configs
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import analytic as A
    from repro_torch.launch import dryrun as D
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.trainer import make_train_step

    check(not dist.is_initialized(), "no process group left open")
    print("   -- dryrun --smoke: wsn-1m at WSN.smoke(), one NCCL rank")
    for shape in D.WSN_SHAPES:
        ops.reset_counts()
        rec = D.run_cell("wsn-1m", shape, False, smoke=True, device="cuda")
        check(rec["ok"], f"smoke {shape}: {rec.get('error')}")
        # the unsharded step on the CPU (the reference) runs plain versions
        # and launches nothing: every launch is the sharded step's
        launched, _ = path_counts()
        kernel = SMOKE_KERNELS.get(shape)
        want = {kernel: 1} if kernel else {}
        check(rec["launches"] == want == launched
              and rec["plain_calls"] == {},
              f"smoke {shape}: launches {rec['launches']} / {launched}, "
              f"plain {rec['plain_calls']}")
        if kernel:
            by = record[kernel].setdefault("launches_by_path", {})
            by["dryrun_smoke"] = by.get("dryrun_smoke", 0) + 1
        print(f"   smoke {shape:<13s} ok against the unsharded step's "
              f"plain versions on the CPU: max abs err "
              f"{rec['max_abs_err']:.3g}, max rel err "
              f"{rec['max_rel_err']:.3g} of the largest magnitude (tol "
              f"{D.SMOKE_RTOL:g}; bit for bit: {rec['bitwise']}), launches "
              f"{rec['launches']}, peak "
              f"{rec['memory']['peak_per_device'] / 1e6:.3f} MB, "
              f"{rec['total_s']} s [{smi}]")

    print("   -- the fake dry run at 16x16 (256 fake ranks; plan figures "
          "at the H100 SXM5 datasheet's rates)")
    for arch, shape in DRYRUN_CELLS:
        rec = D.run_cell(arch, shape, False)
        check(rec["ok"], f"{arch} {shape}: {rec.get('error')}")
        rl, col = rec["roofline"], rec["collectives"]
        print(f"   {arch} {shape} 16x16: peak "
              f"{rec['memory']['peak_per_device'] / 2**30:.3f} GiB/device, "
              f"{rec['cost']['flops']:.4g} FLOP/device, "
              f"{col['total_wire_bytes'] / 2**20:.1f} MiB wire/device "
              f"({sum(col['counts'].values())} collectives), compute "
              f"{rl['compute_s']:.3g} s, memory {rl['memory_s']:.3g} s, "
              f"collective {rl['collective_s']:.3g} s ({rl['dominant']}); "
              f"ran in {rec['total_s']} s [{smi}]")

    print("   -- the planner against the card: lm100m, 8 x 256")
    cfg = configs.get(TRAIN_ARCH)
    tcfg = _train_config(TRAIN_STEPS, 0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(cfg, gen, device=dev)
    opt = adamw_init(params, tcfg.optimizer)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=256,
                         global_batch=8, seed=0)
    tokens = torch.from_numpy(next(pipe)).to(dev)
    step = make_train_step(cfg, tcfg)
    # torch's own FlopCounterMode over the same step: a count that shares
    # the formulas but not the meter's handling of the dispatch
    with FlopCounterMode(display=False) as counter:
        real = D.measure(lambda p, o, b: step(p, o, None, b, 0),
                         (params, opt, {"tokens": tokens}))
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated() - held
    del params, opt, real.result
    plan = D.plan_train_step(cfg, tcfg, (8, 256))
    gap = plan.peak / card_peak - 1
    # the analytic model's 6 N D + 3 x attention (launch.analytic): it
    # leaves out remat's recomputed forward and counts the embedding
    # table's lookup as a product, so it is printed, not held
    model = (6.0 * cfg.active_param_count() * 8 * 256
             + 3.0 * A._attn_fwd_flops(cfg, 8, 256, 128))
    print(f"   lm100m step: FLOPs counted on the card {real.flops:.6g}, "
          f"by FlopCounterMode {counter.get_total_flops():.6g}, planned "
          f"{plan.flops:.6g} (the analytic 6 N D + 3 attention "
          f"{model:.6g}, ratio {real.flops / model:.4f}); peak on the card "
          f"(max_memory_allocated - held) {card_peak / 1e9:.4f} GB, the "
          f"meter's on the card {real.peak / 1e9:.4f} GB, planned "
          f"{plan.peak / 1e9:.4f} GB ({100 * gap:+.2f}%) [{smi}]")
    check(real.flops == counter.get_total_flops(), "the meter's FLOPs "
          "differ from FlopCounterMode's")
    check(plan.flops == real.flops, "the planned FLOPs differ from the "
          "card's")
    check(abs(gap) <= 0.10, f"the planned peak is {100 * gap:+.1f}% off "
          f"the card's")


# the pipeline schedule (phase 21): llama3.2-1b's full-width layer stack
# (configs/llama3p2_1b.py) as one stage over 8 x 256 embedded tokens
PIPE_ARCH, PIPE_BATCH, PIPE_MICRO, PIPE_REPS = "llama3.2-1b", (8, 256), 4, 2


def pipeline_on_card(dev, smi: str) -> None:
    """Phase 21: ``repro_torch.distributed.pipeline.pipeline_apply`` on a
    one-rank NCCL group.  Its one stage is llama3.2-1b's 16 layers at full
    width (random bf16 weights from a seed), applied by the transformer's
    own layer function (``_layer_fwd`` over the stacked layers), to 8 x
    256 embedded tokens in bf16 in PIPE_MICRO microbatches: the output and
    the gradients of every stage parameter and of x (backpropagating a
    seeded fp32 cotangent) equal, bit for bit, the same layer function
    applied microbatch by microbatch without the pipeline, at the same
    shapes; no point-to-point call (one stage hands nothing on).  The time
    of the forward and backward beside the plain loop's (2 x PIPE_REPS
    each, in turns), and the bubble fraction."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.distributed import pipeline as PP
    from repro_torch.launch.mesh import init_fleet_process_group
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_leaves, unflatten

    cfg = configs.get(PIPE_ARCH)
    B, S = PIPE_BATCH
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(21)
    params = T.init_params(cfg, gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, PIPE_BATCH, device=dev,
                         generator=gen)
    with torch.no_grad():
        x0 = T._embed(params, cfg, toks)
    cot = torch.randn(x0.shape, device=dev, generator=gen)
    flat = [(k, v.detach()) for k, v in tree_leaves(params["layers"])]
    del params
    pos = torch.arange(S, device=dev)

    def layer_fn(p, h):
        for lp in T._unstack(p, cfg.n_layers):
            h, _ = T._layer_fwd(cfg, h, lp, pos, 0)
        return h

    sends = []
    real = dist.batch_isend_irecv

    def counted(ops):
        sends.append(len(ops))
        return real(ops)

    def run(piped: bool):
        leaves = [v.requires_grad_(True) for _, v in flat]
        p = unflatten({k: v for (k, _), v in zip(flat, leaves)})
        x = x0.detach().requires_grad_(True)
        if piped:
            y = PP.pipeline_apply(layer_fn, p, x,
                                  n_microbatches=PIPE_MICRO,
                                  group=dist.group.WORLD)
        else:
            y = torch.cat([layer_fn(p, m) for m in x.chunk(PIPE_MICRO)])
        grads = torch.autograd.grad((y.float() * cot).sum(), [x, *leaves])
        return [y.detach(), *grads]

    with tempfile.TemporaryDirectory() as store:
        init_fleet_process_group(0, 1, store, device=dev, timeout_s=180)
        try:
            dist.batch_isend_irecv = counted
            piped = run(True)
            plain = run(False)
            same = [bool(torch.equal(a, b)) for a, b in zip(piped, plain)]
            del piped, plain
            times = {True: [], False: []}
            for piped_ in (True, False, False, True) * PIPE_REPS:
                torch.cuda.synchronize()
                t = time.perf_counter()
                run(piped_)
                torch.cuda.synchronize()
                times[piped_].append(1e3 * (time.perf_counter() - t))
        finally:
            dist.batch_isend_irecv = real
            dist.destroy_process_group()
    tp, tl = (float(np.median(times[k])) for k in (True, False))
    names = ["output", "x"] + [k for k, _ in flat]
    print(f"   one stage ({cfg.n_layers} layers of {PIPE_ARCH}, d_model "
          f"{cfg.d_model}, bf16) over {B} x {S} embedded tokens in "
          f"{PIPE_MICRO} microbatches on a one-rank NCCL group: output and "
          f"gradients equal to the microbatch loop's bit for bit: "
          f"{sum(same)} of {len(same)}"
          + ("" if all(same) else f" (differ: {[n for n, ok in zip(names, same) if not ok]})")
          + f"; point-to-point calls {sum(sends)}")
    print(f"   forward + backward: pipeline {tp:.2f} ms, microbatch loop "
          f"{tl:.2f} ms (medians of {len(times[True])} and "
          f"{len(times[False])}, in turns; {tp / tl:.3f}x); bubble "
          f"fraction at 1 stage, {PIPE_MICRO} microbatches "
          f"{PP.bubble_fraction(1, PIPE_MICRO):.3f} (at 4 stages "
          f"{PP.bubble_fraction(4, PIPE_MICRO):.3f}) [{smi}]")
    check(all(same), "the pipeline differs from the microbatch loop")
    check(not sends, "a one-stage pipeline issued point-to-point calls")
    del flat, x0, cot
    torch.cuda.empty_cache()


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
    # the work model and bounds (67 TFLOP/s fp32, 3.35 TB/s), the ptxas
    # reader and the host-sync helpers live in repro_torch.analysis; the
    # helpers of this script read them as module globals
    global bound, fold_flops, band_entries, ptxas_summary, sync_sites
    global ALLOWED_SYNCS
    from repro_torch.analysis.op_lint import ALLOWED_SYNCS, sync_sites
    from repro_torch.analysis.resources import (band_entries, bound,
                                                fold_flops, ptxas_summary)
    from repro_torch.core.covariance import band_to_dense, band_valid
    from repro_torch.kernels import build, ops, ref
    from repro_torch.serve.engine import StreamingPCAEngine, StreamRequest
    from repro_torch.streaming import (CompressionConfig, DetectionConfig,
                                       StreamConfig, batched_stream_init,
                                       batched_stream_run)
    from repro_torch.streaming.driver import random_bases, tree_map

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
            if name == "pca_project" and "stage_" in line:   # kernels 4, 5
                check("0 bytes spill stores" in line,
                      f"kernel 4 or 5 spills: {line}")

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
    split_kernels(record, x.reshape(S, R, P), masks, basis, mean, il, eps,
                  g)
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

    def by_path(name, path, n):
        record[name].setdefault("launches_by_path", {})[path] = n

    def serve(config, rounds, label, pipeline=False):
        """Serve every request (request i is region i); returns the steps,
        the launches, the results, the engine and the retirement order."""
        eng = StreamingPCAEngine(config, slots=SLOTS, chunk=K, seed=0,
                                 device="cuda", telemetry=True,
                                 pipeline=pipeline)
        reqs = [StreamRequest(rounds=d[:rounds],
                              liveness=(sched[:rounds] if i >= SLOTS
                                        else None), region=i)
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
        index = {id(r): i for i, r in enumerate(reqs)}
        order = [(index[id(q)], why) for q, why in eng.retired_log]
        return steps, launches, res, eng, order

    steps, launches, res, eng, order4 = serve(cfg, ROUNDS, "stages engine")
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
    by_path("banded_matmul_s1", "engine", retired)
    by_path("banded_matmul", "engine (256 slots)", per_decision * steps)
    worst = max(r.compression_max_err for r in res)
    flagged = sum(r.compression_extra_packets for r in res)
    alarms = sum(r.detection_events for r in res)
    print(f"   worst sink error {worst:.4f} <= eps {EPS} over "
          f"{flagged:.0f} flagged readings; {alarms:.0f} alarmed epochs")
    check(worst <= EPS, "the eps guarantee was broken")
    check(flagged > 0, "no reading flagged")
    by_path("fused_stream", "engine", launches["fused_stream"])
    launches4, res4 = launches, res
    fp32_books = (flagged, sum(r.refreshes for r in res), alarms)
    fleet4 = {qf: eng.fleet_summary(qf) for qf in (Q, 8 * Q)}
    for qf, summ in fleet4.items():
        fleet_yardstick(eng, summ, qf, dev)
    del eng
    profile_breakdown(lambda: serve(cfg, ROUNDS, "profiled stages engine"))

    phase("5 engine: band only")
    band_cfg = StreamConfig(p=P, q=Q, halfwidth=H, forgetting=0.99,
                            warmup_rounds=K - 1, drift_threshold=0.05)
    steps, launches, res5, _, order5 = serve(band_cfg, 16,
                                             "band-only engine")
    check(launches["band_fold"] >= 1 and launches["band_fold_masked"] >= 1
          and launches["band_fold"] + launches["band_fold_masked"] == steps
          and launches["fused_stream"] == 0,
          f"band-only launches {launches} vs {steps} steps")
    launches5 = launches
    for name in ("band_fold", "band_fold_masked"):
        by_path(name, "band-only engine", launches[name])

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
    steps, launches, res, _, _ = serve(split_cfg, ROUNDS,
                                       "split stages engine")
    stage_launches(launches, steps, ("supervised_compress", "pca_monitor"),
                   "split")
    check(launches["pca_project"] == launches["pca_reconstruct"] == 0,
          "split engine launched the quantized-score kernels")
    split_books = sink_books(res, "split")
    for name in ("supervised_compress", "pca_monitor"):
        record[name]["launches_by_path"] = {"split engine": launches[name]}

    phase("7 engine: quantized scores")
    quant_cfg = dataclasses.replace(cfg, compression=CompressionConfig(
        epsilon=EPS, score_bits=8, emit_reconstruction=True))
    steps, launches, res, _, _ = serve(quant_cfg, ROUNDS,
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
    record["pca_monitor"]["launches_by_path"]["quantized engine"] = \
        launches["pca_monitor"]
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
    for name in ("band_round_masked_drop", "banded_matvec"):
        record[name]["launches"] = launches[name]
    for name in ("band_round_masked", "banded_matmul"):
        by_path(name, "per-round fleet", launches[name])
    for name in ("supervised_compress", "pca_monitor"):
        by_path(f"{name}_r32", "per-round fleet", launches[name])
    # phase 8's books of the 192 networks under all-ones masks (phase 13)
    ones8 = (tree_map(lambda t: t[:SLOTS - 64].cpu(), met),
             fin.sched.W[:SLOTS - 64].cpu())
    del fin, met
    profile_breakdown(lambda: fleet_run(cfg, ROUNDS, live,
                                        "profiled per-round fleet"))

    phase("9 per-round fleet: band only")
    _, _, launches = fleet_run(band_cfg, 16, None, "band-only per-round fleet")
    check(launches["band_round"] == 16 and launches["band_round_masked"] == 0
          and launches["band_round_masked_drop"] == 0
          and launches["band_fold"] == launches["band_fold_masked"] == 0,
          f"band-only per-round launches {launches}")
    by_path("band_round", "band-only per-round fleet", launches["band_round"])
    profile_breakdown(lambda: fleet_run(band_cfg, 16, None,
                                        "profiled band-only per-round fleet"))
    del xs

    phase("10 engine: fused stages, bf16 tiles")
    bf16_cfg = dataclasses.replace(cfg, precision="bf16")
    steps, launches, res, _, _ = serve(bf16_cfg, ROUNDS,
                                       "bf16 stages engine")
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

    phase("11 device time of kernels 1 (fp32, bf16), 2-11 and the stage "
          "recompute (torch.profiler)")
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
    del calls, xc
    # kernels 4 and 5 at the engine's chunk and the fleet's round, and the
    # fused body's plain-torch stage recompute (every slot, every step)
    xs4 = torch.randn((SLOTS, K * N, P), device=dev, generator=g)
    ms4 = (torch.rand((SLOTS, K, P), device=dev, generator=g) > 0.05).float()
    mean = 0.1 * torch.randn((SLOTS, P), device=dev, generator=g)
    il = torch.rand((SLOTS, Q), device=dev, generator=g) + 0.5
    shapes = (("", xs4, ms4),
              ("_r32", xs4[:, :N].contiguous(), ms4[:, :1].contiguous()))
    for suffix, xr, mr in shapes:
        for name, (run, *_) in stage_cases(xr, mr, N, wr, mean, il,
                                           2.5).items():
            rec = record[name + suffix]
            rec["device_ms"], names = device_ms(run, 50)
            print(f"   {name}{suffix} (R={xr.shape[1]}): device time a call "
                  f"over 50 calls: kernel {rec['device_ms']:.4f} ms "
                  f"[{names}] (events {rec['ms']:.4f}); bound "
                  f"{rec['bound_ms']:.4f} ms")
    recompute_ms, names = device_ms(
        lambda: ops.fused_stream_stages_blocked(
            xs4.reshape(SLOTS, K, N, P), wr, mean, il, epsilon=2.5,
            with_compress=True, with_monitor=True, mask=ms4), 20)
    print(f"   stage recompute of the fused body (ops.fused_stream_stages_"
          f"blocked, plain torch, S={SLOTS} R={K * N} p={P} q={Q}, both "
          f"stages): device time a step over 20 calls {recompute_ms:.4f} ms "
          f"[{names}]")
    del shapes, xs4, ms4, mean, il, wr
    band = torch.randn((SLOTS, 2 * H + 1, P), device=dev, generator=g) \
        * band_valid(P, H, device=dev)
    V = random_bases(SLOTS, P, Q, seed=6, device=dev).contiguous()
    dense = band_to_dense(band)
    for name, b, v, d in (("banded_matmul", band, V, dense),
                          ("banded_matmul_s1", band[:1].contiguous(),
                           V[:1].contiguous(), dense[:1]),
                          ("banded_matvec", band, V[..., 0].contiguous(),
                           dense)):
        rec = record[name]
        vec = name == "banded_matvec"
        rec["device_ms"], names = device_ms(
            (lambda: ops.banded_matvec(b, v)) if vec
            else (lambda: ops.banded_matmul(b, v)), 50)
        rec["library_device_ms"], lib_names = device_ms(
            (lambda: torch.bmm(d, v[..., None])) if vec
            else (lambda: torch.bmm(d, v)), 50)
        print(f"   {name}: device time a call over 50 calls: kernel "
              f"{rec['device_ms']:.4f} ms [{names}] (events "
              f"{rec['ms']:.4f}); torch.bmm on the dense matrix "
              f"{rec['library_device_ms']:.4f} ms [{lib_names}] (events "
              f"{rec['library_ms']:.4f})")
    del band, V, dense

    phase("12 engine: pipelined staging (pinned buffers, copy stream)")
    # the synchronous and the pipelined engine back to back, in turns
    # (sync, pipelined, pipelined, sync); each equal to phase 4 bit for bit
    eng = pipelined = None
    for label, pipe in (("sync stages engine", False),
                        ("pipelined stages engine", True),
                        ("pipelined stages engine, again", True),
                        ("sync stages engine, again", False)):
        steps, launches, res, e, order = serve(cfg, ROUNDS, label,
                                               pipeline=pipe)
        bad = different_fields(res4, res)
        folded = [r for r in e.telemetry.steps if r.live > 0]
        print(f"   {label} vs phase 4: StreamResult fields that differ "
              f"{bad or 'none'}; retirement order equal {order == order4}; "
              f"launches equal {launches == launches4}; prestage hits "
              f"{e._prestage_hits}, misses {e._prestage_misses}, transfer "
              f"fences {e._transfer_fences}; pulls {e.pulls}; staging "
              f"{sum(r.stage_s for r in folded):.3f} s of host time, "
              f"{sum(r.overlap_s for r in folded):.3f} s of it after the "
              f"dispatch")
        check(not bad and order == order4, f"{label} differs from phase 4")
        check(launches == launches4, f"{label}: launches {launches} != "
              f"phase 4's {launches4}")
        if pipe:
            check(e.pulls["hot"] == 0 and e._prestage_hits >= 1,
                  f"{label}: a hot pull or no prestage hit")
        if pipe and eng is None:
            eng, pipelined = e, (launches, len(res))
        del e
    # the counts of the first pipelined run, its own counts reset before it
    launches, n_res = pipelined
    by_path("fused_stream", "pipelined engine", launches["fused_stream"])
    by_path("banded_matmul", "pipelined engine (256 slots)",
            launches["banded_matmul"] - n_res)
    by_path("banded_matmul_s1", "pipelined engine", n_res)
    for qf, summ in fleet4.items():
        again = eng.fleet_summary(qf)
        bad = different_fields([summ], [again])
        print(f"   fleet_summary(q_fleet={qf}) of the pipelined engine == "
              f"phase 4's: fields that differ {bad or 'none'}; merge pulls "
              f"{eng.pulls['merge']}")
        check(not bad, f"fleet_summary({qf}) differs between the engines")
        fleet_yardstick(eng, again, qf, dev)
    del eng, fleet4
    mean = lambda label, i: (rates[label][i] + rates[f"{label}, again"][i]) / 2
    print(f"   pipelined vs sync (back to back, in turns, means of two): "
          f"{mean('pipelined stages engine', 0):.1f} vs "
          f"{mean('sync stages engine', 0):.1f} rounds/s, step "
          f"{mean('pipelined stages engine', 1):.1f} vs "
          f"{mean('sync stages engine', 1):.1f} ms")
    profile_breakdown(lambda: serve(cfg, ROUNDS,
                                    "profiled pipelined stages engine",
                                    pipeline=True))
    steps, launches, res, _, order = serve(band_cfg, 16,
                                           "pipelined band-only engine",
                                           pipeline=True)
    bad = different_fields(res5, res)
    print(f"   pipelined band-only engine vs phase 5: StreamResult fields "
          f"that differ {bad or 'none'}; retirement order equal "
          f"{order == order5}; launches equal {launches == launches5}")
    check(not bad and order == order5 and launches == launches5,
          "pipelined band-only engine differs from phase 5")
    for name in ("band_fold", "band_fold_masked"):
        by_path(name, "pipelined band-only engine", launches[name])
    del res, res5
    # the host syncs of the pipelined loop, by call site (a run of its
    # own: the warnings cost host time), from the first step to the last
    eng = StreamingPCAEngine(cfg, slots=SLOTS, chunk=K, seed=0,
                             device="cuda", telemetry=True, pipeline=True)
    for i, d in enumerate(data):
        eng.submit(StreamRequest(rounds=d, region=i, liveness=(
            sched if i >= SLOTS else None)))
    sites = sync_sites(eng.run_until_done)
    steps = sum(1 for r in eng.telemetry.steps if r.live > 0)
    print(f"   host syncs of the pipelined engine over {steps} steps and "
          f"{len(eng.retired_log)} retirements "
          f"(torch.cuda.set_sync_debug_mode), by call site:")
    for site, n in sorted(sites.items()):
        print(f"     {n:5d} ({n / steps:.1f} a step)  {site}")
    del eng
    stray = [site for site in sites
             if not any(a in site for a in ALLOWED_SYNCS)]
    check(not stray, f"unexpected host syncs in the engine loop: {stray}")
    check(any("x.cpu()" in site for site in sites),
          "the retirement pull did not show as a sync: is the debug mode on?")

    phase("13 distributed drivers on one card (NCCL, one rank)")
    from repro_torch.launch.mesh import (init_fleet_process_group,
                                         make_fleet_mesh)
    from repro_torch.streaming import (hierarchical_stream_run,
                                       sharded_stream_run)
    from repro_torch.streaming.hierarchy import COLLECTIVES, reset_collectives
    import torch.distributed as dist
    xs = torch.from_numpy(np.stack(data[:SLOTS])).to(dev)
    with tempfile.TemporaryDirectory() as store:
        init_fleet_process_group(0, 1, store, device="cuda", timeout_s=180)
        try:
            mesh = make_fleet_mesh()
            st = batched_stream_init(cfg, SLOTS, seed=0, device="cuda")
            torch.cuda.synchronize()
            ops.reset_counts()
            reset_collectives()
            t = time.perf_counter()
            fin, met = sharded_stream_run(cfg, mesh.data, st, xs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = dict(ops.LAUNCHES)
            print(f"   sharded per-round fleet: {SLOTS} networks x {ROUNDS} "
                  f"rounds in {wall:.2f} s = {SLOTS * ROUNDS / wall:.1f} "
                  f"rounds/s, {1e3 * wall / ROUNDS:.1f} ms a round; "
                  f"collectives {COLLECTIVES}; launches "
                  f"{ {k: v for k, v in launches.items() if v} }")
            check(sum(COLLECTIVES.values()) == 0
                  and sum(ops.PLAIN_CALLS.values()) == 0
                  and launches["band_round"] == ROUNDS
                  and launches["supervised_compress"] == ROUNDS
                  and launches["pca_monitor"] == ROUNDS
                  and launches["banded_matmul"] == ROUNDS * per_decision,
                  f"sharded run: collectives {COLLECTIVES}, launches "
                  f"{launches}")
            by_path("band_round", "sharded per-round fleet",
                    launches["band_round"])
            by_path("banded_matmul", "sharded per-round fleet",
                    launches["banded_matmul"])
            for name in ("supervised_compress", "pca_monitor"):
                by_path(f"{name}_r32", "sharded per-round fleet",
                        launches[name])
            fin_b, met_b = batched_stream_run(cfg, st, xs)
            bad = []
            for label, a, b in (("states", fin, fin_b),
                                ("metrics", met, met_b)):
                pairs = []
                tree_map(lambda u, v: pairs.append(torch.equal(u, v)), a, b)
                if not all(pairs):
                    bad.append(label)
            print(f"   sharded run == batched_stream_run on the same inputs "
                  f"bit for bit: {not bad} (differ: {bad or 'none'})")
            check(not bad, f"sharded run differs from batched: {bad}")
            m8, W8 = ones8
            same8 = {}
            for f in ("rho", "did_refresh", "refreshes", "comm_packets"):
                same8[f] = torch.equal(getattr(met, f)[:SLOTS - 64].cpu(),
                                       getattr(m8, f))
            same8["compression.extra_packets"] = torch.equal(
                met.compression.extra_packets[:SLOTS - 64].cpu(),
                m8.compression.extra_packets)
            same8["detection.alarms"] = torch.equal(
                met.detection.alarms[:SLOTS - 64].cpu(), m8.detection.alarms)
            same8["W"] = torch.equal(fin.sched.W[:SLOTS - 64].cpu(), W8)
            print(f"   the {SLOTS - 64} networks phase 8 streamed under "
                  f"all-ones masks, unmasked here: equal to phase 8 bit for "
                  f"bit {same8}")
            del fin, met, fin_b, met_b, ones8
            q_fleet = 8 * Q
            torch.cuda.synchronize()
            ops.reset_counts()
            reset_collectives()
            t = time.perf_counter()
            fin, met, fleet = hierarchical_stream_run(
                cfg, mesh.region, st, xs, live, q_fleet=q_fleet, chunk=K)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = dict(ops.LAUNCHES)
            decisions = met.rho.shape[1]
            print(f"   hierarchical run: {SLOTS} regions x {ROUNDS} rounds "
                  f"(p={P} each, chunk {K}) in {wall:.2f} s = "
                  f"{SLOTS * ROUNDS / wall:.1f} rounds/s; collectives "
                  f"{COLLECTIVES}; launches "
                  f"{ {k: v for k, v in launches.items() if v} }")
            check(COLLECTIVES == {"all_gather": 1, "all_reduce": 1},
                  f"hierarchical run collectives {COLLECTIVES}")
            check(sum(ops.PLAIN_CALLS.values()) == 0
                  and launches["fused_stream"] == decisions
                  and launches["banded_matmul"]
                  == decisions * per_decision + 1,
                  f"hierarchical run launches {launches} vs {decisions} "
                  f"chunk steps")
            by_path("fused_stream", "hierarchical run",
                    launches["fused_stream"])
            by_path("banded_matmul", "hierarchical run",
                    launches["banded_matmul"])
            table = fleet.basis.lam_table.cpu().numpy()
            order = np.argsort(-table.reshape(-1), kind="stable")[:q_fleet]
            region = fleet.basis.region.cpu().numpy()
            col = fleet.basis.col.cpu().numpy()
            lam = fleet.basis.lam.cpu().numpy()
            check(np.array_equal(region, order // Q)
                  and np.array_equal(col, order % Q)
                  and np.array_equal(lam, table.reshape(-1)[order]),
                  "hierarchical merge differs from numpy's selection")
            epochs = int(fleet.merge_epochs)
            fired = int(met.did_refresh.any(0).sum())
            print(f"   merge: == numpy stable argsort of the gathered "
                  f"({table.shape[0]}, {table.shape[1]}) table; rho "
                  f"{float(fleet.basis.rho):.6f}, {len(set(region.tolist()))} "
                  f"regions chosen; merge epochs {epochs} (boundaries with a "
                  f"refresh {fired}), merge packets "
                  f"{float(fleet.merge_packets)}")
            check(epochs == max(fired, 1), "merge epochs")
            del fin, met, fleet, st
        finally:
            dist.destroy_process_group()
    del xs, live

    phase("14 the paper's pipeline (core/, sensors/): the Berkeley "
          "deployment and wsn-1m's production steps")
    t14 = time.perf_counter()
    paper_pipeline(record, dev)
    wsn1m_production(record, dev)
    print(f"   phase 14: {time.perf_counter() - t14:.1f} s")

    phase("15 the examples (repro_torch.examples) at their configurations")
    t15 = time.perf_counter()
    examples_on_card(record)
    print(f"   phase 15: {time.perf_counter() - t15:.1f} s")

    phase("16 the checker (repro_torch.analysis.check --device cuda)")
    t16 = time.perf_counter()
    checker_on_card()
    print(f"   phase 16: {time.perf_counter() - t16:.1f} s")

    phase("17 LM serving (dense and MoE) at full width")
    t17 = time.perf_counter()
    lm_serving(dev, smi)
    print(f"   phase 17: {time.perf_counter() - t17:.1f} s")

    phase("18 LM training (dense and MoE): lm100m at full width, "
          "llama3.2-1b")
    t18 = time.perf_counter()
    lm_training(dev, smi)
    print(f"   phase 18: {time.perf_counter() - t18:.1f} s")

    phase("19 LM families (SSM, hybrid, encoder-decoder) at full width")
    t19 = time.perf_counter()
    lm_families(dev, smi)
    print(f"   phase 19: {time.perf_counter() - t19:.1f} s")

    phase("20 the dry run (repro_torch.launch): smoke cells on the card, "
          "fake 16x16 cells, the planner against the card")
    t20 = time.perf_counter()
    dryrun_on_card(record, dev, smi)
    print(f"   phase 20: {time.perf_counter() - t20:.1f} s")

    phase("21 the pipeline schedule (repro_torch.distributed.pipeline) "
          "on a one-rank NCCL group")
    t21 = time.perf_counter()
    pipeline_on_card(dev, smi)
    print(f"   phase 21: {time.perf_counter() - t21:.1f} s")

    print(f"   total {time.perf_counter() - t_start:.1f} s")
    for rec in record.values():
        if "launches_by_path" in rec:
            rec["launches"] = sum(rec["launches_by_path"].values())
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0],
             replaces=KERNELS[name][1], launches=rec["launches"],
             max_abs_err=rec["max_abs_err"], ms=rec["ms"],
             plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
             bound_by=rec["bound_by"], library_ms=rec.get("library_ms"),
             **{k: rec[k] for k in ("cast_ms", "cast_bound_ms", "device_ms",
                                    "library_device_ms", "two_step_ms",
                                    "two_step_device_ms", "launches_by_path")
                if k in rec})
        for name, rec in record.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
