"""End-to-end driver: train the ~100M-parameter LM for a few hundred steps
(counterpart of ``examples/train_lm.py``).

Demonstrates the full training substrate: deterministic data pipeline,
AdamW + warmup-cosine, remat, fault-tolerant checkpointing (kill the process
and rerun — it resumes bitwise), and the paper's technique as gradient
compression (--compress enables rank-4 PowerIter compression with error
feedback).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \\
          [--compress] [--small] [--ckpt-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.runtime.health import HealthMonitor
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer

BATCH, SEQ, LR, WD, WARMUP, RANK, CKPT_EVERY = 8, 256, 3e-4, 0.01, 20, 4, 50


def run(device="cuda", steps: int = 200, batch: int = BATCH,
        seq: int = SEQ, compress: bool = False, small: bool = False,
        ckpt_dir: str | None = None, log_every: int = 10) -> dict:
    """Train (resuming from ``ckpt_dir``'s latest checkpoint if there is
    one) up to ``steps``; returns the per-step history, the step resumed
    from, the parameter count and the wall time."""
    dev = resolve_device(device)
    cfg = configs.get("lm100m")
    if small:
        cfg = cfg.smoke()
    pipeline = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=seq,
                             global_batch=batch, seed=0)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=LR, weight_decay=WD),
        warmup_steps=WARMUP, total_steps=steps,
        compress_rank=RANK if compress else 0,
        checkpoint_dir=ckpt_dir, checkpoint_every=CKPT_EVERY, remat=True)
    trainer = Trainer(cfg, tcfg, pipeline, gen=0,
                      health_monitor=HealthMonitor(), device=dev)
    resumed = trainer.state.step if trainer.try_resume() else None
    t0 = time.perf_counter()
    hist = trainer.run(steps - trainer.state.step, log_every=log_every)
    seconds = time.perf_counter() - t0
    trainer.save(async_=False)
    return dict(cfg=cfg, history=hist, resumed_from=resumed,
                params=cfg.param_count(), seconds=seconds,
                stragglers=trainer.health.straggler_count(), device=dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--compress", action="store_true",
                    help="rank-4 PowerIter gradient compression")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm100m_ckpt"))
    ap.add_argument("--small", action="store_true",
                    help="smoke-size model (CI)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = configs.get("lm100m")
    cfg = cfg.smoke() if args.small else cfg
    print(f"arch {cfg.name}: {cfg.param_count()/1e6:.0f}M params; "
          f"compress={'rank-4 PowerIter' if args.compress else 'off'}")
    out = run(args.device, args.steps, args.batch, args.seq, args.compress,
              args.small, args.ckpt_dir)
    if out["resumed_from"] is not None:
        print(f"resumed from step {out['resumed_from']}")
    hist, dev = out["history"], out["device"]
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU")
    if hist:
        print(f"\nloss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
              f"over {len(hist)} steps in {out['seconds']:.1f} s on {where}")
    if out["stragglers"]:
        print(f"stragglers observed: {out['stragglers']}")
    print("checkpoint saved; rerun to resume.")


if __name__ == "__main__":
    main()
