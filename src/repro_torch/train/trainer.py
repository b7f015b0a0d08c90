"""Training loop: step builder with microbatching, mixed precision,
PCA/power-iteration gradient compression, checkpoint/resume, health hooks
(counterpart of ``repro.train.trainer``).

The step is a plain function of (params, optimizer state, compressor
state, batch, step) that runs eagerly on the parameters' device; the
:class:`Trainer` owns the impure parts (data cursor, checkpoint IO,
heartbeats).  Gradients come from ``torch.autograd.grad`` on detached
copies of the parameter leaves, so no ``.grad`` accumulates anywhere;
AdamW then writes the parameters and moments in place.  Data-parallel
replicas pass ``reduce_fn`` (``distributed.compression.all_reduce_mean``
over their group): inside the compressor, or on every gradient when
compression is off.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import compression as GC
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, tree_map, unflatten
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.optimizer import (AdamWConfig, AdamWState, adamw_init,
                                         adamw_update, warmup_cosine)

__all__ = ["TrainConfig", "TrainState", "make_train_step", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatches: int = 1          # gradient accumulation
    accum_dtype: str = "float32"   # bf16 for memory-bound giants (405b)
    compress_rank: int = 0         # 0 = off; >0 enables PowerIter compression
    remat: bool = True
    remat_groups: int = 0          # >1: nested (two-level) remat
    checkpoint_dir: str | None = None
    checkpoint_every: int = 100
    keep_checkpoints: int = 3


class TrainState:
    """Mutable bundle: params, optimizer, compressor, step counter."""

    def __init__(self, params, opt_state: AdamWState, comp_state, step: int):
        self.params = params
        self.opt_state = opt_state
        self.comp_state = comp_state
        self.step = step

    @classmethod
    def create(cls, cfg, tcfg: TrainConfig,
               gen: torch.Generator | int = 0, dtype=None,
               device: str | torch.device = "cuda", params=None,
               q: Mapping[str, np.ndarray] | None = None) -> "TrainState":
        """Fresh state on ``device``: ``params`` if given (a tree of
        tensors there), else drawn from ``gen`` (a generator on the device,
        or a seed) in ``dtype`` (default ``cfg.dtype``); the compressor's Q
        factors from ``q`` if given, else drawn from ``gen`` after the
        parameters."""
        dev = resolve_device(device)
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        if params is None:
            params = T.init_params(cfg, gen, dtype=dtype, device=dev)
        opt = adamw_init(params, tcfg.optimizer)
        comp = (GC.init_compressor(params, tcfg.compress_rank, gen, q=q)
                if tcfg.compress_rank else None)
        return cls(params, opt, comp, 0)


def _value_and_grad(cfg, tcfg: TrainConfig, params, batch):
    """(loss, metrics, grads) of ``lm_loss`` at ``params``; a parameter
    the loss does not reach gets a zero gradient, as under JAX."""
    flat = tree_leaves(params)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for _, p in flat]
        tree = unflatten({path: x for (path, _), x in zip(flat, leaves)})
        loss, metrics = T.lm_loss(tree, cfg, batch, remat=tcfg.remat,
                                  remat_groups=tcfg.remat_groups)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = unflatten({path: torch.zeros_like(p) if g is None else g
                       for (path, p), g in zip(flat, grads)})
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg, tcfg: TrainConfig,
                    reduce_fn: Callable | None = None):
    """Returns step(params, opt_state, comp_state, batch, step) -> (...)

    ``reduce_fn`` is the data-parallel gradient reduction used *inside* the
    compressor (or on every gradient without compression); None on one
    replica.
    """

    def step_fn(params, opt_state, comp_state, batch, step):
        if tcfg.microbatches > 1:
            tokens = batch["tokens"]
            mb = tokens.shape[0] // tcfg.microbatches
            accum_dt = T.torch_dtype(tcfg.accum_dtype)
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=accum_dt),
                            params)
            lsum = 0.0
            for i in range(tcfg.microbatches):
                mbatch = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, _, g = _value_and_grad(cfg, tcfg, params, mbatch)
                flat_g = dict(tree_leaves(g))
                for path, acc in tree_leaves(gsum):
                    acc.add_(flat_g[path])
                lsum = lsum + l
            grads = tree_map(lambda g: g / tcfg.microbatches, gsum)
            loss = lsum / tcfg.microbatches
            metrics = {}
        else:
            loss, metrics, grads = _value_and_grad(cfg, tcfg, params, batch)

        if comp_state is not None:
            grads, comp_state = GC.compress_gradients(grads, comp_state,
                                                      reduce_fn)
        elif reduce_fn is not None:
            grads = tree_map(reduce_fn, grads)

        lr = warmup_cosine(step, peak_lr=tcfg.optimizer.lr,
                           warmup=tcfg.warmup_steps, total=tcfg.total_steps)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, tcfg.optimizer, lr)
        out_metrics = {"loss": loss, "lr": lr, **opt_metrics, **metrics}
        return params, opt_state, comp_state, out_metrics

    return step_fn


def _to_host(metrics: dict) -> dict:
    """Every metric as a float, with one read from the device."""
    on_dev = [k for k, v in metrics.items() if v.device.type != "cpu"]
    out = {k: float(v) for k, v in metrics.items() if k not in on_dev}
    if on_dev:
        out.update(zip(on_dev, torch.stack(
            [metrics[k].float() for k in on_dev]).tolist()))
    return out


class Trainer:
    """Drives the step; owns checkpointing, resume and health hooks.

    ``gen`` (a generator on ``device``, or a seed) draws the parameters and
    then the compressor's Q factors, unless ``params`` (a tree of tensors
    on ``device``) and ``q`` (dotted path -> array) are given.
    ``reduce_fn`` averages the gradients over data-parallel replicas.
    """

    def __init__(self, cfg, tcfg: TrainConfig, pipeline, *,
                 gen: torch.Generator | int = 0, dtype=None,
                 health_monitor=None, device: str | torch.device = "cuda",
                 params=None, q: Mapping[str, np.ndarray] | None = None,
                 reduce_fn: Callable | None = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.pipeline = pipeline
        self.health = health_monitor
        self.device = resolve_device(device)
        self.state = TrainState.create(cfg, tcfg, gen, dtype=dtype,
                                       device=self.device, params=params,
                                       q=q)
        self._step_fn = make_train_step(cfg, tcfg, reduce_fn)
        self.history: list[dict] = []

    def _tree(self) -> dict:
        return {"params": self.state.params,
                "opt": self.state.opt_state,
                "comp": self.state.comp_state}

    # -- fault tolerance ----------------------------------------------------
    def save(self, async_: bool = True) -> None:
        if not self.tcfg.checkpoint_dir:
            return
        extra = {"step": self.state.step,
                 "data": self.pipeline.state_dict()}
        fn = CKPT.save_async if async_ else CKPT.save
        fn(self.tcfg.checkpoint_dir, self.state.step, self._tree(),
           extra=extra, keep=self.tcfg.keep_checkpoints)

    def try_resume(self) -> bool:
        d = self.tcfg.checkpoint_dir
        if not d or CKPT.latest_step(d) is None:
            return False
        tree, extra = CKPT.restore(d, self._tree())
        self.state.params = tree["params"]
        self.state.opt_state = tree["opt"]
        self.state.comp_state = tree["comp"]
        self.state.step = int(extra["step"])
        self.pipeline.load_state_dict(extra["data"])
        return True

    # -- loop ----------------------------------------------------------------
    def run(self, n_steps: int, log_every: int = 10) -> list[dict]:
        for _ in range(n_steps):
            t0 = time.perf_counter()
            tokens = next(self.pipeline)
            batch = {"tokens": torch.from_numpy(tokens).to(self.device)}
            (self.state.params, self.state.opt_state, self.state.comp_state,
             metrics) = self._step_fn(self.state.params,
                                      self.state.opt_state,
                                      self.state.comp_state, batch,
                                      self.state.step)
            self.state.step += 1
            rec = _to_host(metrics)             # waits for the step
            dt = time.perf_counter() - t0
            if self.health is not None:
                self.health.heartbeat(step=self.state.step, duration=dt)
            rec.update(step=self.state.step, seconds=dt)
            self.history.append(rec)
            if log_every and self.state.step % log_every == 0:
                print(f"step {self.state.step:5d} "
                      f"loss {rec['loss']:.4f} lr {rec['lr']:.2e} "
                      f"gnorm {rec['grad_norm']:.2f} {dt*1e3:.0f} ms")
            if (self.tcfg.checkpoint_dir
                    and self.state.step % self.tcfg.checkpoint_every == 0):
                self.save()
        CKPT.wait_pending()
        return self.history
