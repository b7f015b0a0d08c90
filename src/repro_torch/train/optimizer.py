"""AdamW + LR schedules (counterpart of ``repro.train.optimizer``).

Parameters and moments are nested dicts of tensors (the model's own
trees).  The arithmetic is the reference's, in fp32: each leaf is widened,
updated and cast back, the moments kept in ``moment_dtype`` (fp32 by
default, bf16 for the memory-constrained large-model configs).
:func:`adamw_update` writes the new parameters and moments into the
tensors it is given (``copy_`` under ``no_grad``) and returns them, so a
step holds no second copy of the model or its moments; each new value is
the reference's ``(p32 - lr * delta).astype(p.dtype)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.models.params import tree_leaves, tree_map, unflatten
from repro_torch.models.transformer import torch_dtype

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "warmup_cosine", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # or "bfloat16" for big models


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 scalar, on the parameters' device
    mu: dict
    nu: dict


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    dt = torch_dtype(cfg.moment_dtype)
    dev = tree_leaves(params)[0][1].device
    zeros = lambda p: torch.zeros_like(p, dtype=dt)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in sorted-path order) of each leaf's
    fp32 sum of squares."""
    return torch.sqrt(sum(torch.sum(x.float() ** 2)
                          for _, x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig,
                 lr: torch.Tensor | float):
    """One AdamW step, in place; returns (params, new state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=t.device), t)
    flat_g = dict(tree_leaves(grads))
    flat_m = dict(tree_leaves(state.mu))
    flat_v = dict(tree_leaves(state.nu))
    for path, p in tree_leaves(params):
        g32 = flat_g[path].float()
        m, v = flat_m[path], flat_v[path]
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
        mhat = m32 / bc1
        vhat = v32 / bc2
        p32 = p.float()
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
        m.copy_(m32)
        v.copy_(v32)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), \
        {"grad_norm": gnorm}


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to floor * peak; an fp32 scalar on
    the CPU (``step``: an int or an integer tensor)."""
    s = torch.as_tensor(step).detach().to("cpu", torch.float32)
    warm = peak_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
