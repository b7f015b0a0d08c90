"""GPipe-style pipeline parallelism (counterpart of
``repro.distributed.pipeline``).

The schedule is the classic fill-drain (GPipe): with S stages and M
microbatches, bubble fraction = (S-1)/(M+S-1).  Each rank of a
``torch.distributed`` group is one stage and holds that stage's layer
parameters; the schedule is a host loop of M + S - 1 ticks, and at the
end of each tick every stage hands its output to the next stage
(:class:`_HandOff`, the reference's ``ppermute`` with ``[(i, i + 1)]``).
The hand-off is an autograd function: its backward sends the cotangent
one stage back, as the transpose of ``ppermute`` does, so the gradients
of the stage parameters and of the input flow through the pipeline.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_leaves

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def _shift(t: torch.Tensor, group, stage: int, n_stages: int,
           step: int) -> torch.Tensor:
    """Send ``t`` to stage ``stage + step`` and return what stage
    ``stage - step`` sends (zeros where that stage does not exist), in one
    ``batch_isend_irecv``."""
    out = torch.zeros_like(t)
    ops = []
    dst, src = stage + step, stage - step
    if 0 <= dst < n_stages:
        ops.append(dist.P2POp(dist.isend, t.contiguous(),
                              dist.get_global_rank(group, dst), group))
    if 0 <= src < n_stages:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, src), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _HandOff(torch.autograd.Function):
    """Forward: send ``y`` to the next stage, receive the previous stage's
    (stage 0 receives zeros).  Backward: send the cotangent to the
    previous stage, receive the next stage's (the last receives zeros)."""

    @staticmethod
    def forward(ctx, y, group, stage, n_stages):
        ctx.args = (group, stage, n_stages)
        return _shift(y, group, stage, n_stages, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, *ctx.args, -1), None, None, None


class _Tie(torch.autograd.Function):
    """``a`` itself, with ``bs`` tied into the graph: the backward gives
    ``a`` the cotangent and each of ``bs`` zeros (the reference's ``where``
    does the same to the branch it does not select).  It keeps every
    hand-off on the path from the output to the stage's parameters and x,
    so every rank runs every hand-off's backward, in one order."""

    @staticmethod
    def forward(ctx, a, *bs):
        ctx.metas = [(b.shape, b.dtype, b.device) for b in bs]
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros((), dtype=dtype, device=device)
                     .expand(shape) for shape, dtype, device in ctx.metas))


def pipeline_apply(layer_fn: Callable, stage_params, x: torch.Tensor, *,
                   n_microbatches: int, group=None) -> torch.Tensor:
    """Run ``layer_fn(stage_params, h)`` as a pipeline over ``group``.

    Every rank of ``group`` (default: the default group; e.g. a
    ``DeviceMesh``'s ``"pipe"`` dim) calls this with its own stage's
    parameters; the stage is the rank's index in the group.  x: (B, ...)
    the stage-0 input (the other stages receive through the hand-offs),
    B divisible by ``n_microbatches``; ``layer_fn`` keeps the shape of
    its input.  Returns (B, ...) on every rank: the last stage's outputs,
    zeros on the other stages (as the reference returns).  Where autograd
    records (grad enabled, and ``x`` or a parameter requiring grad), every
    rank must record and backpropagate from its output, so that the
    hand-offs' backwards pair up."""
    if x.shape[0] % n_microbatches:
        raise ValueError(f"the batch of {x.shape[0]} rows does not split "
                         f"into {n_microbatches} microbatches")
    group = group if group is not None else dist.group.WORLD
    n_stages = dist.get_world_size(group) if dist.is_initialized() else 1
    stage = dist.get_rank(group) if n_stages > 1 else 0
    M = n_microbatches
    micro = x.reshape(M, x.shape[0] // M, *x.shape[1:])
    recorded = [t for t in [x] + [p for _, p in tree_leaves(stage_params)]
                if isinstance(t, torch.Tensor) and t.requires_grad]
    grad = torch.is_grad_enabled() and bool(recorded)
    last = stage == n_stages - 1
    buf = torch.zeros_like(micro[0])
    if grad and n_stages > 1:
        # the chain of hand-offs starts at x and the parameters: every
        # tick's output then records, and every hand-off lies on the path
        # to whichever of them a backward asks for
        buf = _Tie.apply(buf, *recorded)
    done = []
    for t in range(M + n_stages - 1):
        incoming = micro[min(t, M - 1)] if stage == 0 else buf
        if 0 <= t - stage < M:
            y = layer_fn(stage_params, incoming)
            if last:
                done.append(y)
        else:
            y = torch.zeros_like(micro[0])
        if n_stages > 1:
            if grad:
                y = _Tie.apply(y, buf)
            buf = _HandOff.apply(y, group, stage, n_stages)
    out = torch.stack(done) if last else torch.zeros_like(micro)
    if grad and n_stages > 1:
        out = _Tie.apply(out, buf)
    return out.reshape(x.shape)
