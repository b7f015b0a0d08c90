"""Top-k MoE with capacity-limited gather dispatch (counterpart of
``repro.models.moe``, its single-device branch).

Routing: softmax router, top-k experts per token, per-expert capacity
``C = ceil(T * k * capacity_factor / E)``; a (token, choice) slot beyond its
expert's capacity is dropped (weight 0) as in GShard.  Slots are ranked
k-major (every token's first choice before any second choice), so earlier
choices win capacity first; dispatch writes each kept slot into its row of
the (E*C, d) expert buffer (dropped slots go to the spare row E*C), and
combine gathers each slot's expert output back, weighted.

The expert-parallel branch of the reference (``_moe_ep_shard_map``) needs a
mesh and waits with ``distributed/`` and ``launch/``; where the reference
shards activations the port does nothing (a no-op outside a mesh there).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.params import P

__all__ = ["moe_schema", "moe_apply", "top_k"]


def moe_schema(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": P((d, e), ("embed", "experts"), fan_in_axes=(0,)),
        "w_gate": P((e, d, f), ("experts", "embed", "expert_mlp"),
                    fan_in_axes=(1,)),
        "w_up": P((e, d, f), ("experts", "embed", "expert_mlp"),
                  fan_in_axes=(1,)),
        "w_down": P((e, f, d), ("experts", "expert_mlp", "embed"),
                    fan_in_axes=(1,),
                    scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row and their indices, largest
    first and, among equal values, the lower index first — the order
    ``jax.lax.top_k`` gives (a stable descending sort; ``torch.topk``
    leaves the order of ties unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: dict, cfg, x: torch.Tensor) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    cap = int(math.ceil(T * K * cfg.capacity_factor / E))

    xt = x.reshape(T, d)
    logits = (xt @ p["router"]).float()                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, K)                           # (T, K)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)          # renormalize

    # load-balancing aux loss (Switch/GShard)
    density = F.one_hot(top_e[:, 0], E).float().mean(dim=0)
    aux = (density * probs.mean(dim=0)).sum() * E

    # capacity positions: rank of each (token, choice) slot within its
    # expert, slots ordered k-major
    flat_e = top_e.T.reshape(K * T)                          # (K*T,)
    onehot = F.one_hot(flat_e, E)                            # (K*T, E)
    pos_in_expert = onehot.cumsum(dim=0) - onehot            # rank before me
    pos = pos_in_expert.gather(1, flat_e[:, None])[:, 0]
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(flat_e, E * cap))     # E*cap: dropped

    # dispatch: each kept slot into its own row (the spare row E*cap takes
    # every dropped slot and is cut off).  Slot k*T + t holds token t: the
    # K copies of the tokens are a repeat, whose backward sums each token's
    # K gradients in order (a gather's backward accumulates them in an
    # order that varies from run to run on the CPU)
    buf = x.new_zeros((E * cap + 1, d))
    buf[dest] = xt.repeat(K, 1)
    buf = buf[:-1].reshape(E, cap, d)

    # expert FFN (grouped SwiGLU over the expert axis)
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"])

    # combine: gather each slot's expert output, weight it, and sum over
    # the choices in a fixed order, k = 0 .. K-1 into zeros (the order of
    # the reference's scatter-add on the CPU; an atomic index_add_ would
    # vary the order from run to run on the card)
    flat_out = torch.cat([out_buf.reshape(E * cap, d), x.new_zeros((1, d))])
    weights = (top_p.T.reshape(K * T) * keep).to(x.dtype)
    contrib = (flat_out[dest] * weights[:, None]).reshape(K, T, d)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for k in range(K):
        y = y + contrib[k]
    return y.reshape(B, S, d), aux
