"""Top-k MoE with capacity-limited gather dispatch (counterpart of
``repro.models.moe``, its single-device branch).

Routing: softmax router, top-k experts per token, per-expert capacity
``C = ceil(T * k * capacity_factor / E)``; a (token, choice) slot beyond its
expert's capacity is dropped (weight 0) as in GShard.  Slots are ranked
k-major (every token's first choice before any second choice), so earlier
choices win capacity first; dispatch writes each kept slot into its row of
the (E*C, d) expert buffer (dropped slots go to the spare row E*C), and
combine gathers each slot's expert output back, weighted.

Under a mesh (an :func:`~repro_torch.distributed.sharding.activation_sharding`
context and DTensor activations) the reference's expert-parallel branch
is taken on its own condition (:func:`_moe_ep`, the counterpart of
``_moe_ep_shard_map``): each data shard dispatches its own tokens with
capacity per data shard, each model rank runs its subgroup's experts on
the local shards, and one all-reduce over the model axis sums the
combine.  Elsewhere the reference's ``shard_activation`` sites call the
port's, a no-op outside a mesh.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (current_mesh, from_local,
                                              is_dtensor, shard_activation)
from repro_torch.models.layers import _SumOver
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


def _combine(out, dest, weights, T, K):
    """Each slot's row of the expert outputs ``out`` (n, cap, d) (``dest``
    in [0, n*cap]; n*cap, the spare zero row, for a dropped slot),
    weighted, summed over the choices k = 0 .. K-1 in order into zeros."""
    d = out.shape[-1]
    flat_out = torch.cat([out.reshape(-1, d), out.new_zeros((1, d))])
    contrib = (flat_out[dest] * weights[:, None]).reshape(K, T, d)
    y = torch.zeros((T, d), dtype=out.dtype, device=out.device)
    for k in range(K):
        y = y + contrib[k]
    return y


def _dispatch(xt, top_e, E, K, cap):
    """Capacity positions and the (E*cap, d) expert buffer of T tokens
    (``xt`` (T, d), ``top_e`` (T, K)): slots ranked k-major (earlier
    choices win capacity first); each kept slot in its own row (the spare
    row E*cap takes every dropped slot and is cut off).  Slot k*T + t
    holds token t: the K copies of the tokens are a repeat, whose backward
    sums each token's K gradients in order (a gather's backward
    accumulates them in an order that varies from run to run on the
    CPU).  Returns (buffer (E, cap, d), dest (K*T,), keep (K*T,))."""
    T, d = xt.shape
    flat_e = top_e.T.reshape(K * T)                          # (K*T,)
    onehot = F.one_hot(flat_e, E)                            # (K*T, E)
    pos_in_expert = onehot.cumsum(dim=0) - onehot            # rank before me
    pos = pos_in_expert.gather(1, flat_e[:, None])[:, 0]
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(flat_e, E * cap))     # E*cap: dropped
    buf = xt.new_zeros((E * cap + 1, d))
    buf[dest] = xt.repeat(K, 1)
    return buf[:-1].reshape(E, cap, d), dest, keep


def _experts(buf, wg, wu, wd):
    """The grouped SwiGLU over the expert axis: (e, cap, d) -> (e, cap,
    d)."""
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    return torch.bmm(h, wd)


def _moe_ep(p, cfg, x, top_p, top_e, mesh, nm: int, g: int):
    """Expert-parallel dispatch on the local shards (the reference's
    ``_moe_ep_shard_map``).

    Every data shard dispatches its own tokens into a local per-expert
    buffer (capacity per data shard, GShard group semantics); model rank j
    runs the ``E/g`` experts of subgroup ``j % g`` (``g = gcd(E, nm)``
    subgroups: granite's 40 experts on 16 ranks run in 8 subgroups of 5,
    each on 2 ranks, whose contributions are scaled by ``1/dup`` so the
    sum stays exact); the only cross-rank traffic is ONE all-reduce of
    the (T_local, d) combine over the model axis.  The local combine sums
    the choices in order, k-major, with no ``index_add_``.

    ``x``, ``top_p``, ``top_e`` are DTensors (B, S, ...); each is taken to
    batch-sharded over the data axes and replicated over ``model``; the
    expert weights to model-sharded over the experts when g == nm, else
    replicated.  The gradients of the local inputs are partial over the
    model axis (each rank's experts see every token), those of the
    weights over the data axes too; ``to_local``'s ``grad_placements``
    say so."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    E, K = cfg.n_experts, cfg.top_k
    B, S, d = x.shape
    e_loc = E // g                       # experts per subgroup
    dup = nm // g                        # ranks sharing a subgroup
    names = mesh.mesh_dim_names
    mi = names.index("model")
    data_pl = [Replicate() if n == "model" else Shard(0) for n in names]
    data_grad = [Partial() if n == "model" else Shard(0) for n in names]

    def local(t, grad=True):
        t = t.redistribute(mesh, data_pl)
        return t.to_local(grad_placements=data_grad if grad else None)

    xb, tp, te = local(x), local(top_p), local(top_e, grad=False)
    w_pl = [Replicate() for _ in names]
    w_grad = [Partial() for _ in names]
    if g == nm:
        w_pl[mi] = w_grad[mi] = Shard(0)
    ws = [p[k].redistribute(mesh, w_pl).to_local(grad_placements=w_grad)
          for k in ("w_gate", "w_up", "w_down")]

    Bl = xb.shape[0]
    Tl = Bl * S
    cap = int(math.ceil(Tl * K * cfg.capacity_factor / E))
    buf, dest, keep = _dispatch(xb.reshape(Tl, d), te.reshape(Tl, K), E, K,
                                cap)
    block = mesh.get_local_rank("model") % g     # this rank's subgroup
    if g != nm:
        ws = [w[block * e_loc:(block + 1) * e_loc] for w in ws]
    out = _experts(buf[block * e_loc:(block + 1) * e_loc], *ws)
    weights = (tp.reshape(Tl, K).T.reshape(K * Tl) * keep).to(xb.dtype)
    if dup > 1:
        weights = weights * (1.0 / dup)               # de-duplicate
    # this rank's rows of the buffer; a slot routed elsewhere reads the
    # spare zero row
    n_local = e_loc * cap
    ld = dest - block * n_local
    ld = torch.where((ld >= 0) & (ld < n_local), ld,
                     torch.full_like(ld, n_local))
    y = _combine(out, ld, weights, Tl, K)
    y = _SumOver.apply(y, "sum", mesh.get_group("model").group_name)
    return from_local(y.reshape(Bl, S, d), mesh, data_pl, x.shape)


def _ep_groups(mesh, E: int, B: int) -> tuple[int, int] | None:
    """(nm, g) where the reference takes its expert-parallel branch
    (``nm > 1``, ``g = gcd(E, nm) > 1``, the batch divisible by the data
    ranks), else None."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    nm = sizes.get("model", 1)
    ndp = math.prod(v for k, v in sizes.items() if k != "model") or 1
    g = math.gcd(E, nm)
    if nm > 1 and g > 1 and B % ndp == 0:
        return nm, g
    return None


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

    # the expert-parallel branch, on the reference's condition
    mesh = current_mesh()
    if mesh is not None and is_dtensor(x):
        ep = _ep_groups(mesh, E, B)
        if ep is not None:
            y = _moe_ep(p, cfg, x, top_p.reshape(B, S, K),
                        top_e.reshape(B, S, K), mesh, *ep)
            return y, aux

    buf, dest, keep = _dispatch(xt, top_e, E, K, cap)
    buf = shard_activation(buf, ("act_experts", "capacity", "act_embed"))
    out_buf = _experts(buf, p["w_gate"], p["w_up"], p["w_down"])
    out_buf = shard_activation(out_buf,
                               ("act_experts", "capacity", "act_embed"))

    # combine: gather each slot's expert output, weight it, and sum over
    # the choices in a fixed order, k = 0 .. K-1 into zeros (the order of
    # the reference's scatter-add on the CPU; an atomic index_add_ would
    # vary the order from run to run on the card)
    weights = (top_p.T.reshape(K * T) * keep).to(x.dtype)
    y = _combine(out_buf, dest, weights, T, K)
    return shard_activation(y.reshape(B, S, d),
                            ("batch", "seq", "act_embed")), aux

