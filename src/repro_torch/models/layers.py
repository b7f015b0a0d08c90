"""Shared transformer building blocks: RMSNorm, RoPE, GQA attention, SwiGLU
(counterpart of ``repro.models.layers``).

Plain PyTorch, with the reference's explicit casts where it puts them:
RMSNorm and RoPE compute in fp32 between casts, attention scores and the
softmax are fp32 and the probabilities are cast to the values' dtype
before the second product.  Masks go through a ``where`` with
``_NEG_INF = -1e30``, never ``-inf``, and read the per-row positions a
:class:`PosCache` stores (-1 marks an empty slot).  Attention is written
as two products with the reference's own masking (causal or
bidirectional, sliding window, an always-visible meta prefix), not
``scaled_dot_product_attention``; the encoder attends bidirectionally and
the decoder's cross-attention reads the encoder's output
(``attention_apply(causal=False, kv_x=...)``, and at decode
:func:`cross_attention_cached` against the prefill's roped K/V).

Where the reference shards activations the port calls
:func:`~repro_torch.distributed.sharding.shard_activation` at the same
sites: a no-op outside a mesh, a redistribute of a DTensor inside one.
The decode path writes its KV cache in place; on a DTensor cache each
rank writes its own shard (:func:`write_slots`, :func:`write_prefix`),
since DTensor has no sharded ``index_put_``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (from_local, is_dtensor,
                                              shard_activation, shard_window)
from repro_torch.models.params import P

__all__ = ["rms_norm", "rope", "attention_schema", "attention_apply",
           "attention_cached", "cross_attention_cached", "mlp_schema",
           "mlp_apply", "PosCache", "init_pos_cache", "write_slots",
           "write_prefix"]

_NEG_INF = -1e30


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (B, S, H, Dh); positions: (S,) or (B, S).
    fp32 math between explicit casts on both boundaries."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = positions if positions.dim() == 2 else positions[None, :]
    angles = pos[..., None].float() * freqs                 # (B?, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def attention_schema(cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    sch = {
        "wq": P((d, H, hd), ("embed", "heads", "head_dim"), fan_in_axes=(0,)),
        "wk": P((d, K, hd), ("embed", "kv_heads", "head_dim"), fan_in_axes=(0,)),
        "wv": P((d, K, hd), ("embed", "kv_heads", "head_dim"), fan_in_axes=(0,)),
        "wo": P((H, hd, d), ("heads", "head_dim", "embed"), fan_in_axes=(0, 1),
                scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.qkv_bias:
        sch["bq"] = P((H, hd), ("heads", "head_dim"), init="zeros")
        sch["bk"] = P((K, hd), ("kv_heads", "head_dim"), init="zeros")
        sch["bv"] = P((K, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        sch["q_norm"] = P((hd,), ("head_dim",), init="ones")
        sch["k_norm"] = P((hd,), ("head_dim",), init="ones")
    return sch


class PosCache(NamedTuple):
    """KV cache that records the absolute position held in every slot.

    ``pos[b, s] == -1`` marks an empty slot.  The mask logic only consults
    the stored positions, so rows may hold unaligned requests.
    """
    k: torch.Tensor      # (B, Cl, K, Dh)
    v: torch.Tensor      # (B, Cl, K, Dh)
    pos: torch.Tensor    # (B, Cl) int32


def init_pos_cache(cfg, batch: int, cache_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device = "cuda") -> PosCache:
    dev = resolve_device(device)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return PosCache(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        pos=torch.full((batch, cache_len), -1, dtype=torch.int32,
                       device=dev))


def _project_qkv(p, cfg, x, kv_src):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_src, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _gqa_attend(q, k, v, mask, head_dim):
    """q: (B,Sq,H,Dh); k,v: (B,Sk,K,Dh); mask broadcastable to
    (B,K,G,Sq,Sk) or None."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores / math.sqrt(head_dim)
    if mask is not None:
        scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, Dh)


def _attend(q, k, v, mask, head_dim):
    """:func:`_gqa_attend`, on DTensors shard by shard
    (:func:`_sharded_attend`)."""
    if is_dtensor(q):
        return _sharded_attend(
            lambda qq, kk, vv, mm: _gqa_attend(qq, kk, vv, mm, head_dim),
            q, k, v, mask)
    return _gqa_attend(q, k, v, mask, head_dim)


def _sharded_attend(core, q, k, v, mask):
    """An attention ``core(q, k, v, mask)`` on DTensors, run on the local
    shards (DTensor has no sharding rule for the grouped heads' reshape
    when a shard splits a KV group).

    * K/V sequence-sharded over ``model`` (a decode cache, as the
      reference places it): split-K attention.  Each model rank scores its
      slice of the keys for every head; the softmax's max and normaliser
      and the PV products are summed over the model ranks (three
      all-reduces: max, sum, sum).
    * Otherwise heads-parallel, where the query heads divide by the model
      ranks (the reference's ``act_heads``): each rank attends with its
      query heads, reading the KV heads they group onto (KV heads
      replicated where they do not divide, ``act_kv_heads``'s fallback).
    * Else every model rank attends for the whole of its batch shard.

    The batch stays sharded over the data axes throughout."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    mi = names.index("model") if "model" in names else None
    nm = mesh.shape[mi] if mi is not None else 1
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    dp_ok = all(B % mesh.shape[i] == 0 for i, n in enumerate(names)
                if n != "model")

    def pl(model_pl):
        return [model_pl if i == mi else (Shard(0) if dp_ok else Replicate())
                for i in range(len(names))]

    kv_seq = (mi is not None and is_dtensor(k)
              and k.placements[mi] == Shard(1) and nm > 1)
    if kv_seq:
        q_pl, kv_pl = pl(Replicate()), pl(Shard(1))
        m_pl = pl(Shard(4))
    elif mi is not None and nm > 1 and H % nm == 0:
        q_pl = pl(Shard(2))
        kv_pl = pl(Shard(2) if K % nm == 0 else Replicate())
        m_pl = pl(Replicate())
    else:
        q_pl = kv_pl = m_pl = pl(Replicate())
    grad = lambda p: [Partial() if (i == mi and p[i] == Replicate()
                                    and q_pl[i] != Replicate()) else p[i]
                      for i in range(len(p))]

    def dt(t):
        return t if is_dtensor(t) else from_local(
            t, mesh, [Replicate()] * len(names))

    def local(t, p, g=None):
        return dt(t).redistribute(mesh, p).to_local(grad_placements=g)

    ql = local(q, q_pl, [Partial() if i == mi else p for i, p in
                         enumerate(q_pl)] if kv_seq else None)
    kl, vl = local(k, kv_pl, grad(kv_pl)), local(v, kv_pl, grad(kv_pl))
    ml = None
    if mask is not None:
        if mask.shape[0] == 1 and not kv_seq:
            ml = mask.to_local() if is_dtensor(mask) else mask
        else:
            ml = dt(mask).expand(B, *mask.shape[1:])
            ml = ml.redistribute(mesh, m_pl).to_local()
    if kv_seq:
        out = _split_k(ql, kl, vl, ml, q.shape[-1],
                       mesh.get_group("model").group_name)
    else:
        if (mi is not None and q_pl[mi] == Shard(2)
                and kv_pl[mi] == Replicate() and K != H):
            # this rank's query heads and the KV heads they group onto
            Hl = ql.shape[2]
            first = mesh.get_local_rank("model") * Hl
            kv_idx = torch.div(torch.arange(first, first + Hl,
                                            device=ql.device),
                               H // K, rounding_mode="floor")
            kl, vl = kl[:, :, kv_idx], vl[:, :, kv_idx]
        out = core(ql, kl, vl, ml)
    return from_local(out, mesh, q_pl, q.shape)


class _SumOver(torch.autograd.Function):
    """All-reduce (``op``) over a group; the backward passes the gradient
    through (every rank holds the whole reduced value)."""

    @staticmethod
    def forward(ctx, x, op, group_name):
        f = torch.ops._c10d_functional
        return f.wait_tensor(f.all_reduce(x.contiguous(), op, group_name))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _split_k(q, k, v, mask, head_dim, group_name):
    """Grouped attention over this rank's slice of the keys, the softmax
    completed across the group: the global max and normaliser by two
    all-reduces, the PV products summed by a third."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores / math.sqrt(head_dim)
    if mask is not None:
        scores = torch.where(mask, scores, _NEG_INF)
    m = _SumOver.apply(scores.amax(dim=-1, keepdim=True).detach(), "max",
                       group_name)
    e = torch.exp(scores - m)
    denom = _SumOver.apply(e.sum(dim=-1, keepdim=True), "sum", group_name)
    probs = e / denom
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    out = _SumOver.apply(out, "sum", group_name)
    return out.reshape(B, Sq, H, Dh)


# Sequences at or above this length take the online-softmax chunked path —
# full (Sq, Sk) score materialization at 32k+ would need tens of GB.
CHUNKED_ATTN_THRESHOLD = 8192
_Q_CHUNK = 1024
_KV_CHUNK = 1024


def _largest_divisor(n: int, target: int) -> int:
    for c in range(target, 0, -1):
        if n % c == 0:
            return c
    return 1


def _window_mask(qp, kp, window: int, n_meta: int):
    """Causal, sliding-window and meta-prefix visibility of key positions
    ``kp`` from query positions ``qp`` (broadcast against each other)."""
    allowed = kp <= qp
    if window > 0:
        in_window = (qp - kp) < window
        if n_meta > 0:
            in_window = in_window | (kp < n_meta)
        allowed = allowed & in_window
    return allowed


def _chunked_attend(q, k, v, q_pos, kv_pos, *, window, n_meta, head_dim,
                    causal=True, q_chunk=_Q_CHUNK, kv_chunk=_KV_CHUNK):
    """Flash-style attention: never materializes the (Sq, Sk) score
    matrix.

    A loop over query chunks, and inside it over KV chunks carrying the
    online-softmax state (running max m, normalizer l, weighted
    accumulator acc), all fp32; with ``causal`` the mask of each chunk
    pair is evaluated from the position arrays, else nothing is masked.
    """
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    q_chunk = _largest_divisor(Sq, min(q_chunk, Sq))
    kv_chunk = _largest_divisor(Sk, min(kv_chunk, Sk))
    scale = 1.0 / math.sqrt(head_dim)
    outs = []
    for i in range(0, Sq, q_chunk):
        qc = q[:, i:i + q_chunk].reshape(B, q_chunk, K, G, Dh).float()
        qp = q_pos[i:i + q_chunk][:, None]
        acc = torch.zeros((B, K, G, q_chunk, Dh), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, K, G, q_chunk), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, K, G, q_chunk), dtype=torch.float32,
                        device=q.device)
        for j in range(0, Sk, kv_chunk):
            kc = k[:, j:j + kv_chunk].float()
            vc = v[:, j:j + kv_chunk].float()
            s = torch.einsum("bqkgd,bskd->bkgqs", qc, kc) * scale
            if causal:
                kp = kv_pos[j:j + kv_chunk][None, :]
                s = torch.where(_window_mask(qp, kp, window, n_meta), s,
                                _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p_ = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p_, vc)
            l = l * alpha + p_.sum(dim=-1)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)     # (B,K,G,qc,Dh)
        outs.append(out.movedim(3, 1).reshape(B, q_chunk, H, Dh))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_apply(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                    *, causal: bool = True, window: int = 0,
                    kv_x: torch.Tensor | None = None,
                    kv_positions: torch.Tensor | None = None,
                    return_kv: bool = False):
    """Full-sequence GQA attention (prefill, the full forward, the encoder
    with ``causal=False``, cross-attention with ``kv_x``, the encoder's
    output, at ``kv_positions``).  ``window`` <= 0 means full attention;
    meta-token positions (< cfg.n_meta_tokens) are always visible under a
    window.
    """
    q, k, v = _project_qkv(p, cfg, x, x if kv_x is None else kv_x)
    kv_pos = positions if kv_positions is None else kv_positions
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, kv_pos, cfg.rope_theta)
    q = shard_activation(q, ("batch", "seq", "act_heads", None))
    k = shard_activation(k, ("batch", "seq", "act_kv_heads", None))
    window = int(window)
    if max(q.shape[1], k.shape[1]) >= CHUNKED_ATTN_THRESHOLD:
        core = lambda qq, kk, vv, _: _chunked_attend(
            qq, kk, vv, positions, kv_pos, causal=causal, window=window,
            n_meta=cfg.n_meta_tokens, head_dim=cfg.head_dim)
        out = (_sharded_attend(core, q, k, v, None) if is_dtensor(q)
               else core(q, k, v, None))
    else:
        mask = None
        if causal:
            mask = _window_mask(positions[:, None], kv_pos[None, :], window,
                                cfg.n_meta_tokens)[None, None, None]
        out = _attend(q, k, v, mask, cfg.head_dim)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    y = shard_activation(y, ("batch", "seq", "act_embed"))
    if return_kv:
        return y, (k, v)
    return y


def attention_cached(p: dict, cfg, x: torch.Tensor, t, cache: PosCache, *,
                     window: int = 0) -> tuple[torch.Tensor, PosCache]:
    """Single-token decode against a PosCache, which is written in place
    at slot t (the linear layout, the only one the reference's decode
    path writes).

    x: (B, 1, d); t: an int or a (B,) tensor of absolute positions (per-row
    positions serve unaligned continuous batching).

    The attention output is cast to the output projection's dtype.  Where
    the cache's dtype is the wider (the engine's fp32 cache beside bf16
    weights) this keeps the residual stream in the weights' dtype; the
    reference promotes it to fp32 there, and its layer scan then refuses
    the changed carry dtype, so it has no result to match in that case.
    Otherwise the cast is the reference's promotion.
    """
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, x)
    tv = torch.as_tensor(t, dtype=torch.int32, device=x.device)
    tv = tv.reshape(-1).expand(B)
    q = rope(q, tv[:, None], cfg.rope_theta)
    k = rope(k, tv[:, None], cfg.rope_theta)

    slot = tv.long()
    write_slots(cache.k, k[:, 0], slot)
    write_slots(cache.v, v[:, 0], slot)
    write_slots(cache.pos, tv, slot)

    kp = cache.pos                                       # (B, Cl)
    tb = tv[:, None]
    mask = (kp >= 0) & (kp <= tb)
    if int(window) > 0:
        in_window = (tb - kp) < int(window)
        if cfg.n_meta_tokens > 0:
            in_window = in_window | ((kp < cfg.n_meta_tokens) & (kp >= 0))
        mask = mask & in_window
    mask = mask[:, None, None, None, :]                  # (B,1,1,1,Cl)

    out = _attend(q, cache.k, cache.v, mask, cfg.head_dim)
    y = torch.einsum("bshk,hkd->bsd", out.to(p["wo"].dtype), p["wo"])
    # attention_apply's placement of its output (DTensor cannot reduce a
    # partial sum onto a one-token sequence dim on its own)
    return shard_activation(y, ("batch", "seq", "act_embed")), cache


def cross_attention_cached(p: dict, cfg, x: torch.Tensor, t,
                           enc_k: torch.Tensor,
                           enc_v: torch.Tensor) -> torch.Tensor:
    """Decode-time cross attention against precomputed (roped) encoder K/V.

    x: (B, 1, d); enc_k, enc_v: (B, Se, K, Dh); t: the decoder position, an
    int or a one-element tensor: the reference ropes the query at
    ``reshape(t, (1,))``, one position for the whole batch, so a per-row
    vector is refused.  The output is cast to the output projection's
    dtype, as in :func:`attention_cached`."""
    tv = torch.as_tensor(t, dtype=torch.int32, device=x.device)
    if tv.numel() != 1:
        raise ValueError(
            f"cross-attention decodes every row at one position (the "
            f"reference ropes the query at reshape(t, (1,))); got {tv.numel()}"
            f" positions")
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    q = rope(q, tv.reshape(1), cfg.rope_theta)
    out = _attend(q, enc_k, enc_v, None, cfg.head_dim)
    return shard_activation(
        torch.einsum("bshk,hkd->bsd", out.to(p["wo"].dtype), p["wo"]),
        ("batch", "seq", "act_embed"))


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_schema(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": P((d, f), ("embed", "mlp"), fan_in_axes=(0,)),
        "w_up": P((d, f), ("embed", "mlp"), fan_in_axes=(0,)),
        "w_down": P((f, d), ("mlp", "embed"), fan_in_axes=(0,),
                    scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    h = shard_activation(h, ("batch", "seq", "act_mlp"))
    return shard_activation(h @ p["w_down"], ("batch", "seq", "act_embed"))


# ---------------------------------------------------------------------------
# In-place cache writes, plain or shard by shard
# ---------------------------------------------------------------------------
def _local_window(dst):
    """(local tensor, global offset of each dim) of a DTensor."""
    _, off = shard_window(dst.shape, dst.device_mesh, dst.placements)
    return dst.to_local(), off


def _src_local(src, dst, dim_map: dict[int, int]):
    """``src`` as the tensor this rank needs for its shard of ``dst``:
    a DTensor redistributed to ``dst``'s placements on the dims
    ``dim_map`` pairs (dst dim -> src dim) and replicated on the others,
    then made local; a plain tensor as it is (the same on every rank).
    Returns (local tensor, whether each src dim is already local)."""
    if not is_dtensor(src):
        return src, {}
    from torch.distributed.tensor import Replicate, Shard
    pl = []
    for p in dst.placements:
        if isinstance(p, Shard) and p.dim in dim_map:
            pl.append(Shard(dim_map[p.dim]))
        else:
            pl.append(Replicate())
    src = src.redistribute(src.device_mesh, pl)
    return src.to_local(), {dim_map[p.dim] for p in dst.placements
                            if isinstance(p, Shard) and p.dim in dim_map}


def write_slots(dst: torch.Tensor, src: torch.Tensor,
                slot: torch.Tensor) -> None:
    """``dst[b, slot[b]] = src[b]`` in place for every row b (``dst`` (B,
    Cl, ...), ``src`` (B, ...), ``slot`` (B,)).  On a DTensor ``dst`` each
    rank writes its own shard: the rows of its batch shard, and of a
    sequence-sharded cache only the slots in its range (the others keep
    their value through a ``where``)."""
    if not is_dtensor(dst):
        bidx = torch.arange(dst.shape[0], device=dst.device)
        dst[bidx, slot] = src.to(dst.dtype)
        return
    local, off = _local_window(dst)
    nd = dst.dim()
    s_loc, done = _src_local(src, dst, {0: 0, **{d: d - 1
                                                 for d in range(2, nd)}})
    sl, _ = _src_local(slot, dst, {0: 0})
    B, Cl = local.shape[:2]
    if 0 not in done:
        s_loc = s_loc[off[0]:off[0] + B]
    if not is_dtensor(slot):
        sl = sl[off[0]:off[0] + B]
    for d in range(2, nd):
        if d - 1 not in done:
            s_loc = s_loc.narrow(d - 1, off[d], local.shape[d])
    ls = sl.long() - off[1]
    inside = (ls >= 0) & (ls < Cl)
    ls = ls.clamp(0, Cl - 1)
    bidx = torch.arange(B, device=local.device)
    old = local[bidx, ls]
    keep = inside.reshape((B,) + (1,) * (old.dim() - 1))
    local[bidx, ls] = torch.where(keep, s_loc.to(local.dtype), old)


def write_prefix(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[:, :S] = src`` in place (``src`` (B, S, ...), S <= Cl).  On a
    DTensor ``dst`` each rank copies the part of ``src`` its shard
    covers."""
    S = src.shape[1]
    if not is_dtensor(dst):
        dst[:, :S] = src.to(dst.dtype)
        return
    local, off = _local_window(dst)
    nd = dst.dim()
    same = {d: d for d in range(nd) if d != 1 or S == dst.shape[1]}
    s_loc, done = _src_local(src, dst, same)
    for d in range(nd):
        if d not in done:
            n = min(local.shape[d], max(src.shape[d] - off[d], 0))
            s_loc = s_loc.narrow(d, min(off[d], src.shape[d]), n)
    local.narrow(1, 0, s_loc.shape[1]).copy_(s_loc.to(local.dtype))
