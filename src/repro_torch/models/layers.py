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

Where the reference shards activations (``shard_activation``) the port
does nothing: outside a mesh the reference's call is a no-op as well.
The decode path writes its KV cache in place.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.params import P

__all__ = ["rms_norm", "rope", "attention_schema", "attention_apply",
           "attention_cached", "cross_attention_cached", "mlp_schema",
           "mlp_apply", "PosCache", "init_pos_cache"]

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
    window = int(window)
    if max(q.shape[1], k.shape[1]) >= CHUNKED_ATTN_THRESHOLD:
        out = _chunked_attend(q, k, v, positions, kv_pos, causal=causal,
                              window=window, n_meta=cfg.n_meta_tokens,
                              head_dim=cfg.head_dim)
    else:
        mask = None
        if causal:
            mask = _window_mask(positions[:, None], kv_pos[None, :], window,
                                cfg.n_meta_tokens)[None, None, None]
        out = _gqa_attend(q, k, v, mask, cfg.head_dim)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
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

    bidx = torch.arange(B, device=x.device)
    slot = tv.long()
    cache.k[bidx, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[bidx, slot] = v[:, 0].to(cache.v.dtype)
    cache.pos[bidx, slot] = tv

    kp = cache.pos                                       # (B, Cl)
    tb = tv[:, None]
    mask = (kp >= 0) & (kp <= tb)
    if int(window) > 0:
        in_window = (tb - kp) < int(window)
        if cfg.n_meta_tokens > 0:
            in_window = in_window | ((kp < cfg.n_meta_tokens) & (kp >= 0))
        mask = mask & in_window
    mask = mask[:, None, None, None, :]                  # (B,1,1,1,Cl)

    out = _gqa_attend(q, cache.k, cache.v, mask, cfg.head_dim)
    y = torch.einsum("bshk,hkd->bsd", out.to(p["wo"].dtype), p["wo"])
    return y, cache


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
    out = _gqa_attend(q, enc_k, enc_v, None, cfg.head_dim)
    return torch.einsum("bshk,hkd->bsd", out.to(p["wo"].dtype), p["wo"])


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
    return h @ p["w_down"]
