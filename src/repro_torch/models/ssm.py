"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060] (counterpart
of ``repro.models.ssm``).

Chunked SSD for train/prefill (the intra-chunk quadratic form and an
inter-chunk recurrence) and an O(1)-per-token recurrent decode step.
Geometry follows the paper: ``d_inner = expand * d_model`` split into
heads of ``ssm_headdim``; scalar decay per head (``A``), shared B/C of size
``d_state`` (one group), depthwise causal conv over (x, B, C), gated
RMSNorm before the output projection.

Plain PyTorch with the reference's casts where it puts them: the conv of
the full sequence accumulates in the input's dtype, tap by tap in order
and the bias last; the decode step's conv is an fp32 product; ``dt``, the
decays, the chunk products and the state are fp32; ``y`` is rounded to
the input's dtype once before the gated RMSNorm.  The intra-chunk decay
is ``exp`` of ``-inf`` above the diagonal (not the attention masks'
-1e30): there ``diff`` is positive and its ``exp`` could overflow.  The
reference's ``lax.scan`` over chunks is a Python loop carrying the fp32
``(B, nh, hd, N)`` state, which keeps the state before each chunk for the
inter-chunk term.  The decode step writes its cache in place.  The
reference's ``shard_activation`` sites call the port's (a no-op outside
a mesh).

On DTensors (under a mesh) the block runs on each rank's batch shard with
its weights and caches gathered over ``model`` (:func:`_on_batch_shards`):
the port has no tensor-parallel SSD, since the in-projection's z, x, B, C
and dt columns do not split along the model shards' boundaries, nor do
hymba's 25 heads over 16 ranks.  The results are placed back as the
caches are placed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (from_local, is_dtensor,
                                              shard_activation)
from repro_torch.models.params import P

__all__ = ["ssm_schema", "ssd_apply", "ssd_decode_step", "SSMCache",
           "init_ssm_cache"]


def _dims(cfg):
    di = cfg.d_inner
    nh = di // cfg.ssm_headdim
    n = cfg.d_state
    conv_dim = di + 2 * n
    return di, nh, n, conv_dim


def ssm_schema(cfg) -> dict:
    d = cfg.d_model
    di, nh, n, conv_dim = _dims(cfg)
    proj_out = 2 * di + 2 * n + nh           # z, x, B, C, dt
    return {
        "in_proj": P((d, proj_out), ("embed", "ssm_inner"), fan_in_axes=(0,)),
        "conv_w": P((cfg.d_conv, conv_dim), ("conv", "ssm_inner"),
                    fan_in_axes=(0,)),
        "conv_b": P((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": P((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": P((nh,), ("ssm_heads",), init="zeros"),
        "d_skip": P((nh,), ("ssm_heads",), init="ones"),
        "norm": P((di,), ("ssm_inner",), init="ones"),
        "out_proj": P((di, d), ("ssm_inner", "embed"), fan_in_axes=(0,),
                      scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


class SSMCache(NamedTuple):
    h: torch.Tensor          # (B, nh, hd, N) recurrent state
    conv: torch.Tensor       # (B, d_conv - 1, conv_dim) conv history


def init_ssm_cache(cfg, batch: int, dtype: torch.dtype = torch.float32,
                   device: str | torch.device = "cuda") -> SSMCache:
    dev = resolve_device(device)
    di, nh, n, conv_dim = _dims(cfg)
    return SSMCache(
        h=torch.zeros((batch, nh, cfg.ssm_headdim, n), dtype=dtype,
                      device=dev),
        conv=torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype,
                         device=dev))


def _split_proj(cfg, zxbcdt):
    di, nh, n, _ = _dims(cfg)
    return torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)  # z, x, B, C, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as the reference writes it (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _conv_causal(u, w, b):
    """Depthwise causal conv.  u: (B,S,Cd), w: (dc,Cd), b: (Cd,).  Sums in
    u's dtype: zeros, then taps 0..dc-1 in order, then the bias."""
    dc = w.shape[0]
    pad = F.pad(u, (0, 0, dc - 1, 0))
    out = torch.zeros_like(u)
    for i in range(dc):
        out = out + pad[:, i:i + u.shape[1], :] * w[i]
    return out + b


def _on_batch_shards(fn, p, cfg, x, cache=None, **kw):
    """``fn`` (the SSD forward or decode step) on this rank's batch shard
    of DTensor ``x``, with every weight and cache leaf gathered to it
    (replicated over ``model``; the weights' gradients are partial over
    the data axes).  Outputs come back as DTensors sharded like ``x``; a
    decode ``cache`` is written back into its own placements."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    pl = [Shard(0) if n != "model" and x.shape[0] % mesh.shape[i] == 0
          else Replicate() for i, n in enumerate(names)]
    grad = [Partial() if q == Shard(0) else Replicate() for q in pl]
    rep = [Replicate()] * len(names)
    pw = {k: w.redistribute(mesh, rep).to_local(grad_placements=grad)
          if is_dtensor(w) else w for k, w in p.items()}
    xl = x.redistribute(mesh, pl).to_local()

    def wrap(t):
        return from_local(t, mesh, pl, (x.shape[0], *t.shape[1:]))

    if cache is not None:
        cl = SSMCache(*(c.redistribute(mesh, pl).to_local() for c in cache))
        out, _ = fn(pw, cfg, xl, cl)
        for c, new in zip(cache, cl):
            c.copy_(wrap(new))
        return wrap(out), cache
    res = fn(pw, cfg, xl, **kw)
    if kw.get("return_state"):
        out, st = res
        return wrap(out), SSMCache(wrap(st.h), wrap(st.conv))
    return wrap(res)


def ssd_apply(p: dict, cfg, x: torch.Tensor, *, chunk: int = 128,
              return_state: bool = False):
    """Chunked SSD forward (on DTensors: :func:`_on_batch_shards`).  See
    :func:`_ssd_apply`."""
    if is_dtensor(x):
        return _on_batch_shards(_ssd_apply, p, cfg, x, chunk=chunk,
                                return_state=return_state)
    return _ssd_apply(p, cfg, x, chunk=chunk, return_state=return_state)


def _ssd_apply(p: dict, cfg, x: torch.Tensor, *, chunk: int = 128,
               return_state: bool = False):
    """Chunked SSD forward.  x: (B, S, d) -> y: (B, S, d); with
    ``return_state`` also the :class:`SSMCache` after the last position
    (the fp32 state, the conv history in x's dtype).  The chunk is
    ``Q = min(chunk, S)``, and S must be a multiple of it."""
    B, S, d = x.shape
    di, nh, n, conv_dim = _dims(cfg)
    hd = cfg.ssm_headdim
    Q = min(chunk, S)
    if S % Q:        # the reference asserts it; padding would change the state
        raise ValueError(
            f"a sequence of {S} positions does not split into SSD chunks "
            f"of {Q}: past {chunk} positions its length must be a "
            f"multiple of {chunk}")
    nc = S // Q

    zxbcdt = x @ p["in_proj"]
    z, xin, bmat, cmat, dt_raw = _split_proj(cfg, zxbcdt)
    u = torch.cat([xin, bmat, cmat], dim=-1)
    conv_out = F.silu(_conv_causal(u, p["conv_w"], p["conv_b"]))
    xin, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)

    xin = shard_activation(xin, ("batch", "seq", "act_ssm_inner"))
    xh = xin.reshape(B, nc, Q, nh, hd)
    dt = _softplus(dt_raw.float() + p["dt_bias"])             # (B,S,nh)
    dt = dt.reshape(B, nc, Q, nh)
    a = -torch.exp(p["a_log"].float())                        # (nh,)
    la = torch.cumsum(dt * a, dim=2)                          # (B,nc,Q,nh)
    bm = bmat.reshape(B, nc, Q, n).float()
    cm = cmat.reshape(B, nc, Q, n).float()
    xf = xh.float()

    # ---- intra-chunk (quadratic in Q) -------------------------------------
    cb = torch.einsum("bcqn,bcjn->bcqj", cm, bm)              # (B,nc,Q,Q)
    qi = torch.arange(Q, device=x.device)
    causal = (qi[:, None] >= qi[None, :])[None, None, :, :, None]  # j <= q
    diff = la[:, :, :, None, :] - la[:, :, None, :, :]        # (B,nc,Q,Q,nh)
    decay = torch.exp(torch.where(causal, diff, -math.inf))
    m = cb[..., None] * decay * dt[:, :, None, :, :]          # (B,nc,Q,Q,nh)
    y_intra = torch.einsum("bcqjh,bcjhp->bcqhp", m, xf)

    # ---- chunk states ------------------------------------------------------
    rem = torch.exp(la[:, :, -1:, :] - la)                    # (B,nc,Q,nh)
    sc = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bm, rem * dt, xf)

    # ---- inter-chunk recurrence: the state before each chunk ---------------
    chunk_decay = torch.exp(la[:, :, -1, :])                  # (B,nc,nh)
    h = torch.zeros((B, nh, hd, n), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + sc[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                     # (B,nc,nh,hd,n)

    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cm, torch.exp(la),
                           h_prevs)
    y = y_intra + y_inter + p["d_skip"][:, None] * xf         # (B,nc,Q,nh,hd)
    y = y.reshape(B, S, di).to(x.dtype)

    # gated RMSNorm + output projection
    y32 = y.float()
    scale = torch.rsqrt((y32 * y32).mean(-1, keepdim=True) + cfg.norm_eps)
    y = (y32 * scale).to(x.dtype) * p["norm"] * F.silu(z)
    out = shard_activation(y @ p["out_proj"], ("batch", "seq", "act_embed"))

    if return_state:
        conv_state = F.pad(u, (0, 0, cfg.d_conv - 1, 0))[
            :, -(cfg.d_conv - 1):, :]
        return out, SSMCache(h=h, conv=conv_state)
    return out


def ssd_decode_step(p: dict, cfg, x: torch.Tensor,
                    cache: SSMCache) -> tuple[torch.Tensor, SSMCache]:
    """One-token recurrent update (on DTensors: :func:`_on_batch_shards`).
    See :func:`_ssd_decode_step`."""
    if is_dtensor(x):
        return _on_batch_shards(_ssd_decode_step, p, cfg, x, cache=cache)
    return _ssd_decode_step(p, cfg, x, cache)


def _ssd_decode_step(p: dict, cfg, x: torch.Tensor,
                     cache: SSMCache) -> tuple[torch.Tensor, SSMCache]:
    """One-token recurrent update.  x: (B, 1, d) -> (B, 1, d).  Writes the
    new state and conv history into ``cache`` in place (each cast to its
    leaf's dtype) and returns it."""
    B = x.shape[0]
    di, nh, n, conv_dim = _dims(cfg)
    hd = cfg.ssm_headdim

    zxbcdt = x[:, 0] @ p["in_proj"]                        # (B, proj)
    z, xin, bmat, cmat, dt_raw = _split_proj(cfg, zxbcdt)
    u_t = torch.cat([xin, bmat, cmat], dim=-1)             # (B, conv_dim)
    full = torch.cat([cache.conv.float(), u_t[:, None].float()], dim=1)
    conv_out = torch.einsum("bdc,dc->bc", full,
                            p["conv_w"].float()) + p["conv_b"]
    conv_out = F.silu(conv_out)
    xin, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)

    xt = xin.reshape(B, nh, hd)
    dt = _softplus(dt_raw.float() + p["dt_bias"])          # (B,nh)
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt * a)                              # (B,nh)
    dbx = torch.einsum("bh,bhp,bn->bhpn", dt, xt, bmat)
    h = decay[:, :, None, None] * cache.h.float() + dbx
    y = torch.einsum("bhpn,bn->bhp", h, cmat) \
        + p["d_skip"][:, None] * xt                        # (B,nh,hd)
    y = y.reshape(B, di)

    scale = torch.rsqrt((y * y).mean(-1, keepdim=True) + cfg.norm_eps)
    y = (y * scale).to(x.dtype) * p["norm"] * F.silu(z)
    out = (y @ p["out_proj"])[:, None, :]
    cache.h.copy_(h)
    cache.conv.copy_(full[:, 1:])
    return out, cache
