"""Model assembly: every LM family behind one API (counterpart of
``repro.models.transformer``).

* dense  — pre-norm GQA transformer (llama3 / qwen2 / phi3 / chameleon)
* moe    — dense attention + top-k expert FFN (granite / moonshot)
* ssm    — Mamba-2 SSD stack, attention-free (mamba2-2.7b)
* hybrid — parallel attention+SSM heads per layer, meta tokens, SWA (hymba)
* encdec — encoder + cross-attending decoder (seamless-m4t)

Parameters are stacked over layers (a leading ``L`` dim, the reference's
layout, so weights carry across one to one and the engine splices a
request's caches at ``[:, slot:slot+1]``); the reference's ``lax.scan`` over
the stack is a Python loop over the layer index here.  Entry points:

``model_schema / init_params``         parameters
``encode``                             the encoder stack (encdec)
``forward``                            full-sequence logits (train/prefill)
``lm_loss``                            next-token CE (the train step core)
``prefill``                            a prompt into the decode state
``init_decode_state / decode_step``    single-token serving step

``prefill`` and ``decode_step`` write the decode state's caches in place and
return it.  Under a mesh (DTensor parameters from ``param_pspecs`` inside
an ``activation_sharding`` context) each layer's weights are gathered over
the FSDP axes where the layer runs (``unshard_fsdp``), and the reference's
``shard_activation`` sites call the port's; outside a mesh both are
no-ops.  Remat (``forward(remat=True)``, the reference's default) wraps
each layer in ``torch.utils.checkpoint`` (non-reentrant: only the layer's
input is kept, the rest recomputed in the backward), or with
``remat_groups`` G > 1 dividing the depth, each group of layers too, as the
reference's ``_scan_layers`` nests its ``jax.checkpoint``; it acts only
where autograd records.  The SSD splits a sequence into chunks of
``min(128, S)`` positions at prefill (the forward's default chunk is 128
as well), so a sequence longer than 128 positions, hybrid's meta prefix
included, must be a multiple of 128: other lengths are refused before any
cache is written.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (from_local, is_dtensor,
                                              shard_activation, shard_window,
                                              unshard_fsdp)
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.params import (P, init_params as _init, tree_leaves,
                                       tree_map, unflatten)

__all__ = ["model_schema", "init_params", "layer_windows", "encode",
           "forward", "lm_loss", "prefill", "DecodeState",
           "init_decode_state", "decode_step", "torch_dtype"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
PREFILL_CHUNK = 128          # the SSD chunk of prefill: min(128, S)


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}: the models are "
                         f"{FAMILIES}")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _n_meta(cfg) -> int:
    return cfg.n_meta_tokens if cfg.family == "hybrid" else 0


def _has_ssm(cfg) -> bool:
    return cfg.family in ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------
def _stack(schema: dict, n: int) -> dict:
    """Prepend a stacked 'layers' dimension to every leaf."""
    def bump(leaf: P) -> P:
        return P((n, *leaf.shape), ("layers", *leaf.axes), init=leaf.init,
                 fan_in_axes=tuple(a + 1 for a in leaf.fan_in_axes),
                 scale=leaf.scale)
    return tree_map(bump, schema)


def _norm(cfg) -> P:
    return P((cfg.d_model,), ("embed",), init="ones")


def _dense_layer_schema(cfg) -> dict:
    return {"ln1": _norm(cfg), "attn": L.attention_schema(cfg),
            "ln2": _norm(cfg), "mlp": L.mlp_schema(cfg)}


def _moe_layer_schema(cfg) -> dict:
    return {"ln1": _norm(cfg), "attn": L.attention_schema(cfg),
            "ln2": _norm(cfg), "moe": MOE.moe_schema(cfg)}


def _ssm_layer_schema(cfg) -> dict:
    return {"ln1": _norm(cfg), "ssm": SSM.ssm_schema(cfg)}


def _hybrid_layer_schema(cfg) -> dict:
    return {"ln1": _norm(cfg), "attn": L.attention_schema(cfg),
            "ssm": SSM.ssm_schema(cfg), "norm_attn": _norm(cfg),
            "norm_ssm": _norm(cfg), "ln2": _norm(cfg),
            "mlp": L.mlp_schema(cfg)}


def _enc_layer_schema(cfg) -> dict:
    return _dense_layer_schema(cfg)


def _dec_layer_schema(cfg) -> dict:
    return {"ln1": _norm(cfg), "attn": L.attention_schema(cfg),
            "ln_cross": _norm(cfg), "cross": L.attention_schema(cfg),
            "ln2": _norm(cfg), "mlp": L.mlp_schema(cfg)}


_LAYER_SCHEMAS = {"dense": _dense_layer_schema, "moe": _moe_layer_schema,
                  "ssm": _ssm_layer_schema, "hybrid": _hybrid_layer_schema,
                  "encdec": _dec_layer_schema}


def model_schema(cfg) -> dict:
    _check_family(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    sch: dict[str, Any] = {
        "embed": P((v, d), ("vocab", "embed"), fan_in_axes=(1,)),
        "out_head": P((d, v), ("embed", "vocab"), fan_in_axes=(0,)),
        "final_norm": _norm(cfg),
        "layers": _stack(_LAYER_SCHEMAS[cfg.family](cfg), cfg.n_layers),
    }
    if cfg.family == "hybrid" and cfg.n_meta_tokens:
        sch["meta_tokens"] = P((cfg.n_meta_tokens, d), (None, "embed"),
                               fan_in_axes=(1,))
    if cfg.family == "encdec":
        sch["enc_layers"] = _stack(_enc_layer_schema(cfg), cfg.enc_layers)
        sch["enc_final_norm"] = _norm(cfg)
    return sch


def init_params(cfg, gen: torch.Generator | int = 0,
                dtype: torch.dtype | None = None,
                device: str | torch.device = "cuda") -> dict:
    """Random-init parameters in ``dtype`` (default ``cfg.dtype``) on
    ``device``, from ``gen`` (a generator on that device, or a seed)."""
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    return _init(model_schema(cfg), gen, dtype or torch_dtype(cfg.dtype),
                 dev)


def layer_windows(cfg) -> np.ndarray:
    """Per-layer attention window (0 = full).  Hybrid: first/middle/last
    layers are global, the rest use cfg.swa_window (Hymba recipe)."""
    w = np.full(cfg.n_layers, cfg.swa_window, np.int32)
    if cfg.family == "hybrid" and cfg.n_global_layers > 0:
        idx = np.linspace(0, cfg.n_layers - 1,
                          cfg.n_global_layers).astype(int)
        w[idx] = 0
    return w


def _layer(stacked: dict, i: int) -> dict:
    return unshard_fsdp(tree_map(lambda a: a[i], stacked))


def _ffn(cfg, h, lp):
    """The second half of a layer: (h + FFN(norm(h)), aux)."""
    xn = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = MOE.moe_apply(lp["moe"], cfg, xn)
        return h + y, aux
    return h + L.mlp_apply(lp["mlp"], xn), None


def _mix(cfg, lp, a, s):
    """Hymba's head fusion: the mean of the normed attention and SSM
    outputs."""
    return 0.5 * (L.rms_norm(a, lp["norm_attn"], cfg.norm_eps)
                  + L.rms_norm(s, lp["norm_ssm"], cfg.norm_eps))


def _logits(h: torch.Tensor, out_head: torch.Tensor) -> torch.Tensor:
    """The output head in fp32 (the reference's fp32 product of the final
    hidden state and the head)."""
    return h.float() @ unshard_fsdp(out_head).float()


def _embed(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings, placed as the reference's full forward places
    them (under a mesh: a vocab-sharded lookup is a partial sum until
    then), with hybrid's meta tokens prepended.  An embedding lookup,
    whose backward sums each row's gradients in a fixed order (an indexing
    gather's backward accumulates them in an order that varies from run to
    run on the CPU)."""
    h = _lookup(unshard_fsdp(params["embed"]), tokens)
    n_meta = _n_meta(cfg)
    if n_meta:
        meta = unshard_fsdp(params["meta_tokens"])[None].expand(
            h.shape[0], n_meta, cfg.d_model).to(h.dtype)
        h = torch.cat([meta, h], dim=1)
    return h


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``F.embedding`` of the tokens, placed as the reference's full
    forward places the embeddings (batch over the data axes).  A DTensor
    table with its vocabulary sharded over ``model`` is looked up shard
    by shard: each rank reads the rows it holds for its batch shard's
    tokens, and one all-reduce over ``model`` sums the pieces (DTensor's
    own vocab-sharded lookup leaves a partial sum whose gradient it
    cannot route back)."""
    if not is_dtensor(table):
        return F.embedding(tokens.long(), table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    if not is_dtensor(tokens):
        tokens = from_local(tokens, mesh, [Replicate()] * len(names))
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    out_pl = [Shard(0) if (n != "model" and tokens.shape[0] % mesh.shape[i]
                           == 0) else Replicate()
              for i, n in enumerate(names)]
    tok = tokens.redistribute(mesh, out_pl).to_local().long()
    w_pl = [p if i in vocab else Replicate()
            for i, p in enumerate(table.placements)]
    w_grad = [p if i in vocab else (Partial() if out_pl[i] == Shard(0)
                                    else Replicate())
              for i, p in enumerate(table.placements)]
    w = table.redistribute(mesh, w_pl).to_local(grad_placements=w_grad)
    _, off = shard_window(table.shape, mesh, w_pl)
    V = w.shape[0]
    idx = tok - off[0]
    mine = (idx >= 0) & (idx < V)
    h = F.embedding(idx.clamp(0, V - 1), w) * mine[..., None].to(w.dtype)
    for i in vocab:
        h = L._SumOver.apply(h, "sum", mesh.get_group(names[i]).group_name)
    return from_local(h, mesh, out_pl, (*tokens.shape, table.shape[1]))


def _check_length(cfg, S: int) -> None:
    """Refuse, before any cache is written, a sequence of S positions
    (hybrid's meta prefix included) that the SSD's chunks of
    ``min(PREFILL_CHUNK, S)`` positions would not tile."""
    if _has_ssm(cfg) and S % min(PREFILL_CHUNK, S):
        n_meta = _n_meta(cfg)
        parts = (f" ({n_meta} meta tokens and {S - n_meta} of the prompt)"
                 if n_meta else "")
        raise ValueError(
            f"{cfg.name}: {S} positions{parts} do not split into SSD chunks "
            f"of {PREFILL_CHUNK}: past {PREFILL_CHUNK} positions a sequence "
            f"must be a multiple of {PREFILL_CHUNK}")


# ---------------------------------------------------------------------------
# Layer bodies (full-sequence)
# ---------------------------------------------------------------------------
def _layer_fwd(cfg, h, lp, positions, window: int):
    """One layer, full sequence.  Returns (h, aux); aux is None but for
    MoE."""
    xn = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        return h + SSM.ssd_apply(lp["ssm"], cfg, xn), None
    a = L.attention_apply(lp["attn"], cfg, xn, positions, window=window)
    if cfg.family == "hybrid":
        h = h + _mix(cfg, lp, a, SSM.ssd_apply(lp["ssm"], cfg, xn))
    else:
        h = h + a
    return _ffn(cfg, h, lp)


def _dec_layer_fwd(cfg, h, lp, positions, enc_out, enc_positions):
    h = h + L.attention_apply(lp["attn"], cfg,
                              L.rms_norm(h, lp["ln1"], cfg.norm_eps),
                              positions)
    h = h + L.attention_apply(lp["cross"], cfg,
                              L.rms_norm(h, lp["ln_cross"], cfg.norm_eps),
                              positions, causal=False, kv_x=enc_out,
                              kv_positions=enc_positions)
    return _ffn(cfg, h, lp)


def _unstack(stacked: dict, n: int) -> list[dict]:
    """Layer i's parameters for every i: views of the stacked leaves, made
    with one ``unbind`` a leaf, so the backward stacks each leaf's layer
    gradients once (slicing layer by layer would sum a full-size zero
    tensor per layer)."""
    flat = [(path, a.unbind(0)) for path, a in tree_leaves(stacked)]
    return [unflatten({path: parts[i] for path, parts in flat})
            for i in range(n)]


def _run_layers(h, n: int, one, remat: bool, remat_groups: int):
    """The layer loop ``h, aux = one(h, i)`` for i < n with single- or
    two-level rematerialization (the reference's ``_scan_layers``): with
    ``remat_groups`` G > 1 dividing the depth, each group of layers is
    checkpointed around its checkpointed layers, so only the G group
    inputs stay alive between the forward and the backward.  Returns (h,
    aux summed layer by layer into fp32 zeros, the reference's carry)."""
    remat = remat and torch.is_grad_enabled()

    def span(hh, aux, idx):
        for i in idx:
            hh, a = (checkpoint(one, hh, i, use_reentrant=False) if remat
                     else one(hh, i))
            if a is not None:
                aux = aux + a
        return hh, aux

    G = remat_groups
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if remat and G > 1 and n % G == 0:
        per = n // G
        for g in range(G):
            h, aux = checkpoint(span, h, aux, range(g * per, (g + 1) * per),
                                use_reentrant=False)
        return h, aux
    return span(h, aux, range(n))


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------
def encode(params, cfg, enc_input: torch.Tensor, remat: bool = True,
           remat_groups: int = 0) -> torch.Tensor:
    """Encoder stack over precomputed frame embeddings (stub frontend):
    bidirectional attention, then the encoder's final norm."""
    pos = torch.arange(enc_input.shape[1], device=enc_input.device)
    layers = _unstack(params["enc_layers"], cfg.enc_layers)

    def one(hh, i):
        lp = unshard_fsdp(layers[i])
        hh = hh + L.attention_apply(lp["attn"], cfg,
                                    L.rms_norm(hh, lp["ln1"], cfg.norm_eps),
                                    pos, causal=False)
        return hh + L.mlp_apply(lp["mlp"],
                                L.rms_norm(hh, lp["ln2"], cfg.norm_eps)), None

    h, _ = _run_layers(enc_input, cfg.enc_layers, one, remat, remat_groups)
    return L.rms_norm(h, unshard_fsdp(params["enc_final_norm"]),
                      cfg.norm_eps)


def _need_enc(cfg, enc_input):
    if cfg.family == "encdec" and enc_input is None:
        raise ValueError(f"{cfg.name}: the encoder-decoder family needs "
                         f"enc_input (B, Se, d_model)")


def forward(params, cfg, tokens: torch.Tensor,
            enc_input: torch.Tensor | None = None, remat: bool = True,
            remat_groups: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits.

    tokens: (B, S) integer (decoder tokens for encdec).
    enc_input: (B, Se, d) stub frontend embeddings (encdec only).
    Returns (logits (B, S, V) fp32, aux_loss scalar); hybrid's meta
    positions are dropped from the logits."""
    _check_family(cfg)
    _need_enc(cfg, enc_input)
    h = _embed(params, cfg, tokens)
    _check_length(cfg, h.shape[1])
    positions = torch.arange(h.shape[1], device=h.device)
    layers = _unstack(params["layers"], cfg.n_layers)

    if cfg.family == "encdec":
        enc_out = encode(params, cfg, enc_input, remat=remat,
                         remat_groups=remat_groups)
        enc_pos = torch.arange(enc_out.shape[1], device=h.device)

        def one(hh, i):
            return _dec_layer_fwd(cfg, hh, unshard_fsdp(layers[i]),
                                  positions, enc_out, enc_pos)
    else:
        windows = [int(w) for w in layer_windows(cfg)]

        def one(hh, i):
            return _layer_fwd(cfg, hh, unshard_fsdp(layers[i]), positions,
                              windows[i])

    h, aux = _run_layers(h, cfg.n_layers, one, remat, remat_groups)
    h = L.rms_norm(h, unshard_fsdp(params["final_norm"]), cfg.norm_eps)
    logits = _logits(h[:, _n_meta(cfg):], params["out_head"])
    return shard_activation(logits, ("batch", "seq", "act_vocab")), aux


def lm_loss(params, cfg, batch: dict, remat: bool = True,
            remat_groups: int = 0):
    """Next-token cross entropy in fp32 plus 0.01 x the MoE load-balancing
    aux.  batch: ``{"tokens": (B, S)}`` [+ ``"enc_input"``].  Returns
    (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    logits, aux = forward(params, cfg, tokens,
                          enc_input=batch.get("enc_input"), remat=remat,
                          remat_groups=remat_groups)
    labels = tokens[:, 1:].long()
    lg = logits[:, :-1].float()
    if is_dtensor(lg):
        logz, gold = _vocab_parallel_terms(lg, labels)
    else:
        logz = torch.logsumexp(lg, dim=-1)
        gold = lg.gather(-1, labels[..., None])[..., 0]
    ce = (logz - gold).mean()
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


def _vocab_parallel_terms(lg, labels):
    """``logsumexp`` over the vocabulary and the gold logit of DTensor
    logits (B, S, V) whose vocabulary may be sharded over ``model`` (the
    reference's ``act_vocab``): each rank reduces its slice, and the
    maxima, exponential sums and gold picks are combined by all-reduces,
    so no rank gathers the logits.  Both come back as DTensors with the
    batch sharded as the logits' and replicated over ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = lg.device_mesh
    names = mesh.mesh_dim_names
    vocab_sharded = [i for i, p in enumerate(lg.placements)
                     if p == Shard(2)]
    lab_pl = [Replicate() if i in vocab_sharded else p
              for i, p in enumerate(lg.placements)]
    ll = lg.to_local()
    lab = labels.redistribute(mesh, lab_pl).to_local()
    _, off = shard_window(lg.shape, mesh, lg.placements)
    V = ll.shape[-1]
    idx = lab - off[2]
    mine = (idx >= 0) & (idx < V)
    gold = ll.gather(-1, idx.clamp(0, V - 1)[..., None])[..., 0] \
        * mine.to(ll.dtype)
    m = ll.amax(dim=-1).detach()
    for i in vocab_sharded:
        group = mesh.get_group(names[i]).group_name
        m = L._SumOver.apply(m, "max", group)
    e = torch.exp(ll - m[..., None]).sum(dim=-1)
    for i in vocab_sharded:
        group = mesh.get_group(names[i]).group_name
        e = L._SumOver.apply(e, "sum", group)
        gold = L._SumOver.apply(gold, "sum", group)
    logz = m + torch.log(e)
    return (from_local(logz, mesh, lab_pl, labels.shape),
            from_local(gold, mesh, lab_pl, labels.shape))


# ---------------------------------------------------------------------------
# Decode state, prefill and decode
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    """Per-model decode state, stacked over layers (L, B, ...); a field a
    family does not use is ``()``."""
    attn: Any = ()       # L.PosCache: dense, moe, hybrid, encdec
    ssm: Any = ()        # SSM.SSMCache, fp32: ssm, hybrid
    cross_k: Any = ()    # (L, B, Se, K, Dh): encdec
    cross_v: Any = ()


def init_decode_state(cfg, batch: int, cache_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device: str | torch.device = "cuda",
                      enc_len: int = 0) -> DecodeState:
    """Zeroed caches for ``batch`` rows: ``cache_len`` positions of K/V in
    ``dtype`` (plus hybrid's meta prefix), the SSM state and conv history
    in fp32 whatever ``dtype`` says (as the reference's), and encdec's
    cross K/V over ``enc_len`` encoder positions."""
    _check_family(cfg)
    dev = resolve_device(device)
    attn: Any = ()
    ssm: Any = ()
    ck: Any = ()
    cv: Any = ()
    if cfg.family != "ssm":
        flat = L.init_pos_cache(cfg, cfg.n_layers * batch,
                                cache_len + _n_meta(cfg), dtype, dev)
        attn = L.PosCache(*(c.unflatten(0, (cfg.n_layers, batch))
                            for c in flat))
    if _has_ssm(cfg):
        flat = SSM.init_ssm_cache(cfg, cfg.n_layers * batch, torch.float32,
                                  dev)
        ssm = SSM.SSMCache(*(c.unflatten(0, (cfg.n_layers, batch))
                             for c in flat))
    if cfg.family == "encdec":
        shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        ck = torch.zeros(shape, dtype=dtype, device=dev)
        cv = torch.zeros(shape, dtype=dtype, device=dev)
    return DecodeState(attn=attn, ssm=ssm, cross_k=ck, cross_v=cv)


def _layer_cache(state: DecodeState, i: int) -> L.PosCache:
    """Layer ``i``'s attention cache: views into the stacked state."""
    return L.PosCache(*(c[i] for c in state.attn))


def _layer_ssm(state: DecodeState, i: int) -> SSM.SSMCache:
    """Layer ``i``'s SSM cache: views into the stacked state."""
    return SSM.SSMCache(*(c[i] for c in state.ssm))


def _write_prefix(cache: L.PosCache, k, v, positions) -> None:
    """Write full-sequence K/V into cache slots [0, S) (linear layout)."""
    L.write_prefix(cache.k, k)
    L.write_prefix(cache.v, v)
    L.write_prefix(cache.pos, positions.to(torch.int32)[None, :].expand(
        cache.pos.shape[0], k.shape[1]))


def _write_ssm(cache: SSM.SSMCache, new: SSM.SSMCache) -> None:
    """Overwrite a layer's SSM cache whole (the state, the conv history),
    cast to the cache's dtype."""
    cache.h.copy_(new.h)
    cache.conv.copy_(new.conv)


def _cross_kv(cfg, lp, enc_out, enc_pos):
    """The cross-attention's K (with ``k_norm`` where set, roped at the
    encoder's positions) and V (neither) of the encoder's output."""
    ck = torch.einsum("bsd,dhk->bshk", enc_out, lp["cross"]["wk"])
    cv = torch.einsum("bsd,dhk->bshk", enc_out, lp["cross"]["wv"])
    if cfg.qkv_bias:
        ck, cv = ck + lp["cross"]["bk"], cv + lp["cross"]["bv"]
    if cfg.qk_norm:
        ck = L.rms_norm(ck, lp["cross"]["k_norm"], cfg.norm_eps)
    return L.rope(ck, enc_pos, cfg.rope_theta), cv


def prefill(params, cfg, tokens: torch.Tensor, state: DecodeState,
            enc_input: torch.Tensor | None = None,
            valid_len: int | None = None):
    """Process a prompt, writing the decode state's caches in place.

    tokens: (B, S) prompt (content tokens; hybrid's meta tokens are added
    here and occupy cache slots [0, n_meta)); enc_input: (B, Se, d) for
    encdec, whose cross K/V fill ``state.cross_k``/``cross_v`` (replaced
    by new tensors where the state was made for another ``enc_len``).
    Returns (last-position logits (B, V) fp32, the state).  Decoding then
    continues from t = S (content position).

    ``valid_len``, if given, marks only the first ``valid_len`` content
    tokens as real: the prompt may be zero-padded to a bucketed length S.
    Causality means the pad suffix never influences the real prefix; its
    cache slots are written with position -1, which every decode-time mask
    excludes, and the logits are read at content position ``valid_len -
    1``.  Only meaningful for dense attention: an SSM state absorbs pad
    tokens and MoE routing counts them against expert capacity, so callers
    keep exact lengths there.
    """
    _check_family(cfg)
    _need_enc(cfg, enc_input)
    n_meta = _n_meta(cfg)
    h = _embed(params, cfg, tokens)
    S = h.shape[1]
    _check_length(cfg, S)
    positions = torch.arange(S, device=h.device)
    pos_write = positions if valid_len is None else torch.where(
        positions < n_meta + int(valid_len), positions, -1)
    chunk = min(PREFILL_CHUNK, S)

    if cfg.family == "encdec":
        enc_out = encode(params, cfg, enc_input, remat=False)
        enc_pos = torch.arange(enc_out.shape[1], device=h.device)
        shape = (cfg.n_layers, *enc_out.shape[:2], cfg.n_kv_heads,
                 cfg.head_dim)
        if tuple(state.cross_k.shape) != shape:
            dt = state.attn.k.dtype
            state = state._replace(
                cross_k=torch.empty(shape, dtype=dt, device=h.device),
                cross_v=torch.empty(shape, dtype=dt, device=h.device))

    for i, w in enumerate(layer_windows(cfg)):
        lp = _layer(params["layers"], i)
        xn = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
        if cfg.family == "ssm":
            y, new = SSM.ssd_apply(lp["ssm"], cfg, xn, chunk=chunk,
                                   return_state=True)
            _write_ssm(_layer_ssm(state, i), new)
            h = h + y
            continue
        a, (k, v) = L.attention_apply(lp["attn"], cfg, xn, positions,
                                      window=int(w), return_kv=True)
        _write_prefix(_layer_cache(state, i), k, v, pos_write)
        if cfg.family == "hybrid":
            s, new = SSM.ssd_apply(lp["ssm"], cfg, xn, chunk=chunk,
                                   return_state=True)
            _write_ssm(_layer_ssm(state, i), new)
            h = h + _mix(cfg, lp, a, s)
        else:
            h = h + a
        if cfg.family == "encdec":
            ck, cv = _cross_kv(cfg, lp, enc_out, enc_pos)
            state.cross_k[i] = ck.to(state.cross_k.dtype)
            state.cross_v[i] = cv.to(state.cross_v.dtype)
            h = h + L.attention_apply(
                lp["cross"], cfg, L.rms_norm(h, lp["ln_cross"], cfg.norm_eps),
                positions, causal=False, kv_x=enc_out, kv_positions=enc_pos)
        h, _ = _ffn(cfg, h, lp)
    h = L.rms_norm(h, unshard_fsdp(params["final_norm"]), cfg.norm_eps)
    # the last REAL content position: the bucket's pad suffix carries no
    # signal
    last = h[:, -1] if valid_len is None else h[:, n_meta + int(valid_len) - 1]
    return _logits(last, params["out_head"]), state


def decode_step(params, cfg, tokens: torch.Tensor, state: DecodeState,
                t) -> tuple[torch.Tensor, DecodeState]:
    """One serving step: tokens (B, 1) at absolute position(s) t (an int,
    or a (B,) tensor of per-row positions; encdec takes one position for
    the whole batch, as the reference's cross-attention does).  For hybrid
    models t indexes the *content* stream: the meta prefix occupies cache
    slots [0, n_meta) and position t maps to slot n_meta + t.  Writes the
    caches in place; returns (logits (B, V) fp32, the state)."""
    _check_family(cfg)
    h = _lookup(unshard_fsdp(params["embed"]), tokens)   # (B, 1, d)
    t_abs = torch.as_tensor(t, dtype=torch.int32, device=h.device) \
        + _n_meta(cfg)
    if cfg.family == "encdec" and t_abs.numel() != 1:
        raise ValueError(
            f"{cfg.name}: the encoder-decoder decodes every row at one "
            f"position (the reference's cross-attention ropes the query at "
            f"reshape(t, (1,))); got {t_abs.numel()} positions")
    for i, w in enumerate(layer_windows(cfg)):
        lp = _layer(params["layers"], i)
        xn = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
        if cfg.family == "ssm":
            y, _ = SSM.ssd_decode_step(lp["ssm"], cfg, xn,
                                       _layer_ssm(state, i))
            h = h + y
            continue
        a, _ = L.attention_cached(lp["attn"], cfg, xn, t_abs,
                                  _layer_cache(state, i), window=int(w))
        if cfg.family == "hybrid":
            s, _ = SSM.ssd_decode_step(lp["ssm"], cfg, xn,
                                       _layer_ssm(state, i))
            h = h + _mix(cfg, lp, a, s)
        else:
            h = h + a
        if cfg.family == "encdec":
            h = h + L.cross_attention_cached(
                lp["cross"], cfg, L.rms_norm(h, lp["ln_cross"], cfg.norm_eps),
                t_abs, state.cross_k[i], state.cross_v[i])
        h, _ = _ffn(cfg, h, lp)
    h = L.rms_norm(h, unshard_fsdp(params["final_norm"]), cfg.norm_eps)
    return _logits(h, params["out_head"])[:, 0], state
