"""Model assembly for the ``dense`` and ``moe`` families (counterpart of
``repro.models.transformer``).

* dense — pre-norm GQA transformer (llama3 / qwen2 / phi3 / chameleon)
* moe   — dense attention + top-k expert FFN (granite / moonshot)

Parameters are stacked over layers (a leading ``L`` dim, the reference's
layout, so weights carry across one to one and the engine splices a
request's caches at ``[:, slot:slot+1]``); the reference's ``lax.scan`` over
the stack is a Python loop over the layer index here.  Entry points:

``model_schema / init_params``         parameters
``forward``                            full-sequence logits (train/prefill)
``lm_loss``                            next-token CE (the train step core)
``prefill``                            a prompt into the decode state
``init_decode_state / decode_step``    single-token serving step

``prefill`` and ``decode_step`` write the decode state's caches in place and
return it.  Remat (``forward(remat=True)``, the reference's default) wraps
each layer in ``torch.utils.checkpoint`` (non-reentrant: only the layer's
input is kept, the rest recomputed in the backward), or with
``remat_groups`` G > 1 dividing the depth, each group of layers too, as the
reference's ``_scan_layers`` nests its ``jax.checkpoint``; it acts only
where autograd records.  The ``ssm``, ``hybrid`` and ``encdec`` families
are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.params import (P, init_params as _init, tree_leaves,
                                       tree_map, unflatten)

__all__ = ["model_schema", "init_params", "layer_windows", "forward",
           "lm_loss", "prefill", "DecodeState", "init_decode_state",
           "decode_step", "torch_dtype"]

PORTED_FAMILIES = ("dense", "moe")


def _check_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port serves "
            f"{PORTED_FAMILIES} (ROADMAP Queue 1 item 10: models/ssm.py and "
            f"the ssm, hybrid and encdec branches)")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


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


def _layer_schema(cfg) -> dict:
    ffn = ({"moe": MOE.moe_schema(cfg)} if cfg.family == "moe"
           else {"mlp": L.mlp_schema(cfg)})
    return {"ln1": P((cfg.d_model,), ("embed",), init="ones"),
            "attn": L.attention_schema(cfg),
            "ln2": P((cfg.d_model,), ("embed",), init="ones"),
            **ffn}


def model_schema(cfg) -> dict:
    _check_family(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "embed": P((v, d), ("vocab", "embed"), fan_in_axes=(1,)),
        "out_head": P((d, v), ("embed", "vocab"), fan_in_axes=(0,)),
        "final_norm": P((d,), ("embed",), init="ones"),
        "layers": _stack(_layer_schema(cfg), cfg.n_layers),
    }


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
    """Per-layer attention window (0 = full): ``cfg.swa_window`` in every
    layer of the dense and MoE families (the reference's global layers
    belong to the hybrid family)."""
    return np.full(cfg.n_layers, cfg.swa_window, np.int32)


def _layer(stacked: dict, i: int) -> dict:
    return tree_map(lambda a: a[i], stacked)


def _ffn(cfg, h, lp):
    """The second half of a layer: (h + FFN(norm(h)), aux)."""
    xn = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = MOE.moe_apply(lp["moe"], cfg, xn)
        return h + y, aux
    return h + L.mlp_apply(lp["mlp"], xn), None


def _logits(h: torch.Tensor, out_head: torch.Tensor) -> torch.Tensor:
    """The output head in fp32 (the reference's fp32 product of the final
    hidden state and the head)."""
    return h.float() @ out_head.float()


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------
def _layer_fwd(cfg, h, lp, positions, window: int):
    """One layer, full sequence.  Returns (h, aux); aux is None for dense."""
    h = h + L.attention_apply(lp["attn"], cfg,
                              L.rms_norm(h, lp["ln1"], cfg.norm_eps),
                              positions, window=window)
    return _ffn(cfg, h, lp)


def _unstack(stacked: dict, n: int) -> list[dict]:
    """Layer i's parameters for every i: views of the stacked leaves, made
    with one ``unbind`` a leaf, so the backward stacks each leaf's layer
    gradients once (slicing layer by layer would sum a full-size zero
    tensor per layer)."""
    flat = [(path, a.unbind(0)) for path, a in tree_leaves(stacked)]
    return [unflatten({path: parts[i] for path, parts in flat})
            for i in range(n)]


def _run_layers(cfg, h, layers: list[dict], positions, remat: bool,
                remat_groups: int):
    """The layer loop with single- or two-level rematerialization (the
    reference's ``_scan_layers``): with ``remat_groups`` G > 1 dividing the
    depth, each group of layers is checkpointed around its checkpointed
    layers, so only the G group inputs stay alive between the forward and
    the backward.  Returns (h, aux summed layer by layer into fp32
    zeros, the reference's carry)."""
    windows = [int(w) for w in layer_windows(cfg)]
    remat = remat and torch.is_grad_enabled()

    def one(hh, i):
        return _layer_fwd(cfg, hh, layers[i], positions, windows[i])

    def span(hh, aux, idx):
        for i in idx:
            hh, a = (checkpoint(one, hh, i, use_reentrant=False) if remat
                     else one(hh, i))
            if a is not None:
                aux = aux + a
        return hh, aux

    n, G = len(layers), remat_groups
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if remat and G > 1 and n % G == 0:
        per = n // G
        for g in range(G):
            h, aux = checkpoint(span, h, aux, range(g * per, (g + 1) * per),
                                use_reentrant=False)
        return h, aux
    return span(h, aux, range(n))


def forward(params, cfg, tokens: torch.Tensor, remat: bool = True,
            remat_groups: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits.  tokens: (B, S) integer.
    Returns (logits (B, S, V) fp32, aux_loss scalar)."""
    _check_family(cfg)
    # an embedding lookup, whose backward sums each row's gradients in a
    # fixed order (an indexing gather's backward accumulates them in an
    # order that varies from run to run on the CPU)
    h = F.embedding(tokens.long(), params["embed"])
    positions = torch.arange(h.shape[1], device=h.device)
    h, aux = _run_layers(cfg, h, _unstack(params["layers"], cfg.n_layers),
                         positions, remat, remat_groups)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(h, params["out_head"]), aux


def lm_loss(params, cfg, batch: dict, remat: bool = True,
            remat_groups: int = 0):
    """Next-token cross entropy in fp32 plus 0.01 x the MoE load-balancing
    aux.  batch: ``{"tokens": (B, S)}``.  Returns (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    logits, aux = forward(params, cfg, tokens, remat=remat,
                          remat_groups=remat_groups)
    labels = tokens[:, 1:].long()
    lg = logits[:, :-1].float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, labels[..., None])[..., 0]
    ce = (logz - gold).mean()
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode state, prefill and decode
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    """Per-model decode state (the reference's also holds the SSM and
    cross-attention caches of the families not ported here)."""
    attn: L.PosCache   # stacked over layers: (L, B, ...)


def init_decode_state(cfg, batch: int, cache_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device: str | torch.device = "cuda") -> DecodeState:
    _check_family(cfg)
    flat = L.init_pos_cache(cfg, cfg.n_layers * batch, cache_len, dtype,
                            device)
    return DecodeState(attn=L.PosCache(
        *(c.unflatten(0, (cfg.n_layers, batch)) for c in flat)))


def _layer_cache(state: DecodeState, i: int) -> L.PosCache:
    """Layer ``i``'s cache: views into the stacked state."""
    return L.PosCache(*(c[i] for c in state.attn))


def _write_prefix(cache: L.PosCache, k, v, positions) -> None:
    """Write full-sequence K/V into cache slots [0, S) (linear layout)."""
    S = k.shape[1]
    cache.k[:, :S] = k.to(cache.k.dtype)
    cache.v[:, :S] = v.to(cache.v.dtype)
    cache.pos[:, :S] = positions.to(torch.int32)[None, :]


def prefill(params, cfg, tokens: torch.Tensor, state: DecodeState,
            valid_len: int | None = None):
    """Process a prompt, writing the decode state's caches in place.

    tokens: (B, S) prompt.  Returns (last-position logits (B, V) fp32, the
    state).  Decoding then continues from t = S.

    ``valid_len``, if given, marks only the first ``valid_len`` tokens as
    real: the prompt may be zero-padded to a bucketed length S.  Causality
    means the pad suffix never influences the real prefix; its cache slots
    are written with position -1, which every decode-time mask excludes,
    and the logits are read at position ``valid_len - 1``.  Only
    meaningful for dense attention: MoE routing counts pad tokens against
    expert capacity, so callers keep exact lengths there.
    """
    _check_family(cfg)
    h = params["embed"][tokens.long()]
    positions = torch.arange(h.shape[1], device=h.device)
    pos_write = positions if valid_len is None else torch.where(
        positions < int(valid_len), positions, -1)
    for i, w in enumerate(layer_windows(cfg)):
        lp = _layer(params["layers"], i)
        xn = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
        a, (k, v) = L.attention_apply(lp["attn"], cfg, xn, positions,
                                      window=int(w), return_kv=True)
        _write_prefix(_layer_cache(state, i), k, v, pos_write)
        h, _ = _ffn(cfg, h + a, lp)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    # the last REAL position: the bucket's pad suffix carries no signal
    last = h[:, -1] if valid_len is None else h[:, int(valid_len) - 1]
    return _logits(last, params["out_head"]), state


def decode_step(params, cfg, tokens: torch.Tensor, state: DecodeState,
                t) -> tuple[torch.Tensor, DecodeState]:
    """One serving step: tokens (B, 1) at absolute position(s) t (an int,
    or a (B,) tensor of per-row positions).  Writes the caches in place;
    returns (logits (B, V) fp32, the state)."""
    _check_family(cfg)
    h = params["embed"][tokens.long()]                  # (B, 1, d)
    tv = torch.as_tensor(t, dtype=torch.int32, device=h.device)
    for i, w in enumerate(layer_windows(cfg)):
        lp = _layer(params["layers"], i)
        a, _ = L.attention_cached(lp["attn"], cfg,
                                  L.rms_norm(h, lp["ln1"], cfg.norm_eps),
                                  tv, _layer_cache(state, i), window=int(w))
        h, _ = _ffn(cfg, h + a, lp)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(h, params["out_head"])[:, 0], state
