"""The port's LM models (``repro_torch.models``, ``repro_torch.configs``)
against the JAX reference (``repro.models``, ``repro.configs``), on the CPU.

Both reference packages import in this process (they need none of the
names jax 0.9 moved).  The weights are the reference's own
``init_params(cfg, PRNGKey(0))`` at the ``.smoke()`` widths of
llama3.2-1b (dense) and granite-moe-3b-a800m (MoE: 4 experts, top-2),
carried across as numpy (``repro_torch.convert.lm_params_from_numpy``);
inputs are numpy draws from fixed seeds.  Full widths are checked on the
schemas' shapes only: no full-width tensor is made.

Tolerances, and why (everything fp32 unless stated):

* ``rms_norm``, ``mlp_apply``, attention and ``moe_apply`` outputs
  rtol/atol 1e-5 — the same products and sums in another order;
* ``rope`` atol 1e-5 at positions below 64 (``theta ** e`` and cos/sin may
  differ by an ulp between XLA and torch, times the position);
* bf16 ``rms_norm`` rtol 2**-7 (one bf16 rounding of the output);
* ``forward``, ``prefill`` and ``decode_step`` logits rtol/atol 1e-4
  (two layers and the head over 256 outputs), the caches rtol/atol 1e-5
  and their positions exactly; with a bf16 cache beside the fp32 weights
  the decode logits 1e-2 and the caches one bf16 ulp (a K or V value
  within an fp32 ulp of a bf16 rounding boundary may round either way);
* ``top_k`` and the MoE routing exactly: ties are ordered lower index
  first on both sides (the port sorts stably), and a case with tied
  router columns checks that order;
* bf16 weights (the served dtype): ``prefill`` with the engine's fp32
  cache, ``decode_step`` with a bf16 cache and ``moe_apply`` against the
  reference within n units of bf16's roundoff 2**-8 of the values' scale
  (n counted at ``U`` below); the fp32-cache decode, which the reference
  cannot run, against a plain written-out step within half a unit, and
  the bf16 combine order bit for bit against a written-out sum.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as RL
from repro.models import moe as RMOE
from repro.models import transformer as RT
from repro.models.params import P as RP
from repro.models.params import tree_size as ref_tree_size

from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, tree_size

ARCHS = {"dense": "llama3.2-1b", "moe": "granite-moe-3b-a800m"}
LM_ARCHS = sorted(n for n, c in configs.ARCHS.items()
                  if c.family in ("dense", "moe"))
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, dtype=np.float32),
                               **(tol or TOL))


def t32(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def flat_ref(params):
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    """(cfg, the reference's params, the port's params on the CPU)."""
    cfg = configs.get(ARCHS[request.param]).smoke()
    ref = RT.init_params(ref_configs.get(ARCHS[request.param]).smoke(),
                         jax.random.PRNGKey(0))
    return cfg, ref, lm_params_from_numpy(cfg, flat_ref(ref), device="cpu")


# --------------------------------------------------------------------------
# configs and schemas
def test_configs_equal_reference():
    assert sorted(configs.ARCHS) == sorted(ref_configs.ARCHS)
    assert configs.ASSIGNED == ref_configs.ASSIGNED
    for name, cfg in configs.ARCHS.items():
        ref = ref_configs.get(name)
        for c, r in ((cfg, ref), (cfg.smoke(), ref.smoke())):
            assert dataclasses.asdict(c) == dataclasses.asdict(r)
            assert c.param_count() == r.param_count()
            assert c.active_param_count() == r.active_param_count()
            assert c.head_dim == r.head_dim
        assert configs.applicable_shapes(cfg) == \
            ref_configs.applicable_shapes(ref)
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in ref_configs.SHAPES.items()}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_schema_at_full_width(arch):
    """Every leaf of the full-width schema — path, shape, axes, init law —
    equals the reference's; no tensor is made."""
    def leaves(tree, is_p):
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_p)[0]:
            out[".".join(k.key for k in path)] = dataclasses.astuple(leaf)
        return out
    port = {path: dataclasses.astuple(leaf) for path, leaf in
            tree_leaves(T.model_schema(configs.get(arch)))}
    ref = leaves(RT.model_schema(ref_configs.get(arch)),
                 lambda x: isinstance(x, RP))
    assert port == ref
    assert tree_size(T.model_schema(configs.get(arch))) == ref_tree_size(
        RT.model_schema(ref_configs.get(arch)))


def test_full_width_counts():
    """The two served configurations' parameter counts (the schema's
    leaves: ``param_count()`` plus the final norm)."""
    assert tree_size(T.model_schema(configs.get("llama3.2-1b"))) \
        == 1_498_482_688
    assert tree_size(T.model_schema(
        configs.get("granite-moe-3b-a800m"))) == 3_374_295_552


def test_init_law_and_dtype():
    """``init_params`` keeps the reference's law: ones, zeros, and normal
    draws of std scale/sqrt(fan_in) (within 5% on every leaf of >= 4096
    draws), in ``cfg.dtype``; one seed gives one draw."""
    cfg = dataclasses.replace(configs.get("granite-moe-3b-a800m").smoke(),
                              qkv_bias=True, qk_norm=True)
    params = T.init_params(cfg, 3, device="cpu")
    again = T.init_params(cfg, 3, device="cpu")
    schema = dict(tree_leaves(T.model_schema(cfg)))
    for path, w in tree_leaves(params):
        leaf = schema[path]
        assert tuple(w.shape) == leaf.shape and w.dtype == torch.float32
        assert torch.equal(w, dict(tree_leaves(again))[path])
        if leaf.init == "ones":
            assert torch.all(w == 1)
        elif leaf.init == "zeros":
            assert torch.all(w == 0)
        elif w.numel() >= 4096:
            fan_in = math.prod(leaf.shape[a] for a in leaf.fan_in_axes)
            std = leaf.scale / math.sqrt(fan_in)
            assert abs(float(w.std()) / std - 1) < 0.05, path
    bf = T.init_params(configs.get("llama3.2-1b").smoke(), 0,
                       dtype=torch.bfloat16, device="cpu")
    assert all(w.dtype == torch.bfloat16 for _, w in tree_leaves(bf))


def test_convert_round_trip_and_checks(model):
    cfg, ref, port = model
    flat = flat_ref(ref)
    back = lm_params_to_numpy(port)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_numpy(cfg, {k: v for k, v in flat.items()
                                   if k != "embed"}, device="cpu")
    bad = dict(flat, embed=flat["embed"][:-1])
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_numpy(cfg, bad, device="cpu")


def test_unknown_family_and_encdec_engine_refused():
    """The refusals that remain once every family is ported: a family
    outside the five, at every entry point, and the LM Engine on the
    encoder-decoder family (a Request carries no encoder input)."""
    from repro_torch.serve.engine import Engine, ServeConfig
    bad = dataclasses.replace(configs.get("llama3.2-1b").smoke(),
                              family="rnn")
    for call in (lambda: T.model_schema(bad),
                 lambda: T.init_params(bad, 0, device="cpu"),
                 lambda: T.init_decode_state(bad, 1, 8, device="cpu"),
                 lambda: T.forward({}, bad, torch.zeros((1, 4), dtype=int)),
                 lambda: T.decode_step({}, bad, torch.zeros((1, 1),
                                                            dtype=int), (), 0)):
        with pytest.raises(ValueError, match="unknown family 'rnn'"):
            call()
    cfg = configs.get("seamless-m4t-medium").smoke()
    params = T.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="encoder input"):
        Engine(cfg, params, ServeConfig(slots=1, max_len=16), device="cpu")


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = configs.get("llama3.2-1b").smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_decode_state(cfg, 1, 8)


# --------------------------------------------------------------------------
# layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    g = rng.normal(size=(64,)).astype(np.float32)
    tdt = getattr(torch, dtype)
    out = L.rms_norm(t32(x).to(tdt), t32(g).to(tdt), 1e-5)
    ref = RL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(g, dtype), 1e-5)
    assert out.dtype == tdt
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-6)
    close(out, ref.astype(jnp.float32), **tol)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
@pytest.mark.parametrize("per_row", [False, True])
def test_rope(theta, per_row):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = (rng.integers(0, 64, size=(2, 9)) if per_row
           else np.arange(9) + 40).astype(np.int32)
    close(L.rope(t32(x), torch.tensor(pos), theta),
          RL.rope(jnp.asarray(x), jnp.asarray(pos), theta))


def _qkv(rng, B=2, Sq=12, Sk=12, H=4, K=2, Dh=16):
    return (rng.normal(size=(B, Sq, H, Dh)).astype(np.float32),
            rng.normal(size=(B, Sk, K, Dh)).astype(np.float32),
            rng.normal(size=(B, Sk, K, Dh)).astype(np.float32))


@pytest.mark.parametrize("masked", [False, True])
def test_gqa_attend(masked):
    q, k, v = _qkv(np.random.default_rng(2))
    mask = (np.arange(12)[None, :] <= np.arange(12)[:, None])[None, None,
                                                              None]
    out = L._gqa_attend(t32(q), t32(k), t32(v),
                        torch.tensor(mask) if masked else None, 16)
    ref = RL._gqa_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(mask) if masked else None, 16)
    close(out, ref)


@pytest.mark.parametrize("window,n_meta", [(0, 0), (5, 0), (5, 2)])
def test_chunked_attend(window, n_meta):
    """Small chunks (queries 4, keys 8 over 24 positions), causal, with a
    window and a meta prefix; also equal to the full-score path of the
    port."""
    q, k, v = _qkv(np.random.default_rng(3), Sq=24, Sk=24)
    pos = np.arange(24, dtype=np.int32)
    kw = dict(window=window, n_meta=n_meta, head_dim=16, q_chunk=4,
              kv_chunk=8)
    out = L._chunked_attend(t32(q), t32(k), t32(v), torch.tensor(pos),
                            torch.tensor(pos), **kw)
    ref = RL._chunked_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos), jnp.asarray(pos), causal=True,
                             **kw)
    close(out, ref)
    mask = L._window_mask(torch.tensor(pos)[:, None],
                          torch.tensor(pos)[None, :], window, n_meta)
    close(out, L._gqa_attend(t32(q), t32(k), t32(v), mask[None, None, None],
                             16).numpy())


def _attn_cfg(**kw):
    return dataclasses.replace(configs.get("llama3.2-1b").smoke(), **kw)


def _attn_params(cfg, seed):
    """The reference's attention schema with every leaf drawn (biases and
    norms too), as numpy."""
    rng = np.random.default_rng(seed)
    sch = RL.attention_schema(cfg)
    return {k: (rng.normal(size=leaf.shape) * 0.2).astype(np.float32)
            for k, leaf in sch.items()}


@pytest.mark.parametrize("variant", ["plain", "bias_qknorm", "window"])
def test_attention_apply(variant):
    cfg = _attn_cfg(qkv_bias=variant == "bias_qknorm",
                    qk_norm=variant == "bias_qknorm")
    window = 4 if variant == "window" else 0
    p = _attn_params(cfg, 4)
    x = np.random.default_rng(5).normal(size=(2, 10, 64)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32)
    y, (k, v) = L.attention_apply({n: t32(a) for n, a in p.items()}, cfg,
                                  t32(x), torch.tensor(pos), window=window,
                                  return_kv=True)
    ry, (rk, rv) = RL.attention_apply(
        {n: jnp.asarray(a) for n, a in p.items()}, cfg, jnp.asarray(x),
        jnp.asarray(pos), window=window, return_kv=True)
    close(y, ry)
    close(k, rk)
    close(v, rv)


@pytest.mark.parametrize("window", [0, 3])
def test_attention_cached_unaligned_rows(window):
    """Three rows at positions 5, 9 and 0 (row 2 empty), a cache of 12 slots
    holding each row's earlier positions; the cache is written in place
    at [row, t] and equals the reference's new cache."""
    cfg = _attn_cfg()
    p = _attn_params(cfg, 6)
    rng = np.random.default_rng(7)
    B, Cl, Kh, Dh = 3, 12, cfg.n_kv_heads, cfg.head_dim
    ck = rng.normal(size=(B, Cl, Kh, Dh)).astype(np.float32)
    cv = rng.normal(size=(B, Cl, Kh, Dh)).astype(np.float32)
    t = np.array([5, 9, 0], np.int32)
    cpos = np.where(np.arange(Cl)[None, :] < t[:, None],
                    np.arange(Cl)[None, :], -1).astype(np.int32)
    x = rng.normal(size=(B, 1, 64)).astype(np.float32)
    cache = L.PosCache(t32(ck), t32(cv), torch.tensor(cpos))
    y, new = L.attention_cached({n: t32(a) for n, a in p.items()}, cfg,
                                t32(x), torch.tensor(t), cache,
                                window=window)
    ry, rnew = RL.attention_cached(
        {n: jnp.asarray(a) for n, a in p.items()}, cfg, jnp.asarray(x),
        jnp.asarray(t), RL.PosCache(jnp.asarray(ck), jnp.asarray(cv),
                                    jnp.asarray(cpos)), window=window)
    assert new.k is cache.k and new.pos is cache.pos      # in place
    close(y, ry)
    close(new.k, rnew.k)
    close(new.v, rnew.v)
    np.testing.assert_array_equal(new.pos.numpy(), np.asarray(rnew.pos))


def test_mlp_apply():
    rng = np.random.default_rng(8)
    p = {n: (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
         for n, leaf in RL.mlp_schema(_attn_cfg()).items()}
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    close(L.mlp_apply({n: t32(a) for n, a in p.items()}, t32(x)),
          RL.mlp_apply({n: jnp.asarray(a) for n, a in p.items()},
                       jnp.asarray(x)))


# --------------------------------------------------------------------------
# MoE
def test_top_k_ties_lower_index_first():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    vals, idx = MOE.top_k(t32(probs), 3)
    rv, ri = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


def _dropped(top_e, E, cap):
    """Slots past their expert's capacity, ranked k-major (numpy)."""
    flat = np.asarray(top_e).T.reshape(-1)
    seen = np.zeros(E, int)
    drops = 0
    for e in flat:
        drops += seen[e] >= cap
        seen[e] += 1
    return drops


@pytest.mark.parametrize("case", ["drops", "no_drops", "tied_router"])
def test_moe_apply(case):
    """Capacity 0.5 drops slots, 4.0 drops none; a router with two equal
    columns ties every token's probabilities for experts 0 and 1."""
    factor = {"drops": 0.5, "no_drops": 4.0, "tied_router": 1.25}[case]
    cfg = dataclasses.replace(configs.get("granite-moe-3b-a800m").smoke(),
                              capacity_factor=factor)
    rng = np.random.default_rng(9)
    p = {n: (rng.normal(size=leaf.shape) * 0.3).astype(np.float32)
         for n, leaf in RMOE.moe_schema(cfg).items()}
    if case == "tied_router":
        p["router"][:, 1] = p["router"][:, 0]
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    y, aux = MOE.moe_apply({n: t32(a) for n, a in p.items()}, cfg, t32(x))
    ry, raux = RMOE.moe_apply({n: jnp.asarray(a) for n, a in p.items()},
                              cfg, jnp.asarray(x))
    close(y, ry)
    close(aux, raux)
    logits = x.reshape(16, 64) @ p["router"]
    _, top_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), cfg.top_k)
    cap = math.ceil(16 * cfg.top_k * factor / cfg.n_experts)
    drops = _dropped(top_e, cfg.n_experts, cap)
    if case == "tied_router":
        probs = np.asarray(jax.nn.softmax(jnp.asarray(logits)))
        np.testing.assert_array_equal(probs[:, 0], probs[:, 1])
    else:
        assert (drops > 0) == (case == "drops"), drops


# --------------------------------------------------------------------------
# the model
def test_forward(model):
    cfg, ref, port = model
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 12))
    logits, aux = T.forward(port, cfg, torch.tensor(toks))
    rlogits, raux = RT.forward(ref, cfg, jnp.asarray(toks, jnp.int32),
                               remat=False)
    assert logits.shape == (2, 12, cfg.vocab_size)
    close(logits, rlogits, **LOGIT_TOL)
    close(aux, raux)


def _ref_state(cfg, B, Cl, dtype="float32"):
    return RT.init_decode_state(cfg, B, Cl, dtype=jnp.dtype(dtype))


def _close_state(state, rstate, **tol):
    close(state.attn.k, rstate.attn.k.astype(jnp.float32), **tol)
    close(state.attn.v, rstate.attn.v.astype(jnp.float32), **tol)
    np.testing.assert_array_equal(state.attn.pos.numpy(),
                                  np.asarray(rstate.attn.pos))


@pytest.mark.parametrize("valid_len", [None, 11])
def test_prefill(model, valid_len):
    """A 16-token prompt, whole or as 11 real tokens and a pad suffix
    (its cache slots at position -1, the logits read at position 10)."""
    cfg, ref, port = model
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 16))
    if valid_len:
        toks[:, valid_len:] = 0
    state = T.init_decode_state(cfg, 2, 24, dtype=torch.float32,
                                device="cpu")
    logits, state = T.prefill(port, cfg, torch.tensor(toks), state,
                              valid_len=valid_len)
    rlogits, rstate = RT.prefill(
        ref, cfg, jnp.asarray(toks, jnp.int32), _ref_state(cfg, 2, 24),
        valid_len=None if valid_len is None else jnp.asarray(valid_len))
    close(logits, rlogits, **LOGIT_TOL)
    _close_state(state, rstate)
    if valid_len:
        assert (state.attn.pos[:, :, valid_len:] == -1).all()


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_decode_steps(model, cache):
    """Prefill 6 tokens, then 5 decode steps fed the reference's greedy
    tokens (one scalar position for the batch); the logits after every
    step and the final caches equal the reference's.  With a bf16 cache
    (the reference's default) beside the fp32 weights, both sides round
    K and V to bf16; a value within an fp32 ulp of a bf16 rounding
    boundary may round either way, so the logits are held to 1e-2 and
    the caches to one bf16 ulp (2**-8 relative)."""
    cfg, ref, port = model
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 6))
    state = T.init_decode_state(cfg, 2, 16, dtype=getattr(torch, cache),
                                device="cpu")
    logits, state = T.prefill(port, cfg, torch.tensor(toks), state)
    rlogits, rstate = RT.prefill(ref, cfg, jnp.asarray(toks, jnp.int32),
                                 _ref_state(cfg, 2, 16, cache))
    tol = LOGIT_TOL if cache == "float32" else dict(rtol=1e-2, atol=1e-2)
    state_tol = TOL if cache == "float32" else dict(rtol=2 ** -8, atol=1e-6)
    ref_step = jax.jit(lambda p, tok, st, t: RT.decode_step(p, cfg, tok,
                                                            st, t))
    for t in range(6, 11):
        nxt = np.asarray(jnp.argmax(rlogits, -1), np.int32)[:, None]
        logits, state = T.decode_step(port, cfg, torch.tensor(nxt), state, t)
        rlogits, rstate = ref_step(ref, jnp.asarray(nxt), rstate,
                                   jnp.asarray(t, jnp.int32))
        close(logits, rlogits, **tol)
    _close_state(state, rstate, **state_tol)


# --------------------------------------------------------------------------
# bf16 weights (the served dtype of both configurations)
#
# The two sides round bf16 at different points: XLA's CPU backend runs a
# fused chain of bf16 elementwise ops in fp32 and rounds once at its end,
# torch rounds after every op.  Each rounding site on the path can so leave
# a difference of up to one unit roundoff U = 2**-8 of the values' scale,
# and the differences add up over the sites a value passes.  The bound is
# therefore |port - ref| <= n * U * max|ref|, with n counted per check
# (measured on this data: logits 3.7, caches 1.6, moe_apply 1.8).
U = 2.0 ** -8
LOGIT_UNITS = 8     # two layers: norm, q/k/v, rope, attention, wo, FFN, head
CACHE_UNITS = 4     # layer 2's K/V pass layer 1 and their own projection
MOE_UNITS = 4       # router, expert SwiGLU, weight product, K-term sum
# The port against the plain written-out step below: the same roundings at
# the same places on one backend, so only the fp32 sums' order differs
# (measured: bit for bit equal).  A rounding moved or added shows as 1.5
# units or more (measured: the output projection in fp32, rounded after).
PLAIN_UNITS = 0.5


def bf16_close(port, ref, units):
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(port.detach().float().numpy(), ref, rtol=0,
                               atol=units * U * float(np.abs(ref).max()))


def same_token_where_clear(port, ref, units):
    """Greedy tokens agree wherever the reference's top-two gap exceeds
    twice the logits' bound."""
    ref = np.asarray(ref, dtype=np.float32)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * units * U * np.abs(ref).max()
    np.testing.assert_array_equal(port.argmax(-1).numpy()[clear],
                                  ref.argmax(-1)[clear])


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model_bf16(request):
    """(cfg, the reference's params, the port's params on the CPU), both
    in bf16 (the reference's own bf16 draws)."""
    cfg = dataclasses.replace(configs.get(ARCHS[request.param]).smoke(),
                              dtype="bfloat16")
    ref = RT.init_params(
        dataclasses.replace(ref_configs.get(ARCHS[request.param]).smoke(),
                            dtype="bfloat16"), jax.random.PRNGKey(0))
    port = lm_params_from_numpy(cfg, flat_ref(ref), device="cpu")
    assert all(w.dtype == torch.bfloat16 for _, w in tree_leaves(port))
    return cfg, ref, port


def test_prefill_bf16_weights_fp32_cache(model_bf16):
    """bf16 weights and the engine's fp32 cache: the prefill's logits and
    caches against the reference's (which runs this mix: the residual is
    bf16 throughout a full-sequence layer)."""
    cfg, ref, port = model_bf16
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 16))
    state = T.init_decode_state(cfg, 2, 24, dtype=torch.float32,
                                device="cpu")
    logits, state = T.prefill(port, cfg, torch.tensor(toks), state)
    rlogits, rstate = RT.prefill(ref, cfg, jnp.asarray(toks, jnp.int32),
                                 _ref_state(cfg, 2, 24))
    assert logits.dtype == torch.float32
    assert state.attn.k.dtype == torch.float32
    bf16_close(logits, rlogits, LOGIT_UNITS)
    same_token_where_clear(logits, rlogits, LOGIT_UNITS)
    bf16_close(state.attn.k, rstate.attn.k, CACHE_UNITS)
    bf16_close(state.attn.v, rstate.attn.v, CACHE_UNITS)
    np.testing.assert_array_equal(state.attn.pos.numpy(),
                                  np.asarray(rstate.attn.pos))


def test_decode_steps_bf16(model_bf16):
    """bf16 weights and a bf16 cache: prefill 6 tokens, then 5 decode steps
    fed the reference's greedy tokens; every step's logits and the final
    caches against the reference's."""
    cfg, ref, port = model_bf16
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 6))
    state = T.init_decode_state(cfg, 2, 16, dtype=torch.bfloat16,
                                device="cpu")
    logits, state = T.prefill(port, cfg, torch.tensor(toks), state)
    rlogits, rstate = RT.prefill(ref, cfg, jnp.asarray(toks, jnp.int32),
                                 _ref_state(cfg, 2, 16, "bfloat16"))
    bf16_close(logits, rlogits, LOGIT_UNITS)
    ref_step = jax.jit(lambda p, tok, st, t: RT.decode_step(p, cfg, tok,
                                                            st, t))
    for t in range(6, 11):
        nxt = np.asarray(jnp.argmax(rlogits, -1), np.int32)[:, None]
        logits, state = T.decode_step(port, cfg, torch.tensor(nxt), state, t)
        rlogits, rstate = ref_step(ref, jnp.asarray(nxt), rstate,
                                   jnp.asarray(t, jnp.int32))
        bf16_close(logits, rlogits, LOGIT_UNITS)
        same_token_where_clear(logits, rlogits, LOGIT_UNITS)
    bf16_close(state.attn.k, rstate.attn.k.astype(jnp.float32), CACHE_UNITS)
    bf16_close(state.attn.v, rstate.attn.v.astype(jnp.float32), CACHE_UNITS)
    np.testing.assert_array_equal(state.attn.pos.numpy(),
                                  np.asarray(rstate.attn.pos))


@pytest.mark.parametrize("factor", [0.5, 4.0])
def test_moe_apply_bf16(factor):
    """bf16 weights and activations, with and without capacity drops: the
    routing (read from the aux loss, a function of every token's top
    choice and probabilities) equals the reference's, and the output,
    including the K-term combine summed in bf16, is within MOE_UNITS."""
    cfg = dataclasses.replace(configs.get("granite-moe-3b-a800m").smoke(),
                              capacity_factor=factor, dtype="bfloat16")
    rng = np.random.default_rng(9)
    p = {n: (rng.normal(size=leaf.shape) * 0.3).astype(np.float32)
         for n, leaf in RMOE.moe_schema(cfg).items()}
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    y, aux = MOE.moe_apply({n: t32(a).bfloat16() for n, a in p.items()},
                           cfg, t32(x).bfloat16())
    ry, raux = RMOE.moe_apply(
        {n: jnp.asarray(a, jnp.bfloat16) for n, a in p.items()}, cfg,
        jnp.asarray(x, jnp.bfloat16))
    assert y.dtype == torch.bfloat16
    bf16_close(y, ry.astype(jnp.float32), MOE_UNITS)
    close(aux, raux)
    # the same top-K choices on both sides, from the same bf16 logits
    xt = t32(x).bfloat16().reshape(16, 64)
    logits = (xt @ t32(p["router"]).bfloat16()).float()
    rlogits = (jnp.asarray(x, jnp.bfloat16).reshape(16, 64)
               @ jnp.asarray(p["router"], jnp.bfloat16)).astype(jnp.float32)
    np.testing.assert_array_equal(logits.numpy(), np.asarray(rlogits))
    _, idx = MOE.top_k(torch.softmax(logits, -1), cfg.top_k)
    _, ridx = jax.lax.top_k(jax.nn.softmax(rlogits, -1), cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))


def _plain_rms(x, g, eps):
    x32 = x.float()
    return (x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
            ).to(x.dtype) * g


def _plain_rope(x, t, theta):
    """x: (H, Dh) of one token at position t; fp32 between the casts."""
    half = x.shape[-1] // 2
    ang = t * theta ** (-torch.arange(half, dtype=torch.float32) / half)
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float()[:, :half], x.float()[:, half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def _plain_swiglu(x, wg, wu, wd):
    return (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd


def _plain_moe(p, cfg, x):
    """x: (T, d).  Top-K from a Python sort (largest first, lower expert
    first among ties), capacity ranks counted k-major, each token's kept
    choices summed in order k = 0 .. K-1 in x's dtype."""
    T_, E, K = x.shape[0], cfg.n_experts, cfg.top_k
    cap = math.ceil(T_ * K * cfg.capacity_factor / E)
    probs = torch.softmax((x @ p["router"]).float(), -1)
    top = [sorted(range(E), key=lambda e: (-float(pr[e]), e))[:K]
           for pr in probs]
    filled = [0] * E
    kept = [[False] * K for _ in range(T_)]
    for k in range(K):
        for i in range(T_):
            e = top[i][k]
            kept[i][k] = filled[e] < cap
            filled[e] += 1
    y = torch.zeros_like(x)
    for i in range(T_):
        norm = sum(probs[i, e] for e in top[i])
        for k, e in enumerate(top[i]):
            w = (probs[i, e] / norm * kept[i][k]).to(x.dtype)
            out = _plain_swiglu(x[i:i + 1], p["w_gate"][e], p["w_up"][e],
                                p["w_down"][e])[0]
            y[i] = y[i] + out * w
    return y


@pytest.mark.parametrize("top_k", [3, 4])
@pytest.mark.parametrize("factor", [0.5, 4.0])
def test_moe_combine_order_bf16(top_k, factor):
    """The combine's order in bf16.  With top-2 the order cannot show
    (0 + a + b == 0 + b + a), so top-3 and top-4 of the 4 experts: the port
    equals, bit for bit, the written-out version that sums each token's
    choices k = 0 .. K-1 into zeros (the reversed order differs in
    hundreds of the 1,024 outputs on this data)."""
    cfg = dataclasses.replace(configs.get("granite-moe-3b-a800m").smoke(),
                              capacity_factor=factor, dtype="bfloat16",
                              top_k=top_k)
    rng = np.random.default_rng(9)
    p = {n: t32((rng.normal(size=leaf.shape) * 0.3)).bfloat16()
         for n, leaf in RMOE.moe_schema(cfg).items()}
    x = t32(rng.normal(size=(2, 8, 64))).bfloat16()
    y, _ = MOE.moe_apply(p, cfg, x)
    assert torch.equal(y.reshape(16, 64), _plain_moe(p, cfg,
                                                     x.reshape(16, 64)))


def _plain_decode_step(params, cfg, tok, ck, cv, cpos, t):
    """One decode step of a dense or MoE model, written out row by row and
    head by head: the attention against the cache in fp32 over the visible
    slots only, its output cast explicitly to the weights' dtype before
    the output projection, the residual in the weights' dtype.  Writes the
    new K/V into (ck, cv, cpos) at [layer, row, t]; returns fp32 logits."""
    H, Kh, Dh, eps = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.norm_eps
    lay = params["layers"]
    h = params["embed"][tok[:, 0]]                                # (B, d)
    for li in range(cfg.n_layers):
        a = {n: w[li] for n, w in lay["attn"].items()}
        x = _plain_rms(h, lay["ln1"][li], eps)
        ys = []
        for b in range(h.shape[0]):
            q = _plain_rope(torch.einsum("d,dhk->hk", x[b], a["wq"]), t,
                            cfg.rope_theta)
            k = _plain_rope(torch.einsum("d,dhk->hk", x[b], a["wk"]), t,
                            cfg.rope_theta)
            v = torch.einsum("d,dhk->hk", x[b], a["wv"])
            ck[li, b, t], cv[li, b, t], cpos[li, b, t] = k, v, t
            vis = (cpos[li, b] >= 0) & (cpos[li, b] <= t)
            out = torch.empty(H, Dh, dtype=torch.float32)
            for hh in range(H):
                kv = hh // (H // Kh)
                s = ck[li, b, vis, kv].float() @ q[hh].float() / math.sqrt(Dh)
                out[hh] = torch.softmax(s, 0) @ cv[li, b, vis, kv].float()
            ys.append(out.to(a["wo"].dtype).reshape(H * Dh)
                      @ a["wo"].reshape(H * Dh, -1))
        h = h + torch.stack(ys)
        x = _plain_rms(h, lay["ln2"][li], eps)
        if cfg.family == "moe":
            h = h + _plain_moe({n: w[li] for n, w in lay["moe"].items()},
                               cfg, x)
        else:
            m = {n: w[li] for n, w in lay["mlp"].items()}
            h = h + _plain_swiglu(x, m["w_gate"], m["w_up"], m["w_down"])
    h = _plain_rms(h, params["final_norm"], eps)
    return h.float() @ params["out_head"].float()


def test_bf16_weights_with_fp32_cache_decode(model_bf16):
    """bf16 weights beside an fp32 cache (the engine's default).  The
    reference's decode cannot run this mix (its attention output promotes
    the scan's carry to fp32), so the port is held against the plain
    written-out step above, which makes the port's choice explicit: the
    attention in fp32, its output cast to bf16 before the output
    projection.  Both start from the port's prefill (held against the
    reference in test_prefill_bf16_weights_fp32_cache); 5 steps, each fed
    the plain step's greedy tokens; logits and the fp32 caches within
    PLAIN_UNITS."""
    cfg, _, port = model_bf16
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 6))
    state = T.init_decode_state(cfg, 2, 16, dtype=torch.float32,
                                device="cpu")
    _, state = T.prefill(port, cfg, torch.tensor(toks), state)
    ck, cv, cpos = (c.clone() for c in state.attn)
    nxt = torch.tensor(toks[:, -1:])
    for t in range(6, 11):
        plain = _plain_decode_step(port, cfg, nxt, ck, cv, cpos, t)
        logits, state = T.decode_step(port, cfg, nxt, state, t)
        assert logits.dtype == torch.float32
        bf16_close(logits, plain.numpy(), PLAIN_UNITS)
        nxt = plain.argmax(-1, keepdim=True)
    assert state.attn.k.dtype == torch.float32
    bf16_close(state.attn.k, ck.numpy(), PLAIN_UNITS)
    bf16_close(state.attn.v, cv.numpy(), PLAIN_UNITS)
    np.testing.assert_array_equal(state.attn.pos.numpy(), cpos.numpy())
