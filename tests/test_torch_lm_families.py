"""The port's SSM, hybrid and encoder-decoder LM families
(``repro_torch.models.ssm``, the three branches of
``repro_torch.models.transformer``, ``layers.cross_attention_cached``)
against the JAX reference (``repro.models``), on the CPU.

The reference packages import in this process (they need none of the
names jax 0.9 moved).  The weights are the reference's own
``init_params(cfg, PRNGKey(k))`` at the ``.smoke()`` widths of
mamba2-2.7b (ssm: 2 layers, d_inner 128 in 8 heads of 16, state 16),
hymba-1.5b (hybrid: 2 layers, 8 meta tokens, a 16-position window on
layer 1, layer 0 global) and seamless-m4t-medium (encdec: 2 + 2 layers),
carried across with ``repro_torch.convert.lm_params_from_numpy``; tokens,
encoder frames and the layer tests' weights are numpy draws from fixed
seeds.  Full widths are checked on the schemas' shapes only: no
full-width tensor is made.

Tolerances, and why (everything fp32 unless stated):

* ``_conv_causal``, ``ssd_apply`` (with its returned state),
  ``ssd_decode_step``, the attention variants and
  ``cross_attention_cached``: rtol/atol 1e-5, as tests/test_torch_lm.py
  holds the dense layers — the same products and sums in another order;
* where an SSD chunk spans 64 or 128 positions (``ssd_apply`` at chunk
  64, a two-chunk prefill) each output and cache leaf within
  ``SSD_FRAC`` = 1e-4 of its largest magnitude instead: the decays are
  ``exp(la_q - la_j)`` of a cumulative sum ``la`` that reaches -50 to
  -100 over such a chunk, XLA and torch sum it in different orders, and
  an ulp of ``la`` there (4e-6 to 8e-6) is a relative error of every
  decay (measured: 2.5e-5 at an output of 1.24, elementwise 2e-5
  relative; 1.35e-5 of the largest state value);
* ``_conv_causal`` with bf16 operands bit for bit: both sides run it op
  by op (the reference eagerly, not fused), so each tap rounds to bf16
  in the same order;
* ``forward``, ``prefill`` and ``decode_step`` logits rtol/atol 1e-4 (two
  layers and the head over 256 outputs; measured 1.0e-5), the caches
  leaf by leaf rtol/atol 1e-5 (measured 1.4e-5 at a state value of 15,
  9e-6 elsewhere) and the cache positions exactly;
* ``lm_loss`` rtol 1e-5, each gradient leaf within 1e-4 of its largest
  magnitude, as tests/test_torch_train.py holds the dense families;
* bf16 weights: within n units of bf16's roundoff U = 2**-8 of the
  values' scale, as tests/test_torch_lm.py explains (XLA runs a fused
  chain of bf16 ops in fp32 and rounds once, torch rounds after every
  op), with n counted below at ``LOGIT_UNITS``, ``CACHE_UNITS`` and
  ``STATE_UNITS``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as RL
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.models.params import P as RP
from repro.models.params import tree_size as ref_tree_size

from repro_torch import configs
from repro_torch.convert import (decode_state_to_numpy, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, tree_size, unflatten
from repro_torch.serve.engine import Engine, ServeConfig

ARCHS = {"ssm": "mamba2-2.7b", "hybrid": "hymba-1.5b",
         "encdec": "seamless-m4t-medium"}
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SSD_FRAC = 1e-4      # of a leaf's largest magnitude, long SSD chunks
PROMPT = 24          # hybrid: 8 meta + 24 = 32 positions, past the window
ENC_LEN = 10         # encoder frames of the encdec cases
CACHE = 40           # decode-state positions (plus hybrid's meta prefix)


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach().float()),
                               np.asarray(ref, dtype=np.float32),
                               **(tol or TOL))


def t32(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def flat_ref(params):
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def ref_state_numpy(state) -> dict:
    """The reference's DecodeState under decode_state_to_numpy's keys."""
    out = {}
    for name, field in zip(state._fields, state):
        if hasattr(field, "_fields"):
            out.update({f"{name}.{f}": v for f, v in zip(field._fields,
                                                          field)})
        elif not isinstance(field, tuple):
            out[name] = field
    return {k: np.asarray(v if v.dtype == jnp.int32
                          else v.astype(jnp.float32))
            for k, v in out.items()}


def scale_close(port, ref, key="", frac=SSD_FRAC):
    """Within ``frac`` of the reference's largest magnitude."""
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(port.detach().float())
                               if isinstance(port, torch.Tensor) else port,
                               ref, rtol=0,
                               atol=frac * float(np.abs(ref).max()),
                               err_msg=key)


def close_state(state, rstate, check=None):
    """Every leaf of the two states (the same keys), positions exactly;
    ``check(port, ref)`` for the float leaves (default ``TOL``)."""
    port, ref = decode_state_to_numpy(state), ref_state_numpy(rstate)
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].shape == ref[k].shape, k
        if k.endswith("pos"):
            np.testing.assert_array_equal(port[k], ref[k])
        elif check is None:
            np.testing.assert_allclose(port[k], ref[k], err_msg=k, **TOL)
        else:
            check(port[k], ref[k], k)


def cfgs(family, **kw):
    """(the port's, the reference's) smoke config of ``family``."""
    return (dataclasses.replace(configs.get(ARCHS[family]).smoke(), **kw),
            dataclasses.replace(ref_configs.get(ARCHS[family]).smoke(), **kw))


def inputs(cfg, seed, S=PROMPT, B=2):
    """Numpy tokens (B, S) and, for encdec, encoder frames (B, ENC_LEN, d)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    enc = (rng.normal(size=(B, ENC_LEN, cfg.d_model)).astype(np.float32)
           if cfg.family == "encdec" else None)
    return toks, enc


def port_in(enc, dtype=torch.float32):
    return None if enc is None else t32(enc).to(dtype)


def ref_in(enc, dtype=jnp.float32):
    return None if enc is None else jnp.asarray(enc, dtype)


def ref_state(cfg, B, dtype="float32"):
    return RT.init_decode_state(cfg, B, CACHE, dtype=jnp.dtype(dtype),
                                enc_len=ENC_LEN)


def port_state(cfg, B, dtype=torch.float32):
    return T.init_decode_state(cfg, B, CACHE, dtype=dtype, device="cpu",
                               enc_len=ENC_LEN)


def _model(family, dtype, key=0):
    cfg, rcfg = cfgs(family, dtype=dtype)
    ref = RT.init_params(rcfg, jax.random.PRNGKey(key))
    port = lm_params_from_numpy(cfg, flat_ref(ref), device="cpu")
    return cfg, rcfg, ref, port


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    """(cfg, rcfg, the reference's params, the port's on the CPU), fp32."""
    return _model(request.param, "float32")


# --------------------------------------------------------------------------
# schemas, windows, conversion
@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
def test_schema_at_full_width(arch):
    """Every leaf of the full-width schema — path, shape, axes, init law —
    equals the reference's, and so does ``ssm_schema``; no tensor is
    made."""
    def leaves(tree):
        return {".".join(k.key for k in path): dataclasses.astuple(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(x, RP))[0]}
    cfg, rcfg = configs.get(arch), ref_configs.get(arch)
    port = {path: dataclasses.astuple(leaf)
            for path, leaf in tree_leaves(T.model_schema(cfg))}
    assert port == leaves(RT.model_schema(rcfg))
    assert tree_size(T.model_schema(cfg)) == ref_tree_size(
        RT.model_schema(rcfg))
    if cfg.family in ("ssm", "hybrid"):
        assert {k: dataclasses.astuple(v)
                for k, v in S.ssm_schema(cfg).items()} == \
            {k: dataclasses.astuple(v)
             for k, v in RS.ssm_schema(rcfg).items()}


def test_full_width_counts():
    """The served configurations' parameter counts (the schema's leaves;
    ``param_count()`` is the reference's approximation)."""
    counts = {a: tree_size(T.model_schema(configs.get(a)))
              for a in ARCHS.values()}
    assert counts == {"mamba2-2.7b": 2_831_296_000,
                      "hymba-1.5b": 1_393_829_920,
                      "seamless-m4t-medium": 977_758_208}


@pytest.mark.parametrize("n_layers", [2, 3, 4, 5, 32])
def test_layer_windows(n_layers):
    """Hymba's global layers: linspace(0, L-1, 3) — every layer at depth
    2 or 3, layer 2 windowed at 4, [0, 15, 31] at 32."""
    cfg = dataclasses.replace(configs.get("hymba-1.5b"), n_layers=n_layers)
    rcfg = dataclasses.replace(ref_configs.get("hymba-1.5b"),
                               n_layers=n_layers)
    w = T.layer_windows(cfg)
    np.testing.assert_array_equal(w, RT.layer_windows(rcfg))
    if n_layers == 4:
        assert list(w) == [0, 0, 1024, 0]
    if n_layers == 32:
        assert list(np.flatnonzero(w == 0)) == [0, 15, 31]


def test_convert_round_trip(model):
    """The new leaves (``layers.ssm.*``, ``meta_tokens``, ``enc_layers.*``,
    ``layers.cross.*``) carry across both ways, exactly."""
    cfg, _, ref, port = model
    flat = flat_ref(ref)
    back = lm_params_to_numpy(port)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    want = {"ssm": ["layers.ssm.in_proj"],
            "hybrid": ["layers.ssm.a_log", "meta_tokens",
                       "layers.norm_attn"],
            "encdec": ["enc_layers.attn.wq", "layers.cross.wv",
                       "enc_final_norm"]}[cfg.family]
    assert set(want) <= set(flat)


# --------------------------------------------------------------------------
# the SSD block
def _ssm_params(cfg, seed):
    """Every leaf of the reference's ssm schema drawn (the decays, skip
    and norm too), as numpy."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=leaf.shape) * 0.3).astype(np.float32)
            for k, leaf in RS.ssm_schema(cfg).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_causal(dtype):
    """Taps 0..3 in order, the bias last, in the input's dtype: bit for bit
    in bf16, where each tap rounds."""
    rng = np.random.default_rng(20)
    u = rng.normal(size=(2, 11, 40)).astype(np.float32)
    w = rng.normal(size=(4, 40)).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    tdt = getattr(torch, dtype)
    out = S._conv_causal(t32(u).to(tdt), t32(w).to(tdt), t32(b).to(tdt))
    ref = RS._conv_causal(jnp.asarray(u, dtype), jnp.asarray(w, dtype),
                          jnp.asarray(b, dtype))
    assert out.dtype == tdt
    if dtype == "float32":
        close(out, ref)
    else:
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_apply(arch, chunk):
    """S = 64 in chunks of 16 (four chunks: the inter-chunk recurrence)
    and of 64 (one), with the returned state, against the reference at
    the same chunk; the two chunkings agree with each other too."""
    cfg = configs.get(arch).smoke()
    p = _ssm_params(cfg, 21)
    x = np.random.default_rng(22).normal(size=(2, 64, 64)).astype(np.float32)
    y, st = S.ssd_apply({k: t32(v) for k, v in p.items()}, cfg, t32(x),
                        chunk=chunk, return_state=True)
    ry, rst = RS.ssd_apply({k: jnp.asarray(v) for k, v in p.items()}, cfg,
                           jnp.asarray(x), chunk=chunk, return_state=True)
    check = close if chunk < 64 else scale_close
    check(y, ry)
    check(st.h, rst.h)
    check(st.conv, rst.conv)
    other = S.ssd_apply({k: t32(v) for k, v in p.items()}, cfg, t32(x),
                        chunk=80 - chunk)
    close(other, y.numpy(), rtol=1e-4, atol=1e-4)


def test_ssd_decode_steps():
    """A 16-position ssd_apply's state, then 12 ssd_decode_steps: every
    output and the cache after every step against the reference's; the
    cache is written in place.  The port's decode outputs also equal its
    own full-sequence SSD over the 28 positions (the recurrence and the
    chunked form are one function)."""
    cfg = configs.get("mamba2-2.7b").smoke()
    p = _ssm_params(cfg, 23)
    pt = {k: t32(v) for k, v in p.items()}
    pr = {k: jnp.asarray(v) for k, v in p.items()}
    x = np.random.default_rng(24).normal(size=(2, 28, 64)).astype(np.float32)
    _, cache = S.ssd_apply(pt, cfg, t32(x[:, :16]), return_state=True)
    _, rcache = RS.ssd_apply(pr, cfg, jnp.asarray(x[:, :16]),
                             return_state=True)
    h0 = cache.h
    outs = []
    for i in range(16, 28):
        y, new = S.ssd_decode_step(pt, cfg, t32(x[:, i:i + 1]), cache)
        ry, rcache = RS.ssd_decode_step(pr, cfg, jnp.asarray(x[:, i:i + 1]),
                                        rcache)
        assert new.h is h0                           # in place
        close(y, ry)
        close(new.h, rcache.h)
        close(new.conv, rcache.conv)
        outs.append(y)
    full = S.ssd_apply(pt, cfg, t32(x), chunk=28)
    close(torch.cat(outs, 1), full[:, 16:].numpy(), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# attention: bidirectional, cross, cached cross
def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=leaf.shape) * 0.2).astype(np.float32)
            for k, leaf in RL.attention_schema(cfg).items()}


@pytest.mark.parametrize("variant", ["encoder", "cross", "cross_bias_qknorm",
                                     "cross_chunked"])
def test_attention_apply_bidirectional_and_cross(variant):
    """``causal=False`` self-attention (the encoder), and cross-attention
    from 7 decoder positions onto 10 encoder frames (``kv_x`` at
    ``kv_positions``), with QKV bias and QK-norm, and onto 8,192 frames,
    where both sides take the chunked online-softmax path unmasked."""
    cfg, _ = cfgs("encdec", qkv_bias=variant == "cross_bias_qknorm",
                  qk_norm=variant == "cross_bias_qknorm")
    p = _attn_params(cfg, 25)
    rng = np.random.default_rng(26)
    Se = 8192 if variant == "cross_chunked" else 10
    x = rng.normal(size=(1, 7, 64)).astype(np.float32)
    enc = rng.normal(size=(1, Se, 64)).astype(np.float32)
    pos, epos = np.arange(7, dtype=np.int32), np.arange(Se, dtype=np.int32)
    kw, rkw = {}, {}
    if variant != "encoder":
        kw = dict(kv_x=t32(enc), kv_positions=torch.tensor(epos))
        rkw = dict(kv_x=jnp.asarray(enc), kv_positions=jnp.asarray(epos))
    y, (k, v) = L.attention_apply({n: t32(a) for n, a in p.items()}, cfg,
                                  t32(x), torch.tensor(pos), causal=False,
                                  return_kv=True, **kw)
    ry, (rk, rv) = RL.attention_apply(
        {n: jnp.asarray(a) for n, a in p.items()}, cfg, jnp.asarray(x),
        jnp.asarray(pos), causal=False, return_kv=True, **rkw)
    close(y, ry)
    close(k, rk)
    close(v, rv)


def test_chunked_attend_bidirectional():
    """The chunked path unmasked (queries 4, keys 8 over 24 positions)
    against the reference's and the port's own full-score path."""
    rng = np.random.default_rng(27)
    q = rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)
    kw = dict(window=5, n_meta=2, head_dim=16, q_chunk=4, kv_chunk=8)
    out = L._chunked_attend(t32(q), t32(k), t32(v), torch.tensor(pos),
                            torch.tensor(pos), causal=False, **kw)
    ref = RL._chunked_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos), jnp.asarray(pos), causal=False,
                             **kw)
    close(out, ref)
    close(out, L._gqa_attend(t32(q), t32(k), t32(v), None, 16).numpy())


@pytest.mark.parametrize("t", [0, 5, "tensor"])
def test_cross_attention_cached(t):
    """One decode position against 10 roped encoder K/V (with QKV bias and
    QK-norm); t as an int or a one-element tensor."""
    cfg, _ = cfgs("encdec", qkv_bias=True, qk_norm=True)
    p = _attn_params(cfg, 28)
    rng = np.random.default_rng(29)
    x = rng.normal(size=(3, 1, 64)).astype(np.float32)
    ek = rng.normal(size=(3, 10, 2, 16)).astype(np.float32)
    ev = rng.normal(size=(3, 10, 2, 16)).astype(np.float32)
    tt = torch.tensor([7], dtype=torch.int32) if t == "tensor" else t
    y = L.cross_attention_cached({n: t32(a) for n, a in p.items()}, cfg,
                                 t32(x), tt, t32(ek), t32(ev))
    ry = RL.cross_attention_cached(
        {n: jnp.asarray(a) for n, a in p.items()}, cfg, jnp.asarray(x),
        jnp.asarray(7 if t == "tensor" else t, jnp.int32), jnp.asarray(ek),
        jnp.asarray(ev))
    close(y, ry)


# --------------------------------------------------------------------------
# the models, fp32
def test_forward(model):
    cfg, rcfg, ref, port = model
    toks, enc = inputs(cfg, 30)
    logits, aux = T.forward(port, cfg, torch.tensor(toks),
                            enc_input=port_in(enc))
    rlogits, raux = RT.forward(ref, rcfg, jnp.asarray(toks),
                               enc_input=ref_in(enc), remat=False)
    assert logits.shape == (2, PROMPT, cfg.vocab_size)   # meta dropped
    close(logits, rlogits, **LOGIT_TOL)
    close(aux, raux)


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_grads(model, remat):
    """The loss and every parameter's gradient (torch.autograd against
    jax.grad), with and without remat."""
    cfg, rcfg, ref, port = model
    toks, enc = inputs(cfg, 31, S=16)
    batch = {"tokens": jnp.asarray(toks)}
    if enc is not None:
        batch["enc_input"] = jnp.asarray(enc)
    (rloss, raux), rgrads = jax.value_and_grad(RT.lm_loss, has_aux=True)(
        ref, rcfg, batch, remat=remat)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tree_leaves(port)}
    pbatch = {"tokens": torch.tensor(toks)}
    if enc is not None:
        pbatch["enc_input"] = t32(enc)
    loss, aux = T.lm_loss(unflatten(leaves), cfg, pbatch, remat=remat)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(rloss), rel=1e-5)
    assert float(aux["ce"]) == pytest.approx(float(raux["ce"]), rel=1e-5)
    assert float(aux["aux"]) == 0.0 == float(raux["aux"])
    rflat = flat_ref(rgrads)
    assert sorted(rflat) == sorted(leaves)
    for k, g in rflat.items():
        scale = float(np.abs(g).max()) or 1.0
        np.testing.assert_allclose(leaves[k].grad.numpy(), g, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


PREFILL_CASES = {
    "ssm": ("ssm", PROMPT, None),
    "ssm_two_chunks": ("ssm", 256, None),        # chunks of 128: the scan
    "hybrid": ("hybrid", PROMPT, None),
    "hybrid_valid_len": ("hybrid", PROMPT, 17),
    "hybrid_two_chunks": ("hybrid", 248, None),  # 8 meta + 248 = 2 x 128
    "encdec": ("encdec", PROMPT, None),
    "encdec_valid_len": ("encdec", PROMPT, 17),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill(case):
    """A prompt (24 tokens, hybrid's 32 positions past its 16-position
    window; 256 positions in two SSD chunks; or 17 real tokens and a pad
    suffix at position -1, the logits read at content position 16) into
    the decode state: the last logits and every cache leaf against the
    reference's (encdec's cross K/V included)."""
    family, length, valid_len = PREFILL_CASES[case]
    cfg, rcfg, ref, port = _model(family, "float32")
    toks, enc = inputs(cfg, 32, S=length)
    if valid_len:
        toks[:, valid_len:] = 0
    cache = max(CACHE, length)
    state = T.init_decode_state(cfg, 2, cache, dtype=torch.float32,
                                device="cpu", enc_len=ENC_LEN)
    logits, state = T.prefill(port, cfg, torch.tensor(toks), state,
                              enc_input=port_in(enc), valid_len=valid_len)
    rlogits, rstate = RT.prefill(
        ref, rcfg, jnp.asarray(toks),
        RT.init_decode_state(rcfg, 2, cache, dtype=jnp.float32,
                             enc_len=ENC_LEN),
        enc_input=ref_in(enc),
        valid_len=None if valid_len is None else jnp.asarray(valid_len))
    close(logits, rlogits, **LOGIT_TOL)
    close_state(state, rstate, scale_close if length > 128 else None)
    if valid_len and family != "ssm":
        n_meta = T._n_meta(cfg)
        assert (state.attn.pos[:, :, n_meta + valid_len:] == -1).all()


def test_prefill_replaces_cross_cache_of_other_length():
    """A state made without ``enc_len`` gets cross K/V of the encoder's
    length from prefill (the reference's prefill replaces the field)."""
    cfg, rcfg, ref, port = _model("encdec", "float32")
    toks, enc = inputs(cfg, 33)
    state = T.init_decode_state(cfg, 2, CACHE, dtype=torch.float32,
                                device="cpu")
    assert state.cross_k.shape[2] == 0
    _, state = T.prefill(port, cfg, torch.tensor(toks), state,
                         enc_input=port_in(enc))
    _, rstate = RT.prefill(ref, rcfg, jnp.asarray(toks),
                           RT.init_decode_state(rcfg, 2, CACHE,
                                                dtype=jnp.float32),
                           enc_input=ref_in(enc))
    close_state(state, rstate)


def _decode_run(cfg, rcfg, ref, port, cache_dtype, steps=5):
    """Prefill PROMPT tokens, then ``steps`` decode steps fed the
    reference's greedy tokens at one scalar position; yields every step's
    (port logits, reference logits), then the final states."""
    toks, enc = inputs(cfg, 34)
    pdt = getattr(torch, cache_dtype)
    state = port_state(cfg, 2, pdt)
    logits, state = T.prefill(port, cfg, torch.tensor(toks), state,
                              enc_input=port_in(enc, port["embed"].dtype))
    rlogits, rstate = RT.prefill(ref, rcfg, jnp.asarray(toks),
                                 ref_state(rcfg, 2, cache_dtype),
                                 enc_input=ref_in(enc, ref["embed"].dtype))
    yield logits, rlogits
    step = jax.jit(lambda p, tok, st, t: RT.decode_step(p, rcfg, tok, st, t))
    for t in range(PROMPT, PROMPT + steps):
        nxt = np.asarray(jnp.argmax(rlogits, -1), np.int32)[:, None]
        logits, state = T.decode_step(port, cfg, torch.tensor(nxt), state, t)
        rlogits, rstate = step(ref, jnp.asarray(nxt), rstate,
                               jnp.asarray(t, jnp.int32))
        yield logits, rlogits
    yield state, rstate


def test_decode_steps(model):
    """Prefill 24 tokens, then 5 decode steps (hybrid's window of 16 cuts
    layer 1's view; encdec cross-attends every step): every step's logits
    and the final caches against the reference's."""
    cfg, rcfg, ref, port = model
    *steps, (state, rstate) = _decode_run(cfg, rcfg, ref, port, "float32")
    assert len(steps) == 6
    for logits, rlogits in steps:
        close(logits, rlogits, **LOGIT_TOL)
    close_state(state, rstate)


# --------------------------------------------------------------------------
# bf16 weights (the served dtype), as in tests/test_torch_lm.py
U = 2.0 ** -8
LOGIT_UNITS = 8     # two layers (and hymba's two heads, encdec's encoder)
#                     (measured 4.1)
CACHE_UNITS = 4     # a K/V or conv-history value: its layer's inputs and
#                     its own projection (measured 3.2)
STATE_UNITS = 8     # the fp32 SSM state sums x * B over the prompt; x and B
#                     each pass the in-projection, the conv's four taps and
#                     bias and the silu, rounding at each on torch's side
#                     and once on XLA's (measured 5.2)


def bf16_close(port, ref, units, msg=""):
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(port.detach().float())
                               if isinstance(port, torch.Tensor) else port,
                               ref, rtol=0,
                               atol=units * U * float(np.abs(ref).max()),
                               err_msg=msg)


def bf16_state(port, ref, key):
    bf16_close(port, ref, STATE_UNITS if key == "ssm.h" else CACHE_UNITS,
               key)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model_bf16(request):
    """The reference's own bf16 draws on both sides."""
    out = _model(request.param, "bfloat16")
    assert all(w.dtype == torch.bfloat16 for _, w in tree_leaves(out[3]))
    return out


def test_forward_bf16(model_bf16):
    cfg, rcfg, ref, port = model_bf16
    toks, enc = inputs(cfg, 30)
    logits, _ = T.forward(port, cfg, torch.tensor(toks),
                          enc_input=port_in(enc, torch.bfloat16))
    rlogits, _ = RT.forward(ref, rcfg, jnp.asarray(toks),
                            enc_input=ref_in(enc, jnp.bfloat16), remat=False)
    assert logits.dtype == torch.float32
    bf16_close(logits, rlogits, LOGIT_UNITS)


def test_prefill_bf16_weights_fp32_cache(model_bf16):
    """bf16 weights and the engine's fp32 cache (the SSM state fp32 as
    always): the prefill's logits and every cache leaf."""
    cfg, rcfg, ref, port = model_bf16
    toks, enc = inputs(cfg, 35)
    logits, state = T.prefill(port, cfg, torch.tensor(toks),
                              port_state(cfg, 2),
                              enc_input=port_in(enc, torch.bfloat16))
    rlogits, rstate = RT.prefill(ref, rcfg, jnp.asarray(toks),
                                 ref_state(rcfg, 2),
                                 enc_input=ref_in(enc, jnp.bfloat16))
    bf16_close(logits, rlogits, LOGIT_UNITS)
    assert all(v.dtype == np.float32 for k, v in
               decode_state_to_numpy(state).items() if not k.endswith("pos"))
    close_state(state, rstate, bf16_state)


def test_decode_steps_bf16(model_bf16):
    """bf16 weights and a bf16 cache (the reference's default; the SSM
    state stays fp32): prefill, 5 decode steps fed the reference's greedy
    tokens, every step's logits and the final caches."""
    cfg, rcfg, ref, port = model_bf16
    *steps, (state, rstate) = _decode_run(cfg, rcfg, ref, port, "bfloat16")
    for logits, rlogits in steps:
        bf16_close(logits, rlogits, LOGIT_UNITS)
    if state.ssm:
        assert state.ssm.h.dtype == torch.float32
    close_state(state, rstate, bf16_state)


# --------------------------------------------------------------------------
# refusals
@pytest.mark.parametrize("family,length,ok", [
    ("ssm", 130, False), ("ssm", 256, True), ("ssm", 100, True),
    ("hybrid", 130, False), ("hybrid", 120, True), ("hybrid", 128, False)])
def test_chunk_rule(family, length, ok):
    """Past 128 positions (hybrid's 8 meta tokens counted) a sequence must
    be a multiple of 128: otherwise prefill and forward raise a
    ValueError that names the rule, before any cache is written."""
    cfg, _ = cfgs(family)
    params = T.init_params(cfg, 0, device="cpu")
    toks = torch.zeros((1, length), dtype=torch.int32)
    state = T.init_decode_state(cfg, 1, 300, dtype=torch.float32,
                                device="cpu")
    if ok:
        T.prefill(params, cfg, toks, state)
        return
    for call in (lambda: T.prefill(params, cfg, toks, state),
                 lambda: T.forward(params, cfg, toks)):
        with pytest.raises(ValueError, match="multiple of 128"):
            call()
    assert all(not bool(v.any()) for k, v in
               decode_state_to_numpy(state).items() if not k.endswith("pos"))
    with pytest.raises(ValueError, match="multiple of 16"):
        S.ssd_apply({k: v[0] for k, v in params["layers"]["ssm"].items()},
                    cfg, torch.zeros((1, 40, cfg.d_model)), chunk=16)


def test_encdec_refusals():
    """A per-row position vector at an encdec decode step (the reference
    ropes the cross query at one position for the batch), before any
    cache is written; prefill without enc_input; the LM Engine."""
    cfg, _, _, port = _model("encdec", "float32")
    toks, enc = inputs(cfg, 36)
    state = port_state(cfg, 2)
    _, state = T.prefill(port, cfg, torch.tensor(toks), state,
                         enc_input=port_in(enc))
    before = decode_state_to_numpy(state)
    with pytest.raises(ValueError, match="one position"):
        T.decode_step(port, cfg, torch.zeros((2, 1), dtype=torch.int32),
                      state, torch.tensor([PROMPT, PROMPT + 1]))
    after = decode_state_to_numpy(state)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
    lp = {k: v[0] for k, v in port["layers"]["cross"].items()}
    with pytest.raises(ValueError, match="one position"):
        L.cross_attention_cached(lp, cfg, torch.zeros((2, 1, 64)),
                                 torch.tensor([3, 4]), state.cross_k[0],
                                 state.cross_v[0])
    with pytest.raises(ValueError, match="enc_input"):
        T.prefill(port, cfg, torch.tensor(toks), port_state(cfg, 2))
    with pytest.raises(ValueError, match="encoder input"):
        Engine(cfg, port, ServeConfig(slots=2, max_len=32), device="cpu")
