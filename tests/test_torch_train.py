"""The port's LM training path (``repro_torch.models.transformer.lm_loss``,
``repro_torch.train``, ``repro_torch.distributed.compression``,
``repro_torch.data``, ``repro_torch.examples.train_lm``) against the JAX
reference (``repro.models``, ``repro.train``, ``repro.distributed``), on
the CPU.

The reference packages import in this process (none of them needs the
names jax 0.9 moved).  Weights are the reference's own
``init_params(cfg, PRNGKey(0))`` at the ``.smoke()`` widths of
llama3.2-1b (dense) and granite-moe-3b-a800m (MoE: 4 experts, top-2),
fp32, carried across as numpy (``repro_torch.convert``); the PowerSGD Q
factors are the reference's ``jax.random`` draws carried the same way;
tokens and gradients are numpy draws from fixed seeds.  Two gloo ranks
(tests/torch_dist_child.py) run the compressor over a process group.

Tolerances, and why (everything fp32 unless stated):

* ``lm_loss`` within rtol 1e-5 (measured 2.3e-7: the same sums in another
  order), each gradient leaf within 1e-4 of its largest magnitude
  (measured 1.6e-6: two layers' backward, the MoE router's softmax
  included); remat off, on and nested equal bit for bit within the port
  (the recomputed forward is the same arithmetic);
* AdamW: fp32 parameters and moments within rtol/atol 1e-6 over 5 steps
  (``b ** t`` and the square root may differ by an ulp between XLA and
  torch); bf16 moments within one bf16 ulp (2**-8 relative) of the
  reference's, since an fp32 ulp in the moment can move its rounding;
  ``warmup_cosine`` within rtol 1e-6 (an ulp of ``cos``), the clipped
  gradients and the global norm within rtol 1e-6;
* PowerSGD: the compressed gradients, the new Q factors and the error
  buffers within 1e-4 of each leaf's largest magnitude over 3 rounds (a
  Cholesky factor and a triangular solve in another order); gradients of
  rank <= r come back within 1e-5 of themselves; small leaves pass
  through exactly; ``compression_ratio`` exactly;
* two gloo ranks against the reference under ``jax.vmap`` with ``pmean``
  as ``reduce_fn``: the same 1e-4, and the ranks' reduced factors equal
  bit for bit to each other;
* checkpoints exactly, bf16 leaves included, in both directions across
  the packages;
* ``Trainer`` against the reference ``Trainer`` from the same weights and
  Q draws: 5 steps' losses within rtol 1e-5 and the final parameters
  within atol 2e-5 (measured 1.4e-6 and 1.2e-6); the port's bitwise
  resume exact; ``microbatches=2`` equal to the full batch's first loss
  within rtol 1e-6 (two means of halves against one mean).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.tokens import TokenPipeline as RefPipeline
from repro.distributed import compression as RGC
from repro.models import transformer as RT
from repro.train import checkpoint as RCKPT
from repro.train import optimizer as ROPT
from repro.train import trainer as RTR

from repro_torch import configs
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy,
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed import compression as GC
from repro_torch.examples import train_lm
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, unflatten
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import optimizer as OPT
from repro_torch.train.trainer import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "torch_dist_child.py"
ARCHS = {"dense": "llama3.2-1b", "moe": "granite-moe-3b-a800m"}
RANK = 4
WORLD = 2
SPAWN_TIMEOUT = 300


def flat_ref(tree) -> dict:
    """A reference pytree of dicts as numpy arrays by dotted path (None
    leaves dropped)."""
    return {".".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def rel_close(port: dict, ref: dict, frac: float):
    """Every leaf within ``frac`` of its largest reference magnitude."""
    assert sorted(port) == sorted(ref)
    for k in ref:
        scale = float(np.max(np.abs(ref[k]))) or 1.0
        np.testing.assert_allclose(np.asarray(port[k], np.float32),
                                   np.asarray(ref[k], np.float32),
                                   rtol=0, atol=frac * scale, err_msg=k)


def to_np(tree) -> dict:
    return {k: v.detach().float().numpy() for k, v in tree_leaves(tree)
            if v is not None}


def smoke(family, **kw):
    cfg = configs.get(ARCHS[family]).smoke()
    rcfg = ref_configs.get(ARCHS[family]).smoke()
    return (dataclasses.replace(cfg, **kw), dataclasses.replace(rcfg, **kw))


# --------------------------------------------------------------------------
# the loss and its gradients
@pytest.fixture(scope="module", params=sorted(ARCHS))
def loss_case(request):
    """A 4-layer cut of the family's smoke config (so remat_groups=2 nests
    two layers a group), the reference's params and tokens, and the
    reference's value and gradients for each remat mode."""
    cfg, rcfg = smoke(request.param, n_layers=4)
    ref = RT.init_params(rcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    out = {}
    for remat, groups in ((False, 0), (True, 0), (True, 2)):
        (loss, aux), g = jax.value_and_grad(RT.lm_loss, has_aux=True)(
            ref, rcfg, {"tokens": jnp.asarray(toks)}, remat=remat,
            remat_groups=groups)
        out[(remat, groups)] = (float(loss), float(aux["ce"]),
                                float(aux["aux"]), flat_ref(g))
    return cfg, flat_ref(ref), toks, out


def port_value_and_grad(cfg, flat, toks, remat, groups):
    leaves = {k: torch.tensor(v).requires_grad_(True)
              for k, v in flat.items()}
    loss, aux = T.lm_loss(unflatten(leaves), cfg,
                          {"tokens": torch.tensor(toks)}, remat=remat,
                          remat_groups=groups)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
        {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("remat,groups", [(False, 0), (True, 0), (True, 2)])
def test_lm_loss_and_grads_match_reference(loss_case, remat, groups):
    cfg, flat, toks, ref = loss_case
    r_loss, r_ce, r_aux, r_grads = ref[(remat, groups)]
    loss, aux, grads = port_value_and_grad(cfg, flat, toks, remat, groups)
    assert float(loss) == pytest.approx(r_loss, rel=1e-5)
    assert float(aux["ce"]) == pytest.approx(r_ce, rel=1e-5)
    assert float(aux["aux"]) == pytest.approx(r_aux, rel=1e-5, abs=1e-6)
    if cfg.family == "dense":
        assert float(aux["aux"]) == 0.0
    rel_close({k: v.numpy() for k, v in grads.items()}, r_grads, 1e-4)


def test_remat_is_bitwise_within_the_port(loss_case):
    cfg, flat, toks, _ = loss_case
    runs = [port_value_and_grad(cfg, flat, toks, remat, groups)
            for remat, groups in ((False, 0), (True, 0), (True, 2))]
    for loss, _, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for k in grads:
            assert torch.equal(grads[k], runs[0][2][k]), k


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_grads_repeat_bit_for_bit(family):
    """Two backward passes at a train_lm batch (8 x 256 tokens, every
    vocabulary row and expert hit many times) give equal bits: the
    embedding's and the MoE dispatch's backward sum their duplicates in a
    fixed order."""
    cfg, _ = smoke(family)
    params = T.init_params(cfg, 3, device="cpu")
    toks = torch.tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (8, 256)))
    runs = []
    for _ in range(3):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in tree_leaves(params)}
        loss, _ = T.lm_loss(unflatten(leaves), cfg, {"tokens": toks})
        loss.backward()
        runs.append({k: v.grad for k, v in leaves.items()})
    for other in runs[1:]:
        for k in other:
            assert torch.equal(other[k], runs[0][k]), k


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b",
                                  "seamless-m4t-medium"])
def test_lm_loss_refuses_unported_families(arch):
    """Every family of the repo is ported: the three last ones take a loss
    (finite, at their smoke widths; held against the reference in
    tests/test_torch_lm_families.py), a family outside the five is
    refused, and so is an encoder-decoder batch without ``enc_input``."""
    cfg = configs.get(arch).smoke()
    params = T.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    if cfg.family == "encdec":
        with pytest.raises(ValueError, match="enc_input"):
            T.lm_loss(params, cfg, batch)
        batch["enc_input"] = torch.ones((1, 6, cfg.d_model))
    loss, _ = T.lm_loss(params, cfg, batch)
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="unknown family"):
        T.lm_loss(params, dataclasses.replace(cfg, family="rnn"), batch)


# --------------------------------------------------------------------------
# AdamW and the schedule
def _opt_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "stack": {"a": rng.standard_normal((3, 4, 7)).astype(np.float32),
                      "b": rng.standard_normal((9,)).astype(np.float32)}}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(moment_dtype):
    rng = np.random.default_rng(1)
    p0 = _opt_tree(rng)
    cfg = OPT.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=0.5,
                          moment_dtype=moment_dtype)
    rcfg = ROPT.AdamWConfig(**dataclasses.asdict(cfg))
    rp = jax.tree.map(jnp.asarray, p0)
    rst = ROPT.adamw_init(rp, rcfg)
    pp = {k: torch.tensor(v) for k, v in flat_ref(p0).items()}
    pp = unflatten(pp)
    st = OPT.adamw_init(pp, cfg)
    mom_tol = (dict(rtol=2 ** -8, atol=1e-7) if moment_dtype == "bfloat16"
               else dict(rtol=1e-6, atol=1e-7))
    for step in range(5):
        g = _opt_tree(rng)
        lr_r = ROPT.warmup_cosine(jnp.asarray(step), peak_lr=cfg.lr,
                                  warmup=2, total=10)
        lr = OPT.warmup_cosine(step, peak_lr=cfg.lr, warmup=2, total=10)
        rp, rst, rm = ROPT.adamw_update(rp, jax.tree.map(jnp.asarray, g),
                                        rst, rcfg, lr_r)
        pp, st, m = OPT.adamw_update(
            pp, unflatten({k: torch.tensor(v)
                           for k, v in flat_ref(g).items()}), st, cfg, lr)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-6)
        assert int(st.step) == int(rst.step) == step + 1
        for k, v in flat_ref(rp).items():
            np.testing.assert_allclose(dict(tree_leaves(pp))[k].numpy(), v,
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        for name in ("mu", "nu"):
            port = to_np(getattr(st, name))
            for k, v in flat_ref(getattr(rst, name)).items():
                assert dict(tree_leaves(getattr(st, name)))[k].dtype == \
                    getattr(torch, moment_dtype)
                np.testing.assert_allclose(port[k], v.astype(np.float32),
                                           err_msg=f"{name}.{k}", **mom_tol)


def test_warmup_cosine_matches_reference():
    for warmup, total in ((10, 100), (0, 7), (5, 5)):
        for s in range(0, total + 3):
            want = float(ROPT.warmup_cosine(jnp.asarray(s), peak_lr=3e-4,
                                            warmup=warmup, total=total))
            got = OPT.warmup_cosine(s, peak_lr=3e-4, warmup=warmup,
                                    total=total)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _opt_tree(np.random.default_rng(2))
    rclip, rnorm = ROPT.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                            max_norm)
    clip, norm = OPT.clip_by_global_norm(
        unflatten({k: torch.tensor(v) for k, v in flat_ref(g).items()}),
        max_norm)
    assert float(norm) == pytest.approx(float(rnorm), rel=1e-6)
    assert float(OPT.global_norm(clip)) == pytest.approx(
        float(ROPT.global_norm(rclip)), rel=1e-6)
    np.testing.assert_allclose(to_np(clip)["w"], np.asarray(rclip["w"]),
                               rtol=1e-6)


# --------------------------------------------------------------------------
# PowerSGD
def _comp_params(rng):
    """A stacked (L, n, m) leaf, a matrix, and two leaves too small to
    compress at rank 4 (a vector, and a 4 x 6 matrix: 24 <= 2*4*10)."""
    return {"layers": {"w": rng.standard_normal((3, 24, 40)
                                                ).astype(np.float32),
                       "norm": rng.standard_normal((3, 40)
                                                   ).astype(np.float32)},
            "mat": rng.standard_normal((32, 48)).astype(np.float32),
            "small": rng.standard_normal((4, 6)).astype(np.float32)}


def _ref_q(params, seed=3):
    st = RGC.init_compressor(jax.tree.map(jnp.asarray, params), RANK,
                             jax.random.PRNGKey(seed))
    return flat_ref(st.q)


def _port_state(params, q):
    return GC.init_compressor(
        unflatten({k: torch.tensor(v) for k, v in flat_ref(params).items()}),
        RANK, q=q)


def test_compress_gradients_matches_reference():
    rng = np.random.default_rng(4)
    params = _comp_params(rng)
    q = _ref_q(params)
    assert sorted(q) == ["layers.w", "mat"]
    rst = RGC.init_compressor(jax.tree.map(jnp.asarray, params), RANK,
                              jax.random.PRNGKey(3))
    st = _port_state(params, q)
    for _ in range(3):
        g = _comp_params(rng)
        rg, rst = RGC.compress_gradients(jax.tree.map(jnp.asarray, g), rst)
        pg, st = GC.compress_gradients(
            unflatten({k: torch.tensor(v) for k, v in flat_ref(g).items()}),
            st)
        rel_close(to_np(pg), flat_ref(rg), 1e-4)
        rel_close(to_np(st.q), flat_ref(rst.q), 1e-4)
        rel_close(to_np(st.error), flat_ref(rst.error), 1e-4)
        for k in ("layers.norm", "small"):       # passed through exactly
            np.testing.assert_array_equal(to_np(pg)[k], flat_ref(g)[k])
            assert dict(tree_leaves(st.q))[k] is None
            assert dict(tree_leaves(st.error))[k] is None
    assert st.rank == RANK


def test_rank_r_gradient_is_exact():
    """One warm-started round reproduces a gradient of rank <= r (P spans
    its column space), with a zero error buffer.  The gradient is
    well conditioned (singular values 1.2 to 2): the Gram-Cholesky step
    squares P's condition number in fp32."""
    rng = np.random.default_rng(5)
    u = np.linalg.qr(rng.standard_normal((2, 30, RANK)))[0]
    v = np.linalg.qr(rng.standard_normal((2, 20, RANK)))[0]
    g = np.einsum("lnr,r,lmr->lnm", u, [2.0, 1.8, 1.5, 1.2][:RANK],
                  v).astype(np.float32)
    params = {"w": np.zeros_like(g)}
    st = _port_state(params, _ref_q(params))
    out, st = GC.compress_gradients({"w": torch.tensor(g)}, st)
    np.testing.assert_allclose(out["w"].numpy(), g, rtol=0,
                               atol=1e-5 * np.abs(g).max())
    assert float(st.error["w"].abs().max()) <= 1e-5 * np.abs(g).max()
    qq = GC._orthonormalize(torch.tensor(g) @ st.q["w"])
    eye = torch.eye(RANK).expand(2, RANK, RANK)
    torch.testing.assert_close(qq.mT @ qq, eye, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["lm100m", "llama3.2-1b",
                                  "granite-moe-3b-a800m"])
@pytest.mark.parametrize("rank", [1, 4, 64])
def test_compression_ratio_matches_reference(arch, rank):
    """At full width, on shapes alone (meta tensors, ShapeDtypeStructs)."""
    port = {k: torch.empty(v.shape, device="meta") for k, v in
            tree_leaves(T.model_schema(configs.get(arch)))}
    ref = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32),
                       RT.model_schema(ref_configs.get(arch)),
                       is_leaf=lambda x: hasattr(x, "fan_in_axes"))
    assert GC.compression_ratio(unflatten(port), rank) == \
        RGC.compression_ratio(ref, rank)


# --------------------------------------------------------------------------
# PowerSGD over two gloo ranks
def _dist_inputs():
    rng = np.random.default_rng(6)
    params = _comp_params(rng)
    out = {"train/paths": np.array(json.dumps(
        {k: list(v.shape) for k, v in flat_ref(params).items()}))}
    out.update({f"train/q/{k}": v for k, v in _ref_q(params).items()})
    for rnd in range(2):
        for r in range(WORLD):
            out.update({f"train/g{rnd}/{r}/{k}": v for k, v in
                        flat_ref(_comp_params(rng)).items()})
    return params, out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    params, inputs = _dist_inputs()
    tmp = tmp_path_factory.mktemp("train_ranks")
    src = tmp / "in.npz"
    np.savez(src, **inputs)
    store = tmp / "store"
    store.mkdir()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(CHILD), str(r), str(WORLD), str(store),
                 str(src), str(tmp / f"rank{r}.npz")],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=SPAWN_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp / f"rank{r}.log").read_text()[-4000:]
    return params, inputs, [dict(np.load(tmp / f"rank{r}.npz"))
                            for r in range(WORLD)]


def test_two_gloo_ranks_match_reference_pmean(two_ranks):
    params, inputs, ranks = two_ranks
    paths = sorted(json.loads(str(inputs["train/paths"])))
    q0 = {k: inputs[f"train/q/{k}"] for k in ("layers.w", "mat")}

    def ref_round(g, q, e):
        st = RGC.CompressorState(q=q, error=e, rank=RANK)
        out, st = RGC.compress_gradients(
            g, st, lambda x: jax.lax.pmean(x, "data"))
        return out, st.q, st.error

    stack = lambda a: jnp.stack([jnp.asarray(a)] * WORLD)
    none_tree = lambda d: unflatten({k: d.get(k) for k in paths})
    q = none_tree({k: stack(v) for k, v in q0.items()})
    e = none_tree({k: jnp.zeros((WORLD, *inputs[f"train/g0/0/{k}"].shape))
                   for k in q0})
    for rnd in range(2):
        g = unflatten({k: jnp.stack([inputs[f"train/g{rnd}/{r}/{k}"]
                                  for r in range(WORLD)]) for k in paths})
        rg, q, e = jax.vmap(ref_round, axis_name="data")(g, q, e)
        for name, tree in (("g", rg), ("q", q), ("e", e)):
            want = flat_ref(tree)
            for r, out in enumerate(ranks):
                got = {k: out[f"train/{rnd}/{name}/{k}"] for k in want}
                rel_close(got, {k: v[r] for k, v in want.items()}, 1e-4)
        for k in paths:      # the reduced gradients and factors: one value
            np.testing.assert_array_equal(ranks[0][f"train/{rnd}/g/{k}"],
                                          ranks[1][f"train/{rnd}/g/{k}"])


# --------------------------------------------------------------------------
# checkpoints
def _ckpt_trees():
    """The same tree in both packages: bf16 and fp32 parameters, an AdamW
    state (NamedTuple) and a compressor state with a None factor."""
    rng = np.random.default_rng(8)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    mu = rng.standard_normal((4, 6)).astype(np.float32)
    qf = rng.standard_normal((6, 2)).astype(np.float32)
    ref = {"params": {"w": jnp.asarray(w, jnp.bfloat16),
                      "b": jnp.asarray(b)},
           "opt": ROPT.AdamWState(
               step=jnp.asarray(3, jnp.int32),
               mu={"w": jnp.asarray(mu), "b": jnp.asarray(b)},
               nu={"w": jnp.asarray(mu), "b": jnp.asarray(b)}),
           "comp": RGC.CompressorState(
               q={"w": jnp.asarray(qf), "b": None},
               error={"w": jnp.asarray(mu), "b": None}, rank=2)}
    port = {"params": {"w": torch.tensor(w).bfloat16(),
                       "b": torch.tensor(b)},
            "opt": OPT.AdamWState(
                step=torch.tensor(3, dtype=torch.int32),
                mu={"w": torch.tensor(mu), "b": torch.tensor(b)},
                nu={"w": torch.tensor(mu), "b": torch.tensor(b)}),
            "comp": GC.CompressorState(
                q={"w": torch.tensor(qf), "b": None},
                error={"w": torch.tensor(mu), "b": None}, rank=2)}
    return ref, port


def _zeros_like_port(tree):
    def z(x):
        if isinstance(x, dict):
            return {k: z(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return type(x)(*(z(v) for v in x))
        if isinstance(x, torch.Tensor):
            return torch.zeros_like(x)
        return 0 if isinstance(x, int) else x
    return z(tree)


def _port_equals(a, b):
    la, lb = CKPT._flatten_with_paths(a), CKPT._flatten_with_paths(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), n
        else:
            assert x == y, n


def test_checkpoint_roundtrip_with_bf16(tmp_path):
    _, port = _ckpt_trees()
    CKPT.save(str(tmp_path), 5, port, extra={"step": 5})
    out, extra = CKPT.restore(str(tmp_path), _zeros_like_port(port))
    assert extra == {"step": 5}
    _port_equals(out, port)
    man = json.loads((tmp_path / "step_00000005" / "manifest.json"
                      ).read_text())
    assert man["format"] == 1
    assert man["leaves"]["params/w"] == {"shape": [4, 6],
                                         "dtype": "bfloat16"}
    assert np.load(tmp_path / "step_00000005" / "shard_00000.npz")[
        "params/w"].dtype == np.dtype("V2")


def test_checkpoint_names_equal_reference():
    ref, port = _ckpt_trees()
    assert [n for n, _ in CKPT._flatten_with_paths(port)] == \
        [n for n, _ in RCKPT._flatten_with_paths(ref)]


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_checkpoint_format_across_packages(tmp_path, direction):
    ref, port = _ckpt_trees()
    if direction == "port_to_ref":
        CKPT.save(str(tmp_path), 2, port, extra={"k": 1})
        out, extra = RCKPT.restore(str(tmp_path), ref)
        names = [n for n, _ in RCKPT._flatten_with_paths(ref)]
        for n, (x, y) in zip(names, zip(
                [v for _, v in RCKPT._flatten_with_paths(out)],
                [v for _, v in RCKPT._flatten_with_paths(ref)])):
            if isinstance(y, jax.Array):   # (the rank int comes back int32)
                assert x.dtype == y.dtype, n
            np.testing.assert_array_equal(np.asarray(x, np.float32),
                                          np.asarray(y, np.float32), n)
    else:
        RCKPT.save(str(tmp_path), 2, ref, extra={"k": 1})
        out, extra = CKPT.restore(str(tmp_path), _zeros_like_port(port))
        _port_equals(out, port)
    assert extra == {"k": 1}


def test_checkpoint_atomic_retention_async(tmp_path):
    tree = {"a": torch.ones(4)}
    for s in range(6):
        CKPT.save_async(str(tmp_path), s, {"a": torch.full((4,), float(s))},
                        keep=3)
        CKPT.wait_pending()
    assert sorted(int(n[5:]) for n in os.listdir(tmp_path)) == [3, 4, 5]
    os.makedirs(tmp_path / "step_00000009.tmp")    # a crash mid-write
    assert CKPT.latest_step(str(tmp_path)) == 5
    out, _ = CKPT.restore(str(tmp_path), tree)
    assert torch.equal(out["a"], torch.full((4,), 5.0))
    # the snapshot is taken before save_async returns
    t = torch.zeros(3)
    CKPT.save_async(str(tmp_path / "snap"), 1, {"t": t})
    t.fill_(7.0)
    CKPT.wait_pending()
    out, _ = CKPT.restore(str(tmp_path / "snap"), {"t": torch.ones(3)})
    assert torch.equal(out["t"], torch.zeros(3))


def test_checkpoint_shape_mismatch_and_missing(tmp_path):
    CKPT.save(str(tmp_path), 1, {"a": torch.ones(4)})
    with pytest.raises(CKPT.CheckpointError, match="shape mismatch"):
        CKPT.restore(str(tmp_path), {"a": torch.ones(5)})
    with pytest.raises(CKPT.CheckpointError, match="missing leaf"):
        CKPT.restore(str(tmp_path), {"b": torch.ones(4)})
    with pytest.raises(CKPT.CheckpointError, match="no checkpoint"):
        CKPT.restore(str(tmp_path / "none"), {"a": torch.ones(4)})


# --------------------------------------------------------------------------
# the Trainer
def _pipelines(cfg):
    kw = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=1)
    return RefPipeline(**kw), TokenPipeline(**kw)


def _tcfgs(**kw):
    base = dict(warmup_steps=2, total_steps=50, remat=False, **kw)
    return (RTR.TrainConfig(optimizer=ROPT.AdamWConfig(lr=1e-3), **base),
            TrainConfig(optimizer=OPT.AdamWConfig(lr=1e-3), **base))


def test_train_config_fields_equal_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(TrainConfig)
            if f.name != "optimizer"] == \
        [(f.name, f.default) for f in dataclasses.fields(RTR.TrainConfig)
         if f.name != "optimizer"]
    assert dataclasses.asdict(OPT.AdamWConfig()) == \
        dataclasses.asdict(ROPT.AdamWConfig())


@pytest.mark.parametrize("family,rank", [("dense", 0), ("dense", RANK),
                                         ("moe", 0), ("moe", RANK)])
def test_trainer_matches_reference(family, rank):
    cfg, rcfg = smoke(family)
    rtcfg, tcfg = _tcfgs(compress_rank=rank)
    rpipe, pipe = _pipelines(cfg)
    rtr = RTR.Trainer(rcfg, rtcfg, rpipe, key=jax.random.PRNGKey(0))
    p0 = flat_ref(rtr.state.params)
    q0 = flat_ref(rtr.state.comp_state.q) if rank else None
    tr = Trainer(cfg, tcfg, pipe, device="cpu",
                 params=lm_params_from_numpy(cfg, p0, device="cpu"), q=q0)
    rh, h = rtr.run(5, log_every=0), tr.run(5, log_every=0)
    np.testing.assert_allclose([x["loss"] for x in h],
                               [x["loss"] for x in rh], rtol=1e-5)
    np.testing.assert_allclose([x["lr"] for x in h], [x["lr"] for x in rh],
                               rtol=1e-6)
    got = lm_params_to_numpy(tr.state.params)
    for k, v in flat_ref(rtr.state.params).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=2e-5, err_msg=k)
    # the whole training state carries across and back
    ref_state = {f"params.{k}": v for k, v in
                 flat_ref(rtr.state.params).items()}
    ref_state["opt.step"] = np.asarray(rtr.state.opt_state.step)
    for name in ("mu", "nu"):
        ref_state.update({f"opt.{name}.{k}": v for k, v in flat_ref(
            getattr(rtr.state.opt_state, name)).items()})
    if rank:
        for name in ("q", "error"):
            ref_state.update({f"comp.{name}.{k}": v for k, v in flat_ref(
                getattr(rtr.state.comp_state, name)).items()})
    back = train_state_to_numpy(train_state_from_numpy(
        cfg, tcfg, ref_state, device="cpu"))
    assert sorted(back) == sorted(ref_state)
    for k, v in ref_state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_microbatches_equal_full_batch_loss():
    cfg, _ = smoke("dense")
    losses = []
    for mb in (1, 2):
        tcfg = TrainConfig(optimizer=OPT.AdamWConfig(lr=0.0),
                           warmup_steps=1, total_steps=5, microbatches=mb,
                           remat=False)
        tr = Trainer(cfg, tcfg, _pipelines(cfg)[1], gen=0, device="cpu")
        losses.append(tr.run(1, log_every=0)[0]["loss"])
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)


@pytest.mark.parametrize("family,rank", [("dense", RANK), ("moe", 0)])
def test_bitwise_resume_after_crash(tmp_path, family, rank):
    """Train 6, against train 3, 'crash', resume from step 3, continue to
    6: the losses and the final parameters equal to the bit."""
    cfg, _ = smoke(family)

    def make(d):
        tcfg = TrainConfig(optimizer=OPT.AdamWConfig(lr=1e-3),
                           warmup_steps=2, total_steps=50,
                           compress_rank=rank, checkpoint_dir=str(d),
                           checkpoint_every=100, remat=True)
        return Trainer(cfg, tcfg, _pipelines(cfg)[1], gen=0, device="cpu")

    full = make(tmp_path / "a")
    full.run(6, log_every=0)
    part = make(tmp_path / "b")
    part.run(3, log_every=0)
    part.save(async_=False)
    resumed = make(tmp_path / "b")
    assert resumed.try_resume() and resumed.state.step == 3
    resumed.run(3, log_every=0)
    assert [h["loss"] for h in full.history] == \
        [h["loss"] for h in part.history + resumed.history]
    for (k, a), (_, b) in zip(tree_leaves(full.state.params),
                              tree_leaves(resumed.state.params)):
        assert torch.equal(a, b), k


def test_train_lm_example_runs_and_resumes(tmp_path):
    out = train_lm.run(device="cpu", small=True, steps=5,
                       ckpt_dir=str(tmp_path), log_every=0)
    assert out["resumed_from"] is None and len(out["history"]) == 5
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["cfg"].name == "lm100m-smoke"
    again = train_lm.run(device="cpu", small=True, steps=7,
                         ckpt_dir=str(tmp_path), log_every=0)
    assert again["resumed_from"] == 5 and len(again["history"]) == 2


def test_token_pipeline_equals_reference():
    cfg, _ = smoke("dense")
    ref, port = _pipelines(cfg)
    for i in (0, 3):
        np.testing.assert_array_equal(port.batch_at(i), ref.batch_at(i))
