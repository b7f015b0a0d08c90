"""Reference runs for the PyTorch port's parity tests, in a child process.

Run as ``python tests/torch_ref_child.py MODE OUT.npz`` (MODE one of
streaming, rounds, engine, hierarchy, streaming_pca, faulty_fleet,
compression_fleet, event_fleet, lm_engine, pipeline) with ``JAX_PLATFORMS=cpu`` and ``src`` on
``PYTHONPATH`` (and, for
``hierarchy``, ``XLA_FLAGS=--xla_force_host_platform_device_count=2``: its
runs shard over a two-device mesh; for ``pipeline``, ``=4``).  The installed jax
moved ``ClosedJaxpr``, ``Jaxpr`` and ``Literal`` from ``jax.core`` to
``jax.extend.core``; ``repro.analysis`` (imported at the bottom of
``repro.streaming.driver`` and ``repro.serve.engine``) still reads them from
``jax.core``.  This process aliases the three names before importing the
reference — so the alias never exists inside the pytest process, where it
would change which reference tests pass depending on import order.

The inputs are made here with numpy from fixed seeds and written to the
output beside the reference's results, so the parent runs the port on
exactly the same data.  Keys: ``{scenario}/cfg`` (JSON of the config),
``{scenario}/x``, ``/masks``, ``/rv`` (inputs), ``{scenario}/c{i}/pre.*``
(state before chunk i), ``/post.*`` (state after), ``/m.*`` (metrics);
``quantize/*`` (the score quantizer on fixed scores).  The ``rounds`` run
writes the per-round scenarios the same way, ``{scenario}/r{i}/...`` for
round i, plus ``{scenario}/run/final.*`` and ``/run/m.*`` (the reference's
``stream_run`` over the whole stream), ``online/*`` and ``stream_cov/*``
(the online covariance per round under each mask kind) and ``batched/*``
(``batched_stream_run`` of a three-network fleet, per round and chunked).
The engine run writes the default configuration's results at the top
level (each request its own region, with ``fleet/q{q_fleet}/...`` from
``fleet_summary``), the pipelined engine's under ``pipe/`` (with its
prestage counts), the quantized configuration's under ``quant/`` and the
bf16 tile mode's under ``bf16/``.  The hierarchy run writes ``merge/*``
(``merge_fleet`` and ``fleet_basis_dense`` on energy tables with ties),
and for each two-level or sharded scenario its inputs, initial states
(``{name}/init.*``), final states, metrics and merge.  The ``lm_engine``
run serves the LM ``Engine`` at seven smoke configurations (``dense``:
llama3.2-1b's, with prompt buckets; ``moe``: granite-moe-3b-a800m's;
``ssm``: mamba2-2.7b's; ``hybrid``: hymba-1.5b's; ``qkv_bias``:
qwen2-7b's; ``qk_norm``: chameleon-34b's; ``top6``: moonshot-v1-16b-a3b's
with 8 experts, top-6) and
writes, under ``{name}/``, the configuration's name and the fields
replaced in its ``.smoke()`` (JSON), slots and cache length, the parameters of ``repro.models.transformer.init_params(cfg,
PRNGKey(0))`` keyed by dotted path (``params.layers.attn.wq``, ...), and
each request's prompt, ``max_new_tokens``, ``eos_id`` and output tokens
(``req{i}/...``).  The ``pipeline`` run writes the reference pipeline's
output and gradients on 1, 2 and 4 stages (``pipe/*``, :func:`pipeline`).
"""

from __future__ import annotations

import dataclasses
import json
import sys

import jax
import jax.extend.core as _jec

for _name in ("ClosedJaxpr", "Jaxpr", "Literal"):
    if not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(_jec, _name))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.streaming.compressor import (CompressionConfig,  # noqa: E402
                                        quantize_scores)
from repro.streaming.detector import DetectionConfig  # noqa: E402
from repro.streaming.driver import (StreamConfig,  # noqa: E402
                                    batched_stream_init, batched_stream_run,
                                    chunk_stream_step, stream_init,
                                    stream_run, stream_step)
from repro.streaming.online_cov import (online_init,  # noqa: E402
                                        online_update, stream_covariance)


def signal(rng, rounds, n, p, *, rank=3, noise=0.05, spike_rate=3e-4,
           rotate_at=None):
    """A spatially local sensor field — ``rank`` smooth bumps a few sensors
    wide, so the covariance is banded as the paper assumes — plus small
    noise and rare large spikes (the readings the compression stage must
    flag and the detector must alarm on).  From round ``rotate_at`` on the
    bumps sit elsewhere (drift).  Readings stay well inside ε = 1 of the
    mean unless spiked, so flags keep a margin from ε."""
    j = np.arange(p)

    def bumps(centres):
        U = np.exp(-0.5 * ((j[:, None] - centres[None, :]) / 1.2) ** 2)
        return U / np.linalg.norm(U, axis=0)
    centres = np.linspace(0.15, 0.85, rank) * p
    U, U2 = bumps(centres), bumps(centres + p / (2 * rank))
    scale = np.array([0.9, 0.7, 0.5])[:rank]
    mean = rng.normal(size=(p,))
    g = rng.normal(size=(rounds, n, rank)) * scale
    x = np.einsum("tnr,pr->tnp", g, U)
    if rotate_at is not None:
        x[rotate_at:] = np.einsum("tnr,pr->tnp", g[rotate_at:], U2)
    x = x + mean + noise * rng.normal(size=x.shape)
    spikes = rng.random(x.shape) < spike_rate
    x = x + spikes * rng.choice([-5.0, 5.0], size=x.shape)
    return x.astype(np.float32)


def flatten(node, prefix):
    out = {}
    if node is None:
        return out
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        for f, v in zip(node._fields, node):
            out.update(flatten(v, f"{prefix}.{f}"))
        return out
    out[prefix] = np.asarray(node)
    return out


def _flat_tree(tree, prefix):
    """A dict of arrays (nested) by ``prefix.dotted.path``; an array by
    ``prefix``."""
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    return {f"{prefix}." + ".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def cfg_json(cfg):
    d = dataclasses.asdict(cfg)
    return json.dumps(d)


STREAM_SCENARIOS = {
    # name: (p, stages, masked, rounds, config overrides)
    "fused": (64, "cm", False, 24, {}),
    "fused_masked": (37, "cm", True, 22, {}),
    "compress_masked": (64, "c", True, 22, {}),
    "monitor": (37, "m", False, 24, {}),
    "band": (64, "", False, 24, {}),
    "band_masked": (37, "", True, 22, {}),
    "split": (64, "cm", False, 24, dict(fused=False)),
    "split_masked": (37, "cm", True, 22, dict(fused=False)),
    "quant": (64, "cm", False, 24, dict(score_bits=4)),
    "quant_masked": (37, "c", True, 22, dict(score_bits=4)),
    "fused_bf16": (64, "cm", False, 24, dict(precision="bf16")),
    "fused_bf16_masked": (37, "cm", True, 22, dict(precision="bf16")),
}
Q, H, K, N = 4, 3, 4, 8
QUANT_BITS = (2, 4, 8, 16)


def stream_cfg(p, stages, fused=True, score_bits=0, precision="fp32"):
    return StreamConfig(
        p=p, q=Q, halfwidth=H, forgetting=0.97, warmup_rounds=6,
        drift_threshold=0.05, fused=fused, precision=precision,
        compression=(CompressionConfig(epsilon=1.0, score_bits=score_bits)
                     if "c" in stages else None),
        detection=(DetectionConfig(alpha=1e-2, calib_rounds=1)
                   if "m" in stages else None))


def quantize_cases(out):
    """Scores with a spread of per-component ranges, an all-zero column
    (the scale's floor) and a column of half-integers up to 7 (at 4 bits
    its scale is exactly 1, so every code is a tie: half to even)."""
    rng = np.random.default_rng(99)
    z = rng.normal(size=(64, 6)) * rng.uniform(0.1, 5.0, size=6)
    z[:, 4] = 0.0
    z[:, 5] = rng.integers(-7, 7, size=64) + 0.5
    z[0, 5] = 7.0
    z = z.astype(np.float32)
    out["quantize/z"] = z
    for bits in QUANT_BITS:
        zq, scale = quantize_scores(jnp.asarray(z), bits)
        out[f"quantize/b{bits}/z"] = np.asarray(zq)
        out[f"quantize/b{bits}/scale"] = np.asarray(scale)


def run_streaming(out):
    quantize_cases(out)
    for si, (name, (p, stages, masked, rounds, over)) in enumerate(
            STREAM_SCENARIOS.items()):
        rng = np.random.default_rng(100 + si)
        cfg = stream_cfg(p, stages, **over)
        x = signal(rng, rounds, N, p, rotate_at=12)
        masks = None
        if masked:
            masks = np.ones((rounds, p), np.float32)
            masks[5:, 3] = 0.0                      # a death
            masks[9:14, p - 5:] = 0.0               # an outage and revival
            masks[17:, 10:12] = 0.0
        n_chunks = -(-rounds // K)
        pad = n_chunks * K - rounds
        rv = np.concatenate([np.ones(rounds), np.zeros(pad)]) \
            .astype(np.float32).reshape(n_chunks, K)
        xp = np.concatenate([x, np.zeros((pad, N, p), np.float32)])
        mp = None if masks is None else np.concatenate(
            [masks, np.zeros((pad, p), np.float32)])
        out[f"{name}/cfg"] = np.array(cfg_json(cfg))
        out[f"{name}/x"] = xp
        out[f"{name}/rv"] = rv
        if mp is not None:
            out[f"{name}/masks"] = mp
        step = jax.jit(lambda s, xc, mc, rc: chunk_stream_step(
            cfg, s, xc, mc, rc))
        st = stream_init(cfg, jax.random.PRNGKey(si))
        for c in range(n_chunks):
            sl = slice(c * K, (c + 1) * K)
            # pass round_valid only where the chunk is partial, exercising
            # both branches of the reference
            rc = jnp.asarray(rv[c]) if rv[c].min() < 1 else None
            mc = None if mp is None else jnp.asarray(mp[sl])
            out.update(flatten(st, f"{name}/c{c}/pre"))
            out[f"{name}/c{c}/has_rv"] = np.array(rc is not None)
            st, m = step(st, jnp.asarray(xp[sl]), mc, rc)
            out.update(flatten(st, f"{name}/c{c}/post"))
            out.update(flatten(m, f"{name}/c{c}/m"))
        out[f"{name}/n_chunks"] = np.array(n_chunks)


ROUND_SCENARIOS = {
    # name: (p, stages, masked, config overrides)
    "r_stages": (64, "cm", False, {}),
    "r_stages_masked": (37, "cm", True, {}),
    "r_band": (64, "", False, {}),
    "r_quant": (64, "cm", False, dict(score_bits=4)),
}
ROUNDS = 16


def round_masks(rounds, p):
    """A death, an outage with revival and a late pair of deaths."""
    masks = np.ones((rounds, p), np.float32)
    masks[5:, 3] = 0.0
    masks[8:11, p - 5:] = 0.0
    masks[12:, 10:12] = 0.0
    return masks


def online_cases(out):
    """The online covariance round by round under each mask kind (none,
    (p,) liveness, (n, p) dropout; prime p, n not a multiple of 8), and
    ``stream_covariance`` over the same rounds."""
    rng = np.random.default_rng(300)
    p, h, n, rounds = 37, 3, 6, 4
    x = rng.normal(size=(rounds, n, p)).astype(np.float32)
    masks = {"none": None,
             "live": (rng.random((rounds, p)) > 0.2).astype(np.float32),
             "drop": (rng.random((rounds, n, p)) > 0.2).astype(np.float32)}
    out["online/x"] = x
    for kind, m in masks.items():
        if m is not None:
            out[f"online/{kind}/mask"] = m
        st = online_init(p, h)
        for r in range(rounds):
            st = online_update(st, jnp.asarray(x[r]), forgetting=0.9,
                               mask=None if m is None else jnp.asarray(m[r]),
                               interpret=True)
            out.update(flatten(st, f"online/{kind}/r{r}"))
    st, trace = stream_covariance(online_init(p, h), jnp.asarray(x),
                                  forgetting=0.9, interpret=True)
    out.update(flatten(st, "stream_cov/state"))
    out["stream_cov/trace"] = np.asarray(trace)


def run_rounds(out):
    online_cases(out)
    for si, (name, (p, stages, masked, over)) in enumerate(
            ROUND_SCENARIOS.items()):
        rng = np.random.default_rng(200 + si)
        cfg = stream_cfg(p, stages, **over)
        x = signal(rng, ROUNDS, N, p, rotate_at=8, spike_rate=2e-3)
        masks = round_masks(ROUNDS, p) if masked else None
        out[f"{name}/cfg"] = np.array(cfg_json(cfg))
        out[f"{name}/x"] = x
        if masks is not None:
            out[f"{name}/masks"] = masks
        step = jax.jit(lambda s, xr, mr: stream_step(cfg, s, xr, mr))
        st0 = st = stream_init(cfg, jax.random.PRNGKey(50 + si))
        for r in range(ROUNDS):
            out.update(flatten(st, f"{name}/r{r}/pre"))
            st, m = step(st, jnp.asarray(x[r]),
                         None if masks is None else jnp.asarray(masks[r]))
            out.update(flatten(st, f"{name}/r{r}/post"))
            out.update(flatten(m, f"{name}/r{r}/m"))
        fin, met = stream_run(cfg, st0, jnp.asarray(x),
                              None if masks is None else jnp.asarray(masks))
        out.update(flatten(fin, f"{name}/run/final"))
        out.update(flatten(met, f"{name}/run/m"))
    # a fleet of three networks: one healthy, one with a death, one with
    # an outage; per round and in chunks of 4 (14 rounds: a padded tail)
    nets, rounds, p = 3, 14, 37
    cfg = stream_cfg(p, "cm")
    rng = np.random.default_rng(400)
    xs = np.stack([signal(rng, rounds, N, p, rotate_at=7, spike_rate=2e-3)
                   for _ in range(nets)])
    masks = np.ones((nets, rounds, p), np.float32)
    masks[1, 4:, 6] = 0.0
    masks[2, 6:9, 20:24] = 0.0
    states = batched_stream_init(cfg, jax.random.PRNGKey(9), nets)
    out["batched/cfg"] = np.array(cfg_json(cfg))
    out["batched/x"], out["batched/masks"] = xs, masks
    out.update(flatten(states, "batched/init"))
    for label, chunk in (("round", None), ("chunk", 4)):
        fin, met = batched_stream_run(cfg, states, jnp.asarray(xs),
                                      jnp.asarray(masks), chunk=chunk)
        out.update(flatten(fin, f"batched/{label}/final"))
        out.update(flatten(met, f"batched/{label}/m"))


ENGINE_P, ENGINE_SLOTS = 64, 4


def engine_cfg(score_bits=0, precision="fp32"):
    return StreamConfig(
        p=ENGINE_P, q=Q, halfwidth=H, forgetting=0.98, warmup_rounds=K - 1,
        drift_threshold=0.05, precision=precision,
        compression=CompressionConfig(epsilon=1.0, score_bits=score_bits),
        detection=DetectionConfig(alpha=1e-3, calib_rounds=2))


# (q_fleet, c_regions) of the fleet summaries: a region's q, the whole
# fleet's components, and a region-tree fan-out of its own
FLEET_SUMMARIES = ((Q, None), (3 * Q, 2), (6 * Q, None))


def run_engine(out):
    serve_engine(out, engine_cfg(), "", summaries=FLEET_SUMMARIES)
    serve_engine(out, engine_cfg(), "pipe/", pipeline=True,
                 summaries=FLEET_SUMMARIES)
    serve_engine(out, engine_cfg(score_bits=4), "quant/")
    serve_engine(out, engine_cfg(precision="bf16"), "bf16/")


def serve_engine(out, cfg, prefix, pipeline=False, summaries=()):
    from repro.serve.engine import StreamingPCAEngine, StreamRequest
    rng = np.random.default_rng(7)
    lengths = [10, 13, 16, 9, 12, 14]
    reqs = []
    for i, R in enumerate(lengths):
        x = signal(rng, R, N, ENGINE_P)
        live = None
        if i == 2:
            live = np.ones((R, ENGINE_P), np.float32)
            live[6:, 20:28] = 0.0
        out[f"{prefix}req{i}/rounds"] = x
        if live is not None:
            out[f"{prefix}req{i}/liveness"] = live
        reqs.append(StreamRequest(rounds=x, liveness=live, region=i))
    eng = StreamingPCAEngine(cfg, slots=ENGINE_SLOTS, seed=0, chunk=K,
                             pipeline=pipeline)
    out[f"{prefix}init_bases"] = np.asarray(eng.states.sched.W)
    out[f"{prefix}cfg"] = np.array(cfg_json(cfg))
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    out[f"{prefix}steps"] = np.array(eng._clock)
    out[f"{prefix}prestage"] = np.array([eng._prestage_hits,
                                         eng._prestage_misses,
                                         eng._transfer_fences])
    out[f"{prefix}retired"] = np.array([reqs.index(q)
                                        for q, _ in eng.retired_log])
    for i, r in enumerate(reqs):
        for f in dataclasses.fields(r.result):
            v = getattr(r.result, f.name)
            if v is not None:
                out[f"{prefix}req{i}/result.{f.name}"] = np.asarray(v)
    for qf, cr in summaries:
        summ = eng.fleet_summary(qf, cr)
        for f in dataclasses.fields(summ):
            out[f"{prefix}fleet/q{qf}/{f.name}"] = np.asarray(
                getattr(summ, f.name))


MERGE_TABLES = {
    # ties within and across regions, a zero and equal rows
    "ties": np.array([[3.0, 1.0, 1.0, 0.5], [3.0, 2.0, 1.0, 0.5],
                      [1.0, 1.0, 0.0, 0.0]], np.float32),
    "random": np.abs(np.random.default_rng(500).normal(
        size=(5, 3))).astype(np.float32),
}
P_REGION, H_REGIONS, H_ROUNDS, H_N = 24, 4, 12, 6
HIER_SCENARIOS = {
    # name: (stages, masked, chunk, q_fleet, config overrides)
    "h_chunk": ("cm", True, 4, 2 * Q, {}),
    "h_round": ("", False, None, None, dict(forgetting=0.9)),
    "h_quiet": ("", False, 4, 3, dict(warmup_rounds=100)),
}
SHARD_SCENARIOS = {"s_round": None, "s_chunk": 4}


def region_data(rng, regions, rounds, n, p):
    """Independent regions whose energies differ by a gain per region, so
    the merge's ranking has a margin from ties."""
    return np.stack([(1.0 + 0.35 * r) * signal(rng, rounds, n, p,
                                                rotate_at=rounds // 2,
                                                spike_rate=0.0)
                     for r in range(regions)]).astype(np.float32)


def run_hierarchy(out):
    from repro.launch.mesh import make_fleet_mesh
    from repro.streaming.driver import sharded_stream_run
    from repro.streaming.hierarchy import (fleet_basis_dense,
                                           hierarchical_stream_init,
                                           hierarchical_stream_run,
                                           merge_fleet)
    assert jax.device_count() == 2, jax.devices()
    rng = np.random.default_rng(501)
    for name, table in MERGE_TABLES.items():
        n_regions, q_local = table.shape
        W = rng.normal(size=(n_regions, 6, q_local)).astype(np.float32)
        total = np.float32(table.sum() * 1.5)
        out[f"merge/{name}/table"], out[f"merge/{name}/W"] = table, W
        out[f"merge/{name}/total"] = np.asarray(total)
        for qf in range(1, n_regions * q_local + 1):
            basis = merge_fleet(jnp.asarray(table), jnp.asarray(total), qf)
            out.update(flatten(basis, f"merge/{name}/q{qf}"))
            out[f"merge/{name}/q{qf}/dense"] = np.asarray(
                fleet_basis_dense(basis, jnp.asarray(W)))
    mesh = make_fleet_mesh(region=2)
    for si, (name, (stages, masked, chunk, qf, over)) in enumerate(
            HIER_SCENARIOS.items()):
        cfg = dataclasses.replace(stream_cfg(P_REGION, stages), **over)
        xs = region_data(rng, H_REGIONS, H_ROUNDS, H_N, P_REGION)
        masks = None
        if masked:
            masks = np.ones((H_REGIONS, H_ROUNDS, P_REGION), np.float32)
            masks[1, 5:, 3] = 0.0
            masks[2, 4:8, 10:14] = 0.0
        states = hierarchical_stream_init(cfg, jax.random.PRNGKey(60 + si),
                                          H_REGIONS)
        out[f"{name}/cfg"] = np.array(cfg_json(cfg))
        out[f"{name}/x"] = xs
        out[f"{name}/chunk"] = np.array(-1 if chunk is None else chunk)
        out[f"{name}/q_fleet"] = np.array(-1 if qf is None else qf)
        if masks is not None:
            out[f"{name}/masks"] = masks
        out.update(flatten(states, f"{name}/init"))
        fin, met, fleet = hierarchical_stream_run(
            cfg, mesh, states, jnp.asarray(xs),
            None if masks is None else jnp.asarray(masks), q_fleet=qf,
            chunk=chunk)
        out.update(flatten(fin, f"{name}/final"))
        out.update(flatten(met, f"{name}/m"))
        out.update(flatten(fleet, f"{name}/fleet"))
    data_mesh = jax.make_mesh((2, 1), ("data", "model"))
    for si, (name, chunk) in enumerate(SHARD_SCENARIOS.items()):
        cfg = stream_cfg(P_REGION, "cm")
        xs = region_data(rng, H_REGIONS, H_ROUNDS, H_N, P_REGION)
        states = hierarchical_stream_init(cfg, jax.random.PRNGKey(70 + si),
                                          H_REGIONS)
        out[f"{name}/cfg"] = np.array(cfg_json(cfg))
        out[f"{name}/x"] = xs
        out[f"{name}/chunk"] = np.array(-1 if chunk is None else chunk)
        out.update(flatten(states, f"{name}/init"))
        fin, met = sharded_stream_run(cfg, data_mesh, states,
                                      jnp.asarray(xs), chunk=chunk)
        out.update(flatten(fin, f"{name}/final"))
        out.update(flatten(met, f"{name}/m"))


def _example(name):
    """The reference example module ``examples/<name>.py``."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fleet_init(cfg, key, n):
    return jax.vmap(lambda k: stream_init(cfg, k))(jax.random.split(key, n))


def example_streaming_pca(out):
    """examples/streaming_pca.py's fleet: its draws and its results."""
    mod = _example("streaming_pca")
    cfg = StreamConfig(p=mod.P, q=mod.Q, halfwidth=4, forgetting=0.9,
                       drift_threshold=0.1, refresh_iters=8,
                       warmup_rounds=8, n_max=8, c_max=4)
    xs = mod.fleet_streams(jax.random.PRNGKey(0))
    states = _fleet_init(cfg, jax.random.PRNGKey(1), mod.N_NETWORKS)
    out["x"], out["W0"] = np.asarray(xs), np.asarray(states.sched.W)
    fin, met = batched_stream_run(cfg, states, xs)
    out.update(flatten(met, "m"))
    out.update(flatten(fin.sched, "final.sched"))


def example_faulty_fleet(out):
    """examples/faulty_fleet.py: both fleet runs and the engine coda, with
    the engine's initial bases."""
    from repro.serve.engine import StreamingPCAEngine, StreamRequest
    mod = _example("faulty_fleet")
    base = dict(p=mod.P, q=mod.Q, halfwidth=4, forgetting=0.95,
                drift_threshold=0.08, refresh_iters=8, warmup_rounds=8,
                n_max=8, c_max=4)
    cfg_c = StreamConfig(**base)
    cfg_f = StreamConfig(**base, link_loss=mod.LINK_LOSS, max_retries=3)
    xs = mod.fleet_streams(jax.random.PRNGKey(0))
    masks = mod.fleet_liveness(seed=1)
    key = jax.random.PRNGKey(1)
    st_c = _fleet_init(cfg_c, key, mod.N_NETWORKS)
    out["x"], out["W0"], out["masks"] = (np.asarray(xs),
                                         np.asarray(st_c.sched.W), masks)
    for tag, cfg, st, m in (("clean", cfg_c, st_c, None),
                            ("fault", cfg_f,
                             _fleet_init(cfg_f, key, mod.N_NETWORKS),
                             jnp.asarray(masks))):
        fin, met = batched_stream_run(cfg, st, xs, m)
        out.update(flatten(met, f"{tag}/m"))
        out.update(flatten(fin.sched, f"{tag}/final.sched"))
    eng = StreamingPCAEngine(cfg_f, slots=2, seed=0)
    out["engine/W0"] = np.asarray(eng.states.sched.W)
    rng = np.random.default_rng(2)
    live = np.ones((40, mod.P), np.float32)
    live[12:26, :] = 0.0
    reqs = [StreamRequest(rounds=rng.normal(size=(40, mod.N_PER_ROUND,
                                                   mod.P)).astype(np.float32),
                          liveness=live if i == 0 else None)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    out["engine/plans"] = np.array([(pl.data, pl.model)
                                    for pl in eng.plan_history])
    out["engine/dead_rounds"] = np.array([r.rounds
                                          for r in reqs[0].retirements])
    out["engine/dead_reasons"] = np.array([r.reason
                                           for r in reqs[0].retirements])
    for i, r in enumerate(reqs):
        out[f"engine/r{i}/rounds"] = np.array(r.result.rounds)
        out[f"engine/r{i}/reason"] = np.array(r.result.reason)
        out[f"engine/r{i}/refreshes"] = np.array(r.result.refreshes)
        out[f"engine/r{i}/comm_packets"] = np.array(r.result.comm_packets)
        out[f"engine/r{i}/retained"] = np.array(r.result.retained)


def example_compression_fleet(out):
    """examples/compression_fleet.py: both sweeps, per reading."""
    mod = _example("compression_fleet")
    xs = mod.fleet_streams(jax.random.PRNGKey(0))
    out["x"] = np.asarray(xs)
    runs = [(f"eps{e}", CompressionConfig(epsilon=e)) for e in mod.EPSILONS]
    runs += [(f"bits{b}", CompressionConfig(epsilon=mod.EPS_FOR_BITS,
                                            score_bits=b))
             for b in mod.BIT_WIDTHS]
    for tag, comp in runs:
        cfg = StreamConfig(p=mod.P, q=mod.Q, halfwidth=4, forgetting=0.95,
                           drift_threshold=0.08, warmup_rounds=5,
                           compression=comp)
        st = _fleet_init(cfg, jax.random.PRNGKey(1), mod.N_NETWORKS)
        out["W0"] = np.asarray(st.sched.W)
        fin, met = batched_stream_run(cfg, st, xs)
        out.update(flatten(met, f"{tag}/m"))
        out.update(flatten(fin.sched, f"{tag}/final.sched"))


def example_event_fleet(out):
    """examples/event_fleet.py: its numpy draws, its initial bases and its
    detector's results."""
    from repro.core.topology import berkeley_like_layout
    mod = _example("event_fleet")
    cfg = StreamConfig(p=mod.P, q=mod.Q, halfwidth=4, forgetting=0.98,
                       drift_threshold=0.5, warmup_rounds=mod.WARMUP,
                       detection=DetectionConfig(
                           alpha=mod.ALPHA, calib_rounds=mod.CALIB_ROUNDS))
    positions = berkeley_like_layout(p=mod.P, seed=7)
    xs, truth = mod.inject_events(mod.fleet_streams(), positions)
    st = _fleet_init(cfg, jax.random.PRNGKey(2), mod.N_NETWORKS)
    out["x"], out["truth"], out["W0"] = xs, truth, np.asarray(st.sched.W)
    fin, met = batched_stream_run(cfg, st, jnp.asarray(xs))
    out.update(flatten(met, "m"))
    out.update(flatten(fin.det, "final.det"))
    out.update(flatten(fin.sched, "final.sched"))


# name: (config, slots, cache length, prompt lengths); the last dense
# prompt runs into the cache's end (decoding stops at max_len - 1)
LM_SCENARIOS = {
    "dense": ("llama3.2-1b", 3, 32, (2, 3, 5, 7, 9, 12, 17, 27)),
    "moe": ("granite-moe-3b-a800m", 3, 32, (3, 4, 6, 9, 11, 5, 14)),
    # a one-token prompt: the conv history is padded with zeros
    "ssm": ("mamba2-2.7b", 3, 32, (1, 4, 6, 11, 19, 2, 27, 8)),
    # 8 meta tokens ahead of every prompt; layer 1's window of 16 cuts
    # the longer ones
    "hybrid": ("hymba-1.5b", 3, 32, (2, 5, 9, 14, 21, 3, 26, 12)),
    # the q/k/v biases
    "qkv_bias": ("qwen2-7b", 3, 32, (4, 2, 7, 13, 9, 19, 5, 24)),
    # the per-head RMS norm of q and k
    "qk_norm": ("chameleon-34b", 3, 32, (6, 3, 11, 2, 17, 8, 25, 10)),
    # top-6 routing over 8 experts (.smoke() caps them at top-2 of 4)
    "top6": ("moonshot-v1-16b-a3b", 3, 32, (3, 9, 5, 12, 7, 16, 4),
             {"n_experts": 8, "top_k": 6}),
}


def lm_engine(out):
    from repro import configs
    from repro.models import transformer as T
    from repro.serve.engine import Engine, Request, ServeConfig
    for name, (arch, slots, max_len, lengths, *extra) in \
            LM_SCENARIOS.items():
        replace = extra[0] if extra else {}
        cfg = dataclasses.replace(configs.get(arch).smoke(), **replace)
        params = T.init_params(cfg, jax.random.PRNGKey(0))
        out[f"{name}/arch"] = np.asarray(arch)
        out[f"{name}/replace"] = np.asarray(json.dumps(replace))
        out[f"{name}/slots"] = np.asarray(slots)
        out[f"{name}/max_len"] = np.asarray(max_len)
        out.update(_flat_tree(params, f"{name}/params"))
        rng = np.random.default_rng(11)
        eng = Engine(cfg, params, ServeConfig(slots=slots, max_len=max_len))
        reqs = []
        for i, s_len in enumerate(lengths):
            req = Request(
                prompt=rng.integers(0, cfg.vocab_size, s_len).astype(np.int32),
                max_new_tokens=int(rng.integers(2, 9)),
                eos_id=int(rng.integers(0, cfg.vocab_size)) if i % 3 == 1
                else -1)
            reqs.append(req)
            eng.submit(req)
        eng.run_until_done()
        for i, req in enumerate(reqs):
            assert req.done
            out[f"{name}/req{i}/prompt"] = req.prompt
            out[f"{name}/req{i}/max_new"] = np.asarray(req.max_new_tokens)
            out[f"{name}/req{i}/eos"] = np.asarray(req.eos_id)
            out[f"{name}/req{i}/output"] = np.asarray(req.output, np.int32)


# the pipeline scenarios: (stages, microbatches) over a batch of
# PIPE_BATCH rows, for each layer function (``tanh``: tanh(h @ W_s) at
# width PIPE_WIDTH; ``dense``: llama3.2-1b's smoke layer, one a stage, over
# PIPE_SEQ positions)
PIPE_STAGES = (1, 2, 4)
PIPE_MICRO = (1, 3, 4, 8)
PIPE_BATCH, PIPE_WIDTH, PIPE_SEQ = 24, 8, 8


def pipeline(out):
    """``repro.distributed.pipeline.pipeline_apply`` under shard_map on S
    of the 4 forced host devices: the last stage's output and, under
    ``jax.set_mesh``, ``jax.grad`` of sum(output x cot) for the stacked
    stage parameters and x (``pipe/{fn}/{S}/{M}/out``, ``/gx``,
    ``/gp`` or ``/gp.{path}``), with the inputs (``pipe/{fn}/x``,
    ``/cot``, ``/p`` or ``/p.{path}``: four stages' parameters, stage s
    the s-th slice)."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as PS
    from repro import configs
    from repro.distributed.pipeline import pipeline_apply
    from repro.models import transformer as T
    rng = np.random.default_rng(29)
    cfg = dataclasses.replace(configs.get("llama3.2-1b").smoke(), n_layers=4)
    positions = jnp.arange(PIPE_SEQ)

    def dense_layer(p, h):
        for i in range(p["ln1"].shape[0]):
            h, _ = T._layer_fwd(cfg, h, jax.tree.map(lambda a: a[i], p),
                                positions, 0)
        return h

    cases = {
        "tanh": (lambda p, h: jnp.tanh(h @ p[0]),
                 jnp.asarray(rng.normal(size=(4, PIPE_WIDTH, PIPE_WIDTH))
                             .astype(np.float32) / np.sqrt(PIPE_WIDTH)),
                 (PIPE_BATCH, PIPE_WIDTH)),
        "dense": (dense_layer,
                  T.init_params(cfg, jax.random.PRNGKey(0))["layers"],
                  (PIPE_BATCH, PIPE_SEQ, cfg.d_model)),
    }
    for fn_name, (layer_fn, params, shape) in cases.items():
        x = jnp.asarray(rng.normal(size=shape).astype(np.float32))
        cot = jnp.asarray(rng.normal(size=shape).astype(np.float32))
        out[f"pipe/{fn_name}/x"] = np.asarray(x)
        out[f"pipe/{fn_name}/cot"] = np.asarray(cot)
        out.update(_flat_tree(params, f"pipe/{fn_name}/p"))
        for S in PIPE_STAGES:
            mesh = jax.make_mesh((S,), ("pipe",), devices=jax.devices()[:S])
            sp = jax.tree.map(lambda a: a[:S], params)
            for M in PIPE_MICRO:
                def run(p, h, M=M):
                    # zeros but on the last stage: the sum is its output
                    return jax.lax.psum(pipeline_apply(
                        layer_fn, p, h, n_microbatches=M, axis_name="pipe"),
                        "pipe")

                fm = shard_map(run, mesh=mesh,
                               in_specs=(PS("pipe"), PS()),
                               out_specs=PS(), check_rep=False)

                def loss(p, h, fm=fm):
                    y = fm(p, h)
                    return jnp.sum(y * cot), y

                with jax.set_mesh(mesh):
                    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
                        loss, argnums=(0, 1), has_aux=True))(sp, x)
                key = f"pipe/{fn_name}/{S}/{M}"
                out[f"{key}/out"] = np.asarray(y)
                out[f"{key}/gx"] = np.asarray(gx)
                out.update(_flat_tree(gp, f"{key}/gp"))


if __name__ == "__main__":
    mode, path = sys.argv[1], sys.argv[2]
    results: dict = {}
    {"streaming": run_streaming, "rounds": run_rounds,
     "engine": run_engine, "hierarchy": run_hierarchy,
     "streaming_pca": example_streaming_pca,
     "faulty_fleet": example_faulty_fleet,
     "compression_fleet": example_compression_fleet,
     "event_fleet": example_event_fleet,
     "lm_engine": lm_engine, "pipeline": pipeline}[mode](results)
    np.savez(path, **results)
