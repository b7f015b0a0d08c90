"""One rank of the port's distributed drivers, for tests/test_torch_hierarchy.py
and tests/test_torch_core_dist.py.

    python tests/torch_dist_child.py RANK WORLD STORE_DIR IN.npz OUT.npz

Joins a gloo process group of WORLD ranks through a ``file://`` store in
STORE_DIR (with a timeout, so a lost peer fails the run instead of
hanging it), then runs every scenario of IN.npz (the reference's inputs
and initial states, written by tests/torch_ref_child.py): each two-level
scenario (``h_*``) through ``hierarchical_stream_run`` over the mesh's
``region`` group, each sharded one (``s_*``) through
``sharded_stream_run`` over a (1, WORLD) mesh's ``data`` group.  Writes
this rank's final states and metrics, the merge and the collectives each
run issued to OUT.npz.  When IN.npz holds ``core/`` inputs (written by
tests/test_torch_core_dist.py) it first runs the D/A/F collectives, the
halo exchange and the sharded production steps and power iterations of
``repro_torch.core`` on them (:func:`core_scenarios`); when it holds
``train/`` inputs (written by tests/test_torch_train.py) it runs two rounds
of PowerSGD (``compress_gradients`` with ``all_reduce_mean`` as
``reduce_fn``) on this rank's gradients (:func:`train_scenarios`); when
it holds ``lm/`` inputs (tests/test_torch_lm_mesh.py) it runs the LM
families at their smoke widths with DTensor parameters on a (2, 2)
(data, model) mesh (:func:`lm_mesh_scenarios`), and with ``moe/`` inputs
the expert-parallel ``moe_apply`` on each case's mesh
(:func:`moe_ep_scenarios`); with ``pipe/`` inputs
(tests/test_torch_pipeline.py) ``pipeline_apply`` on groups of 1, 2 and
4 stages with its gradients (:func:`pipe_scenarios`).
Imports no JAX.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import aggregation as agg
from repro_torch.core import power_iteration as pim
from repro_torch.core import production as prod
from repro_torch.distributed import compression as GC
from repro_torch.launch.mesh import init_fleet_process_group, make_fleet_mesh
from repro_torch.models.params import tree_leaves, unflatten
from repro_torch.streaming import (hierarchical_stream_run,
                                   sharded_stream_run)
from repro_torch.streaming.hierarchy import COLLECTIVES, reset_collectives

from torch_parity import config_from_json


def scenario(data, name):
    cfg = config_from_json(data[f"{name}/cfg"])
    states = state_from_numpy(data, device="cpu", prefix=f"{name}/init.")
    xs = torch.from_numpy(data[f"{name}/x"])
    chunk = int(data[f"{name}/chunk"])
    return cfg, states, xs, None if chunk < 0 else chunk


def core_scenarios(data, rank, world):
    """``repro_torch.core``'s collectives and sharded steps on this
    rank's slice of the ``core/`` inputs, in the default group; each
    output beside the collectives it issued (``*/collectives``: all_reduce,
    broadcast, all_gather, halo_exchange)."""
    out = {}

    def counted(name, fn):
        agg.reset_collectives()
        res = fn()
        out[f"core/{name}/collectives"] = np.array(
            [agg.COLLECTIVES[k] for k in ("all_reduce", "broadcast",
                                          "all_gather", "halo_exchange")])
        for i, r in enumerate(res if isinstance(res, tuple) else (res,)):
            out[f"core/{name}/{i}"] = r.numpy()

    get = lambda k: torch.from_numpy(data[f"core/{k}"])
    mine = get("records")[rank]                   # (3, halo + 2) a rank
    halo = int(data["core/halo"])
    counted("a_op", lambda: agg.a_op(mine))
    for root in range(world):
        counted(f"f_op{root}", lambda: agg.f_op(mine, root=root))
    counted("d_op", lambda: agg.d_op(mine))
    counted("d_op_tiled", lambda: agg.d_op(mine, tiled=True))
    for wrap in (False, True):
        counted(f"halo_wrap{int(wrap)}",
                lambda: agg.halo_exchange(mine, halo, wrap=wrap))

    band, v, W, V = get("band"), get("v"), get("w_prev"), get("V")
    v0, V0 = get("v0"), get("V0")
    local = band.shape[1] // world
    rows = slice(rank * local, (rank + 1) * local)
    bp = prod.shard_band(band, rank, world)
    for k in range(W.shape[1] + 1):
        counted(f"deflated{k}", lambda: prod.sharded_pim_deflated_step(
            bp, v[rows], W[rows, :k]))
    counted("block", lambda: prod.sharded_pim_block_step(bp, V[rows]))
    counted("power", lambda: tuple(pim.deflated_power_iteration(
        lambda u: prod.halo_matvec(bp, u), local, v0.shape[0],
        v0=v0[:, rows], aggregate=agg.a_op, device="cpu")))

    def ortho():
        res = pim.orthogonal_iteration(
            lambda U: prod.halo_matmul(bp, U), local, V0.shape[1],
            v0=V0[rows], aggregate=agg.a_op, device="cpu")
        return res.W, res.eigenvalues, torch.tensor(res.iterations)

    counted("ortho", ortho)
    return out


def train_scenarios(data, rank, world):
    """Two PowerSGD rounds over the default group from the given Q
    factors: each round's reduced gradients, Q factors and this rank's
    error buffers (``train/{round}/{g,q,e}/{path}``)."""
    shapes = json.loads(str(data["train/paths"]))
    params = unflatten({k: torch.zeros(v) for k, v in shapes.items()})
    q = {k[len("train/q/"):]: data[k] for k in data
         if k.startswith("train/q/")}
    state = GC.init_compressor(params, 4, q=q)
    out = {}
    for rnd in range(2):
        g = unflatten({k: torch.from_numpy(data[f"train/g{rnd}/{rank}/{k}"])
                       for k in shapes})
        g, state = GC.compress_gradients(g, state, GC.all_reduce_mean())
        for name, tree in (("g", g), ("q", state.q), ("e", state.error)):
            out.update({f"train/{rnd}/{name}/{k}": v.numpy()
                        for k, v in tree_leaves(tree) if v is not None})
    return out


def _lm_cfg(name):
    import dataclasses
    from repro_torch import configs
    base, _, variant = name.partition(":")
    cfg = configs.get(base).smoke()
    if cfg.n_experts:
        # ample capacity: the expert-parallel branch's capacity per data
        # shard then drops no more than the single device's
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    if variant == "mqa":
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    return cfg


def lm_inputs(name, B=4, S=16, steps=3):
    """The parameters and token streams of an ``lm/`` scenario (seeded, so
    the test process makes the same ones)."""
    from repro_torch.models import transformer as T
    cfg = _lm_cfg(name)
    params = T.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    nxt = torch.randint(0, cfg.vocab_size, (steps, B, 1), generator=g)
    return cfg, params, tokens, nxt


def lm_run(cfg, params, tokens, nxt, mesh=None):
    """forward, prefill + decode steps, and lm_loss with its gradients of
    one scenario; under a mesh on DTensors (results gathered whole)."""
    import contextlib
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed.sharding import (act_rules,
                                                  activation_sharding,
                                                  param_rules)
    from repro_torch.launch.dryrun import distribute_state
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.models import transformer as T
    from repro_torch.models.params import distribute_params, param_pspecs
    from repro_torch.train.trainer import TrainConfig, _value_and_grad
    B, S = tokens.shape
    state = T.init_decode_state(cfg, B, S + nxt.shape[0], torch.float32,
                                device="cpu")
    ctx = contextlib.ExitStack()
    whole = lambda t: t
    if mesh is not None:
        specs = param_pspecs(T.model_schema(cfg), param_rules(False),
                             mesh_axis_sizes(mesh))
        params = distribute_params(params, specs, mesh)
        bpl = [Shard(0), Replicate()]
        tokens = distribute_tensor(tokens, mesh, bpl, src_data_rank=None)
        nxt = [distribute_tensor(t, mesh, bpl, src_data_rank=None)
               for t in nxt]
        state = distribute_state(state, mesh)
        ctx.enter_context(activation_sharding(mesh, act_rules(False)))
        ctx.enter_context(implicit_replication())
        whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") \
            else t
    out = {}
    with ctx:
        logits, aux = T.forward(params, cfg, tokens, remat=False)
        out["forward"] = whole(logits)
        lg, state = T.prefill(params, cfg, tokens, state)
        out["prefill"] = whole(lg)
        for i, tok in enumerate(nxt):
            lg, state = T.decode_step(params, cfg, tok, state, S + i)
            out[f"decode{i}"] = whole(lg)
        loss, _, grads = _value_and_grad(cfg, TrainConfig(), params,
                                         {"tokens": tokens})
        out["loss"] = whole(loss)
        for path, g in tree_leaves(grads):
            out[f"grad/{path}"] = whole(g)
    return {k: v.detach().numpy() for k, v in out.items()}


def lm_mesh_scenarios(data, rank, world):
    """Each ``lm/`` scenario on a (2, 2) (data, model) mesh of the default
    group's four ranks: DTensor parameters from ``param_pspecs``, the
    decode state placed as the dry run places it."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for name in json.loads(str(data["lm/archs"])):
        res = lm_run(*lm_inputs(name), mesh=mesh)
        out.update({f"lm/{name}/{k}": v for k, v in res.items()})
    return out


def moe_ep_scenarios(data, rank, world):
    """The expert-parallel ``moe_apply`` on each ``moe/`` case's mesh over
    the default group: (E, mesh shape) with the reference's parameters
    and input."""
    import dataclasses
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.distributed.sharding import (act_rules,
                                                  activation_sharding,
                                                  param_rules)
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import distribute_params, param_pspecs
    out = {}
    for case in json.loads(str(data["moe/cases"])):
        E, shape = case["E"], tuple(case["mesh"])
        key = f"moe/{E}_{shape[0]}x{shape[1]}"
        cfg = dataclasses.replace(
            configs.get("granite-moe-3b-a800m").smoke(), n_experts=E,
            top_k=2, capacity_factor=8.0)
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        p = {k: torch.from_numpy(data[f"{key}/p/{k}"])
             for k in ("router", "w_gate", "w_up", "w_down")}
        specs = param_pspecs(MOE.moe_schema(cfg), param_rules(False),
                             mesh_axis_sizes(mesh))
        pd = distribute_params(p, specs, mesh)
        x = distribute_tensor(torch.from_numpy(data[f"{key}/x"]), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        with activation_sharding(mesh, act_rules(False)), \
                implicit_replication():
            y, _ = MOE.moe_apply(pd, cfg, x)
        out[f"{key}/y"] = y.full_tensor().numpy()
    return out


def _pipe_layer(fn_name):
    """The layer function of a ``pipe/`` case: ``tanh`` is tanh(h @ W_s);
    ``dense`` runs the stage's stacked llama3.2-1b smoke layers through
    the transformer's own layer function."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_map
    if fn_name == "tanh":
        return lambda p, h: torch.tanh(h @ p[0])
    cfg = dataclasses.replace(configs.get("llama3.2-1b").smoke(), n_layers=4)

    def dense(p, h):
        pos = torch.arange(h.shape[1])
        for i in range(p["ln1"].shape[0]):
            h, _ = T._layer_fwd(cfg, h, tree_map(lambda a: a[i], p), pos, 0)
        return h
    return dense


def pipe_scenarios(data, rank, world):
    """``pipeline_apply`` on groups of 1, 2 and 4 stages of the default
    group's four ranks (every rank alone; {0, 1} and {2, 3}; all four):
    this rank holds stage s = its index in the group, the s-th slice of
    the stacked parameters, and backpropagates sum(output x cot).  Writes
    the output, the gradient of its stage's parameters and of x
    (``pipe/{fn}/{S}/{M}/{out,gx,gp[.path]}``)."""
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.models.params import tree_map
    groups = {}
    for S in json.loads(str(data["pipe/stages"])):
        for first in range(0, world, S):
            g = dist.new_group(list(range(first, first + S)))
            if first <= rank < first + S:
                groups[S] = (g, rank - first)
    out = {}
    for fn_name in json.loads(str(data["pipe/fns"])):
        pre = f"pipe/{fn_name}/p"
        flat = {k[len(pre) + 1:]: torch.from_numpy(data[k]) for k in data
                if k.startswith(pre + ".")}
        params = unflatten(flat) if flat else torch.from_numpy(data[pre])
        x0 = torch.from_numpy(data[f"pipe/{fn_name}/x"])
        cot = torch.from_numpy(data[f"pipe/{fn_name}/cot"])
        layer = _pipe_layer(fn_name)
        for S, (group, stage) in groups.items():
            mine = tree_map(lambda a: a[stage:stage + 1].clone()
                            .requires_grad_(True), params)
            for M in json.loads(str(data["pipe/micro"])):
                x = x0.clone().requires_grad_(True)
                y = pipeline_apply(layer, mine, x, n_microbatches=M,
                                   group=group)
                gp = torch.autograd.grad(
                    (y * cot).sum(), [x] + [a for _, a in tree_leaves(mine)])
                key = f"pipe/{fn_name}/{S}/{M}"
                out[f"{key}/out"] = y.detach().numpy()
                out[f"{key}/gx"] = gp[0].numpy()
                for (path, _), g in zip(tree_leaves(mine), gp[1:]):
                    out[f"{key}/gp" + (f".{path}" if path else "")] = \
                        g.numpy()
    return out


def main(rank, world, store_dir, path_in, path_out):
    data = dict(np.load(path_in))
    names = sorted({k.split("/")[0] for k in data
                    if k.startswith(("h_", "s_"))})
    out = {}
    init_fleet_process_group(rank, world, store_dir, device="cpu",
                             timeout_s=60.0)
    try:
        if any(k.startswith("core/") for k in data):
            out.update(core_scenarios(data, rank, world))
        if "train/paths" in data:
            out.update(train_scenarios(data, rank, world))
        if "lm/archs" in data:
            out.update(lm_mesh_scenarios(data, rank, world))
        if "moe/cases" in data:
            out.update(moe_ep_scenarios(data, rank, world))
        if "pipe/fns" in data:
            out.update(pipe_scenarios(data, rank, world))
        regions = make_fleet_mesh()                    # (WORLD, 1)
        networks = make_fleet_mesh(region=1, data=world)
        for name in names:
            cfg, states, xs, chunk = scenario(data, name)
            reset_collectives()
            if name.startswith("h_"):
                masks = (torch.from_numpy(data[f"{name}/masks"])
                         if f"{name}/masks" in data else None)
                qf = int(data[f"{name}/q_fleet"])
                fin, m, fleet = hierarchical_stream_run(
                    cfg, regions.region, states, xs, masks,
                    q_fleet=None if qf < 0 else qf, chunk=chunk)
                out.update(state_to_numpy(fleet, f"{name}/fleet."))
            else:
                fin, m = sharded_stream_run(cfg, networks.data, states, xs,
                                            chunk=chunk)
            out.update(state_to_numpy(fin, f"{name}/final."))
            out.update(state_to_numpy(m, f"{name}/m."))
            out[f"{name}/collectives"] = np.array(
                [COLLECTIVES["all_gather"], COLLECTIVES["all_reduce"]])
    finally:
        dist.destroy_process_group()
    np.savez(path_out, **out)


if __name__ == "__main__":
    r, w, store, src, dst = sys.argv[1:6]
    main(int(r), int(w), store, src, dst)
