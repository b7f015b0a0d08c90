"""Multi-pod dry run: every (architecture x shape x mesh) cell, executed on
fake tensors over a fake process group (counterpart of
``repro.launch.dryrun``).

The reference lowers and compiles each cell's jitted step against
``ShapeDtypeStruct`` inputs on 256 or 512 forced host devices.  The port
has no compiler to ask, so it runs the step itself, op by op, with nothing
allocated:

* a fake process group (``torch.testing._internal.distributed.fake_pg``)
  of 256 ranks ("16x16", ``("data", "model")``) or 512 ("2x16x16",
  ``("pod", "data", "model")``), of which this process is rank 17 (mesh
  coordinate data 1, model 1: a rank inside the ring, with both halo
  neighbours), and a CPU ``DeviceMesh`` over it;
* every parameter, optimizer moment, cache and input a fake DTensor under
  ``FakeTensorMode``, placed by the reference's rules: parameters by
  ``param_pspecs(param_rules(...))``, caches and inputs by the
  reference's ``_decode_state_sds`` / ``_sds`` axes, with the same
  divisibility fallback;
* the step the port's own: ``make_train_step``, ``prefill`` or
  ``decode_step`` inside ``activation_sharding(mesh, act_rules(...))``
  (where ``moe_apply`` takes its expert-parallel branch), or a WSN step's
  sharded form over the world group (``core.production``).  Donated
  inputs are updated in place, and a training cell runs every one of
  its microbatches (``pick_microbatches``), so no count is scaled.

A :class:`Meter` (a dispatch mode under DTensor, so it sees each rank's
local ops) counts what one device does: FLOPs by ``torch.utils.
flop_counter``'s formulas, bytes accessed (each op's tensor inputs and
outputs), the live bytes of local storages over the step (the peak per
device), and every collective issued, with its bytes and group size.  A
kernel wrapper handed fake tensors launches nothing and records the call
(``kernels.ops.PLANNED``), which is priced by
``analysis.resources.call_work``.  Cell failures are data, as in the
reference: the record carries ``error`` and a traceback.

``--smoke`` runs the wsn-1m cells at ``WSN.smoke()`` for real, on a mesh
over the local devices (one NCCL rank on the card, one gloo rank with
``--device cpu``), and holds each result against the unsharded step run
on CPU copies of the operands, where each kernel takes its plain version:
within ``SMOKE_RTOL`` (1e-6) of its largest magnitude (``max_rel_err``,
``max_abs_err``), and the record says whether it is bit for bit
(``bitwise``).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k \\
        --mesh pod --out results.jsonl
    python -m repro_torch.launch.dryrun --list          # enumerate all cells
    python -m repro_torch.launch.dryrun --smoke --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import signal
import tempfile
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs import SHAPES, applicable_shapes
from repro_torch.configs.wsn_1m import CONFIG as WSN
from repro_torch.distributed.sharding import (act_rules, activation_sharding,
                                              from_local, param_rules,
                                              shard_window, spec_entries,
                                              to_placements)
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                     mesh_axis_sizes)

__all__ = ["WSN_SHAPES", "all_cells", "skipped_cells", "pick_microbatches",
           "build_lm_cell", "build_wsn_cell", "run_cell", "Meter", "measure",
           "fake_world", "plan_train_step", "distribute_state", "main"]

WSN_SHAPES = ["cov_update", "pim_block", "pim_deflated", "transform",
              "hier_merge"]

# ---------------------------------------------------------------------------
# The meter
# ---------------------------------------------------------------------------
_FUNCOL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
           "all_gather_into_tensor": "all-gather",
           "reduce_scatter_tensor": "reduce-scatter",
           "all_to_all_single": "all-to-all"}
_C10D = {"allreduce_": "all-reduce", "allgather_": "all-gather",
         "_allgather_base_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "send": "collective-permute"}
_NO_TRAFFIC = {"empty", "empty_like", "new_empty", "empty_strided",
               "new_empty_strided", "detach", "lift_fresh", "alias",
               "_to_copy_meta", "wait_tensor", "recv_"}


# matrix-vector and dot products, which torch.utils.flop_counter leaves
# out: 2 FLOPs a multiply-add
_VECTOR_FLOPS = {"mv": lambda a, b, *_: 2 * a.shape[0] * a.shape[1],
                 "addmv": lambda c, a, b, *_: 2 * a.shape[0] * a.shape[1],
                 "dot": lambda a, b, *_: 2 * a.shape[0],
                 "vdot": lambda a, b, *_: 2 * a.shape[0]}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(arg) -> int:
    """The size of a collective's group: a functional collective names it,
    a ``c10d`` op passes the (boxed) group."""
    if isinstance(arg, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(arg).size()
    if isinstance(arg, torch.ScriptObject):
        arg = dist.ProcessGroup.unbox(arg)
    return int(arg.size())


def _site() -> str:
    """The innermost frame of the port's own code that asked for a
    collective: outside the launch package and the sharding helpers, and
    not an autograd Function's ``forward``/``backward``."""
    import traceback as tb
    for fr in reversed(tb.extract_stack()):
        f = fr.filename.replace("\\", "/")
        if ("/repro_torch/" in f and "/repro_torch/launch/" not in f
                and not f.endswith("distributed/sharding.py")
                and fr.name not in ("forward", "backward")):
            return f"{f.split('/repro_torch/', 1)[1]}:{fr.lineno} {fr.name}"
    return "?"


class Meter(TorchDispatchMode):
    """What one device does in a run: FLOPs, bytes accessed, the live
    bytes of its storages (and their peak) and the collectives issued.

    A DTensor op is handed on (``NotImplemented``) so that DTensor turns it
    into local ops on the shards, which come back here: every count is a
    device's.  Ops that DTensor's sharding propagation runs under a fake
    mode of its own are skipped.  ``track(tree)`` makes the storages of
    tensors that exist before the run (the arguments) count as live."""

    def __init__(self, sites: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.sites = sites
        self.flops = 0.0
        self.bytes = 0.0
        self.issues: list[tuple[str, float, int]] = []
        self.issue_sites: list[str] = []
        self.live = 0
        self.peak = 0
        self._tracked: set[int] = set()
        self._fake = None

    def track(self, tree) -> int:
        """Count the storages under ``tree`` (tensors, DTensors' local
        shards, nested tuples, lists, dicts) as live; returns their
        bytes."""
        from torch.distributed.tensor import DTensor
        before = self.live
        for t in _tensors(_flatten(tree)):
            if isinstance(t, DTensor):
                t = t.to_local()
            self._track_storage(t)
        self.peak = max(self.peak, self.live)
        return self.live - before

    def _track_storage(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._tracked:
            return
        n = st.nbytes()
        self._tracked.add(key)
        self.live += n

        def free(key=key, n=n):
            self._tracked.discard(key)
            self.live -= n

        weakref.finalize(st, free)

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake or _in_propagation():
            return out                      # DTensor's sharding propagation
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in ("_c10d_functional", "c10d"):
            self._collective(ns, name, args, out)
            return out
        fn = self._flops.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        elif name in _VECTOR_FLOPS:
            self.flops += _VECTOR_FLOPS[name](*args)
        if not func.is_view and name not in _NO_TRAFFIC:
            seen = {}
            for t in list(_tensors(args)) + list(_tensors(kwargs)) \
                    + list(_tensors(out)):
                seen[id(t)] = _nbytes(t)
            self.bytes += sum(seen.values())
        for t in _tensors(out):
            self._track_storage(t)
        self.peak = max(self.peak, self.live)
        return out

    def _collective(self, ns, name, args, out):
        if ns == "_c10d_functional":
            kind = _FUNCOL.get(name)
            if kind is None:
                return
            x = args[0]
            g = _group_size(args[-1])
            nbytes = _nbytes(x) * (g if kind == "all-gather" else 1)
            for t in _tensors(out):
                self._track_storage(t)
            self.peak = max(self.peak, self.live)
        else:
            kind = _C10D.get(name)
            if kind is None:
                return
            # the full size: the first argument (the tensors sent, an
            # all-gather's results), a reduce-scatter's second (its inputs)
            full = args[1] if kind == "reduce-scatter" else args[0]
            nbytes = sum(_nbytes(t) for t in _tensors(full))
            g = _group_size(next(a for a in args
                                 if isinstance(a, torch.ScriptObject)))
        self.issues.append((kind, float(nbytes), g))
        if self.sites:
            self.issue_sites.append(_site())

    def stats(self) -> C.CollectiveStats:
        return C.CollectiveStats.from_issues(self.issues)


_PROPAGATION = frozenset({"_propagate_tensor_meta_non_cached",
                          "_propagate_tensor_meta"})


def _in_propagation() -> bool:
    """Whether DTensor is running an op on global-shaped fake tensors to
    learn its output's metadata (under the active fake mode, which it
    reuses): nothing a device executes."""
    import sys
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name in _PROPAGATION:
            return True
        f = f.f_back
    return False


def _flatten(tree):
    """Tensors of a tree of dicts, tuples (NamedTuples too) and lists."""
    if isinstance(tree, dict):
        return [_flatten(v) for v in tree.values()]
    if isinstance(tree, (list, tuple)):
        return [_flatten(v) for v in tree]
    return tree


def _planned_work() -> tuple[float, float]:
    """FLOPs and bytes of the kernel calls planned on fake tensors."""
    from repro_torch.analysis.op_lint import KernelCall
    from repro_torch.analysis.resources import call_work, kernel_work
    from repro_torch.kernels import ops
    flops = nbytes = 0.0
    for kernel, operands, params, outputs in ops.PLANNED:
        d, model, _ = call_work(KernelCall(kernel, operands, params, outputs))
        flops += kernel_work(kernel, **d)[0]
        nbytes += model
    return flops, nbytes


# ---------------------------------------------------------------------------
# Fake process groups and fake DTensors
# ---------------------------------------------------------------------------
FAKE_RANK = 17   # mesh coordinate (data 1, model 1): an interior rank


@contextlib.contextmanager
def fake_world(n: int, rank: int = FAKE_RANK):
    """A fake default process group of ``n`` ranks, this process rank
    ``rank`` (by default an interior one: both its halo neighbours exist),
    destroyed on exit.  Its collectives move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=min(rank, n - 1),
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_shape(shape, mesh, placements) -> tuple[int, ...]:
    return shard_window(shape, mesh, placements)[0]


def _dtensor(shape, dtype, mesh, placements, fill=None):
    """A DTensor of global ``shape`` whose shard on this rank is a new
    tensor (empty, or ``fill``); no communication."""
    local = _local_shape(shape, mesh, placements)
    t = (torch.empty(local, dtype=dtype) if fill is None
         else torch.full(local, fill, dtype=dtype))
    return from_local(t, mesh, placements, shape)


def _spec(mesh, dims, axes):
    """Placements from mesh-axis names with the divisibility fallback (the
    reference's ``_spec``): ``spec_entries`` with each name its own
    rule."""
    rules = {ax: ax for ax in axes if ax is not None}
    return to_placements(spec_entries(axes, rules, mesh_axis_sizes(mesh),
                                      dims), mesh)


def _sds(shape, dtype, mesh, axes, fill=None):
    return _dtensor(shape, dtype, mesh, _spec(mesh, shape, axes), fill)


def _dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _params(cfg, mesh, dtype=torch.bfloat16):
    from repro_torch.models import transformer as T
    from repro_torch.models.params import (param_pspecs, tree_leaves,
                                           unflatten)
    rules = param_rules(multi_pod="pod" in mesh.mesh_dim_names)
    schema = T.model_schema(cfg)
    specs = dict(tree_leaves(param_pspecs(schema, rules,
                                          mesh_axis_sizes(mesh))))
    return unflatten({
        path: _dtensor(leaf.shape, dtype, mesh,
                       to_placements(specs[path], mesh))
        for path, leaf in tree_leaves(schema)})


def _state_axes(mesh) -> dict[str, tuple]:
    """The reference's ``_decode_state_sds`` axes of each decode-state
    leaf (stacked over layers): KV caches and encdec's cross K/V sharded
    over the data axes on the batch and over ``model`` on the sequence,
    the SSM state over ``model`` on its heads, the conv history on its
    channels."""
    dp = _dp_axes(mesh)
    return {"attn.k": (None, dp, "model", None, None),
            "attn.v": (None, dp, "model", None, None),
            "attn.pos": (None, dp, "model"),
            "ssm.h": (None, dp, "model", None, None),
            "ssm.conv": (None, dp, None, "model"),
            "cross_k": (None, dp, "model", None, None),
            "cross_v": (None, dp, "model", None, None)}


def _map_state(state, fn):
    """``fn(name, leaf)`` over a DecodeState's tensor leaves."""
    out = {}
    for field in state._fields:
        v = getattr(state, field)
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out[field] = type(v)(*(fn(f"{field}.{k}", getattr(v, k))
                                   for k in v._fields))
        elif isinstance(v, torch.Tensor):
            out[field] = fn(field, v)
        else:
            out[field] = v
    return type(state)(**out)


def distribute_state(state, mesh):
    """A decode state of full tensors (the same on every rank) as
    DTensors placed by :func:`_state_axes`; no communication."""
    from torch.distributed.tensor import distribute_tensor
    axes = _state_axes(mesh)
    return _map_state(state, lambda name, t: distribute_tensor(
        t, mesh, _spec(mesh, t.shape, axes[name]), src_data_rank=None))


def _decode_state(cfg, mesh, batch, cache_len, enc_len=0):
    """The decode state's leaves as DTensors of empty shards, placed by
    :func:`_state_axes` (the position cache filled with -1, as
    ``init_decode_state`` leaves it)."""
    from repro_torch.models import transformer as T
    meta = T.init_decode_state(cfg, batch, cache_len, device="meta",
                               enc_len=enc_len)
    axes = _state_axes(mesh)
    return _map_state(meta, lambda name, t: _sds(
        t.shape, t.dtype, mesh, axes[name],
        fill=-1 if name == "attn.pos" else None))


def pick_microbatches(cfg, B, S, dp: int, budget_bytes=192 * 2**20) -> int:
    """Smallest power-of-two microbatch count keeping the per-device layer
    activation (B/m, S, d) bf16 — plus, for MoE, the per-data-shard
    dispatch buffer (T_loc * k * cf * d) — under budget."""
    m = 1
    while m < B:
        per_dev = (B // m) * S * cfg.d_model * 2 / dp
        if cfg.n_experts and cfg.top_k:
            per_dev += ((B // m) * S / dp) * cfg.top_k \
                * cfg.capacity_factor * cfg.d_model * 2
        if per_dev <= budget_bytes:
            break
        m *= 2
    return m


# ---------------------------------------------------------------------------
# Cell builders: (fn, args, extra); fn(*args) runs the step
# ---------------------------------------------------------------------------
def build_lm_cell(arch: str, shape_name: str, mesh, opt_level: int = 0):
    """opt_level 0 = the reference's baseline shardings; 1 = its gradient
    constraint (DTensor gradients already take their parameter's
    placements, so it changes nothing and is recorded); 2 = nested remat
    (``remat_groups``) with a 4x microbatch budget."""
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import TrainConfig, make_train_step
    cfg = configs.get(arch)
    shp = SHAPES[shape_name]
    dp = _dp_axes(mesh)
    dp_size = math.prod(mesh_axis_sizes(mesh)[a] for a in dp)
    big = cfg.param_count() > 5e10
    params = _params(cfg, mesh)
    B, S = shp.global_batch, shp.seq_len

    if shp.kind == "train":
        remat_groups = 0
        budget = 192 * 2 ** 20
        if opt_level >= 2:
            L = cfg.n_layers
            remat_groups = next((g for g in range(int(L ** 0.5), 1, -1)
                                 if L % g == 0), 0)
            budget = 768 * 2 ** 20
        m = pick_microbatches(cfg, B, S, dp_size, budget_bytes=budget)
        tcfg = TrainConfig(
            optimizer=AdamWConfig(
                moment_dtype="bfloat16" if big else "float32"),
            microbatches=m,
            accum_dtype="bfloat16" if big else "float32",
            remat=True, remat_groups=remat_groups)
        step = make_train_step(cfg, tcfg)
        opt = adamw_init(params, tcfg.optimizer)
        if cfg.family == "encdec":
            Sd = S // 2
            batch = {"tokens": _sds((B, Sd), torch.int32, mesh, (dp, None),
                                    fill=0),
                     "enc_input": _sds((B, Sd, cfg.d_model), torch.bfloat16,
                                       mesh, (dp, None, None))}
        else:
            batch = {"tokens": _sds((B, S), torch.int32, mesh, (dp, None),
                                    fill=0)}
        fn = lambda p, o, b: step(p, o, None, b, 0)
        extra = {"microbatches": m}
        if opt_level >= 1:
            extra["grad_constraint"] = "dtensor-gradients-take-placements"
        return fn, (params, opt, batch), extra

    if shp.kind == "prefill":
        tokens = _sds((B, S // 2 if cfg.family == "encdec" else S),
                      torch.int32, mesh, (dp, None), fill=0)
        if cfg.family == "encdec":
            Se = Sd = S // 2
            state = _decode_state(cfg, mesh, B, Sd, enc_len=Se)
            enc = _sds((B, Se, cfg.d_model), torch.bfloat16, mesh,
                       (dp, None, None))
            fn = lambda p, tok, st, e: T.prefill(p, cfg, tok, st,
                                                 enc_input=e)
            return fn, (params, tokens, state, enc), {}
        state = _decode_state(cfg, mesh, B, S)
        fn = lambda p, tok, st: T.prefill(p, cfg, tok, st)
        return fn, (params, tokens, state), {}

    # decode
    if cfg.family == "encdec":
        Se = Sd = S // 2
        state = _decode_state(cfg, mesh, B, Sd, enc_len=Se)
    else:
        state = _decode_state(cfg, mesh, B, S)
    tokens = _sds((B, 1), torch.int32, mesh, (dp, None), fill=0)
    t = torch.zeros((), dtype=torch.int32)
    fn = lambda p, tok, st, tt: T.decode_step(p, cfg, tok, st, tt)
    return fn, (params, tokens, state, t), {}


def _wsn_inputs(shape_name, wsn, local, gen=None, device="cpu"):
    """One rank's operands of a WSN cell: fake-shaped when ``gen`` is None
    (inside FakeTensorMode), else drawn from ``gen``."""
    p, h, q, n = local, wsn.halfwidth, wsn.q, wsn.batch_epochs
    nb = 2 * h + 1

    def t(*shape):
        if gen is None:
            return torch.empty(shape, dtype=torch.float32, device=device)
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)

    if shape_name == "cov_update":
        return {"t": torch.zeros((), device=device), "s": t(p),
                "band": t(nb, p), "x": t(n, p)}
    if shape_name == "pim_block":
        return {"band": t(nb, p), "v": t(p, q)}
    if shape_name == "pim_deflated":
        return {"band": t(nb, p), "v": t(p), "w_prev": t(p, q - 1)}
    if shape_name == "transform":
        return {"w": t(p, q), "mean": t(p), "x": t(n, p)}
    if shape_name == "hier_merge":
        return {"lam": t(wsn.n_regions * local // wsn.p, q).abs(),
                "tv": torch.full((), 1e3, device=device)}
    raise KeyError(shape_name)


def build_wsn_cell(shape_name: str, group=None, wsn=WSN, inputs=None):
    """The paper's production system with the feature axis over every rank
    of ``group`` (the world when None): each rank's contiguous slice of p,
    the step's sharded form (``core.production``).  ``inputs`` (this rank's
    operands, from :func:`_wsn_inputs`) default to empty ones of the
    rank's shape.  The covariance update's state is updated in place (the
    reference donates it)."""
    from repro_torch.core import covariance as cov
    from repro_torch.core import production as P
    world = dist.get_world_size(group)
    if wsn.p % world:
        raise ValueError(f"p={wsn.p} not divisible by {world} ranks")
    local = wsn.p // world
    h = wsn.halfwidth
    a = inputs or _wsn_inputs(shape_name, wsn, local)

    if shape_name == "cov_update":
        def fn(t, s, band, x):
            st = cov.BandedCovState(t=t, s=s, band=band, halfwidth=h)
            new = P.sharded_cov_update_step(st, x, group)
            t.copy_(new.t)
            s.copy_(new.s)
            band.copy_(new.band)
            return t, s, band
        return fn, (a["t"], a["s"], a["band"], a["x"]), {}
    if shape_name in ("pim_block", "pim_deflated"):
        band = a["band"]
        pad = band.new_zeros((band.shape[0], local + 2 * h))
        pad[:, h:h + local] = band          # shard_band's padded layout
        if shape_name == "pim_block":
            fn = lambda b, v: P.sharded_pim_block_step(b, v, group)
            return fn, (pad, a["v"]), {}
        fn = lambda b, v, w: P.sharded_pim_deflated_step(b, v, w, group)
        return fn, (pad, a["v"], a["w_prev"]), {}
    if shape_name == "transform":
        fn = lambda w, m, x: P.sharded_transform_step(w, m, x, group)
        return fn, (a["w"], a["mean"], a["x"]), {}
    if shape_name == "hier_merge":
        # level-2 fleet merge: the (regions, q) energy table gathered over
        # the ranks, then the global top-q selection
        from repro_torch.core.aggregation import d_op
        from repro_torch.streaming.hierarchy import merge_fleet
        fn = lambda lam, tv: merge_fleet(d_op(lam, group, tiled=True), tv,
                                         wsn.q)
        return fn, (a["lam"], a["tv"]), {}
    raise KeyError(shape_name)


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------
def all_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in configs.ASSIGNED:
        for shp in applicable_shapes(configs.get(arch)):
            cells.append((arch, shp))
    for shp in WSN_SHAPES:
        cells.append(("wsn-1m", shp))
    return cells


def skipped_cells() -> list[tuple[str, str, str]]:
    out = []
    for arch in configs.ASSIGNED:
        cfg = configs.get(arch)
        if not cfg.supports_long_context:
            out.append((arch, "long_500k",
                        "full-attention family: long_500k requires "
                        "sub-quadratic sequence mixing (DESIGN.md Sec. 4)"))
    return out


class CellTimeout(Exception):
    pass


@contextlib.contextmanager
def _time_limit(seconds: float | None):
    if not seconds:
        yield
        return

    def on_alarm(signum, frame):
        raise CellTimeout(f"the cell ran past {seconds:.0f} s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def measure(fn, args, *, mesh=None, rules=None, sites=False) -> Meter:
    """Run ``fn(*args)`` once under a :class:`Meter` (inside
    ``activation_sharding(mesh, rules)`` and DTensor's implicit
    replication when a mesh is given) with the arguments' storages
    counted as live; returns the meter, its ``result`` what ``fn``
    returned."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.kernels import ops
    ops.PLANNED.clear()
    meter = Meter(sites=sites)
    with contextlib.ExitStack() as ctx:
        if mesh is not None:
            ctx.enter_context(activation_sharding(mesh, rules))
            ctx.enter_context(implicit_replication())
        ctx.enter_context(meter)
        meter.argument_bytes = meter.track(args)
        meter.result = fn(*args)
        # outputs that alias an argument's storage add nothing
        meter.output_bytes = meter.track(meter.result)
    kf, kb = _planned_work()
    meter.flops += kf
    meter.bytes += kb
    return meter


def _record(meter: Meter, peak_flops: float) -> dict:
    mem = {"argument_bytes": int(meter.argument_bytes),
           "output_bytes": int(meter.output_bytes),
           "temp_bytes": int(meter.peak - meter.argument_bytes),
           "alias_bytes": 0,
           "peak_per_device": int(meter.peak)}
    cost = {"flops": float(meter.flops),
            "bytes accessed": float(meter.bytes)}
    coll = meter.stats()
    terms = C.roofline_terms(cost, coll, peak_flops=peak_flops)
    return {
        "memory": mem, "cost": cost,
        "collectives": {
            "counts": coll.counts,
            "wire_bytes": {k: float(v) for k, v in coll.wire_bytes.items()},
            "total_wire_bytes": float(coll.total_wire_bytes),
            "unknown_trips": list(coll.unknown_trips)},
        "roofline": {"compute_s": terms.compute_s,
                     "memory_s": terms.memory_s,
                     "collective_s": terms.collective_s,
                     "dominant": terms.dominant},
    }


def _fake_cell(arch, shape_name, multi_pod, opt_level, sites=False):
    """Build and run one cell on fake tensors over a fake world; returns
    (record fields, meter)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    n = 512 if multi_pod else 256
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod)
        with FakeTensorMode(allow_non_fake_inputs=True):
            t0 = time.time()
            if arch == "wsn-1m":
                fn, args, extra = build_wsn_cell(shape_name)
                kw, peak = {}, C.PEAK_FP32
            else:
                fn, args, extra = build_lm_cell(arch, shape_name, mesh,
                                                opt_level=opt_level)
                kw = {"mesh": mesh, "rules": act_rules(multi_pod=multi_pod)}
                peak = C.PEAK_BF16
            # the reference's lower_s / compile_s: building the cell's
            # inputs, running its step
            extra["lower_s"] = round(time.time() - t0, 1)
            t1 = time.time()
            meter = measure(fn, args, sites=sites, **kw)
            extra["compile_s"] = round(time.time() - t1, 1)
            fields = _record(meter, peak)
    return {**extra, **fields}, meter


def plan_train_step(cfg, tcfg, batch: tuple[int, int]) -> Meter:
    """The dry run's plan of one training step (``make_train_step(cfg,
    tcfg)`` on a ``batch`` of (B, S) tokens) on a one-rank fake mesh:
    fake DTensor parameters in ``cfg.dtype``, AdamW moments, and the
    tokens; returns the meter (FLOPs, bytes, the peak of live bytes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.transformer import torch_dtype
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.trainer import make_train_step
    with fake_world(1):
        mesh = make_local_mesh(1, 1)
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = _params(cfg, mesh, dtype=torch_dtype(cfg.dtype))
            opt = adamw_init(params, tcfg.optimizer)
            tokens = _sds(batch, torch.int32, mesh, (("data",), None),
                          fill=0)
            step = make_train_step(cfg, tcfg)
            return measure(lambda p, o, b: step(p, o, None, b, 0),
                           (params, opt, {"tokens": tokens}), mesh=mesh,
                           rules=act_rules(multi_pod=False))


SMOKE_RTOL = 1e-6     # of the largest magnitude: fp32 roundoff


def _compare(a, b) -> tuple[bool, float, float]:
    """(bit for bit, the largest difference, that over the largest
    magnitude) of two results (tensors or tuples of them), ``a`` moved to
    ``b``'s device."""
    if isinstance(a, (tuple, list)):
        parts = [_compare(x, y) for x, y in zip(a, b)]
        return (all(p[0] for p in parts), max(p[1] for p in parts),
                max(p[2] for p in parts))
    if a.shape != b.shape:
        return False, float("inf"), float("inf")
    if not b.numel():
        return True, 0.0, 0.0
    a, b = a.to(b.device).double(), b.double()
    err = float((a - b).abs().max())
    return bool(torch.equal(a, b)), err, err / max(float(b.abs().max()),
                                                   1e-30)


def _unsharded(shape_name, a, wsn):
    """The unsharded step on the same operands (one rank holds them all)."""
    from repro_torch.core import covariance as cov
    from repro_torch.core import production as P
    from repro_torch.streaming.hierarchy import merge_fleet
    h = wsn.halfwidth
    if shape_name == "cov_update":
        st = cov.BandedCovState(t=a["t"].clone(), s=a["s"].clone(),
                                band=a["band"].clone(), halfwidth=h)
        new = P.cov_update_step(st, a["x"])
        return new.t, new.s, new.band
    if shape_name == "pim_block":
        return P.pim_block_step(a["band"], a["v"])
    if shape_name == "pim_deflated":
        return P.pim_deflated_step(a["band"], a["v"], a["w_prev"])
    if shape_name == "transform":
        return P.transform_step(a["w"], a["mean"], a["x"])
    b = merge_fleet(a["lam"], a["tv"], wsn.q)
    return (b.region, b.col, b.lam, b.rho)


def _smoke_cell(shape_name, device, group=None):
    """A wsn-1m cell at ``WSN.smoke()`` for real, on this process's rank
    of ``group``: the sharded step (kernels launch on the card) measured,
    and its result held against the unsharded step on CPU copies of the
    operands, where every kernel wrapper takes its plain version.
    Returns record fields; ``launches`` and ``plain_calls`` are the
    sharded step's."""
    from repro_torch.kernels import ops
    wsn = WSN.smoke()
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    dev = torch.device(device)
    if world != 1:
        raise ValueError("the smoke cells compare against the unsharded "
                         "step on one rank")
    gen = torch.Generator(device=dev).manual_seed(0)
    a = _wsn_inputs(shape_name, wsn, wsn.p // world, gen=gen, device=dev)
    if shape_name == "pim_block":
        a["v"] = torch.linalg.qr(a["v"])[0]
    if shape_name == "pim_deflated":
        a["v"] = a["v"] / a["v"].norm()
    want = _unsharded(shape_name, {k: v.cpu().clone() for k, v in a.items()},
                      wsn)
    before = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
    fn, args, extra = build_wsn_cell(shape_name, group, wsn, inputs=a)
    meter = measure(fn, args)
    got = meter.result
    if shape_name == "hier_merge":
        got = (got.region, got.col, got.lam, got.rho)
    launched = {k: v - before[0][k] for k, v in ops.LAUNCHES.items()
                if v != before[0][k]}
    plain = {k: v - before[1][k] for k, v in ops.PLAIN_CALLS.items()
             if v != before[1][k]}
    fields = _record(meter, C.PEAK_FP32)
    bits, abs_err, err = _compare(got, want)
    fields.update(equal_unsharded=err <= SMOKE_RTOL, bitwise=bits,
                  max_abs_err=abs_err, max_rel_err=err, launches=launched,
                  plain_calls=plain, rank=rank)
    return fields


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_level: int = 0, smoke: bool = False, device="cuda",
             time_limit: float | None = None) -> dict:
    """One cell's record (the reference's keys).  ``smoke``: the wsn-1m
    cell at ``WSN.smoke()``, run for real on ``device`` in the default
    process group (opened here over one rank when none is open: NCCL on
    the card, gloo on the CPU)."""
    rec = {"arch": arch, "shape": shape_name, "opt_level": opt_level,
           "mesh": "2x16x16" if multi_pod else "16x16", "ok": False}
    t0 = time.time()
    try:
        with _time_limit(time_limit):
            if smoke:
                if arch != "wsn-1m":
                    raise ValueError("--smoke runs the wsn-1m cells only")
                with _local_world(device):
                    rec["mesh"] = f"local{dist.get_world_size()}"
                    rec.update(_smoke_cell(shape_name, device))
                rec["ok"] = bool(rec["equal_unsharded"])
                if not rec["ok"]:
                    rec["error"] = (f"the sharded step differs from the "
                                    f"unsharded one by {rec['max_rel_err']}"
                                    f" of its largest magnitude")
            else:
                fields, _ = _fake_cell(arch, shape_name, multi_pod,
                                       opt_level)
                rec.update(fields)
                rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — cell failures are data
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


@contextlib.contextmanager
def _local_world(device):
    """The default group if one is open, else one over this process alone
    (NCCL on a CUDA device, gloo on the CPU), closed on exit."""
    if dist.is_initialized():
        yield
        return
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{d}/store", rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--opt-level", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="WSNConfig.smoke() shapes run for real on a "
                         "local one-rank mesh (wsn-1m cells only)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where --smoke runs (default: the card)")
    ap.add_argument("--time-limit", type=float, default=None,
                    help="seconds a cell may run before it is recorded "
                         "as failed")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a, s in all_cells():
            print(f"{a}\t{s}")
        for a, s, why in skipped_cells():
            print(f"{a}\t{s}\tSKIP: {why}")
        return 0

    cells = all_cells()
    if args.smoke:
        cells = [(a, s) for a, s in cells if a == "wsn-1m"]
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    if args.smoke:
        meshes = [False]            # one local mesh — run_cell builds it

    failed = 0
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(arch, shape, mp, opt_level=args.opt_level,
                           smoke=args.smoke, device=args.device,
                           time_limit=args.time_limit)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            failed += not rec["ok"]
            status = "OK " if rec["ok"] else "FAIL"
            print(f"[{status}] {arch} {shape} {rec['mesh']} "
                  f"({rec['total_s']}s)"
                  + ("" if rec["ok"] else f"  {rec.get('error')}"),
                  flush=True)
    return 1 if failed and args.smoke else 0


if __name__ == "__main__":
    raise SystemExit(main())
