"""Op recorder and the program-contract rules (counterpart of
``repro.analysis.jaxpr_lint``).

The reference traces a jaxpr without running it.  Here an entry point
runs once, at a tiny size, under :func:`record`, which collects:

* every aten op the run dispatches (a ``TorchDispatchMode``), with its
  output dtypes and, for the ops a rule reads (host reads, float64 and
  bfloat16 outputs), the Python call site;
* the deltas of the port's own counters: the kernel wrappers' launches
  and plain calls (``kernels/ops.py``: a ctypes launch never reaches the
  dispatcher, so kernel budgets read these, never aten ops), the
  collectives of ``streaming/hierarchy.py`` (with their payload sizes)
  and of ``core/aggregation.py``, and the power iteration's counted
  host reads;
* each wrapper call's operand and output shapes and dtypes (what
  :class:`repro_torch.analysis.resources.HbmTrafficBudget` reads);
* on the card, optionally, the host syncs by call site
  (``torch.cuda.set_sync_debug_mode``).

The counters are module globals, so one record runs at a time: no
nesting, no threads.  On the CPU ``.cpu()`` of a CPU tensor copies
nothing, so a host read there is ``aten::_local_scalar_dense`` (what
``.item()``, ``float()`` and ``bool()`` of a tensor dispatch); on the card
a device-to-host copy counts as well.

Rules are frozen dataclasses with ``name`` and ``check(record) ->
RuleReport``; :mod:`repro_torch.analysis.contracts` binds them to entry
points.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import linecache
import sys
import warnings
from pathlib import Path
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["ROOT", "OpEvent", "KernelCall", "Record", "record",
           "sync_sites", "ALLOWED_SYNCS", "EIGH_OP", "RuleReport",
           "KernelBudget", "OpBudget", "NoHostRead", "NoF64",
           "Fp32Accumulators", "CollectiveBudget", "WirePayload",
           "InPlaceState", "SyncBudget", "tensors_of"]

ROOT = Path(__file__).resolve().parents[3]
_TORCH_DIR = str(Path(torch.__file__).resolve().parent)
_THIS = str(Path(__file__).resolve())
# the eigh op every refresh dispatches (torch.linalg.eigh decomposes to it)
EIGH_OP = "aten::_linalg_eigh"
# ops that only view or move a tensor's elements: a bf16 tile may pass
# through them without being computed on
_DATA_MOVEMENT = frozenset({
    "aten::view", "aten::_unsafe_view", "aten::reshape", "aten::expand",
    "aten::slice", "aten::select", "aten::permute", "aten::transpose",
    "aten::t", "aten::clone", "aten::unsqueeze", "aten::squeeze",
    "aten::as_strided", "aten::detach", "aten::alias", "aten::unbind",
    "aten::split", "aten::narrow", "aten::contiguous", "aten::copy_",
    "aten::empty_like", "aten::empty_strided", "aten::_to_copy",
    "aten::lift_fresh"})
# the kernel wrappers whose calls are recorded (each bumps exactly one
# counter of kernels/ops.py); the others reach these through the module
_WRAPPERS = ("cov_band_update_batched", "cov_band_accumulate",
             "cov_band_update_chunk_batched",
             "fused_stream_update", "supervised_compress", "pca_monitor",
             "pca_project", "pca_reconstruct", "_banded")


def _site(skip: int = 2) -> str:
    """The innermost Python frame outside torch and this module, as
    ``path:line function`` (path relative to the repository)."""
    f = sys._getframe(skip)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_TORCH_DIR) and fn != _THIS \
                and "<frozen" not in fn:
            p = Path(fn)
            try:
                p = p.resolve().relative_to(ROOT)
            except ValueError:
                pass
            return f"{p}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return "?"


@dataclasses.dataclass(frozen=True)
class OpEvent:
    name: str                    # aten op, e.g. "aten::_linalg_eigh"
    dtypes: tuple[str, ...]      # output tensor dtypes
    site: str | None             # call site, for the ops rules read
    host_read: bool = False      # the op moved a value to the host
    bf16_made: bool = False      # bf16 output computed from a non-tile


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """One kernel wrapper call: the counter it bumped, its tensor operands
    (name -> (shape, dtype)), its other arguments and its outputs."""
    kernel: str
    operands: dict
    params: dict
    outputs: tuple


@dataclasses.dataclass
class Record:
    label: str
    device: torch.device
    ops: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=dict)
    plain_calls: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=dict)
    collective_elems: dict = dataclasses.field(default_factory=dict)
    core_collectives: dict = dataclasses.field(default_factory=dict)
    host_reads: dict = dataclasses.field(default_factory=dict)
    calls: list = dataclasses.field(default_factory=list)
    syncs: collections.Counter | None = None
    result: Any = None

    def kernel_count(self, kernel: str) -> int:
        """Launches on the card plus plain calls on the CPU: the same
        wrapper, the same count."""
        return self.launches.get(kernel, 0) + self.plain_calls.get(kernel, 0)

    def op_count(self, name: str) -> int:
        return sum(1 for e in self.ops if e.name == name)


class _OpMode(TorchDispatchMode):
    def __init__(self, sink: list):
        super().__init__()
        self.sink = sink

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func._schema.name)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        dtypes = tuple(str(t.dtype).replace("torch.", "") for t in outs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        host_read = _host_read(name, ins, outs)
        bf16_made = "bfloat16" in dtypes and not (
            name in _DATA_MOVEMENT and ins
            and all(t.dtype == torch.bfloat16 for t in ins))
        site = (_site() if host_read or bf16_made or "float64" in dtypes
                or "complex128" in dtypes else None)
        self.sink.append(OpEvent(name, dtypes, site, host_read, bf16_made))
        return out


def _host_read(name: str, ins: list, outs: list) -> bool:
    """The op moved a value to the host: ``.item()`` and its kin, or a
    copy from a CUDA tensor into host memory."""
    if name == "aten::_local_scalar_dense":
        return True
    if name == "aten::_to_copy":
        src, dst = ins[:1], outs
    elif name == "aten::copy_":
        src, dst = ins[1:2], ins[:1]
    else:
        return False
    return any(t.is_cuda for t in src) and any(not t.is_cuda for t in dst)


def _meta(t):
    return None if t is None else (tuple(t.shape), t.dtype)


def _traced(fn, calls: list, ops_mod):
    sig = inspect.signature(fn)

    def wrapper(*args, **kwargs):
        before = {k: ops_mod.LAUNCHES[k] + ops_mod.PLAIN_CALLS[k]
                  for k in ops_mod.LAUNCHES}
        out = fn(*args, **kwargs)
        bumped = [k for k in before if ops_mod.LAUNCHES[k]
                  + ops_mod.PLAIN_CALLS[k] != before[k]]
        bound = sig.bind(*args, **kwargs)
        operands = {k: _meta(v) for k, v in bound.arguments.items()
                    if isinstance(v, torch.Tensor)}
        params = {k: v for k, v in bound.arguments.items()
                  if isinstance(v, (bool, int, float, str))}
        flat = out if isinstance(out, tuple) else (out,)
        calls.append(KernelCall("+".join(bumped), operands, params,
                                tuple(_meta(t) for t in flat)))
        return out
    return wrapper


def _counters():
    from repro_torch.core import aggregation, power_iteration
    from repro_torch.kernels import ops
    from repro_torch.streaming import hierarchy
    return dict(launches=ops.LAUNCHES, plain_calls=ops.PLAIN_CALLS,
                collectives=hierarchy.COLLECTIVES,
                collective_elems=hierarchy.COLLECTIVE_ELEMS,
                core_collectives=aggregation.COLLECTIVES,
                host_reads=power_iteration.HOST_READS)


_ACTIVE = False


def record(run: Callable[[], Any], *, label: str = "",
           device: str | torch.device = "cpu",
           syncs: bool = False) -> Record:
    """Run ``run()`` once under the recorder and return its
    :class:`Record` (``result``: what ``run`` returned).  With ``syncs``
    (card only) the host syncs are collected by call site, as
    :func:`sync_sites` does.  Records do not nest."""
    global _ACTIVE
    if _ACTIVE:
        raise RuntimeError("op_lint.record does not nest: the counters it "
                           "reads are module globals")
    from repro_torch.kernels import ops
    rec = Record(label=label, device=torch.device(device))
    counters = _counters()
    before = {k: dict(v) for k, v in counters.items()}
    saved = {name: getattr(ops, name) for name in _WRAPPERS}
    _ACTIVE = True
    try:
        for name, fn in saved.items():
            setattr(ops, name, _traced(fn, rec.calls, ops))
        with _OpMode(rec.ops):
            if syncs:
                rec.syncs = sync_sites(lambda: setattr(rec, "result", run()))
            else:
                rec.result = run()
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
        _ACTIVE = False
    for k, v in counters.items():
        setattr(rec, k, {c: n - before[k].get(c, 0) for c, n in v.items()
                         if n != before[k].get(c, 0)})
    return rec


def sync_sites(run) -> collections.Counter:
    """The host syncs ``run()`` makes, by call site ("file:line: code"),
    from ``torch.cuda.set_sync_debug_mode("warn")``.  torch warns once,
    when the mode is first switched on, that it is a prototype; only the
    warnings that say "called a synchronizing" count."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter()
    for w in caught:
        if "called a synchronizing" in str(w.message):
            where = Path(w.filename)
            if where.is_relative_to(ROOT):
                where = where.relative_to(ROOT)
            code = linecache.getline(w.filename, w.lineno).strip()
            sites[f"{where}:{w.lineno}: {code}"] += 1
    return sites


# the sites where the engine's loop may wait for the card: the refresh's
# eigh (it checks its result on the host) and the retirement pull (the
# transfer fence, an Event.synchronize on a copy, is never flagged)
ALLOWED_SYNCS = ("torch.linalg.eigh", "x.cpu()")


def tensors_of(tree):
    """Every tensor in a nest of NamedTuples, tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tensors_of(v)


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RuleReport:
    rule: str
    ok: bool
    detail: str


def _want(n, exact, max_, min_):
    ok, wants = True, []
    if exact is not None:
        ok &= n == exact
        wants.append(f"== {exact}")
    if max_ is not None:
        ok &= n <= max_
        wants.append(f"<= {max_}")
    if min_ is not None:
        ok &= n >= min_
        wants.append(f">= {min_}")
    return ok, " and ".join(wants)


@dataclasses.dataclass(frozen=True)
class KernelBudget:
    """Launches (card) or plain calls (CPU) of one kernel wrapper, or the
    sum over a tuple of them; ``exact``/``max``/``min`` may be callables
    of the record.  On the card a plain call fails the rule too: no path
    takes a plain version there."""
    kernel: str | tuple
    exact: int | Callable | None = None
    max: int | Callable | None = None
    min: int | Callable | None = None

    @property
    def kernels(self) -> tuple:
        return (self.kernel,) if isinstance(self.kernel, str) else self.kernel

    @property
    def name(self) -> str:
        return "kernels:" + "+".join(self.kernels)

    def check(self, rec: Record) -> RuleReport:
        n = sum(rec.kernel_count(k) for k in self.kernels)
        val = lambda v: v(rec) if callable(v) else v
        ok, want = _want(n, val(self.exact), val(self.max), val(self.min))
        detail = f"{'+'.join(self.kernels)} {n} (want {want})"
        if rec.device.type == "cuda":
            plain = sum(rec.plain_calls.get(k, 0) for k in self.kernels)
            ok &= plain == 0
            detail += f"; plain calls on the card {plain} (want 0)"
        return RuleReport(self.name, ok, detail)


@dataclasses.dataclass(frozen=True)
class OpBudget:
    """The count of one aten op (e.g. :data:`EIGH_OP`)."""
    op: str
    exact: int | None = None
    max: int | None = None
    min: int | None = None

    @property
    def name(self) -> str:
        return f"ops:{self.op}"

    def check(self, rec: Record) -> RuleReport:
        n = rec.op_count(self.op)
        ok, want = _want(n, self.exact, self.max, self.min)
        return RuleReport(self.name, ok, f"{self.op} x{n} (want {want})")


@dataclasses.dataclass(frozen=True)
class NoHostRead:
    """No value moves to the host in the run (the counterpart of
    ``ForbidInLoops``) outside ``allowed_sites`` (substrings of the call
    site ``path:line function``)."""
    allowed_sites: tuple = ()

    @property
    def name(self) -> str:
        return "host-read"

    def check(self, rec: Record) -> RuleReport:
        reads = [e for e in rec.ops if e.host_read]
        bad = collections.Counter(
            f"{e.name} at {e.site}" for e in reads
            if not any(a in (e.site or "") for a in self.allowed_sites))
        allowed = len(reads) - sum(bad.values())
        if bad:
            detail = "; ".join(f"{k} x{n}" for k, n in bad.most_common(6))
        else:
            detail = (f"no host read (want 0); {allowed} at the allowed "
                      f"sites {list(self.allowed_sites)}"
                      if self.allowed_sites else "no host read (want 0)")
        return RuleReport(self.name, not bad, detail)


@dataclasses.dataclass(frozen=True)
class NoF64:
    """No float64/complex128 op output anywhere in the run."""

    @property
    def name(self) -> str:
        return "dtype:no-f64"

    def check(self, rec: Record) -> RuleReport:
        hits = collections.Counter(
            f"{e.name} -> {d} at {e.site}" for e in rec.ops
            for d in e.dtypes if d in ("float64", "complex128"))
        detail = ("; ".join(f"{k} x{n}" for k, n in hits.most_common(6))
                  if hits else f"no f64/c128 output in {len(rec.ops)} ops")
        return RuleReport(self.name, not hits, detail)


@dataclasses.dataclass(frozen=True)
class Fp32Accumulators:
    """bf16 is a tile format: it is made only by ``ops.fused_tiles`` (kernel
    1's operand tiles) and only moved after that, never computed on; every
    floating tensor the run returns (state, metrics) is fp32."""

    @property
    def name(self) -> str:
        return "dtype:fp32-accumulators"

    def check(self, rec: Record) -> RuleReport:
        hits = collections.Counter(
            f"{e.name} makes bfloat16 at {e.site}" for e in rec.ops
            if e.bf16_made and "fused_tiles" not in (e.site or ""))
        returned = collections.Counter(
            str(t.dtype) for t in tensors_of(rec.result)
            if t.is_floating_point() and t.dtype != torch.float32)
        problems = [f"{k} x{n}" for k, n in hits.most_common(6)]
        problems += [f"returned {d} tensors x{n}" for d, n in
                     returned.items()]
        n_ret = sum(1 for _ in tensors_of(rec.result))
        detail = "; ".join(problems) if problems else (
            f"bf16 made only by fused_tiles; {n_ret} returned tensors, "
            f"every floating one fp32")
        return RuleReport(self.name, not problems, detail)


@dataclasses.dataclass(frozen=True)
class CollectiveBudget:
    """Exact collectives per run on one of the port's counters
    (``"hierarchy"``: ``streaming.hierarchy.COLLECTIVES``;
    ``"aggregation"``: ``core.aggregation.COLLECTIVES``); every counter
    not in ``budgets`` must stay 0."""
    counter: str
    budgets: tuple

    @property
    def name(self) -> str:
        return f"collectives:{self.counter}"

    def check(self, rec: Record) -> RuleReport:
        got = (rec.collectives if self.counter == "hierarchy"
               else rec.core_collectives)
        want = dict(self.budgets)
        problems = [f"{k} x{got.get(k, 0)} (want {w})"
                    for k, w in want.items() if got.get(k, 0) != w]
        problems += [f"unbudgeted {k} x{n}" for k, n in got.items()
                     if k not in want and n]
        detail = "; ".join(problems) if problems else (", ".join(
            f"{k} x{w}" for k, w in want.items()) or "no collective") \
            + ", none other"
        return RuleReport(self.name, not problems, detail)


@dataclasses.dataclass(frozen=True)
class WirePayload:
    """The merge's record a region — the energies each region puts in the
    ``all_gather`` plus its trace partial in the ``all_reduce`` — has
    ``record_elems(q)`` elements (``costs.merge_record_elems``: what the
    merge's Table-1 price bills; the counterpart of ``WireBytesBudget``).
    Reads ``result["regions_local"]`` and ``result["q"]``."""
    record_elems: Callable[[int], int]

    @property
    def name(self) -> str:
        return "wire:merge-record"

    def check(self, rec: Record) -> RuleReport:
        regions, q = rec.result["regions_local"], rec.result["q"]
        gathered = rec.collective_elems.get("all_gather", 0)
        per_region = gathered / max(regions, 1) + 1
        want = self.record_elems(q)
        return RuleReport(
            self.name, per_region == want,
            f"{gathered} gathered elements over {regions} regions + 1 "
            f"trace partial = {per_region:g} a region (want {want})")


@dataclasses.dataclass(frozen=True)
class InPlaceState:
    """Every state tensor keeps its ``data_ptr`` across the run's steps
    (the counterpart of buffer donation); reads ``result["state_ptrs"]``,
    one tuple of pointers a step, the first before any step."""

    @property
    def name(self) -> str:
        return "state:in-place"

    def check(self, rec: Record) -> RuleReport:
        ptrs = rec.result["state_ptrs"]
        moved = sum(a != b for p in ptrs[1:] for a, b in zip(ptrs[0], p))
        return RuleReport(
            self.name, moved == 0,
            f"{len(ptrs[0])} state tensors over {len(ptrs) - 1} steps; "
            f"{moved} reallocations (want 0)")


@dataclasses.dataclass(frozen=True)
class SyncBudget:
    """Card only: the host syncs by call site, each at an ``allowed`` site
    (substrings of ``file:line: code``)."""
    allowed: tuple = ALLOWED_SYNCS

    @property
    def name(self) -> str:
        return "syncs"

    def check(self, rec: Record) -> RuleReport:
        if rec.syncs is None:
            return RuleReport(self.name, False, "syncs were not recorded")
        bad = {s: n for s, n in rec.syncs.items()
               if not any(a in s for a in self.allowed)}
        detail = ("; ".join(f"{s} x{n}" for s, n in bad.items()) if bad
                  else f"{sum(rec.syncs.values())} syncs, all at "
                       f"{list(self.allowed)}: " + "; ".join(
                           f"{s} x{n}" for s, n in rec.syncs.items()))
        return RuleReport(self.name, not bad, detail)
