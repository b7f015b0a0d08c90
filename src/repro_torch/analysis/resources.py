"""The kernels' work model and resource bill (counterpart of
``repro.analysis.resources``).

**CPU part: the work model.**  :func:`kernel_work` gives a kernel's
floating-point operations and the bytes it must move at given shapes
(each input read once, each output written once); :func:`bound` turns
them into the least time the H100 could take (:data:`H100`).
:class:`HbmTrafficBudget` checks, for every kernel call a recorded run
made, that the bytes its operands and outputs occupy — as the kernel
reads them — equal the model's: one pass over HBM, the reference's
``max_passes=1.0`` in the port's terms.  :func:`check_traffic` runs every
wrapper once under the recorder and applies it.

**Card part: the build's bill.**  :func:`build_bill` reads each kernel
function's registers, spills and static shared memory from ``ptxas -v``
(the build's own log, :mod:`repro_torch.kernels.build`);
:func:`launch_bill` launches every wrapper once at the engine's widths
under ``torch.profiler`` (in a process of its own) and reads the registers
and shared memory (static plus the dynamic the wrapper requests) each
launch was given.
:func:`check_card` holds both against the H100's limits, requires kernels
4 and 5's stage tile (``stage_rows``) not to spill, and compares them with
the committed ``baselines/resources.json`` — which :func:`bless` writes
from a run on the card, never from the CPU.  Without ``nvcc`` the card
part reports "skipped: no CUDA toolkit".
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.analysis import op_lint
from repro_torch.analysis.contracts import RuleResult

__all__ = ["DeviceLimits", "H100", "PEAK_FP32", "PEAK_BYTES", "bound",
           "CASE_COUNTERS",
           "fold_flops", "band_entries", "kernel_work", "call_work",
           "HbmTrafficBudget", "check_traffic", "ptxas_summary",
           "ptxas_functions", "build_bill", "launch_bill", "resource_bill",
           "check_card", "bless", "BASELINE", "have_toolkit"]

BASELINE = Path(__file__).resolve().parent / "baselines" / "resources.json"


@dataclasses.dataclass(frozen=True)
class DeviceLimits:
    name: str
    peak_fp32: float             # FLOP/s, CUDA cores, dense
    peak_bytes: float            # HBM bytes/s
    smem_per_block: int          # opt-in shared memory a block, bytes
    regs_per_thread: int


H100 = DeviceLimits(name="H100 SXM", peak_fp32=67e12, peak_bytes=3.35e12,
                    smem_per_block=227 * 1024, regs_per_thread=255)
PEAK_FP32, PEAK_BYTES = H100.peak_fp32, H100.peak_bytes


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the H100 could take for the work, and what
    bounds it: the larger of the operations at the fp32 peak and the
    bytes at the HBM rate."""
    t_ops, t_mem = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def fold_flops(S, R, p, h):
    """2 flops per multiply-add over R rows for each UNIQUE pair
    (i, j), i <= j <= i + h, j < p: the band is symmetric
    (band[h-d, i] = band[h+d, i-d]), so its lower diagonals are copies."""
    h = min(h, p - 1)
    pairs = (h + 1) * p - h * (h + 1) // 2
    return 2.0 * S * R * pairs


def band_entries(p, h):
    """In-range entries of a (2h+1, p) band: (2h+1)p - h(h+1)."""
    h = min(h, p - 1)
    return (2 * h + 1) * p - h * (h + 1)


def kernel_work(kernel: str, **d) -> tuple[float, float]:
    """``(flops, bytes)`` of one launch of ``kernel`` (a key of
    ``ops.LAUNCHES``), every input read once and every output written
    once.  Dimensions by kernel:

    * ``fused_stream``, ``fused_stream_bf16``: S, K, n, p, h, q, and
      ``mask`` (a (S, K, p) liveness operand), ``compress``, ``monitor``
      (default True); the bf16 mode reads x and the basis as bf16;
    * ``band_fold``, ``band_fold_masked``: S, K, n, p, h, ``mask_elems``;
    * ``band_round``, ``band_round_masked``, ``band_round_masked_drop``:
      S, n, p, h, ``mask_elems``, and ``accumulate`` (kernel 6 adding
      into a band it reads: the band read once more);
    * ``supervised_compress``, ``pca_monitor``: S, R, p, q, ``mask_elems``;
    * ``pca_project``, ``pca_reconstruct``: S, R, p, q;
    * ``banded_matmul`` (S, p, h, q), ``banded_matvec`` (S, p, h): the
      band's in-range entries only (its corners are never read)."""
    S, p = d["S"], d["p"]
    f32 = 4.0
    me = d.get("mask_elems", 0)
    if kernel in ("fused_stream", "fused_stream_bf16"):
        K, n, h, q = d["K"], d["n"], d["h"], d["q"]
        R = K * n
        wc, wm = d.get("compress", True), d.get("monitor", True)
        tile = 2.0 if kernel == "fused_stream_bf16" else f32
        flops = fold_flops(S, R, p, h) + 2.0 * 2 * S * R * p * q
        nbytes = (tile * (S * R * p + S * p * q)
                  + f32 * (S * K + (S * K * p if d.get("mask") else 0)
                           + S * p + S * q + S * (2 * h + 1) * p + S * R * q
                           + (S * R * p if wc else 0)          # x_hat
                           + (2 * S * R if wm else 0))         # T2, SPE
                  + (1.0 * S * R * p if wc else 0))            # bool flags
        return flops, nbytes
    if kernel in ("band_fold", "band_fold_masked"):
        K, n, h = d["K"], d["n"], d["h"]
        return (fold_flops(S, K * n, p, h),
                f32 * (S * K * n * p + S * K + S * (2 * h + 1) * p + me))
    if kernel.startswith("band_round"):
        n, h = d["n"], d["h"]
        bands = 2 if d.get("accumulate") else 1
        return (fold_flops(S, n, p, h),
                f32 * (S * n * p + bands * S * (2 * h + 1) * p + me))
    if kernel in ("supervised_compress", "pca_monitor"):
        R, q = d["R"], d["q"]
        flops = 2.0 * 2 * S * R * p * q
        if kernel == "supervised_compress":
            return flops, (f32 * (2 * S * R * p + me + S * p * q + S * p
                                  + S * R * q) + S * R * p)
        return flops, f32 * (S * R * p + me + S * p * q + S * (p + q)
                             + S * R * q + 2 * S * R)
    if kernel in ("pca_project", "pca_reconstruct"):
        R, q = d["R"], d["q"]
        return 2.0 * S * R * p * q, f32 * (S * R * p + S * p * q + S * R * q)
    if kernel in ("banded_matmul", "banded_matvec"):
        h, q = d["h"], d.get("q", 1)
        e = band_entries(p, h)
        return 2.0 * S * q * e, f32 * (S * e + 2 * S * p * q)
    raise KeyError(f"no work model for kernel {kernel!r}")


def _numel(shape) -> int:
    return math.prod(shape)


def call_work(call: op_lint.KernelCall) -> tuple[dict, float, float]:
    """A recorded wrapper call's dimensions, the model's bytes for them
    and the bytes its operands and outputs occupy as the kernel reads
    them: each operand as given (bf16 tile operands of kernel 1's bf16
    mode at 2 bytes, a banded product's band at its in-range entries,
    per-round weights at (S, K), and a mean or inverse-eigenvalue operand
    the wrapper defaults at the size it makes), each output as returned."""
    k, ops_, prm = call.kernel, call.operands, call.params
    nbytes = lambda name: (_numel(ops_[name][0])
                           * ops_[name][1].itemsize) if name in ops_ else 0
    out_b = sum(_numel(s) * dt.itemsize for s, dt in
                (o for o in call.outputs if o is not None))
    if k in ("fused_stream", "fused_stream_bf16"):
        S, K, n, p = ops_["x"][0]
        q = ops_["basis"][0][-1]
        d = dict(S=S, K=K, n=n, p=p, h=prm["halfwidth"], q=q,
                 mask="mask" in ops_, compress=prm["with_compress"],
                 monitor=prm["with_monitor"])
        tile = 2 if k == "fused_stream_bf16" else 4
        got = (tile * (_numel(ops_["x"][0]) + _numel(ops_["basis"][0]))
               + 4 * S * K + nbytes("mask")
               + (nbytes("mean") or 4 * S * p)
               + (nbytes("inv_lam") or 4 * S * q))
    elif k.startswith("band_fold"):
        S, K, n, p = ops_["xs"][0]
        d = dict(S=S, K=K, n=n, p=p, h=prm["halfwidth"],
                 mask_elems=_numel(ops_["mask"][0]) if "mask" in ops_ else 0)
        got = nbytes("xs") + 4 * S * K + nbytes("mask")
    elif k.startswith("band_round"):
        shape = ops_["x"][0]        # (n, p) where the call adds into a band
        S, n, p = shape if len(shape) == 3 else (1, *shape)
        d = dict(S=S, n=n, p=p, h=prm["halfwidth"],
                 mask_elems=_numel(ops_["mask"][0]) if "mask" in ops_ else 0,
                 accumulate="band" in ops_)
        got = nbytes("x") + nbytes("mask") + nbytes("band")
    elif k in ("supervised_compress", "pca_monitor"):
        S, R, p = ops_["x"][0]
        q = ops_["basis"][0][-1]
        d = dict(S=S, R=R, p=p, q=q,
                 mask_elems=_numel(ops_["mask"][0]) if "mask" in ops_ else 0)
        got = (nbytes("x") + nbytes("basis") + nbytes("mask")
               + (nbytes("mean") or 4 * S * p))
        if k == "pca_monitor":
            got += nbytes("inv_lam") or 4 * S * q
    elif k == "pca_project":
        S, R, p = ops_["x"][0]
        d = dict(S=S, R=R, p=p, q=ops_["basis"][0][-1])
        got = nbytes("x") + nbytes("basis")
    elif k == "pca_reconstruct":
        S, R, q = ops_["z"][0]
        d = dict(S=S, R=R, p=ops_["basis"][0][1], q=q)
        got = nbytes("z") + nbytes("basis")
    elif k in ("banded_matmul", "banded_matvec"):
        shape = ops_["band"][0]
        nb, p = shape[-2:]
        S, h = _numel(shape[:-2]), (nb - 1) // 2
        q = 1 if k == "banded_matvec" else ops_["V"][0][-1]
        d = dict(S=S, p=p, h=h, q=q)
        got = (S * band_entries(p, h) * ops_["band"][1].itemsize
               + nbytes("V"))
    else:
        raise KeyError(f"no work model for kernel {k!r}")
    return d, kernel_work(k, **d)[1], float(got + out_b)


@dataclasses.dataclass(frozen=True)
class HbmTrafficBudget:
    """Every kernel call of the run moves exactly the model's bytes: its
    operands and outputs, as the kernel reads them, equal
    :func:`kernel_work`'s one read of each input and one write of each
    output."""

    @property
    def name(self) -> str:
        return "hbm:one-pass"

    def check(self, rec: op_lint.Record) -> op_lint.RuleReport:
        bad, total = [], 0.0
        for call in rec.calls:
            d, model, got = call_work(call)
            total += got
            if got != model:
                bad.append(f"{call.kernel} {d}: {got:.0f} B moved, model "
                           f"{model:.0f} B")
        detail = "; ".join(bad[:4]) if bad else (
            f"{len(rec.calls)} kernel calls, {total:.0f} B, each one pass "
            f"(== kernel_work)")
        return op_lint.RuleReport(self.name, not bad, detail)


# cases of _cases that count under another case's counter
CASE_COUNTERS = {"band_round_acc": "band_round"}


def _cases(dev: torch.device, S, K, n, p, h, q):
    """One call of every kernel wrapper at the given widths, keyed by the
    counter it bumps (or by its name in :data:`CASE_COUNTERS`): ``{kernel:
    thunk}``."""
    from repro_torch.core.covariance import band_valid
    from repro_torch.kernels import ops
    from repro_torch.streaming.driver import random_bases
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, device=dev, generator=g)
    live = lambda *s: (torch.rand(s, device=dev, generator=g) > 0.05).float()
    x, w, m = rnd(S, K, n, p), rnd(S, K).abs(), live(S, K, p)
    basis = random_bases(S, p, q, seed=1, device=dev).contiguous()
    mean, il = 0.1 * rnd(S, p), rnd(S, q).abs() + 0.5
    xb, bb = ops.fused_tiles(x, "bf16"), ops.fused_tiles(basis, "bf16")
    xv, xr = x.reshape(S, K * n, p), rnd(S, n, p)
    z = rnd(S, K * n, q)
    band = rnd(S, 2 * h + 1, p) * band_valid(p, h, device=dev)
    prior = rnd(2 * h + 1, p)           # a state the acc form adds into
    stages = dict(halfwidth=h, epsilon=1.0, with_compress=True,
                  with_monitor=True, mask=m)
    return {
        "fused_stream": lambda: ops.fused_stream_update(
            x, w, basis, mean, il, **stages),
        "fused_stream_bf16": lambda: ops.fused_stream_update(
            xb, w, bb, mean, il, precision="bf16", **stages),
        "band_fold": lambda: ops.cov_band_update_chunk_batched(x, w, h),
        "band_fold_masked": lambda: ops.cov_band_update_chunk_batched(
            x, w, h, mask=m),
        "band_round": lambda: ops.cov_band_update_batched(xr, h),
        "band_round_masked": lambda: ops.cov_band_update_batched(
            xr, h, mask=m[:, 0]),
        "band_round_masked_drop": lambda: ops.cov_band_update_batched(
            xr, h, mask=live(S, n, p)),
        "band_round_acc": lambda: ops.cov_band_accumulate(prior, xr[0], h),
        "supervised_compress": lambda: ops.supervised_compress(
            xv, basis, mean, epsilon=1.0, mask=m, n=n),
        "pca_monitor": lambda: ops.pca_monitor(xv, basis, mean, il, mask=m,
                                               n=n),
        "pca_project": lambda: ops.pca_project(xv, basis),
        "pca_reconstruct": lambda: ops.pca_reconstruct(z, basis),
        "banded_matmul": lambda: ops.banded_matmul(band, basis),
        "banded_matvec": lambda: ops.banded_matvec(
            band, basis[..., 0].contiguous()),
    }


# the tiny widths the CPU checks run at, and the engine's on the card
# (one wsn-1m region a slot, 8 slots, K = 8 rounds of n = 32 epochs)
CPU_WIDTHS = dict(S=2, K=2, n=4, p=12, h=2, q=3)
CARD_WIDTHS = dict(S=8, K=8, n=32, p=1024, h=128, q=32)


def check_traffic(device="cpu") -> list[RuleResult]:
    """Every kernel wrapper once, at the CPU's tiny widths or the card's,
    under the recorder: one row a kernel, its call against the model
    (:class:`HbmTrafficBudget`)."""
    dev = torch.device(device)
    widths = CARD_WIDTHS if dev.type == "cuda" else CPU_WIDTHS
    rows = []
    for kernel, thunk in _cases(dev, **widths).items():
        rec = op_lint.record(thunk, label=kernel, device=dev)
        rep = HbmTrafficBudget().check(rec)
        ok = rep.ok and [c.kernel for c in rec.calls] == [
            CASE_COUNTERS.get(kernel, kernel)]
        rows.append(RuleResult("resources", f"{rep.rule}[{kernel}]", ok,
                               rep.detail))
    return rows


# ---------------------------------------------------------------------------
# Card part: the build's bill
# ---------------------------------------------------------------------------
def have_toolkit() -> bool:
    from repro_torch.kernels import build
    try:
        build._nvcc()
    except RuntimeError:
        return False
    return True


def ptxas_summary(log: str) -> list[str]:
    """One line a kernel function of an ``nvcc -Xptxas -v`` log: its
    (mangled) name, registers and spills; and one line a device function
    that is not inlined (kernel 1's two kinds of block): its stack frame
    and spills."""
    out, name, spill, callee = [], "?", "", None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        f = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill, callee = m[1], "", None
        elif f:
            callee = None if f[1] == name else f[1]
        elif "spill" in line:
            if callee is not None:
                out.append(f"{callee} (device function): {line.strip()}")
            else:
                spill = line.strip()
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs[1] if regs else '?'} registers; "
                       f"{spill}")
    return out


def ptxas_functions(log: str) -> dict[str, dict]:
    """``{function: {...}}`` from an ``nvcc -Xptxas -v`` log: each entry
    function's ``registers``, static ``smem`` bytes, ``stack``,
    ``spill_stores`` and ``spill_loads``; each device function that is not
    inlined (``kind`` "device") with its stack and spills."""
    out: dict[str, dict] = {}
    entry, current = None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        f = re.search(r"Function properties for (\S+)", line)
        if m:
            entry = m[1]
            out[entry] = dict(kind="entry")
            current = entry
        elif f:
            current = f[1]
            out.setdefault(current, dict(kind="device" if current != entry
                                         else "entry"))
        elif "spill" in line and current is not None:
            nums = dict(re.findall(r"(\d+) bytes (stack frame|spill stores"
                                   r"|spill loads)", line))
            rev = {v: int(k) for k, v in nums.items()}
            out[current].update(stack=rev.get("stack frame", 0),
                                spill_stores=rev.get("spill stores", 0),
                                spill_loads=rev.get("spill loads", 0))
        elif "Used" in line and "registers" in line and entry is not None:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry].update(registers=int(regs[1]) if regs else None,
                              smem=int(smem[1]) if smem else 0)
    return out


def build_bill() -> dict[str, dict]:
    """``{source: ptxas_functions(log)}`` for every CUDA source, built
    first if needed (the log is kept beside each library)."""
    from repro_torch.kernels import build
    return {name: ptxas_functions(info["log"])
            for name, info in build.build_all().items()}


def _base_name(name: str) -> str:
    """The unqualified function name of a mangled (``_ZN...``) or a
    demangled symbol: ``band_syrk_kernel`` for both spellings."""
    if name.startswith("_Z"):
        parts, i = [], name.find("repro_torch") + len("repro_torch")
        while i < len(name) and name[i].isdigit():
            j = i
            while name[j].isdigit():
                j += 1
            n = int(name[i:j])
            parts.append(name[j:j + n])
            i = j + n
        return parts[-1] if parts else name
    head = name.split("(")[0].split("<")[0]
    return head.split("::")[-1].split()[-1]


def _traced_kernels(thunk, path: Path) -> tuple[list, set]:
    """The port's kernel events of one call of ``thunk`` in a
    ``torch.profiler`` trace, and the trace's event categories."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        thunk()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    events = [e for e in trace if str(e.get("cat", "")).lower() == "kernel"
              and "repro_torch" in e.get("name", "")]
    return events, {str(e.get("cat")) for e in trace}


# a trace without one device kernel event of any kind: the profiler
# caught no device activity (seen in a fresh process too, then not in the
# next); the launch bill is taken again in a new process
_NO_DEVICE_EVENTS = "the profiler recorded no kernel event"
_LAUNCH_BILL_TRIES = 3


def _launch_bill_here(device="cuda") -> dict[str, dict]:
    dev = torch.device(device)
    bill = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kernel, thunk in _cases(dev, **CARD_WIDTHS).items():
            thunk()
            torch.cuda.synchronize()
            events, cats = _traced_kernels(thunk, Path(tmp) / f"{kernel}.json")
            if "kernel" not in {c.lower() for c in cats}:
                raise RuntimeError(f"{_NO_DEVICE_EVENTS}: {kernel}'s trace "
                                   f"(event categories {sorted(cats)})")
            if len(events) != 1:
                raise RuntimeError(f"{kernel}: {len(events)} kernels of the "
                                   f"port in one launch's trace (event "
                                   f"categories {sorted(cats)})")
            args = events[0].get("args", {})
            bill[kernel] = dict(function=events[0]["name"],
                                registers=args.get("registers per thread"),
                                shared_memory=args.get("shared memory"))
    return bill


def launch_bill(device="cuda") -> dict[str, dict]:
    """``{kernel: {function, registers, shared_memory}}``: every wrapper
    launched once at the engine's widths under ``torch.profiler``, with
    the registers a thread and the shared memory a block (static plus the
    dynamic the wrapper requests) the launch was given, from the
    profiler's trace.  It runs in a child process of its own: in a
    process that has profiled before (as ``chip_smoke.py``'s phases 4-14
    do) torch 2.11's profiler caught no kernel event on the H100 machine.
    A fresh process's trace, too, once held no device kernel event at all;
    such a process is run again, up to ``_LAUNCH_BILL_TRIES`` in all, and
    each retry is printed with its reason (a trace with device events but
    not exactly one of the port's kernels fails at once)."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    code = ("import json, sys; from repro_torch.analysis import resources; "
            "print(json.dumps(resources._launch_bill_here(sys.argv[1])))")
    for attempt in range(1, _LAUNCH_BILL_TRIES + 1):
        proc = subprocess.run([sys.executable, "-c", code, str(device)],
                              capture_output=True, text=True, env=env,
                              timeout=900)
        if _NO_DEVICE_EVENTS not in proc.stderr or \
                attempt == _LAUNCH_BILL_TRIES:
            break
        reason = [line for line in proc.stderr.splitlines()
                  if _NO_DEVICE_EVENTS in line][-1]
        print(f"   launch bill: try {attempt} of {_LAUNCH_BILL_TRIES} "
              f"failed ({reason.strip()}); running it again", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the launch bill's process failed "
                           f"(exit {proc.returncode}):\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def resource_bill(device="cuda") -> dict:
    """The card's whole bill: the build's (:func:`build_bill`) and the
    launches' (:func:`launch_bill`), with each launch's dynamic shared
    memory (its shared memory less its function's static ``smem``)."""
    build = build_bill()
    launches = launch_bill(device)
    static: dict[str, set] = {}
    for funcs in build.values():
        for f, v in funcs.items():
            if v.get("kind") == "entry":
                static.setdefault(_base_name(f), set()).add(v.get("smem", 0))
    for rec in launches.values():
        st = static.get(_base_name(rec["function"]), set())
        # the static part is known where every instance of the kernel's
        # template has the same (ptxas names them mangled, the trace not)
        rec["dynamic_shared_memory"] = (
            rec["shared_memory"] - next(iter(st))
            if len(st) == 1 and rec["shared_memory"] is not None else None)
    return dict(device=torch.cuda.get_device_name(torch.device(device)),
                build=build, launch=launches)


def _limits(bill: dict) -> list[RuleResult]:
    rows = []
    for src, funcs in sorted(bill["build"].items()):
        bad = [f"{f}: {v.get('registers')} registers, {v.get('smem', 0)} B "
               f"smem" for f, v in funcs.items() if v.get("kind") == "entry"
               and ((v.get("registers") or 0) > H100.regs_per_thread
                    or v.get("smem", 0) > H100.smem_per_block)]
        spills = {f: v.get("spill_stores", 0) for f, v in funcs.items()}
        rows.append(RuleResult(
            "resources", f"limits:build[{src}]", not bad,
            "; ".join(bad) if bad else
            f"{len(funcs)} functions within {H100.regs_per_thread} registers "
            f"and {H100.smem_per_block} B smem; spill stores "
            f"{sum(spills.values())} B"))
    stage = {f: v for f, v in bill["build"].get("pca_project", {}).items()
             if "stage_rows" in f}
    spilled = {f: v.get("spill_stores", 0) for f, v in stage.items()
               if v.get("spill_stores", 0) or v.get("spill_loads", 0)}
    rows.append(RuleResult(
        "resources", "no-spill:stage_rows", bool(stage) and not spilled,
        f"{len(stage)} stage_rows functions (kernels 4 and 5), spills "
        f"{spilled or 'none'}"))
    for kernel, rec in sorted(bill["launch"].items()):
        regs, smem = rec["registers"], rec["shared_memory"]
        ok = (regs is not None and smem is not None
              and regs <= H100.regs_per_thread
              and smem <= H100.smem_per_block)
        rows.append(RuleResult(
            "resources", f"limits:launch[{kernel}]", ok,
            f"{regs} registers, {smem} B shared memory (dynamic "
            f"{rec.get('dynamic_shared_memory')} B) at launch; limits "
            f"{H100.regs_per_thread}, {H100.smem_per_block} B"))
    return rows


def record_diff(got: dict | None, want: dict | None) -> str:
    """What differs between a record of this run's bill and the
    baseline's (``""`` where they are equal): each field as
    ``want -> got``, or which side lacks the record."""
    if want is None:
        return "missing from the baseline"
    if got is None:
        return "missing from this run"
    return "; ".join(f"{f}: {want.get(f)} -> {got.get(f)}"
                     for f in sorted(set(got) | set(want))
                     if got.get(f) != want.get(f))


def _against(bill: dict, base: dict) -> list[RuleResult]:
    rows = []
    for part in ("build", "launch"):
        for key in sorted(set(bill[part]) | set(base.get(part, {}))):
            diff = record_diff(bill[part].get(key),
                               base.get(part, {}).get(key))
            rows.append(RuleResult("resources", f"baseline:{part}[{key}]",
                                   not diff, diff or "== baseline"))
    return rows


def check_card(device="cuda", baseline: Path = BASELINE
               ) -> list[RuleResult]:
    """The card part: the bill within the H100's limits, the stage tile
    without spills, and the bill equal to ``baseline``."""
    if not have_toolkit():
        return [RuleResult("resources", "card", True,
                           "skipped: no CUDA toolkit")]
    bill = resource_bill(device)
    rows = _limits(bill)
    if not Path(baseline).exists():
        return rows + [RuleResult("resources", "baseline", False,
                                  f"no baseline at {baseline}: bless one "
                                  f"from a run on the card")]
    return rows + _against(bill, json.loads(Path(baseline).read_text()))


def bless(path: Path = BASELINE, device="cuda") -> Path:
    """Write the card's bill to ``path``; refuses without a card."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the resource baseline is blessed from a run on "
                           "the card, never from the CPU")
    bill = resource_bill(device)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(bill, indent=1, sort_keys=True) + "\n")
    return Path(path)
