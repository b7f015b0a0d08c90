"""What every cell shares: finding a cell's files by name, the card and
its caches, the measured window, the metrics and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the mix names the driver that runs it
(``drivers/<driver>.py``) and the parameters it reads.  The numbers a
run compares with the reference, and their limits, are in
``limits/<cell>.json``; each metric is read by ``metrics/<metric>.py``.
A new cell, mix, configuration or metric is a new file."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _safe(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    base: Path = HERE

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports: its end-to-end metrics,
        or with ``trace`` its per-layer ones."""
        kind = self.per_layer if trace else self.end_to_end
        return [m for m in kind
                if self.name in m.get("workloads", [self.name])]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    base = root / HERE.name
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    limits = load_json(base / "limits" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
                base=base)


def driver_module(cell: Cell):
    name = cell.traffic["driver"]
    return load_module(cell.base / "drivers" / f"{name}.py",
                       f"wsnbench_driver_{_safe(name)}")


def metric_reader(cell: Cell, name: str):
    return load_module(cell.base / "metrics" / f"{name}.py",
                       f"wsnbench_metric_{_safe(name)}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def use_checkout_caches(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the kernels' own build directory is ``build/repro_torch`` there)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(root / "build" / "wsnbench" / sub)
    os.environ["USE_FLAX"] = "0"


def percentile(values: list, pct: float) -> float:
    """The ``pct`` percentile, linear between the order statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    x = (len(v) - 1) * pct / 100.0
    lo = math.floor(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


class Window:
    """The measured window: units of work dispatched back to back until
    ``seconds`` have passed, then one synchronisation.  With a tracer the
    profiler runs over the window's first ``trace_seconds`` (the span
    ``wsnbench.traced``), closed by a synchronisation."""

    def __init__(self, seconds: float, tracer=None,
                 trace_seconds: float | None = None, on_trace_stop=None):
        self.seconds = float(seconds)
        self.tracer = tracer
        self.on_trace_stop = on_trace_stop
        self.trace_seconds = (self.seconds if trace_seconds is None
                              else min(self.seconds, float(trace_seconds)))
        self.units = 0
        self.elapsed = 0.0

    def run(self, unit, sync) -> None:
        """Call ``unit(i)`` for i = 0, 1, ... while the window is open, and
        ``sync()`` at its close; ``elapsed`` is from the first dispatch to
        the end of that synchronisation."""
        from torch.autograd.profiler import record_function
        span = None
        if self.tracer is not None:
            sync()
            self.tracer.start()
            span = record_function("wsnbench.traced")
            span.__enter__()
        t0 = time.perf_counter()
        i = 0
        while True:
            unit(i)
            i += 1
            now = time.perf_counter()
            if span is not None and (now - t0 >= self.trace_seconds
                                     or now - t0 >= self.seconds):
                sync()
                span.__exit__(None, None, None)
                self.tracer.stop()
                span = None
                if self.on_trace_stop is not None:
                    self.on_trace_stop()
            if now - t0 >= self.seconds:
                break
        sync()
        self.elapsed = time.perf_counter() - t0
        self.units = i


@dataclasses.dataclass
class Context:
    """What a metric reader reads: the cell, the window's record, the
    counters' change over the window, the trace of a traced run and the
    set-up time."""

    cell: Cell
    record: dict
    counters: dict
    trace: object
    setup_s: float
    traced_counters: dict = dataclasses.field(default_factory=dict)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "power limit not read"
    return out[0] if out else "power limit not read"


def finite_or_text(x):
    """A number as JSON can carry it: non-finite values as text."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x
