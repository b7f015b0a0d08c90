"""Run one cell of the benchmark on the card and print its result line.

    python -m wsnbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A run loads the cell's files, builds (or finds built) the port's kernels
in the checkout, makes its data on the card from the seed, warms the
cell's shapes, measures for ``--seconds``, compares what the window
produced with the plain reference, and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; then ``checks``, each compared number beside its limit,
which are also the last lines on standard error.  Without a CUDA card
(or with fewer than the cell asks for) it prints no result and exits 3.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from wsnbench import harness  # noqa: E402


def program_counters() -> dict:
    """The program's own counters: kernel launches and plain calls by
    kernel, the iterations' host reads."""
    try:
        from repro_torch.core import power_iteration
        from repro_torch.kernels import ops
    except ImportError:
        return {}
    out = {f"launches.{k}": v for k, v in ops.LAUNCHES.items()}
    out.update({f"plain_calls.{k}": v for k, v in ops.PLAIN_CALLS.items()})
    out.update({f"host_reads.{k}": v
                for k, v in power_iteration.HOST_READS.items()})
    return out


def execute(cell: harness.Cell, seed: int, seconds: float, trace: bool,
            device, program=None, t0: float = _T0) -> dict:
    """One run of ``cell`` on ``device``; ``program`` puts another program
    (the control, or a broken one in the tests) in the port's place.
    Returns the result line's object."""
    import torch
    from wsnbench.trace import Tracer
    drv = harness.driver_module(cell).Driver(
        cell.config, cell.traffic, seed, device, program=program)
    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = program_counters()
    tracer = Tracer() if trace else None
    traced = {}

    def at_trace_stop():
        traced.update({k: v - before.get(k, 0)
                       for k, v in program_counters().items()})

    window = harness.Window(seconds, tracer,
                            cell.traffic.get("trace_seconds"),
                            on_trace_stop=at_trace_stop)
    setup_s = time.perf_counter() - t0
    record = drv.measure(window)
    counters = {k: v - before.get(k, 0)
                for k, v in program_counters().items()}
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    tr = tracer.result("wsnbench.traced") if trace else None
    ctx = harness.Context(cell=cell, record=record, counters=counters,
                          trace=tr, setup_s=setup_s, traced_counters=traced)
    metrics = {}
    for m in cell.metrics(trace):
        value = harness.metric_reader(cell, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = drv.check()
    checks = {}
    for name, lim in cell.limits["limits"].items():
        value = readings.get(name, float("nan"))
        checks[name] = {"value": harness.finite_or_text(value),
                        "limit": lim["limit"]}
    correct = all(isinstance(c["value"], (int, float))
                  and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    out = {"correct": correct, "attempted": int(record["attempted"]),
           "failed": 0, "metrics": metrics, "device": dev}
    if tr is not None:
        out["breakdown"] = {"device_ops": [list(x) for x in tr.top_ops()],
                            "idle_gaps": [list(x) for x in tr.idle_gaps()]}
    out["readings"] = readings
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m wsnbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    harness.use_checkout_caches()
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"wsnbench: the cell {cell.name} needs {cell.chips} CUDA "
              f"card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 3
    out = execute(cell, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0))
    bad = harness.forbidden_modules()
    if bad:
        print(f"wsnbench: the process loaded {bad}: no result",
              file=sys.stderr)
        return 4
    info = out.pop("readings")
    print("readings " + json.dumps(
        {k: harness.finite_or_text(v) for k, v in info.items()},
        sort_keys=True), file=sys.stderr)
    for name, c in out["checks"].items():
        ok = ("ok" if isinstance(c["value"], (int, float))
              and c["value"] <= c["limit"] else "FAIL")
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
