"""Readings of the comparison over many seeds in one process, for the
port and for the control (the reference in the port's place, float32
with TF32 products), from which each limit in ``limits/<cell>.json`` is
set: the lower reading is the largest the port gives, the upper the
smallest the control gives.

    python -m wsnbench.control --workload <cell> --seeds 1 2 3 \
        --program port|control --seconds 3

Each seed is a whole run of the cell (set-up, a window of ``--seconds``,
the check); one JSON line a seed on standard output."""

from __future__ import annotations

import argparse
import json
import sys
import time

from wsnbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m wsnbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", choices=("port", "control"),
                    default="control")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    harness.use_checkout_caches()
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("wsnbench.control: no CUDA card", file=sys.stderr)
        return 3
    from wsnbench import run
    mod = harness.driver_module(cell)
    program = mod.Control if args.program == "control" else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = run.execute(cell, seed, args.seconds, False,
                          torch.device("cuda", 0), program=program, t0=t0)
        line = {"workload": cell.name, "program": args.program,
                "seed": seed, "correct": out["correct"],
                "attempted": out["attempted"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                "readings": {k: harness.finite_or_text(v)
                             for k, v in out["readings"].items()}}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
