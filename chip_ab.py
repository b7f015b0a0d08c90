#!/usr/bin/env python3
"""Run chip_smoke.py in two source trees, alternated, and tabulate the rates.

    python3 chip_ab.py BASE_TREE [--change TREE] [--order bccb] [--out DIR]

BASE_TREE is an unpacked checkout of the commit to compare against (for
example ``git archive <commit> | tar -x -C build/base``; put it under a
directory that .gitignore lists).  ``--change`` defaults to the directory
that holds this script.  ``--order`` spells the runs, ``b`` for the base
and ``c`` for the change (default ``bccb``), so that drift of the card
over time falls on both sides.  Each run is ``python3 chip_smoke.py``
from its tree's root; its output goes to ``<i>_<side>.log`` in ``--out``
(default ``build/ab`` beside this script).  Then the script prints one
row of values per side, in run order, for every engine or fleet line of
the runs (rounds/s, and the wall time over its steps or rounds), for
phase 17's LM engines (tokens/s and the median decode step), for the
profiled runs' device idle shares and for every kernel of the JSON record
(ms, and device ms where phase 11 gives it), and which kernel functions
kept their SASS (``cuobjdump -sass`` of each tree's build,
``build/repro_torch/``, function by function), and writes the same to
``summary.json`` there.  It exits non-zero if any run
did.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RATE = re.compile(r"^\s+(?P<label>[^:]+): (?:(?P<steps>\d+) steps, \d+ "
                  r"rounds|\d+ networks x (?P<rounds>\d+) rounds) in "
                  r"(?P<wall>[\d.]+) s = (?P<rate>[\d.]+) rounds/s")
IDLE = re.compile(r"^\s+profile: device busy .*idle (?P<idle>[\d.]+)%")
LM = re.compile(r"^\s+(?P<label>[^:]+): \d+ requests, \d+ tokens in [\d.]+ "
                r"s = (?P<rate>[\d.]+) tokens/s; decode step (?P<ms>[\d.]+) "
                r"ms")


def parse(log: str) -> dict[str, float]:
    """The numbers of one chip_smoke.py run, keyed by what they measure."""
    out: dict[str, float] = {}
    last = "run"
    for line in log.splitlines():
        m = RATE.match(line)
        if m:
            last = m["label"].strip()
            out[f"{last}: rounds/s"] = float(m["rate"])
            per, unit = ((m["steps"], "step") if m["steps"]
                         else (m["rounds"], "round"))
            out[f"{last}: ms a {unit}"] = 1e3 * float(m["wall"]) / int(per)
            continue
        m = LM.match(line)
        if m:
            out[f"{m['label'].strip()}: tokens/s"] = float(m["rate"])
            out[f"{m['label'].strip()}: decode ms a step"] = float(m["ms"])
            continue
        m = IDLE.match(line)
        if m:
            out[f"{last}: device idle %"] = float(m["idle"])
        elif line.startswith('{"kernels"'):
            for k in json.loads(line)["kernels"]:
                out[f"kernel {k['name']}: ms"] = k["ms"]
                if "device_ms" in k:
                    out[f"kernel {k['name']}: device ms"] = k["device_ms"]
    return out


def sass_functions(tree: Path) -> dict[str, dict[str, str]]:
    """``{library: {kernel function: its SASS}}`` of every library built
    in ``tree`` (``cuobjdump -sass``; the library's name without its
    content hash)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out: dict[str, dict[str, str]] = {}
    for lib in sorted((tree / "build" / "repro_torch").glob("lib*.so")):
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        funcs, name = {}, None
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                name = m[1]
                funcs[name] = []
            elif name is not None:   # cuobjdump pads to the file's widest line
                funcs[name].append(" ".join(line.split()))
        out[lib.name.rsplit("-", 1)[0]] = {k: "\n".join(v)
                                            for k, v in funcs.items()}
    return out


def compare_sass(trees: dict[str, Path]) -> dict[str, str]:
    """``{library:function: same | differs | base only | change only}``."""
    base, change = (sass_functions(trees[k]) for k in ("b", "c"))
    verdict = {}
    for lib in sorted(set(base) | set(change)):
        b, c = base.get(lib, {}), change.get(lib, {})
        for fn in sorted(set(b) | set(c)):
            verdict[f"{lib}:{fn}"] = ("base only" if fn not in c else
                                      "change only" if fn not in b else
                                      "same" if b[fn] == c[fn] else
                                      "differs")
    return verdict


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("--change", type=Path, default=ROOT)
    ap.add_argument("--order", default="bccb")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ab")
    args = ap.parse_args()
    trees = {"b": args.base.resolve(), "c": args.change.resolve()}
    if set(args.order) - set(trees):
        ap.error("--order takes only the letters b and c")
    for tree in trees.values():
        if not (tree / "chip_smoke.py").is_file():
            ap.error(f"{tree} holds no chip_smoke.py")
    out_dir = args.out.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    names = {"b": "base", "c": "change"}
    runs, failed = [], False
    for i, side in enumerate(args.order, 1):
        proc = subprocess.run([sys.executable, "chip_smoke.py"],
                              cwd=trees[side], capture_output=True,
                              text=True, timeout=args.timeout)
        log = proc.stdout + proc.stderr
        (out_dir / f"{i}_{names[side]}.log").write_text(log)
        print(f"== run {i} {names[side]} ({trees[side]}): exit "
              f"{proc.returncode}", flush=True)
        failed |= proc.returncode != 0
        runs.append((names[side], parse(proc.stdout)))
    keys = list(dict.fromkeys(k for _, nums in runs for k in nums))
    table = {key: {name: [nums.get(key) for side, nums in runs
                          if side == name]
                   for name in ("base", "change")} for key in keys}
    for key, sides in table.items():
        cells = "; ".join(f"{name} " + " / ".join(
            "-" if v is None else f"{v:g}" for v in vals)
            for name, vals in sides.items())
        print(f"{key}: {cells}")
    sass = compare_sass(trees)
    for fn, v in sass.items():
        print(f"sass {fn}: {v}")
    (out_dir / "summary.json").write_text(json.dumps(
        {"order": args.order, "base": str(trees["b"]),
         "change": str(trees["c"]), "table": table, "sass": sass},
        indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
