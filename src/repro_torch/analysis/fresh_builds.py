"""``python -m repro_torch.analysis.fresh_builds`` — build one CUDA source
fresh many times and count the resource bills (and the PTX texts) nvcc
gives it.

The resource check (phase 16 of ``chip_smoke.py``) holds each kernel
function's registers, spills and shared memory equal to a committed
baseline, so it needs one bill per source.  A library in the build cache
(``kernels/build.py``) is named by a hash of the sources and is never
rebuilt, so a cached build cannot show a compiler that gives one source
two bills.  Here every build is a new ``nvcc`` process with the cache's
own flags (``build.NVCC_FLAGS``) into a directory of its own, with
``-keep``: its ``ptxas -v`` log is parsed as the bill's build part
(``resources.ptxas_functions``) and held against the baseline's, and its
PTX is hashed.

Options:
    --source NAME   the source under ``kernels/csrc`` (default pca_project)
    --builds N      fresh builds (default 24)
    --jobs J        builds run at once (default 1: one at a time;
                    ``build_all`` starts every source's nvcc together)
    --out DIR       write ``summary.json`` and one ``ptx_<hash>.ptx`` a
                    distinct PTX text there (default: nothing written)

Prints one line a build and a summary; exits non-zero if any build's bill
differs from the baseline's.  Needs the CUDA toolkit (the card's machine).
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def fresh_build(source: Path, work: Path) -> dict:
    """One ``nvcc -keep`` of ``source`` into ``work``, its intermediate
    files there too: the build's seconds, its bill (``{function: {...}}``)
    and its PTX's hash."""
    from repro_torch.analysis import resources
    from repro_torch.kernels import build

    work.mkdir(parents=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS,
           "-keep", "-keep-dir", str(work),
           "-o", str(work / f"lib{source.stem}.so"), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    ptx = sorted(work.glob("*.ptx"))
    text = b"".join(p.read_bytes() for p in ptx)
    return dict(seconds=seconds,
                bill=resources.ptxas_functions(proc.stdout + proc.stderr),
                ptx_sha=hashlib.sha256(text).hexdigest()[:16], ptx=text)


def run(source: str = "pca_project", builds: int = 24, jobs: int = 1,
        out: Path | None = None, echo=print) -> dict:
    """``builds`` fresh builds of ``source``, ``jobs`` at a time; returns
    the summary (each distinct bill and PTX text with its count, and the
    builds that differ from the baseline)."""
    from repro_torch.analysis import resources
    from repro_torch.kernels import build

    src = build.CSRC / f"{source}.cu"
    want = json.loads(resources.BASELINE.read_text())["build"][source]
    records = []
    with tempfile.TemporaryDirectory(prefix="fresh_builds_") as tmp, \
            concurrent.futures.ThreadPoolExecutor(jobs) as pool:
        futs = [pool.submit(fresh_build, src, Path(tmp) / f"b{i:03d}")
                for i in range(builds)]
        for i, fut in enumerate(futs):
            rec = fut.result()
            rec["diff"] = resources.record_diff(rec["bill"], want)
            records.append(rec)
            echo(f"build {i:3d}: {rec['seconds']:6.1f} s, PTX "
                 f"{rec['ptx_sha']}, bill " + (f"differs: {rec['diff']}"
                                               if rec["diff"] else
                                               "== baseline"))
    bills = collections.Counter(json.dumps(r["bill"], sort_keys=True)
                                for r in records)
    ptx = collections.Counter(r["ptx_sha"] for r in records)
    summary = dict(
        source=str(src), builds=builds, jobs=jobs,
        flags=build.NVCC_FLAGS, equal_to_baseline=sum(
            not r["diff"] for r in records),
        distinct_bills=len(bills), distinct_ptx=dict(ptx),
        differing=[dict(build=i, ptx=r["ptx_sha"], diff=r["diff"])
                   for i, r in enumerate(records) if r["diff"]])
    echo(f"{source}: {summary['equal_to_baseline']}/{builds} bills == the "
         f"baseline ({jobs} at a time); {len(bills)} distinct bills, "
         f"{len(ptx)} distinct PTX texts {dict(ptx)}")
    if out is not None:
        out = Path(out)
        out.mkdir(parents=True, exist_ok=True)
        seen = set()
        for r in records:
            if r["ptx_sha"] not in seen:
                seen.add(r["ptx_sha"])
                (out / f"ptx_{r['ptx_sha']}.ptx").write_bytes(r["ptx"])
        (out / "summary.json").write_text(json.dumps(summary, indent=1))
    return summary


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.fresh_builds")
    ap.add_argument("--source", default="pca_project")
    ap.add_argument("--builds", type=int, default=24)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    summary = run(args.source, args.builds, args.jobs, args.out)
    return 0 if summary["equal_to_baseline"] == args.builds else 1


if __name__ == "__main__":
    sys.exit(main())
