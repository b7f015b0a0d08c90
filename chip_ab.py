#!/usr/bin/env python3
"""Run chip_smoke.py in two source trees, alternated, and tabulate the rates.

    python3 chip_ab.py BASE_TREE [--change TREE] [--order bccb] [--out DIR]
    python3 chip_ab.py BASE_TREE --fold [--order bccb] [--out DIR]
    python3 chip_ab.py BASE_TREE --product [--order bccb] [--out DIR]

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

With ``--fold`` each run is instead the band folds' probe of its tree
(:func:`fold_probe`, a few seconds after the build, in a process of its
own): kernels 1 (fp32 and bf16 tiles), 2, 3, 6, 7 and 7 with a dropout
mask at the serving slice, and kernel 6 at the paper pipeline's two
one-slot batches (the Berkeley fit's and wsn-1m's), on inputs drawn from
one seed on the card; at those two batches also ``banded_update``'s fold,
the delta added to a band and, in a tree that has it, kernel 6's
accumulating form (``6 <batch> acc``, whose digest is the two steps').
The table gives each call's ms (CUDA events) and device ms
(torch.profiler), and whether every output of a call has the same bits
in every run of both trees (a SHA-256 of its bytes), beside torch.bmm's
dense product at the Berkeley batch; each run's JSON also holds the
device microseconds a call of each kernel it launched.

With ``--product`` each run is kernel 11's probe (:func:`product_probe`)
in the same way: the banded C v at its three rows (the Berkeley fit's
one slot, wsn-1m's one slot, the refresh's 256-slot band), beside
torch.bmm on the dense matrix at Berkeley's and the refresh's.
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


def _digest(out) -> str:
    import hashlib
    import torch
    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(t, torch.Tensor):
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_calls(calls: dict) -> dict:
    """``{call: {ms, device_ms, digest, kernels_us}}`` for ``{call: (fn,
    iters)}``: the digest of the first call's output, then the events'
    ms a call over ``iters`` calls and torch.profiler's device ms a call
    over up to 50 (the device events' time over the calls it caught)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, (fn, iters) in calls.items():
        digest = _digest(fn())
        torch.cuda.synchronize()
        for _ in range(2):
            fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(min(iters, 50)):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type != DeviceType.CPU
                and getattr(e, "self_device_time_total", 0) > 0]
        caught = max((e.count for e in rows), default=min(iters, 50))
        out[name] = dict(ms=a.elapsed_time(b) / iters, device_ms=sum(
            e.self_device_time_total for e in rows) / 1e3 / caught,
            digest=digest, kernels_us={
                e.key[:60]: e.self_device_time_total / e.count for e in rows})
        print(f"   {name}: {out[name]}", flush=True)
    return out


def fold_probe(tree: Path) -> dict:
    """The band folds of ``tree``'s port at the shapes their paths give
    them: ``{call: {ms, device_ms, digest}}``.  Uses only the wrappers'
    public arguments, so any tree of the port runs it."""
    import torch
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, device=dev, generator=g)
    live = lambda *s: (torch.rand(s, device=dev, generator=g) > 0.05).float()
    S, K, n, p, h, q = 256, 8, 32, 1024, 128, 32
    x, m = rnd(S, K, n, p), live(S, K, p)
    w = torch.rand((S, K), device=dev, generator=g) * 0.5 + 0.5
    basis = torch.linalg.qr(rnd(S, p, q))[0]
    mean, il = 0.1 * rnd(S, p), torch.rand((S, q), device=dev,
                                           generator=g) + 0.5
    xr, lr, dr = rnd(S, n, p), live(S, p), live(S, n, p)
    xb, bb = ops.fused_tiles(x, "bf16"), ops.fused_tiles(basis, "bf16")
    xk, xw = rnd(1, 1440, 52), rnd(1, 256, 1 << 20)
    stages = dict(halfwidth=h, epsilon=2.5, with_compress=True,
                  with_monitor=True, mask=m)
    calls = {
        "1 fp32": (lambda: ops.fused_stream_update(
            x, w, basis, mean, il, **stages), 10),
        "1 bf16": (lambda: ops.fused_stream_update(
            xb, w, bb, mean, il, precision="bf16", **stages), 10),
        "2": (lambda: ops.cov_band_update_chunk_batched(x, w, h), 20),
        "3": (lambda: ops.cov_band_update_chunk_batched(x, w, h, mask=m),
              20),
        "6": (lambda: ops.cov_band_update_batched(xr, h), 50),
        "7": (lambda: ops.cov_band_update_batched(xr, h, mask=lr), 50),
        "7 drop": (lambda: ops.cov_band_update_batched(xr, h, mask=dr), 50),
        "6 Berkeley": (lambda: ops.cov_band_update_batched(xk, 15), 200),
        "bmm Berkeley": (lambda: torch.bmm(xk.transpose(1, 2), xk), 200),
        "6 wsn-1m": (lambda: ops.cov_band_update_batched(xw, h), 10),
    }
    # banded_update's fold at the two batches: the delta and the band's
    # add, and kernel 6 adding into the band where the tree has that form
    # (its digest equals the two steps' where the bits are kept)
    bk, bw = rnd(31, 52), rnd(2 * h + 1, 1 << 20)
    for name, xs, hs, band, iters in (("Berkeley", xk[0], 15, bk, 200),
                                      ("wsn-1m", xw[0], h, bw, 10)):
        calls[f"6 {name} band+delta"] = (
            lambda x=xs, k=hs, b=band: b + ops.cov_band_update(x, k), iters)
        if hasattr(ops, "cov_band_accumulate"):
            calls[f"6 {name} acc"] = (
                lambda x=xs, k=hs, b=band: ops.cov_band_accumulate(b, x, k),
                iters)
    return time_calls(calls)


# kernel 11's rows: (S, p, h, iters), its three paths' shapes
PRODUCT_ROWS = {"11 Berkeley": (1, 52, 15, 200),
                "11 wsn-1m": (1, 1 << 20, 128, 20),
                "11 refresh": (256, 1024, 128, 50)}


def product_probe(tree: Path) -> dict:
    """Kernel 11 of ``tree``'s port at its three rows
    (:data:`PRODUCT_ROWS`), on in-range bands and vectors drawn from one
    seed on the card: ``{call: {ms, device_ms, digest}}``, torch.bmm on
    the dense matrix beside it at Berkeley's and the refresh's."""
    import torch
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    calls = {}
    for row, (S, p, h, iters) in PRODUCT_ROWS.items():
        k = torch.arange(2 * h + 1, device=dev)[:, None]
        j = torch.arange(p, device=dev)[None, :] + k - h
        band = torch.randn((S, 2 * h + 1, p), device=dev, generator=g) \
            * ((j >= 0) & (j < p))
        v = torch.randn((S, p), device=dev, generator=g)
        calls[row] = (lambda b=band, x=v: ops.banded_matvec(b, x), iters)
        if p <= 4096:
            dense = torch.zeros((S, p, p), device=dev)
            i = torch.arange(p, device=dev)[None, :].expand_as(j)
            inside = (j >= 0) & (j < p)
            for s in range(S):
                dense[s, i[inside], j[inside]] = band[s][inside]
            calls[f"bmm {row[3:]}"] = (
                lambda d=dense, x=v: torch.bmm(d, x[..., None]), iters)
            del dense
    return time_calls(calls)


def fold_table(runs: list) -> dict:
    """``{call: row}`` over the probe's runs ``[(side, {call: {ms,
    device_ms, digest}})]``: each side's ms and device ms in run order,
    whether the call's output had the same bits in every run of both
    trees, and in every run of the change."""
    table = {}
    for call in dict.fromkeys(k for _, r in runs for k in r):
        row = {f"{name} {key}": [r[call][key] for side, r in runs
                                 if side == name and call in r]
               for name in ("base", "change") for key in ("ms", "device_ms")}
        row["same bits"] = len({r[call]["digest"] for _, r in runs
                                if call in r}) == 1
        row["change repeats its bits"] = len({
            r[call]["digest"] for side, r in runs
            if side == "change" and call in r}) == 1
        table[call] = row
    return table


def probe_main(args, trees, names, out_dir, kind) -> int:
    """Each run of the order is ``kind``'s probe ("fold" or "product") of
    its tree in a process of its own; the table of :func:`fold_table`."""
    runs, failed = [], False
    for i, side in enumerate(args.order, 1):
        save = out_dir / f"{i}_{names[side]}.json"
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_ab.py"), str(trees[side]),
             f"--{kind}-probe", str(save)], capture_output=True, text=True,
            timeout=args.timeout)
        (out_dir / f"{i}_{names[side]}.log").write_text(proc.stdout
                                                        + proc.stderr)
        print(f"== run {i} {names[side]} ({trees[side]}): exit "
              f"{proc.returncode}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:])
            failed = True
            continue
        runs.append((names[side], json.loads(save.read_text())))
    table = fold_table(runs)
    for call, row in table.items():
        print(f"{call}: " + "; ".join(
            f"{k} " + (" / ".join(f"{v:.4f}" for v in vals)
                       if isinstance(vals, list) else str(vals))
            for k, vals in row.items()))
    (out_dir / "summary.json").write_text(json.dumps(
        {"order": args.order, "base": str(trees["b"]),
         "change": str(trees["c"]), kind: table}, indent=1))
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("--change", type=Path, default=ROOT)
    ap.add_argument("--order", default="bccb")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ab")
    ap.add_argument("--fold", action="store_true",
                    help="run the band folds' probe in each tree instead "
                         "of chip_smoke.py")
    ap.add_argument("--product", action="store_true",
                    help="run kernel 11's probe in each tree instead of "
                         "chip_smoke.py")
    for kind in ("fold", "product"):      # one run of a probe
        ap.add_argument(f"--{kind}-probe", type=Path, default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args()
    for kind, probe in (("fold", fold_probe), ("product", product_probe)):
        save = getattr(args, f"{kind}_probe")
        if save is not None:
            save.write_text(json.dumps(probe(args.base.resolve())))
            return 0
    trees = {"b": args.base.resolve(), "c": args.change.resolve()}
    if set(args.order) - set(trees):
        ap.error("--order takes only the letters b and c")
    for tree in trees.values():
        if not (tree / "chip_smoke.py").is_file():
            ap.error(f"{tree} holds no chip_smoke.py")
    out_dir = args.out.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    names = {"b": "base", "c": "change"}
    if args.fold or args.product:
        return probe_main(args, trees, names, out_dir,
                          "fold" if args.fold else "product")
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
