"""Roofline report: aggregate dry-run JSONL records into the roofline table
(counterpart of ``repro.launch.roofline``).

Per (arch x shape x mesh):
  compute / memory / collective terms (seconds) at the H100 SXM5 80GB's
  datasheet rates, the dominant term, MODEL_FLOPS = 6 N D (train) or
  2 N_active D (inference) vs the dry run's counted FLOPs (useful-compute
  ratio), peak bytes per device vs the card's 80 GB.

The records may be the port's or the reference's: the keys are the same.

Usage:  python -m repro_torch.launch.roofline results/*.jsonl [--md]
"""

from __future__ import annotations

import argparse
import glob
import json
import sys

from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.configs.wsn_1m import CONFIG as WSN
from repro_torch.launch.collectives import HBM_BYTES

__all__ = ["model_flops", "n_chips", "load", "analyze", "main"]


def model_flops(arch: str, shape: str) -> float:
    """Analytic 'useful' FLOPs per step, whole job (all chips)."""
    if arch == "wsn-1m":
        p, h, q, n = WSN.p, WSN.halfwidth, WSN.q, WSN.batch_epochs
        nb = 2 * h + 1
        return {
            "cov_update": 2.0 * n * nb * p,
            "pim_block": 2.0 * nb * p * q + 4.0 * p * q * q,
            "pim_deflated": 2.0 * nb * p + 4.0 * p * (q - 1),
            "transform": 2.0 * n * p * q,
        }[shape]
    cfg = configs.get(arch)
    shp = SHAPES[shape]
    n_active = cfg.active_param_count()
    if shp.kind == "train":
        tokens = shp.global_batch * shp.seq_len
        return 6.0 * n_active * tokens
    if shp.kind == "prefill":
        tokens = shp.global_batch * shp.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shp.global_batch


def n_chips(mesh: str) -> int:
    return 512 if mesh == "2x16x16" else 256


def load(paths) -> list[dict]:
    recs = []
    for path in paths:
        with open(path) as f:
            for line in f:
                if line.strip():
                    recs.append(json.loads(line))
    # dedup on (arch, shape, mesh): keep the last record
    uniq = {}
    for r in recs:
        uniq[(r["arch"], r["shape"], r["mesh"])] = r
    return sorted(uniq.values(),
                  key=lambda r: (r["arch"], r["shape"], r["mesh"]))


def analyze(rec: dict) -> dict:
    from repro_torch.launch.analytic import cell_model
    chips = n_chips(rec["mesh"])
    rl = rec.get("roofline", {})
    cost = rec.get("cost", {})
    mf = model_flops(rec["arch"], rec["shape"])
    counted_total = cost.get("flops", 0.0) * chips

    model = cell_model(rec["arch"], rec["shape"], chips,
                       microbatches=rec.get("microbatches", 1))
    # the reference halves the all-reduce bytes here, undoing XLA CPU's
    # upcast of bf16 dot outputs to fp32; the port's collectives carry
    # the dtypes the step computes in, so its wire bytes stand as counted
    wire_per_dev = rec.get("collectives", {}).get("total_wire_bytes", 0.0)
    terms = model.terms(chips, wire_per_dev)
    useful = mf / model.flops_global if model.flops_global else float("nan")
    frac = terms["compute_s"] / terms["bound_s"] if terms["bound_s"] \
        else float("nan")
    peak = rec.get("memory", {}).get("peak_per_device", 0)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "ok": rec["ok"],
        "compute_s": terms["compute_s"], "memory_s": terms["memory_s"],
        "collective_s": terms["collective_s"],
        "dominant": terms["dominant"],
        "counted_compute_s": rl.get("compute_s"),
        "counted_memory_s": rl.get("memory_s"),
        "counted_collective_s": rl.get("collective_s"),
        "model_flops": mf, "counted_flops_total": counted_total,
        "useful_ratio": useful,
        "roofline_fraction": frac,
        "peak_gb": peak / 2 ** 30,
        "fits_h100": peak <= HBM_BYTES,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("paths", nargs="*", default=["results/dryrun_*.jsonl"])
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    paths = []
    for p in args.paths:
        paths.extend(glob.glob(p))
    if not paths:
        sys.exit("no dry-run result files found")
    rows = []
    for r in load(paths):
        if not r["ok"]:
            continue
        try:
            rows.append(analyze(r))
        except KeyError:          # no analytic model (wsn-1m hier_merge)
            print(f"no analytic model: {r['arch']} {r['shape']}",
                  file=sys.stderr)
    if args.mesh:
        rows = [r for r in rows if r["mesh"] == args.mesh]

    if args.md:
        print("| arch | shape | mesh | compute s | memory s | coll s |"
              " dominant | MODEL/analytic | comp/bound | peak GB |"
              " fits H100 |")
        print("|---|---|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                  f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
                  f"| {r['collective_s']:.3e} | {r['dominant']} "
                  f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} "
                  f"| {r['peak_gb']:.1f} | {'y' if r['fits_h100'] else 'N'} |")
    else:
        for r in rows:
            print(json.dumps(r))


if __name__ == "__main__":
    main()
