"""``python -m repro_torch.analysis.check`` — run every registered program
contract, the resource checks and the source lints; print one line a rule
(PASS or FAIL, with the budget and the count seen); exit non-zero on any
failure.

Options:
    --device cpu|cuda   where the contracts run (default cuda: the
                        engine's widths, plus the host syncs by call site
                        on the engine contracts and the card part of the
                        resource checks; raises where there is no card;
                        cpu: tiny sizes)
    --only SUBSTR       only the contracts whose id contains SUBSTR (the
                        resource checks and the lints still run)
    --json PATH         also write the rows as JSON
    --list              list the registered contracts and exit
    --bless-resources PATH
                        write the card's resource bill to PATH (on the
                        card only; commit it as
                        repro_torch/analysis/baselines/resources.json)
"""

from __future__ import annotations

import argparse
import json
import sys


def run_checks(device: str = "cuda", only: str | None = None,
               echo=print) -> list[dict]:
    """Every contract, resource check and lint on ``device`` (the card
    unless asked for the CPU: where there is no card it raises); returns
    the rows (``contract``, ``rule``, ``ok``, ``detail``), each echoed as
    a line."""
    from repro_torch.analysis import contracts, repolint, resources
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    rows: list[dict] = []

    def emit(res, flag=None):
        flag = flag or ("PASS" if res.ok else "FAIL")
        echo(f"[{flag}] {res.contract:<24s} {res.rule:<40s} {res.detail}")
        rows.append(dict(contract=res.contract, rule=res.rule, ok=res.ok,
                         detail=res.detail))

    echo("== program contracts " + "=" * 46)
    for res in contracts.check_all(only=only, device=dev):
        emit(res)
    echo("== resources " + "=" * 54)
    for res in resources.check_traffic(dev):
        emit(res)
    if dev.type == "cuda":
        for res in resources.check_card(dev):
            emit(res, "SKIP" if res.detail.startswith("skipped") else None)
    else:
        emit(contracts.RuleResult(
            "resources", "card", True,
            "skipped: --device cpu" if resources.have_toolkit()
            else "skipped: no CUDA toolkit"), "SKIP")
    echo("== repolint " + "=" * 55)
    findings = repolint.run_repolint()
    for f in findings:
        emit(contracts.RuleResult("repolint", f.rule, False,
                                  f"{f.file}:{f.line}: {f.message}"))
    for rule in repolint.RULES:
        if not any(f.rule == rule for f in findings):
            emit(contracts.RuleResult("repolint", rule, True,
                                      "0 findings"))
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.check")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--only", help="substring filter on contract ids")
    ap.add_argument("--json", dest="json_path",
                    help="write the rows to this path")
    ap.add_argument("--list", action="store_true",
                    help="list the registered contracts and exit")
    ap.add_argument("--bless-resources", metavar="PATH",
                    help="write the card's resource bill to PATH")
    args = ap.parse_args(argv)

    from repro_torch.analysis import contracts, resources
    if args.list:
        for cid, c in sorted(contracts.load_entry_points().items()):
            print(f"{cid:<24s} {c.where:<52s} {c.claim}")
        return 0
    if args.bless_resources:
        path = resources.bless(args.bless_resources, device=args.device)
        print(f"blessed the card's resource bill -> {path}")
        return 0

    rows = run_checks(args.device, args.only)
    if args.json_path:
        with open(args.json_path, "w") as fh:
            json.dump(rows, fh, indent=1)
    failed = [r for r in rows if not r["ok"]]
    print(f"== {'FAILED' if failed else 'OK'}: "
          f"{len(rows) - len(failed)}/{len(rows)} rules pass"
          + (f", {len(failed)} violation(s)" if failed else ""))
    if failed:
        print("violated: " + ", ".join(sorted(
            {f"{r['contract']}/{r['rule']}" for r in failed})))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
