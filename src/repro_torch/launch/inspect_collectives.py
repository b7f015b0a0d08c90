"""Perf-debugging tool: the largest collectives of one dry-run cell, with
their kind, bytes, group size and the port's call site (counterpart of
``repro.launch.inspect_collectives``, which reads them from the HLO text;
the port takes them from a dry run as they are issued).

    python -m repro_torch.launch.inspect_collectives --arch llama3-405b \\
        --shape train_4k [--multipod] [--top 15]
"""

from __future__ import annotations

import argparse
import collections

from repro_torch.launch.collectives import ring_wire_bytes

__all__ = ["largest", "dump_largest", "main"]


def largest(meter, top: int = 15) -> list[dict]:
    """The collectives of a dry run's :class:`~repro_torch.launch.dryrun.
    Meter` grouped by (kind, bytes, group, call site), largest total wire
    bytes first."""
    rows = collections.defaultdict(lambda: {"count": 0, "wire_total": 0.0})
    for (kind, nbytes, g), site in zip(meter.issues, meter.issue_sites):
        r = rows[(kind, nbytes, g, site)]
        r["count"] += 1
        r["wire_total"] += ring_wire_bytes(kind, nbytes, g)
    out = [{"kind": k, "bytes": b, "group": g, "site": s, **v}
           for (k, b, g, s), v in rows.items()]
    out.sort(key=lambda r: -r["wire_total"])
    return out[:top]


def dump_largest(meter, top: int = 15) -> None:
    total = sum(ring_wire_bytes(*i) for i in meter.issues)
    print(f"total wire/dev: {total / 2**30:.3f} GiB "
          f"({len(meter.issues)} collectives)")
    for r in largest(meter, top):
        print(f"{r['wire_total'] / 2**30:9.3f} GiB  {r['kind']:<18} "
              f"x{r['count']:<5d} g={r['group']:<4d} "
              f"{r['bytes'] / 2**20:9.2f} MiB/op  {r['site']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.inspect_collectives")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--opt-level", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import _fake_cell
    _, meter = _fake_cell(args.arch, args.shape, args.multipod,
                          args.opt_level, sites=True)
    dump_largest(meter, args.top)


if __name__ == "__main__":
    main()
