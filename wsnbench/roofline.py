"""A kernel's share of its roofline in a traced window: the least time
the work model gives for one launch over the mean device time of the
launches the profiler caught."""

from __future__ import annotations

import sys

from wsnbench import harness, work


def share(ctx, kernel: str, names: tuple, **dims) -> float | None:
    """100 x bound / mean device time of the events named ``names`` (one
    event a launch of ``kernel``), or None when the trace caught none.
    Prints the bound, what sets it, the card's power limit and how many
    launches the profiler caught of those the program counted."""
    if ctx.trace is None:
        return None
    ev = ctx.trace.kernels(*names)
    if not ev:
        return None
    mean_ms = sum(e - s for s, e, _ in ev) / len(ev) / 1e3
    bound_ms, by = work.bound(*work.kernel_work(kernel, **dims))
    counted = ctx.traced_counters.get(f"launches.{kernel}")
    note = ("" if counted is None or counted == len(ev) else
            f"; the profiler caught {len(ev)} of {counted} launches")
    print(f"roofline {kernel} {dims}: bound {bound_ms:.6f} ms ({by}), "
          f"mean {mean_ms:.6f} ms over {len(ev)} events{note}; "
          f"{harness.power_limit()}", file=sys.stderr)
    return 100.0 * bound_ms / mean_ms
