"""The 95th percentile of every refit's time in the window, from its
dispatch to its basis on the card (host clock)."""

from wsnbench.harness import percentile


def read(ctx):
    lat = ctx.record.get("latencies_ms")
    return percentile(lat, 95.0) if lat else None
