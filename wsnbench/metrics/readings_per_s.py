"""Sensor readings (one sensor, one epoch) folded, compressed or
monitored in the window, over the window's seconds (host clock, from the
first dispatch to the end of the synchronisation that closes it)."""


def read(ctx):
    r = ctx.record
    return r["readings"] / r["seconds"] if "readings" in r else None
