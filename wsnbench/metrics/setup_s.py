"""Seconds from the start of the run's process to the window's first
dispatch: loading, the kernels' build or its cache, the data, the warm-up
(host clock)."""


def read(ctx):
    return ctx.setup_s
