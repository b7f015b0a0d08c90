"""Device milliseconds of the scheduler's decision (the program's span
``repro_torch.chunk.decide``: the drift probe, the refresh computed for
every slot, its ``eigh``, the post-refresh probe, the selects, the round
bill), the busy time inside its device extents, per chunk the trace
caught."""

from wsnbench.spans import busy_per


def read(ctx):
    return busy_per(ctx.trace, "repro_torch.chunk.decide")
