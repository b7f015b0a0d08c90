"""Device milliseconds of each call's padding and stacking of its
chunks' outputs (the program's span ``repro_torch.fleet.stack``), per
chunk the trace caught (the decisions' span count)."""

from wsnbench.spans import busy_per


def read(ctx):
    return busy_per(ctx.trace, "repro_torch.fleet.stack",
                    per="repro_torch.chunk.decide")
