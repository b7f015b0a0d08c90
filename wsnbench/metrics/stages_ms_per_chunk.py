"""Device milliseconds of the stages against the post-decision basis
(the program's span ``repro_torch.chunk.stages``: the recompute for every
slot and the per-slot picks), per chunk the trace caught."""

from wsnbench.spans import busy_per


def read(ctx):
    return busy_per(ctx.trace, "repro_torch.chunk.stages",
                    per="repro_torch.chunk.decide")
