"""Device milliseconds of the compressor's and the detector's books (the
program's span ``repro_torch.chunk.books``: the records, the bills, the
new state), per chunk the trace caught."""

from wsnbench.spans import busy_per


def read(ctx):
    return busy_per(ctx.trace, "repro_torch.chunk.books",
                    per="repro_torch.chunk.decide")
