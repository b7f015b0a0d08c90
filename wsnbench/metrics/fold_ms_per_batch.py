"""Device milliseconds of ``cov_update_step`` (the program's span
``repro_torch.production.fold``: kernel 6, the band's add, the sums),
per batch the trace caught."""

from wsnbench.spans import busy_per


def read(ctx):
    return busy_per(ctx.trace, "repro_torch.production.fold")
