"""Device milliseconds of one step of ``orthogonal_iteration`` (the
program's span ``repro_torch.ortho.step``: C V, the Gram matrix,
Cholesky, the solve, the sign and the update norm), per step the trace
caught."""

from wsnbench.spans import busy_per


def read(ctx):
    return busy_per(ctx.trace, "repro_torch.ortho.step")
