"""Kernel 10 (the banded product) on the flat band, one slot: its share
of the roofline."""

from wsnbench.roofline import share


def read(ctx):
    c = ctx.cell.config
    return share(ctx, "banded_matmul", ("banded_matmul_kernel",), S=1,
                 p=c["p"], h=c["halfwidth"], q=c["q"])
