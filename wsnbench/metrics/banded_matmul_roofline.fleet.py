"""Kernel 10 (the banded product) at the fleet's refresh, every network
in one launch: its share of the roofline."""

from wsnbench.roofline import share


def read(ctx):
    c = ctx.cell.config
    return share(ctx, "banded_matmul", ("banded_matmul_kernel",),
                 S=c["n_regions"], p=c["region_p"], h=c["halfwidth"],
                 q=c["q"])
