"""Kernel 6 (the round's band fold) on a flat-band batch, one slot: its
share of the roofline."""

from wsnbench.roofline import share


def read(ctx):
    c = ctx.cell.config
    return share(ctx, "band_round", ("band_round_kernel", "band_long_kernel"),
                 S=1, n=c["batch_epochs"], p=c["p"], h=c["halfwidth"])
