"""Kernel 1 (the fused chunk kernel) at the fleet's chunk: its share of
the roofline."""

from wsnbench.roofline import share


def read(ctx):
    c = ctx.cell.config
    return share(ctx, "fused_stream", ("fused_stream_kernel",),
                 S=c["n_regions"], K=c["chunk_rounds"],
                 n=c["epochs_per_round"], p=c["region_p"],
                 h=c["halfwidth"], q=c["q"], mask=False)
