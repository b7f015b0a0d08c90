"""The orthogonal iteration's counted host reads
(``power_iteration.HOST_READS``) per refit in the window."""


def read(ctx):
    refits = ctx.record.get("refits")
    n = ctx.counters.get("host_reads.orthogonal_iteration")
    return n / refits if refits and n is not None else None
