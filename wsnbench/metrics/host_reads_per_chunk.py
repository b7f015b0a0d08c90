"""The scheduler's counted host reads (the refresh's ``eigh`` check,
``power_iteration.HOST_READS["ortho_refresh_evals"]``) per chunk of K
rounds streamed in the window."""


def read(ctx):
    chunks = ctx.record.get("chunks")
    n = ctx.counters.get("host_reads.ortho_refresh_evals")
    return n / chunks if chunks and n is not None else None
