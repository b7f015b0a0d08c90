"""The port's kernel launches in the window (``ops.LAUNCHES``) per chunk
of K rounds streamed."""


def read(ctx):
    chunks = ctx.record.get("chunks")
    if not chunks:
        return None
    n = sum(v for k, v in ctx.counters.items() if k.startswith("launches."))
    return n / chunks
