"""Milliseconds the card stood idle while the host was inside a chunk's
step (the program's spans ``repro_torch.chunk.fold``, ``.decide``,
``.stages`` and ``.books``; each instant of idle goes to the innermost
span the host was in): the host's dispatch and ``eigh``'s sync, per
chunk the trace caught."""

from wsnbench.spans import summary

PARTS = ("repro_torch.chunk.fold", "repro_torch.chunk.decide",
         "repro_torch.chunk.stages", "repro_torch.chunk.books")


def read(ctx):
    sm = summary(ctx.trace)
    if sm is None or not sm.busy_ms:      # no device operation traced
        return None
    decide = sm.spans.get("repro_torch.chunk.decide")
    if decide is None or not decide.count:
        return None
    return sum(sm.spans[p].idle_ms for p in PARTS
               if p in sm.spans) / decide.count
