"""Milliseconds the card stood idle while the host was inside a step of
``orthogonal_iteration`` or its stopping test's host read (the program's
spans ``repro_torch.ortho.step`` and ``repro_torch.stop_test``), per step
the trace caught: the round trip of the stopping test."""

from wsnbench.spans import summary


def read(ctx):
    sm = summary(ctx.trace)
    if sm is None or not sm.busy_ms:      # no device operation traced
        return None
    step = sm.spans.get("repro_torch.ortho.step")
    if step is None or not step.count:
        return None
    stop = sm.spans.get("repro_torch.stop_test")
    return (step.idle_ms + (stop.idle_ms if stop else 0.0)) / step.count
