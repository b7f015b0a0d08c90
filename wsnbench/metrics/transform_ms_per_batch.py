"""Device milliseconds of the operations ``transform_step`` launched (the
device extent of the harness's ``wsnbench.transform`` span), per batch
the trace caught."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device_spans.get("wsnbench.transform"):
        return None
    ops = tr.in_device_span("wsnbench.transform")
    if not ops:
        return None
    spans = len(tr.device_spans["wsnbench.transform"])
    return sum(e - s for s, e, _ in ops) / 1e3 / spans
