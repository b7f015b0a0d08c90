"""The program's own spans in a traced window, reduced to what the span
metrics read.

The port names its layers with ``record_function`` ranges called
``repro_torch.<layer>.<part>``; the profiler puts each in the trace
twice, with its host extent (``Trace.spans``) and with the device extent
of the operations it launched (``Trace.device_spans``), on one clock with
the device's operations.  The profiler gives each kernel to the
innermost range open at its launch, so a range's device extent runs from
its first own kernel to its last: a range that launches nothing outside
the ranges nested in it has none.  :func:`summary` reduces a
:class:`Trace` once (and caches the result on it):

* a span's device busy time: the window's busy time (the union of the
  device intervals) inside the union of its device extents;
* a span's idle time: the window's idle time (busy's complement) that
  falls inside its host extent and inside no span nested in it, i.e. each
  instant of idle goes to the innermost program span the host was in, so
  a gap that two sibling spans overlap is split by their overlaps; idle
  under no program span is kept apart;
* coverage: the share of the busy time inside some program span's device
  extent.

Only spans that lie wholly inside the window are counted.  Every pass is
a sort and a linear sweep.  The first reduction of a trace prints one
table on standard error."""

from __future__ import annotations

import dataclasses
import sys

PREFIX = "repro_torch."
HARNESS = "wsnbench."
WINDOW = "wsnbench.traced"
NO_SPAN = "(no program span)"
TITLE = "program spans of the traced window (repro_torch.*):"


@dataclasses.dataclass
class SpanStats:
    count: int = 0            # host extents wholly inside the window
    extents: int = 0          # device extents wholly inside the window
    host_ms: float = 0.0      # the host extents' total
    busy_ms: float = 0.0      # device busy inside the device extents
    idle_ms: float = 0.0      # device idle attributed to the span


@dataclasses.dataclass
class Summary:
    spans: dict               # program span name -> SpanStats
    no_span_idle_ms: float
    busy_ms: float
    idle_ms: float
    coverage: float | None    # share of busy time in program extents
    harness: dict             # harness span name -> (count, host mean ms)


def inside(ivs, w0: float, w1: float) -> list:
    """The intervals of ``ivs`` that lie wholly inside [w0, w1]."""
    return [(s, e) for s, e in ivs if w0 <= s and e <= w1]


def union(ivs) -> list:
    """Sorted, merged intervals."""
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a: list, b: list) -> float:
    """The total overlap of two sorted lists of disjoint intervals."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def innermost(spans: list) -> list:
    """``spans`` (start, end, name), nested as ranges of one thread are,
    cut into disjoint (start, end, name) pieces, each named by the
    innermost span open over it; time under no span is left out."""
    out, stack, t = [], [], None

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))

    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, name = stack.pop()
            emit(t, end, name)
            t = max(t, end)
        if stack:
            emit(t, s, stack[-1][1])
        stack.append((e, n))
        t = s
    while stack:
        end, name = stack.pop()
        emit(t, end, name)
        t = max(t, end)
    return out


def attribute(gaps: list, pieces: list) -> tuple[dict, float]:
    """Idle time by the piece it falls in: ``gaps`` and ``pieces`` sorted
    and disjoint; returns ({name: us}, us under no piece)."""
    by = {}
    covered = 0.0
    i = j = 0
    while i < len(gaps) and j < len(pieces):
        (a, b), (s, e, n) = gaps[i], pieces[j]
        lo, hi = max(a, s), min(b, e)
        if hi > lo:
            by[n] = by.get(n, 0.0) + hi - lo
            covered += hi - lo
        if b < e:
            i += 1
        else:
            j += 1
    return by, sum(b - a for a, b in gaps) - covered


def _reduce(tr) -> Summary:
    w0, w1 = tr.window
    busy = tr.busy_intervals()
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    stats, host, dev_all = {}, [], []
    for name, ivs in tr.spans.items():
        if not name.startswith(PREFIX):
            continue
        ivs = inside(ivs, w0, w1)
        st = stats.setdefault(name, SpanStats())
        st.count = len(ivs)
        st.host_ms = sum(e - s for s, e in ivs) / 1e3
        host += [(s, e, name) for s, e in ivs]
    for name, ivs in tr.device_spans.items():
        if not name.startswith(PREFIX):
            continue
        ivs = inside(ivs, w0, w1)
        st = stats.setdefault(name, SpanStats())
        st.extents = len(ivs)
        st.busy_ms = overlap(busy, union(ivs)) / 1e3
        dev_all += ivs
    by, none = attribute(gaps, innermost(host))
    for name, us in by.items():
        stats[name].idle_ms = us / 1e3
    busy_us = sum(e - s for s, e in busy)
    harness = {}
    for name, ivs in tr.spans.items():
        if name.startswith(HARNESS) and name != WINDOW:
            ivs = inside(ivs, w0, w1)
            if ivs:
                harness[name] = (len(ivs),
                                 sum(e - s for s, e in ivs) / 1e3 / len(ivs))
    return Summary(
        spans=stats, no_span_idle_ms=none / 1e3, busy_ms=busy_us / 1e3,
        idle_ms=sum(b - a for a, b in gaps) / 1e3,
        coverage=(overlap(busy, union(dev_all)) / busy_us if busy_us
                  else None),
        harness=harness)


def table(sm: Summary) -> str:
    """The summary as lines of text."""
    rows = [f"{'span':36s} {'count':>7s} {'host ms':>11s} "
            f"{'busy ms':>11s} {'idle ms':>10s}"]
    for name in sorted(sm.spans):
        st = sm.spans[name]
        rows.append(f"{name:36s} {st.count:7d} {st.host_ms:11.3f} "
                    f"{st.busy_ms:11.3f} {st.idle_ms:10.3f}")
    rows.append(f"{NO_SPAN:36s} {'':7s} {'':11s} {'':11s} "
                f"{sm.no_span_idle_ms:10.3f}")
    cov = ("none" if sm.coverage is None
           else f"{100.0 * sm.coverage:.3f}%")
    rows.append(f"window: busy {sm.busy_ms:.3f} ms, idle {sm.idle_ms:.3f} "
                f"ms; coverage of busy by program spans {cov}")
    for name, (n, mean) in sorted(sm.harness.items()):
        rows.append(f"harness span {name}: {n} in the window, host mean "
                    f"{mean:.4f} ms")
    return "\n".join(rows)


def summary(tr) -> Summary | None:
    """The program spans of the trace ``tr`` (None without a trace);
    reduced once per trace, the table printed on standard error then."""
    if tr is None:
        return None
    sm = getattr(tr, "_program_spans", None)
    if sm is None:
        sm = _reduce(tr)
        tr._program_spans = sm
        print(TITLE + "\n" + table(sm), file=sys.stderr, flush=True)
    return sm


def busy_per(tr, name: str, per: str | None = None):
    """The device busy ms of the span ``name`` over the count of the span
    ``per`` (default: ``name``); None without a trace, without either
    span, or without the span's device extents."""
    sm = summary(tr)
    if sm is None:
        return None
    st, div = sm.spans.get(name), sm.spans.get(per or name)
    if st is None or div is None or not st.extents or not div.count:
        return None
    return st.busy_ms / div.count
