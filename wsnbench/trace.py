"""The device trace of a measured window, taken with ``torch.profiler``
and reduced to what the per-layer metrics read.

:class:`Tracer` runs the profiler over the part of the window named by
the traffic's ``trace_seconds``; :func:`reduce` turns the exported trace
into a :class:`Trace`: every device operation (kernels, copies, sets)
with its interval, the harness's spans on the host and on the device,
and the host's operations, from which the busy time (the union of the
device intervals, not their sum), the longest operations and the longest
idle gaps are read."""

from __future__ import annotations

import dataclasses
import heapq
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    window: tuple[float, float]           # the traced window, us
    device: list                          # (start, end, name) device ops
    spans: dict                           # host span name -> [(start, end)]
    device_spans: dict                    # device span name -> [(s, e)]
    host: list                            # (start, end, name) host ops

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device intervals inside the window, merged."""
        w0, w1 = self.window
        iv = sorted((max(s, w0), min(e, w1)) for s, e, _ in self.device
                    if e > w0 and s < w1)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernels(self, *names: str) -> list:
        """The device operations whose name holds any of ``names``."""
        return [(s, e, n) for s, e, n in self.device
                if any(k in n for k in names)]

    def in_device_span(self, span: str) -> list:
        """The device operations inside the device extent of ``span``."""
        iv = self.device_spans.get(span, [])
        return [(s, e, n) for s, e, n in self.device
                if any(a <= s and e <= b for a, b in iv)]

    def top_ops(self, k: int = 10) -> list:
        tot = defaultdict(float)
        for s, e, n in self.device:
            tot[short(n)] += (e - s) / 1e6
        return sorted(tot.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device time grouped by the host operation that overlapped
        each gap the most (the outermost of equals): one sweep over the
        gaps and the host operations, both in time order."""
        busy = self.busy_intervals()
        w0, w1 = self.window
        edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host)
        active, j = [], 0                 # heap of (end, start, name)
        tot = defaultdict(float)
        for a, b in gaps:
            while j < len(host) and host[j][0] < b:
                s, e, n = host[j]
                heapq.heappush(active, (e, s, n))
                j += 1
            while active and active[0][0] <= a:
                heapq.heappop(active)
            best, start, name = 0.0, 0.0, "host: no traced operation"
            for e, s, n in active:
                ov = min(b, e) - max(a, s)
                if ov > best or (ov == best and s < start):
                    best, start, name = ov, s, n
            tot[short(name)] += (b - a) / 1e6
        return sorted(tot.items(), key=lambda kv: -kv[1])[:k]


def short(name: str) -> str:
    """A kernel's or operation's name without its argument list."""
    head = name.split("(")[0]
    return head[:96]


def reduce(events: list, window_span: str) -> Trace:
    """A :class:`Trace` of chrome-trace ``events``; the window is the host
    extent of the span ``window_span``."""
    device, host = [], []
    spans, dspans = defaultdict(list), defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", ""))
        s = float(e["ts"])
        iv = (s, s + float(e.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            device.append(iv + (e.get("name", cat),))
        elif cat == "user_annotation":
            spans[e["name"]].append(iv)
        elif cat == "gpu_user_annotation":
            dspans[e["name"]].append(iv)
        elif cat in HOST_CATS:
            host.append(iv + (e.get("name", cat),))
    win = spans.get(window_span)
    if not win:
        raise RuntimeError(f"the trace holds no span {window_span!r}")
    return Trace(window=(min(a for a, _ in win), max(b for _, b in win)),
                 device=device, spans=dict(spans), device_spans=dict(dspans),
                 host=host)


class Tracer:
    """``torch.profiler`` over a window: :meth:`start` and :meth:`stop`
    around it; :meth:`result` exports the trace into a temporary
    directory (under ``TMPDIR``), reads it and removes it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.running = False

    def start(self):
        self._prof.start()
        self.running = True

    def stop(self):
        if self.running:
            self._prof.stop()
            self.running = False

    def result(self, window_span: str) -> Trace:
        with tempfile.TemporaryDirectory(prefix="wsnbench-trace-") as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return reduce(events, window_span)
