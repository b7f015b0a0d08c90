"""The program spans' reduction (``wsnbench.spans``) on synthetic chrome
events: device time inside a span's device extents, idle time given to
the innermost host span, spans cut by the window left out, and the span
metrics' readers."""

from __future__ import annotations

import time

import pytest

from wsnbench import harness, spans
from wsnbench.tests.tiny import tiny_cell
from wsnbench.trace import reduce

NEW = {"regions-fleet": ("decide_ms_per_chunk", "stages_ms_per_chunk",
                         "books_ms_per_chunk", "stack_ms_per_chunk",
                         "dispatch_idle_ms_per_chunk"),
       "flat-stream": ("fold_ms_per_batch",),
       "flat-refit": ("ortho_step_busy_ms", "ortho_step_idle_ms")}


def X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts),
            "dur": float(dur)}


def host(name, ts, dur):
    return X("user_annotation", name, ts, dur)


def dev(name, ts, dur):
    return X("gpu_user_annotation", name, ts, dur)


def kernel(ts, dur, name="k"):
    return X("kernel", name, ts, dur)


# a window of 0-100 us holding one chunk: decide (host 10-40) launches
# kernels that run at 14-20 and 35-45, its device extent 14-45; a span
# nested in it (host 12-18) launches the kernel at 20-30 (the profiler
# gives a kernel to the innermost range), device extent 20-30; the stages
# (host 40-60) launch a kernel at 50-70.  Idle: 0-14, 30-35, 45-50 and
# 70-98.
CHUNK = [
    host("wsnbench.traced", 0, 100),
    host("repro_torch.chunk.decide", 10, 30),
    host("repro_torch.inner", 12, 6),
    host("repro_torch.chunk.stages", 40, 20),
    dev("repro_torch.chunk.decide", 14, 31),
    dev("repro_torch.inner", 20, 10),
    dev("repro_torch.chunk.stages", 50, 20),
    kernel(14, 6), kernel(20, 10), kernel(35, 10), kernel(50, 20),
    # a span cut by the window's end, and its kernel: left out
    host("repro_torch.chunk.decide", 95, 10),
    dev("repro_torch.chunk.decide", 98, 4),
    kernel(98, 4),
]


def summary(events):
    return spans.summary(reduce(events, "wsnbench.traced"))


def test_device_time_inside_nested_extents_and_siblings_apart():
    sm = summary(CHUNK)
    d, s, i = (sm.spans[f"repro_torch.{n}"]
               for n in ("chunk.decide", "chunk.stages", "inner"))
    assert (d.count, d.extents) == (1, 1)          # the cut one left out
    assert d.busy_ms == pytest.approx(26e-3)       # 14-30 and 35-45
    assert i.busy_ms == pytest.approx(10e-3)       # nested: 20-30
    assert s.busy_ms == pytest.approx(20e-3)       # its sibling's apart
    assert d.host_ms == pytest.approx(30e-3)
    # busy 14-30, 35-45, 50-70 and the cut span's 98-100 of the window
    assert sm.busy_ms == pytest.approx(48e-3)
    assert sm.coverage == pytest.approx(46 / 48)


def test_idle_goes_to_the_innermost_host_span():
    sm = summary(CHUNK)
    d, s, i = (sm.spans[f"repro_torch.{n}"]
               for n in ("chunk.decide", "chunk.stages", "inner"))
    # idle 0-14: 0-10 no span, 10-12 decide, 12-14 inner; 30-35 decide;
    # 45-50 stages; 70-98 no span (the stages ended at 60)
    assert i.idle_ms == pytest.approx(2e-3)
    assert d.idle_ms == pytest.approx((2 + 5) * 1e-3)
    assert s.idle_ms == pytest.approx(5e-3)
    assert sm.no_span_idle_ms == pytest.approx((10 + 28) * 1e-3)
    assert sm.idle_ms == pytest.approx(52e-3)


def test_an_idle_gap_is_split_between_sibling_spans():
    ev = [host("wsnbench.traced", 0, 100),
          host("repro_torch.a", 0, 50), host("repro_torch.b", 50, 50),
          kernel(0, 40), kernel(70, 30)]
    sm = summary(ev)
    # the gap 40-70: 10 us under a, 20 us under b
    assert sm.spans["repro_torch.a"].idle_ms == pytest.approx(10e-3)
    assert sm.spans["repro_torch.b"].idle_ms == pytest.approx(20e-3)
    assert sm.no_span_idle_ms == pytest.approx(0.0)


def test_innermost_pieces_of_nested_spans():
    pieces = spans.innermost([(0, 100, "a"), (10, 20, "b"), (30, 60, "c"),
                              (40, 50, "d")])
    assert pieces == [(0, 10, "a"), (10, 20, "b"), (20, 30, "a"),
                      (30, 40, "c"), (40, 50, "d"), (50, 60, "c"),
                      (60, 100, "a")]


def test_the_table_is_printed_once_a_trace(capsys):
    tr = reduce(CHUNK, "wsnbench.traced")
    spans.summary(tr)
    spans.summary(tr)
    err = capsys.readouterr().err
    assert err.count(spans.TITLE) == 1
    assert "repro_torch.chunk.decide" in err and spans.NO_SPAN in err
    assert "coverage of busy by program spans 95.833%" in err
    assert "harness span wsnbench.traced" not in err   # the window itself


class _Ctx:
    def __init__(self, cell, trace, counters=None, record=None):
        self.cell, self.trace = cell, trace
        self.counters, self.record = counters or {}, record or {}


def _reader(cell, name):
    return harness.metric_reader(cell, name).read


@pytest.mark.parametrize("cell", list(NEW))
def test_readers_return_none_without_a_trace_or_their_span(cell):
    c = tiny_cell(cell)
    bare = reduce([host("wsnbench.traced", 0, 10), kernel(1, 2)],
                  "wsnbench.traced")
    for name in NEW[cell]:
        assert _reader(c, name)(_Ctx(c, None)) is None, name
        assert _reader(c, name)(_Ctx(c, bare)) is None, name


def _fleet_events(chunks=3):
    """Chunks of 10 us: fold 0-2, decide 2-6, stages 6-8, books 8-10 on
    the host; each span's kernel runs 1 us later for its host time less
    half a microsecond; one stack a call at the end."""
    ev = [host("wsnbench.traced", 0, 10 * chunks + 10)]
    parts = (("fold", 0, 2), ("decide", 2, 4), ("stages", 6, 2),
             ("books", 8, 2))
    for c in range(chunks):
        for part, t, d in parts:
            name = f"repro_torch.chunk.{part}"
            ev += [host(name, 10 * c + t, d),
                   dev(name, 10 * c + t + 1, d - 0.5),
                   kernel(10 * c + t + 1, d - 0.5)]
    s = 10 * chunks
    ev += [host("repro_torch.fleet.stack", s, 5),
           dev("repro_torch.fleet.stack", s + 1, 3), kernel(s + 1, 3)]
    return ev


def test_the_fleet_readers():
    c = tiny_cell("regions-fleet")
    ctx = _Ctx(c, reduce(_fleet_events(), "wsnbench.traced"),
               counters={"host_reads.ortho_refresh_evals": 24},
               record={"chunks": 24})
    assert _reader(c, "decide_ms_per_chunk")(ctx) == pytest.approx(3.5e-3)
    assert _reader(c, "stages_ms_per_chunk")(ctx) == pytest.approx(1.5e-3)
    assert _reader(c, "books_ms_per_chunk")(ctx) == pytest.approx(1.5e-3)
    assert _reader(c, "stack_ms_per_chunk")(ctx) == pytest.approx(1e-3)
    # each span leaves 0.5 us idle under itself; the first 1 us of the
    # window lies under the first fold
    idle = (4 * 0.5 * 3 + 0.5) / 3 * 1e-3
    assert _reader(c, "dispatch_idle_ms_per_chunk")(ctx) == pytest.approx(
        idle)
    assert _reader(c, "host_reads_per_chunk")(ctx) == 1.0
    none = _Ctx(c, None, counters={}, record={"chunks": 24})
    assert _reader(c, "host_reads_per_chunk")(none) is None


def test_the_refit_readers():
    """Two steps of 10 us on the host, their kernels 1 us in for 8 us,
    each followed by a stopping test of 4 us on the host."""
    ev = [host("wsnbench.traced", 0, 40), host("wsnbench.refit", 0, 30)]
    for t in (0, 14):
        ev += [host("repro_torch.ortho.step", t, 10),
               dev("repro_torch.ortho.step", t + 1, 8), kernel(t + 1, 8),
               host("repro_torch.stop_test", t + 10, 4)]
    c = tiny_cell("flat-refit")
    ctx = _Ctx(c, reduce(ev, "wsnbench.traced"))
    assert _reader(c, "ortho_step_busy_ms")(ctx) == pytest.approx(8e-3)
    # idle per step: 1 us at its start and 1 us at its end under the step,
    # 4 us under the stopping test
    assert _reader(c, "ortho_step_idle_ms")(ctx) == pytest.approx(6e-3)


def test_the_stream_readers():
    """The program's fold span inside the harness's: the profiler gives
    each kernel to the innermost range, so only the program's span has a
    device extent; the transform's harness span keeps its own."""
    ev = [host("wsnbench.traced", 0, 100)]
    for t in (0, 50):
        ev += [host("wsnbench.fold", t, 20),
               host("repro_torch.production.fold", t + 1, 18),
               dev("repro_torch.production.fold", t + 5, 20),
               kernel(t + 5, 15), kernel(t + 20, 5),
               host("wsnbench.transform", t + 21, 5),
               dev("wsnbench.transform", t + 25, 10),
               kernel(t + 25, 4), kernel(t + 29, 6)]
    c = tiny_cell("flat-stream")
    ctx = _Ctx(c, reduce(ev, "wsnbench.traced"))
    assert _reader(c, "fold_ms_per_batch")(ctx) == pytest.approx(20e-3)
    assert _reader(c, "transform_ms_per_batch")(ctx) == pytest.approx(
        10e-3)


def test_the_readers_are_fast_on_a_long_trace():
    """A refit trace's size: 2,400 steps, 24 kernels each."""
    ev = [host("wsnbench.traced", 0, 2400 * 30 + 10)]
    for k in range(2400):
        t = 30 * k
        ev += [host("repro_torch.ortho.step", t, 20),
               dev("repro_torch.ortho.step", t + 2, 24),
               host("repro_torch.stop_test", t + 20, 8)]
        ev += [kernel(t + 2 + j, 1) for j in range(24)]
    tr = reduce(ev, "wsnbench.traced")
    c = tiny_cell("flat-refit")
    t0 = time.perf_counter()
    for name in ("ortho_step_busy_ms", "ortho_step_idle_ms"):
        assert _reader(c, name)(_Ctx(c, tr)) is not None
    assert time.perf_counter() - t0 < 2.0
