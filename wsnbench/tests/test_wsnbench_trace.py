"""The trace's reduction: busy time is the union of the device intervals
inside the traced window, and each idle gap is named by the host
operation that overlaps it most."""

from __future__ import annotations

import pytest

from wsnbench.trace import reduce

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "wsnbench.traced",
     "ts": 0.0, "dur": 100.0},
    {"ph": "X", "cat": "kernel", "name": "void k1<float>(float*)",
     "ts": 10.0, "dur": 30.0},
    {"ph": "X", "cat": "kernel", "name": "void k2(float*)", "ts": 20.0,
     "dur": 30.0},                              # overlaps k1: counted once
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 90.0,
     "dur": 20.0},                              # clipped at the window
    {"ph": "X", "cat": "gpu_user_annotation", "name": "wsnbench.transform",
     "ts": 15.0, "dur": 40.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::linalg_eigh", "ts": 45.0,
     "dur": 50.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
     "ts": 60.0, "dur": 30.0},
    {"ph": "f", "cat": "ac2g", "name": "ac2g", "ts": 1.0},
]


def test_busy_is_the_union_inside_the_window():
    tr = reduce(EVENTS, "wsnbench.traced")
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx((50 - 10 + 100 - 90) * 1e-6)


def test_idle_gaps_and_operations():
    tr = reduce(EVENTS, "wsnbench.traced")
    gaps = dict(tr.idle_gaps())
    # 0-10 has no host operation; 50-90 lies under eigh (its sync is
    # shorter)
    assert gaps["aten::linalg_eigh"] == pytest.approx(40e-6)
    assert gaps["host: no traced operation"] == pytest.approx(10e-6)
    top = dict(tr.top_ops())
    assert top["void k1<float>"] == pytest.approx(30e-6)
    assert [n for _, _, n in tr.in_device_span("wsnbench.transform")] == [
        "void k2(float*)"]
    assert len(tr.kernels("k1", "k2")) == 2


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(RuntimeError):
        reduce(EVENTS[1:], "wsnbench.traced")
