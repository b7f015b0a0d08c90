"""Copy of ``repro.serve.telemetry`` for the PyTorch port (held equal to it by
tests/test_torch_streaming.py).

Structured serving telemetry: ring-buffer recorder + JSONL sink.

The engine's hot loop (DESIGN.md Sec. 17) emits one :class:`StepRecord`
per step and one event record per admission/retirement/rejection; the
:class:`TelemetryRecorder` keeps the most recent ``capacity`` of each in a
ring buffer (bounded memory for arbitrarily long serving runs) and can
mirror every record to a JSONL file as it arrives — the append-a-line-per-
step logging shape of the ``wandblog.py`` pattern the ROADMAP cites, with
the file as the sink instead of a tracking service.

Everything recorded is HOST-side (wall times from ``perf_counter``, host
counters, queue depths): recording never touches a device array, so the
recorder can sit inside the pipelined hot loop without adding a sync.  The
one exception is the per-slot Table-1 bill attached to retirement events —
the engine already pulls those scalars to host to build the
:class:`~repro_torch.serve.engine.StreamResult`, so telemetry reuses the pulled
values rather than causing its own transfer.

``summary()`` folds the ring into the serving headline numbers: p50/p99
step latency, mean staged-vs-compute overlap fraction, prestage hit rate,
throughput, admission/retirement totals.
"""

from __future__ import annotations

import collections
import dataclasses
import json
from typing import IO

import numpy as np

__all__ = ["StepRecord", "TelemetryRecorder"]


@dataclasses.dataclass(frozen=True)
class StepRecord:
    """One engine step, entirely host-observed.

    ``stage_s`` is the host staging work done during this step (buffer
    fill + owned-copy upload dispatch); ``overlap_s`` is the part of it
    that ran while the previous chunk's device compute was still in
    flight (the pipelined engine stages chunk t+1 after dispatching
    chunk t, so its whole staging cost overlaps; the synchronous engine
    stages before dispatch, so its overlap is 0 by construction).
    ``prestaged`` flags whether the chunk folded THIS step came from the
    previous step's staging (the steady-state pipelined case) or had to
    be staged inline (first step, or an admission/retirement changed the
    slot plan under the staged batch).
    """

    step: int                 # engine logical clock at this step
    wall_s: float             # whole-step wall time
    stage_s: float            # host staging work performed this step
    overlap_s: float          # staging time overlapped with device compute
    prestaged: bool           # chunk folded this step was staged last step
    live: int                 # active slots this step
    rounds: int               # measurement rounds folded this step
    queue_depth: int          # queue depth after admission
    admitted: int             # slots admitted this step
    retired: int              # slots retired this step

    @property
    def overlap_fraction(self) -> float:
        return self.overlap_s / self.wall_s if self.wall_s > 0 else 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = "step"
        d["overlap_fraction"] = self.overlap_fraction
        return d


class TelemetryRecorder:
    """Bounded ring of step/event records with an optional JSONL mirror."""

    def __init__(self, capacity: int = 4096,
                 jsonl_path: str | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.steps: collections.deque[StepRecord] = collections.deque(
            maxlen=capacity)
        self.events: collections.deque[dict] = collections.deque(
            maxlen=capacity)
        # lifetime totals survive ring eviction (the ring is a window,
        # the totals are the ledger)
        self.total_steps = 0
        self.total_rounds = 0
        self.total_admitted = 0
        self.total_retired = 0
        self.total_wall_s = 0.0
        self._sink: IO[str] | None = (
            open(jsonl_path, "a") if jsonl_path else None)

    # -- recording -----------------------------------------------------------
    def record_step(self, rec: StepRecord) -> None:
        self.steps.append(rec)
        self.total_steps += 1
        self.total_rounds += rec.rounds
        self.total_admitted += rec.admitted
        self.total_retired += rec.retired
        self.total_wall_s += rec.wall_s
        if self._sink is not None:
            json.dump(rec.to_json(), self._sink)
            self._sink.write("\n")

    def record_event(self, kind: str, **fields) -> None:
        """Admission / retirement / rejection events; retirement events
        carry the slot's pulled per-segment bill (``comm_packets`` etc.)."""
        rec = {"kind": kind, **fields}
        self.events.append(rec)
        if self._sink is not None:
            json.dump(rec, self._sink)
            self._sink.write("\n")

    # -- summaries -----------------------------------------------------------
    def step_latency_percentiles(self, qs=(50.0, 99.0)) -> dict[str, float]:
        """``{"p50": seconds, ...}`` over the ring window (empty → zeros)."""
        walls = np.asarray([r.wall_s for r in self.steps], np.float64)
        if walls.size == 0:
            return {f"p{q:g}": 0.0 for q in qs}
        return {f"p{q:g}": float(np.percentile(walls, q)) for q in qs}

    def mean_overlap_fraction(self) -> float:
        """Staged-vs-compute overlap over the ring, weighted by wall time
        (the fraction of serving time the host spent staging under an
        in-flight device chunk)."""
        wall = sum(r.wall_s for r in self.steps)
        if wall <= 0:
            return 0.0
        return sum(r.overlap_s for r in self.steps) / wall

    def prestage_hit_rate(self) -> float:
        """Fraction of non-idle steps that consumed a prestaged chunk."""
        folded = [r for r in self.steps if r.live > 0]
        if not folded:
            return 0.0
        return sum(1 for r in folded if r.prestaged) / len(folded)

    def summary(self) -> dict:
        pct = self.step_latency_percentiles()
        return {
            "steps": self.total_steps,
            "rounds": self.total_rounds,
            "admitted": self.total_admitted,
            "retired": self.total_retired,
            "wall_s": self.total_wall_s,
            "rounds_per_s": (self.total_rounds / self.total_wall_s
                             if self.total_wall_s > 0 else 0.0),
            "p50_step_s": pct["p50"],
            "p99_step_s": pct["p99"],
            "overlap_fraction": self.mean_overlap_fraction(),
            "prestage_hit_rate": self.prestage_hit_rate(),
        }

    def reset(self) -> None:
        """Clear the rings and lifetime totals (the JSONL sink, if any,
        keeps appending) — e.g. to drop warm-up/compile steps before a
        measured benchmark window."""
        self.steps.clear()
        self.events.clear()
        self.total_steps = 0
        self.total_rounds = 0
        self.total_admitted = 0
        self.total_retired = 0
        self.total_wall_s = 0.0

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None

    def __enter__(self) -> "TelemetryRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
