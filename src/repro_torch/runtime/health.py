"""Copy of ``repro.runtime.health`` for the PyTorch port (held equal to it by
tests/test_torch_streaming.py).

Runtime health: heartbeats, straggler detection, failure policy.

At 1000+ nodes the failure model is: slow hosts (stragglers), dead hosts,
and flaky steps.  The monitor consumes per-step heartbeats and produces
actions:

* ``straggler``  — step time above ``straggler_factor`` x rolling median:
  log + (policy) drop the host from the next data allocation / trigger
  checkpoint-and-reshard.
* ``stall``      — no heartbeat for ``stall_timeout``: the launcher should
  restart from the latest checkpoint (the Trainer's atomic checkpoints make
  this always safe).

The monitor is deliberately dependency-free and synchronous so it can run
inside the train loop of every host and in the external watchdog.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

__all__ = ["HealthMonitor", "StragglerPolicy"]


@dataclasses.dataclass
class StragglerPolicy:
    straggler_factor: float = 2.0      # x median step time
    window: int = 32                   # rolling window (steps)
    stall_timeout: float = 300.0       # seconds without heartbeat
    min_samples: int = 8


class HealthMonitor:
    def __init__(self, policy: StragglerPolicy | None = None,
                 on_straggler: Callable[[dict], None] | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy or StragglerPolicy()
        self.on_straggler = on_straggler
        self.clock = clock
        self.durations: deque[float] = deque(maxlen=self.policy.window)
        self.last_beat: float | None = None
        self.events: list[dict] = []

    def heartbeat(self, *, step: int, duration: float) -> None:
        self.last_beat = self.clock()
        if len(self.durations) >= self.policy.min_samples:
            med = sorted(self.durations)[len(self.durations) // 2]
            if duration > self.policy.straggler_factor * med:
                ev = {"kind": "straggler", "step": step,
                      "duration": duration, "median": med}
                self.events.append(ev)
                if self.on_straggler:
                    self.on_straggler(ev)
        self.durations.append(duration)

    def stalled(self) -> bool:
        if self.last_beat is None:
            return False
        return (self.clock() - self.last_beat) > self.policy.stall_timeout

    def straggler_count(self) -> int:
        return sum(1 for e in self.events if e["kind"] == "straggler")
