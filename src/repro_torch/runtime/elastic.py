"""Copy of ``repro.runtime.elastic`` for the PyTorch port (held equal to it by
tests/test_torch_streaming.py).

Elastic rescale planning: choose a mesh for whatever devices survive.

When hosts die mid-run, the launcher restarts with fewer (or, after repair,
more) chips.  The planner picks the new (data, model) mesh factorization
under the constraints that (a) the model axis still fits TP divisibility for
the arch, (b) the global batch stays divisible, and the restore path
(repro.train.checkpoint.restore with new shardings) re-slices every array.
"""

from __future__ import annotations

import dataclasses

__all__ = ["plan_mesh", "RescalePlan"]


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    data: int
    model: int
    global_batch: int

    @property
    def n_devices(self) -> int:
        return self.data * self.model


def plan_mesh(n_devices: int, *, prefer_model: int, global_batch: int,
              max_model: int | None = None) -> RescalePlan:
    """Largest model axis <= prefer_model that divides n_devices, batch kept
    divisible by the data axis (batch is trimmed down if needed)."""
    max_model = max_model or prefer_model
    model = 1
    for m in range(min(prefer_model, max_model, n_devices), 0, -1):
        if n_devices % m == 0:
            model = m
            break
    data = n_devices // model
    gb = (global_batch // data) * data
    if gb == 0:
        gb = data
    return RescalePlan(data=data, model=model, global_batch=gb)
