"""Copy of ``repro.serve.queue`` for the PyTorch port (held equal to it by
tests/test_torch_streaming.py).

Priority admission queue for the streaming-PCA engine (DESIGN.md Sec. 17).

The queue is the front end of :class:`repro_torch.serve.engine.StreamingPCAEngine`:
every external :meth:`submit` lands here, and the engine's ``_admit`` drains
it into free device slots.  Three serving knobs live in the
:class:`QueuePolicy`:

* **priorities** — higher ``priority`` admits first; within a priority
  class the queue is strictly oldest-first (FIFO by arrival sequence), so
  admission order is a pure function of the arrival schedule.
* **per-tenant quotas** — ``max_slots_per_tenant`` caps how many device
  slots one tenant may hold concurrently; an over-quota tenant's requests
  are *skipped, not dropped* — they stay queued (in order) and admit as
  soon as one of the tenant's slots retires.  Johard et al.'s
  self-adaptive per-node encodings (PAPERS.md) motivate exactly this
  per-tenant admission dial.
* **backpressure** — ``capacity`` bounds the queue depth; a submit into a
  full queue is *rejected* (``submit`` returns ``False``, the
  ``rejected`` counter ticks) rather than buffered without bound.  The
  engine's own continuation re-queues (churn revivals) bypass the bound:
  they represent work already admitted once, so dropping them would lose
  accepted state.

Everything is host-side pure Python with no randomness: given the same
arrival schedule (submit calls interleaved with engine steps) the admission
sequence is bit-reproducible — the determinism-replay tests pin this.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Iterator, Mapping

__all__ = ["QueuePolicy", "QueuedRequest", "AdmissionQueue"]


@dataclasses.dataclass(frozen=True)
class QueuePolicy:
    """Admission-control knobs; the default is an unbounded plain FIFO
    (bit-compatible with the pre-queue engine's ``list`` semantics)."""

    capacity: int | None = None            # max queued entries; None = no bound
    max_slots_per_tenant: int | None = None  # concurrent-slot quota per tenant

    def __post_init__(self):
        if self.capacity is not None and self.capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {self.capacity}")
        if (self.max_slots_per_tenant is not None
                and self.max_slots_per_tenant < 1):
            raise ValueError("max_slots_per_tenant must be >= 1, got "
                             f"{self.max_slots_per_tenant}")


@dataclasses.dataclass(frozen=True, order=True)
class QueuedRequest:
    """One queue entry.  The sort key IS the admission order: higher
    priority first (negated), oldest arrival first within a priority."""

    sort_key: tuple[int, int] = dataclasses.field(repr=False)
    req: object = dataclasses.field(compare=False)
    priority: int = dataclasses.field(compare=False)
    tenant: object = dataclasses.field(compare=False)
    seq: int = dataclasses.field(compare=False)


class AdmissionQueue:
    """Bounded priority queue with per-tenant quota-aware draining."""

    def __init__(self, policy: QueuePolicy | None = None):
        self.policy = policy or QueuePolicy()
        self._entries: list[QueuedRequest] = []   # kept sorted by sort_key
        self._seq = 0                             # arrival counter (total order)
        self.rejected = 0                         # backpressure rejections
        self.submitted = 0                        # accepted submissions

    # -- producer side -------------------------------------------------------
    def submit(self, req, *, priority: int = 0, tenant=None,
               internal: bool = False) -> bool:
        """Enqueue ``req``; returns False (and counts a rejection) when the
        queue is at capacity.  ``internal`` marks engine-initiated
        continuation re-queues, which are exempt from the bound."""
        if (not internal and self.policy.capacity is not None
                and len(self._entries) >= self.policy.capacity):
            self.rejected += 1
            return False
        entry = QueuedRequest(sort_key=(-priority, self._seq), req=req,
                              priority=priority, tenant=tenant,
                              seq=self._seq)
        self._seq += 1
        bisect.insort(self._entries, entry)
        self.submitted += 1
        return True

    # -- consumer side (the engine's _admit) ---------------------------------
    def pop_admissible(self, tenant_load: Mapping | None = None
                       ) -> QueuedRequest | None:
        """Remove and return the highest-priority oldest entry whose tenant
        has spare quota under ``tenant_load`` (a ``{tenant: live-slot
        count}`` view of the engine's active slots).  Over-quota tenants'
        entries are skipped in place; returns None when nothing admits."""
        quota = self.policy.max_slots_per_tenant
        for i, entry in enumerate(self._entries):
            if (quota is not None and entry.tenant is not None
                    and tenant_load is not None
                    and tenant_load.get(entry.tenant, 0) >= quota):
                continue
            return self._entries.pop(i)
        return None

    # -- observability -------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        return bool(self._entries)

    def __iter__(self) -> Iterator[QueuedRequest]:
        return iter(list(self._entries))

    def depth_by_priority(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for e in self._entries:
            out[e.priority] = out.get(e.priority, 0) + 1
        return out
