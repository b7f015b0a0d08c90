"""Copy of ``repro.core.faults`` for the PyTorch port
(held equal to it by tests/test_torch_streaming.py).

Fault models for the WSN simulation: lossy links, node churn, dropout.

The paper's aggregation-service framing (Sec. 2.1) assumes every D/A/F
packet arrives.  Real deployments do not: the Intel-Berkeley trace the paper
compresses is full of holes, and the faulty-sensor literature (Gupchup et
al.; Johard et al., PAPERS.md) treats packet loss and node death as the
normal operating regime.  This module is the single source of truth for the
three fault classes the reproduction simulates:

* **per-link packet loss** — each transmission on a radio link independently
  fails with probability ``link_loss``; senders retransmit up to
  ``max_retries`` times (per-hop ARQ, data packets counted, acks free);
* **node churn** — a :class:`NodeChurn` schedule of (round, node) deaths and
  revivals, materialized as a per-round boolean liveness matrix; dead nodes
  neither measure nor route (routing-tree repair:
  :func:`repro.core.topology.repair_tree`);
* **measurement dropout** — individual sensor readings missing at a given
  rate (a flaky ADC rather than a dead mote), masking single (epoch, sensor)
  entries of a measurement block.

Everything is driven by ``numpy.random.Generator`` streams seeded by the
caller, so a fault schedule is a pure function of its seed — the property
the engine-determinism test (tests/test_streaming.py) and the differential
tests (tests/test_faults.py) rely on.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

__all__ = ["FaultModel", "NodeChurn", "expected_transmissions",
           "death_wave", "dropout_mask"]


def expected_transmissions(link_loss: float, max_retries: int) -> float:
    """Mean transmissions per packet under per-hop ARQ with capped retries.

    Attempt k+1 happens iff the first k attempts all failed, so
    ``E = sum_{k=0}^{max_retries} link_loss^k = (1 - loss^(r+1)) / (1 - loss)``.
    This is the factor by which a lossy deployment's *booked* communication
    exceeds the reliable Table-1 figure (used by
    :func:`repro.core.costs.lossy_round_cost`).
    """
    if not 0.0 <= link_loss < 1.0:
        raise ValueError(f"link_loss must be in [0, 1), got {link_loss}")
    if link_loss == 0.0:
        return 1.0
    return float((1.0 - link_loss ** (max_retries + 1)) / (1.0 - link_loss))


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Per-link Bernoulli loss + retransmission policy + measurement dropout.

    ``link_loss`` is the per-transmission failure probability of one radio
    hop; ``max_retries`` caps retransmissions (so a packet is dropped for
    good with probability ``link_loss**(max_retries+1)``); ``dropout`` is the
    per-(epoch, sensor) probability that a measurement is missing.
    """

    link_loss: float = 0.0
    max_retries: int = 3
    dropout: float = 0.0

    def __post_init__(self) -> None:
        if not 0.0 <= self.link_loss < 1.0:
            raise ValueError(f"link_loss must be in [0, 1), got {self.link_loss}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")

    @property
    def delivery_rate(self) -> float:
        """Probability a packet survives one hop within the retry budget."""
        return 1.0 - self.link_loss ** (self.max_retries + 1)

    def expected_transmissions(self) -> float:
        return expected_transmissions(self.link_loss, self.max_retries)

    def transmit(self, rng: np.random.Generator) -> tuple[bool, int]:
        """One hop: returns (delivered, attempts used).

        At ``link_loss == 0`` no randomness is consumed, so the zero-loss
        path is bit-identical to the reliable simulator (the differential
        test in tests/test_faults.py).
        """
        if self.link_loss == 0.0:
            return True, 1
        for attempt in range(1, self.max_retries + 2):
            if rng.random() >= self.link_loss:
                return True, attempt
        return False, self.max_retries + 1


@dataclasses.dataclass(frozen=True)
class NodeChurn:
    """Death/revival schedule: node ``i`` flips state at the listed round.

    ``deaths``/``revivals`` are (round, node) pairs; a node may die and
    revive repeatedly (battery swap).  Rounds are the streaming subsystem's
    epoch-synchronous unit (DESIGN.md Sec. 8.1).
    """

    deaths: tuple[tuple[int, int], ...] = ()
    revivals: tuple[tuple[int, int], ...] = ()

    def liveness(self, p: int, n_rounds: int) -> np.ndarray:
        """(n_rounds, p) boolean liveness matrix; all-alive before round 0."""
        alive = np.ones(p, dtype=bool)
        events: dict[int, list[tuple[int, bool]]] = {}
        for r, node in self.deaths:
            events.setdefault(r, []).append((node, False))
        for r, node in self.revivals:
            events.setdefault(r, []).append((node, True))
        out = np.empty((n_rounds, p), dtype=bool)
        for r in range(n_rounds):
            for node, state in events.get(r, ()):
                alive[node] = state
            out[r] = alive
        return out


def death_wave(rng: np.random.Generator, p: int, *, round: int,
               fraction: float, spare: Iterable[int] = (),
               revive_round: int | None = None) -> NodeChurn:
    """A correlated failure: ``fraction`` of the nodes die at ``round``.

    ``spare`` nodes (typically the routing root) never die.  If
    ``revive_round`` is given the wave's victims all come back then —
    the battery-swap scenario of examples/faulty_fleet.py.
    """
    spare_set = set(int(s) for s in spare)
    candidates = np.array([i for i in range(p) if i not in spare_set])
    n_dead = min(int(np.ceil(fraction * p)), candidates.size)
    victims = rng.choice(candidates, size=n_dead, replace=False)
    deaths = tuple((round, int(v)) for v in np.sort(victims))
    revivals = ()
    if revive_round is not None:
        if revive_round <= round:
            raise ValueError("revive_round must come after the wave")
        revivals = tuple((revive_round, int(v)) for v in np.sort(victims))
    return NodeChurn(deaths=deaths, revivals=revivals)


def dropout_mask(rng: np.random.Generator, shape: tuple[int, ...],
                 dropout: float) -> np.ndarray:
    """Boolean keep-mask for measurement dropout (True = reading present)."""
    if dropout == 0.0:
        return np.ones(shape, dtype=bool)
    return rng.random(shape) >= dropout
