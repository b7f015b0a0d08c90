"""Copy of ``repro.core.faults.expected_transmissions`` (per-hop ARQ)."""

from __future__ import annotations

__all__ = ["expected_transmissions"]


def expected_transmissions(link_loss: float, max_retries: int) -> float:
    """Mean transmissions per packet under per-hop ARQ with capped retries.

    Attempt k+1 happens iff the first k attempts all failed, so
    ``E = sum_{k=0}^{max_retries} link_loss^k = (1 - loss^(r+1)) / (1 - loss)``.
    This is the factor by which a lossy deployment's *booked* communication
    exceeds the reliable Table-1 figure (used by
    :func:`repro_torch.core.costs.lossy_round_cost`).
    """
    if not 0.0 <= link_loss < 1.0:
        raise ValueError(f"link_loss must be in [0, 1), got {link_loss}")
    if link_loss == 0.0:
        return 1.0
    return float((1.0 - link_loss ** (max_retries + 1)) / (1.0 - link_loss))
