"""The region merge record of the two-level fleet (counterpart of
``repro.streaming.hierarchy.region_energies``); the merge itself
(``merge_fleet``) is not ported yet."""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.streaming.online_cov import (online_estimate,
                                              online_total_variance)

__all__ = ["region_energies"]


def region_energies(state, cw: torch.Tensor | None = None,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (..., q) live subspace energies ``diag(W^T C W)`` of a region's
    basis plus its trace partial — what a region head sends up; ``C W``
    is one banded-product launch on the band estimate, or ``cw`` where
    the caller has it already."""
    W = state.sched.W
    if cw is None:
        cw = ops.banded_matmul(online_estimate(state.cov), W)
    return (W * cw).sum(-2), online_total_variance(state.cov)
