"""Recompute scheduler: drift-triggered basis refreshes (counterpart of
``repro.streaming.scheduler``).

Every decision evaluates the retained fraction of the current basis
against the live covariance,

    rho(W, C) = trace(W^T C W) / trace(C),  drift = rho_at_last_refresh - rho,

and past the threshold (or on the first decision after warmup, or on
churn) recomputes the basis by a fixed-length blocked orthogonal iteration
warm-started from the stale basis.

The banded products ``C W`` (the drift probe, every orthogonal-iteration
step, the Rayleigh quotients and the post-refresh probe: 1 +
``refresh_iters`` + 2 per decision) go through the banded-product kernel
(:func:`repro_torch.kernels.ops.banded_matmul`) on the band estimate,
with the reference's arithmetic (``banded_matmul_ref``: the diagonals in
order); no dense (p, p) matrix is formed.  Cholesky, the triangular solve
and ``eigh`` are plain torch, as the reference leaves them to XLA.  Under
the fleet's slot axis the reference's ``lax.cond`` is a select: the
refresh is computed for every slot and chosen with ``torch.where``, with
no host sync.  fp32 matrix products run in full fp32 (TF32 is switched off
by :func:`repro_torch.streaming.driver.stream_init`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import costs
from repro_torch.core.power_iteration import HOST_READS, orthonormalize
from repro_torch.kernels import ops
from repro_torch.streaming.online_cov import (OnlineCovariance,
                                              online_estimate,
                                              online_total_variance)

__all__ = ["RecomputeScheduler", "SchedulerState", "retained_fraction",
           "ortho_refresh", "ortho_refresh_evals"]

# the functions of every decision (checked by repolint's host-pull rule)
HOT_PATHS = ("retained_fraction", "ortho_refresh_evals",
             "RecomputeScheduler.step")


def retained_fraction(band_est: torch.Tensor, W: torch.Tensor,
                      total_variance: torch.Tensor,
                      cw: torch.Tensor | None = None) -> torch.Tensor:
    """rho = trace(W^T C W) / trace(C) for an orthonormal basis W; ``cw``
    is ``C W`` if the caller has it already (no banded product then)."""
    if cw is None:
        cw = ops.banded_matmul(band_est, W)
    num = (W * cw).sum((-2, -1))
    return num / total_variance.clamp(min=1e-30)


def ortho_refresh_evals(band_est: torch.Tensor, W0: torch.Tensor,
                        iters: int, eps: float = 1e-8,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-length blocked orthogonal iteration warm-started from W0;
    returns the ordered basis and its Rayleigh quotients (descending).
    ``iters`` + 1 banded products."""
    V = orthonormalize(W0, W0.mT @ W0, eps)
    for _ in range(iters):
        CV = ops.banded_matmul(band_est, V)
        V = orthonormalize(CV, CV.mT @ CV, eps)
    H = V.transpose(-1, -2) @ ops.banded_matmul(band_est, V)
    # jnp.linalg.eigh symmetrizes its input; torch reads one triangle
    # (eigh checks its result on the host: one sync a decision, the fleet's,
    # counted in HOST_READS under this function's name)
    HOST_READS["ortho_refresh_evals"] += 1
    # repolint: allow-host-pull the refresh's one sync
    evals, U = torch.linalg.eigh(0.5 * (H + H.transpose(-1, -2)))
    # descending order (eigh returns ascending)
    return V @ U.flip(-1), evals.flip(-1)


def ortho_refresh(band_est: torch.Tensor, W0: torch.Tensor, iters: int,
                  eps: float = 1e-8) -> torch.Tensor:
    """Basis-only form of :func:`ortho_refresh_evals`."""
    return ortho_refresh_evals(band_est, W0, iters, eps)[0]


class SchedulerState(NamedTuple):
    W: torch.Tensor             # (..., p, q) current orthonormal basis
    rho_ref: torch.Tensor       # (...) retained fraction at last refresh
    refreshes: torch.Tensor     # (...) int32 refreshes triggered
    comm_packets: torch.Tensor  # (...) fp32 accumulated communication
    lam: torch.Tensor           # (..., q) per-component variance estimates


@dataclasses.dataclass(frozen=True)
class RecomputeScheduler:
    """Policy + cost parameters (see ``repro.streaming.scheduler``)."""

    q: int
    drift_threshold: float = 0.02
    refresh_iters: int = 8
    warmup_rounds: int = 10
    n_max: int = 8
    c_max: int = 4
    link_loss: float = 0.0
    max_retries: int = 3

    def init(self, W0: torch.Tensor) -> SchedulerState:
        """State around the initial orthonormal basis ``W0`` (..., p, q) —
        drawn by the caller (the reference's ``jax.random`` stream cannot
        be reproduced in torch)."""
        lead = W0.shape[:-2]
        kw = dict(device=W0.device, dtype=W0.dtype)
        return SchedulerState(
            W=W0,
            rho_ref=torch.zeros(lead, **kw),
            refreshes=torch.zeros(lead, device=W0.device, dtype=torch.int32),
            comm_packets=torch.zeros(lead, **kw),
            lam=torch.ones(lead + (self.q,), **kw),
        )

    def round_cost(self) -> float:
        return costs.lossy_round_cost(
            self.n_max, self.q, self.c_max,
            self.link_loss, self.max_retries).communication

    def refresh_cost(self, p: int) -> float:
        return costs.lossy_refresh_cost(
            p, self.q, self.n_max, self.c_max, self.refresh_iters,
            self.link_loss, self.max_retries).communication

    def step(self, state: SchedulerState, cov_state: OnlineCovariance,
             round_index: torch.Tensor, churn: torch.Tensor,
             ) -> tuple[SchedulerState, torch.Tensor, torch.Tensor]:
        """One decision per network; returns ``(new_state, rho,
        did_refresh)`` with ``rho`` the retained fraction before any
        refresh."""
        p = state.W.shape[-2]
        band_est = online_estimate(cov_state)
        total_var = online_total_variance(cov_state)
        rho = retained_fraction(band_est, state.W, total_var)

        past_warmup = round_index >= self.warmup_rounds
        never_fit = state.refreshes == 0
        drifted = (state.rho_ref - rho) > self.drift_threshold
        trigger = past_warmup & (never_fit | drifted | churn)

        W_new, lam_new = ortho_refresh_evals(band_est, state.W,
                                             self.refresh_iters)
        rho_new = retained_fraction(band_est, W_new, total_var)
        comm = torch.where(trigger,
                           state.comm_packets + self.refresh_cost(p),
                           state.comm_packets)
        new_state = SchedulerState(
            W=torch.where(trigger[..., None, None], W_new, state.W),
            rho_ref=torch.where(trigger, rho_new, state.rho_ref),
            refreshes=state.refreshes + trigger.to(torch.int32),
            comm_packets=comm + self.round_cost(),
            lam=torch.where(trigger[..., None], lam_new, state.lam),
        )
        return new_state, rho, trigger
