"""Online banded covariance with exponential forgetting (counterpart of
``repro.streaming.online_cov``).

The sufficient statistics decay by a forgetting factor ``beta`` per round:

    t    <- beta * t    + n
    S_i  <- beta * S_i  + sum_tau x_i[tau]
    S_ij <- beta * S_ij + sum_tau x_i[tau] x_j[tau]     (band entries only)

Every function takes leading axes (the fleet's slot axis); the band fold
runs through a CUDA band-fold kernel on a CUDA tensor, one launch for the
whole fleet: a chunk through the chunk kernel
(:func:`repro_torch.kernels.ops.cov_band_update_chunk_batched`), a round
through the per-round kernel
(:func:`repro_torch.kernels.ops.cov_band_update_batched`).  A round is
folded with the chunk's statistics at K = 1, so :func:`online_update`
gives the bits of :func:`online_update_chunk` on a one-round chunk.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.covariance import band_valid, shifted_stack
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

__all__ = ["OnlineCovariance", "online_init", "online_update",
           "online_update_chunk", "online_chunk_stats", "online_apply_chunk",
           "online_estimate", "online_total_variance", "stream_covariance"]

# the functions of every fold (checked by repolint's host-pull rule)
HOT_PATHS = ("_per_round", "_pow_table", "online_chunk_stats",
             "online_apply_chunk", "_fold", "online_update_chunk",
             "online_update", "online_estimate", "online_total_variance")


class OnlineCovariance(NamedTuple):
    """Decayed banded sufficient statistics; ``t_band[..., k, i]`` is the
    pairwise effective count of sensors i and i+k-h (its center row the
    per-sensor count ``t_i``)."""

    t: torch.Tensor          # (...) effective epoch count
    s: torch.Tensor          # (..., p) decayed per-sensor sums
    band: torch.Tensor       # (..., 2h+1, p) decayed products
    t_band: torch.Tensor     # (..., 2h+1, p) pairwise effective counts

    @property
    def halfwidth(self) -> int:
        return (self.band.shape[-2] - 1) // 2

    @property
    def p(self) -> int:
        return self.s.shape[-1]

    @property
    def t_i(self) -> torch.Tensor:
        return self.t_band[..., self.halfwidth, :]


def online_init(p: int, halfwidth: int, lead: tuple = (), *,
                device: torch.device | str = "cuda",
                dtype=torch.float32) -> OnlineCovariance:
    device = resolve_device(device)
    nb = 2 * halfwidth + 1
    z = lambda *shape: torch.zeros(tuple(lead) + shape, device=device,
                                   dtype=dtype)
    return OnlineCovariance(t=z(), s=z(p), band=z(nb, p), t_band=z(nb, p))


def _per_round(masks: torch.Tensor, xs: torch.Tensor) -> bool:
    """True for a (..., K, p) liveness mask, False for (..., K, n, p)."""
    return masks.dim() == xs.dim() - 1


@functools.lru_cache(maxsize=None)
def _pow_table(beta: float, K: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """``[beta**0, ..., beta**K]`` as Python floats cast to ``dtype`` on
    ``device``, built once per key: its host-to-device copy waits on the
    stream, so the fold must not make it every chunk."""
    return torch.tensor([beta ** j for j in range(K + 1)], dtype=dtype,
                        device=device)


def online_chunk_stats(state: OnlineCovariance, xs: torch.Tensor,
                       forgetting: float = 1.0,
                       masks: torch.Tensor | None = None,
                       round_valid: torch.Tensor | None = None):
    """The kernel-free half of :func:`online_update_chunk`: per-round
    forgetting weights ``w`` (..., K), the chunk's decay ``beta_eff`` (...),
    and the mean-sum / pairwise-count deltas.  ``delta_tb`` is None for a
    (..., K, n, p) dropout mask (its counts need a kernel pass).

    The decay powers come from a table of Python floats ``beta**j`` cast
    to fp32 (:func:`_pow_table`), gathered on device — no traced ``pow``."""
    dt = state.s.dtype
    xs = xs.to(dt)
    K, n, p = xs.shape[-3:]
    lead = xs.shape[:-3]
    h = state.halfwidth
    pow_table = _pow_table(float(forgetting), K, dt, xs.device)
    if round_valid is None:
        w = pow_table[torch.arange(K - 1, -1, -1, device=xs.device)]
        w = w.expand(lead + (K,))
        beta_eff = pow_table[K].clone().expand(lead)   # not the cache
    else:
        rv = round_valid.to(dt)
        # each valid round decays once per valid round AFTER it
        after = (torch.flip(torch.cumsum(torch.flip(rv, (-1,)), -1), (-1,))
                 - rv).long()
        w = pow_table[after] * rv
        beta_eff = pow_table[rv.sum(-1).long()]
    valid = band_valid(p, h, device=xs.device, dtype=state.t_band.dtype)
    if masks is None:
        delta_s = torch.einsum("...t,...tp->...p", w, xs.sum(-2))
        delta_tb = (w.sum(-1) * n)[..., None, None] * valid
    elif _per_round(masks, xs):
        masks = masks.to(dt)
        delta_s = torch.einsum("...t,...tp->...p", w,
                               (xs * masks[..., None, :]).sum(-2))
        # pairwise counts stay analytic: n m_i m_j per round, weighted
        mj = shifted_stack(masks, h)                    # (..., K, 2h+1, p)
        delta_tb = torch.einsum("...t,...tp,...tkp->...kp", w * n, masks,
                                mj).to(state.t_band.dtype)
    else:
        masks = masks.to(dt)
        delta_s = torch.einsum("...t,...tp->...p", w, (xs * masks).sum(-2))
        delta_tb = None
    return w, beta_eff, delta_s, delta_tb


def online_apply_chunk(state: OnlineCovariance, delta_band: torch.Tensor,
                       w: torch.Tensor, beta_eff: torch.Tensor,
                       delta_s: torch.Tensor, delta_tb: torch.Tensor,
                       n: int) -> OnlineCovariance:
    """Apply a chunk's deltas to the carried statistics."""
    b1, b2 = beta_eff[..., None], beta_eff[..., None, None]
    return OnlineCovariance(
        t=beta_eff * state.t + w.sum(-1) * n,
        s=b1 * state.s + delta_s,
        band=b2 * state.band + delta_band.to(state.band.dtype),
        t_band=b2 * state.t_band + delta_tb,
    )


def _fold(xs, w, h, mask=None):
    """Band kernel over any leading axes (flattened into the fleet axis)."""
    K, n, p = xs.shape[-3:]
    lead = xs.shape[:-3]
    m = None if mask is None else mask.reshape((-1,) + mask.shape[len(lead):])
    out = ops.cov_band_update_chunk_batched(
        xs.reshape(-1, K, n, p), w.reshape(-1, K), h, mask=m)
    return out.reshape(lead + out.shape[-2:])


def online_update_chunk(state: OnlineCovariance, xs: torch.Tensor,
                        forgetting: float = 1.0,
                        masks: torch.Tensor | None = None,
                        round_valid: torch.Tensor | None = None,
                        ) -> OnlineCovariance:
    """Fold a (..., K, n, p) chunk in ONE band-kernel launch: K sequential
    per-round updates, with the per-round forgetting weights fused into
    the fold and the carried statistics decayed once by ``beta^K``.

    ``masks`` is (..., K, p) liveness or (..., K, n, p) dropout (whose
    pairwise counts take a second, unmasked pass of the kernel over the
    mask); ``round_valid`` (..., K) marks the real rounds of the chunk."""
    xs = xs.to(state.s.dtype)
    h = state.halfwidth
    w, beta_eff, delta_s, delta_tb = online_chunk_stats(
        state, xs, forgetting=forgetting, masks=masks,
        round_valid=round_valid)
    if masks is not None:
        masks = masks.to(state.s.dtype)
    delta_band = _fold(xs, w, h, masks)
    if delta_tb is None:
        delta_tb = _fold(masks, w, h).to(state.t_band.dtype)
    return online_apply_chunk(state, delta_band, w, beta_eff, delta_s,
                              delta_tb, xs.shape[-2])


def online_update(state: OnlineCovariance, x: torch.Tensor,
                  forgetting: float = 1.0,
                  mask: torch.Tensor | None = None) -> OnlineCovariance:
    """Fold one round ``x`` (..., n, p) into the decayed statistics, every
    row of the round with the same weight (``repro.streaming.online_cov
    .online_update``).

    ``mask`` is None (the per-round kernel), a (..., p) sensor liveness
    (the masked kernel reading the row once for all n rows; the pairwise
    counts stay analytic, ``n m_i m_j``) or a (..., n, p) measurement
    dropout (the masked kernel per reading, plus the unmasked kernel over
    the mask for the counts ``sum_r m_i m_j``)."""
    x = x.to(state.s.dtype)
    lead, (n, p) = x.shape[:-2], x.shape[-2:]
    h = state.halfwidth
    liveness = mask is not None and mask.dim() == x.dim() - 1
    if mask is not None:
        mask = mask.to(state.s.dtype)
        if mask.shape != (lead + (p,) if liveness else x.shape):
            raise ValueError(f"mask shape {tuple(mask.shape)} fits neither "
                             f"{lead + (p,)} nor {tuple(x.shape)}")
    # the chunk's statistics at K = 1 (unit weight, decay beta)
    w, beta_eff, delta_s, delta_tb = online_chunk_stats(
        state, x[..., None, :, :], forgetting=forgetting,
        masks=None if mask is None
        else mask[..., None, :] if liveness else mask[..., None, :, :])
    flat = lambda t: t.reshape((-1,) + t.shape[len(lead):])
    delta_band = ops.cov_band_update_batched(
        flat(x), h, mask=None if mask is None else flat(mask))
    delta_band = delta_band.reshape(lead + delta_band.shape[1:])
    if delta_tb is None:
        counts = ops.cov_band_update_batched(flat(mask), h)
        delta_tb = counts.reshape(lead + counts.shape[1:]).to(
            state.t_band.dtype)
    return online_apply_chunk(state, delta_band, w, beta_eff, delta_s,
                              delta_tb, n)


def stream_covariance(state: OnlineCovariance, xs: torch.Tensor,
                      forgetting: float = 1.0,
                      ) -> tuple[OnlineCovariance, torch.Tensor]:
    """Fold ``xs`` (..., rounds, n, p) round by round
    (``repro.streaming.online_cov.stream_covariance``); returns the final
    state and the (..., rounds) total-variance trace after each round."""
    traces = []
    for r in range(xs.shape[-3]):
        state = online_update(state, xs[..., r, :, :], forgetting)
        traces.append(online_total_variance(state))
    return state, torch.stack(traces, -1)


def online_estimate(state: OnlineCovariance) -> torch.Tensor:
    """Banded covariance diagonals ``c_band[..., k, i] = C[i, i+k-h]``,
    every sum normalized by its own effective count."""
    h = state.halfwidth
    mean = state.s / state.t_i.clamp(min=1.0)
    t_pair = state.t_band.clamp(min=1.0)
    band = state.band / t_pair - mean[..., None, :] * shifted_stack(mean, h)
    valid = band_valid(state.p, h, device=band.device)
    return torch.where(valid > 0, band, torch.zeros_like(band))


def online_total_variance(state: OnlineCovariance) -> torch.Tensor:
    """trace(C) of the live estimate (the band's center row)."""
    h = state.halfwidth
    ti = state.t_i.clamp(min=1.0)
    variances = state.band[..., h, :] / ti - (state.s / ti) ** 2
    return variances.sum(-1)
