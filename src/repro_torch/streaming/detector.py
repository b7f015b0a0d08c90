"""Streaming event-detection stage: T²/SPE monitoring (counterpart of
``repro.streaming.detector``).

The per-epoch statistics come out of the fused chunk kernel, or — on the
split path — out of the monitoring kernel through :func:`detect_round`;
this module holds the detector state machine — healthy-window moments
after every refresh, moment-matched ``g·χ²_h`` thresholds by the
Wilson-Hilferty cube, alarms outside the window — and the Sec.-2.4.3
packet books.  Every function takes leading axes (the fleet's slots).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core import costs
from repro_torch.core.events import _norm_quantile
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

__all__ = ["DetectionConfig", "DetectorState", "RoundDetection",
           "detector_init", "detect_round", "detect_apply", "inv_lambda",
           "row_liveness", "wilson_hilferty", "detection_packet_split"]

# the functions of every detection stage (checked by repolint's host-pull
# rule)
HOT_PATHS = ("_moment_threshold", "_ordered_sum", "inv_lambda",
             "row_liveness", "detect_round", "detect_apply",
             "wilson_hilferty")


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """Static per-deployment detection policy (hashable: rides the jitted
    StreamConfig as a compile-time constant).

    Parameters
    ----------
    alpha: per-epoch false-alarm rate under H0 — must lie in the open
        interval (0, 1) (the same validation the host-side
        :class:`repro.core.events.LowVarianceDetector` applies).
    calib_rounds: healthy-window length (rounds) after every basis
        refresh; alarms are suppressed while the window is open and the
        thresholds re-arm when it closes.
    min_lambda: clamp floor for the per-component variance estimates
        before inversion (a near-zero Rayleigh quotient would turn T²
        into an alarm siren).
    emit_statistics: carry the per-epoch (n,) T²/SPE/event arrays in the
        per-round output.  Costs rounds × n floats through a scan — right
        for examples/tests; disable at scale to keep only the scalar
        alarm counts and thresholds.
    """

    alpha: float = 1e-3
    calib_rounds: int = 8
    min_lambda: float = 1e-9
    emit_statistics: bool = True

    def __post_init__(self):
        if not 0.0 < self.alpha < 1.0:
            raise ValueError(
                f"alpha must be in the open interval (0, 1), got {self.alpha}")
        if self.calib_rounds < 1:
            raise ValueError(
                f"calib_rounds must be >= 1, got {self.calib_rounds}")
        if self.min_lambda <= 0.0:
            raise ValueError(
                f"min_lambda must be > 0, got {self.min_lambda}")

    @property
    def z_alpha(self) -> float:
        """Normal (1 - alpha) quantile, resolved host-side (alpha is
        static); the device evaluates only the Wilson-Hilferty cube."""
        return float(_norm_quantile(1.0 - self.alpha))


class DetectorState(NamedTuple):
    """Per-network detector state (leading axes: the slots)."""

    t2_threshold: torch.Tensor   # (...) +inf until the first window closes
    spe_threshold: torch.Tensor  # (...) +inf until the first window closes
    calib_left: torch.Tensor     # (...) int32 rounds left in the window
    t2_sum: torch.Tensor         # (...) window moments of T²
    t2_sumsq: torch.Tensor
    spe_sum: torch.Tensor        # (...) window moments of SPE
    spe_sumsq: torch.Tensor
    count: torch.Tensor          # (...) epochs folded into the window


class RoundDetection(NamedTuple):
    """Per-chunk detection output; ``t2``/``spe``/``events`` are None when
    the config disables statistics emission."""

    t2: torch.Tensor | None      # (..., rows) per-epoch T²
    spe: torch.Tensor | None     # (..., rows) per-epoch SPE
    events: torch.Tensor | None  # (..., rows) 0/1 alarms
    alarms: torch.Tensor         # (...) alarmed epochs
    t2_threshold: torch.Tensor   # (...) threshold in effect
    spe_threshold: torch.Tensor  # (...) threshold in effect
    calibrating: torch.Tensor    # (...) bool — healthy window open


def wilson_hilferty(df: torch.Tensor, z: float) -> torch.Tensor:
    """Chi-square quantile by the Wilson-Hilferty cube, tensor ``df``."""
    a = 2.0 / (9.0 * df.clamp(min=1e-12))
    return df * (1.0 - a + z * torch.sqrt(a)) ** 3


def detector_init(lead: tuple = (), *, device="cuda",
                  dtype=torch.float32) -> DetectorState:
    device = resolve_device(device)
    zero = torch.zeros(lead, device=device, dtype=dtype)
    inf = torch.full(lead, math.inf, device=device, dtype=dtype)
    return DetectorState(
        t2_threshold=inf, spe_threshold=inf.clone(),
        calib_left=torch.zeros(lead, device=device, dtype=torch.int32),
        t2_sum=zero, t2_sumsq=zero.clone(), spe_sum=zero.clone(),
        spe_sumsq=zero.clone(), count=zero.clone())


def _moment_threshold(s: torch.Tensor, ss: torch.Tensor, cnt: torch.Tensor,
                      z: float) -> torch.Tensor:
    """Moment-matched g·χ²_h (1-alpha) quantile from window sums (Box)."""
    cnt = cnt.clamp(min=1.0)
    m = (s / cnt).clamp(min=1e-12)
    v = (ss / cnt - m * m).clamp(min=1e-12)
    g = v / (2.0 * m)
    h = 2.0 * m * m / v
    return g * wilson_hilferty(h, z)


def _ordered_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by the reference's fixed halving tree
    (zero-padded to a power of two; ``x + 0 == x`` is exact)."""
    n = v.shape[-1]
    m = 1 << max(n - 1, 0).bit_length()
    if m != n:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (m - n,))], -1)
    while m > 1:
        m //= 2
        v = v[..., :m] + v[..., m:]
    return v[..., 0]


def inv_lambda(lam: torch.Tensor, cfg: DetectionConfig) -> torch.Tensor:
    """Clamped inverse of the per-component variance estimates."""
    return 1.0 / lam.to(torch.float32).clamp(min=cfg.min_lambda)


def row_liveness(mask: torch.Tensor | None, rows: int, lead: tuple = (),
                 device="cuda", dtype=torch.float32) -> torch.Tensor:
    """(..., rows) 0/1 weight of each epoch in the window moments: an epoch
    with no live sensor carries no statistic.  ``mask`` is (..., rows, p)
    or None (every epoch live)."""
    if mask is None:
        return torch.ones(tuple(lead) + (rows,),
                          device=resolve_device(device), dtype=dtype)
    return (mask.amax(-1) > 0).to(dtype)


def detect_round(W: torch.Tensor, mean: torch.Tensor, lam: torch.Tensor,
                 x: torch.Tensor, state: DetectorState, cfg: DetectionConfig,
                 refreshed: torch.Tensor, mask: torch.Tensor | None = None,
                 n: int | None = None,
                 ) -> tuple[DetectorState, RoundDetection]:
    """Monitor every slot's (R, p) rows against its basis ``W`` (S, p, q):
    one monitoring-kernel launch for T²/SPE, then :func:`detect_apply`.
    ``lam`` (S, q) are the scheduler's per-component variances (clamped
    before inversion); ``refreshed`` (S,) opens a fresh healthy window
    before this chunk's statistics are folded.  ``mask`` is (S, R, p) per
    row, (S, R / n, p) per round with ``n`` given, or None."""
    S, R, _ = x.shape
    _, t2, spe = ops.pca_monitor(x.to(torch.float32), W, mean,
                                 inv_lambda(lam, cfg), mask=mask, n=n)
    if mask is None or n is None:
        row_live = row_liveness(mask, R, (S,), device=x.device)
    else:
        row_live = row_liveness(mask, R // n).repeat_interleave(n, dim=-1)
    return detect_apply(t2, spe, row_live, W.shape[-1], state, cfg,
                        refreshed)


def detect_apply(t2: torch.Tensor, spe: torch.Tensor, row_live: torch.Tensor,
                 q: int, state: DetectorState, cfg: DetectionConfig,
                 refreshed: torch.Tensor,
                 ) -> tuple[DetectorState, RoundDetection]:
    """The detector state machine on computed statistics: window reset on
    refresh, healthy-window fold, threshold re-arm, alarm evaluation."""
    refreshed = refreshed.to(torch.bool)
    zero = torch.zeros_like(state.t2_sum)
    calib_left = torch.where(refreshed,
                             torch.full_like(state.calib_left,
                                             cfg.calib_rounds),
                             state.calib_left)
    reset = lambda a: torch.where(refreshed, zero, a)
    t2_sum, t2_sumsq = reset(state.t2_sum), reset(state.t2_sumsq)
    spe_sum, spe_sumsq = reset(state.spe_sum), reset(state.spe_sumsq)
    count = reset(state.count)

    calibrating = calib_left > 0
    cal_f = calibrating.to(t2.dtype)
    n_live = row_live.sum(-1)
    t2_sum = t2_sum + cal_f * _ordered_sum(t2 * row_live)
    t2_sumsq = t2_sumsq + cal_f * _ordered_sum(t2 * t2 * row_live)
    spe_sum = spe_sum + cal_f * _ordered_sum(spe * row_live)
    spe_sumsq = spe_sumsq + cal_f * _ordered_sum(spe * spe * row_live)
    count = count + cal_f * n_live
    # a fully-dead round does not advance the window
    calib_left = calib_left - (calibrating & (n_live > 0)).to(torch.int32)
    closing = calibrating & (calib_left == 0)

    z = cfg.z_alpha
    floor = wilson_hilferty(torch.full((), float(q), device=t2.device), z)
    t2_thr_new = torch.maximum(_moment_threshold(t2_sum, t2_sumsq, count, z),
                               floor)
    spe_thr_new = _moment_threshold(spe_sum, spe_sumsq, count, z).clamp(
        min=0.0)
    t2_threshold = torch.where(closing, t2_thr_new, state.t2_threshold)
    spe_threshold = torch.where(closing, spe_thr_new, state.spe_threshold)

    armed = ~calibrating
    events = armed[..., None] & ((t2 > state.t2_threshold[..., None])
                                 | (spe > state.spe_threshold[..., None]))
    events_f = events.to(t2.dtype)
    new_state = DetectorState(
        t2_threshold=t2_threshold, spe_threshold=spe_threshold,
        calib_left=calib_left, t2_sum=t2_sum, t2_sumsq=t2_sumsq,
        spe_sum=spe_sum, spe_sumsq=spe_sumsq, count=count)
    emit = cfg.emit_statistics
    detection = RoundDetection(
        t2=t2 if emit else None, spe=spe if emit else None,
        events=events_f if emit else None, alarms=events_f.sum(-1),
        t2_threshold=state.t2_threshold, spe_threshold=state.spe_threshold,
        calibrating=calibrating)
    return new_state, detection


def detection_packet_split(q: int, c_max: int) -> tuple[float, float]:
    """(flag-free packets per round, packets per alarmed epoch) of one
    Sec.-2.4.3 monitoring epoch at the highest-loaded node.

    The cost model owns both numbers
    (:func:`repro_torch.core.costs.detection_round_cost`): the flag-free
    part is the one extra record element riding the per-round drift
    aggregation, the per-alarm part is the scalar F alarm flood.
    """
    base = costs.detection_round_cost(q, c_max).communication
    per_alarm = (costs.detection_round_cost(q, c_max, 1.0).communication
                 - base)
    return float(base), float(per_alarm)
