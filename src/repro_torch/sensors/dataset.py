"""Copy of ``repro.sensors.dataset`` for the PyTorch port
(held equal to it by tests/test_torch_streaming.py).

Synthetic surrogate of the Intel-Berkeley temperature trace (paper Sec. 4.1).

The original trace (54 Mica2Dot motes, 5 days, 31 s sampling, sensors 5 and 15
dead -> 52 usable) is not available offline.  This module generates a
statistically matched surrogate with the properties the paper's experiments
depend on:

* p = 52 sensors at a Berkeley-like 2-D layout (40 m x 30 m),
* N = 14 400 epochs of 30 s (5 days),
* temperatures within ~15-35 C,
* a shared diurnal cycle (dominant first principal component, ~80 % variance),
* spatially correlated residuals whose correlation decays with distance
  (the *local covariance hypothesis* substrate), least-correlated pair ~0.6,
* localized AC/occupancy events (the Fig.-8 'air conditioning near sensor 49'
  plateaus) contributing mid-rank components,
* i.i.d. sensor noise (the white-noise tail of Fig. 7).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.topology import berkeley_like_layout

__all__ = ["SensorDataset", "berkeley_surrogate", "kfold_blocks",
           "inject_ac_event"]


@dataclasses.dataclass(frozen=True)
class SensorDataset:
    """(N, p) measurement matrix plus sensor positions; rows are epochs."""

    measurements: np.ndarray     # (N, p) float64, degrees C
    positions: np.ndarray        # (p, 2) meters
    epoch_seconds: float = 30.0

    @property
    def n_epochs(self) -> int:
        return int(self.measurements.shape[0])

    @property
    def p(self) -> int:
        return int(self.measurements.shape[1])

    def centered(self, mean: np.ndarray | None = None) -> np.ndarray:
        mu = self.measurements.mean(axis=0) if mean is None else mean
        return self.measurements - mu


def berkeley_surrogate(p: int = 52, n_epochs: int = 14_400, seed: int = 0,
                       noise_std: float = 0.25) -> SensorDataset:
    """Generate the surrogate trace.  Deterministic for a given seed."""
    rng = np.random.default_rng(seed)
    positions = berkeley_like_layout(p=p, seed=seed + 7)

    t = np.arange(n_epochs) * 30.0 / 86_400.0  # time in days
    # --- shared diurnal component (global, dominates variance) -------------
    diurnal = 24.0 + 6.5 * np.sin(2 * np.pi * (t - 0.3))  # (N,)
    diurnal = diurnal + 1.2 * np.sin(4 * np.pi * (t - 0.1))
    # per-sensor coupling to the diurnal cycle: near-window sensors swing more
    gain = 0.75 + 0.5 * rng.beta(2.0, 2.0, size=p)          # (p,)
    offset = rng.normal(0.0, 1.0, size=p)                   # per-sensor bias

    # --- spatially correlated slow residual (GP over positions) ------------
    d = np.linalg.norm(positions[:, None, :] - positions[None, :, :], axis=-1)
    ell = 18.0                                  # spatial correlation length, m
    K = np.exp(-(d / ell) ** 2) + 1e-6 * np.eye(p)
    Lk = np.linalg.cholesky(K)
    # temporally smooth drivers: random walk smoothed by an EMA
    n_factors = p
    z = rng.normal(size=(n_epochs, n_factors))
    alpha = 0.015                               # ~30-min smoothing at 30 s
    for i in range(1, n_epochs):
        z[i] = (1 - alpha) * z[i - 1] + np.sqrt(alpha * (2 - alpha)) * z[i]
    spatial = 1.6 * (z @ Lk.T)                  # (N, p)

    # --- localized AC / occupancy events (plateaus near a random site) -----
    events = np.zeros((n_epochs, p))
    n_events = 10
    for _ in range(n_events):
        site = rng.integers(0, p)
        start = rng.integers(0, n_epochs - 1_200)
        dur = rng.integers(400, 1_200)
        amp = rng.uniform(-3.0, -1.0)           # cooling plateaus
        foot = np.exp(-(d[site] / 6.0) ** 2)    # ~6 m footprint
        window = np.zeros(n_epochs)
        window[start:start + dur] = 1.0
        # smooth the edges (~5 epochs)
        kernel = np.ones(11) / 11.0
        window = np.convolve(window, kernel, mode="same")
        events += amp * window[:, None] * foot[None, :]

    x = (offset[None, :] + gain[None, :] * diurnal[:, None]
         + spatial + events
         + rng.normal(0.0, noise_std, size=(n_epochs, p)))
    x = np.clip(x, 12.0, 38.0)
    return SensorDataset(measurements=x, positions=positions)


def inject_ac_event(measurements: np.ndarray, positions: np.ndarray, *,
                    site: int, start: int, duration: int,
                    amplitude: float, footprint_m: float = 6.0,
                    ramp_epochs: int = 11,
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Inject one localized AC/occupancy plateau into an (N, p) epoch block.

    The same event family :func:`berkeley_surrogate` seeds its traces with
    (the Fig.-8 'air conditioning near sensor 49' plateaus), exposed as a
    standalone generator so detection experiments can place *known* events:
    a spatial footprint ``exp(-(d / footprint_m)^2)`` around ``site``
    (network-coherent — every nearby sensor moves together — yet small
    against each sensor's own swing: exactly what the Sec.-2.4.3 evaluator
    exists to catch), a plateau of ``duration`` epochs whose first/last
    ``ramp_epochs`` ramp linearly INSIDE the window (no amplitude ever
    leaks outside it — an event epoch outside the truth mask would charge
    a correct detector with false positives), and ``amplitude`` degrees at
    the site (negative for cooling).

    Returns ``(x_event, window)``: a modified copy of ``measurements`` and
    the (N,) boolean truth mask — exactly the support of the injected
    envelope, the ground truth TPR/FPR sweeps score against.
    """
    x = np.array(measurements, dtype=measurements.dtype)
    n_epochs, p = x.shape
    if not 0 <= site < p:
        raise ValueError(f"site {site} outside [0, {p})")
    if start < 0 or start + duration > n_epochs:
        raise ValueError(
            f"event [{start}, {start + duration}) outside [0, {n_epochs})")
    d = np.linalg.norm(positions - positions[site], axis=-1)
    foot = np.exp(-(d / footprint_m) ** 2)
    plateau = np.ones(duration)
    r = min(ramp_epochs, duration // 2)
    if r > 1:
        up = np.linspace(1.0 / r, 1.0, r)
        plateau[:r] = up
        plateau[duration - r:] = up[::-1]
    window = np.zeros(n_epochs)
    window[start:start + duration] = plateau
    x += amplitude * window[:, None] * foot[None, :]
    return x, window > 0.0


def kfold_blocks(n_epochs: int, k: int = 10) -> list[tuple[np.ndarray, np.ndarray]]:
    """The paper's block K-fold CV (Sec. 4.3): K *consecutive* blocks; each
    block is the training set in turn, the remaining epochs are the test set.
    Returns a list of (train_idx, test_idx)."""
    edges = np.linspace(0, n_epochs, k + 1).astype(int)
    folds = []
    all_idx = np.arange(n_epochs)
    for i in range(k):
        tr = all_idx[edges[i]:edges[i + 1]]
        te = np.concatenate([all_idx[:edges[i]], all_idx[edges[i + 1]:]])
        folds.append((tr, te))
    return folds
