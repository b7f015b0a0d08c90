"""Copy of ``repro.core.events`` for the PyTorch port
(held equal to it by tests/test_torch_streaming.py).

Event detection on low-variance components (paper Sec. 2.4.3).

Low-variance principal components normally carry near-zero coordinates (they
account for sensor noise).  A network-scale event that is invisible at any
single node shows up as a significant coordinate on those components.  The
evaluator function is a statistical test on the standardized low-variance
scores:

    T[t] = sum_{k in low} z_k[t]^2 / lambda_k   ~   chi^2_{|low|}  under H0.

:class:`LowVarianceDetector` flags epochs where T exceeds the chi-square
quantile (normal-approximation threshold — no scipy dependency).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LowVarianceDetector", "DetectionResult"]


def _chi2_quantile(df: float, alpha: float) -> float:
    """Wilson-Hilferty approximation of the chi-square (1-alpha) quantile.

    ``df`` may be fractional (the moment-matched ``g * chi2_h`` thresholds of
    the streaming detector pass their effective degrees of freedom here).
    ``alpha`` outside (0, 1) is clamped into the open interval by
    :func:`_norm_quantile` — the helpers never return ±inf/NaN; the
    *validation* of a caller's alpha belongs to the caller (see
    :class:`LowVarianceDetector`).
    """
    # normal quantile via Acklam-style rational approximation (sufficient here)
    z = _norm_quantile(1.0 - alpha)
    a = 2.0 / (9.0 * df)
    return df * (1.0 - a + z * np.sqrt(a)) ** 3


def _norm_quantile(u: float) -> float:
    # Beasley-Springer-Moro.  The tail branches take log(u) / log(1-u), so
    # u is clamped into the open interval first: u = 0 or 1 would silently
    # produce ±inf and poison every threshold derived from it.
    u = float(np.clip(u, 1e-300, 1.0 - 1e-16))
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if u < plow:
        q = np.sqrt(-2 * np.log(u))
        return (((((c[0]*q+c[1])*q+c[2])*q+c[3])*q+c[4])*q+c[5]) / \
               ((((d[0]*q+d[1])*q+d[2])*q+d[3])*q+1)
    if u > phigh:
        return -_norm_quantile(1 - u)
    q = u - 0.5
    r = q * q
    return (((((a[0]*r+a[1])*r+a[2])*r+a[3])*r+a[4])*r+a[5])*q / \
           (((((b[0]*r+b[1])*r+b[2])*r+b[3])*r+b[4])*r+1)


@dataclasses.dataclass(frozen=True)
class DetectionResult:
    statistic: np.ndarray   # (N,) chi-square statistic per epoch
    threshold: float
    events: np.ndarray      # (N,) bool


class LowVarianceDetector:
    """Detector over the trailing (low-variance) components.

    Parameters
    ----------
    W_low: (p, m) low-variance components (e.g. columns q_lo..q_hi of the
        full basis).
    lambdas_low: (m,) their eigenvalues (estimated on healthy training data).
    alpha: false-alarm rate under H0.
    """

    def __init__(self, W_low: np.ndarray, lambdas_low: np.ndarray,
                 mean: np.ndarray, alpha: float = 1e-3,
                 min_lambda: float = 1e-9):
        if not 0.0 < alpha < 1.0:
            raise ValueError(
                f"alpha must be in the open interval (0, 1), got {alpha}")
        self.W = np.asarray(W_low, dtype=np.float64)
        self.lam = np.maximum(np.asarray(lambdas_low, np.float64), min_lambda)
        self.mean = np.asarray(mean, dtype=np.float64)
        self.alpha = alpha
        self.threshold = _chi2_quantile(self.W.shape[1], alpha)

    def statistic(self, x: np.ndarray) -> np.ndarray:
        xc = np.asarray(x, dtype=np.float64) - self.mean
        z = xc @ self.W                       # (N, m) low-variance scores
        return np.sum(z * z / self.lam[None, :], axis=1)

    def calibrate(self, x_healthy: np.ndarray) -> float:
        """Replace the chi-square threshold by the empirical (1-alpha)
        quantile on a healthy calibration window.

        The chi-square calibration assumes the deployment period is
        stationary w.r.t. the training block; on real (diurnal,
        non-stationary) traces the low-variance scores drift, so production
        deployments should re-calibrate on recent healthy data — this is the
        WSN analogue of recalibrating a fleet-telemetry alarm."""
        stat = self.statistic(x_healthy)
        self.threshold = float(np.quantile(stat, 1.0 - self.alpha))
        return self.threshold

    def detect(self, x: np.ndarray) -> DetectionResult:
        stat = self.statistic(x)
        return DetectionResult(statistic=stat, threshold=self.threshold,
                               events=stat > self.threshold)
