"""Copy of ``repro.core.events._norm_quantile`` (Beasley-Springer-Moro)."""

from __future__ import annotations

import numpy as np

__all__ = ["_norm_quantile"]


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
