"""Event detection on low-variance components (paper Sec. 2.4.3;
counterpart of ``examples/event_detection.py``).

Train the PCA basis on healthy data, then inject a network-scale anomaly
that is invisible at any single node (a correlated pattern orthogonal to
the normal subspace) and detect it with the chi-square test on the
low-variance component scores.

Run:  PYTHONPATH=src python -m repro_torch.examples.event_detection [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.events import LowVarianceDetector
from repro_torch.core.pca import DistributedPCA
from repro_torch.device import resolve_device
from repro_torch.examples import parse_device
from repro_torch.sensors.dataset import berkeley_surrogate

P, N_EPOCHS = 52, 7200
Q_SIG, Q_LOW = 10, 30    # components 10..29 span the noise floor
ALPHA = 1e-3
EVENT = slice(1000, 1040)    # deployment epochs carrying the event
EVENT_MAX = 1.2              # degrees C, across the network


def run(device="cuda", *, measurements=None) -> dict:
    """Fit, calibrate, inject and detect on ``measurements`` (epochs, 52):
    2.5 days train, 10 h calibration, 20 h deployment; the surrogate's
    7,200 epochs when None.  Returns the rates, both thresholds and the
    statistic inside and outside the event."""
    device = resolve_device(device)
    X = (berkeley_surrogate(p=P, n_epochs=N_EPOCHS, seed=0).measurements
         if measurements is None else np.asarray(measurements))
    train, cal, test = X[:3600], X[3600:4800], X[4800:7200].copy()
    # full basis: leading components = signal, trailing = noise floor
    res = DistributedPCA(q=P, method="eigh", device=device).fit(train)
    W_low = res.components[:, Q_SIG:Q_LOW]
    lam_low = res.eigenvalues[Q_SIG:Q_LOW]
    det = LowVarianceDetector(W_low, lam_low, res.mean, alpha=ALPHA)
    # the chi-square threshold assumes stationarity; calibrate empirically
    # on a healthy window
    chi2_thr = det.threshold
    det.calibrate(cal)
    # a coherent pattern in the noise subspace, small against the diurnal
    # swing any single node rides, but network-coherent
    pattern = W_low[:, 3] + 0.5 * W_low[:, 7]
    pattern = pattern / np.abs(pattern).max() * EVENT_MAX
    test[EVENT] += pattern[None, :]
    out = det.detect(test)
    window = np.zeros(len(test), bool)
    window[EVENT] = True
    return dict(
        tpr=float(out.events[window].mean()),
        fpr=float(out.events[~window].mean()),
        chi2_threshold=float(chi2_thr), threshold=float(det.threshold),
        max_inside=float(out.statistic[window].max()),
        median_outside=float(np.median(out.statistic[~window])),
        events=out.events)


def main(argv=None) -> None:
    r = run(parse_device(__doc__, argv))
    print(f"low-variance detector (20 comps, chi2 thr "
          f"{r['chi2_threshold']:.1f} -> calibrated {r['threshold']:.1f})")
    print(f"  detection rate inside event window: {r['tpr']:.1%}")
    print(f"  false alarm rate outside:           {r['fpr']:.2%}")
    print(f"  max statistic inside window: {r['max_inside']:.1f} "
          f"vs outside median {r['median_outside']:.1f}")
    assert r["tpr"] > 0.8 and r["fpr"] < 0.05, "detector quality regression"


if __name__ == "__main__":
    main()
