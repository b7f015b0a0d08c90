"""Event-detecting serving: a fleet monitoring T²/SPE on the streaming path
(counterpart of ``examples/event_fleet.py``).

Every round passes through the monitoring kernel (kernel 5: project, T²
and SPE in one launch, the reconstruction never stored), and the
detector re-arms its Wilson-Hilferty thresholds over a healthy window
after the warmup basis refresh.  Half the networks get an injected
localized AC plateau (:func:`repro_torch.sensors.dataset.inject_ac_event`:
a ~8 m footprint, ~5 C at the site, network-coherent but small against
each sensor's own variance).  The acceptance gate: detection rate inside
the injected windows > 80%, false-alarm rate outside < 5%.

Run:  PYTHONPATH=src python -m repro_torch.examples.event_fleet [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.topology import berkeley_like_layout
from repro_torch.device import as_tensor, resolve_device
from repro_torch.examples import parse_device
from repro_torch.sensors.dataset import inject_ac_event
from repro_torch.streaming import (DetectionConfig, StreamConfig,
                                   batched_stream_run, stream_init)
from repro_torch.streaming.driver import random_bases

N_NETWORKS = 8
N_ROUNDS = 40
N_PER_ROUND = 8
P = 32                   # sensors per network
Q = 3                    # principal components maintained
ALPHA = 1e-3
CALIB_ROUNDS = 8
WARMUP = 6
EVENT_NETWORKS = (1, 3, 4, 6)
EVENT_START_ROUND = 22   # well after arming (warmup + calibration window)
EVENT_ROUNDS = 8
EVENT_AMP = -5.0         # cooling plateau, degrees at the site
EVENT_FOOTPRINT = 8.0    # meters
NOISE = 0.8

CFG = StreamConfig(p=P, q=Q, halfwidth=4, forgetting=0.98,
                   drift_threshold=0.5, warmup_rounds=WARMUP,
                   detection=DetectionConfig(alpha=ALPHA,
                                             calib_rounds=CALIB_ROUNDS))


def fleet_streams(seed=0) -> np.ndarray:
    """(networks, rounds, n, p): a dominant top-q group of sensors over a
    flat noise floor (numpy, as the reference draws it)."""
    rng = np.random.default_rng(seed)
    scale = np.concatenate([[4.0, 3.4, 2.8], np.full(P - 3, NOISE)])
    x = rng.normal(size=(N_NETWORKS, N_ROUNDS, N_PER_ROUND, P)) * scale
    return x.astype(np.float32)


def inject_events(xs, positions, seed=1):
    """Plant one localized plateau per event network, away from the
    high-variance sensors; returns the fleet block and the (networks,
    rounds, n) ground-truth epoch mask."""
    rng = np.random.default_rng(seed)
    truth = np.zeros(xs.shape[:3], bool)
    epochs = N_ROUNDS * N_PER_ROUND
    d_top = np.linalg.norm(positions[:, None, :] - positions[None, :3, :],
                           axis=-1).min(axis=1)
    candidates = np.nonzero(d_top > 10.0)[0]
    for b in EVENT_NETWORKS:
        site = int(rng.choice(candidates))
        start = EVENT_START_ROUND * N_PER_ROUND
        dur = EVENT_ROUNDS * N_PER_ROUND
        flat, window = inject_ac_event(
            xs[b].reshape(epochs, P), positions, site=site, start=start,
            duration=dur, amplitude=EVENT_AMP,
            footprint_m=EVENT_FOOTPRINT, ramp_epochs=3)
        xs[b] = flat.reshape(N_ROUNDS, N_PER_ROUND, P)
        truth[b] = window.reshape(N_ROUNDS, N_PER_ROUND)
    return xs, truth


def run(device="cuda", *, streams=None, init_bases=None) -> dict:
    """Stream the fleet with events planted; returns the rates, the
    per-network alarms, thresholds and bills.  ``streams`` (numpy) and the
    ground truth come from :func:`inject_events` when None."""
    dev = resolve_device(device)
    positions = berkeley_like_layout(p=P, seed=7)
    xs_np, truth = inject_events(fleet_streams(), positions)
    xs = as_tensor(xs_np if streams is None else streams, torch.float32, dev)
    W0 = (random_bases(N_NETWORKS, P, Q, seed=2, device=dev)
          if init_bases is None
          else as_tensor(init_bases, torch.float32, dev))
    states = stream_init(CFG, N_NETWORKS, init_bases=W0, device=dev)
    t0 = time.perf_counter()
    fin, met = batched_stream_run(CFG, states, xs)
    det = met.detection
    events = det.events.cpu().numpy() > 0.5          # (networks, rounds, n)
    elapsed = time.perf_counter() - t0
    calibrating = det.calibrating.cpu().numpy() > 0.5   # (networks, rounds)
    # score only epochs where the detector was armed (outside warmup and
    # the healthy windows: alarms are suppressed inside them by design)
    armed = ~calibrating
    armed[:, :WARMUP + 1] = False
    armed_e = np.repeat(armed[:, :, None], N_PER_ROUND, axis=2)
    return dict(
        seconds=elapsed, events=events, truth=truth,
        tpr=float(events[truth & armed_e].mean()),
        fpr=float(events[~truth & armed_e].mean()),
        alarms=events.sum(axis=(1, 2)).astype(int),
        event_epochs=truth.sum(axis=(1, 2)).astype(int),
        t2_threshold=fin.det.t2_threshold.cpu().numpy(),
        spe_threshold=fin.det.spe_threshold.cpu().numpy(),
        bills=fin.sched.comm_packets.cpu().numpy())


def main(argv=None) -> None:
    device = parse_device(__doc__, argv)
    print("=== T²/SPE event-detection fleet ===\n")
    print(f"fleet: {N_NETWORKS} networks x {N_ROUNDS} rounds, p={P}, q={Q}; "
          f"events on networks {EVENT_NETWORKS} at rounds "
          f"[{EVENT_START_ROUND}, {EVENT_START_ROUND + EVENT_ROUNDS})\n")
    r = run(device)
    print(f"{'network':>8} {'alarms':>7} {'event epochs':>13} "
          f"{'T² thr':>8} {'SPE thr':>8} {'bill':>9}")
    for b in range(N_NETWORKS):
        print(f"{b:>8} {r['alarms'][b]:>7} {r['event_epochs'][b]:>13} "
              f"{r['t2_threshold'][b]:>8.1f} {r['spe_threshold'][b]:>8.1f} "
              f"{r['bills'][b]:>9.0f}")
    tpr, fpr = r["tpr"], r["fpr"]
    print(f"\ndetection rate inside injected windows: {tpr:.1%}")
    print(f"false-alarm rate outside:               {fpr:.2%}")
    print(f"(streamed {N_NETWORKS * N_ROUNDS} network-rounds in "
          f"{r['seconds']:.1f} s)\n")
    assert tpr > 0.8, f"TPR {tpr:.1%} below the 80% acceptance gate"
    assert fpr < 0.05, f"FPR {fpr:.2%} above the 5% acceptance gate"
    print("OK: the device tier reproduces the Sec.-2.4.3 envelope — "
          "localized events caught network-wide, alarms stay rare.")


if __name__ == "__main__":
    main()
