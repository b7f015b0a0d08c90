"""Compressed serving: a fleet streaming ε-supervised PCAg scores
(counterpart of ``examples/compression_fleet.py``).

Ship q scores instead of p raw readings, feed them back, and let every
node police its own reconstruction: whoever's error strictly exceeds ε
ships the raw value, so the sink is always within |x − x̂| <= ε.  The
fleet streams round by round against each network's live basis: with
full-precision scores through the supervised-compression kernel (kernel
4), with quantized scores through the projection and reconstruction
kernels (8 and 9) around the quantizer.

Two sweeps, one acceptance gate each: at every swept ε, and at every
score bit width (ε = 0.5), the worst sink error across the whole fleet
and stream must be <= ε.

Run:  PYTHONPATH=src python -m repro_torch.examples.compression_fleet [--device cpu]
"""

from __future__ import annotations

import time

import torch

from repro_torch.device import as_tensor, resolve_device
from repro_torch.examples import normal, parse_device
from repro_torch.streaming import (CompressionConfig, StreamConfig,
                                   batched_stream_run, stream_init)
from repro_torch.streaming.driver import random_bases

N_NETWORKS = 8
N_ROUNDS = 30
N_PER_ROUND = 8
P = 32                   # sensors per network
Q = 3                    # principal components maintained
EPSILONS = (0.1, 0.25, 0.5, 1.0, 2.0)
BIT_WIDTHS = (0, 16, 8, 6, 4, 2)     # 0 = full-precision scores
EPS_FOR_BITS = 0.5
READINGS = N_NETWORKS * N_ROUNDS * N_PER_ROUND * P


def fleet_streams(device, seed: int = 0) -> torch.Tensor:
    """(networks, rounds, n, p): a dominant top-q subspace plus a weak
    tail, so PCAg compression has signal to keep and noise to drop."""
    scale = torch.cat([torch.tensor([4.0, 3.4, 2.8], device=device),
                       torch.linspace(1.2, 0.8, P - 3, device=device)])
    return normal((N_NETWORKS, N_ROUNDS, N_PER_ROUND, P), seed,
                  device) * scale


def run_fleet(compression: CompressionConfig, xs, W0):
    cfg = StreamConfig(p=P, q=Q, halfwidth=4, forgetting=0.95,
                       drift_threshold=0.08, warmup_rounds=5,
                       compression=compression)
    states = stream_init(cfg, N_NETWORKS, init_bases=W0, device=xs.device)
    return batched_stream_run(cfg, states, xs)


def run(device="cuda", *, streams=None, init_bases=None) -> dict:
    """Both sweeps; returns ``eps`` and ``bits``, one row a swept value:
    worst sink error, extra packets, notification rate, bill per network
    (ε sweep) or score bits on air per network (bit sweep)."""
    dev = resolve_device(device)
    xs = (fleet_streams(dev) if streams is None
          else as_tensor(streams, torch.float32, dev))
    W0 = (random_bases(N_NETWORKS, P, Q, seed=1, device=dev)
          if init_bases is None
          else as_tensor(init_bases, torch.float32, dev))
    t0 = time.perf_counter()
    eps_rows = []
    for eps in EPSILONS:
        fin, met = run_fleet(CompressionConfig(epsilon=eps), xs, W0)
        comp = met.compression
        extras = float(comp.extra_packets.sum())
        eps_rows.append(dict(
            epsilon=eps, worst=float(comp.max_err.max()), extras=extras,
            rate=extras / READINGS,
            bill=float(fin.sched.comm_packets.mean())))
    eps_seconds = time.perf_counter() - t0
    bit_rows = []
    for bits in BIT_WIDTHS:
        fin, met = run_fleet(CompressionConfig(epsilon=EPS_FOR_BITS,
                                               score_bits=bits), xs, W0)
        comp = met.compression
        extras = float(comp.extra_packets.sum())
        bit_rows.append(dict(
            bits=bits, worst=float(comp.max_err.max()), extras=extras,
            rate=extras / READINGS,
            bits_air=float(comp.bits_on_air.sum()) / N_NETWORKS))
    return dict(eps=eps_rows, bits=bit_rows, eps_seconds=eps_seconds)


def main(argv=None) -> None:
    device = parse_device(__doc__, argv)
    print("=== ε-supervised compression fleet ===\n")
    print(f"fleet: {N_NETWORKS} networks x {N_ROUNDS} rounds, p={P}, q={Q} "
          f"({P / Q:.1f}x raw-to-score ratio)\n")
    r = run(device)
    print("-- ε sweep (full-precision scores) ------------------------")
    print(f"{'ε':>6} {'worst sink err':>15} {'notif rate':>11} "
          f"{'extras/round':>13} {'bill/network':>13}")
    for row in r["eps"]:
        eps, worst = row["epsilon"], row["worst"]
        print(f"{eps:>6.2f} {worst:>15.4f} {row['rate']:>10.1%} "
              f"{row['extras'] / (N_NETWORKS * N_ROUNDS):>13.1f} "
              f"{row['bill']:>13.0f}")
        assert worst <= eps + 1e-6, \
            f"sink error {worst} exceeded the ε={eps} guarantee"
    print(f"(swept {len(EPSILONS)} ε values in {r['eps_seconds']:.1f} s)\n")

    print(f"-- bit-width sweep (ε = {EPS_FOR_BITS}) -------------------------")
    print(f"{'bits':>6} {'worst sink err':>15} {'notif rate':>11} "
          f"{'score bits/network':>19}")
    for row in r["bits"]:
        bits, worst = row["bits"], row["worst"]
        label = "fp32" if bits == 0 else f"{bits:>4}"
        print(f"{label:>6} {worst:>15.4f} {row['rate']:>10.1%} "
              f"{row['bits_air']:>19.0f}")
        assert worst <= EPS_FOR_BITS + 1e-6, \
            f"sink error {worst} broke the guarantee at {bits}-bit scores"

    print("\nOK: sink within ε at every swept ε and every bit width — "
          "coarser scores trade notifications for bits, never accuracy.")


if __name__ == "__main__":
    main()
