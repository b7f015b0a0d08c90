"""Streaming distributed PCA over a fleet of sensor networks (counterpart
of ``examples/streaming_pca.py``).

Measurements arrive round by round; each network folds them into its
banded covariance with an exponential forgetting factor (kernel 6, one
launch a round for the whole fleet) and a recompute scheduler refreshes
the principal-component basis only when retained variance drifts (kernel
10 for every banded product), booking the Table-1 cost of every refresh.
Halfway through the stream, half of the fleet suffers a distribution
shift — watch the scheduler fire on exactly those networks.

Run:  PYTHONPATH=src python -m repro_torch.examples.streaming_pca [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import costs
from repro_torch.device import as_tensor, resolve_device
from repro_torch.examples import normal, parse_device
from repro_torch.streaming import StreamConfig, batched_stream_run, stream_init
from repro_torch.streaming.driver import random_bases

N_NETWORKS = 64
N_ROUNDS = 120
N_PER_ROUND = 8          # measurement epochs per round
P = 32                   # sensors per network
Q = 3                    # principal components maintained
SHIFT_ROUND = 60         # distribution shift for the second half of the fleet

CFG = StreamConfig(p=P, q=Q, halfwidth=4, forgetting=0.9,
                   drift_threshold=0.1, refresh_iters=8,
                   warmup_rounds=8, n_max=8, c_max=4)


def fleet_streams(device, seed: int = 0) -> torch.Tensor:
    """(networks, rounds, n, p) measurement stream: a smoothly decaying
    variance profile, reversed from SHIFT_ROUND on for networks 32..63
    (the paper's 'air conditioning turns on' regime change)."""
    base = torch.linspace(4.0, 1.0, P, device=device)
    x = normal((N_NETWORKS, N_ROUNDS, N_PER_ROUND, P), seed, device)
    rounds = torch.arange(N_ROUNDS, device=device)[None, :, None, None]
    nets = torch.arange(N_NETWORKS, device=device)[:, None, None, None]
    use_shifted = (rounds >= SHIFT_ROUND) & (nets >= N_NETWORKS // 2)
    return x * torch.where(use_shifted, base.flip(0), base)


def run(device="cuda", *, streams=None, init_bases=None) -> dict:
    """Stream the fleet; returns every number the report prints."""
    dev = resolve_device(device)
    xs = (fleet_streams(dev) if streams is None
          else as_tensor(streams, torch.float32, dev))
    W0 = (random_bases(N_NETWORKS, P, Q, seed=1, device=dev)
          if init_bases is None
          else as_tensor(init_bases, torch.float32, dev))
    states = stream_init(CFG, N_NETWORKS, init_bases=W0, device=dev)
    t0 = time.perf_counter()
    final, metrics = batched_stream_run(CFG, states, xs)
    rho = metrics.rho.cpu().numpy()                 # (networks, rounds)
    dt = time.perf_counter() - t0
    fired = metrics.did_refresh.cpu().numpy()
    refreshes = final.sched.refreshes.cpu().numpy()
    comm = final.sched.comm_packets.cpu().numpy()

    stable, shifted = slice(0, N_NETWORKS // 2), slice(N_NETWORKS // 2, None)
    counts = np.bincount(np.where(fired[shifted])[1], minlength=N_ROUNDS)
    sched = CFG.scheduler()
    round_c, refresh_c = sched.round_cost(), sched.refresh_cost(P)
    every_round = round_c + refresh_c
    rep = costs.streaming_refresh_cost(P, Q, CFG.n_max, CFG.c_max,
                                       CFG.refresh_iters)
    return dict(
        seconds=dt, rho=rho, did_refresh=fired, refreshes=refreshes,
        comm_packets=comm, total_refreshes=int(refreshes.sum()),
        refreshes_stable=float(refreshes[stable].mean()),
        refreshes_shifted=float(refreshes[shifted].mean()),
        first_post_shift=int(np.nonzero(counts[SHIFT_ROUND:])[0][0])
        + SHIFT_ROUND,
        rho_end_stable=float(rho[stable, -1].mean()),
        rho_pre_shift_stable=float(rho[stable, SHIFT_ROUND - 1].mean()),
        rho_end_shifted=float(rho[shifted, -1].mean()),
        rho_drifted_low=float(rho[shifted, SHIFT_ROUND:].min(axis=1).mean()),
        round_cost=round_c, refresh_cost=refresh_c,
        comm_stable=float(comm[stable].mean()),
        comm_shifted=float(comm[shifted].mean()),
        every_round_bill=N_ROUNDS * every_round,
        bill_share=float(comm.mean() / (N_ROUNDS * every_round)),
        table1=(rep.communication, rep.computation, rep.memory))


def main(argv=None) -> None:
    device = parse_device(__doc__, argv)
    print("=== Streaming distributed PCA: 64-network fleet ===\n")
    print(f"fleet: {N_NETWORKS} networks x {N_ROUNDS} rounds x "
          f"{N_PER_ROUND} epochs/round, p={P} sensors, q={Q} components")
    print(f"policy: forgetting {CFG.forgetting}, refresh when retained "
          f"variance drops > {CFG.drift_threshold:.0%} since last refresh\n")
    r = run(device)
    total_rounds = N_NETWORKS * N_ROUNDS
    print(f"streamed {total_rounds} network-rounds in {r['seconds']:.1f} s "
          f"({total_rounds / r['seconds']:.0f} rounds/s, one fold launch "
          f"per round for the fleet)")
    print("\n-- scheduler activity ------------------------------------")
    print(f"refreshes/network: stable fleet half  "
          f"{r['refreshes_stable']:.2f} (warmup fit only is 1.0)")
    print(f"                   shifted fleet half "
          f"{r['refreshes_shifted']:.2f}")
    print(f"total refreshes: {r['total_refreshes']} "
          f"(first post-shift trigger at round {r['first_post_shift']}; "
          f"shift injected at round {SHIFT_ROUND})")
    print("\n-- retained variance -------------------------------------")
    print(f"end of stream: stable half  {r['rho_end_stable']:.3f}  "
          f"(pre-shift level {r['rho_pre_shift_stable']:.3f})")
    print(f"               shifted half {r['rho_end_shifted']:.3f}  "
          f"(drifted low point {r['rho_drifted_low']:.3f} before the "
          f"refresh caught it)")
    print("\n-- communication bill (packets, highest-loaded node) -----")
    print(f"per round (cov fold + drift probe): {r['round_cost']:.0f}")
    print(f"per refresh (ortho iteration + basis flood): "
          f"{r['refresh_cost']:.0f}")
    print(f"accumulated/network: stable {r['comm_stable']:.0f}, "
          f"shifted {r['comm_shifted']:.0f}")
    print(f"refresh-every-round baseline would pay "
          f"{r['every_round_bill']:.0f}/network — the scheduler spends "
          f"{r['bill_share']:.1%} of that")
    comm, comp, mem = r["table1"]
    print(f"\nTable-1 view of one refresh: comm {comm:.0f}, "
          f"compute O({comp:.0f}), memory O({mem:.0f})")

    assert r["total_refreshes"] >= 1, "no refresh triggered"
    print("\nOK: fleet streamed, drift caught, refreshes scheduled.")


if __name__ == "__main__":
    main()
