"""Fault-tolerant streaming PCA: a fleet surviving loss, death and revival
(counterpart of ``examples/faulty_fleet.py``).

A 32-network fleet streams under 10% per-hop packet loss (every booked
packet pays the expected ARQ retransmissions), and halfway through, half
the fleet suffers a node-death wave: 25% of each victim network's sensors
go dark for 15 rounds before a battery swap revives them.  Dead sensors
are masked (kernel 7, the masked per-round fold), the churn triggers a
refresh, and the bill books the lossy Table-1 costs.

The acceptance gate: every network ends within 5% of its fault-free
retained variance, at <= 2x the fault-free packet bill.  A coda runs the
fault-aware serving engine on a network that dies outright: the health
monitor rules it stalled, the engine retires it, re-plans the fleet mesh
and re-admits the network when its liveness schedule revives it.

Run:  PYTHONPATH=src python -m repro_torch.examples.faulty_fleet [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.faults import FaultModel, death_wave
from repro_torch.device import as_tensor, resolve_device
from repro_torch.examples import normal, parse_device
from repro_torch.serve.engine import StreamingPCAEngine, StreamRequest
from repro_torch.streaming import StreamConfig, batched_stream_run, stream_init
from repro_torch.streaming.driver import random_bases

N_NETWORKS = 32
N_ROUNDS = 80
N_PER_ROUND = 8
P = 32                   # sensors per network
Q = 3                    # principal components maintained
LINK_LOSS = 0.1          # per-hop packet loss
WAVE_ROUND = 30          # node-death wave hits here...
REVIVE_ROUND = 45        # ...battery swap here
WAVE_FRACTION = 0.25     # sensors killed per victim network

BASE = dict(p=P, q=Q, halfwidth=4, forgetting=0.95, drift_threshold=0.08,
            refresh_iters=8, warmup_rounds=8, n_max=8, c_max=4)
CFG_CLEAN = StreamConfig(**BASE)
CFG_FAULT = StreamConfig(**BASE, link_loss=LINK_LOSS, max_retries=3)
FAULTS = FaultModel(link_loss=LINK_LOSS, max_retries=3)


def fleet_streams(device, seed: int = 0) -> torch.Tensor:
    """(networks, rounds, n, p): three dominant sensors over a weak tail,
    so the top-q subspace has a clear eigengap."""
    scale = torch.cat([torch.tensor([4.0, 3.4, 2.8], device=device),
                       torch.linspace(1.2, 0.8, P - 3, device=device)])
    return normal((N_NETWORKS, N_ROUNDS, N_PER_ROUND, P), seed,
                  device) * scale


def fleet_liveness(seed: int = 1) -> np.ndarray:
    """(networks, rounds, p) liveness: the wave hits networks 16..31."""
    masks = np.ones((N_NETWORKS, N_ROUNDS, P), np.float32)
    rng = np.random.default_rng(seed)
    for i in range(N_NETWORKS // 2, N_NETWORKS):
        churn = death_wave(rng, P, round=WAVE_ROUND, fraction=WAVE_FRACTION,
                           revive_round=REVIVE_ROUND)
        masks[i] = churn.liveness(P, N_ROUNDS).astype(np.float32)
    return masks


def engine_coda(device, engine_bases=None) -> dict:
    """The serving engine (2 slots) on three requests of 40 rounds; request
    0 blacks out in rounds 12..25 and revives."""
    eng = StreamingPCAEngine(
        CFG_FAULT, slots=2, seed=0, device=device,
        init_bases=None if engine_bases is None
        else as_tensor(engine_bases, torch.float32, device))
    rng = np.random.default_rng(2)
    live = np.ones((40, P), np.float32)
    live[12:26, :] = 0.0                      # total blackout, then revival
    reqs = [StreamRequest(rounds=rng.normal(size=(40, N_PER_ROUND, P))
                          .astype(np.float32),
                          liveness=live if i == 0 else None)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    dead = reqs[0]
    return dict(
        dead_retirements=len(dead.retirements),
        dead_reasons=[r.reason for r in dead.retirements],
        dead_rounds=[r.rounds for r in dead.retirements],
        rounds_before_stall=dead.retirements[0].rounds
        if dead.retirements else None,
        rounds_after_revival=dead.result.rounds,
        dead_done=dead.done, dead_final_reason=dead.result.reason,
        plans=[(pl.data, pl.model) for pl in eng.plan_history],
        results=[dict(rounds=r.result.rounds, reason=r.result.reason,
                      refreshes=r.result.refreshes,
                      comm_packets=r.result.comm_packets,
                      retained=r.result.retained) for r in reqs])


def run(device="cuda", *, streams=None, init_bases=None, masks=None,
        engine_bases=None) -> dict:
    """Both fleet runs and the engine coda; returns every number the
    report prints."""
    dev = resolve_device(device)
    xs = (fleet_streams(dev) if streams is None
          else as_tensor(streams, torch.float32, dev))
    m = as_tensor(fleet_liveness() if masks is None else masks,
                  torch.float32, dev)
    W0 = (random_bases(N_NETWORKS, P, Q, seed=1, device=dev)
          if init_bases is None
          else as_tensor(init_bases, torch.float32, dev))
    t0 = time.perf_counter()
    fin_c, met_c = batched_stream_run(
        CFG_CLEAN, stream_init(CFG_CLEAN, N_NETWORKS, init_bases=W0,
                               device=dev), xs)
    fin_f, met_f = batched_stream_run(
        CFG_FAULT, stream_init(CFG_FAULT, N_NETWORKS, init_bases=W0,
                               device=dev), xs, m)
    rho_f = met_f.rho.cpu().numpy()[:, -1]
    dt = time.perf_counter() - t0
    rho_c = met_c.rho.cpu().numpy()[:, -1]
    bill_c = fin_c.sched.comm_packets.cpu().numpy()
    bill_f = fin_f.sched.comm_packets.cpu().numpy()
    ref_c = fin_c.sched.refreshes.cpu().numpy()
    ref_f = fin_f.sched.refreshes.cpu().numpy()
    fired_f = met_f.did_refresh.cpu().numpy()
    stable, waved = slice(0, N_NETWORKS // 2), slice(N_NETWORKS // 2, None)
    rel = np.abs(rho_f - rho_c) / rho_c
    out = dict(
        seconds=dt, rho_clean=rho_c, rho_fault=rho_f, bill_clean=bill_c,
        bill_fault=bill_f, refreshes_clean=ref_c, refreshes_fault=ref_f,
        did_refresh_fault=fired_f,
        did_refresh_clean=met_c.did_refresh.cpu().numpy(),
        refreshes_untouched=float(ref_f[stable].mean()),
        refreshes_waved=float(ref_f[waved].mean()),
        wave_hits=float(fired_f[waved][:, WAVE_ROUND].mean()),
        revive_hits=float(fired_f[waved][:, REVIVE_ROUND].mean()),
        rel_gap=rel, worst_rel_gap=float(rel.max()),
        bill_ratio=bill_f / bill_c, worst_ratio=float((bill_f
                                                       / bill_c).max()))
    out.update(engine_coda(dev, engine_bases))
    return out


def main(argv=None) -> None:
    device = parse_device(__doc__, argv)
    print("=== Fault-tolerant streaming PCA: 32-network fleet ===\n")
    print(f"fleet: {N_NETWORKS} networks x {N_ROUNDS} rounds, p={P}, q={Q}")
    print(f"faults: {LINK_LOSS:.0%} per-hop loss (E[tx] = "
          f"{FAULTS.expected_transmissions():.3f} per packet), death wave "
          f"at round {WAVE_ROUND} ({WAVE_FRACTION:.0%} of sensors in half "
          f"the fleet), revival at round {REVIVE_ROUND}\n")
    r = run(device)
    print(f"streamed both runs ({2 * N_NETWORKS * N_ROUNDS} network-rounds) "
          f"in {r['seconds']:.1f} s\n")
    print("-- churn response -----------------------------------------")
    print(f"refreshes/network: untouched half {r['refreshes_untouched']:.2f}"
          f", waved half {r['refreshes_waved']:.2f} "
          f"(fault-free run: {r['refreshes_clean'].mean():.2f})")
    print(f"churn triggers: {r['wave_hits']:.0%} of waved networks "
          f"refreshed at the death round, {r['revive_hits']:.0%} at the "
          f"revival round")
    print("\n-- retained variance at end of stream ---------------------")
    print(f"fault-free {r['rho_clean'].mean():.3f}, faulty "
          f"{r['rho_fault'].mean():.3f}, worst relative gap "
          f"{r['worst_rel_gap']:.2%}")
    print("\n-- packet bill --------------------------------------------")
    print(f"fault-free {r['bill_clean'].mean():.0f}/network, faulty "
          f"{r['bill_fault'].mean():.0f}/network, worst ratio "
          f"{r['worst_ratio']:.2f}x (loss factor alone would be "
          f"{FAULTS.expected_transmissions():.2f}x)")
    rel, ratio = r["rel_gap"], r["bill_ratio"]
    assert (rel <= 0.05).all(), \
        f"retained variance drifted >5% on networks {np.nonzero(rel > 0.05)[0]}"
    assert (ratio <= 2.0).all(), \
        f"packet bill exceeded 2x on networks {np.nonzero(ratio > 2.0)[0]}"

    print("\n-- engine: death, stall verdict, revival, re-admission ----")
    print(f"network 0: {r['dead_retirements']} dead retirement(s) "
          f"(streamed {r['rounds_before_stall']} rounds before the stall "
          f"verdict), then re-admitted and completed "
          f"{r['rounds_after_revival']} more rounds")
    print(f"mesh re-plans as the live count moved: {r['plans']}")
    assert r["dead_done"] and r["dead_final_reason"] == "completed"
    assert r["dead_retirements"] == 1 and r["dead_reasons"][0] == "dead"

    print("\nOK: fleet survived loss + churn within 5% accuracy at "
          f"{r['worst_ratio']:.2f}x <= 2x the fault-free bill.")


if __name__ == "__main__":
    main()
