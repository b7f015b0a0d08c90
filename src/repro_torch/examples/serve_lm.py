"""Serving example: continuous-batching engine with batched requests
(counterpart of ``examples/serve_lm.py``).

Initializes a small model, submits a burst of requests with different
prompts/lengths, and drives the slot-based engine: prefill on admission,
one decode step per tick for every active slot, refill on completion.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
          --requests 12 --slots 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, Request, ServeConfig


def run(requests: int = 12, slots: int = 4, max_new: int = 16,
        small: bool = True, device="cuda") -> dict:
    """Serve the burst; returns the requests, the ticks and the wall time."""
    dev = resolve_device(device)
    cfg = configs.get("lm100m").smoke() if small else configs.get("lm100m")
    params = T.init_params(cfg, 0, device=dev)
    engine = Engine(cfg, params, ServeConfig(slots=slots, max_len=128),
                    device=dev)

    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(requests):
        plen = int(rng.integers(4, 24))
        req = Request(prompt=rng.integers(0, cfg.vocab_size, plen)
                      .astype(np.int32),
                      max_new_tokens=max_new)
        reqs.append(req)
        engine.submit(req)

    t0 = time.perf_counter()
    ticks = 0
    while any(not r.done for r in reqs):
        n = engine.step()
        ticks += 1
        if n == 0 and not engine.queue:
            break
    return dict(requests=reqs, ticks=ticks, seconds=time.perf_counter() - t0,
                device=dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--small", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.requests, args.slots, args.max_new, args.small,
              args.device)
    reqs, dt, dev = out["requests"], out["seconds"], out["device"]
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU")
    total_tokens = sum(len(r.output) for r in reqs)
    print(f"{len(reqs)} requests, {total_tokens} tokens in {out['ticks']} "
          f"ticks, {dt:.2f}s ({total_tokens/dt:.1f} tok/s on {where})")
    for i, r in enumerate(reqs[:4]):
        print(f"req{i}: prompt[{len(r.prompt)}] -> {r.output}")


if __name__ == "__main__":
    main()
