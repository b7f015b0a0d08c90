"""The WSN system's examples on the port (counterparts of ``examples/``).

One module per example, each runnable as
``python -m repro_torch.examples.<name> [--device cpu]``:

* :mod:`.streaming_pca` — a 64-network fleet streaming round by round,
  half of it shifted mid-stream; the gate: at least one refresh;
* :mod:`.faulty_fleet` — 10% link loss and a node-death wave; the gates:
  within 5% of the fault-free retained variance at <= 2x its bill, and
  the engine retiring a network that died and re-admitting it;
* :mod:`.compression_fleet` — ε-supervised compression over an ε sweep
  and a score bit-width sweep; the gate: the worst sink error <= ε;
* :mod:`.event_fleet` — T²/SPE monitoring with injected AC events; the
  gates: TPR > 80%, FPR < 5%;
* :mod:`.quickstart` — the paper's pipeline on the Berkeley surrogate;
* :mod:`.event_detection` — the low-variance detector; its gate as the
  reference's.

Each module keeps the reference example's configuration as its own
constants and has ``run(device="cuda", ...) -> dict`` (every number the
report prints, as plain numbers and numpy arrays) and ``main()`` (the
report and the gate's assertions, with the reference's thresholds and
messages).  ``run`` draws its data from a seeded ``torch.Generator`` on
the device, or from the ported numpy helpers where the reference uses
numpy; the draws can also be given (``streams=``, ``init_bases=``, ...).
"""

from __future__ import annotations

import argparse

import torch

__all__ = ["parse_device", "normal"]


def parse_device(doc: str | None, argv=None) -> str:
    """The ``--device`` of an example's command line (default ``cuda``)."""
    ap = argparse.ArgumentParser(description=(doc or "").split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    return ap.parse_args(argv).device


def normal(shape, seed: int, device) -> torch.Tensor:
    """Standard normal draws from ``torch.Generator(device).manual_seed``,
    made on ``device``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=g, device=device)
