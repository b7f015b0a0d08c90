"""Each cell cut to a size the CPU runs in seconds, through the port's
plain path: the same files, drivers and comparison as on the card."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

CELLS = ("regions-fleet", "flat-stream", "flat-refit")

# the planted field needs p > 64 q (its modes' bumps lie 65 sensors wide)
TINY = {
    "regions-fleet": (dict(region_p=64, halfwidth=4, q=4, n_regions=3,
                           epochs_per_round=4, chunk_rounds=2,
                           warmup_rounds=1),
                      dict(segment_rounds=6, signal_rank=2)),
    "flat-stream": (dict(p=384, halfwidth=4, q=4, batch_epochs=16), {}),
    "flat-refit": (dict(p=384, halfwidth=4, q=4, batch_epochs=16, t_max=20),
                   dict(setup_batches=3, starts=2)),
}


def tiny_cell(name: str, root: Path = ROOT):
    from wsnbench import harness
    cell = harness.find_cell(name, root)
    conf, traffic = TINY.get(name, ({}, {}))
    cell.config = dict(copy.deepcopy(cell.config), **conf)
    cell.traffic = dict(copy.deepcopy(cell.traffic), **traffic)
    return cell


def run_tiny(cell, program=None, seconds: float = 0.3, seed: int = 2**33 + 5):
    import torch
    from wsnbench import run
    return run.execute(cell, seed, seconds, False, torch.device("cpu"),
                       program=program)
