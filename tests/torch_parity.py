"""Helpers shared by the port's parity tests (imports no JAX).

:func:`run_reference` runs tests/torch_ref_child.py — the JAX reference —
in a child process and returns its ``.npz`` as a dict; the child, not this
process, aliases the names jax 0.9 moved out of ``jax.core``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from repro_torch.streaming import (CompressionConfig, DetectionConfig,
                                   StreamConfig)

ROOT = Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "torch_ref_child.py"


def run_reference(mode: str, out: Path, env: dict | None = None) -> dict:
    """Run the child in ``mode``, with ``env`` added to its environment."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, str(CHILD), mode, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def config_from_json(text: str) -> StreamConfig:
    d = json.loads(str(text))
    if d["compression"] is not None:
        d["compression"] = CompressionConfig(**d["compression"])
    if d["detection"] is not None:
        d["detection"] = DetectionConfig(**d["detection"])
    return StreamConfig(**d)
