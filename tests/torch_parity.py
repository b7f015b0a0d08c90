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


def _child_env(env: dict | None) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def run_reference(mode: str, out: Path, env: dict | None = None) -> dict:
    """Run the child in ``mode``, with ``env`` added to its environment."""
    proc = subprocess.run([sys.executable, str(CHILD), mode, str(out)],
                          env=_child_env(env), capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def start_reference(mode: str, out: Path) -> subprocess.Popen:
    """Start the child in ``mode`` without waiting for it
    (:func:`finish_reference` collects it), so several run at once; each
    computes on one thread, so that they and the parent share the cores."""
    env = _child_env(dict(OMP_NUM_THREADS="1", XLA_FLAGS=(
        "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")))
    return subprocess.Popen([sys.executable, str(CHILD), mode, str(out)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_reference(proc: subprocess.Popen, out: Path) -> dict:
    log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def config_from_json(text: str) -> StreamConfig:
    d = json.loads(str(text))
    if d["compression"] is not None:
        d["compression"] = CompressionConfig(**d["compression"])
    if d["detection"] is not None:
        d["detection"] = DetectionConfig(**d["detection"])
    return StreamConfig(**d)
