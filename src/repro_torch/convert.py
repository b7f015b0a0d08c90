"""Carry a reference streaming state across to the port.

The reference (``repro.streaming.driver.StreamState``) draws its initial
bases from ``jax.random``, which torch cannot reproduce; a test that wants
both implementations to start from the same state flattens the reference
state to numpy arrays keyed by field path (``"cov.band"``,
``"sched.W"``, ``"det.t2_threshold"``, ...) and rebuilds it here.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.streaming.detector import DetectorState
from repro_torch.streaming.driver import StreamState
from repro_torch.streaming.online_cov import OnlineCovariance
from repro_torch.streaming.scheduler import SchedulerState

__all__ = ["state_from_numpy", "state_to_numpy"]

_INT_FIELDS = {"sched.refreshes", "rounds", "det.calib_left"}


def state_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda",
                     prefix: str = "") -> StreamState:
    """Build the port's :class:`StreamState` from numpy arrays keyed by
    field path (optionally under ``prefix``); the detector state is read
    when its keys are present.  Leaves keep their leading axes, so a
    fleet's states (the reference's ``batched_stream_init``, initial
    bases included) carry across with their networks axis."""
    dev = resolve_device(device)

    def get(name):
        a = np.asarray(arrays[prefix + name])
        dt = torch.int32 if name in _INT_FIELDS else torch.float32
        return torch.tensor(a, dtype=dt, device=dev)

    def build(cls, group):
        return cls(*(get(f"{group}.{f}") for f in cls._fields))

    det = (build(DetectorState, "det")
           if prefix + "det.t2_threshold" in arrays else None)
    return StreamState(cov=build(OnlineCovariance, "cov"),
                       sched=build(SchedulerState, "sched"),
                       rounds=get("rounds"), alive=get("alive"), det=det)


def state_to_numpy(state: StreamState, prefix: str = "") -> dict:
    """The inverse of :func:`state_from_numpy`: field path -> numpy."""
    out = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            for f, v in zip(node._fields, node):
                walk(v, f"{path}.{f}" if path else f)
        else:
            out[prefix + path] = node.detach().cpu().numpy()

    walk(state, "")
    return out
