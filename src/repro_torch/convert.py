"""Carry a reference state across to the port.

The reference draws its initial bases and vectors from ``jax.random``,
which torch cannot reproduce; a test that wants both implementations to
start from the same state flattens the reference state to numpy arrays
keyed by field path and rebuilds it here:

* a streaming state (``repro.streaming.driver.StreamState``: ``"cov.band"``,
  ``"sched.W"``, ``"det.t2_threshold"``, ...);
* a covariance state of ``repro.core.covariance`` (``CovState``:
  ``"t"``, ``"s"``, ``"sxy"``, ``"mask"``; ``BandedCovState``: ``"t"``,
  ``"s"``, ``"band"``, the half-width read from the band's shape);
* the initial vectors of ``repro.core.pca.DistributedPCA`` need no
  conversion: ``DistributedPCA(init=)`` and the iterations' ``v0=`` take
  the reference's draws as numpy (for ``power`` the q draws
  ``jax.random.normal(k, (p,))`` over ``jax.random.split(PRNGKey(seed),
  q)``, stacked (q, p); for ``ortho`` the draw
  ``jax.random.normal(PRNGKey(seed), (p, q))``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.covariance import BandedCovState, CovState
from repro_torch.device import as_tensor, resolve_device
from repro_torch.streaming.detector import DetectorState
from repro_torch.streaming.driver import StreamState
from repro_torch.streaming.online_cov import OnlineCovariance
from repro_torch.streaming.scheduler import SchedulerState

__all__ = ["state_from_numpy", "state_to_numpy", "cov_state_from_numpy",
           "cov_state_to_numpy"]

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


def cov_state_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda",
                         prefix: str = "") -> CovState | BandedCovState:
    """A reference covariance state from numpy arrays keyed by field
    (under ``prefix``): a :class:`BandedCovState` when a ``band`` is
    present, else a :class:`CovState`."""
    dev = resolve_device(device)

    def get(name, dtype=torch.float32):
        return as_tensor(arrays[prefix + name], dtype, dev)

    if prefix + "band" in arrays:
        band = get("band")
        return BandedCovState(t=get("t"), s=get("s"), band=band,
                              halfwidth=(band.shape[0] - 1) // 2)
    return CovState(t=get("t"), s=get("s"), sxy=get("sxy"),
                    mask=get("mask", torch.bool))


def cov_state_to_numpy(state: CovState | BandedCovState,
                       prefix: str = "") -> dict:
    """The inverse of :func:`cov_state_from_numpy`: field -> numpy (the
    half-width stays implicit in the band's shape)."""
    return {prefix + f: v.detach().cpu().numpy()
            for f, v in zip(state._fields, state) if f != "halfwidth"}
