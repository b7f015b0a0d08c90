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
  ``jax.random.normal(PRNGKey(seed), (p, q))``);
* an LM's parameters (``repro.models.transformer.init_params``): the
  reference's pytree flattened to numpy arrays keyed by dotted path
  (``"embed"``, ``"layers.attn.wq"``, ``"layers.moe.router"``,
  ``"layers.ssm.in_proj"``, ``"layers.cross.wq"``, ``"meta_tokens"``,
  ``"enc_layers.attn.wq"``, ...), one array a leaf of the port's schema,
  stacked over layers as there; the other way, an LM's decode state
  (``decode_state_to_numpy``: ``"attn.k"``, ``"ssm.h"``, ``"cross_k"``,
  ...; the reference's ``DecodeState`` flattens to the same keys);
* an LM's training state (``repro.train.trainer.TrainState``): the same
  paths under ``"params."``, the AdamW step and moments as ``"opt.step"``,
  ``"opt.mu.<path>"`` and ``"opt.nu.<path>"``, and the compressor's Q
  factors and error buffers as ``"comp.q.<path>"`` and
  ``"comp.error.<path>"`` (the compressed leaves only).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.covariance import BandedCovState, CovState
from repro_torch.device import as_tensor, resolve_device
from repro_torch.models.params import tree_leaves, unflatten
from repro_torch.models.transformer import model_schema, torch_dtype
from repro_torch.streaming.detector import DetectorState
from repro_torch.streaming.driver import StreamState
from repro_torch.streaming.online_cov import OnlineCovariance
from repro_torch.streaming.scheduler import SchedulerState

__all__ = ["state_from_numpy", "state_to_numpy", "cov_state_from_numpy",
           "cov_state_to_numpy", "lm_params_from_numpy",
           "lm_params_to_numpy", "decode_state_to_numpy",
           "train_state_from_numpy", "train_state_to_numpy"]

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


def lm_params_from_numpy(cfg, flat: Mapping[str, np.ndarray], device="cuda",
                         dtype: torch.dtype | None = None) -> dict:
    """An LM's parameters from numpy arrays keyed by dotted path, checked
    one to one against the port's schema (every leaf present, with its
    shape, and nothing else), in ``dtype`` (default ``cfg.dtype``) on
    ``device``."""
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    schema = dict(tree_leaves(model_schema(cfg)))
    if set(flat) != set(schema):
        raise ValueError(
            f"parameter paths differ from the schema: missing "
            f"{sorted(set(schema) - set(flat))}, extra "
            f"{sorted(set(flat) - set(schema))}")
    out = {}
    for path, leaf in schema.items():
        a = np.asarray(flat[path], dtype=np.float32)
        if a.shape != leaf.shape:
            raise ValueError(f"{path}: shape {a.shape}, the schema's "
                             f"{leaf.shape}")
        out[path] = as_tensor(a, dt, dev)
    return unflatten(out)


def lm_params_to_numpy(params: dict) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: dotted path -> numpy
    (fp32)."""
    return {path: v.detach().float().cpu().numpy()
            for path, v in tree_leaves(params)}


def decode_state_to_numpy(state) -> dict:
    """An LM's decode state (``repro_torch.models.transformer.DecodeState``)
    as numpy arrays keyed by field path: ``"attn.k"``, ``"attn.v"``,
    ``"attn.pos"``, ``"ssm.h"``, ``"ssm.conv"``, ``"cross_k"``,
    ``"cross_v"``, each present where the family has it (bf16 widened to
    fp32)."""
    out = {}
    for name, field in zip(state._fields, state):
        if isinstance(field, torch.Tensor):
            out[name] = field
        elif field:
            out.update({f"{name}.{f}": v for f, v in zip(field._fields,
                                                          field)})
    return {k: (v.float() if v.is_floating_point() else v).detach().cpu()
            .numpy() for k, v in out.items()}


def _under(flat: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def train_state_from_numpy(cfg, tcfg, flat: Mapping[str, np.ndarray],
                           device="cuda", dtype: torch.dtype | None = None):
    """The port's :class:`repro_torch.train.trainer.TrainState` from numpy
    arrays keyed as the module docstring says: the parameters in ``dtype``
    (default ``cfg.dtype``), the moments in ``tcfg.optimizer``'s
    ``moment_dtype``, the compressor's factors in fp32 (when
    ``tcfg.compress_rank``); the step counter is ``"opt.step"``."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.trainer import TrainState

    dev = resolve_device(device)
    params = lm_params_from_numpy(cfg, _under(flat, "params."), dev, dtype)
    mdt = torch_dtype(tcfg.optimizer.moment_dtype)
    step = int(np.asarray(flat["opt.step"]))
    opt = AdamWState(
        step=torch.tensor(step, dtype=torch.int32, device=dev),
        mu=lm_params_from_numpy(cfg, _under(flat, "opt.mu."), dev, mdt),
        nu=lm_params_from_numpy(cfg, _under(flat, "opt.nu."), dev, mdt))
    state = TrainState.create(cfg, tcfg, device=dev, params=params,
                              q=_under(flat, "comp.q."))
    state.opt_state, state.step = opt, step
    if state.comp_state is not None:
        errs = _under(flat, "comp.error.")
        for path, e in tree_leaves(state.comp_state.error):
            if e is not None:
                e.copy_(as_tensor(errs[path], torch.float32, dev))
    return state


def train_state_to_numpy(state) -> dict:
    """The inverse of :func:`train_state_from_numpy` (every array as it
    lies, widened to fp32 where it is bf16)."""
    out = {f"params.{k}": v for k, v in lm_params_to_numpy(
        state.params).items()}
    out["opt.step"] = np.asarray(int(state.opt_state.step), np.int32)
    for name in ("mu", "nu"):
        out.update({f"opt.{name}.{k}": v for k, v in lm_params_to_numpy(
            getattr(state.opt_state, name)).items()})
    if state.comp_state is not None:
        for name in ("q", "error"):
            out.update({f"comp.{name}.{k}": v.detach().cpu().numpy()
                        for k, v in tree_leaves(
                            getattr(state.comp_state, name))
                        if v is not None})
    return out
