"""Fault-tolerant checkpointing: atomic, async, with retention
(counterpart of ``repro.train.checkpoint``, in its on-disk format).

Layout (one directory per step)::

    <dir>/step_00000100.tmp/...      (being written)
    <dir>/step_00000100/             (atomically renamed when complete)
        manifest.json              step, leaf shapes/dtypes, extra, format 1
        shard_00000.npz            the leaves (flat "/"-joined name -> array)

A tree is nested dicts and NamedTuples of tensors (or numpy arrays and
Python scalars); a leaf's name joins its dict keys and ``.field`` for a
NamedTuple field with "/", and ``None`` holds no leaf — the names
``jax.tree_util`` paths give the reference's trees, so either package
restores what the other wrote.  bfloat16 leaves are stored
as 2-byte void (``|V2``) arrays with ``"dtype": "bfloat16"`` in the
manifest, as the reference's ``np.savez`` stores them, and read back by
viewing the bytes as ``int16`` and then as ``torch.bfloat16`` (numpy has
no bfloat16 without ``ml_dtypes``).

Guarantees
----------
* **Atomicity**: a checkpoint is visible only after ``os.replace`` of the
  tmp dir; a crash mid-write leaves the previous checkpoint intact.
* **Async**: :func:`save_async` snapshots to host memory synchronously and
  writes to disk on a worker thread.
* **Resume**: :func:`restore` fills the structure of a template on the
  template's devices and in its dtypes.
* **Retention**: the ``keep`` most recent checkpoints are retained.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

__all__ = ["save", "save_async", "wait_pending", "restore", "latest_step",
           "CheckpointError"]


class CheckpointError(RuntimeError):
    pass


def _flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``("/"-joined name, leaf)`` in the order ``jax.tree_util`` flattens
    the same tree: dict keys sorted, NamedTuple fields in order, ``None``
    skipped."""
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_paths(tree[k], join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _flatten_with_paths(getattr(tree, f), join(f".{f}"))]
    return [(prefix, tree)]


def _unflatten_like(template, leaves: dict, prefix: str = ""):
    """``template``'s structure with each leaf replaced from ``leaves``."""
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten_like(v, leaves, join(k))
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten_like(getattr(template, f), leaves, join(f".{f}"))
            for f in template._fields))
    return leaves[prefix]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array stored and the dtype named in the manifest."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)   # never the live storage
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, step: int, tree: Any, *, extra: dict | None = None,
         keep: int = 3) -> str:
    """Synchronous save with atomic publish."""
    return _write(directory, step, _snapshot(tree), extra, keep)


def _snapshot(tree) -> list[tuple[str, tuple[np.ndarray, str]]]:
    """Every leaf on the host: ``(name, (array, manifest dtype))``."""
    return [(name, _to_numpy(leaf))
            for name, leaf in _flatten_with_paths(tree)]


def _write(directory: str, step: int, snapshot, extra: dict | None,
           keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {}
    manifest_leaves = {}
    for name, (arr, dtype) in snapshot:
        arrays[name] = arr
        manifest_leaves[name] = {"shape": list(arr.shape), "dtype": dtype}
    np.savez(os.path.join(tmp, "shard_00000.npz"), **arrays)
    manifest = {"step": step, "leaves": manifest_leaves,
                "extra": extra or {}, "format": 1}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    _gc(directory, keep)
    return final


_PENDING: list[threading.Thread] = []


def save_async(directory: str, step: int, tree: Any, *,
               extra: dict | None = None, keep: int = 3) -> threading.Thread:
    """Snapshot to host memory now, write on a background thread."""
    snapshot = _snapshot(tree)                  # device -> host
    t = threading.Thread(target=_write,
                         args=(directory, step, snapshot, extra, keep),
                         daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending() -> None:
    for t in list(_PENDING):
        t.join()
        _PENDING.remove(t)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                continue
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, dtype: str | None, like) -> Any:
    """A stored array as ``like``'s kind of leaf: a tensor on ``like``'s
    device in its dtype, a Python scalar, or a numpy array."""
    if dtype == "bfloat16" and arr.dtype.kind == "V":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif arr.dtype.kind == "V":
        raise CheckpointError(f"cannot reinterpret a leaf stored as "
                              f"{arr.dtype} back to {dtype}")
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(t.item())
    return t.numpy().astype(np.asarray(like).dtype)


def restore(directory: str, template: Any, *, step: int | None = None
            ) -> tuple[Any, dict]:
    """Restore into the structure of ``template`` (its devices and dtypes).
    Returns (tree, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise CheckpointError(f"no checkpoint found in {directory}")
    final = _step_dir(directory, step)
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(final, "shard_00000.npz"))

    leaves = {}
    for name, leaf in _flatten_with_paths(template):
        if name not in data:
            raise CheckpointError(f"missing leaf {name!r} in checkpoint")
        arr = data[name]
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(arr.shape) != shape:
            raise CheckpointError(
                f"shape mismatch for {name}: ckpt {arr.shape} vs "
                f"template {shape}")
        want = manifest["leaves"].get(name, {}).get("dtype")
        leaves[name] = _from_numpy(arr, want, leaf)
    return _unflatten_like(template, leaves), manifest["extra"]


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        int(n[5:]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
