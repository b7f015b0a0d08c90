"""nvcc build and ctypes loader for the CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` source compiles, with its headers, into its own shared
library with a plain C interface (``extern "C"`` entry points taking raw
device pointers and a ``cudaStream_t``), bound here with :mod:`ctypes`.
No PyTorch headers are involved, so a build takes seconds.  Libraries go
to ``build/repro_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of their sources and flags, and are built
at first use — or all at once, one ``nvcc`` per source in parallel, by
:func:`build_all` — each with its compiler log (``ptxas -v``: registers,
spills, shared memory) beside it.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "build_all",
           "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel 1's two entry points (fp32, bf16 tile mode) take the same arguments
_FUSED = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P, _P,
          _P, _P, _P, _P, _P]
# every C entry point returns cudaGetLastError() after its launch, but
# pca_reconstruct_max_q(device), stage_tile_max_q(device) and
# fused_stream_max_q(device, bf16), which return the largest q of kernel 9,
# of kernels 4 and 5, and of kernel 1
SOURCES: dict[str, dict[str, list]] = {
    "band_fold": {
        "band_fold_f32": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
        "band_fold_masked_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
        # (x, S, n, p, h, ws, band, stream) and (x, m, S, n, per_reading,
        # p, h, ws, band, stream): ws the split fold's workspace or null
        "band_round_f32": [_P, _I, _I, _I, _I, _P, _P, _P],
        # (x, band_in, S, n, p, h, ws, band, stream): kernel 6 adding into
        # band_in in its write-out
        "band_round_acc_f32": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
        "band_round_masked_f32": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    },
    "banded": {
        "banded_matmul_f32": [_P, _P, _I, _I, _I, _I, _P, _P],
        # (band, V, S, p, h, q, tile, Y, stream): kernel 10 with its tile
        # named (0 the choice of banded_matmul_f32, 1 rows64, 2 rows16)
        "banded_matmul_tile_f32": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
        "banded_matvec_f32": [_P, _P, _I, _I, _I, _P, _P],
        # kernel 11's slot shape (ops.banded_matvec_plan)
        "banded_matvec_slot_f32": [_P, _P, _I, _I, _I, _P, _P],
    },
    "fused_stream": {"fused_stream_f32": _FUSED, "fused_stream_bf16": _FUSED,
                     "fused_stream_max_q": [_I, _I]},
    "pca_project": {
        # (x, m, basis, mean, S, R, p, q, mask_div, eps, z, xh, flags,
        # stream) and (x, m, basis, mean, inv_lam, S, R, p, q, mask_div, z,
        # t2, spe, stream): kernels 4 and 5, the basis read as it lies
        "supervised_compress_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                    _P, _P, _P, _P],
        "pca_monitor_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                            _P, _P],
        "stage_tile_max_q": [_I],
        # (x, basis, S, R, p, q, z, stream) and (z, basis, S, R, p, q, xh,
        # stream): both read the (S, p, q) basis itself, not its transpose
        "pca_project_f32": [_P, _P, _I, _I, _I, _I, _P, _P],
        "pca_reconstruct_f32": [_P, _P, _I, _I, _I, _I, _P, _P],
        "pca_reconstruct_max_q": [_I],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, dict]:
    """Compile every source (or ``names``) not yet built, one ``nvcc`` per
    source, all started together; raises with the compiler's output if any
    build fails.  Returns ``{name: {"path", "seconds", "log"}}``."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            log = out.with_suffix(".log")
            build_log.setdefault(name, {
                "path": str(out), "seconds": 0.0,
                "log": log.read_text() if log.exists() else "cached"})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)     # ptxas -v, for the bill
        build_log[name] = {"path": str(out),
                           "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: build_log[name] for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, built first if needed, with
    ``argtypes``/``restype`` declared for every entry point."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SOURCES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib
