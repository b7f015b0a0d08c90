"""The Hopper block plan of the port's CUDA kernels (counterpart of
``repro.launch.tiling``).

The reference derives its Pallas kernels' block targets from a v5e
machine model (VMEM, the HBM ridge point).  The port's kernels fix their
tiles in the CUDA sources (``kernels/csrc``); this module states them, and
the largest q each kernel family takes, derived from the H100's opt-in
shared memory per block (``analysis.resources.H100.smem_per_block``) by
the sources' own shared-memory formulas.  It changes no kernel and no
wrapper: the C entries ``fused_stream_max_q``, ``stage_tile_max_q`` and
``pca_reconstruct_max_q`` ask the device, and a test on the card holds
them equal to :func:`max_q` here (276, 208 and 224 on the H100).

Tiles (``block_targets``):

* ``"cov"`` — the band fold (``band_syrk.cuh``, kernels 2, 3, 6, 7 and
  kernel 1's fold blocks): 64 x 64 output tiles of 128 threads, 8 rows x 4
  columns a thread; 32 rows of x a stage, 2 stages (a round: 16 rows);
* ``"stage"`` / ``"fused"`` — the stage tile (``stage_tile.cuh``, kernel
  1's stage blocks and kernels 4 and 5): 64 rows a block of 128 threads
  (kernels 4 and 5 also 32, for a round of at most 32 rows), 32 sensors a
  slice of the projection, 64 sensors a tile of the reconstruction;
* ``"banded"`` — kernel 10 (``banded.cu``): "rows64", 64 rows x up to 32
  columns a block, slices of 32 diagonals, 2 in flight; "rows16", 16 rows
  x up to 16 columns, 3 in flight, where the rows64 grid would leave the
  SMs under 4 blocks each.
"""

from __future__ import annotations

from repro_torch.analysis.resources import H100

__all__ = ["SMEM_BYTES", "block_targets", "max_q"]

SMEM_BYTES = H100.smem_per_block        # opt-in shared memory per block

_TILES = {
    "cov": {"rows": 64, "features": 64, "rows_per_thread": 8,
            "cols_per_thread": 4, "threads": 128, "stage_rows": 32,
            "stages": 2, "round_rows": 16},
    "stage": {"rows": 64, "rows_small": 32, "features": 64,
              "slice": 32, "threads": 128},
    "fused": {"rows": 64, "features": 64, "slice": 32, "threads": 128},
    "banded": {"rows": 64, "features": 32, "rows_small": 16,
               "features_small": 16, "slice": 32, "threads": 64},
}


def _dtype_bytes(dtype: str) -> int:
    return {"fp32": 4, "float32": 4, "bf16": 2, "bfloat16": 2}[dtype]


def block_targets(kind: str, dtype: str = "fp32") -> dict[str, int]:
    """The tile a kernel family uses: ``{"rows": ..., "features": ...}``
    and its other dimensions (module docstring).  ``kind`` is one of the
    reference's four (``"cov"``, ``"stage"``, ``"fused"``, ``"banded"``);
    ``dtype`` the tile-load dtype — only kernel 1's bf16 tile mode loads
    bf16, and its tiles are the fp32 ones."""
    if kind not in _TILES:
        raise ValueError(f"unknown kernel family {kind!r}")
    _dtype_bytes(dtype)
    return dict(_TILES[kind])


def _round_up(v: int, to: int) -> int:
    return (v + to - 1) // to * to


def _stage_tile_floats(q: int, wide: bool, bm: int = 64) -> int:
    """``stage_tile.cuh::stage_tile_smem_floats``."""
    scores = bm * (_round_up(q, 4) + 4)
    a = 2 * (bm * 36 + 32 * 32) + (2 * (bm * 32 + 32 * 32) // 2 if wide
                                   else 0)
    b = (2 * 64 * _round_up(q, 4) + bm * 68
         + (2 * 64 * _round_up(q, 8) // 2 if wide else 0))
    return scores + max(a, b)


def _fused_floats(q: int, wide: bool) -> int:
    """``fused_stream.cu::fused_smem_bytes`` / 4: the larger of the fold
    block's stages and the stage tile."""
    fold = 2 * 32 * (2 + (1 if wide else 0)) * 64
    return max(fold, _stage_tile_floats(q, wide))


def _reconstruct_floats(q: int) -> int:
    """``pca_project.cu::rec_smem_floats``."""
    return 8 * 8 * (_round_up(q, 4) + 4) + 3 * 4 * 16 * _round_up(q, 4)


def max_q(entry: str, smem_bytes: int = SMEM_BYTES) -> int:
    """The largest q whose shared memory fits ``smem_bytes`` for a C
    entry's kernel: ``"fused_stream"`` (fp32), ``"fused_stream_bf16"``,
    ``"stage_tile"`` (kernels 4 and 5), ``"pca_reconstruct"`` (kernel
    9)."""
    floats = {"fused_stream": lambda q: _fused_floats(q, False),
              "fused_stream_bf16": lambda q: _fused_floats(q, True),
              "stage_tile": lambda q: _stage_tile_floats(q, False),
              "pca_reconstruct": _reconstruct_floats}[entry]
    q = 0
    while 4 * floats(q + 1) <= smem_bytes:
        q += 1
    return q
