"""The yardstick's work model: floating-point operations and bytes of one
kernel launch, and the least time an H100 could take for them.

A frozen copy of ``repro_torch.analysis.resources`` (``kernel_work``,
``fold_flops``, ``band_entries``, ``bound``) as it stood when this
benchmark was written, so that a later change to the program cannot move
the yardstick.  Every input is counted read once and every output written
once.  Peaks: NVIDIA's data sheet for the H100 SXM, dense, without
sparsity: 67 TFLOP/s in fp32 outside the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

PEAK_FP32 = 67e12            # FLOP/s
PEAK_BYTES = 3.35e12         # bytes/s


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) for the work, and what bounds it: the larger of
    the operations at the fp32 peak and the bytes at the HBM rate."""
    t_ops, t_mem = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def fold_flops(S, R, p, h):
    """2 flops per multiply-add over R rows for each unique pair (i, j),
    i <= j <= i + h, j < p: the band is symmetric, so its lower diagonals
    are copies."""
    h = min(h, p - 1)
    pairs = (h + 1) * p - h * (h + 1) // 2
    return 2.0 * S * R * pairs


def band_entries(p, h):
    """In-range entries of a (2h+1, p) band: (2h+1)p - h(h+1)."""
    h = min(h, p - 1)
    return (2 * h + 1) * p - h * (h + 1)


def kernel_work(kernel: str, **d) -> tuple[float, float]:
    """``(flops, bytes)`` of one launch of ``kernel`` (a key of the
    program's launch counter).  Dimensions by kernel:

    * ``fused_stream``, ``fused_stream_bf16``: S, K, n, p, h, q, and
      ``mask`` (a (S, K, p) liveness operand), ``compress``, ``monitor``
      (default True); the bf16 mode reads x and the basis as bf16;
    * ``band_fold``, ``band_fold_masked``: S, K, n, p, h, ``mask_elems``;
    * ``band_round``, ``band_round_masked``, ``band_round_masked_drop``:
      S, n, p, h, ``mask_elems``;
    * ``supervised_compress``, ``pca_monitor``: S, R, p, q, ``mask_elems``;
    * ``pca_project``, ``pca_reconstruct``: S, R, p, q;
    * ``banded_matmul`` (S, p, h, q), ``banded_matvec`` (S, p, h): the
      band's in-range entries only (its corners are never read)."""
    S, p = d["S"], d["p"]
    f32 = 4.0
    me = d.get("mask_elems", 0)
    if kernel in ("fused_stream", "fused_stream_bf16"):
        K, n, h, q = d["K"], d["n"], d["h"], d["q"]
        R = K * n
        wc, wm = d.get("compress", True), d.get("monitor", True)
        tile = 2.0 if kernel == "fused_stream_bf16" else f32
        flops = fold_flops(S, R, p, h) + 2.0 * 2 * S * R * p * q
        nbytes = (tile * (S * R * p + S * p * q)
                  + f32 * (S * K + (S * K * p if d.get("mask") else 0)
                           + S * p + S * q + S * (2 * h + 1) * p + S * R * q
                           + (S * R * p if wc else 0)          # x_hat
                           + (2 * S * R if wm else 0))         # T2, SPE
                  + (1.0 * S * R * p if wc else 0))            # bool flags
        return flops, nbytes
    if kernel in ("band_fold", "band_fold_masked"):
        K, n, h = d["K"], d["n"], d["h"]
        return (fold_flops(S, K * n, p, h),
                f32 * (S * K * n * p + S * K + S * (2 * h + 1) * p + me))
    if kernel.startswith("band_round"):
        n, h = d["n"], d["h"]
        return (fold_flops(S, n, p, h),
                f32 * (S * n * p + S * (2 * h + 1) * p + me))
    if kernel in ("supervised_compress", "pca_monitor"):
        R, q = d["R"], d["q"]
        flops = 2.0 * 2 * S * R * p * q
        if kernel == "supervised_compress":
            return flops, (f32 * (2 * S * R * p + me + S * p * q + S * p
                                  + S * R * q) + S * R * p)
        return flops, f32 * (S * R * p + me + S * p * q + S * (p + q)
                             + S * R * q + 2 * S * R)
    if kernel in ("pca_project", "pca_reconstruct"):
        R, q = d["R"], d["q"]
        return 2.0 * S * R * p * q, f32 * (S * R * p + S * p * q + S * R * q)
    if kernel in ("banded_matmul", "banded_matvec"):
        h, q = d["h"], d.get("q", 1)
        e = band_entries(p, h)
        return 2.0 * S * q * e, f32 * (S * e + 2 * S * p * q)
    raise KeyError(f"no work model for kernel {kernel!r}")
