// Banded, forgetting-weighted outer-product fold, one thread an output:
// the fold blocks of kernel 1 (fused_stream.cu).  Kernels 2, 3, 6 and 7
// (band_fold.cu) tile the same sum (band_syrk.cuh).
//
//   band[s, k, i] = sum_r w[s, r / n] * (m x)[s, r, i] * (m x)[s, r, i + k - h]
//
// x is the slot's flattened chunk (R = K*n rows, p columns, row-major;
// row r = t*n + e is epoch e of round t), fp32 or — kernel 1's bf16 tile
// mode — bf16, converted to fp32 as it is loaded, so every product and the
// accumulator stay fp32 whatever the operand type; w holds one weight
// per ROUND; the optional 0/1 mask has one row per round ((K, p) liveness,
// never broadcast to the chunk's size in device memory).
//
// The sums follow the order of band_syrk.cuh, with the same intrinsics:
// s_t = fma(mx_i, mx_j, s_t) over the round's rows from 0, then
// acc = fma(w_t, s_t, acc) — symmetric in (i, j), so kernel 1's band
// equals kernels 2 and 3's bit for bit, both halves, in both tile modes
// (mx = x m: one rounding, which no contraction can remove, as the
// product feeds a multiplication).
//
// One thread owns one output (k, i), lower half included, and walks the
// rows in order, round by round (so no integer division in the loop): no
// atomics, no cross-block reduction, so the result is deterministic (the
// engine's replay determinism depends on that).  The halo column
// i + k - h is read with a bounds check instead of padding x in device
// memory.  Threads of a warp share k and hold consecutive i, so both loads
// of a row are coalesced; the 2h+1 blocks of one column tile re-read the
// same rows, which then come from L1/L2.
#pragma once

#include <cuda_runtime.h>

#include "operand.cuh"

namespace repro_torch {

constexpr int kFoldThreads = 256;

template <bool HAS_MASK, typename T = float>
__device__ __forceinline__ void band_fold_block(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ m, int K, int n, int p, int h, int block,
    float* __restrict__ band) {
  const int col_blocks = (p + kFoldThreads - 1) / kFoldThreads;
  const int k = block / col_blocks;
  const int i = (block % col_blocks) * kFoldThreads + threadIdx.x;
  if (i >= p) return;
  const int j = i + k - h;
  float acc = 0.0f;
  if (j >= 0 && j < p) {
    for (int t = 0; t < K; ++t) {
      float mi = 1.0f, mj = 1.0f;
      if (HAS_MASK) {
        mi = m[(size_t)t * p + i];
        mj = m[(size_t)t * p + j];
      }
      float s = 0.0f;
      for (int e = 0; e < n; ++e) {
        const size_t r = (size_t)t * n + e;
        float xi = to_f32(x[r * p + i]);
        float xj = to_f32(x[r * p + j]);
        if (HAS_MASK) {
          xi *= mi;
          xj *= mj;
        }
        s = __fmaf_rn(xi, xj, s);
      }
      acc = __fmaf_rn(w[t], s, acc);
    }
  }
  band[(size_t)k * p + i] = acc;
}

}  // namespace repro_torch
