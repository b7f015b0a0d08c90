// Per-row stage arithmetic shared by fused_stream.cu (kernel 1) and
// pca_project.cu (kernels 4 and 5).
//
// For one block of kRows rows of one slot, at the EXACT sensor count p:
//   z   = ((x - mean) m) W                      (R, q)
//   x^  = z W^T + mean                          (R, p)  [WITH_C]
//   flags = (|x - x^| > eps) & (m > 0), strict  (R, p)  [WITH_C]
//   T2  = sum_c z_c^2 inv_lam_c                 (R,)    [WITH_M]
//   SPE = ||((x - mean) m - z W^T) m||^2        (R,)    [WITH_M]
// flags are bytes (0/1, read as torch.bool), the rest fp32.  Row r reads
// mask row r / mask_div: mask_div = n for a per-round (K, p) mask (never
// broadcast to the chunk's size in device memory), 1 for a per-row mask.
//
// The block stages its kRows centred, masked rows in shared memory and the
// kRows x q scores beside them (kRows * (p + q) floats).  The basis is not
// staged: it is read through L1/L2 (__ldg), where every block of the slot
// finds it.  Scores: one thread per (row, component), a warp reading W
// (p, q) row-contiguously.  Reconstruction: one warp per row, each lane
// striding over sensors and reading the transposed copy W^T (q, p) that the
// wrapper makes, so both its loads and the x^/flags stores are coalesced
// (reading W itself there put a warp's 32 loads on 32 cache lines, 4 bytes
// of each); SPE and T2 are warp-shuffle reductions in a fixed order, so the
// outputs are deterministic.
//
// x, the basis and its transpose are fp32 or (kernel 1's bf16 tile mode,
// T = __nv_bfloat16) bf16: each element is converted to fp32 as it is
// loaded (operand.cuh), and the staged rows, the scores and every
// sum stay fp32, as in the reference's _fused_kernel.  The flag compares
// the loaded x (bf16-rounded in that mode) with x^, as the reference does.
#pragma once

#include <cuda_runtime.h>

#include "operand.cuh"

namespace repro_torch {

constexpr int kStageThreads = 256;
constexpr int kRows = kStageThreads / 32;   // one warp per staged row

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// x^_r[i] = sum_c z_r[c] W^T[c, i] for one row, lanes over sensors; the
// same products in the same order as z W^T.
template <typename T>
__device__ __forceinline__ float reconstruct_one(
    const float* __restrict__ zr, const T* __restrict__ basis_t, int p,
    int q, int i) {
  float acc = 0.0f;
  for (int c = 0; c < q; ++c)
    acc += zr[c] * ldg_f32(basis_t + (size_t)c * p + i);
  return acc;
}

// z_s[rr, c] = sum_i xc_s[rr, i] W[i, c] for the block's rows; also
// written to z (the slot's (R, q) scores) for rows below R.
template <typename T>
__device__ __forceinline__ void stage_scores(
    const float* __restrict__ xc_s, const T* __restrict__ basis, int R,
    int p, int q, int r0, float* __restrict__ z_s, float* __restrict__ z) {
  for (int o = threadIdx.x; o < kRows * q; o += blockDim.x) {
    const int rr = o / q, c = o - rr * q;
    const float* xr = xc_s + rr * p;
    float acc = 0.0f;
    for (int i = 0; i < p; ++i)
      acc += xr[i] * ldg_f32(basis + (size_t)i * q + c);
    z_s[o] = acc;
    if (r0 + rr < R) z[(size_t)(r0 + rr) * q + c] = acc;
  }
}

// The stages of rows [r0, r0 + kRows) of one slot.  Pointers are the
// slot's: x (R, p), m (R / mask_div, p) or unused, basis (p, q), basis_t
// (q, p) its transpose, mean (p), inv_lam (q); outputs z (R, q), xh/flags
// (R, p), t2/spe (R).  smem holds kRows * (p + q) floats.
template <bool HAS_MASK, bool WITH_C, bool WITH_M, typename T = float>
__device__ __forceinline__ void stage_block(
    const T* __restrict__ x, const float* __restrict__ m, int mask_div,
    const T* __restrict__ basis, const T* __restrict__ basis_t,
    const float* __restrict__ mean, const float* __restrict__ inv_lam,
    int R, int p, int q, float eps, int r0, float* __restrict__ z,
    float* __restrict__ xh, unsigned char* __restrict__ flags,
    float* __restrict__ t2, float* __restrict__ spe, float* smem) {
  float* xc_s = smem;               // (kRows, p) centred, masked rows
  float* z_s = smem + kRows * p;    // (kRows, q) scores
  const int tid = threadIdx.x;

  for (int idx = tid; idx < kRows * p; idx += blockDim.x) {
    const int rr = idx / p, i = idx - rr * p, r = r0 + rr;
    float v = 0.0f;
    if (r < R) {
      v = to_f32(x[(size_t)r * p + i]) - mean[i];
      if (HAS_MASK) v *= m[(size_t)(r / mask_div) * p + i];
    }
    xc_s[idx] = v;
  }
  __syncthreads();

  stage_scores(xc_s, basis, R, p, q, r0, z_s, z);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int r = r0 + warp;
  if (r >= R) return;
  const float* zr = z_s + warp * q;
  const float* xr = xc_s + warp * p;
  const size_t row = (size_t)r * p;
  const float* mr = HAS_MASK ? m + (size_t)(r / mask_div) * p : nullptr;
  float spe_acc = 0.0f;
  for (int i = lane; i < p; i += 32) {
    const float xh_r = reconstruct_one(zr, basis_t, p, q, i);
    const float mv = HAS_MASK ? mr[i] : 1.0f;
    if (WITH_C) {
      const float xhv = xh_r + mean[i];
      const float err = fabsf(to_f32(x[row + i]) - xhv);
      xh[row + i] = xhv;
      flags[row + i] = (err > eps && mv > 0.0f) ? 1 : 0;
    }
    if (WITH_M) {
      const float res = (xr[i] - xh_r) * mv;
      spe_acc += res * res;
    }
  }
  if (WITH_M) {
    float t2_acc = 0.0f;
    for (int c = lane; c < q; c += 32) t2_acc += zr[c] * zr[c] * inv_lam[c];
    t2_acc = warp_sum(t2_acc);
    spe_acc = warp_sum(spe_acc);
    if (lane == 0) {
      t2[r] = t2_acc;
      spe[r] = spe_acc;
    }
  }
}

}  // namespace repro_torch
