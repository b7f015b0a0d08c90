// Kernels 2 and 3 of the port: the chunk band fold, plain and masked; and
// kernels 6 and 7: the per-round band fold, plain and masked.
//
// Replaces repro/kernels/cov_update.py::cov_band_update_chunk_pallas
// (pallas_call at :171, body _chunk_kernel :123),
// cov_band_update_chunk_masked_pallas (:228, body _chunk_masked_kernel
// :185), cov_band_update_pallas (:53, body _kernel :26) and
// cov_band_update_masked_pallas (:108, body _masked_kernel :66).  The
// Pallas kernels accumulate a (2h+1, block_p) tile in VMEM over a
// sequential row grid; here the fleet's slot axis is a grid dimension
// (one launch folds every slot's chunk or round).  The per-round kernels
// are the chunk fold at K = 1 without the weight (cov_update.py:159-162
// says the same of the reference): the per-round mask is a (S, p)
// liveness row read once for all n rows, or a (S, n, p) dropout mask —
// never a liveness row broadcast to (S, n, p) in device memory, as the
// reference wrapper does (repro/kernels/ops.py:245).
//
// All four are one banded SYRK (band_syrk.cuh): register-tiled 64 x 64
// tiles of the upper band, x staged through shared memory by cp.async,
// half the band computed and mirrored, in a per-round order of sums that
// is symmetric in (i, j), so the mirror, kernel 1's fold blocks and, at
// K = 1 and w = 1, kernels 6 and 7 all give the same bits.  Kernels 6 and
// 7 are the tile at K = 1 with unit weight, in the round's shape
// (band_syrk.cuh, ROUND: one accumulator set, 16-row stages, a leaner
// epilogue), on the same grid as kernels 2 and 3.
//
// Bound at the slice shape (p=1024, h=128, R=K*n=256 rows), per slot per
// step: the band is symmetric (band[h-d, i] = band[h+d, i-d]), so the
// function needs one multiply-add per row for each unique pair |i-j| <= h,
// (h+1)p - h(h+1)/2 = 123,840 pairs: 2*256*123,840 = 63 MFLOP (the weight
// and mask multiplies are not counted); bytes: x 1 MB (+ mask 32 KB
// per-round) read once and the band 1.05 MB written once, ~2.1 MB.  At
// 67 TFLOP/s fp32 (no tensor cores: TF32 would change the reference's
// precision) against 3.35 TB/s that is 0.95 us of arithmetic against 0.63
// us of memory: bound by operations.  The tiles compute ~1.24x the unique
// pairs (the quarters of a tile that meet the band), and each fused
// multiply-add needs 3/32 of a shared load.  A round (R = n = 32 rows)
// does an eighth of the arithmetic and writes the same band: 0.12 us
// against 0.35 us, bound by the band's writeback — which is why the chunk
// kernel exists.  On the card a round is held by its instructions instead
// (the arithmetic and the epilogue's stores, band_syrk.cuh): a band kept
// in L2 makes it barely faster, so kernels 6 and 7 take the tile's round
// shape.
#include "band_syrk.cuh"

namespace repro_torch {

// Kernels 2 and 3: one block a tile of the upper band (band_syrk.cuh),
// grid (row tiles x column offsets, S).  Four blocks an SM at most 128
// registers a thread.
template <bool HAS_MASK, bool PER_READING>
__global__ void __launch_bounds__(kSyrkThreads, 4)
band_syrk_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ m, int K, int n, int p, int h,
                 bool vec, float* __restrict__ band) {
  extern __shared__ __align__(16) float syrk_smem[];
  const size_t s = blockIdx.y;
  const size_t m_rows = PER_READING ? (size_t)K * n : (size_t)K;
  band_syrk_tile<HAS_MASK, PER_READING>(
      x + s * K * n * p, w + s * K, HAS_MASK ? m + s * m_rows * p : nullptr,
      K, n, p, h, vec, blockIdx.x, band + s * (2 * h + 1) * p, syrk_smem);
}

// Kernels 6 and 7: the same tile over one round, in the round's shape
// (ROUND: K = 1, unit weight; the weight and K arguments, which
// launch_syrk passes to either kernel, are unread).  Five blocks an SM at
// most 102 registers a thread (the round keeps one accumulator set).
template <bool HAS_MASK, bool PER_READING>
__global__ void __launch_bounds__(kSyrkThreads, 5)
band_round_kernel(const float* __restrict__ x, const float* __restrict__,
                  const float* __restrict__ m, int, int n, int p, int h,
                  bool vec, float* __restrict__ band) {
  extern __shared__ __align__(16) float syrk_smem[];
  const size_t s = blockIdx.y;
  const size_t m_rows = PER_READING ? (size_t)n : 1;
  band_syrk_tile<HAS_MASK, PER_READING, /*ROUND=*/true>(
      x + s * n * p, nullptr, HAS_MASK ? m + s * m_rows * p : nullptr, 1, n,
      p, h, vec, blockIdx.x, band + s * (2 * h + 1) * p, syrk_smem);
}

static bool aligned16(const void* ptr) {
  return (reinterpret_cast<size_t>(ptr) & 15) == 0;
}

// Kernels 2 and 3 (a chunk of K rounds, one weight each), or with ROUND
// kernels 6 and 7 (one round: K = 1, w unread).
template <bool HAS_MASK, bool PER_READING, bool ROUND>
static int launch_syrk(const float* x, const float* w, const float* m,
                       int S, int K, int n, int p, int h, float* band,
                       void* stream) {
  constexpr size_t smem =
      sizeof(float) * syrk_smem_floats<HAS_MASK && PER_READING, ROUND>();
  if (S < 1 || K < 1 || n < 1 || p < 1 || h < 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = ROUND ? band_round_kernel<HAS_MASK, PER_READING>
                      : band_syrk_kernel<HAS_MASK, PER_READING>;
  if (smem > 48 * 1024) {   // the chunk's dropout mask stages: 64 KB
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = p % 4 == 0 && aligned16(x) && (!HAS_MASK || aligned16(m));
  dim3 grid((p + kSyrkT - 1) / kSyrkT * syrk_offsets(p, h), S);
  kernel<<<grid, kSyrkThreads, smem, (cudaStream_t)stream>>>(
      x, w, m, K, n, p, h, vec, band);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" {

// x (S, K*n, p), w (S, K), band (S, 2h+1, p); all fp32, contiguous.
int band_fold_f32(const float* x, const float* w, int S, int K, int n,
                  int p, int h, float* band, void* stream) {
  return repro_torch::launch_syrk<false, false, false>(x, w, nullptr, S, K, n,
                                                      p, h, band, stream);
}

// As band_fold_f32 with a 0/1 mask: (S, K, p) per-round liveness, or
// (S, K*n, p) per-reading dropout when per_reading is set.
int band_fold_masked_f32(const float* x, const float* w, const float* m,
                         int S, int K, int n, int per_reading, int p, int h,
                         float* band, void* stream) {
  if (per_reading)
    return repro_torch::launch_syrk<true, true, false>(x, w, m, S, K, n, p, h,
                                                      band, stream);
  return repro_torch::launch_syrk<true, false, false>(x, w, m, S, K, n, p, h,
                                                     band, stream);
}

// Kernel 6: x (S, n, p) one round per slot, band (S, 2h+1, p);
// band[s, k, i] = sum_r x[s, r, i] x[s, r, i + k - h].
int band_round_f32(const float* x, int S, int n, int p, int h, float* band,
                   void* stream) {
  return repro_torch::launch_syrk<false, false, true>(
      x, nullptr, nullptr, S, 1, n, p, h, band, stream);
}

// Kernel 7: as band_round_f32 with a 0/1 mask: (S, p) liveness, or
// (S, n, p) per-reading dropout when per_reading is set.
int band_round_masked_f32(const float* x, const float* m, int S, int n,
                          int per_reading, int p, int h, float* band,
                          void* stream) {
  if (per_reading)
    return repro_torch::launch_syrk<true, true, true>(x, nullptr, m, S, 1, n,
                                                       p, h, band, stream);
  return repro_torch::launch_syrk<true, false, true>(x, nullptr, m, S, 1, n,
                                                      p, h, band, stream);
}

}  // extern "C"
