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
// (one launch folds every slot's chunk or round) and each thread owns one
// band entry (band_fold.cuh).  The per-round kernels are the chunk kernel
// at K = 1 without the weight (cov_update.py:159-162 says the same of the
// reference): the per-round mask is a (S, p) liveness row read once for
// all n rows, or a (S, n, p) dropout mask — never a liveness row
// broadcast to (S, n, p) in device memory, as the reference wrapper does
// (repro/kernels/ops.py:245).
//
// Bound at the slice shape (p=1024, h=128, R=K*n=256 rows), per slot per
// step: the band is symmetric (band[h-d, i] = band[h+d, i-d]), so the
// function needs one multiply-add per row for each unique pair |i-j| <= h,
// (h+1)p - h(h+1)/2 = 123,840 pairs: 2*256*123,840 = 63 MFLOP (the weight
// and mask multiplies are not counted); bytes: x 1 MB (+ mask 32 KB
// per-round) read once and the band 1.05 MB written once, ~2.1 MB.  At
// 67 TFLOP/s fp32 (no tensor cores) against 3.35 TB/s that is 0.95 us of
// arithmetic against 0.63 us of memory: bound by operations.  A round
// (R = n = 32 rows) does an eighth of the arithmetic and writes the same
// band: 0.12 us against 0.35 us, bound by the band's writeback — which is
// why the chunk kernel exists.  This simple version computes both halves
// of the band and runs far above either bound (PERF.md): every output
// re-reads two rows of x per row from L1/L2 and does one multiply-add per
// two loads; a version that folds half the band and mirrors it, keeps a
// row window in shared memory and gives each thread several diagonals is
// later work.
#include "band_fold.cuh"

namespace repro_torch {

template <bool HAS_MASK, bool WEIGHTED>
__global__ void __launch_bounds__(kFoldThreads)
band_fold_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ m, int K, int n,
                 bool per_reading, int p, int h, float* __restrict__ band) {
  const size_t s = blockIdx.y;
  const size_t m_rows = per_reading ? (size_t)K * n : (size_t)K;
  band_fold_block<HAS_MASK, WEIGHTED>(
      x + s * K * n * p, WEIGHTED ? w + s * K : nullptr,
      HAS_MASK ? m + s * m_rows * p : nullptr,
      K, n, per_reading, p, h, blockIdx.x, band + s * (2 * h + 1) * p);
}

template <bool HAS_MASK, bool WEIGHTED = true>
static int launch(const float* x, const float* w, const float* m, int S,
                  int K, int n, int per_reading, int p, int h, float* band,
                  void* stream) {
  const int col_blocks = (p + kFoldThreads - 1) / kFoldThreads;
  dim3 grid(col_blocks * (2 * h + 1), S);
  band_fold_kernel<HAS_MASK, WEIGHTED><<<grid, kFoldThreads, 0,
                                         (cudaStream_t)stream>>>(
      x, w, m, K, n, per_reading != 0, p, h, band);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" {

// x (S, K*n, p), w (S, K), band (S, 2h+1, p); all fp32, contiguous.
int band_fold_f32(const float* x, const float* w, int S, int K, int n,
                  int p, int h, float* band, void* stream) {
  return repro_torch::launch<false>(x, w, nullptr, S, K, n, 0, p, h, band,
                                    stream);
}

// As band_fold_f32 with a 0/1 mask: (S, K, p) per-round liveness, or
// (S, K*n, p) per-reading dropout when per_reading is set.
int band_fold_masked_f32(const float* x, const float* w, const float* m,
                         int S, int K, int n, int per_reading, int p, int h,
                         float* band, void* stream) {
  return repro_torch::launch<true>(x, w, m, S, K, n, per_reading, p, h, band,
                                   stream);
}

// Kernel 6: x (S, n, p) one round per slot, band (S, 2h+1, p);
// band[s, k, i] = sum_r x[s, r, i] x[s, r, i + k - h].
int band_round_f32(const float* x, int S, int n, int p, int h, float* band,
                   void* stream) {
  return repro_torch::launch<false, false>(x, nullptr, nullptr, S, 1, n, 0,
                                           p, h, band, stream);
}

// Kernel 7: as band_round_f32 with a 0/1 mask: (S, p) liveness, or
// (S, n, p) per-reading dropout when per_reading is set.
int band_round_masked_f32(const float* x, const float* m, int S, int n,
                          int per_reading, int p, int h, float* band,
                          void* stream) {
  return repro_torch::launch<true, false>(x, nullptr, m, S, 1, n,
                                          per_reading, p, h, band, stream);
}

}  // extern "C"
