// Kernels 4, 5, 8 and 9 of the port: the split and quantized stage paths.
//
// Replace, in repro/kernels/pca_project.py:
//  * supervised_compress_f32 (kernel 4) <- supervised_compress_pallas
//    (pallas_call at :216, body _supervised_kernel :102):
//      z = ((x - mean) m) W,  x^ = z W^T + mean,  flags = (|x - x^| > eps) & m
//  * pca_monitor_f32 (kernel 5) <- pca_monitor_pallas (:171, body
//    _monitor_kernel :121): z, T2 = sum_c z_c^2 inv_lam_c,
//    SPE = ||((x - mean) m - z W^T) m||^2; x^ never leaves the block;
//  * pca_project_f32 (kernel 8) <- pca_project_pallas (:61, body
//    _project_kernel :40): Z = X W, fp32 accumulation over p (X already
//    centred and masked by the caller);
//  * pca_reconstruct_f32 (kernel 9) <- pca_reconstruct_pallas (:89, body
//    _reconstruct_kernel :74): X^ = Z W^T.
// Every kernel takes the whole fleet in one launch: slots on grid y, row
// blocks of kRows rows on grid x.
//
// Design.  The Pallas kernels tile (block_n, p) slabs through VMEM with
// the whole (p, q) basis resident.  Here kernels 4 and 5 are the stage
// device function of kernel 1 (stages.cuh): a block stages its kRows
// centred, masked rows in shared memory, one thread per (row, component)
// forms the scores reading W through L1/L2 (__ldg), and one warp per row
// reconstructs, lanes striding over sensors so x^ and flags are written
// coalesced (reading the wrapper's transposed copy W^T).  The per-round
// (K, p) liveness mask is read at row r / n, never
// expanded to the chunk's (K*n, p) in device memory (268 MB at 256 slots).
// Kernel 8 is the score loop alone on raw rows; kernel 9 one warp per row
// with the row's q scores in shared memory.
//
// Bounds at the slice shape (S=256 slots, R=K*n=256 rows, p=1024, q=32;
// 67 TFLOP/s fp32 on CUDA cores, 3.35 TB/s):
//  * kernel 8: 2*S*R*p*q = 4.29 GFLOP (0.064 ms) against x 268 MB + W
//    33.5 MB + z 8.4 MB = 310 MB (0.093 ms): bound by bytes, 0.093 ms;
//  * kernel 9: 4.29 GFLOP against z 8.4 + W 33.5 + x^ 268 MB = 310 MB:
//    bound by bytes, 0.093 ms;
//  * kernel 4: two products, 8.59 GFLOP (0.128 ms), against x 268 +
//    mask 8.4 + W 33.5 + mean 1 + z 8.4 + x^ 268 + flags 67 MB = 655 MB
//    (0.196 ms): bound by bytes;
//  * kernel 5: 8.59 GFLOP (0.128 ms) against ~320 MB (0.095 ms): bound by
//    operations.
// None of them uses tensor cores: fp32 products without TF32, as the
// reference's fp32 accumulation asks.  Every block re-reads its slot's W
// (128 KB) from L1/L2, and the scores loop is one dependent chain of p
// multiply-adds per thread — these keep the kernels far above their bounds
// (PERF.md has the times); staging W in shared memory and splitting p
// across lanes is later work.
#include "stages.cuh"

namespace repro_torch {

template <bool HAS_MASK, bool WITH_C, bool WITH_M>
__global__ void __launch_bounds__(kStageThreads)
stage_kernel(const float* __restrict__ x, const float* __restrict__ m,
             int mask_div, const float* __restrict__ basis,
             const float* __restrict__ basis_t,
             const float* __restrict__ mean,
             const float* __restrict__ inv_lam, int R, int p, int q,
             float eps, float* __restrict__ z, float* __restrict__ xh,
             unsigned char* __restrict__ flags, float* __restrict__ t2,
             float* __restrict__ spe) {
  const size_t s = blockIdx.y;
  const size_t rows = s * R;
  extern __shared__ float smem[];
  stage_block<HAS_MASK, WITH_C, WITH_M>(
      x + rows * p, HAS_MASK ? m + s * (R / mask_div) * (size_t)p : nullptr,
      mask_div, basis + s * p * q, basis_t + s * p * q, mean + s * p,
      WITH_M ? inv_lam + s * q : nullptr, R, p, q, eps, blockIdx.x * kRows,
      z + rows * q, WITH_C ? xh + rows * p : nullptr,
      WITH_C ? flags + rows * p : nullptr, WITH_M ? t2 + rows : nullptr,
      WITH_M ? spe + rows : nullptr, smem);
}

__global__ void __launch_bounds__(kStageThreads)
project_kernel(const float* __restrict__ x, const float* __restrict__ basis,
               int R, int p, int q, float* __restrict__ z) {
  const size_t s = blockIdx.y;
  x += s * R * p;
  extern __shared__ float smem[];
  float* x_s = smem;               // (kRows, p) rows
  float* z_s = smem + kRows * p;   // (kRows, q) scores
  const int r0 = blockIdx.x * kRows;
  for (int idx = threadIdx.x; idx < kRows * p; idx += blockDim.x) {
    const int rr = idx / p, r = r0 + rr;
    x_s[idx] = r < R ? x[(size_t)r0 * p + idx] : 0.0f;
  }
  __syncthreads();
  stage_scores(x_s, basis + s * p * q, R, p, q, r0, z_s, z + s * R * q);
}

__global__ void __launch_bounds__(kStageThreads)
reconstruct_kernel(const float* __restrict__ z,
                   const float* __restrict__ basis_t, int R, int p, int q,
                   float* __restrict__ xh) {
  const size_t s = blockIdx.y;
  z += s * R * q;
  basis_t += s * p * q;
  extern __shared__ float z_s[];   // (kRows, q) scores of the block's rows
  const int r0 = blockIdx.x * kRows;
  for (int o = threadIdx.x; o < kRows * q; o += blockDim.x)
    z_s[o] = r0 + o / q < R ? z[(size_t)r0 * q + o] : 0.0f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = r0 + warp;
  if (r >= R) return;
  const float* zr = z_s + warp * q;
  float* out = xh + (s * R + r) * (size_t)p;
  for (int i = lane; i < p; i += 32)
    out[i] = reconstruct_one(zr, basis_t, p, q, i);
}

template <typename Kernel, typename... Args>
static int launch(Kernel kernel, int S, int R, size_t smem, void* stream,
                  Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((R + kRows - 1) / kRows, S);
  kernel<<<grid, kStageThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

static size_t stage_smem(int p, int q) {
  return sizeof(float) * (size_t)kRows * (p + q);
}

}  // namespace repro_torch

extern "C" {

// x (S, R, p); m (S, R / mask_div, p) liveness x validity or NULL (row r
// reads mask row r / mask_div); basis (S, p, q) and basis_t (S, q, p) its
// transpose; mean (S, p).  Outputs
// z (S, R, q), xh (S, R, p) fp32 and flags (S, R, p) bytes.  Contiguous.
int supervised_compress_f32(const float* x, const float* m,
                            const float* basis, const float* basis_t,
                            const float* mean, int S,
                            int R, int p, int q, int mask_div, float eps,
                            float* z, float* xh, unsigned char* flags,
                            void* stream) {
  using namespace repro_torch;
  const size_t smem = stage_smem(p, q);
  if (m != nullptr)
    return launch(stage_kernel<true, true, false>, S, R, smem, stream, x, m,
                  mask_div, basis, basis_t, mean, (const float*)nullptr, R,
                  p, q, eps, z, xh, flags, (float*)nullptr, (float*)nullptr);
  return launch(stage_kernel<false, true, false>, S, R, smem, stream, x, m,
                mask_div, basis, basis_t, mean, (const float*)nullptr, R, p,
                q, eps, z, xh, flags, (float*)nullptr, (float*)nullptr);
}

// x, m, basis, basis_t, mean as above; inv_lam (S, q).  Outputs
// z (S, R, q) and t2, spe (S, R), fp32.
int pca_monitor_f32(const float* x, const float* m, const float* basis,
                    const float* basis_t, const float* mean,
                    const float* inv_lam, int S, int R, int p, int q,
                    int mask_div, float* z, float* t2, float* spe,
                    void* stream) {
  using namespace repro_torch;
  const size_t smem = stage_smem(p, q);
  if (m != nullptr)
    return launch(stage_kernel<true, false, true>, S, R, smem, stream, x, m,
                  mask_div, basis, basis_t, mean, inv_lam, R, p, q, 0.0f, z,
                  (float*)nullptr, (unsigned char*)nullptr, t2, spe);
  return launch(stage_kernel<false, false, true>, S, R, smem, stream, x, m,
                mask_div, basis, basis_t, mean, inv_lam, R, p, q, 0.0f, z,
                (float*)nullptr, (unsigned char*)nullptr, t2, spe);
}

// x (S, R, p) rows (already centred and masked), basis (S, p, q) ->
// z (S, R, q).
int pca_project_f32(const float* x, const float* basis, int S, int R, int p,
                    int q, float* z, void* stream) {
  using namespace repro_torch;
  return launch(project_kernel, S, R, stage_smem(p, q), stream, x, basis, R,
                p, q, z);
}

// z (S, R, q), basis_t (S, q, p) the transposed basis ->
// xh (S, R, p) = z W^T.
int pca_reconstruct_f32(const float* z, const float* basis_t, int S, int R,
                        int p, int q, float* xh, void* stream) {
  using namespace repro_torch;
  return launch(reconstruct_kernel, S, R, sizeof(float) * (size_t)kRows * q,
                stream, z, basis_t, R, p, q, xh);
}

}  // extern "C"
