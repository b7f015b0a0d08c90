// Kernel 1 of the port: the one-pass fused streaming chunk update.
//
// Replaces repro/kernels/fused_stream.py::fused_stream_pallas (pallas_call
// at :206, body _fused_kernel :70).  One launch per engine step covers
// every slot of the fleet (grid y) and has two parts along grid x:
//
//  * blocks [0, band_blocks): the masked, forgetting-weighted band fold,
//    one thread an output (band_fold.cuh), in the order of sums of
//    kernels 2 and 3 (band_syrk.cuh);
//  * blocks [band_blocks, band_blocks + ceil(R / kRows)): the stages for
//    kRows rows each, at the EXACT sensor count p —
//      z   = ((x - mean) m) W                      (R, q)
//      x^  = z W^T + mean                          (R, p)  [with_compress]
//      flags = (|x - x^| > eps) & (m > 0), strict  (R, p)  [with_compress]
//      T2  = sum_c z_c^2 inv_lam_c                 (R,)    [with_monitor]
//      SPE = ||((x - mean) m - z W^T) m||^2        (R,)    [with_monitor]
//    flags written as bytes (0/1, read as torch.bool), the rest as fp32.
//    The mask is per round, (K, p): the chunk driver takes no per-reading
//    dropout mask with stages.
//
// Design: the stage half is the device function of stages.cuh, which
// kernels 4 and 5 (pca_project.cu) call too: a stage block stages its
// kRows centred, masked rows and their scores in dynamic shared memory
// (kRows * (p + q) floats, 34 KB at p=1024; above 48 KB the launch raises
// the block's limit with cudaFuncSetAttribute) and reads W (128 KB per
// slot at the slice width) and its transpose through L1/L2.
//
// Bound at the slice shape (p=1024, h=128, q=32, R=256), per slot per
// step: the band is symmetric (band[h-d, i] = band[h+d, i-d]), so the
// fold needs only the unique pairs |i-j| <= h, (h+1)p - h(h+1)/2 =
// 123,840 of them: 2*256*123,840 = 63 MFLOP, plus the two stage products
// 2*2*256*1024*32 = 34 MFLOP, ~97 MFLOP; bytes: x 1 MB + mask 32 KB +
// W 128 KB read, band 1.05 MB + x^ 1 MB + flags 256 KB + z 32 KB written,
// ~3.5 MB.  At 256 slots that is 24.8 GFLOP against ~0.93 GB: 0.37 ms at
// 67 TFLOP/s fp32 against 0.28 ms at 3.35 TB/s — bound by operations
// (CUDA-core fp32; the fold has no tensor-core form in fp32 without TF32).
// This kernel's fold blocks still compute every in-range band entry, both
// halves, one thread an output; they sum in the symmetric per-round order
// of kernels 2 and 3 (band_syrk.cuh), which fold half the band and mirror
// it, so the bands agree bit for bit.  Moving these blocks onto that tile
// is later work.
//
// bf16 tile mode (fused_stream_bf16; the reference's precision="bf16",
// repro/kernels/ops.py::_fused_prep): x, the basis and its transpose come
// in as bf16, rounded to nearest even by the wrapper; the mask (0/1, exact
// in either type), the weights, mean, inv_lam and every output stay fp32.
// The kernel is the same template on the operand type: each bf16 element is
// widened to fp32 as it is loaded (operand.cuh) and all arithmetic, shared
// memory and accumulators are fp32, as in _fused_kernel (fused_stream.py:
// 46-55).  The operation count is unchanged, so the bound is too (0.37 ms
// at the slice, by operations); x and W halve, ~0.77 GB against ~0.93.
// Loads stay scalar: a bf16 row at odd p is not 16-byte aligned.
#include "band_fold.cuh"
#include "stages.cuh"

namespace repro_torch {

static_assert(kFoldThreads == kStageThreads,
              "fold and stage blocks share one launch's block size");

template <bool HAS_MASK, bool WITH_C, bool WITH_M, typename T>
__global__ void __launch_bounds__(kFoldThreads)
fused_stream_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ m,
                    const T* __restrict__ basis,
                    const T* __restrict__ basis_t,
                    const float* __restrict__ mean,
                    const float* __restrict__ inv_lam, int K, int n,
                    int p, int q, int h, float eps, int band_blocks,
                    float* __restrict__ band, float* __restrict__ z,
                    float* __restrict__ xh, unsigned char* __restrict__ flags,
                    float* __restrict__ t2, float* __restrict__ spe) {
  const size_t s = blockIdx.y;
  const int R = K * n;
  x += s * R * p;
  if (HAS_MASK) m += s * K * (size_t)p;
  if (blockIdx.x < band_blocks) {
    band_fold_block<HAS_MASK>(x, w + s * K, m, K, n, p, h, blockIdx.x,
                              band + s * (2 * h + 1) * p);
    return;
  }
  extern __shared__ float smem[];
  const size_t rows = s * R;
  stage_block<HAS_MASK, WITH_C, WITH_M>(
      x, m, n, basis + s * p * q, basis_t + s * p * q, mean + s * p,
      inv_lam + s * q, R, p, q, eps, (blockIdx.x - band_blocks) * kRows,
      z + rows * q, WITH_C ? xh + rows * p : nullptr,
      WITH_C ? flags + rows * p : nullptr, WITH_M ? t2 + rows : nullptr,
      WITH_M ? spe + rows : nullptr, smem);
}

template <bool HAS_MASK, bool WITH_C, bool WITH_M, typename T>
static int launch(const T* x, const float* w, const float* m,
                  const T* basis, const T* basis_t,
                  const float* mean, const float* inv_lam, int S, int K,
                  int n, int p, int q, int h, float eps, float* band,
                  float* z, float* xh, unsigned char* flags, float* t2,
                  float* spe, void* stream) {
  const int R = K * n;
  const int col_blocks = (p + kFoldThreads - 1) / kFoldThreads;
  const int band_blocks = col_blocks * (2 * h + 1);
  const int stage_blocks = (R + kRows - 1) / kRows;
  const size_t smem = sizeof(float) * (size_t)kRows * (p + q);
  auto kernel = fused_stream_kernel<HAS_MASK, WITH_C, WITH_M, T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(band_blocks + stage_blocks, S);
  kernel<<<grid, kFoldThreads, smem, (cudaStream_t)stream>>>(
      x, w, m, basis, basis_t, mean, inv_lam, K, n, p, q, h, eps,
      band_blocks, band, z, xh, flags, t2, spe);
  return (int)cudaGetLastError();
}

template <bool HAS_MASK, typename T>
static int dispatch(int with_c, int with_m, const T* x, const float* w,
                    const float* m, const T* basis,
                    const T* basis_t, const float* mean,
                    const float* inv_lam, int S, int K, int n, int p,
                    int q, int h, float eps, float* band, float* z,
                    float* xh, unsigned char* flags, float* t2, float* spe,
                    void* stream) {
  if (with_c && with_m)
    return launch<HAS_MASK, true, true, T>(
        x, w, m, basis, basis_t, mean, inv_lam, S, K, n, p, q, h, eps, band,
        z, xh, flags, t2, spe, stream);
  if (with_c)
    return launch<HAS_MASK, true, false, T>(
        x, w, m, basis, basis_t, mean, inv_lam, S, K, n, p, q, h, eps, band,
        z, xh, flags, t2, spe, stream);
  if (with_m)
    return launch<HAS_MASK, false, true, T>(
        x, w, m, basis, basis_t, mean, inv_lam, S, K, n, p, q, h, eps, band,
        z, xh, flags, t2, spe, stream);
  return (int)cudaErrorInvalidValue;   // band-only chunks use band_fold.cu
}

template <typename T>
static int entry(const T* x, const float* w, const float* m, const T* basis,
                 const T* basis_t, const float* mean, const float* inv_lam,
                 int S, int K, int n, int p, int q, int h, float eps,
                 int with_compress, int with_monitor, float* band, float* z,
                 float* xh, unsigned char* flags, float* t2, float* spe,
                 void* stream) {
  if (m != nullptr)
    return dispatch<true>(with_compress, with_monitor, x, w, m, basis,
                          basis_t, mean, inv_lam, S, K, n, p, q, h, eps,
                          band, z, xh, flags, t2, spe, stream);
  return dispatch<false>(with_compress, with_monitor, x, w, m, basis,
                         basis_t, mean, inv_lam, S, K, n, p, q, h, eps, band,
                         z, xh, flags, t2, spe, stream);
}

}  // namespace repro_torch

extern "C" {

// x (S, K*n, p); w (S, K); m (S, K, p) per-round liveness or NULL;
// basis (S, p, q) and basis_t (S, q, p) its transpose; mean (S, p);
// inv_lam (S, q).  Outputs band (S, 2h+1, p), z (S, K*n, q), xh
// (S, K*n, p) fp32 and flags (S, K*n, p) bytes when with_compress, t2/spe
// (S, K*n) when with_monitor (NULL otherwise).  fp32 unless stated,
// contiguous.
int fused_stream_f32(const float* x, const float* w, const float* m,
                     const float* basis, const float* basis_t,
                     const float* mean, const float* inv_lam, int S, int K,
                     int n, int p, int q, int h, float eps,
                     int with_compress, int with_monitor, float* band,
                     float* z, float* xh, unsigned char* flags, float* t2,
                     float* spe, void* stream) {
  return repro_torch::entry(x, w, m, basis, basis_t, mean, inv_lam, S, K, n,
                            p, q, h, eps, with_compress, with_monitor, band,
                            z, xh, flags, t2, spe, stream);
}

// The bf16 tile mode: as fused_stream_f32 with x, basis and basis_t bf16;
// every other operand and every output as there.
int fused_stream_bf16(const __nv_bfloat16* x, const float* w,
                      const float* m, const __nv_bfloat16* basis,
                      const __nv_bfloat16* basis_t, const float* mean,
                      const float* inv_lam, int S, int K, int n, int p,
                      int q, int h, float eps, int with_compress,
                      int with_monitor, float* band, float* z, float* xh,
                      unsigned char* flags, float* t2, float* spe,
                      void* stream) {
  return repro_torch::entry(x, w, m, basis, basis_t, mean, inv_lam, S, K, n,
                            p, q, h, eps, with_compress, with_monitor, band,
                            z, xh, flags, t2, spe, stream);
}

}  // extern "C"
