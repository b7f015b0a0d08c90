// Kernel 1 of the port: the one-pass fused streaming chunk update.
//
// Replaces repro/kernels/fused_stream.py::fused_stream_pallas (pallas_call
// at :206, body _fused_kernel :70).  One launch per engine step covers
// every slot of the fleet, with two kinds of block on a one-dimensional
// grid, 128 threads each:
//
//  * blocks [0, S ceil(R / 64)): the stage tile (stage_tile.cuh), 64 rows
//    of one slot each, at the EXACT sensor count p —
//      z   = ((x - mean) m) W                      (R, q)
//      x^  = z W^T + mean                          (R, p)  [with_compress]
//      flags = (|x - x^| > eps) & (m > 0), strict  (R, p)  [with_compress]
//      T2  = sum_c z_c^2 inv_lam_c                 (R,)    [with_monitor]
//      SPE = ||((x - mean) m - z W^T) m||^2        (R,)    [with_monitor]
//    flags written as bytes (0/1, read as torch.bool), the rest as fp32;
//    register tiles of kernels 8 and 9 over cp.async rings, the basis read
//    as it lies (no transposed copy), shared memory independent of p;
//  * the rest: one tile each of the masked, forgetting-weighted band fold
//    of one slot — kernel 3's banded SYRK tile (band_syrk.cuh; kernel 2's
//    without a mask): 64 x 64 tiles of the upper band, half the band
//    computed and mirrored, a (K, p) liveness mask read once a round.
//
// The mask is per round, (K, p): the chunk driver takes no per-reading
// dropout mask with stages.  Each output's order of sums is its yardstick
// kernel's, so the band equals kernel 3's (2's) bit for bit, z kernel 8's
// on (x - mean) m, x^ kernel 9's plus mean, and T2, SPE and the flags
// kernels 4's and 5's (stage_tile.cuh says how).
//
// Block size: 128 threads for both kinds, the SYRK tile's own (four warps
// on the quarters of a 64 x 64 tile; at most 128 registers a thread, four
// blocks an SM).  The stage tile is laid out for it rather than the other
// way round: the fold does about three quarters of the operations, and
// kernels 8 and 9's tiles take 128 threads at 64 rows (phase B is kernel
// 9's block; phase A holds 4 x 4 accumulators instead of kernel 8's 8 x 4,
// so that 64 rows x 32 columns cover 128 threads).
//
// What the H100 taught (at the slice, each comparison in one run):
//  * each kind of block is a function of its own, not inlined: in one body
//    the stage tile's live ranges pushed the fold's past 128 registers
//    into hundreds of bytes of spills, and the kernel ran slower.  A
//    called fold tile has a few registers fewer than kernel 3's own body,
//    so it loads a round's liveness values as the round ends
//    (band_syrk.cuh, MASK_AT_FLUSH): no spill in any function;
//  * every stage block is dispatched before the first fold tile: stage
//    blocks (about four fold tiles' work each) beside fold tiles on one SM
//    slowed both; interleaving the kinds slot by slot, or a stage block
//    every few fold tiles, was slower than this order.
//
// Bound at the slice shape (p=1024, h=128, q=32, R=256), per slot per
// step: the band is symmetric (band[h-d, i] = band[h+d, i-d]), so the
// fold needs only the unique pairs |i-j| <= h, (h+1)p - h(h+1)/2 =
// 123,840 of them: 2*256*123,840 = 63 MFLOP, plus the two stage products
// 2*2*256*1024*32 = 34 MFLOP, ~97 MFLOP; bytes: x 1 MB + mask 32 KB +
// W 128 KB read, band 1.05 MB + x^ 1 MB + flags 256 KB + z 32 KB written,
// ~3.5 MB.  At 256 slots that is 24.8 GFLOP against ~0.93 GB: 0.37 ms at
// 67 TFLOP/s fp32 against 0.28 ms at 3.35 TB/s — bound by operations
// (CUDA-core fp32; no tensor cores: the stage products' operand (x -
// mean) m is fp32 in both tile modes, and TF32 would change the
// reference's precision).
//
// bf16 tile mode (fused_stream_bf16; the reference's precision="bf16",
// repro/kernels/ops.py::_fused_prep): x and the basis come in as bf16,
// rounded to nearest even by the wrapper; the mask (0/1, exact in either
// type), the weights, mean, inv_lam and every output stay fp32.  The kernel
// is the same template on the operand type: both tiles copy bf16 rows as
// they lie (16 bytes a cp.async where p and q are multiples of 8) and widen
// them exactly into their fp32 tiles (operand.cuh), so all arithmetic,
// shared memory and accumulators are fp32, as in _fused_kernel
// (fused_stream.py:46-55), and every output is the fp32 kernel's on the
// widened operands.  The operation count is unchanged, so the bound is too
// (0.37 ms at the slice, by operations); x and W halve, ~0.77 GB.
#include <cstdint>

#include "band_syrk.cuh"
#include "stage_tile.cuh"

namespace repro_torch {

static_assert(kSyrkThreads == kTileThreads,
              "fold and stage blocks share one launch's block size");

// The two kinds of block as functions of their own (not inlined), so that
// each gets its own register allocation (see above).
template <bool HAS_MASK, typename T>
__device__ __noinline__ void fold_block(const T* x, const float* w,
                                        const float* m, int K, int n, int p,
                                        int h, bool vec, int tile,
                                        float* band, float* smem) {
  band_syrk_tile<HAS_MASK, false, false, T, true>(x, w, m, K, n, p, h, vec,
                                                  tile, band, smem);
}

template <bool HAS_MASK, bool WITH_C, bool WITH_M, typename T>
__device__ __noinline__ void stage_block(
    const T* x, const float* m, int mask_div, const T* basis,
    const float* mean, const float* inv_lam, int R, int p, int q, float eps,
    bool vec, int r0, float* z, float* xh, unsigned char* flags, float* t2,
    float* spe, float* smem) {
  stage_tile<HAS_MASK, WITH_C, WITH_M>(x, m, mask_div, basis, mean, inv_lam,
                                       R, p, q, eps, vec, r0, z, xh, flags,
                                       t2, spe, smem);
}

template <bool HAS_MASK, bool WITH_C, bool WITH_M, typename T>
__global__ void __launch_bounds__(kSyrkThreads, 4)
fused_stream_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ m,
                    const T* __restrict__ basis,
                    const float* __restrict__ mean,
                    const float* __restrict__ inv_lam, int S, int K, int n,
                    int p, int q, int h, float eps, bool fold_vec,
                    bool stage_vec, int stage_blocks, int fold_tiles,
                    float* __restrict__ band, float* __restrict__ z,
                    float* __restrict__ xh, unsigned char* __restrict__ flags,
                    float* __restrict__ t2, float* __restrict__ spe) {
  extern __shared__ __align__(16) float fused_smem[];
  const int R = K * n;
  // every stage block first, then the fold tiles
  const int b = blockIdx.x, stages = S * stage_blocks;
  const bool is_stage = b < stages;
  const int idx = is_stage ? b : b - stages;
  const size_t s = idx / (is_stage ? stage_blocks : fold_tiles);
  x += s * R * p;
  if constexpr (HAS_MASK) m += s * K * (size_t)p;
  if (is_stage) {
    const size_t rows = s * R;
    stage_block<HAS_MASK, WITH_C, WITH_M>(
        x, m, n, basis + s * p * q, mean + s * p,
        WITH_M ? inv_lam + s * q : nullptr, R, p, q, eps, stage_vec,
        idx % stage_blocks * kTileRows, z + rows * q,
        WITH_C ? xh + rows * p : nullptr,
        WITH_C ? flags + rows * p : nullptr, WITH_M ? t2 + rows : nullptr,
        WITH_M ? spe + rows : nullptr, fused_smem);
    return;
  }
  fold_block<HAS_MASK>(x, w + s * K, m, K, n, p, h, fold_vec,
                       idx % fold_tiles, band + s * (2 * h + 1) * p,
                       fused_smem);
}

static bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// Bytes of a block's dynamic shared memory: the larger of the fold tile's
// and the stage tile's at q components.
template <typename T>
static size_t fused_smem_bytes(int q) {
  const int fold =
      syrk_smem_floats<false, false, !std::is_same<T, float>::value>();
  const int stage = stage_tile_smem_floats<T>(q);
  return sizeof(float) * (size_t)(fold > stage ? fold : stage);
}

template <bool HAS_MASK, bool WITH_C, bool WITH_M, typename T>
static int launch(const T* x, const float* w, const float* m,
                  const T* basis, const float* mean, const float* inv_lam,
                  int S, int K, int n, int p, int q, int h, float eps,
                  float* band, float* z, float* xh, unsigned char* flags,
                  float* t2, float* spe, void* stream) {
  if (S < 1 || K < 1 || n < 1 || p < 1 || q < 1 || h < 0)
    return (int)cudaErrorInvalidValue;
  const int R = K * n;
  const int stage_blocks = (R + kTileRows - 1) / kTileRows;
  const int fold_tiles = (p + kSyrkT - 1) / kSyrkT * syrk_offsets(p, h);
  const size_t smem = fused_smem_bytes<T>(q);
  auto kernel = fused_stream_kernel<HAS_MASK, WITH_C, WITH_M, T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte copies: p (and for the stages q) a multiple of 16 bytes' worth
  // of T, every operand 16-byte aligned
  constexpr int EV = 16 / sizeof(T);
  const bool fold_vec =
      p % EV == 0 && aligned16(x) && (!HAS_MASK || aligned16(m));
  const bool stage_vec = fold_vec && q % EV == 0 && aligned16(basis) &&
                         aligned16(mean) && aligned16(z) &&
                         (!WITH_C || (aligned16(xh) && aligned16(flags)));
  const long long blocks = (long long)S * (stage_blocks + fold_tiles);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kSyrkThreads, smem, (cudaStream_t)stream>>>(
      x, w, m, basis, mean, inv_lam, S, K, n, p, q, h, eps, fold_vec,
      stage_vec, stage_blocks, fold_tiles, band, z, xh, flags, t2, spe);
  return (int)cudaGetLastError();
}

template <bool HAS_MASK, typename T>
static int dispatch(int with_c, int with_m, const T* x, const float* w,
                    const float* m, const T* basis, const float* mean,
                    const float* inv_lam, int S, int K, int n, int p,
                    int q, int h, float eps, float* band, float* z,
                    float* xh, unsigned char* flags, float* t2, float* spe,
                    void* stream) {
  if (with_c && with_m)
    return launch<HAS_MASK, true, true, T>(
        x, w, m, basis, mean, inv_lam, S, K, n, p, q, h, eps, band, z, xh,
        flags, t2, spe, stream);
  if (with_c)
    return launch<HAS_MASK, true, false, T>(
        x, w, m, basis, mean, inv_lam, S, K, n, p, q, h, eps, band, z, xh,
        flags, t2, spe, stream);
  if (with_m)
    return launch<HAS_MASK, false, true, T>(
        x, w, m, basis, mean, inv_lam, S, K, n, p, q, h, eps, band, z, xh,
        flags, t2, spe, stream);
  return (int)cudaErrorInvalidValue;   // band-only chunks use band_fold.cu
}

template <typename T>
static int entry(const T* x, const float* w, const float* m, const T* basis,
                 const float* mean, const float* inv_lam, int S, int K,
                 int n, int p, int q, int h, float eps, int with_compress,
                 int with_monitor, float* band, float* z, float* xh,
                 unsigned char* flags, float* t2, float* spe, void* stream) {
  if (m != nullptr)
    return dispatch<true>(with_compress, with_monitor, x, w, m, basis, mean,
                          inv_lam, S, K, n, p, q, h, eps, band, z, xh, flags,
                          t2, spe, stream);
  return dispatch<false>(with_compress, with_monitor, x, w, m, basis, mean,
                         inv_lam, S, K, n, p, q, h, eps, band, z, xh, flags,
                         t2, spe, stream);
}

template <typename T>
static int max_q(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  int q = 0;
  while (fused_smem_bytes<T>(q + 1) <= (size_t)optin) ++q;
  return q;
}

}  // namespace repro_torch

extern "C" {

// x (S, K*n, p); w (S, K); m (S, K, p) per-round liveness or NULL; basis
// (S, p, q) row-major, read as it lies; mean (S, p); inv_lam (S, q).
// Outputs band (S, 2h+1, p), z (S, K*n, q), xh (S, K*n, p) fp32 and flags
// (S, K*n, p) bytes when with_compress, t2/spe (S, K*n) when with_monitor
// (NULL otherwise).  fp32 unless stated, contiguous; 1 <= q <=
// fused_stream_max_q.
int fused_stream_f32(const float* x, const float* w, const float* m,
                     const float* basis, const float* mean,
                     const float* inv_lam, int S, int K, int n, int p, int q,
                     int h, float eps, int with_compress, int with_monitor,
                     float* band, float* z, float* xh, unsigned char* flags,
                     float* t2, float* spe, void* stream) {
  return repro_torch::entry(x, w, m, basis, mean, inv_lam, S, K, n, p, q, h,
                            eps, with_compress, with_monitor, band, z, xh,
                            flags, t2, spe, stream);
}

// The bf16 tile mode: as fused_stream_f32 with x and basis bf16; every
// other operand and every output as there.
int fused_stream_bf16(const __nv_bfloat16* x, const float* w,
                      const float* m, const __nv_bfloat16* basis,
                      const float* mean, const float* inv_lam, int S, int K,
                      int n, int p, int q, int h, float eps,
                      int with_compress, int with_monitor, float* band,
                      float* z, float* xh, unsigned char* flags, float* t2,
                      float* spe, void* stream) {
  return repro_torch::entry(x, w, m, basis, mean, inv_lam, S, K, n, p, q, h,
                            eps, with_compress, with_monitor, band, z, xh,
                            flags, t2, spe, stream);
}

// The largest q kernel 1 takes on `device` in the fp32 (bf16 = 0) or bf16
// tile mode: a stage block's scores and ring within the block's opt-in
// shared memory; 0 if the device cannot be queried.
int fused_stream_max_q(int device, int bf16) {
  return bf16 ? repro_torch::max_q<__nv_bfloat16>(device)
              : repro_torch::max_q<float>(device);
}

}  // extern "C"
