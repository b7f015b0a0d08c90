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
// half the band computed and mirrored, in an order of sums (segments of
// kSegRows rows a round, combined in order) that is symmetric in (i, j)
// and depends on n alone, so the mirror, kernel 1's fold blocks and, at
// K = 1 and w = 1, kernels 6 and 7 all give the same bits.  Kernels 6 and
// 7 take one of three shapes, by the round's rows and the launch's size:
//
//  * n <= kLongRound (the serving paths' 32-row rounds): the tile at K = 1
//    with unit weight, in the round's shape (band_syrk.cuh, ROUND: one
//    accumulator set, 16-row stages, a leaner epilogue), on the same grid
//    as kernels 2 and 3;
//  * longer rounds on a grid that fills the card (wsn-1m's 256-row
//    production batch, 49,152 tiles): kernel 2's tile at K = 1 with unit
//    weight (UNIT), whose second accumulator set holds the round across
//    its segments.  A tile built for the FMA rate (8 x 8 a thread, a block
//    a row tile, 32-row stages) ran this batch slower on the H100: its
//    write-out and its exposed loads cost more than its inner loop saved
//    (PERF.md);
//  * longer rounds on a grid too small to fill it, of a small band (the
//    Berkeley fit: S = 1, n = 1,440, p = 52, h = 15, one tile), when the
//    wrapper hands a workspace: the split fold (band_pair_kernel below),
//    one block a segment, which folds the segment pair by pair into the
//    workspace, then a kernel that folds each entry's partials in segment
//    order, acc = fma(f, c_g, acc) — the order the other shapes keep in
//    registers.  Two kernels, one call: one count in ops.LAUNCHES.
//
// A dropout mask is applied to the rows as they are staged, in all three.
//
// Kernel 6 has an accumulating form in each shape (band_round_acc_f32,
// what banded_update launches): band = band_in + the round's sums, the
// add in the write-out (band_syrk.cuh's ACC; the split fold's combine),
// one __fadd_rn an entry, so its band has the bits of band_in + the delta
// form's band, without the delta's write, its read and the add's pass.
// Its kernels overload the delta form's by a third template argument and
// a band_in operand: the delta form's functions keep their names and
// code.
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
// shape.  At wsn-1m's batch (n = 256, p = 1,048,576) the round is bound by
// operations (69.3 GFLOP against 2.15 GB: 1.03 ms against 0.64 ms); at the
// Berkeley fit's (n = 1,440, p = 52) by a launch's latency, the arithmetic
// being 2.1 MFLOP: what bounds it is the chain of rows one block sums in
// order, which the split cuts to a segment.
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

// Kernels 6 and 7 at n <= kLongRound: the same tile over one round, in
// the round's shape (ROUND: K = 1, unit weight, one segment).  Five blocks
// an SM at most 102 registers a thread (the round keeps one accumulator
// set).
template <bool HAS_MASK, bool PER_READING>
__global__ void __launch_bounds__(kSyrkThreads, 5)
band_round_kernel(const float* __restrict__ x, const float* __restrict__ m,
                  int n, int p, int h, bool vec, float* __restrict__ band) {
  extern __shared__ __align__(16) float syrk_smem[];
  const size_t s = blockIdx.y;
  const size_t m_rows = PER_READING ? (size_t)n : 1;
  band_syrk_tile<HAS_MASK, PER_READING, /*ROUND=*/true>(
      x + s * n * p, nullptr, HAS_MASK ? m + s * m_rows * p : nullptr, 1, n,
      p, h, vec, blockIdx.x, band + s * (2 * h + 1) * p, syrk_smem);
}

// Kernel 6's accumulating form in the round's shape: band = band_in + the
// round's sums, band_in (S, 2h+1, p).
template <bool HAS_MASK, bool PER_READING, bool ACC>
__global__ void __launch_bounds__(kSyrkThreads, 5)
band_round_kernel(const float* __restrict__ x, const float* __restrict__ m,
                  const float* __restrict__ band_in, int n, int p, int h,
                  bool vec, float* __restrict__ band) {
  extern __shared__ __align__(16) float syrk_smem[];
  const size_t s = blockIdx.y, E = (size_t)(2 * h + 1) * p;
  const size_t m_rows = PER_READING ? (size_t)n : 1;
  band_syrk_tile<HAS_MASK, PER_READING, /*ROUND=*/true, float, false,
                 /*UNIT=*/true, ACC>(
      x + s * n * p, nullptr, HAS_MASK ? m + s * m_rows * p : nullptr, 1, n,
      p, h, vec, blockIdx.x, band + s * E, syrk_smem, band_in + s * E);
}

// Kernels 6 and 7 at n > kLongRound on a full grid: kernel 2's tile (two
// accumulator sets: the segment's and the round's) at K = 1 with unit
// weight (UNIT: no weight read), on its grid.
template <bool HAS_MASK, bool PER_READING>
__global__ void __launch_bounds__(kSyrkThreads, 4)
band_long_kernel(const float* __restrict__ x, const float* __restrict__ m,
                 int n, int p, int h, bool vec, float* __restrict__ band) {
  extern __shared__ __align__(16) float syrk_smem[];
  const size_t s = blockIdx.y;
  const size_t m_rows = PER_READING ? (size_t)n : 1;
  band_syrk_tile<HAS_MASK, PER_READING, /*ROUND=*/false, float, false,
                 /*UNIT=*/true>(
      x + s * n * p, nullptr, HAS_MASK ? m + s * m_rows * p : nullptr, 1, n,
      p, h, vec, blockIdx.x, band + s * (2 * h + 1) * p, syrk_smem);
}

// Kernel 6's accumulating form on a full grid: band = band_in + the
// round's sums, band_in (S, 2h+1, p).
template <bool HAS_MASK, bool PER_READING, bool ACC>
__global__ void __launch_bounds__(kSyrkThreads, 4)
band_long_kernel(const float* __restrict__ x, const float* __restrict__ m,
                 const float* __restrict__ band_in, int n, int p, int h,
                 bool vec, float* __restrict__ band) {
  extern __shared__ __align__(16) float syrk_smem[];
  const size_t s = blockIdx.y, E = (size_t)(2 * h + 1) * p;
  const size_t m_rows = PER_READING ? (size_t)n : 1;
  band_syrk_tile<HAS_MASK, PER_READING, /*ROUND=*/false, float, false,
                 /*UNIT=*/true, ACC>(
      x + s * n * p, nullptr, HAS_MASK ? m + s * m_rows * p : nullptr, 1, n,
      p, h, vec, blockIdx.x, band + s * E, syrk_smem, band_in + s * E);
}

// The split fold of a small band (kernels 6 and 7 at n > kLongRound on a
// grid too small to fill the card, with p <= kPairMaxP and p ceil((h'+1) /
// kPairDiags) <= kPairThreads, h' = min(h, p-1): the Berkeley fit's batch,
// n = 1,440, p = 52, h = 15, 712 unique pairs), two kernels.  The first:
// one block a segment g = blockIdx.x of slot s = blockIdx.y, which stages
// the segment's rows (a dropout mask applied); thread t takes column i =
// t % p and the diagonals d = kPairDiags (t / p) + q, q < kPairDiags, so a
// row costs it 1 + kPairDiags shared loads for kPairDiags pairs, and sums
// each pair (i, i + d) over the rows in order, c_g = fma(mx_i, mx_j, c_g)
// from 0 — the tiles' chain of the segment, pair by pair — into ws (S, G,
// U) at k = d p - d (d - 1) / 2 + i.  The second: one thread an entry of
// the band, which folds its pair's partials in segment order, acc =
// fma(f, c_g, acc) from 0 with f = m_i m_j (a liveness row) or 1, and
// writes it (0 outside the matrix).  No atomics.
constexpr int kPairThreads = 512;   // threads a block
constexpr int kPairDiags = 4;       // diagonals a thread
constexpr int kPairMaxP = 128;      // columns
// a segment's rows and a dropout mask: 64 KB
constexpr int kPairSmemFloats = 2 * kSegRows * kPairMaxP;

// Unique pairs of a (2h+1, p) band: (h'+1) p - h'(h'+1)/2, h' = min(h, p-1).
__host__ __device__ inline int band_pairs(int p, int h) {
  const int d = h < p - 1 ? h : p - 1;
  return (d + 1) * p - d * (d + 1) / 2;
}

// Threads the first kernel needs: p ceil((h'+1) / kPairDiags).
__host__ __device__ inline int pair_threads(int p, int h) {
  const int d = h < p - 1 ? h : p - 1;
  return p * ((d + kPairDiags) / kPairDiags);
}

template <bool DROP>
__global__ void __launch_bounds__(kPairThreads)
band_pair_kernel(const float* __restrict__ x, const float* __restrict__ m,
                 int n, int p, int h, bool vec, float* __restrict__ ws) {
  extern __shared__ __align__(16) float pair_smem[];
  const int tid = threadIdx.x, g = blockIdx.x, G = gridDim.x;
  const size_t s = blockIdx.y;
  const int hd = min(h, p - 1), U = band_pairs(p, h);
  const int r0 = g * kSegRows, rows = min(kSegRows, n - r0);
  const float* xs = x + (s * n + r0) * p;
  const float* ms = DROP ? m + (s * n + r0) * p : nullptr;
  // the segment's rows, (rows, p) row-major, and a dropout mask after them
  const int EV = vec ? 4 : 1, chunks = rows * p / EV;
  for (int c = tid; c < chunks; c += kPairThreads) {
    if (vec) {
      cp_async16(pair_smem + EV * c, xs + EV * c, 16);
      if (DROP) cp_async16(pair_smem + rows * p + EV * c, ms + EV * c, 16);
    } else {
      cp_async4(pair_smem + c, xs + c, 4);
      if (DROP) cp_async4(pair_smem + rows * p + c, ms + c, 4);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (DROP) {
    for (int c = tid; c < rows * p; c += kPairThreads)
      pair_smem[c] = __fmul_rn(pair_smem[c], pair_smem[rows * p + c]);
    __syncthreads();
  }
  if (tid >= pair_threads(p, h)) return;
  // column i, diagonals d0 .. d0 + kPairDiags - 1 (those past h' or past
  // the matrix read column i and are not written)
  const int i = tid % p, d0 = kPairDiags * (tid / p);
  int jq[kPairDiags];
  float acc[kPairDiags];
#pragma unroll
  for (int q = 0; q < kPairDiags; ++q) {
    const int j = i + d0 + q;
    jq[q] = d0 + q <= hd && j < p ? j : i;
    acc[q] = 0.0f;
  }
  auto row = [&](int r) {
    const float* xr = pair_smem + r * p;
    const float xi = xr[i];
#pragma unroll
    for (int q = 0; q < kPairDiags; ++q)
      acc[q] = __fmaf_rn(xi, xr[jq[q]], acc[q]);
  };
  int r = 0;
  for (; r + 4 <= rows; r += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) row(r + q);
  }
  for (; r < rows; ++r) row(r);
  float* part = ws + (s * G + g) * U;
#pragma unroll
  for (int q = 0; q < kPairDiags; ++q) {
    const int d = d0 + q;
    if (d <= hd && i + d < p) part[d * p - d * (d - 1) / 2 + i] = acc[q];
  }
}

// The second kernel's partials a pass: each thread copies its entry's
// next kCombineSegs partials into shared memory by cp.async, all in flight
// at once, before its chain reads them.
constexpr int kCombineThreads = 256, kCombineSegs = 32;

// One entry of the band a thread (the body of both combine kernels); ACC
// adds band_in's entry, loaded before the partials' chain, by one
// __fadd_rn (band_in + 0 outside the matrix).
template <bool LIVE, bool ACC>
__device__ __forceinline__ void pair_combine(const float* __restrict__ ws,
                                             const float* __restrict__ m,
                                             const float* __restrict__ band_in,
                                             int G, int p, int h,
                                             float* __restrict__ band) {
  __shared__ float parts[kCombineSegs * kCombineThreads];
  const int E = (2 * h + 1) * p, U = band_pairs(p, h), tid = threadIdx.x;
  const int e = blockIdx.x * kCombineThreads + tid;
  if (e >= E) return;
  const size_t s = blockIdx.y;
  const int i = e % p, d = e / p - h, j = i + d;
  float* out = band + s * E + e;
  const float prior = ACC ? __ldg(band_in + s * E + e) : 0.0f;
  if (j < 0 || j >= p) {
    *out = ACC ? __fadd_rn(prior, 0.0f) : 0.0f;
    return;
  }
  const int ad = d < 0 ? -d : d, lo = d < 0 ? j : i;
  const float f = LIVE ? __fmul_rn(__ldg(m + s * p + i), __ldg(m + s * p + j))
                       : 1.0f;
  const float* c = ws + s * G * U + ad * p - ad * (ad - 1) / 2 + lo;
  float acc = 0.0f;
  for (int g0 = 0; g0 < G; g0 += kCombineSegs) {
    const int nseg = min(kCombineSegs, G - g0);
    for (int q = 0; q < nseg; ++q)
      cp_async4(parts + q * kCombineThreads + tid, c + (size_t)(g0 + q) * U,
                4);
    cp_async_commit();
    cp_async_wait<0>();   // this thread's own copies: no barrier
    for (int q = 0; q < nseg; ++q)
      acc = __fmaf_rn(f, parts[q * kCombineThreads + tid], acc);
  }
  *out = ACC ? __fadd_rn(prior, acc) : acc;
}

template <bool LIVE>
__global__ void __launch_bounds__(kCombineThreads)
band_pair_combine_kernel(const float* __restrict__ ws,
                         const float* __restrict__ m, int G, int p, int h,
                         float* __restrict__ band) {
  pair_combine<LIVE, false>(ws, m, nullptr, G, p, h, band);
}

// Kernel 6's accumulating form of the split fold's second kernel: band =
// band_in + the folded partials, band_in (S, 2h+1, p).
template <bool LIVE, bool ACC>
__global__ void __launch_bounds__(kCombineThreads)
band_pair_combine_kernel(const float* __restrict__ ws,
                         const float* __restrict__ m,
                         const float* __restrict__ band_in, int G, int p,
                         int h, float* __restrict__ band) {
  pair_combine<LIVE, ACC>(ws, m, band_in, G, p, h, band);
}

static bool aligned16(const void* ptr) {
  return (reinterpret_cast<size_t>(ptr) & 15) == 0;
}

static cudaError_t smem_attr(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Kernels 2 and 3: a chunk of K rounds, one weight each.
template <bool HAS_MASK, bool PER_READING>
static int launch_syrk(const float* x, const float* w, const float* m,
                       int S, int K, int n, int p, int h, float* band,
                       void* stream) {
  constexpr size_t smem =
      sizeof(float) * syrk_smem_floats<HAS_MASK && PER_READING>();
  if (S < 1 || K < 1 || n < 1 || p < 1 || h < 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = band_syrk_kernel<HAS_MASK, PER_READING>;
  // the chunk's dropout mask stages: 64 KB
  cudaError_t err = smem_attr((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = p % 4 == 0 && aligned16(x) && (!HAS_MASK || aligned16(m));
  dim3 grid((p + kSyrkT - 1) / kSyrkT * syrk_offsets(p, h), S);
  kernel<<<grid, kSyrkThreads, smem, (cudaStream_t)stream>>>(
      x, w, m, K, n, p, h, vec, band);
  return (int)cudaGetLastError();
}

// Kernels 6 and 7: one round of n rows a slot, in the shape its n and the
// workspace choose (above).  ws: (S, ceil(n / kSegRows), band_pairs(p, h))
// floats for the split fold of a round of n > kLongRound rows, or null.
// ACC: kernel 6's accumulating form, band = band_in + the sums (band_in
// (S, 2h+1, p), not band).
template <bool HAS_MASK, bool PER_READING, bool ACC = false>
static int launch_round(const float* x, const float* m, const float* band_in,
                        int S, int n, int p, int h, float* ws, float* band,
                        void* stream) {
  if (S < 1 || n < 1 || p < 1 || h < 0) return (int)cudaErrorInvalidValue;
  const bool vec = p % 4 == 0 && aligned16(x) && (!HAS_MASK || aligned16(m));
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  const int tiles = (p + kSyrkT - 1) / kSyrkT * syrk_offsets(p, h);
  // a tile kernel (the round's shape or the long one) on the tile grid,
  // given band_in in ACC's form
  auto tile_launch = [&](auto kernel, size_t smem) {
    if ((err = smem_attr((const void*)kernel, smem)) != cudaSuccess)
      return (int)err;
    if constexpr (ACC)
      kernel<<<dim3(tiles, S), kSyrkThreads, smem, st>>>(x, m, band_in, n, p,
                                                        h, vec, band);
    else
      kernel<<<dim3(tiles, S), kSyrkThreads, smem, st>>>(x, m, n, p, h, vec,
                                                        band);
    return (int)cudaGetLastError();
  };
  if (n <= kLongRound) {
    constexpr size_t smem = sizeof(float) *
        syrk_smem_floats<HAS_MASK && PER_READING, /*ROUND=*/true, false,
                         ACC>();
    if constexpr (ACC)
      return tile_launch(band_round_kernel<HAS_MASK, PER_READING, true>, smem);
    else
      return tile_launch(band_round_kernel<HAS_MASK, PER_READING>, smem);
  }
  if (ws == nullptr) {
    constexpr size_t smem =
        sizeof(float) *
        syrk_smem_floats<HAS_MASK && PER_READING, false, false, ACC>();
    if constexpr (ACC)
      return tile_launch(band_long_kernel<HAS_MASK, PER_READING, true>, smem);
    else
      return tile_launch(band_long_kernel<HAS_MASK, PER_READING>, smem);
  }
  const int G = (n + kSegRows - 1) / kSegRows;
  if (pair_threads(p, h) > kPairThreads || p > kPairMaxP)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kPairSmemFloats;
  auto part = band_pair_kernel<HAS_MASK && PER_READING>;
  if ((err = smem_attr((const void*)part, smem)) != cudaSuccess)
    return (int)err;
  part<<<dim3(G, S), kPairThreads, smem, st>>>(x, m, n, p, h, vec, ws);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // a thread an entry of the band (at most (2h+1) kPairMaxP: h < p here
  // or the band is zero past p)
  const long long entries = (long long)(2 * h + 1) * p;
  if (entries > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((entries + kCombineThreads - 1) /
                             kCombineThreads), S);
  constexpr bool LIVE = HAS_MASK && !PER_READING;
  if constexpr (ACC)
    band_pair_combine_kernel<LIVE, true><<<grid, kCombineThreads, 0, st>>>(
        ws, m, band_in, G, p, h, band);
  else
    band_pair_combine_kernel<LIVE><<<grid, kCombineThreads, 0, st>>>(
        ws, m, G, p, h, band);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" {

// x (S, K*n, p), w (S, K), band (S, 2h+1, p); all fp32, contiguous.
int band_fold_f32(const float* x, const float* w, int S, int K, int n,
                  int p, int h, float* band, void* stream) {
  return repro_torch::launch_syrk<false, false>(x, w, nullptr, S, K, n, p, h,
                                                band, stream);
}

// As band_fold_f32 with a 0/1 mask: (S, K, p) per-round liveness, or
// (S, K*n, p) per-reading dropout when per_reading is set.
int band_fold_masked_f32(const float* x, const float* w, const float* m,
                         int S, int K, int n, int per_reading, int p, int h,
                         float* band, void* stream) {
  if (per_reading)
    return repro_torch::launch_syrk<true, true>(x, w, m, S, K, n, p, h, band,
                                                stream);
  return repro_torch::launch_syrk<true, false>(x, w, m, S, K, n, p, h, band,
                                               stream);
}

// Kernel 6: x (S, n, p) one round per slot, band (S, 2h+1, p);
// band[s, k, i] = sum_r x[s, r, i] x[s, r, i + k - h].  ws: the split
// fold's workspace, (S, ceil(n / 64), U) floats for U = band_pairs(p, h)
// unique pairs, or null (the round's shape up to 64 rows, kernel 2's tile
// at unit weight beyond).
int band_round_f32(const float* x, int S, int n, int p, int h, float* ws,
                   float* band, void* stream) {
  return repro_torch::launch_round<false, false>(x, nullptr, nullptr, S, n,
                                                 p, h, ws, band, stream);
}

// Kernel 6's accumulating form: as band_round_f32, with band = band_in +
// the round's sums, each entry one fp32 add in the write-out (the bits of
// band_in + band_round_f32's band).  band_in (S, 2h+1, p) is read only;
// band is a separate output.
int band_round_acc_f32(const float* x, const float* band_in, int S, int n,
                       int p, int h, float* ws, float* band, void* stream) {
  return repro_torch::launch_round<false, false, true>(
      x, nullptr, band_in, S, n, p, h, ws, band, stream);
}

// Kernel 7: as band_round_f32 with a 0/1 mask: (S, p) liveness, or
// (S, n, p) per-reading dropout when per_reading is set.
int band_round_masked_f32(const float* x, const float* m, int S, int n,
                          int per_reading, int p, int h, float* ws,
                          float* band, void* stream) {
  if (per_reading)
    return repro_torch::launch_round<true, true>(x, m, nullptr, S, n, p, h,
                                                 ws, band, stream);
  return repro_torch::launch_round<true, false>(x, m, nullptr, S, n, p, h,
                                                ws, band, stream);
}

}  // extern "C"
