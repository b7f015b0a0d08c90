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
// Every kernel takes the whole fleet in one launch, the slots on grid y.
//
// Kernels 4 and 5 are kernel 1's stage tile (stage_tile.cuh), one block of
// 128 threads per 64 rows of one slot, grid (row blocks, slots): z by
// kernel 8's register tile over a cp.async ring of x and W slices (x
// centred and masked as it lands), x^ by kernel 9's tile over a ring of W
// tiles, and an epilogue that reads x again to add the mean and write x^
// and the flags (kernel 4) or sum SPE (kernel 5); T2 from the scores in
// shared memory.  The basis is read as it lies, (S, p, q) row-major, with
// no transposed copy, and shared memory does not grow with p: any p, and q
// up to stage_tile_max_q (276 on the H100).  A per-round (K, p) liveness
// mask is read at row r / n (mask_div), never expanded to the chunk's
// (K*n, p) in device memory (268 MB at 256 slots); mask_div = 1 reads a
// per-row mask.  The tile runs in a kernel of its own (stage_kernel, one
// instantiation a stage, mask mode and row count, the tile called as a
// non-inlined function), so kernel 4 does none of kernel 5's work and the
// other way round.  Each output keeps kernel 1's
// bits: z equals kernel 8's on (x - mean) m, x^ kernel 9's plus the mean,
// and the flags, T2 and SPE kernel 1's on the same chunk.
//
// At the engine's chunk (S=256, R=K*n=256, p=1024, q=32) a launch is 1,024
// blocks of 64 rows, about two waves of four blocks an SM.  At the
// per-round fleet's round (R=n=32) it is 256 blocks, at most two an SM,
// and each block's serial walk over p's 32 slices and 16 tiles, not the
// card's bandwidth, sets the time; so a round takes blocks of 32 rows (the
// tile's BM), each thread walking half as many rows as in a 64-row block,
// none of them empty.
//
// Kernels 8 and 9 are tall, skinny fp32 products, register-tiled and fed
// through shared memory.  At the slice (S=256 slots, R=K*n=256 rows,
// p=1024, q=32) each is 2*S*R*p*q = 4.29 GFLOP (0.064 ms at 67 TFLOP/s
// fp32 on CUDA cores) against x or x^ 268 MB + W 33.5 MB + z 8.4 MB =
// 310 MB (0.0927 ms at 3.35 TB/s): bound by bytes, 0.0927 ms, but with the
// FMA pipe two thirds busy at that bound, so every multiply-add must find
// its operands in registers and each shared-memory read must feed many.
//  * Kernel 8: a block of 64 threads owns 64 rows of one slot and 32
//    columns (grid z tiles wider q).  It walks p in slices of 32 sensors:
//    each slice's x (64 x 32) and W (32 x 32) come into a ring of two
//    shared-memory buffers by 16-byte cp.async (zero-filled past R, p and
//    q: exact, a product with 0 adds +0), so the next slice's loads run
//    under this slice's multiply-adds.  Each thread keeps 8 x 4
//    accumulators and reads its operands as float4: 12 shared loads per
//    128 FMAs (x rows padded to 36 floats, so the four rows a warp reads
//    sit on different banks).  x is read from HBM once, coalesced, 128
//    bytes a row a slice; W from L2 once per 64 rows, not once per 8.
//  * Kernel 9: a block of 128 threads owns 64 rows and 8 consecutive
//    tiles of 64 sensors.  The rows' scores stay in shared memory for all
//    8 tiles; the W tiles (64 sensors x q) stream through a ring of three
//    buffers by cp.async, so the loads of the next tiles run under this
//    tile's multiply-adds and stores.  Each thread keeps 8 rows x 4
//    adjacent sensors of accumulators and stores x^ as float4, a warp
//    writing 128 contiguous bytes of each of 4 rows.
// Both read the basis as it is, (S, p, q) row-major as the engine's
// refresh leaves it; neither copies or transposes it in device memory
// (kernel 9 XOR-swizzles a W tile's float4 chunks in shared memory so a
// warp's reads hit 32 banks).  Both keep each output's order of sums:
// one fp32 accumulator per output walks p (kernel 8) or q (kernel 9) in
// increasing order with fused multiply-adds, as the stage tile's phases
// A and B do, so kernels 1, 4 and 5 give their z and x^ bits.  No
// atomics, no split of a sum across threads or blocks, no tensor cores
// (no TF32): fp32 FMAs on CUDA cores.
// p or q not a multiple of 4, or an operand not 16-byte aligned, takes
// the same kernels' 4-byte-copy variant (VEC false).
//
// Kernels 4, 5 at the slice: two products, 8.59 GFLOP (0.128 ms), against
// x 268 + mask 8.4 + W 33.5 + mean 1 + z 8.4 + x^ 268 + flags 67 MB =
// 655 MB (0.196 ms, kernel 4: bytes) or ~320 MB (0.095 ms, kernel 5:
// operations).  At the round (R=32, a (S, 1, p) mask): x 33.5 + W 33.5 +
// x^ 33.5 + flags 8.4 MB and small operands, 112 MB (0.0335 ms, kernel 4)
// or 70 MB (0.021 ms, kernel 5), both bound by bytes.
#include <cstdint>

#include "cp_async.cuh"
#include "stage_tile.cuh"

namespace repro_torch {

// The tile as a function of its own (not inlined), as kernel 1 calls it:
// inlined into stage_kernel, kernel 4's masked 64-row tile spilled 64
// bytes at the launch bound's 128 registers; called, it gets a register
// allocation of its own and no instantiation spills.
template <bool HAS_MASK, bool WITH_C, bool WITH_M, int BM>
__device__ __noinline__ void stage_rows(
    const float* x, const float* m, int mask_div, const float* basis,
    const float* mean, const float* inv_lam, int R, int p, int q, float eps,
    bool vec, int r0, float* z, float* xh, unsigned char* flags, float* t2,
    float* spe, float* smem) {
  stage_tile<HAS_MASK, WITH_C, WITH_M, float, BM>(
      x, m, mask_div, basis, mean, inv_lam, R, p, q, eps, vec, r0, z, xh,
      flags, t2, spe, smem);
}

// Kernels 4 (WITH_C) and 5 (WITH_M): rows [BM blockIdx.x, + BM) of slot
// blockIdx.y, kTileThreads threads.
// x (S, R, p), m (S, R / mask_div, p) or unused, basis (S, p, q), mean
// (S, p), inv_lam (S, q) (WITH_M); outputs z (S, R, q), xh/flags (S, R, p)
// (WITH_C), t2/spe (S, R) (WITH_M).
template <bool HAS_MASK, bool WITH_C, bool WITH_M, int BM>
__global__ void __launch_bounds__(kTileThreads, 4)
stage_kernel(const float* __restrict__ x, const float* __restrict__ m,
             int mask_div, const float* __restrict__ basis,
             const float* __restrict__ mean,
             const float* __restrict__ inv_lam, int R, int p, int q,
             float eps, bool vec, float* __restrict__ z,
             float* __restrict__ xh, unsigned char* __restrict__ flags,
             float* __restrict__ t2, float* __restrict__ spe) {
  extern __shared__ __align__(16) float stage_smem[];
  const size_t s = blockIdx.y;
  const size_t rows = s * R;
  stage_rows<HAS_MASK, WITH_C, WITH_M, BM>(
      x + rows * p, HAS_MASK ? m + s * (R / mask_div) * (size_t)p : nullptr,
      mask_div, basis + s * p * q, mean + s * p,
      WITH_M ? inv_lam + s * q : nullptr, R, p, q, eps, vec,
      blockIdx.x * BM, z + rows * q, WITH_C ? xh + rows * p : nullptr,
      WITH_C ? flags + rows * p : nullptr, WITH_M ? t2 + rows : nullptr,
      WITH_M ? spe + rows : nullptr, stage_smem);
}

// ---- kernel 8: Z = X W --------------------------------------------------

constexpr int kColTile = 32;                  // columns of W a block owns
constexpr int kTN = 4;                        // columns a thread owns
constexpr int kColGroups = kColTile / kTN;    // 8
constexpr int kProjThreads = 64;
constexpr int kRowGroups = kProjThreads / kColGroups;   // 8
constexpr int kProjRows = 64;                 // rows a block owns
constexpr int kProjK = 32;                    // sensors a slice
constexpr int kProjStages = 2;                // ring of slices
constexpr int kProjMinBlocks = 6;             // registers for 6 blocks an SM
constexpr int kProjSmemFloats =
    kProjStages * (kProjRows * (kProjK + 4) + kProjK * kColTile);

// x (S, R, p), basis (S, p, q) -> z (S, R, q); block (row block, slot,
// column tile).  Thread t owns rows rg + 8 i (i < BM / 8) and columns
// 4 cg .. 4 cg + 3 of the tile, rg = t / 8, cg = t % 8.
template <bool VEC>
__global__ void __launch_bounds__(kProjThreads, kProjMinBlocks)
project_kernel(const float* __restrict__ x, const float* __restrict__ basis,
               int R, int p, int q, float* __restrict__ z) {
  constexpr int BM = kProjRows, BK = kProjK, STAGES = kProjStages;
  constexpr int NT = kProjThreads, RG = kRowGroups, TM = BM / RG;
  constexpr int XLD = BK + 4;   // rows 1 apart start 4 banks apart
  constexpr int KC = BK / 4;    // float4 chunks of a slice row
  extern __shared__ __align__(16) float proj_smem[];
  float* xs = proj_smem;                     // STAGES x (BM, XLD)
  float* ws = proj_smem + STAGES * BM * XLD; // STAGES x (BK, 32)
  const size_t s = blockIdx.y;
  const int r0 = blockIdx.x * BM, c0 = blockIdx.z * kColTile;
  x += s * R * p;
  basis += s * p * q;
  z += s * R * q;
  const int tid = threadIdx.x, cg = tid % kColGroups, rg = tid / kColGroups;
  const int slices = (p + BK - 1) / BK;

  auto load = [&](int kt, int stage) {
    const int k0 = kt * BK;
    float* xd = xs + stage * BM * XLD;
    float* wd = ws + stage * BK * kColTile;
    if (VEC) {   // p % 4 == q % 4 == 0: a 16-byte chunk is all in or out
      static_assert(BM * BK / 4 % NT == 0, "x slice chunks");
      static_assert(BK * kColTile / 4 % NT == 0, "W chunks");
#pragma unroll
      for (int u = 0; u < BM * BK / 4 / NT; ++u) {
        const int e = tid + u * NT;
        const int m = e / KC, k = 4 * (e % KC);
        const bool in = r0 + m < R && k0 + k < p;
        cp_async16(xd + m * XLD + k,
                   in ? x + (size_t)(r0 + m) * p + k0 + k : x, in ? 16 : 0);
      }
#pragma unroll
      for (int u = 0; u < BK * kColTile / 4 / NT; ++u) {
        const int e = tid + u * NT;
        const int kk = e / (kColTile / 4), c = 4 * (e % (kColTile / 4));
        const bool in = k0 + kk < p && c0 + c < q;
        cp_async16(wd + kk * kColTile + c,
                   in ? basis + (size_t)(k0 + kk) * q + c0 + c : basis,
                   in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * BK; e += NT) {
        const int m = e / BK, k = e % BK;
        const bool in = r0 + m < R && k0 + k < p;
        cp_async4(xd + m * XLD + k,
                  in ? x + (size_t)(r0 + m) * p + k0 + k : x, in ? 4 : 0);
      }
      for (int e = tid; e < BK * kColTile; e += NT) {
        const int kk = e / kColTile, c = e % kColTile;
        const bool in = k0 + kk < p && c0 + c < q;
        cp_async4(wd + kk * kColTile + c,
                  in ? basis + (size_t)(k0 + kk) * q + c0 + c : basis,
                  in ? 4 : 0);
      }
    }
  };

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[i][n] = 0.0f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < slices) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // slice kt landed; slice kt - 1's buffer is free
    if (kt + STAGES - 1 < slices)
      load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* xt = xs + (kt % STAGES) * BM * XLD + rg * XLD;
    const float* wt = ws + (kt % STAGES) * BK * kColTile;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float4 a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            xt + i * RG * XLD + k);
#pragma unroll
      for (int j = 0; j < 4; ++j)   // b[j]: sensor k + j, columns 4 cg ..
        b[j] = *reinterpret_cast<const float4*>(
            wt + (k + j) * kColTile + cg * kTN);
#pragma unroll
      for (int j = 0; j < 4; ++j)     // sensors k + j in increasing order
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = lane_of(a[i], j);
#pragma unroll
          for (int n = 0; n < kTN; ++n)
            acc[i][n] = fmaf(av, lane_of(b[j], n), acc[i][n]);
        }
    }
  }

  const int c = c0 + cg * kTN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + rg + i * RG;
    if (r >= R || c >= q) continue;
    float* out = z + (size_t)r * q + c;
    if (VEC) {
      *reinterpret_cast<float4*>(out) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int n = 0; n < kTN; ++n)
        if (c + n < q) out[n] = acc[i][n];
    }
  }
}

// ---- kernel 9: X^ = Z W^T -----------------------------------------------

// Kernel 9's tile: kRecRG x kRecSG threads, kRecTM rows a thread
// (64 rows x 64 sensors a tile), a ring of kRecStages W tiles, kRecTiles
// tiles a block.
constexpr int kRecRG = 8, kRecSG = 16, kRecTM = 8, kRecStages = 3;
constexpr int kRecTiles = 8;

// Floats of kernel 9's dynamic shared memory: the block's scores
// (64 rows x q4 + 4) and kRecStages W tiles of 64 sensors x q4 components;
// q4 = q rounded up to 4.  Within a Hopper block's 227 KB for q <= 224
// (pca_reconstruct_max_q).
constexpr int rec_smem_floats(int q) {
  return kRecRG * kRecTM * ((q + 3) / 4 * 4 + 4) +
         kRecStages * 4 * kRecSG * ((q + 3) / 4 * 4);
}

// z (S, R, q), basis (S, p, q) -> xh (S, R, p).  Block (row block x
// tile group, slot) of RG x SG threads owning BM = RG * TM rows and
// kRecTiles consecutive tiles of BN = 4 SG sensors.  The rows' scores
// stay in shared memory; the W tiles stream through a ring of STAGES
// buffers by cp.async, so the next tile's loads run under this tile's
// multiply-adds and stores.  Thread t owns rows
// rg + RG i (i < TM) and sensors 4 sg .. 4 sg + 3 of a tile,
// sg = t % SG, rg = t / SG.  A W tile is staged as (sensors, components),
// the float4 chunks of sensor row i XOR-swizzled by i / 4 when a row has
// a power of two of them (q = 32: 8 chunks), so that the float4 reads of
// a quarter warp (8 sensor rows 4 apart) hit 32 banks; other q leave
// them in place.
template <bool VEC>
__global__ void __launch_bounds__(kRecRG * kRecSG, 512 / (kRecRG * kRecSG))
reconstruct_kernel(const float* __restrict__ z,
                   const float* __restrict__ basis, int R, int p, int q,
                   float* __restrict__ xh) {
  constexpr int RG = kRecRG, SG = kRecSG, TM = kRecTM, STAGES = kRecStages;
  constexpr int NT = RG * SG, BM = RG * TM, BN = 4 * SG;
  extern __shared__ __align__(16) float rec_smem[];
  const int q4 = (q + 3) / 4 * 4, qc = q4 / 4;
  const int zld = q4 + 4;                       // rows 1 apart: 4 banks
  const int rmask = (qc & (qc - 1)) == 0 ? qc - 1 : 0;
  const int wtile = q4 * BN;
  float* zs = rec_smem;                         // (BM, zld)
  float* ws = rec_smem + BM * zld;              // STAGES x W tile
  const size_t s = blockIdx.y;
  const int ntiles = (p + BN - 1) / BN;
  const int groups = (ntiles + kRecTiles - 1) / kRecTiles;
  const int r0 = blockIdx.x / groups * BM;
  const int t0 = blockIdx.x % groups * kRecTiles;
  const int nt = min(kRecTiles, ntiles - t0);
  z += s * R * q;
  basis += s * p * q;
  xh += s * R * p;
  const int tid = threadIdx.x, sg = tid % SG, rg = tid / SG;
  // chunk `ch` of sensor row i
  auto swz = [rmask](int i, int ch) { return ch ^ ((i >> 2) & rmask); };

  auto load_w = [&](int tile, int stage) {
    const int i0 = (t0 + tile) * BN;
    float* wd = ws + stage * wtile;
    if (VEC) {   // p % 4 == q % 4 == 0: a 16-byte chunk is all in or out
      for (int e = tid; e < BN * qc; e += NT) {
        const int i = e / qc, ch = e % qc;
        const bool in = i0 + i < p && 4 * ch < q;
        cp_async16(wd + i * q4 + 4 * swz(i, ch),
                   in ? basis + (size_t)(i0 + i) * q + 4 * ch : basis,
                   in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BN * q4; e += NT) {
        const int i = e / q4, c = e % q4;
        const bool in = i0 + i < p && c < q;
        cp_async4(wd + i * q4 + 4 * swz(i, c >> 2) + (c & 3),
                  in ? basis + (size_t)(i0 + i) * q + c : basis,
                  in ? 4 : 0);
      }
    }
  };

  // the scores, zero past R and q: exact, a product with 0 adds +0
  for (int e = tid; e < BM * (VEC ? q4 / 4 : q4); e += NT) {
    const int w = VEC ? q4 / 4 : q4;
    const int m = e / w, c = (e % w) * (VEC ? 4 : 1);
    const bool in = r0 + m < R && c < q;
    const float* src = in ? z + (size_t)(r0 + m) * q + c : z;
    if (VEC)
      cp_async16(zs + m * zld + c, src, in ? 16 : 0);
    else
      cp_async4(zs + m * zld + c, src, in ? 4 : 0);
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nt) load_w(st, st);
    cp_async_commit();   // the scores land with tile 0
  }

  const float* zr = zs + rg * zld;
  for (int tile = 0; tile < nt; ++tile) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile landed; the previous tile's buffer is free
    if (tile + STAGES - 1 < nt)
      load_w(tile + STAGES - 1, (tile + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* wt = ws + (tile % STAGES) * wtile;
    float acc[TM][4];
#pragma unroll
    for (int t = 0; t < TM; ++t)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[t][n] = 0.0f;
    for (int c = 0; c < q4; c += 4) {
      float4 a[TM], b[4];
#pragma unroll
      for (int t = 0; t < TM; ++t)
        a[t] = *reinterpret_cast<const float4*>(zr + t * RG * zld + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)   // b[j]: sensor 4 sg + j, components c ..
        b[j] = *reinterpret_cast<const float4*>(
            wt + (4 * sg + j) * q4 + 4 * swz(4 * sg + j, c >> 2));
#pragma unroll
      for (int j = 0; j < 4; ++j)     // components c + j in increasing order
#pragma unroll
        for (int t = 0; t < TM; ++t) {
          const float zv = lane_of(a[t], j);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            acc[t][n] = fmaf(zv, lane_of(b[n], j), acc[t][n]);
        }
    }
    const int i = (t0 + tile) * BN + 4 * sg;
    if (i < p) {
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        const int r = r0 + rg + t * RG;
        if (r >= R) break;
        float* out = xh + (size_t)r * p + i;
        if (VEC) {
          *reinterpret_cast<float4*>(out) =
              make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
        } else {
#pragma unroll
          for (int n = 0; n < 4; ++n)
            if (i + n < p) out[n] = acc[t][n];
        }
      }
    }
  }
}

static bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// One launch of kernel 4 (WITH_C) or 5 (WITH_M) over every slot in blocks
// of BM rows, 16-byte copies (vec) where p and q are multiples of 4 and
// every operand the tile reads by float4 or writes by float4/uchar4 is
// 16-byte aligned.
template <bool WITH_C, bool WITH_M, int BM>
static int launch_stage(const float* x, const float* m, int mask_div,
                        const float* basis, const float* mean,
                        const float* inv_lam, int S, int R, int p, int q,
                        float eps, float* z, float* xh, unsigned char* flags,
                        float* t2, float* spe, void* stream) {
  const bool masked = m != nullptr;
  auto kernel = masked ? stage_kernel<true, WITH_C, WITH_M, BM>
                       : stage_kernel<false, WITH_C, WITH_M, BM>;
  const size_t smem = sizeof(float) * stage_tile_smem_floats<float, BM>(q);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = p % 4 == 0 && q % 4 == 0 && aligned16(x) &&
                   (!masked || aligned16(m)) && aligned16(basis) &&
                   aligned16(mean) && aligned16(z) &&
                   (!WITH_C || (aligned16(xh) && aligned16(flags)));
  dim3 grid((R + BM - 1) / BM, S);
  kernel<<<grid, kTileThreads, smem, (cudaStream_t)stream>>>(
      x, m, mask_div, basis, mean, inv_lam, R, p, q, eps, vec, z, xh, flags,
      t2, spe);
  return (int)cudaGetLastError();
}

// The rows a block of kernels 4 and 5 owns: 64, or 32 for a round of at
// most 32 rows (the per-round fleet's), whose 64-row blocks would be half
// empty: at 32 rows each thread walks half the rows, and the round's time
// is the walk's (PERF.md's table).
static int block_rows(int R) { return R <= 32 ? 32 : kTileRows; }

template <bool WITH_C, bool WITH_M>
static int stage_entry(const float* x, const float* m, int mask_div,
                       const float* basis, const float* mean,
                       const float* inv_lam, int S, int R, int p, int q,
                       float eps, float* z, float* xh,
                       unsigned char* flags, float* t2, float* spe,
                       void* stream) {
  if (S < 1 || R < 1 || p < 1 || q < 1 || mask_div < 1)
    return (int)cudaErrorInvalidValue;
  if (block_rows(R) == 32)
    return launch_stage<WITH_C, WITH_M, 32>(x, m, mask_div, basis, mean,
                                            inv_lam, S, R, p, q, eps, z, xh,
                                            flags, t2, spe, stream);
  return launch_stage<WITH_C, WITH_M, kTileRows>(x, m, mask_div, basis, mean,
                                                 inv_lam, S, R, p, q, eps, z,
                                                 xh, flags, t2, spe, stream);
}

}  // namespace repro_torch

extern "C" {

// x (S, R, p); m (S, R / mask_div, p) liveness x validity or NULL (row r
// reads mask row r / mask_div); basis (S, p, q) row-major, read as it
// lies; mean (S, p).  Outputs z (S, R, q), xh (S, R, p) fp32 and flags
// (S, R, p) bytes.  Contiguous; any p, 1 <= q <= stage_tile_max_q.
int supervised_compress_f32(const float* x, const float* m,
                            const float* basis, const float* mean, int S,
                            int R, int p, int q, int mask_div, float eps,
                            float* z, float* xh, unsigned char* flags,
                            void* stream) {
  return repro_torch::stage_entry<true, false>(
      x, m, mask_div, basis, mean, nullptr, S, R, p, q, eps, z, xh, flags,
      nullptr, nullptr, stream);
}

// x, m, basis, mean as above; inv_lam (S, q).  Outputs z (S, R, q)
// and t2, spe (S, R), fp32.
int pca_monitor_f32(const float* x, const float* m, const float* basis,
                    const float* mean, const float* inv_lam, int S, int R,
                    int p, int q, int mask_div, float* z, float* t2,
                    float* spe, void* stream) {
  return repro_torch::stage_entry<false, true>(
      x, m, mask_div, basis, mean, inv_lam, S, R, p, q, 0.0f, z, nullptr,
      nullptr, t2, spe, stream);
}

// The largest q kernels 4 and 5 take on `device` at every row count: the
// 64-row stage tile's scores and rings within the block's opt-in shared
// memory (276 on the H100; fewer rows need less); 0 if the device cannot
// be queried.
int stage_tile_max_q(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  int q = 0;
  while (sizeof(float) * repro_torch::stage_tile_smem_floats<float>(q + 1) <=
         (size_t)optin)
    ++q;
  return q;
}

// x (S, R, p) rows (already centred and masked), basis (S, p, q) ->
// z (S, R, q).  Contiguous.  Any p, q >= 1; no limit from shared memory.
int pca_project_f32(const float* x, const float* basis, int S, int R, int p,
                    int q, float* z, void* stream) {
  using namespace repro_torch;
  if (S < 1 || R < 1 || p < 1 || q < 1) return (int)cudaErrorInvalidValue;
  const bool vec = p % 4 == 0 && q % 4 == 0 && aligned16(x) &&
                   aligned16(basis) && aligned16(z);
  auto kernel = vec ? project_kernel<true> : project_kernel<false>;
  dim3 grid((R + kProjRows - 1) / kProjRows, S,
            (q + kColTile - 1) / kColTile);
  kernel<<<grid, kProjThreads, sizeof(float) * kProjSmemFloats,
           (cudaStream_t)stream>>>(x, basis, R, p, q, z);
  return (int)cudaGetLastError();
}

// z (S, R, q), basis (S, p, q) read as it is (no transposed copy) ->
// xh (S, R, p) = z W^T.  Contiguous.  Any p >= 1, and
// 1 <= q <= pca_reconstruct_max_q (the scores and the ring of W tiles in
// shared memory).
int pca_reconstruct_f32(const float* z, const float* basis, int S, int R,
                        int p, int q, float* xh, void* stream) {
  using namespace repro_torch;
  if (S < 1 || R < 1 || p < 1 || q < 1) return (int)cudaErrorInvalidValue;
  constexpr int BM = kRecRG * kRecTM, BN = 4 * kRecSG;
  const size_t smem = sizeof(float) * rec_smem_floats(q);
  const int tiles = (p + BN - 1) / BN;
  const long long blocks = (long long)((R + BM - 1) / BM) *
                           ((tiles + kRecTiles - 1) / kRecTiles);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vec = p % 4 == 0 && q % 4 == 0 && aligned16(z) &&
                   aligned16(basis) && aligned16(xh);
  auto kernel = vec ? reconstruct_kernel<true> : reconstruct_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((unsigned)blocks, S), kRecRG * kRecSG, smem,
           (cudaStream_t)stream>>>(z, basis, R, p, q, xh);
  return (int)cudaGetLastError();
}

// The largest q kernel 9 takes on `device`: its block's scores and ring
// of W tiles within the block's opt-in shared memory (224 on the H100);
// 0 if the device cannot be queried.
int pca_reconstruct_max_q(int device) {
  using namespace repro_torch;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  int q = 0;
  while (sizeof(float) * rec_smem_floats(q + 1) <= (size_t)optin) ++q;
  return q;
}

}  // extern "C"
