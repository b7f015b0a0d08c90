// The stage tile: the per-row stages of kernel 1 (fused_stream.cu) for 64
// rows of one slot, at the EXACT sensor count p, written so that kernels 4
// and 5 can take it up:
//   z   = ((x - mean) m) W                      (R, q)
//   x^  = z W^T + mean                          (R, p)  [WITH_C]
//   flags = (|x - x^| > eps) & (m > 0), strict  (R, p)  [WITH_C]
//   T2  = sum_c z_c^2 inv_lam_c                 (R,)    [WITH_M]
//   SPE = ||((x - mean) m - z W^T) m||^2        (R,)    [WITH_M]
// flags are bytes (0/1, read as torch.bool), the rest fp32.  Row r reads
// mask row r / mask_div (a per-round (K, p) mask with mask_div = n, never
// broadcast to the chunk's size in device memory).  The basis is read as
// it lies, (p, q) row-major: no transposed copy.
//
// Design: kernel 8's and kernel 9's register tiles (pca_project.cu), one
// block of 128 threads owning 64 rows, so that shared memory no longer
// grows with p.
//  * Phase A, z = ((x - mean) m) W: 16 row groups x 8 column groups, 4 rows
//    x 4 columns a thread (64 rows x 32 columns a pass; a wider q takes a
//    pass more over x).  p streams in slices of 32 sensors through a
//    two-slot cp.async ring of x and W; each thread centres and masks the
//    x chunks it copied before the slice's barrier, with stage_block's two
//    roundings (v = x - mean, then v *= m), from mean and mask values it
//    loaded a slice ahead.  Each score walks p in
//    increasing order with fused multiply-adds from 0: kernel 8's bits on
//    the centred, masked rows.  The scores go to z and stay in shared
//    memory.
//  * T2, from the scores in shared memory: a warp per row, lane c (strided
//    by 32), then the xor butterfly — stage_block's order and expression,
//    so kernel 5's bits.
//  * Phase B, x^ = z W^T + mean: kernel 9's block, 8 row groups x 16
//    sensor groups, 8 rows x 4 adjacent sensors a thread, over every
//    64-sensor tile of p in order; the W tiles (64 sensors x q, as they
//    lie) stream through a two-slot ring, their float4 chunks XOR-swizzled
//    as kernel 9's.  Each output walks q in increasing order with fused
//    multiply-adds: kernel 9's bits.  The tile's sums go to shared memory,
//    and an epilogue pass with its own layout (16 row groups x 8 column
//    groups: 4 rows x sensors 4 cg .. 4 cg + 3 and 32 + 4 cg .. a thread)
//    reads x again, half a tile at a time (the four rows' x and mask, eight
//    coalesced 16-byte loads a thread issued together; both halves at once
//    spilled in the bf16 mode), adds the mean, writes x^ and the flags on
//    the loaded x, and adds ((x - mean) m - z W^T)^2 m^2 into the rows' SPE
//    sums.  (Reading x in the product's layout put a global load's latency
//    under every pair of outputs.)
//  * SPE keeps stage_block's order (kernel 5's bits): sensor i goes to sum
//    i mod 32, each sum in increasing i from 0, then the xor butterfly over
//    the 32 sums.  In the epilogue's layout both sensors of a tile with
//    residue 4 cg + j fall to the same thread, in order, so the sums need
//    no exchange until the butterfly, whose steps 16, 8, 4 cross lanes 4,
//    2, 1 apart and whose steps 2 and 1 join the thread's j.
// No atomics, no split of a sum across blocks: two launches give equal
// bits.
//
// bf16 tile mode (T = __nv_bfloat16): x and the basis are bf16 and every
// sum is fp32, as in the reference's _fused_kernel.  Where the copies can
// be 16 bytes (p and q multiples of 8, operands aligned: vec), the rows are
// copied as they lie into rings of raw values and each thread widens the
// chunks it copied into the fp32 tiles before the barrier; elsewhere (odd
// p or q, or fp32 rows that are not 16-byte aligned) each value is loaded,
// widened, centred and masked as it is stored (cp.async has no 2-byte
// form).  Widening is exact, so the bits are those of the fp32 stages on
// the widened operands.
//
// Shared memory: the scores (64 x (q4 + 4) floats, q4 = q rounded up to 4)
// beside the larger of phase A's ring and phase B's (with its 64 x 68 tile
// of sums): at q = 32, 42 KB in fp32 and 50 KB in bf16, for any p — four
// blocks an SM.  q is bounded by the block's shared memory
// (fused_stream_max_q).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "cp_async.cuh"
#include "operand.cuh"

namespace repro_torch {

constexpr int kTileThreads = 128;
constexpr int kTileRows = 64;                    // rows a block owns
// phase A: z = xc W
constexpr int kZRG = 16, kZCG = 8;               // row x column groups
constexpr int kZTM = kTileRows / kZRG;           // 4 rows a thread
constexpr int kZCols = 4 * kZCG;                 // 32 columns a pass
constexpr int kZK = 32;                          // sensors a slice
constexpr int kZStages = 2;
constexpr int kZXLD = kZK + 4;                   // rows 1 apart: 4 banks
// phase B: x^ = z W^T
constexpr int kXRG = 8, kXSG = 16;               // row x sensor groups
constexpr int kXTM = kTileRows / kXRG;           // 8 rows a thread
constexpr int kXTile = 4 * kXSG;                 // 64 sensors a tile
constexpr int kXStages = 2;
constexpr int kXOLD = kXTile + 4;                // the tile of sums' rows
// phase B's epilogue: 16 row groups x 8 column groups
constexpr int kERG = 16, kECG = 8;
constexpr int kETM = kTileRows / kERG;           // 4 rows a thread
static_assert(kZRG * kZCG == kTileThreads && kXRG * kXSG == kTileThreads &&
                  kERG * kECG == kTileThreads,
              "every phase tiles the block's threads");
static_assert(kXTile == 64 && kECG == 8,
              "SPE sums: a tile's two sensors of a residue in one thread");

__host__ __device__ constexpr int round_up(int v, int to) {
  return (v + to - 1) / to * to;
}

// Floats of the stage tile's shared memory at q components.
template <typename T>
__host__ __device__ constexpr int stage_tile_smem_floats(int q) {
  const bool wide = sizeof(T) == 2;
  const int scores = kTileRows * (round_up(q, 4) + 4);
  const int a = kZStages * (kTileRows * kZXLD + kZK * kZCols) +
                (wide ? kZStages * (kTileRows * kZK + kZK * kZCols) / 2 : 0);
  const int b = kXStages * kXTile * round_up(q, 4) + kTileRows * kXOLD +
                (wide ? kXStages * kXTile * round_up(q, 8) / 2 : 0);
  return scores + (a > b ? a : b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Four adjacent values (16-byte or 8-byte aligned) as fp32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = widen2(v.x), b = widen2(v.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

// The stages of rows [r0, r0 + 64) of one slot.  Pointers are the slot's:
// x (R, p), m (R / mask_div, p) or unused, basis (p, q), mean (p), inv_lam
// (q) (WITH_M); outputs z (R, q), xh/flags (R, p) (WITH_C), t2/spe (R)
// (WITH_M).  vec: p and q are multiples of 16 bytes' worth of T and every
// operand is 16-byte aligned.  smem: stage_tile_smem_floats<T>(q) floats,
// 16-byte aligned.  kTileThreads threads.
template <bool HAS_MASK, bool WITH_C, bool WITH_M, typename T>
__device__ __forceinline__ void stage_tile(
    const T* __restrict__ x, const float* __restrict__ m, int mask_div,
    const T* __restrict__ basis, const float* __restrict__ mean,
    const float* __restrict__ inv_lam, int R, int p, int q, float eps,
    bool vec, int r0, float* __restrict__ z, float* __restrict__ xh,
    unsigned char* __restrict__ flags, float* __restrict__ t2,
    float* __restrict__ spe, float* __restrict__ smem) {
  constexpr bool WIDE = !std::is_same<T, float>::value;
  constexpr int NT = kTileThreads, BM = kTileRows;
  constexpr int EV = 16 / sizeof(T);             // values a 16-byte copy
  const int tid = threadIdx.x;
  const int q4 = round_up(q, 4), zld = q4 + 4;
  float* zs = smem;                              // (BM, zld) scores
  float* ring = smem + BM * zld;                 // either phase's ring

  // ---- phase A: z = ((x - mean) m) W ----------------------------------
  {
    constexpr int XS = BM * kZXLD, WS = kZK * kZCols;
    constexpr int XKC = kZK / EV;                // chunks of a slice row
    constexpr int XU = BM * XKC / NT;            // x chunks a thread
    constexpr int WKC = kZCols / EV;             // chunks of a W row
    static_assert(NT % XKC == 0 && XU >= 1, "x chunks tile the block");
    float* xs = ring;                            // kZStages x (BM, kZXLD)
    float* ws = ring + kZStages * XS;            // kZStages x (kZK, 32)
    T* xraw = reinterpret_cast<T*>(ws + kZStages * WS);   // WIDE, vec
    T* wraw = xraw + kZStages * BM * kZK;
    // the thread's x chunks: rows xm + u NT / XKC, columns xk ..
    const int xk = EV * (tid % XKC), xm = tid / XKC;
    int mrow[XU];        // their mask rows, -1 past R
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      const int r = r0 + xm + u * (NT / XKC);
      mrow[u] = r < R ? r / mask_div : -1;
    }
    const int slices = (p + kZK - 1) / kZK;
    const int cg = tid % kZCG, rg = tid / kZCG;
    // vec: the mean and mask values of the thread's chunks, loaded with
    // the slice's copies and used by prepare() a slice later
    float pf_mu[EV], pf_mk[XU][EV];

    // slice kt of x and of W's columns c0 .. c0 + 31 into ring slot `slot`
    auto load = [&](int c0, int kt, int slot) {
      const int k0 = kt * kZK;
      float* xd = xs + slot * XS;
      float* wd = ws + slot * WS;
      if (vec) {   // 16-byte copies; a chunk is all in or all out
        const bool kin = k0 + xk < p;
#pragma unroll
        for (int u = 0; u < XU; ++u) {
          const int mm = xm + u * (NT / XKC);
          const bool in = mrow[u] >= 0 && kin;
          const T* src = in ? x + (size_t)(r0 + mm) * p + k0 + xk : x;
          float* dst = WIDE ? reinterpret_cast<float*>(
                                  xraw + slot * BM * kZK + mm * kZK + xk)
                            : xd + mm * kZXLD + xk;
          cp_async16(dst, reinterpret_cast<const float*>(src), in ? 16 : 0);
        }
        for (int e = tid; e < kZK * WKC; e += NT) {
          const int kk = e / WKC, c = EV * (e % WKC);
          const bool in = k0 + kk < p && c0 + c < q;
          const T* src = in ? basis + (size_t)(k0 + kk) * q + c0 + c : basis;
          float* dst = WIDE ? reinterpret_cast<float*>(
                                  wraw + slot * WS + kk * kZCols + c)
                            : wd + kk * kZCols + c;
          cp_async16(dst, reinterpret_cast<const float*>(src), in ? 16 : 0);
        }
#pragma unroll
        for (int e = 0; e < EV; e += 4) {
          const float4 v = kin ? __ldg(reinterpret_cast<const float4*>(
                                     mean + k0 + xk + e))
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          pf_mu[e] = v.x, pf_mu[e + 1] = v.y, pf_mu[e + 2] = v.z,
          pf_mu[e + 3] = v.w;
        }
        if constexpr (HAS_MASK) {
#pragma unroll
          for (int u = 0; u < XU; ++u)
#pragma unroll
            for (int e = 0; e < EV; e += 4) {
              const float4 v =
                  mrow[u] >= 0 && kin
                      ? __ldg(reinterpret_cast<const float4*>(
                            m + (size_t)mrow[u] * p + k0 + xk + e))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              pf_mk[u][e] = v.x, pf_mk[u][e + 1] = v.y,
              pf_mk[u][e + 2] = v.z, pf_mk[u][e + 3] = v.w;
            }
        }
      } else {     // plain loads, widened, centred and masked as stored
        for (int e = tid; e < BM * kZK; e += NT) {
          const int mm = e / kZK, k = e % kZK, r = r0 + mm, i = k0 + k;
          float v = 0.0f;
          if (r < R && i < p) {
            v = __fsub_rn(to_f32(x[(size_t)r * p + i]), mean[i]);
            if (HAS_MASK)
              v = __fmul_rn(v, m[(size_t)(r / mask_div) * p + i]);
          }
          xd[mm * kZXLD + k] = v;
        }
        for (int e = tid; e < kZK * kZCols; e += NT) {
          const int kk = e / kZCols, c = e % kZCols;
          const bool in = k0 + kk < p && c0 + c < q;
          wd[kk * kZCols + c] =
              in ? to_f32(basis[(size_t)(k0 + kk) * q + c0 + c]) : 0.0f;
        }
      }
    };
    // vec: the chunks this thread copied (its groups have landed), widened,
    // centred and masked in the fp32 slice; zero past R and p
    auto prepare = [&](int kt, int slot) {
      const bool kin = kt * kZK + xk < p;
      float* xd = xs + slot * XS;
#pragma unroll
      for (int u = 0; u < XU; ++u) {
        const int mm = xm + u * (NT / XKC);
        float* d = xd + mm * kZXLD + xk;
        float v[EV];
        if constexpr (WIDE) {
          float4 lo, hi;
          widen8(*reinterpret_cast<const uint4*>(
                     xraw + slot * BM * kZK + mm * kZK + xk),
                 lo, hi);
          v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
          v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
        } else {
          const float4 a = *reinterpret_cast<const float4*>(d);
          v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
        }
        const bool in = mrow[u] >= 0 && kin;
#pragma unroll
        for (int e = 0; e < EV; ++e) {
          float t = __fsub_rn(v[e], pf_mu[e]);
          if (HAS_MASK) t = __fmul_rn(t, pf_mk[u][e]);
          v[e] = in ? t : 0.0f;
        }
#pragma unroll
        for (int e = 0; e < EV; e += 4)
          *reinterpret_cast<float4*>(d + e) =
              make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
      }
      if constexpr (WIDE) {   // W's chunks, widened
        float* wd = ws + slot * WS;
        for (int e = tid; e < kZK * WKC; e += NT) {
          const int kk = e / WKC, c = EV * (e % WKC);
          float4 lo, hi;
          widen8(*reinterpret_cast<const uint4*>(wraw + slot * WS +
                                                 kk * kZCols + c),
                 lo, hi);
          *reinterpret_cast<float4*>(wd + kk * kZCols + c) = lo;
          *reinterpret_cast<float4*>(wd + kk * kZCols + c + 4) = hi;
        }
      }
    };

    for (int c0 = 0; c0 < q; c0 += kZCols) {
      float acc[kZTM][4];
#pragma unroll
      for (int i = 0; i < kZTM; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[i][n] = 0.0f;
      load(c0, 0, 0);
      cp_async_commit();
      for (int kt = 0; kt < slices; ++kt) {
        const int slot = kt % kZStages;
        cp_async_wait<kZStages - 2>();
        if (vec) prepare(kt, slot);
        __syncthreads();   // slice kt ready; slice kt - 1's slot is free
        if (kt + 1 < slices) load(c0, kt + 1, (kt + 1) % kZStages);
        cp_async_commit();
        const float* xt = xs + slot * XS + rg * kZXLD;
        const float* wt = ws + slot * WS + 4 * cg;
#pragma unroll
        for (int k = 0; k < kZK; k += 4) {
          float4 a[kZTM], b[4];
#pragma unroll
          for (int i = 0; i < kZTM; ++i)
            a[i] = *reinterpret_cast<const float4*>(xt + i * kZRG * kZXLD + k);
#pragma unroll
          for (int j = 0; j < 4; ++j)   // b[j]: sensor k + j, columns 4 cg ..
            b[j] = *reinterpret_cast<const float4*>(wt + (k + j) * kZCols);
#pragma unroll
          for (int j = 0; j < 4; ++j)     // sensors k + j in increasing order
#pragma unroll
            for (int i = 0; i < kZTM; ++i) {
              const float av = lane_of(a[i], j);
#pragma unroll
              for (int n = 0; n < 4; ++n)
                acc[i][n] = fmaf(av, lane_of(b[j], n), acc[i][n]);
            }
        }
      }
      // this pass's scores: to shared memory (zero past q: W was) and to z
      const int c = c0 + 4 * cg;
#pragma unroll
      for (int i = 0; i < kZTM; ++i) {
        const int rr = rg + i * kZRG, r = r0 + rr;
        if (c < q4)
          *reinterpret_cast<float4*>(zs + rr * zld + c) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        if (r >= R || c >= q) continue;
        float* out = z + (size_t)r * q + c;
        if (vec) {
          *reinterpret_cast<float4*>(out) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int n = 0; n < 4; ++n)
            if (c + n < q) out[n] = acc[i][n];
        }
      }
      cp_async_wait<0>();
      __syncthreads();   // the ring is free; the scores are complete
    }
  }

  // ---- phase B: x^ = z W^T + mean, flags, SPE; and T2 ------------------
  const int q8 = round_up(q, 8), qc = q4 / 4;
  const int wtile = kXTile * q4, rtile = kXTile * q8;
  float* wring = ring;                                  // kXStages x (64, q4)
  float* xo = ring + kXStages * wtile;                  // (64, kXOLD) sums
  T* wraw = reinterpret_cast<T*>(xo + BM * kXOLD);      // WIDE, vec
  // a W tile's float4 chunks XOR-swizzled by sensor / 4 when a row has a
  // power of two of them (kernel 9's layout)
  const int rmask = (qc & (qc - 1)) == 0 ? qc - 1 : 0;
  auto swz = [rmask](int i, int ch) { return ch ^ ((i >> 2) & rmask); };
  const int ntiles = (p + kXTile - 1) / kXTile;
  const int cpr = q / EV;                       // vec: 16-byte chunks a row

  auto load_w = [&](int tile, int slot) {
    const int i0 = tile * kXTile;
    float* wd = wring + slot * wtile;
    if (vec) {
      for (int e = tid; e < kXTile * cpr; e += NT) {
        const int i = e / cpr, ch = e % cpr;
        const bool in = i0 + i < p;
        const T* src = in ? basis + (size_t)(i0 + i) * q + EV * ch : basis;
        float* dst = WIDE ? reinterpret_cast<float*>(wraw + slot * rtile +
                                                     i * q8 + EV * ch)
                          : wd + i * q4 + 4 * swz(i, ch);
        cp_async16(dst, reinterpret_cast<const float*>(src), in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kXTile * q4; e += NT) {
        const int i = e / q4, c = e % q4;
        const bool in = i0 + i < p && c < q;
        wd[i * q4 + 4 * swz(i, c >> 2) + (c & 3)] =
            in ? to_f32(basis[(size_t)(i0 + i) * q + c]) : 0.0f;
      }
    }
  };
  // WIDE, vec: the W chunks this thread copied, widened into the slot
  auto widen_w = [&](int slot) {
    float* wd = wring + slot * wtile;
    for (int e = tid; e < kXTile * cpr; e += NT) {
      const int i = e / cpr, ch = e % cpr;
      float4 lo, hi;
      widen8(*reinterpret_cast<const uint4*>(wraw + slot * rtile + i * q8 +
                                             EV * ch),
             lo, hi);
      *reinterpret_cast<float4*>(wd + i * q4 + 4 * swz(i, 2 * ch)) = lo;
      *reinterpret_cast<float4*>(wd + i * q4 + 4 * swz(i, 2 * ch + 1)) = hi;
    }
  };

#pragma unroll
  for (int st = 0; st < kXStages - 1; ++st) {
    if (st < ntiles) load_w(st, st);
    cp_async_commit();
  }

  if constexpr (WITH_M) {   // T2: a warp per row, stage_block's order
    const int warp = tid >> 5, lane = tid & 31;
    constexpr int WROWS = BM / (NT / 32);
    for (int j = 0; j < WROWS; ++j) {
      const int rr = warp * WROWS + j, r = r0 + rr;
      const float* zr = zs + rr * zld;
      float t2_acc = 0.0f;
      for (int c = lane; c < q; c += 32) t2_acc += zr[c] * zr[c] * inv_lam[c];
      t2_acc = warp_sum(t2_acc);
      if (lane == 0 && r < R) t2[r] = t2_acc;
    }
  }

  // the product's layout: rows rg + 8 t, sensors 4 sg .. 4 sg + 3
  const int sg = tid % kXSG, rg = tid / kXSG;
  const float* zr = zs + rg * zld;
  // the epilogue's layout: rows erg + 16 k, sensors 4 ecg .. and 32 + 4 ecg ..
  const int ecg = tid % kECG, erg = tid / kECG;
  int emrow[kETM];   // mask rows of the epilogue's rows
#pragma unroll
  for (int k = 0; k < kETM; ++k) {
    const int r = r0 + erg + k * kERG;
    emrow[k] = r < R ? r / mask_div : 0;
  }
  float spe_acc[kETM][4];   // the sums of residues 4 ecg .. 4 ecg + 3
#pragma unroll
  for (int k = 0; k < kETM; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) spe_acc[k][j] = 0.0f;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int slot = tile % kXStages;
    cp_async_wait<kXStages - 2>();
    if constexpr (WIDE) {
      if (vec) widen_w(slot);
    }
    __syncthreads();   // tile landed; the last tile's slot and sums are free
    if (tile + kXStages - 1 < ntiles)
      load_w(tile + kXStages - 1, (tile + kXStages - 1) % kXStages);
    cp_async_commit();
    {
      const float* wt = wring + slot * wtile;
      float acc[kXTM][4];
#pragma unroll
      for (int t = 0; t < kXTM; ++t)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[t][n] = 0.0f;
      for (int c = 0; c < q4; c += 4) {
        float4 a[kXTM], b[4];
#pragma unroll
        for (int t = 0; t < kXTM; ++t)
          a[t] = *reinterpret_cast<const float4*>(zr + t * kXRG * zld + c);
#pragma unroll
        for (int j = 0; j < 4; ++j)   // b[j]: sensor 4 sg + j, components c ..
          b[j] = *reinterpret_cast<const float4*>(
              wt + (4 * sg + j) * q4 + 4 * swz(4 * sg + j, c >> 2));
#pragma unroll
        for (int j = 0; j < 4; ++j)     // components c + j in increasing order
#pragma unroll
          for (int t = 0; t < kXTM; ++t) {
            const float zv = lane_of(a[t], j);
#pragma unroll
            for (int n = 0; n < 4; ++n)
              acc[t][n] = fmaf(zv, lane_of(b[n], j), acc[t][n]);
          }
      }
#pragma unroll
      for (int t = 0; t < kXTM; ++t)
        *reinterpret_cast<float4*>(xo + (rg + t * kXRG) * kXOLD + 4 * sg) =
            make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
    }
    __syncthreads();   // the tile's sums are in shared memory

    // epilogue, half 0 then half 1 (so each SPE sum takes its sensors in
    // increasing order): x^, flags and the SPE sums of the thread's 4 rows
    // x 4 sensors, every load of x and of the mask issued before any use
    const int ib = tile * kXTile;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = ib + hf * (kXTile / 2) + 4 * ecg;
      float4 xv[kETM], mv[kETM], mu;
      {
        float v[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) v[f] = 0.0f;
        if (vec) {
          if (i < p) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(mean + i));
            v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
          }
        } else {
#pragma unroll
          for (int f = 0; f < 4; ++f)
            if (i + f < p) v[f] = mean[i + f];
        }
        mu = make_float4(v[0], v[1], v[2], v[3]);
      }
#pragma unroll
      for (int k = 0; k < kETM; ++k) {
        const int r = r0 + erg + k * kERG;
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 b = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
        if (r < R) {
          const T* xr = x + (size_t)r * p;
          const float* mr = HAS_MASK ? m + (size_t)emrow[k] * p : nullptr;
          if (vec) {
            if (i < p) {
              a = load4(xr + i);
              if (HAS_MASK)
                b = __ldg(reinterpret_cast<const float4*>(mr + i));
            }
          } else {
            float xs4[4] = {0.0f, 0.0f, 0.0f, 0.0f},
                  ms4[4] = {1.0f, 1.0f, 1.0f, 1.0f};
#pragma unroll
            for (int f = 0; f < 4; ++f)
              if (i + f < p) {
                xs4[f] = to_f32(xr[i + f]);
                if (HAS_MASK) ms4[f] = mr[i + f];
              }
            a = make_float4(xs4[0], xs4[1], xs4[2], xs4[3]);
            b = make_float4(ms4[0], ms4[1], ms4[2], ms4[3]);
          }
        }
        xv[k] = a;
        mv[k] = b;
      }
#pragma unroll
      for (int k = 0; k < kETM; ++k) {
        const int rr = erg + k * kERG, r = r0 + rr;
        if (r >= R) continue;
        const size_t row = (size_t)r * p;
        const float4 s4 = *reinterpret_cast<const float4*>(
            xo + rr * kXOLD + hf * (kXTile / 2) + 4 * ecg);
        float xhv[4];
        unsigned char fl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xh_r = lane_of(s4, j), xj = lane_of(xv[k], j);
          const float mu_j = lane_of(mu, j);
          const float m_j = HAS_MASK ? lane_of(mv[k], j) : 1.0f;
          if constexpr (WITH_C) {
            xhv[j] = __fadd_rn(xh_r, mu_j);
            const float err = fabsf(xj - xhv[j]);
            fl[j] = (err > eps && m_j > 0.0f) ? 1 : 0;
          }
          if constexpr (WITH_M) {
            // stage_block's roundings, v = x - mean, v *= m, each its own
            // (stage_block stores v to shared memory, so no contraction
            // joins v *= m to the subtraction below)
            float v = __fsub_rn(xj, mu_j);
            if (HAS_MASK) v = __fmul_rn(v, m_j);
            const float res = (v - xh_r) * m_j;
            spe_acc[k][j] += res * res;
          }
        }
        if constexpr (WITH_C) {
          if (vec) {
            if (i < p) {
              *reinterpret_cast<float4*>(xh + row + i) =
                  make_float4(xhv[0], xhv[1], xhv[2], xhv[3]);
              *reinterpret_cast<uchar4*>(flags + row + i) =
                  make_uchar4(fl[0], fl[1], fl[2], fl[3]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (i + j < p)
                xh[row + i + j] = xhv[j], flags[row + i + j] = fl[j];
          }
        }
      }
    }
  }

  if constexpr (WITH_M) {   // the butterfly: residue bits 16, 8, 4 are lane
#pragma unroll               // bits 4, 2, 1; bits 2 and 1 the thread's j
    for (int k = 0; k < kETM; ++k) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = spe_acc[k][j];
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
          v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
      }
      const int r = r0 + erg + k * kERG;
      if (ecg == 0 && r < R) spe[r] = (v[0] + v[2]) + (v[1] + v[3]);
    }
  }
  cp_async_wait<0>();
}

}  // namespace repro_torch
