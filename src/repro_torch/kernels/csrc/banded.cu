// Kernels 10 and 11 of the port: the banded covariance products C V and
// C v (the paper's neighbour-local Cv, Sec. 3.4.3), on the band layout
// band[k, i] = C[i, i + k - h]:
//
//   Y[s, i, c] = sum_{k=0}^{2h} band[s, k, i] * V[s, i + k - h, c]
//
// Replaces repro/kernels/banded_matvec.py::banded_matmul_pallas
// (pallas_call at :85, body _matmul_kernel :65) and banded_matvec_pallas
// (:52, body _matvec_kernel :34).  The Pallas kernels keep a halo-padded
// copy of V resident in VMEM and unroll the 2h+1 diagonals over a
// (block_p, q) tile; the wrapper pads V with h zero rows per side in
// device memory.  Here the fleet's slot axis is grid y and every output
// sums the diagonals k = 0..2h in order, as
// repro.core.covariance.banded_matmul_ref does, in fp32 with a separate
// rounding for the product and the sum (no fused multiply-add: the plain
// version's `acc + band[k] * V_shifted` gives the same bits).  A halo row
// i + k - h outside [0, p) adds nothing.  No atomics, no split of a sum
// across threads or blocks: the engine's replay gives equal bits.
//
// The matvec (q = 1, kernel 11) has no column to tile: each output is one
// chain of at most 2h+1 diagonals, and each in-range band entry is read
// once for one multiply and one add, so bytes bound it at every shape.
// ops.banded_matvec_plan picks one of two entry points from (S, p, h) and
// the card's SM count:
//  * "slot" (banded_matvec_slot_f32): where the diagonals that hold an
//    in-range entry and v fit kMatvecSlotMaxBytes of shared memory and the
//    grid, a block a slot, is smaller than the card (the Berkeley fit: 31
//    x 52 floats and 52, one slot), a block copies its slot whole by
//    cp.async (16 bytes a copy where the address allows, else 4), all in
//    flight, one wait, one barrier; then each output's chain runs from
//    shared memory.  One round trip to device memory in place of one for
//    every few diagonals of a dependent loop.
//  * "thread" (banded_matvec_f32): one output a thread in blocks of
//    kBandedThreads, its diagonals in a loop with run-time bounds; both
//    loads coalesce along i.  Every other shape: wsn-1m, the sharded
//    step's padded width, the refresh's 256 slots.  A tile of four outputs
//    a thread with float4 band loads was timed against it there and gained
//    too little to keep (PERF.md, kernel 11).
// Bound (3.35 TB/s): the refresh's band 2(S p) + S((2h+1)p - h(h+1))
// floats, 254.6 MB, 0.0760 ms; wsn-1m 1.086 GB, 0.3243 ms; Berkeley 5.9 KB,
// where a launch and one round trip set the time.
//
// The product (kernel 10) is register-tiled.  A block owns BM = R RG
// consecutive rows i of one slot and CT columns (grid z tiles wider q); a
// thread owns R consecutive rows and C columns, R x C accumulators.  The
// block's diagonals [klo, khi] (those any of its rows reaches inside
// [0, p)) go in slices of at most KS = 32 of near-equal length (257
// diagonals: 5 of 29 and 4 of 28, no one-diagonal slice).  The thread
// walks a slice's diagonals in increasing order; at diagonal k row r takes
// band[k, i_t + r] (R values side by side in shared memory: R / 4 float4
// loads) times V row i_t + r + k - h.  Those R V rows slide by one row a
// diagonal, so they live in registers: each diagonal loads one new V row
// (C / 4 float4s) for R x C multiply-add pairs.  At R = 8, C = 4: 3 shared
// loads for 32 pairs, against 8 shared loads and one device-memory load
// for 32 pairs in the kernel this one replaces.  The diagonals go G = 8
// at a time, unrolled, so the register slots are known at compile time.
// For each output k increases, slice after slice: each sum is the
// reference's chain.
//
// Band and V reach shared memory by cp.async, STAGES slices in flight, the
// next slices' loads under this slice's arithmetic:
//  * the band slice as it lies, (ks, BM) coalesced along i, 16 bytes a
//    copy (4-byte copies where a chunk crosses an edge or p % 4 != 0),
//    zero-filled where i >= p or i + k - h lies outside [0, p): a zero
//    product adds +0 to a sum that is never -0, so the bits do not change;
//    read from device memory once (once per column tile above 32 columns);
//  * V through a ring of RING rows (a power of two >= BM + STAGES KS - 1),
//    each row copied once per block at the first slice that needs it.
//    Below 32 columns padding after every R ring rows keeps the reads of
//    threads R rows apart on distinct banks.
// Where a block's rows reach a slice's diagonals and V rows wholly (most
// blocks and slices), the copies go without per-chunk checks, since the
// staging's instructions share the schedulers with the arithmetic.  No
// device-memory load sits in the dependent loop, and the staging loops
// divide by powers of two only.
//
// Tiles: "rows64" (R = 8, C = 4, 64 rows x 32 columns, 64 threads, 32 KB
// of shared memory: 6 blocks an SM) for grids of at least 4 blocks an SM,
// the refresh's; "rows16" (R = 2, C = 2, 16 rows x 16 columns, 64
// threads, 18 KB) otherwise, so that a single slot (the engine's
// retirement, S = 1, p = 1024, q = 32) still spreads over 128 blocks.
// Narrower q takes narrower column tiles.
//
// Bound at the refresh's shape (S=256 slots, p=1024, h=128, q=32): the
// in-range band entries (2h+1)p - h(h+1) = 246,656 per slot, one
// multiply and one add each per column, 2*S*q*246,656 = 4.04 GFLOP
// (0.060 ms at 67 TFLOP/s fp32) against the in-range band 252.6 MB + V
// 33.5 MB read and Y 33.5 MB written (0.095 ms at 3.35 TB/s): bound by
// bytes.  Without fused multiply-adds every flop is an instruction: 4.04 G
// at one warp instruction a clock on each of the 528 schedulers (1.98 GHz)
// is 0.12 ms, above the bytes bound; a thread skips the slices its rows do
// not reach, but computes the zeros inside a slice.  At S = 1: 1.25 MB and
// 15.8 MFLOP (0.0004 ms); there one block's chain of 257 dependent
// diagonals and its slices' load latency set the time.
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace repro_torch {

constexpr int kBandedThreads = 256;   // "thread": one output a thread
// "slot": at most kMatvecSlotThreads a block, and the band's in-range
// diagonals and v in at most kMatvecSlotMaxBytes (ops.py: MATVEC_*)
constexpr int kMatvecSlotThreads = 256;
constexpr int kMatvecSlotMaxBytes = 48 * 1024;

__global__ void __launch_bounds__(kBandedThreads)
banded_matvec_kernel(const float* __restrict__ band,
                     const float* __restrict__ v, int p, int h,
                     float* __restrict__ y) {
  const size_t s = blockIdx.y;
  const int i = blockIdx.x * kBandedThreads + threadIdx.x;
  if (i >= p) return;
  const int nb = 2 * h + 1;
  const float* bs = band + s * nb * p;
  const float* vs = v + s * p;
  const int klo = max(0, h - i), khi = min(nb - 1, p - 1 - i + h);
  float acc = 0.0f;
  for (int k = klo; k <= khi; ++k)
    acc = __fadd_rn(acc, __fmul_rn(bs[(size_t)k * p + i], vs[i + k - h]));
  y[s * p + i] = acc;
}

// n floats from src into shared dst by cp.async: 16 bytes a copy where
// both addresses are 16-byte aligned (dst always is), the last n % 4 (or
// all, unaligned) 4 bytes a copy.
__device__ __forceinline__ void stage_floats(float* dst, const float* src,
                                             int n, int tid, int nt) {
  int done = 0;
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    done = n / 4 * 4;
    for (int c = tid; c < n / 4; c += nt)
      cp_async16(dst + 4 * c, src + 4 * c, 16);
  }
  for (int e = done + tid; e < n; e += nt) cp_async4(dst + e, src + e, 4);
}

// "slot": block (0, s) stages slot s's diagonals k0 .. k0 + kd - 1 and v
// in shared memory, then runs each output's chain from there.
__global__ void __launch_bounds__(kMatvecSlotThreads)
banded_matvec_slot_kernel(const float* __restrict__ band,
                          const float* __restrict__ v, int p, int h, int k0,
                          int kd, float* __restrict__ y) {
  extern __shared__ __align__(16) float matvec_smem[];
  const size_t s = blockIdx.y;
  const int nb = 2 * h + 1, tid = threadIdx.x, nt = blockDim.x;
  float* sb = matvec_smem;                      // (kd, p)
  float* sv = matvec_smem + (kd * p + 3) / 4 * 4;
  stage_floats(sb, band + (s * nb + k0) * p, kd * p, tid, nt);
  stage_floats(sv, v + s * p, p, tid, nt);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < p; i += nt) {
    const int klo = max(0, h - i), khi = min(nb - 1, p - 1 - i + h);
    const float* b = sb + (klo - k0) * p + i;
    const float* w = sv + i + klo - h;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k <= khi - klo; ++k)
      acc = __fadd_rn(acc, __fmul_rn(b[k * p], w[k]));
    y[s * p + i] = acc;
  }
}

constexpr int pow2_at_least(int n) {
  int r = 1;
  while (r < n) r *= 2;
  return r;
}

// A tile of kernel 10: R rows x C columns a thread, RG x CT/C threads
// (BM = R RG rows x CT columns a block), slices of at most KS diagonals,
// STAGES slices in flight.
template <int R_, int C_, int RG_, int CT_, int KS_, int STAGES_>
struct MatmulTile {
  static constexpr int R = R_, C = C_, RG = RG_, CT = CT_, KS = KS_;
  static constexpr int STAGES = STAGES_;
  static constexpr int BM = R * RG;            // rows a block
  static constexpr int CG = CT / C;            // column groups
  static constexpr int NT = RG * CG;           // threads
  // diagonals a thread walks unrolled (a multiple of R)
  static constexpr int G = R >= 8 ? R : 8;
  // the V rows of STAGES slices, BM + STAGES KS - 1 at most, rounded up
  // to a power of two
  static constexpr int RING = pow2_at_least(BM + STAGES * KS - 1);
  // floats of padding after every R ring rows, so that the reads of the
  // threads a quarter (half) warp holds, rows R apart, hit distinct banks
  static constexpr int PADF = CT < 32 ? CT : 0;
  static constexpr int RING_FLOATS = RING * CT + RING / R * PADF;
  static constexpr int SMEM_FLOATS = RING_FLOATS + STAGES * KS * BM;
  static_assert(C == 2 || C == 4, "columns a thread");
  static_assert(BM + STAGES * KS - 1 <= RING, "ring holds STAGES slices");
  static_assert((BM & (BM - 1)) == 0 && (CT & (CT - 1)) == 0 &&
                BM >= 4 && R % 2 == 0 && G % R == 0, "tile shape");
  static_assert(NT % CT == 0, "V staging: whole rows per pass");
};

// band (S, 2h+1, p), V (S, p, q) -> Y (S, p, q).  Block (row block, slot,
// column tile); thread t owns rows R tr .. R tr + R - 1 of the block and
// columns C tc .. C tc + C - 1 of the tile, tc = t % CG, tr = t / CG.
// vec_in: V rows may be copied 16 bytes at a time (q % 4 == 0, aligned);
// vec_band: band rows likewise (p % 4 == 0, aligned); vec_out: Y likewise
// stored.
template <class T>
__global__ void __launch_bounds__(T::NT)
banded_matmul_kernel(const float* __restrict__ band,
                     const float* __restrict__ V, int p, int h, int q,
                     bool vec_in, bool vec_band, bool vec_out,
                     float* __restrict__ Y) {
  constexpr int R = T::R, C = T::C, CT = T::CT, KS = T::KS, G = T::G;
  constexpr int STAGES = T::STAGES;
  constexpr int BM = T::BM, CG = T::CG, NT = T::NT, RING = T::RING;
  extern __shared__ __align__(16) float banded_smem[];
  float* ring = banded_smem;                     // RING rows of CT
  float* bst = banded_smem + T::RING_FLOATS;     // STAGES x (KS, BM)
  const size_t s = blockIdx.y;
  const int i0 = blockIdx.x * BM, c0 = blockIdx.z * CT;
  const int nb = 2 * h + 1;
  band += s * nb * p;
  V += s * p * q;
  Y += s * p * q;
  const int tid = threadIdx.x, tc = tid % CG, tr = tid / CG;

  // the diagonals the block's rows reach inside [0, p), in slices of
  // near-equal length; window row g = il + k holds V row i0 - h + g
  const int imax = min(i0 + BM, p) - 1;
  const int klo = max(0, h - imax), khi = min(nb - 1, p - 1 - i0 + h);
  const int len = khi - klo + 1;
  const int slices = (len + KS - 1) / KS;
  const int base = len / slices, rem = len - base * slices;
  auto slice_len = [&](int n) { return base + (n < rem ? 1 : 0); };
  auto slice_k0 = [&](int n) { return klo + n * base + min(n, rem); };
  // one past the last window row slice n reads
  auto slice_ghi = [&](int n) { return slice_k0(n) + BM + slice_len(n) - 1; };

  // offset of window row g in the ring
  auto ring_at = [](int g) {
    const int ph = g & (RING - 1);
    return ph * CT + ph / R * T::PADF;
  };

  // V window rows [glo, ghi) into the ring; zeros outside [0, p) and
  // past column q
  auto load_v = [&](int glo, int ghi) {
    if (vec_in) {   // 16-byte chunks: chunk tid % (CT / 4)
      constexpr int CH = CT / 4;
      const int c = 4 * (tid % CH);
      const bool c_in = c0 + c < q;
      if (c0 + CT <= q && glo >= h - i0 && ghi <= p + h - i0) {
        // every row inside [0, p), every column below q: no checks
        const float* src = V + (size_t)(i0 - h + glo + tid / CH) * q + c0 + c;
        for (int g = glo + tid / CH; g < ghi; g += NT / CH) {
          cp_async16(ring + ring_at(g) + c, src, 16);
          src += (size_t)(NT / CH) * q;
        }
        return;
      }
      for (int g = glo + tid / CH; g < ghi; g += NT / CH) {
        const int j = i0 - h + g;
        const bool in = c_in && (unsigned)j < (unsigned)p;
        cp_async16(ring + ring_at(g) + c,
                   in ? V + (size_t)j * q + c0 + c : V, in ? 16 : 0);
      }
    } else {        // 4-byte copies: column tid % CT, rows step NT / CT
      const int c = tid % CT;
      const bool c_in = c0 + c < q;
      for (int g = glo + tid / CT; g < ghi; g += NT / CT) {
        const int j = i0 - h + g;
        const bool in = c_in && (unsigned)j < (unsigned)p;
        cp_async4(ring + ring_at(g) + c,
                  in ? V + (size_t)j * q + c0 + c : V, in ? 4 : 0);
      }
    }
  };
  // band slice n into its stage as it lies, (kk, il) at kk BM + il, in
  // chunks of 4 rows i; zero where i >= p or i + k - h lies outside
  // [0, p).  A chunk wholly inside (or outside) is one 16-byte copy (zero
  // fill); one across an edge, or any chunk when !vec_band, four 4-byte
  // copies.
  constexpr int CHB = BM / 4;
  auto load_band = [&](int n) {
    const int k0 = slice_k0(n), ks = slice_len(n);
    float* dst0 = bst + (n % STAGES) * KS * BM;
    if constexpr (NT % CHB == 0) {
      if (vec_band && i0 + BM <= p && h - k0 <= i0 &&
          i0 + BM + k0 + ks - 1 <= p + h) {
        // every row of the block reaches every diagonal of the slice:
        // whole 16-byte chunks, no checks; the thread's chunk column is
        // fixed, its diagonals step by NT / CHB
        constexpr int KST = NT / CHB;
        const int il = 4 * (tid % CHB), kk0 = tid / CHB;
        const float* src = band + (size_t)(k0 + kk0) * p + i0 + il;
        float* dst = dst0 + kk0 * BM + il;
        for (int kk = kk0; kk < ks; kk += KST) {
          cp_async16(dst, src, 16);
          src += (size_t)KST * p;
          dst += KST * BM;
        }
        return;
      }
    }
    for (int e = tid; e < ks * CHB; e += NT) {
      const int kk = e / CHB, il = 4 * (e % CHB);
      const int i = i0 + il, j = i + k0 + kk - h;
      const float* src = band + (size_t)(k0 + kk) * p + i;
      float* dst = dst0 + kk * BM + il;
      if (vec_band && i + 3 < p && j >= 0 && j + 3 < p) {
        cp_async16(dst, src, 16);
      } else if (i >= p || j + 3 < 0 || j >= p) {
        cp_async16(dst, band, 0);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const bool in = i + m < p && (unsigned)(j + m) < (unsigned)p;
          cp_async4(dst + m, in ? src + m : band, in ? 4 : 0);
        }
      }
    }
  };
  auto load_slice = [&](int n) {
    load_v(n == 0 ? klo : slice_ghi(n - 1), slice_ghi(n));
    load_band(n);
  };

  // the diagonals the thread's own rows reach: slices outside add zeros
  const int it = i0 + R * tr;
  const int tklo = max(0, h - min(it + R - 1, p - 1));
  const int tkhi = it < p ? min(nb - 1, p - 1 - it + h) : -1;

  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < slices) load_slice(st);
    cp_async_commit();
  }
  for (int n = 0; n < slices; ++n) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // slice n landed; slice n - 1's buffers are free
    if (n + STAGES - 1 < slices) load_slice(n + STAGES - 1);
    cp_async_commit();
    const int k0 = slice_k0(n), ks = slice_len(n);
    if (k0 > tkhi || k0 + ks - 1 < tklo) continue;

    // Diagonal kk of the slice: row r takes band[k0 + kk, it + r] times
    // V window row t = r + kk of the thread (ring row R tr + k0 + t).  The
    // R window rows live in registers, row t in slot t % R: each diagonal
    // loads one new V row and R band values (R / 4 float4s, contiguous)
    // for R x C multiply-add pairs.
    const int gt = R * tr + k0;
    const float* bt = bst + (n % STAGES) * KS * BM + R * tr;
    float win[R][C];
    auto load_row = [&](int t, float (&w)[C]) {
      const float* row = ring + ring_at(gt + t) + C * tc;
      if constexpr (C == 2) {
        const float2 x = *reinterpret_cast<const float2*>(row);
        w[0] = x.x, w[1] = x.y;
      } else {
#pragma unroll
        for (int c = 0; c < C; c += 4) {
          const float4 x = *reinterpret_cast<const float4*>(row + c);
          w[c] = x.x, w[c + 1] = x.y, w[c + 2] = x.z, w[c + 3] = x.w;
        }
      }
    };
    // diagonal kk = kk0 + d, kk0 a multiple of R: its new window row
    // kk + R - 1 goes to slot (d + R - 1) % R, row r reads slot (r + d) % R
    auto diagonal = [&](int kk, int d) {
      load_row(kk + R - 1, win[(d + R - 1) % R]);
      float b[R];
#pragma unroll
      for (int r = 0; r < R; r += R % 4 == 0 ? 4 : 2) {
        if constexpr (R % 4 == 0) {
          const float4 w = *reinterpret_cast<const float4*>(bt + kk * BM + r);
          b[r] = w.x, b[r + 1] = w.y, b[r + 2] = w.z, b[r + 3] = w.w;
        } else {
          const float2 w = *reinterpret_cast<const float2*>(bt + kk * BM + r);
          b[r] = w.x, b[r + 1] = w.y;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* v = win[(r + d) % R];
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(b[r], v[c]));
      }
    };
#pragma unroll
    for (int t = 0; t < R - 1; ++t) load_row(t, win[t]);
    int kk0 = 0;
    for (; kk0 + G <= ks; kk0 += G) {
#pragma unroll
      for (int d = 0; d < G; ++d) diagonal(kk0 + d, d);
    }
#pragma unroll
    for (int d = 0; d < G; ++d) {   // the last diagonals, fewer than G
      if (kk0 + d >= ks) break;
      diagonal(kk0 + d, d);
    }
  }

  const int c = c0 + C * tc;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = it + r;
    if (i >= p) continue;
    float* out = Y + (size_t)i * q + c;
#pragma unroll
    for (int c4 = 0; c4 < C; c4 += 4) {
      if (c + c4 >= q) continue;
      if (vec_out && C % 4 == 0) {
        *reinterpret_cast<float4*>(out + c4) =
            make_float4(acc[r][c4], acc[r][c4 + 1], acc[r][c4 + 2],
                        acc[r][c4 + 3]);
      } else {
#pragma unroll
        for (int n = c4; n < c4 + 4 && n < C; ++n)
          if (c + n < q) out[n] = acc[r][n];
      }
    }
  }
}

static bool aligned16(const void* ptr) {
  return (reinterpret_cast<size_t>(ptr) & 15) == 0;
}

template <class T>
static int launch_matmul(const float* band, const float* V, int S, int p,
                         int h, int q, float* Y, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * T::SMEM_FLOATS;
  static_assert(smem <= 48 * 1024, "dynamic shared memory by default");
  const bool vec_in = q % 4 == 0 && aligned16(V);
  const bool vec_band = p % 4 == 0 && aligned16(band);
  const bool vec_out = q % 4 == 0 && aligned16(Y);
  dim3 grid((p + T::BM - 1) / T::BM, S, (q + T::CT - 1) / T::CT);
  banded_matmul_kernel<T><<<grid, T::NT, smem, stream>>>(
      band, V, p, h, q, vec_in, vec_band, vec_out, Y);
  return (int)cudaGetLastError();
}

// "rows64": 8 rows x 4 columns a thread, 64 rows x 32 columns a block of
// 64 threads (narrower for q <= 16), slices of 32 diagonals, 2 in flight:
// 32 KB of shared memory, 6 blocks an SM.
template <int CT>
using Rows64 = MatmulTile<8, 4, 8, CT, 32, 2>;
// "rows16": 2 rows x 2 columns a thread, 16 rows x 16 columns a block of
// 64 threads (narrower for q <= 8), slices of 32 diagonals, 3 in flight:
// 18 KB.
template <int CT>
using Rows16 = MatmulTile<2, 2, 8, CT, 32, 3>;

// The column tile: the least of 4, 8, 16 (and 32 for rows64) that holds
// q, the widest above it with column tiles on grid z.
template <template <int> class Tile, int MAXCT>
static int launch_cols(const float* band, const float* V, int S, int p,
                       int h, int q, float* Y, cudaStream_t st) {
  if (q <= 4) return launch_matmul<Tile<4>>(band, V, S, p, h, q, Y, st);
  if (q <= 8) return launch_matmul<Tile<8>>(band, V, S, p, h, q, Y, st);
  if (q <= 16 || MAXCT == 16)
    return launch_matmul<Tile<16>>(band, V, S, p, h, q, Y, st);
  return launch_matmul<Tile<MAXCT>>(band, V, S, p, h, q, Y, st);
}

enum BandedTile { kTileAuto = 0, kTileRows64 = 1, kTileRows16 = 2 };

}  // namespace repro_torch

extern "C" {

// Kernel 10 with its tile named: 1 "rows64" (8 rows a thread, 64 a
// block), 2 "rows16" (2 rows a thread, 16 a block), 0 the choice of
// banded_matmul_f32.  band (S, 2h+1, p), V (S, p, q), Y (S, p, q); fp32,
// contiguous.  Any p, h >= 0 and q >= 1.
int banded_matmul_tile_f32(const float* band, const float* V, int S, int p,
                           int h, int q, int tile, float* Y, void* stream) {
  using namespace repro_torch;
  if (S < 1 || p < 1 || h < 0 || q < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (tile == kTileAuto) {
    // rows64 where its grid gives every SM at least 4 blocks, else
    // rows16: a few slots spread over the SMs
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)S * ((p + 63) / 64) *
                             ((q + 31) / 32);
    tile = blocks >= 4LL * sms ? kTileRows64 : kTileRows16;
  }
  if (tile == kTileRows64)
    return launch_cols<Rows64, 32>(band, V, S, p, h, q, Y, st);
  if (tile == kTileRows16)
    return launch_cols<Rows16, 16>(band, V, S, p, h, q, Y, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel 10: band (S, 2h+1, p), V (S, p, q), Y (S, p, q); fp32, contiguous.
// The tile is chosen from the grid (banded_matmul_tile_f32, tile 0).
int banded_matmul_f32(const float* band, const float* V, int S, int p, int h,
                      int q, float* Y, void* stream) {
  return banded_matmul_tile_f32(band, V, S, p, h, q, 0, Y, stream);
}

// Kernel 11, "thread": band (S, 2h+1, p), v (S, p), y (S, p); fp32,
// contiguous.
int banded_matvec_f32(const float* band, const float* v, int S, int p, int h,
                      float* y, void* stream) {
  using namespace repro_torch;
  dim3 grid((p + kBandedThreads - 1) / kBandedThreads, S);
  banded_matvec_kernel<<<grid, kBandedThreads, 0, (cudaStream_t)stream>>>(
      band, v, p, h, y);
  return (int)cudaGetLastError();
}

// Kernel 11, "slot": as banded_matvec_f32, a block a slot; refused where
// the diagonals that hold an in-range entry, |k - h| <= p - 1, and v (at a
// 16-byte boundary) pass kMatvecSlotMaxBytes.
int banded_matvec_slot_f32(const float* band, const float* v, int S, int p,
                           int h, float* y, void* stream) {
  using namespace repro_torch;
  if (S < 1 || p < 1 || h < 0) return (int)cudaErrorInvalidValue;
  const int k0 = h - p + 1 > 0 ? h - p + 1 : 0;
  const int kd = (2 * h < h + p - 1 ? 2 * h : h + p - 1) - k0 + 1;
  const long long bytes = 4 * (((long long)kd * p + 3) / 4 * 4 + p);
  if (bytes > kMatvecSlotMaxBytes) return (int)cudaErrorInvalidValue;
  const int t = (p + 31) / 32 * 32;
  banded_matvec_slot_kernel<<<dim3(1, S),
                              t < kMatvecSlotThreads ? t : kMatvecSlotThreads,
                              (int)bytes, (cudaStream_t)stream>>>(
      band, v, p, h, k0, kd, y);
  return (int)cudaGetLastError();
}

}  // extern "C"
