// The banded, forgetting-weighted SYRK of kernels 2 and 3 (a chunk) and 6
// and 7 (one round) (band_fold.cu):
//
//   band[k, i] = sum_t w[t] sum_e (m x)[t n + e, i] (m x)[t n + e, i + k - h]
//
// over a slot's chunk x (R = K n rows, p columns, row-major; row r = t n + e
// is epoch e of round t), one weight per round, and an optional 0/1 mask,
// (K, p) per-round liveness or, with PER_READING, (R, p) per-reading
// dropout.  Out-of-range entries (i + k - h outside [0, p)) are 0.
//
// The order of sums (the bits contract).  A round's rows are cut into
// segments of kSegRows consecutive rows (the last may be shorter), and
// every pair (i, j) is summed as
//   c_tg = 0;  c_tg = fma(mx_i, mx_j, c_tg) over segment g's rows;
//   acc = fma(w_t, c_tg, acc) for g = 0, 1, ..., for t = 0 .. K-1,
// from acc = 0, with explicit __fmaf_rn / __fmul_rn, so no contraction can
// differ between files.  The segments depend on n alone, never on S, p, h
// or the block that holds a segment, so a slot's band has the same bits
// however a launch divides its rows.  A product inside an fma commutes
// exactly, so the order is symmetric in (i, j): the mirrored entry
// band[h - d, i + d] := band[h + d, i] carries the bits a direct
// computation of it gives.  Kernel 1's fold blocks (fused_stream.cu) are
// this tile too, in both of its tile modes.  At K = 1 and w = 1 the order
// is that of kernels 6 and 7, which sum one round with unit weight: in the
// round's shape here (ROUND: n <= kSegRows, one segment, s_0 scaled in
// place, s_0 = fma(f, s_0, 0), the bits of acc = fma(f, s_0, acc) from
// acc = 0), and for longer rounds in the chunk's shape at unit weight
// (UNIT) or with the segments on blocks of their own (band_fold.cu).  A 0/1
// liveness mask enters at each segment's end, acc = fma((w_t m_ti) m_tj,
// c_tg, acc) over the unmasked c_tg: a live pair gives the masked chain's
// bits (x 1 = x), a dead one adds exactly 0, as the masked chain's +0
// does.  A round of n <= kSegRows rows is one segment: the order before
// segments existed, so every path of 32-row rounds keeps its bits.
//
// Design.  The p x p matrix is cut into T x T tiles (I, J), J >= I, and a
// block computes one tile that meets the band 0 <= j - i <= h: at p = 1024,
// h = 128, T = 64 the diagonal tiles and the next two, 45 a slot.  Four
// warps each own a 32 x 32 quarter of the tile; a quarter that holds no
// pair of the band (below the diagonal of a diagonal tile, past h in the
// last) skips the arithmetic, so about 1.24x the unique pairs are computed
// (the dense product does 8.5x).  A thread owns 8 rows x 4 columns, two
// accumulator sets (s for the segment, acc across segments and rounds).
// The chunk's rows stream through shared memory in stages of kSyrkRows
// rows, kSyrkStages in flight by cp.async: x at the tile's I columns and at
// its J columns (one copy for a diagonal tile), 16 bytes a copy where p %
// 4 == 0 and the rows are aligned, 4 bytes otherwise, zero past column p;
// with a dropout mask, its rows too, then each thread multiplies the
// chunks it copied (mx = x m) before the stage's barrier; a liveness mask
// is read at each segment's end, 12 values a thread, as the segment's
// last stage starts.  Per row a thread loads 8 + 4 operands (three 16-byte
// shared loads; a warp's lanes share them: 8 lanes a row group, 4 a column
// group) for 32 fused multiply-adds.  A segment boundary follows the row
// index, not the staging, so n need not divide the stage.  At the end the
// tile's sums go to shared memory and out along wrapped diagonals (entry
// (ii, (ii + delta) mod T)): a warp stores two consecutive runs of
// band[h + d, i] and of their mirrors band[h - d, i + d].  The diagonal
// tiles also write the out-of-range zeros of their rows, so every entry of
// the band is written once (no memset).  No atomics: two launches give
// equal bits.
//
// bf16 rows (T = __nv_bfloat16: kernel 1's bf16 tile mode, the chunk fold
// with a liveness mask or none).  Where p % 8 == 0 and the rows are
// aligned, a stage's rows are copied as they lie, 16 bytes (8 values) a
// cp.async, into a second ring beside the fp32 one; each thread widens the
// chunks it copied into the fp32 stage before the stage's barrier, as the
// dropout mask is applied.  Elsewhere (odd p) the thread loads each value
// and widens it as it stores it (cp.async has no 2-byte form).  Widening
// is exact, so the band is the fp32 fold's of the widened rows, bit for bit.
//
// A round (ROUND, n <= kSegRows) is bound by its launch's instructions, not
// by the band's writeback: at n = 32 rows a block does 32 rows of fused
// multiply-adds and then writes up to 8,192 entries, so the epilogue weighs
// as much as the arithmetic.  Its shape: one accumulator set (the round's
// s, which frees 32 registers: five blocks an SM instead of four), stages
// of kRoundRows rows (two in flight over a 32-row round, so the second
// half's copy overlaps the first half's arithmetic), and an epilogue whose
// loop keeps per thread the row ii, the range of jj inside the band and
// the two base offsets, so an entry costs one range test, a shared load
// and its stores.  It writes the same entries in the same order as the
// chunk's.  The chunk keeps its own loop: on the round's, kernel 3 ran
// 2-3% slower on the H100 (0.836 / 0.842 ms against 0.817 / 0.817 at the
// slice).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "cp_async.cuh"
#include "operand.cuh"

namespace repro_torch {

constexpr int kSyrkT = 64;          // a tile: kSyrkT rows x kSyrkT columns
constexpr int kSyrkRM = 8;          // rows a thread
constexpr int kSyrkCM = 4;          // columns a thread
constexpr int kSyrkRows = 32;       // rows of x a stage
constexpr int kSyrkStages = 2;      // stages in flight
constexpr int kRoundRows = 16;      // the same for a round (ROUND)
constexpr int kRoundStages = 2;
// the order of sums: a round's rows in segments of kSegRows (above)
constexpr int kSegRows = 64;
// rounds of more rows than this take the chunk's shape at unit weight or
// the split fold (band_fold.cu); the round's shape holds one segment
constexpr int kLongRound = 64;
static_assert(kLongRound <= kSegRows, "ROUND sums one segment");
static_assert(kSegRows % kSyrkRows == 0 && kSegRows % kRoundRows == 0 &&
                  kSegRows >= 32,
              "segments end at stage ends; a 32-row round is one segment");
// a warp's 4 x 8 lanes cover (4 RM) x (8 CM) of the tile: 32 x 32, a quarter
constexpr int kSyrkWR = 4 * kSyrkRM, kSyrkWC = 8 * kSyrkCM;
constexpr int kSyrkThreads = 32 * (kSyrkT / kSyrkWR) * (kSyrkT / kSyrkWC);

// Column-tile offsets J - I a row tile takes: 0 .. ceil(h / T), capped at
// the last tile.
__host__ __device__ inline int syrk_offsets(int p, int h) {
  const int tiles = (p + kSyrkT - 1) / kSyrkT;
  const int d = (h + kSyrkT - 1) / kSyrkT;
  return (d < tiles - 1 ? d : tiles - 1) + 1;
}

// Shared memory of a block: kSyrkStages stages of x at I and J (and, for a
// dropout mask, the mask at I and J), each (kSyrkRows, kSyrkT), or for a
// round kRoundStages of kRoundRows; the (T, T) output tile reuses them.
// WIDE (bf16 rows) adds the ring of raw rows, half the size in floats.
// ACC adds the band_in prefetch past the ring: (T, T) floats, and a second
// (T, T) for a round, whose ring has no stage slot of that size to spare.
template <bool STAGED_MASK, bool ROUND = false, bool WIDE = false,
          bool ACC = false>
constexpr int syrk_smem_floats() {
  return (ROUND ? kRoundStages * kRoundRows : kSyrkStages * kSyrkRows) *
             ((STAGED_MASK ? 4 : 2) + (WIDE ? 1 : 0)) * kSyrkT +
         (ACC ? (ROUND ? 2 : 1) * kSyrkT * kSyrkT : 0);
}
static_assert(syrk_smem_floats<false>() >= kSyrkT * kSyrkT &&
                  syrk_smem_floats<false, true>() >= kSyrkT * kSyrkT,
              "the output tile reuses the stages");
static_assert(kSyrkT % kSyrkWR == 0 && kSyrkT % kSyrkWC == 0 &&
              kSyrkRM % 4 == 0 && kSyrkCM % 4 == 0 &&
              kSyrkThreads % kSyrkT == 0,
              "warps of 4 x 8 lanes tile the tile; float4 operands");

// The accumulating form (ACC).  A thread writes the entries of the plain
// write-outs below: row ii = tid % T of the tile, columns jj = (ii + tid /
// T + k NT / T) mod T for k < kAccEntries, each band[h + d, i] and its
// mirror band[h - d, j] (d = j - i).  Their band_in values come into
// shared memory by cp.async ahead of the write-out, slot k NT + tid of a
// buffer of T T floats each (the thread reads back what it copied): those
// at band[h + d, i] with the first stage's rows, into a buffer of their
// own past the ring, the mirrors as the last stage's arithmetic starts,
// into the ring slot it leaves free (a round, whose ring has no slot to
// spare, takes both with its first stage's rows), so the loads' latency
// hides behind the arithmetic (acc_prefetch; on the H100 at wsn-1m's
// batch, the direct values with the last stage's rows, or both halves
// with the first stage's in a buffer of 32 KB, three blocks an SM, ran
// slower, PERF.md).  Then each entry is band_in + v by one __fadd_rn
// (never contracted into the sum's last fma), so the band carries the bits
// of band_in + the delta form's band, the out-of-range zeros as band_in +
// 0 (band_tile_accumulate).
constexpr int kAccEntries = kSyrkT * kSyrkT / kSyrkThreads;

__device__ __forceinline__ int acc_column(int tid, int k) {
  return (tid % kSyrkT + tid / kSyrkT + k * (kSyrkThreads / kSyrkT)) &
         (kSyrkT - 1);
}

// band_in at the thread's entries (or their mirrors) into dst; zero-filled
// where the pair is outside the band or the matrix (never written)
__device__ __forceinline__ void acc_prefetch(
    float* dst, const float* __restrict__ band_in, int i0, int j0, int p,
    int h, bool mirror) {
  const int tid = threadIdx.x, ii = tid % kSyrkT, i = i0 + ii;
#pragma unroll 8
  for (int k = 0; k < kAccEntries; ++k) {
    const int jj = acc_column(tid, k), d = j0 + jj - i, j = j0 + jj;
    const bool in = d >= (mirror ? 1 : 0) && d <= h && j < p;
    const ptrdiff_t at = mirror ? (ptrdiff_t)(h - d) * p + j
                                : (ptrdiff_t)(h + d) * p + i;
    cp_async4(dst + k * kSyrkThreads + tid, band_in + (in ? at : 0),
              in ? 4 : 0);
  }
}

// The write-out once the tile's sums stand in cs (T, T) and the
// prefetches (up: band[h + d, i]; mirror: band[h - d, j]) have landed.
__device__ __forceinline__ void band_tile_accumulate(
    const float* cs, const float* up, const float* mirror,
    const float* __restrict__ band_in, float* __restrict__ band, int i0,
    int j0, bool diag, int p, int h) {
  constexpr int TT = kSyrkT, NT = kSyrkThreads;
  const int tid = threadIdx.x, ii = tid % TT, i = i0 + ii;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kAccEntries; ++k) {
    const int jj = acc_column(tid, k), d = j0 + jj - i, j = j0 + jj;
    if (d < 0 || d > h || j >= p) continue;
    const float v = cs[ii * TT + jj];
    band[(size_t)(h + d) * p + i] = __fadd_rn(up[k * NT + tid], v);
    if (d > 0)
      band[(size_t)(h - d) * p + j] = __fadd_rn(mirror[k * NT + tid], v);
  }
  // the zeros of the tile's rows, as band_syrk_tile writes them
  if (diag && (i0 < h || min(i0 + TT, p) - 1 + h >= p)) {
    for (int f = tid; f < h * TT; f += NT) {
      const int d = 1 + f / TT, r = i0 + f % TT;
      if (r >= p) continue;
      if (r < d) {
        const size_t at = (size_t)(h - d) * p + r;
        band[at] = __fadd_rn(__ldg(band_in + at), 0.0f);
      }
      if (r + d >= p) {
        const size_t at = (size_t)(h + d) * p + r;
        band[at] = __fadd_rn(__ldg(band_in + at), 0.0f);
      }
    }
  }
}

// One tile (blockIdx-free: ``tile`` = I * syrk_offsets(p, h) + (J - I)) of
// one slot: x (R, p), w (K) (unread with ROUND, which takes K = 1 and
// n <= kSegRows), m
// (K, p), or (R, p) with PER_READING, or null, band (2h+1, p).  vec: x and
// m may be copied 16 bytes at a time (p a multiple of 16 bytes' worth of
// T, both aligned).  smem: syrk_smem_floats<HAS_MASK && PER_READING,
// ROUND, WIDE, ACC>() floats, 16-byte aligned.  x is fp32 or, for the chunk
// fold without a dropout mask, bf16 (WIDE: widened as it is staged).
// MASK_AT_FLUSH (kernel 1) loads a round's liveness values as the round
// ends instead of as its last stage starts: 12 registers fewer through the
// stage's multiply-adds, for a tile that is a called function (whose
// calling convention leaves it fewer registers than a kernel's own body).
// UNIT (kernels 6 and 7 past one segment: K = 1, unit weight, w unread)
// keeps the chunk's shape; ROUND implies it.  ACC (kernel 6's accumulating
// form) writes band = band_in + the sums (above): band_in (2h+1, p), read
// once, never band itself.
template <bool HAS_MASK, bool PER_READING, bool ROUND = false,
          typename T = float, bool MASK_AT_FLUSH = false, bool UNIT = ROUND,
          bool ACC = false>
__device__ __forceinline__ void band_syrk_tile(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ m, int K, int n, int p, int h, bool vec,
    int tile, float* __restrict__ band, float* __restrict__ smem,
    const float* __restrict__ band_in = nullptr) {
  constexpr bool WIDE = !std::is_same<T, float>::value;
  static_assert(!(ACC && WIDE), "the accumulating form folds fp32 rows");
  static_assert(!WIDE || (std::is_same<T, __nv_bfloat16>::value && !ROUND &&
                          !PER_READING),
                "bf16 rows: the chunk fold without a dropout mask");
  constexpr bool STAGED = HAS_MASK && PER_READING;   // mask rows staged
  constexpr bool ROUND_MASK = HAS_MASK && !PER_READING;
  constexpr int TT = kSyrkT, NT = kSyrkThreads;
  constexpr int RB = ROUND ? kRoundRows : kSyrkRows;
  constexpr int ST = ROUND ? kRoundStages : kSyrkStages;
  constexpr int RM = kSyrkRM, CM = kSyrkCM;
  constexpr int WR = kSyrkWR, WC = kSyrkWC, WGC = TT / WC;
  constexpr int BUF = RB * TT;                  // one operand of a stage
  constexpr int STAGE = (STAGED ? 4 : 2) * BUF;
  constexpr int EV = 16 / sizeof(T);             // values a 16-byte copy
  // WIDE: the raw rows of stage slot st at raw + (st % ST) STAGE, laid out
  // as the fp32 stage (an fp32 address d has its raw value at raw + (d -
  // smem))
  T* raw = reinterpret_cast<T*>(smem + ST * STAGE);
  const int offsets = syrk_offsets(p, h);
  const int ti = tile / offsets, dj = tile % offsets;
  const int i0 = ti * TT, j0 = (ti + dj) * TT;
  if (j0 >= p) return;                          // past the last tile
  const bool diag = dj == 0;
  const int R = K * n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the warp's part (wr, wc); the thread's rows ri.., columns cj..
  const int wr = warp / WGC, wc = warp % WGC;
  const int ri = WR * wr + RM * (lane / 8), cj = WC * wc + CM * (lane % 8);
  // the part holds a pair with 0 <= j - i <= h, i and j inside [0, p)
  const int qi = i0 + WR * wr, qj = j0 + WC * wc;
  const bool active = qi < p && qj < p && min(qj + WC - 1, p - 1) >= qi &&
                      qj - min(qi + WR - 1, p - 1) <= h;

  // Stage st: rows [st RB, st RB + RB) of x (and of a dropout mask) at
  // the tile's I columns (offset 0) and J columns (offset BUF; the mask at
  // 2 BUF and 3 BUF), into ring slot st % ST.  A diagonal tile copies I
  // only.  The thread's copies are fixed by tid, so apply_mask can treat
  // exactly the chunks the thread copied.
  auto for_chunks = [&](int st, auto&& f) {
    float* buf = smem + (st % ST) * STAGE;
    const int r0 = st * RB, rows = min(RB, R - r0);
    if (vec) {        // 16-byte chunks: chunk tid % (T / EV)
      constexpr int CH = TT / EV;
      const int c = EV * (tid % CH);
      for (int rr = tid / CH; rr < rows; rr += NT / CH)
        f(buf + rr * TT + c, r0 + rr, c);
    } else {          // 4-byte copies: column tid % T
      const int c = tid % TT;
      for (int rr = tid / TT; rr < rows; rr += NT / TT)
        f(buf + rr * TT + c, r0 + rr, c);
    }
  };
  auto stage = [&](int st) {
    for_chunks(st, [&](float* d, int r, int c) {
      const bool in_i = i0 + c < p, in_j = j0 + c < p;
      const T* xr = x + (size_t)r * p;
      const float* mr = STAGED ? m + (size_t)r * p : nullptr;
      if constexpr (WIDE) {
        if (vec) {    // the raw rows, widened by widen() before the barrier
          T* rd = raw + (d - smem);
          cp_async16(reinterpret_cast<float*>(rd),
                     reinterpret_cast<const float*>(in_i ? xr + i0 + c : x),
                     in_i ? 16 : 0);
          if (!diag)
            cp_async16(reinterpret_cast<float*>(rd + BUF),
                       reinterpret_cast<const float*>(in_j ? xr + j0 + c : x),
                       in_j ? 16 : 0);
        } else {      // a plain load, widened as it is stored
          *d = in_i ? to_f32(xr[i0 + c]) : 0.0f;
          if (!diag) d[BUF] = in_j ? to_f32(xr[j0 + c]) : 0.0f;
        }
      } else if (vec) {
        cp_async16(d, in_i ? xr + i0 + c : x, in_i ? 16 : 0);
        if (!diag) cp_async16(d + BUF, in_j ? xr + j0 + c : x, in_j ? 16 : 0);
        if (STAGED) {
          cp_async16(d + 2 * BUF, in_i ? mr + i0 + c : m, in_i ? 16 : 0);
          if (!diag)
            cp_async16(d + 3 * BUF, in_j ? mr + j0 + c : m, in_j ? 16 : 0);
        }
      } else {
        cp_async4(d, in_i ? xr + i0 + c : x, in_i ? 4 : 0);
        if (!diag) cp_async4(d + BUF, in_j ? xr + j0 + c : x, in_j ? 4 : 0);
        if (STAGED) {
          cp_async4(d + 2 * BUF, in_i ? mr + i0 + c : m, in_i ? 4 : 0);
          if (!diag)
            cp_async4(d + 3 * BUF, in_j ? mr + j0 + c : m, in_j ? 4 : 0);
        }
      }
    });
  };
  // mx = x m in place, on the chunks this thread copied (its own cp.async
  // groups have landed, so no barrier is needed before it)
  auto apply_mask = [&](int st) {
    for_chunks(st, [&](float* d, int, int) {
      for (int o = 0; o < (diag ? 1 : 2); ++o) {
        float* v = d + o * BUF;
        const float* mv = v + 2 * BUF;
        if (vec) {
          float4 a = *reinterpret_cast<float4*>(v);
          const float4 b = *reinterpret_cast<const float4*>(mv);
          a.x = __fmul_rn(a.x, b.x);
          a.y = __fmul_rn(a.y, b.y);
          a.z = __fmul_rn(a.z, b.z);
          a.w = __fmul_rn(a.w, b.w);
          *reinterpret_cast<float4*>(v) = a;
        } else {
          *v = __fmul_rn(*v, *mv);
        }
      }
    });
  };

  // WIDE, 16-byte copies: the chunks this thread copied, widened into the
  // fp32 stage (its own cp.async groups have landed)
  auto widen = [&](int st) {
    for_chunks(st, [&](float* d, int, int) {
      for (int o = 0; o < (diag ? 1 : 2); ++o) {
        float4 lo, hi;
        widen8(*reinterpret_cast<const uint4*>(raw + (d - smem) + o * BUF),
               lo, hi);
        *reinterpret_cast<float4*>(d + o * BUF) = lo;
        *reinterpret_cast<float4*>(d + o * BUF + 4) = hi;
      }
    });
  };

  float s[RM][CM], acc[RM][CM];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < CM; ++b) s[a][b] = acc[a][b] = 0.0f;
  // the round of the next row, and the row after the segment that holds
  // it (the next flush); round t ends at row (t + 1) n
  int t = 0, flush_end = min(n, kSegRows);
  static_assert(UNIT || !ROUND, "a round has unit weight");
  float wt = UNIT ? 1.0f : __ldg(w);
  // round t's liveness at the thread's rows and columns (1 without a mask),
  // loaded ahead of the round's last rows where the stage allows
  float mi[RM], mj[CM];
#pragma unroll
  for (int a = 0; a < RM; ++a) mi[a] = 1.0f;
#pragma unroll
  for (int b = 0; b < CM; ++b) mj[b] = 1.0f;
  auto load_mask = [&]() {
    if constexpr (ROUND_MASK) {
      const float* mt = m + (size_t)t * p;
#pragma unroll
      for (int a = 0; a < RM; ++a)
        mi[a] = i0 + ri + a < p ? __ldg(mt + i0 + ri + a) : 0.0f;
#pragma unroll
      for (int b = 0; b < CM; ++b)
        mj[b] = j0 + cj + b < p ? __ldg(mt + j0 + cj + b) : 0.0f;
    }
  };
  // end of a segment of round t: acc = fma(w_t, s, acc), or with a
  // liveness mask acc = fma((w_t m_ti) m_tj, s, acc); at the round's end
  // the next round's weight is loaded here, ahead of its rows.  A ROUND
  // ends once, from acc = 0: s takes acc's value in place, and acc is
  // never used
  auto flush = [&]() {
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const float wa = ROUND_MASK ? __fmul_rn(wt, mi[a]) : wt;
#pragma unroll
      for (int b = 0; b < CM; ++b) {
        const float f = ROUND_MASK ? __fmul_rn(wa, mj[b]) : wa;
        if constexpr (ROUND) {
          s[a][b] = __fmaf_rn(f, s[a][b], 0.0f);
        } else {
          acc[a][b] = __fmaf_rn(f, s[a][b], acc[a][b]);
          s[a][b] = 0.0f;
        }
      }
    }
    // at a round's end t moves on; the weight is (re)loaded either way,
    // without a branch (an unchanged t loads the same weight)
    t += flush_end == (t + 1) * n;
    if constexpr (!UNIT) wt = t < K ? __ldg(w + t) : 0.0f;
    flush_end = min((t + 1) * n, flush_end + kSegRows);
  };
  // one row: the thread's RM values at I and CM at J (float4 loads),
  // RM x CM fused multiply-adds
  auto row = [&](const float* ar, const float* br) {
    float av[RM], bv[CM];
#pragma unroll
    for (int a = 0; a < RM; a += 4) {
      const float4 v = *reinterpret_cast<const float4*>(ar + a);
      av[a] = v.x, av[a + 1] = v.y, av[a + 2] = v.z, av[a + 3] = v.w;
    }
#pragma unroll
    for (int b = 0; b < CM; b += 4) {
      const float4 v = *reinterpret_cast<const float4*>(br + b);
      bv[b] = v.x, bv[b + 1] = v.y, bv[b + 2] = v.z, bv[b + 3] = v.w;
    }
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int b = 0; b < CM; ++b) s[a][b] = __fmaf_rn(av[a], bv[b], s[a][b]);
  };

  const int stages = (R + RB - 1) / RB;
  // ACC: band_in's values past the ring (and, for a round, their mirrors
  // after them; else in the ring slot the last stage leaves free)
  [[maybe_unused]] float* acc_up = smem + ST * STAGE;
  [[maybe_unused]] float* acc_mirror =
      ROUND ? acc_up + TT * TT : smem + stages % ST * STAGE;
#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (st < stages) stage(st);
    if constexpr (ACC) {
      if (st == 0) {
        acc_prefetch(acc_up, band_in, i0, j0, p, h, false);
        if (ROUND) acc_prefetch(acc_mirror, band_in, i0, j0, p, h, true);
      }
    }
    cp_async_commit();
  }
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<ST - 2>();
    if constexpr (STAGED) apply_mask(st);
    if constexpr (WIDE) {
      if (vec) widen(st);
    }
    __syncthreads();   // stage st landed; stage st - 1's slot is free
    if (st + ST - 1 < stages) stage(st + ST - 1);
    if constexpr (ACC && !ROUND) {
      if (st == stages - 1)
        acc_prefetch(acc_mirror, band_in, i0, j0, p, h, true);
    }
    cp_async_commit();
    if (!active) continue;
    const float* ar = smem + (st % ST) * STAGE + ri;
    const float* br = smem + (st % ST) * STAGE + (diag ? 0 : BUF) + cj;
    const int r0 = st * RB, rows = min(RB, R - r0);
    if (rows == RB && flush_end - r0 >= RB) {   // a whole stage, one segment
      const bool ends = flush_end == r0 + RB;
      if (ends && !MASK_AT_FLUSH) load_mask();
#pragma unroll
      for (int q = 0; q < RB; ++q) row(ar + q * TT, br + q * TT);
      if (ends) {
        if (MASK_AT_FLUSH) load_mask();
        flush();
      }
    } else {
      for (int q = 0; q < rows;) {
        const int seg = min(rows, flush_end - r0);
        for (; q < seg; ++q) row(ar + q * TT, br + q * TT);
        if (q == flush_end - r0) {
          load_mask();
          flush();
        }
      }
    }
  }

  // the tile's sums through shared memory, out along wrapped diagonals
  cp_async_wait<0>();
  __syncthreads();     // every stage consumed: the ring is free
  // (T, T); ACC: in the last stage's slot, beside the mirrors
  float* cs = smem + (ACC && !ROUND ? (stages - 1) % ST * STAGE : 0);
  float(&out)[RM][CM] = ROUND ? s : acc;
  if (active) {
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int b = 0; b < CM; b += 4)
        *reinterpret_cast<float4*>(cs + (ri + a) * TT + cj + b) =
            make_float4(out[a][b], out[a][b + 1], out[a][b + 2],
                        out[a][b + 3]);
  }
  if constexpr (ACC) {
    band_tile_accumulate(cs, acc_up, acc_mirror, band_in, band, i0, j0, diag,
                         p, h);
    return;
  }
  __syncthreads();
  if constexpr (ROUND) {
    // thread: row ii, entries jj = (ii + tid / T + k NT / T) mod T, the
    // pair in the band iff lo <= jj <= hi; d = base + jj - ii, so
    // band[h + d, i] and band[h - d, j] lie at od + jj p and om + jj (1 - p)
    const int ii = tid % TT, base = j0 - i0;
    const int lo = max(0, ii - base);
    const int hi = min(min(TT - 1, ii - base + h), p - 1 - j0);
    const float* crow = cs + ii * TT;
    const ptrdiff_t od = (ptrdiff_t)(h + base - ii) * p + i0 + ii;
    const ptrdiff_t om = (ptrdiff_t)(h - base + ii) * p + j0;
    const int first = ii + tid / TT;
#pragma unroll
    for (int k = 0; k < TT * TT / NT; ++k) {
      const int jj = (first + k * (NT / TT)) & (TT - 1);
      if (jj < lo || jj > hi) continue;
      const float v = crow[jj];
      band[od + (ptrdiff_t)jj * p] = v;
      if (jj + base > ii) band[om + (ptrdiff_t)jj * (1 - p)] = v;
    }
  } else {
    for (int f = tid; f < TT * TT; f += NT) {
      const int ii = f % TT, jj = (ii + f / TT) % TT;
      const int i = i0 + ii, j = j0 + jj, d = j - i;
      if (d < 0 || d > h || j >= p) continue;
      const float v = cs[ii * TT + jj];
      band[(size_t)(h + d) * p + i] = v;
      if (d > 0) band[(size_t)(h - d) * p + j] = v;
    }
  }
  // the zeros of the tile's rows: band[h - d, i] for i < d, band[h + d, i]
  // for i + d >= p (1 <= d <= h)
  if (diag && (i0 < h || min(i0 + TT, p) - 1 + h >= p)) {
    for (int f = tid; f < h * TT; f += NT) {
      const int d = 1 + f / TT, i = i0 + f % TT;
      if (i >= p) continue;
      if (i < d) band[(size_t)(h - d) * p + i] = 0.0f;
      if (i + d >= p) band[(size_t)(h + d) * p + i] = 0.0f;
    }
  }
}

}  // namespace repro_torch
