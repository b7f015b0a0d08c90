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
// i + k - h outside [0, p) adds nothing: its diagonals are left out of the
// loop instead of padding V.
//
// The product (q > 1): a block owns kRows consecutive rows i of one slot
// and a tile of CT columns; a thread owns one row and the CT columns in
// registers.  The diagonals go in windows of kDiag: the V rows the window
// reaches, kRows + kDiag - 1 of them, are staged in shared memory, and a
// thread reads its V row for diagonal k there as CT/4 float4 loads (rows
// padded so that eight consecutive rows hit distinct banks), and its band
// entry band[k, i] from global memory, coalesced across the warp's rows.
// So each V element comes from device memory about twice per block, not
// 2h+1 times per output.  The matvec (q = 1) keeps one thread per output
// with lanes over i: both of its loads are coalesced.
//
// Bound at the refresh's shape (S=256 slots, p=1024, h=128, q=32): the
// in-range band entries (2h+1)p - h(h+1) = 246,656 per slot, one
// multiply and one add each per column, 2*S*q*246,656 = 4.04 GFLOP
// (0.060 ms at 67 TFLOP/s fp32) against the in-range band 252.6 MB + V
// 33.5 MB read and Y 33.5 MB written (0.095 ms at 3.35 TB/s): bound by
// bytes.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kBandedThreads = 256;   // the matvec: one output a thread
constexpr int kRows = 128;            // the product: rows i per block
constexpr int kDiag = 128;            // diagonals per shared V window

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

template <int CT>
__global__ void __launch_bounds__(kRows)
banded_matmul_kernel(const float* __restrict__ band,
                     const float* __restrict__ V, int p, int h, int q,
                     float* __restrict__ Y) {
  // V window rows in shared memory are LD floats apart: CT + 4 keeps the
  // float4 loads of eight consecutive rows on distinct banks (CT = 4 is
  // already conflict-free unpadded).
  constexpr int LD = CT == 4 ? 4 : CT + 4;
  constexpr int kWin = kRows + kDiag - 1;
  __shared__ __align__(16) float win[kWin * LD];
  const size_t s = blockIdx.y;
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * kRows, i = i0 + t;
  const int c0 = blockIdx.z * CT;
  const int nb = 2 * h + 1;
  const float* bs = band + s * nb * p;
  const float* vs = V + s * p * q;
  // the diagonals whose V row i + k - h lies in [0, p); none past row p
  const int klo = max(0, h - i);
  const int khi = i < p ? min(nb - 1, p - 1 - i + h) : -1;
  float acc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) acc[c] = 0.0f;
  for (int k0 = 0; k0 < nb; k0 += kDiag) {
    // window row r holds V row i0 + k0 - h + r: row i's diagonal k is
    // window row t + k - k0
    const int j0 = i0 + k0 - h;
    __syncthreads();
    for (int e = t; e < kWin * CT; e += kRows) {
      const int r = e / CT, c = e - r * CT, j = j0 + r, col = c0 + c;
      win[r * LD + c] = (j >= 0 && j < p && col < q)
                            ? vs[(size_t)j * q + col] : 0.0f;
    }
    __syncthreads();
    const int ka = max(k0, klo), kb = min(k0 + kDiag - 1, khi);
    for (int k = ka; k <= kb; ++k) {
      const float b = bs[(size_t)k * p + i];
      const float4* row =
          reinterpret_cast<const float4*>(win + (t + k - k0) * LD);
#pragma unroll
      for (int c4 = 0; c4 < CT / 4; ++c4) {
        const float4 v = row[c4];
        acc[4 * c4 + 0] = __fadd_rn(acc[4 * c4 + 0], __fmul_rn(b, v.x));
        acc[4 * c4 + 1] = __fadd_rn(acc[4 * c4 + 1], __fmul_rn(b, v.y));
        acc[4 * c4 + 2] = __fadd_rn(acc[4 * c4 + 2], __fmul_rn(b, v.z));
        acc[4 * c4 + 3] = __fadd_rn(acc[4 * c4 + 3], __fmul_rn(b, v.w));
      }
    }
  }
  if (i >= p) return;
  float* ys = Y + (s * p + i) * q;
#pragma unroll
  for (int c = 0; c < CT; ++c)
    if (c0 + c < q) ys[c0 + c] = acc[c];
}

template <int CT>
static int launch_matmul(const float* band, const float* V, int S, int p,
                         int h, int q, float* Y, cudaStream_t stream) {
  dim3 grid((p + kRows - 1) / kRows, S, (q + CT - 1) / CT);
  banded_matmul_kernel<CT><<<grid, kRows, 0, stream>>>(band, V, p, h, q, Y);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" {

// Kernel 10: band (S, 2h+1, p), V (S, p, q), Y (S, p, q); fp32, contiguous.
// The column tile is the least of 4, 8, 16, 32 that holds q (32 above).
int banded_matmul_f32(const float* band, const float* V, int S, int p, int h,
                      int q, float* Y, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = (cudaStream_t)stream;
  if (q <= 4) return launch_matmul<4>(band, V, S, p, h, q, Y, st);
  if (q <= 8) return launch_matmul<8>(band, V, S, p, h, q, Y, st);
  if (q <= 16) return launch_matmul<16>(band, V, S, p, h, q, Y, st);
  return launch_matmul<32>(band, V, S, p, h, q, Y, st);
}

// Kernel 11: band (S, 2h+1, p), v (S, p), y (S, p).
int banded_matvec_f32(const float* band, const float* v, int S, int p, int h,
                      float* y, void* stream) {
  using namespace repro_torch;
  dim3 grid((p + kBandedThreads - 1) / kBandedThreads, S);
  banded_matvec_kernel<<<grid, kBandedThreads, 0, (cudaStream_t)stream>>>(
      band, v, p, h, y);
  return (int)cudaGetLastError();
}

}  // extern "C"
