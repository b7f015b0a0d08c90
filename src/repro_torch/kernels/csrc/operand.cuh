// Operand widening for kernel 1's two tile modes: an element of x or of
// the basis is fp32 or — the bf16 tile mode — bf16, returned as fp32.  For
// fp32 it is the value itself; for bf16 the widening is exact (the 16 bits
// become the high half of the fp32 word), so every product and sum after
// it is fp32 arithmetic.  Used by the fold tile (band_syrk.cuh) and the
// stage tile (stage_tile.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Two bf16 values held in one 32-bit word (the first in the low half, as
// they lie in memory), widened exactly.
__device__ __forceinline__ float2 widen2(unsigned v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// The 8 bf16 values of a 16-byte chunk, widened exactly: values 0-3 in lo,
// 4-7 in hi.
__device__ __forceinline__ void widen8(const uint4& v, float4& lo,
                                       float4& hi) {
  const float2 a = widen2(v.x), b = widen2(v.y), c = widen2(v.z),
               d = widen2(v.w);
  lo = make_float4(a.x, a.y, b.x, b.y);
  hi = make_float4(c.x, c.y, d.x, d.y);
}

}  // namespace repro_torch
