// Operand loads shared by the fold (band_fold.cuh) and the stages
// (stages.cuh): an element of x or of the basis, fp32 or — kernel 1's bf16
// tile mode — bf16, returned as fp32.  For fp32 both are the plain load, so
// the fp32 kernels compile to the arithmetic they had before the bf16 mode;
// for bf16 the widening is exact (the 16 bits become the high half of the
// fp32 word), so every product and sum after the load is fp32 arithmetic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Read-only (non-coherent cache) loads, as __ldg, for both operand types.
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

}  // namespace repro_torch
