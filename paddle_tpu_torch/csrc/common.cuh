// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

// dtype codes shared with the Python wrappers (kernels/build.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// round a float to the precision of T (identity for float)
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

// one 16-byte load of E = 16 / sizeof(T) elements, converted to float
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ p, float* out) {
  constexpr int E = 16 / sizeof(T);
  union {
    uint4 raw;
    T vals[E];
  } u;
  u.raw = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = to_f(u.vals[e]);
}

}  // namespace ptt
