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

// the 16 / sizeof(T) elements of a raw 16-byte chunk, converted to float
// by bit operations alone (no union through local memory): an f32 is its
// bits, a bf16 the high half of the f32 of the same value, an int8 byte
// permuted under the exponent of 2^23 less 2^23 + 128 (exact)
__device__ __forceinline__ void unpack16(const uint4& r, float* out, float) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack16(const uint4& r, float* out,
                                         __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4& r, float* out,
                                         int8_t) {
  const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u,
                         r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] =
          __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 + j)) -
          8388736.f;
}

// The arrival count of a split reduction inside one launch. Each of the
// `expected` blocks of a group writes its partial to device memory, then
// calls this (every thread of the block). It returns true in the one block
// that arrives last, which then reads every partial (through L2: __ldcg)
// in split order, so the sum is the same whichever block arrives last.
// That block also resets the group's counter to 0, so a buffer that
// starts zeroed stays zeroed from one launch to the next and nothing on
// the host reads or clears it.
__device__ __forceinline__ bool last_to_arrive(int* counter, int expected) {
  __shared__ int last;
  __threadfence();  // this block's partials are visible before it counts
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == expected - 1;
    if (last) atomicExch(counter, 0);  // every block of the group is in
  }
  __syncthreads();
  if (last) __threadfence();  // the others' partials before our reads
  return last;
}

}  // namespace ptt
