// Tensor-core building blocks of the flash kernels' bf16 bodies (sm_80+
// instructions, run here on sm_90a): cp.async copies into shared memory,
// ldmatrix fragment loads and the m16n8k16 bf16 mma.sync with f32
// accumulators.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), lane =
// 4 * g + t with g = lane / 4 and t = lane % 4:
//   A 16x16 (row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..2t+1),
//                        a[2] = (g, 2t+8..2t+9), a[3] = (g+8, 2t+8..2t+9)
//   B 16x8 (k x n):      b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8..2t+9, n g)
//   C 16x8 (f32):        c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1)
// Each 32-bit register holds two bf16, the lower index in the low half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !ok (src is
// then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a * b on the tensor cores: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even) in one register, lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Address of lane `lane`'s row for an ldsm_x4 of the A fragment covering
// rows r0..r0+15, columns c0..c0+15 of a row-major tile with pitch ld
// (elements): matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15) give a[0..3].
__device__ __forceinline__ const __nv_bfloat16* a_frag_row(
    const __nv_bfloat16* tile, int ld, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}

// Address for an ldsm_x4 of two B fragments (n tiles n0..n0+7 and
// n0+8..n0+15, k = c0..c0+15) read from a row-major tile whose rows are
// n (the "col" operand, e.g. K for Q K^T): r[0], r[1] are b[0], b[1] of
// n tile 0 and r[2], r[3] those of n tile 1.
__device__ __forceinline__ const __nv_bfloat16* b_frag_row(
    const __nv_bfloat16* tile, int ld, int n0, int c0, int lane) {
  return tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + c0 +
         ((lane >> 3) & 1) * 8;
}

// Address for an ldsm_x4_t of two B fragments (k = k0..k0+15, n tiles
// c0..c0+7 and c0+8..c0+15) read from a row-major tile whose rows are k
// (e.g. V for P V): r[0], r[1] are b[0], b[1] of n tile 0 and r[2], r[3]
// those of n tile 1.
__device__ __forceinline__ const __nv_bfloat16* bt_frag_row(
    const __nv_bfloat16* tile, int ld, int k0, int c0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 +
         (lane >> 4) * 8;
}

// The A fragment of a 16x16 product operand from two C fragments of f32
// accumulators (n tiles 2kk and 2kk+1 of a 16-row tile), rounded to bf16:
// the accumulator of one product becomes the operand of the next without
// leaving registers.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A warp's 16 x D f32 accumulator (D/8 C fragments), row g scaled by m0
// and row g+8 by m1, rounded to bf16 and stored at rows row0.. of `dst`
// (a [S, D] view with row stride ss elements, rows >= S dropped). Staged
// through `buf`, the warp's own 16 rows of shared memory (pitch ld), so
// that each global store is 16 bytes. The caller makes sure no other warp
// reads `buf` meanwhile.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           float m0, float m1,
                                           __nv_bfloat16* buf, int ld,
                                           __nv_bfloat16* dst, long long ss,
                                           int row0, int S, int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(buf + g * ld + 8 * j + 2 * t) =
        __floats2bfloat162_rn(acc[j][0] * m0, acc[j][1] * m0);
    *reinterpret_cast<__nv_bfloat162*>(buf + (g + 8) * ld + 8 * j + 2 * t) =
        __floats2bfloat162_rn(acc[j][2] * m1, acc[j][3] * m1);
  }
  __syncwarp();
  constexpr int CH = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * ss + 8 * c) =
          *reinterpret_cast<const uint4*>(buf + r * ld + 8 * c);
  }
}

}  // namespace ptt
