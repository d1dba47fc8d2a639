// Single-token decode attention over a contiguous KV cache, for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of paddle_tpu/ops/pallas/decode_attention.py that
// compute one function on two layouts:
//   #14 `decode_attention_pallas` (body `_decode_kernel`): k/v caches
//       [B, Hkv, S, D], the reference's [2, B, Hkv, S, D] split in two;
//   #15 `_slab_pallas` (body `_slab_kernel`): the kv slab
//       [2, B, S, Hkv * D] that GenerationMixin's caches use.
// One entry point takes K/V base pointers and element strides for
// (b, kv head, position); the wrapper passes the 5-D cache's or the slab's.
//
// out[b, h] = softmax(q[b, h] . K[b, h / group, :len_b] * scale) .
// V[b, h / group, :len_b], len_b = min(lengths[b], S); the Pallas kernels'
// full-S softmax with an `ids < len` mask, as an online softmax over the
// live rows only. A sequence of length 0 gives exact zeros (the Pallas
// kernels give the mean of V there: no caller passes 0).
//
// The body (decode_kernel.cuh, shared with #1 and #4) is bound by the bytes
// of the live K/V rows; it reads no row past len_b and shares each K/V row
// across the q heads of its GQA group.

#include "decode_kernel.cuh"

using namespace ptt;
using namespace ptt::decode;

// q [B, H, D] at strides (q_sb, q_sh, 1), f32 or bf16; k and v caches of
// q's dtype, row (b, kvh, s) at k + b * sb + kvh * sh + s * ss (unit stride
// over D); lengths [B] i32; out [B, H, D] of q's dtype, contiguous. Returns
// the cudaError_t of the launch.
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int H, int Hkv, int D, int max_seq, long long q_sb,
    long long q_sh, long long sb, long long sh, long long ss, int q_dtype,
    int kv_dtype, float scale, void* stream) {
  if (max_seq <= 0 || q_dtype != kv_dtype) return cudaErrorInvalidValue;
  const StridedCache rows{static_cast<const int*>(lengths), sb, sh, ss,
                          max_seq};
  const Args a{q, q_sb, q_sh, k, v, out, B, H, Hkv, scale,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == kBF16) return launch<__nv_bfloat16, __nv_bfloat16>(D, a, rows);
  if (q_dtype == kF32) return launch<float, float>(D, a, rows);
  return cudaErrorInvalidValue;
}
