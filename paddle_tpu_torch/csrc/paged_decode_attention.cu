// Paged single-token decode attention over slab pages, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `paged_slab_decode_attention` (body `_paged_slab_kernel`).
//
// Token t of sequence b lives in physical page block_tables[b, t /
// page_size], row t % page_size. Pages are slabs [P, page_size, Hkv * D];
// int8 pages carry per-token-per-head bf16 scales in a [P, page_size, 128]
// scale page (k scale at lane kvh, v scale at lane Hkv + kvh). len_b =
// min(lengths[b], max_pages * page_size); a sequence of length 0 gives
// exact zeros, like the Pallas kernel's max(l, 1e-37) guard.
//
// The kernel body, what bounds it (the bytes of the live K/V rows) and what
// its design does about that are in decode_kernel.cuh, which this kernel
// shares with #4 and #14/#15; this file supplies the slab-page row source.

#include "decode_kernel.cuh"

using namespace ptt;
using namespace ptt::decode;

// q [B, H, D] (f32 or bf16); pages [P, page_size, Hkv * D] of q's dtype, or
// int8 with scale_pages [P, page_size, 128] bf16; block_tables [B,
// max_pages] i32; lengths [B] i32; out [B, H, D] of q's dtype. Returns the
// cudaError_t of the launch.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* scale_pages, const void* block_tables, const void* lengths,
    void* out, int B, int H, int Hkv, int D, int page_size, int max_pages,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  const bool quant = kv_dtype == kI8;
  if (quant != (scale_pages != nullptr)) return cudaErrorInvalidValue;
  const SlabPages rows{static_cast<const int*>(block_tables),
                       static_cast<const int*>(lengths),
                       static_cast<const __nv_bfloat16*>(scale_pages),
                       page_size, max_pages, Hkv, D};
  const Args a{q, static_cast<long long>(H) * D, D, k_pages, v_pages, out,
               B, H, Hkv, scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(D, a, rows);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch<float, float>(D, a, rows);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch<__nv_bfloat16, int8_t>(D, a, rows);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return launch<float, int8_t>(D, a, rows);
  return cudaErrorInvalidValue;
}
