// Paged single-token decode attention over head-major pages, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `paged_decode_attention` (body `_paged_kernel`), the decode behind the
// host-managed `PagedKVCache.attend`.
//
// Token t of sequence b lives in physical page block_tables[b, t /
// page_size], row t % page_size. Pages are [Hkv, P, page_size, D]: a kv
// head's rows of one page are contiguous. int8 pages carry one f32 scale per
// row in k_scales / v_scales [Hkv, P, page_size]. len_b = min(lengths[b],
// max_pages * page_size); a sequence of length 0 gives exact zeros (the
// Pallas kernel's guard of fully masked rows).
//
// The TPU kernel runs one program per (b, h, page) and carries its online
// softmax across pages in VMEM scratch. Here one block serves a sequence, a
// kv head and up to four q heads of its GQA group, and walks only the live
// pages of its chunk of the window in a loop: at GPT-2 serving shapes the
// TPU grid would be thousands of tiny programs on 132 SMs. The body
// (decode_kernel.cuh) is the one #1 and #14/#15 run; it is bound by the
// bytes of the live K/V rows.

#include "decode_kernel.cuh"

using namespace ptt;
using namespace ptt::decode;

// q [B, H, D] at strides (q_sb, q_sh, 1), f32 or bf16; pages [Hkv, P,
// page_size, D] of q's dtype, or int8 with k_scales / v_scales f32 [Hkv, P,
// page_size]; block_tables [B, max_pages] i32; lengths [B] i32; out [B, H,
// D] of q's dtype, contiguous. Returns the cudaError_t of the launch.
// splits, min_chunk: each live window is cut into at most splits chunks
// of at least min_chunk rows (decode_kernel.cuh); with splits above one,
// part_o f32 [splits, B, H, D], part_lse f32 [splits, B, H] and counters
// (int32, one per (b, kv head, head chunk), zero on entry, left zero).
extern "C" int paged_decode_attention_v1(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* lengths, void* out, int B, int H, int Hkv, int D,
    int num_pages, int page_size, int max_pages, long long q_sb,
    long long q_sh, int q_dtype, int kv_dtype, float scale, int splits,
    int min_chunk, void* part_o, void* part_lse, void* counters,
    void* stream) {
  const bool quant = kv_dtype == kI8;
  if (quant != (k_scales != nullptr) || quant != (v_scales != nullptr))
    return cudaErrorInvalidValue;
  const HeadMajorPages rows{static_cast<const int*>(block_tables),
                            static_cast<const int*>(lengths),
                            static_cast<const float*>(k_scales),
                            static_cast<const float*>(v_scales),
                            page_size, max_pages, num_pages, D};
  const Args a{q, q_sb, q_sh, k_pages, v_pages, out, B, H, Hkv, scale,
               Split{splits, min_chunk, static_cast<float*>(part_o),
                     static_cast<float*>(part_lse),
                     static_cast<int*>(counters)},
               static_cast<cudaStream_t>(stream)};
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
