// Paged single-token decode attention over slab pages, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `paged_slab_decode_attention` (body `_paged_slab_kernel`).
//
// What it computes: out[b, h] = softmax(q[b, h] . K[b, :len_b, h // group]
// * scale) . V[b, :len_b, h // group], where token t of sequence b lives in
// physical page block_tables[b, t / page_size], row t % page_size. Pages are
// slabs [P, page_size, Hkv * D]; int8 pages carry per-token-per-head bf16
// scales in a [P, page_size, 128] scale page (k scale at lane kvh, v scale
// at lane Hkv + kvh). len_b = min(lengths[b], max_pages * page_size); a
// sequence of length 0 gives exact zeros, like the Pallas kernel's
// max(l, 1e-37) guard.
//
// What bounds it on the H100: the bytes of K/V pages read (each live token
// row of a kv head is read once, 2 * len * D * sizeof(kv) bytes), against
// ~4 * group * len * D flops: a few flops per byte, far below the ~295 the
// card needs before compute matters. So it is bound by memory.
//
// What the design does about that: one block per (sequence, kv head, chunk
// of GC q heads of its GQA group), 256 threads; GC is 4, 2 or 1, the
// largest that divides the group, so the group's q heads share each K/V row
// the block loads (a group larger than 4 is split over gridDim.z). The
// block loads its own block-table row (there is no scalar prefetch).
// Threads read K/V rows with 16-byte loads, neighbouring threads on
// neighbouring lanes of a row (a 128-wide bf16 head row is 16 threads);
// the block runs 256 / (threads per row) independent token streams, each
// with its own online softmax per q head in f32, and every stream keeps a
// few rows of K and V in flight before it computes on them. The streams
// merge in shared memory at the end. Only ceil(len / page_size) pages are
// touched. Not done yet (later work): split-K over long sequences when
// B * Hkv is small, TMA.

#include <math.h>

#include "common.cuh"

namespace {

using namespace ptt;

constexpr int kThreads = 256;

template <typename TKV, int D, int GC>
struct Geometry {
  static constexpr int V = 16 / static_cast<int>(sizeof(TKV));  // per load
  // elements per thread: one 16-byte load, or more where a row would
  // otherwise need more than a warp (f32 at D = 256)
  static constexpr int E = (D / 32 > V) ? D / 32 : V;
  static constexpr int TPR = D / E;          // threads per K/V row
  static constexpr bool ok = (D % E == 0) && (E % V == 0) && TPR >= 1 &&
                             TPR <= 32 && (32 % TPR == 0);
  static constexpr int NS = ok ? kThreads / TPR : 1;  // token streams
  // K/V rows in flight per stream: fewer as the per-thread q and
  // accumulator state (2 * GC * E floats) grows, to stay in registers
  static constexpr int U = GC * E >= 64 ? 1 : (GC * E >= 32 ? 2 : 4);
};

template <typename TQ, typename TKV, int D, int GC>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp,
                    const __nv_bfloat16* __restrict__ sp,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, TQ* __restrict__ out,
                    int H, int Hkv, int page_size, int max_pages,
                    float scale) {
  using G = Geometry<TKV, D, GC>;
  constexpr int V = G::V, E = G::E, TPR = G::TPR, NS = G::NS, U = G::U;
  __shared__ float sm_m[NS];
  __shared__ float sm_l[NS];
  __shared__ float sm_acc[NS][D];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int h0 = kvh * (H / Hkv) + blockIdx.z * GC;  // first q head here
  const int tid = threadIdx.x;
  const int stream = tid / TPR;
  const int part = tid % TPR;
  const int d0 = part * E;

  const int cap = max_pages * page_size;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const bool quant = sp != nullptr;

  float qv[GC][E];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const TQ* qrow = q + (static_cast<size_t>(b) * H + h0 + g) * D + d0;
#pragma unroll
    for (int e = 0; e < E; ++e) qv[g][e] = to_f(qrow[e]);
  }

  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const int* bt = block_tables + static_cast<size_t>(b) * max_pages;
  float m[GC], l[GC], acc[GC][E];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  // every thread runs the same trip count, so the shuffles below always
  // see the full warp
  for (int base = 0; base < len; base += NS * U) {
    float kf[U][E], vf[U][E];
    float ks[U], vs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * NS + stream;
      ks[u] = vs[u] = 1.f;
      if (t < len) {
        const int page = bt[t / page_size];
        const size_t tok = static_cast<size_t>(page) * page_size
                           + t % page_size;
        const size_t off = tok * row_stride + static_cast<size_t>(kvh) * D
                           + d0;
#pragma unroll
        for (int c = 0; c < E; c += V) {
          load16(kp + off + c, kf[u] + c);
          load16(vp + off + c, vf[u] + c);
        }
        if (quant) {
          const __nv_bfloat16* srow = sp + tok * 128;
          ks[u] = to_f(srow[kvh]);
          vs[u] = to_f(srow[Hkv + kvh]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = base + u * NS + stream < len;
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s += qv[g][e] * kf[u][e];
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (live) {
          s = s * ks[u] * scale;
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);  // 0 while m is -inf
          const float p = expf(s - m_new);
          l[g] = l[g] * alpha + p;
          const float pv = p * vs[u];
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[g][e] = acc[g][e] * alpha + pv * vf[u][e];
          m[g] = m_new;
        }
      }
    }
  }

  // merge the streams, one q head at a time through one shared buffer
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (part == 0) {
      sm_m[stream] = m[g];
      sm_l[stream] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[stream][d0 + e] = acc[g][e];
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float mx = -INFINITY;
      for (int s = 0; s < NS; ++s) mx = fmaxf(mx, sm_m[s]);
      float num = 0.f, den = 0.f;
      for (int s = 0; s < NS; ++s) {
        const float ms = sm_m[s];
        const float w = (ms == -INFINITY) ? 0.f : expf(ms - mx);
        num += sm_acc[s][d] * w;
        den += sm_l[s] * w;
      }
      store_f(out + (static_cast<size_t>(b) * H + h0 + g) * D + d,
              num / fmaxf(den, 1e-37f));
    }
    __syncthreads();  // the buffer is refilled for the next q head
  }
}

template <typename TQ, typename TKV, int D, int GC>
cudaError_t launch_g(const void* q, const void* kp, const void* vp,
                     const void* sp, const int* bt, const int* lens,
                     void* out, int B, int H, int Hkv, int ps, int mp,
                     float scale, cudaStream_t st) {
  if constexpr (!Geometry<TKV, D, GC>::ok) {
    return cudaErrorInvalidValue;
  } else {
    dim3 grid(B, Hkv, H / Hkv / GC);
    paged_decode_kernel<TQ, TKV, D, GC><<<grid, kThreads, 0, st>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
        static_cast<const TKV*>(vp),
        static_cast<const __nv_bfloat16*>(sp), bt, lens,
        static_cast<TQ*>(out), H, Hkv, ps, mp, scale);
    return cudaGetLastError();
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_d(const void* q, const void* kp, const void* vp,
                     const void* sp, const int* bt, const int* lens,
                     void* out, int B, int H, int Hkv, int ps, int mp,
                     float scale, cudaStream_t st) {
  const int group = H / Hkv;
  if (group % 4 == 0)
    return launch_g<TQ, TKV, D, 4>(q, kp, vp, sp, bt, lens, out, B, H, Hkv,
                                   ps, mp, scale, st);
  if (group % 2 == 0)
    return launch_g<TQ, TKV, D, 2>(q, kp, vp, sp, bt, lens, out, B, H, Hkv,
                                   ps, mp, scale, st);
  return launch_g<TQ, TKV, D, 1>(q, kp, vp, sp, bt, lens, out, B, H, Hkv,
                                 ps, mp, scale, st);
}

template <typename TQ, typename TKV>
cudaError_t launch_t(int D, const void* q, const void* kp, const void* vp,
                     const void* sp, const int* bt, const int* lens,
                     void* out, int B, int H, int Hkv, int ps, int mp,
                     float scale, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch_d<TQ, TKV, 32>(q, kp, vp, sp, bt, lens, out, B, H, Hkv,
                                   ps, mp, scale, st);
    case 64:
      return launch_d<TQ, TKV, 64>(q, kp, vp, sp, bt, lens, out, B, H, Hkv,
                                   ps, mp, scale, st);
    case 128:
      return launch_d<TQ, TKV, 128>(q, kp, vp, sp, bt, lens, out, B, H,
                                    Hkv, ps, mp, scale, st);
    case 256:
      return launch_d<TQ, TKV, 256>(q, kp, vp, sp, bt, lens, out, B, H,
                                    Hkv, ps, mp, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, H, D] (f32 or bf16); pages [P, page_size, Hkv * D] of q's dtype, or
// int8 with scale_pages [P, page_size, 128] bf16; block_tables [B,
// max_pages] i32; lengths [B] i32; out [B, H, D] of q's dtype. Returns the
// cudaError_t of the launch.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* scale_pages, const void* block_tables, const void* lengths,
    void* out, int B, int H, int Hkv, int D, int page_size, int max_pages,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Hkv > 65535 ||
      H / Hkv > 65535)
    return cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quant = kv_dtype == kI8;
  if (quant != (scale_pages != nullptr)) return cudaErrorInvalidValue;
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_t<__nv_bfloat16, __nv_bfloat16>(
        D, q, k_pages, v_pages, nullptr, bt, lens, out, B, H, Hkv,
        page_size, max_pages, scale, st);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_t<float, float>(D, q, k_pages, v_pages, nullptr, bt, lens,
                                  out, B, H, Hkv, page_size, max_pages,
                                  scale, st);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch_t<__nv_bfloat16, int8_t>(
        D, q, k_pages, v_pages, scale_pages, bt, lens, out, B, H, Hkv,
        page_size, max_pages, scale, st);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return launch_t<float, int8_t>(D, q, k_pages, v_pages, scale_pages, bt,
                                   lens, out, B, H, Hkv, page_size,
                                   max_pages, scale, st);
  return cudaErrorInvalidValue;
}
