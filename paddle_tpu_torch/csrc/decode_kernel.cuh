// One single-token decode attention body for Hopper (sm_90a), shared by the
// port's four decode kernels. They compute one function over four K/V
// layouts:
//
//   #1  paged_decode_attention.cu     slab pages [P, page_size, Hkv * D],
//                                     bf16 scale pages (int8)
//   #4  paged_decode_attention_v1.cu  head-major pages [Hkv, P, page_size, D],
//                                     f32 scales [Hkv, P, page_size] (int8)
//   #14 decode_attention.cu           a contiguous cache [B, Hkv, S, D]
//   #15 decode_attention.cu           the kv slab [2, B, S, Hkv * D]
//
// What it computes: out[b, h] = softmax(q[b, h] . K[b, :len_b, h / group]
// * scale) . V[b, :len_b, h / group] in f32, group = H / Hkv. A layout is a
// "row source" (below) that clamps len_b and says where row t of (b, kv
// head) lives. A sequence of length 0 gives exact zeros (the max(l, 1e-37)
// guard of the Pallas kernels, applied to every layout).
//
// What bounds it on the H100: the bytes of the live K/V rows (2 * len * D
// elements per kv head, each read once) against ~4 * group * len * D flops:
// a few flops a byte, far below the ~295 the card needs before compute
// matters. So it is bound by memory.
//
// What the design does about that: one block per (sequence, kv head, chunk
// of GC q heads of its GQA group), 256 threads; GC is 4, 2 or 1, the
// largest that divides the group, so the group's q heads share each K/V row
// the block loads (a group larger than 4 is split over gridDim.z). The
// block reads only its sequence's live rows (a paged layout loads its own
// block-table entries: there is no scalar prefetch). Threads read K/V rows
// with 16-byte loads, neighbouring threads on neighbouring lanes of a row
// (a 128-wide bf16 head row is 16 threads); the block runs 256 / (threads
// per row) independent token streams, each with its own online softmax per
// q head in f32, and every stream keeps a few rows of K and V in flight
// before it computes on them. The streams merge in shared memory at the
// end. Not done yet (later work): split-K over long sequences when
// B * Hkv is small, TMA.
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace ptt {
namespace decode {

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

// Where a row lives. `off` is the element offset of row t of (b, kv head)
// from the K (and, the same, the V) base pointer; `tok` indexes the scales
// of an int8 layout.
struct Loc {
  size_t off;
  size_t tok;
};

// Row source of #1: slab pages [P, page_size, Hkv * D] through block tables
// [B, max_pages]; int8 scales in bf16 scale pages [P, page_size, 128] (k at
// lane kvh, v at lane Hkv + kvh).
struct SlabPages {
  const int* __restrict__ block_tables;
  const int* __restrict__ lengths;
  const __nv_bfloat16* __restrict__ scale_pages;
  int page_size, max_pages, Hkv, D;

  __device__ __forceinline__ int length(int b) const {
    const int cap = max_pages * page_size;
    const int n = lengths[b];
    return n < 0 ? 0 : (n > cap ? cap : n);
  }
  __device__ __forceinline__ Loc locate(int b, int kvh, int t) const {
    const int page = block_tables[static_cast<size_t>(b) * max_pages
                                  + t / page_size];
    const size_t tok = static_cast<size_t>(page) * page_size + t % page_size;
    return {tok * static_cast<size_t>(Hkv) * D + static_cast<size_t>(kvh) * D,
            tok};
  }
  __device__ __forceinline__ void scales(int kvh, const Loc& at, float& ks,
                                         float& vs) const {
    const __nv_bfloat16* row = scale_pages + at.tok * 128;
    ks = to_f(row[kvh]);
    vs = to_f(row[Hkv + kvh]);
  }
};

// Row source of #4: head-major pages [Hkv, P, page_size, D] (a kv head's
// rows of one page are contiguous) through block tables [B, max_pages];
// int8 scales f32 [Hkv, P, page_size], one per row.
struct HeadMajorPages {
  const int* __restrict__ block_tables;
  const int* __restrict__ lengths;
  const float* __restrict__ k_scales;
  const float* __restrict__ v_scales;
  int page_size, max_pages, num_pages, D;

  __device__ __forceinline__ int length(int b) const {
    const int cap = max_pages * page_size;
    const int n = lengths[b];
    return n < 0 ? 0 : (n > cap ? cap : n);
  }
  __device__ __forceinline__ Loc locate(int b, int kvh, int t) const {
    const int page = block_tables[static_cast<size_t>(b) * max_pages
                                  + t / page_size];
    const size_t tok = (static_cast<size_t>(kvh) * num_pages + page)
                       * page_size + t % page_size;
    return {tok * D, tok};
  }
  __device__ __forceinline__ void scales(int, const Loc& at, float& ks,
                                         float& vs) const {
    ks = k_scales[at.tok];
    vs = v_scales[at.tok];
  }
};

// Row source of #14 and #15: a contiguous cache with element strides for
// (b, kv head, position) and a unit stride over D. [B, Hkv, S, D] has
// strides (Hkv*S*D, S*D, D); the slab's K half [B, S, Hkv*D] seen as
// [B, Hkv, S, D] has (S*Hkv*D, D, Hkv*D). No int8 form.
struct StridedCache {
  const int* __restrict__ lengths;
  long long sb, sh, ss;
  int max_seq;

  __device__ __forceinline__ int length(int b) const {
    const int n = lengths[b];
    return n < 0 ? 0 : (n > max_seq ? max_seq : n);
  }
  __device__ __forceinline__ Loc locate(int b, int kvh, int t) const {
    return {static_cast<size_t>(b * sb + kvh * sh + t * ss), 0};
  }
  __device__ __forceinline__ void scales(int, const Loc&, float& ks,
                                         float& vs) const {
    ks = vs = 1.f;
  }
};

// q row (b, h) at q + b * q_sb + h * q_sh (unit stride over D); out is
// contiguous [B, H, D].
template <typename TQ, typename TKV, int D, int GC, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, long long q_sb, long long q_sh,
              const TKV* __restrict__ kp, const TKV* __restrict__ vp,
              Rows rows, TQ* __restrict__ out, int H, int Hkv, float scale) {
  using G = Geometry<TKV, D, GC>;
  constexpr int V = G::V, E = G::E, TPR = G::TPR, NS = G::NS, U = G::U;
  constexpr bool quant = std::is_same<TKV, int8_t>::value;
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
  const int len = rows.length(b);

  float qv[GC][E];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const TQ* qrow = q + b * q_sb + (h0 + g) * q_sh + d0;
#pragma unroll
    for (int e = 0; e < E; ++e) qv[g][e] = to_f(qrow[e]);
  }

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
        const Loc at = rows.locate(b, kvh, t);
        const size_t off = at.off + d0;
#pragma unroll
        for (int c = 0; c < E; c += V) {
          load16(kp + off + c, kf[u] + c);
          load16(vp + off + c, vf[u] + c);
        }
        if constexpr (quant) rows.scales(kvh, at, ks[u], vs[u]);
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

// The launch: grid (B, Hkv, group / GC). Returns the launch's cudaError_t.
struct Args {
  const void* q;
  long long q_sb, q_sh;
  const void* k;
  const void* v;
  void* out;
  int B, H, Hkv;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int GC, typename Rows>
cudaError_t launch_g(const Args& a, const Rows& rows) {
  if constexpr (!Geometry<TKV, D, GC>::ok) {
    return cudaErrorInvalidValue;
  } else {
    dim3 grid(a.B, a.Hkv, a.H / a.Hkv / GC);
    decode_kernel<TQ, TKV, D, GC, Rows><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const TQ*>(a.q), a.q_sb, a.q_sh,
        static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v), rows,
        static_cast<TQ*>(a.out), a.H, a.Hkv, a.scale);
    return cudaGetLastError();
  }
}

template <typename TQ, typename TKV, int D, typename Rows>
cudaError_t launch_d(const Args& a, const Rows& rows) {
  const int group = a.H / a.Hkv;
  if (group % 4 == 0) return launch_g<TQ, TKV, D, 4>(a, rows);
  if (group % 2 == 0) return launch_g<TQ, TKV, D, 2>(a, rows);
  return launch_g<TQ, TKV, D, 1>(a, rows);
}

// Dispatch on the head dim (32, 64, 128 or 256).
template <typename TQ, typename TKV, typename Rows>
cudaError_t launch(int D, const Args& a, const Rows& rows) {
  if (a.B <= 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 ||
      a.Hkv > 65535 || a.H / a.Hkv > 65535)
    return cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return launch_d<TQ, TKV, 32>(a, rows);
    case 64:
      return launch_d<TQ, TKV, 64>(a, rows);
    case 128:
      return launch_d<TQ, TKV, 128>(a, rows);
    case 256:
      return launch_d<TQ, TKV, 256>(a, rows);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace decode
}  // namespace ptt
