// Paged multi-query attention with a per-row base (spec verify, prefix-cache
// suffix prefill, chunked prefill), for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `paged_verify_slab_attention` (body `_paged_verify_slab_kernel`).
//
// What it computes: q [B, m, H, D] (f32 or bf16, any strides with a
// contiguous last dim) against slab pages [P, page_size, Hkv * D] of q's
// dtype, or int8 with per-token-per-head bf16 scales in a [P, page_size,
// 128] scale page (k scale at lane kvh, v scale at lane Hkv + kvh). Token t
// of row b lives in physical page block_tables[b, t / page_size], slab row
// t % page_size. Query j of row b attends the tokens
// t < min(base_len[b] + j + 1, max_pages * page_size); q head h reads kv
// head h / (H / Hkv). out [B, m, H, D] is f32. The limit is never below 1,
// so no query is ever fully masked: pad columns and idle rows read whatever
// the table and the trash page hold, deterministically.
//
// What bounds it on the H100: each live K/V row is read once per kv head,
// 2 * min(base + m, cap) * Hkv * D * sizeof(kv) bytes per row, plus the f32
// output, against 4 * H * D * sum_j min(base + j + 1, cap) flops. At the
// card's peaks that is bound by bytes at every width the engine uses: a few
// flops per byte at spec-verify widths (m = 5), and at chunked and suffix
// widths (m = 256, 512) the f32 output and the windows still take longer to
// move than the flops take on the bf16 tensor cores. This first version
// does its products with f32 FMAs out of shared memory (no tensor cores, no
// TMA, no split-K yet), so at wide m the FMA rate limits it: right and
// simple first.
//
// What the design does: the TPU kernel DMA-gathers a row's whole window
// into VMEM and builds an [m, seq] score slab per head; a 4096-token
// llama2_7b window is 32 MB of K+V a row, far past any on-chip memory. So
// this is the flash tile loop instead (as csrc/flash_attention_fwd.cu):
//   * grid (q tiles, B, Hkv * head chunks). A block serves G q heads of one
//     GQA group (G the largest power of two up to 16 dividing the group) at
//     BQ / G query positions, so each K/V tile it loads serves all G heads;
//     BQ (16, 32 or 64 score rows) is the smallest that holds m * G, so a
//     5-wide verify block does not pay for 64 rows.
//   * the K/V tile loader walks the block table: 64 tokens a tile, each
//     token's slab row looked up once per tile into shared memory, then
//     16-byte loads with neighbouring threads on neighbouring lanes. int8
//     pages are dequantised in the loader (value * scale in f32, the plain
//     version's order). Block-table entries at or past max_pages are never
//     read: keys stop at the tile's largest limit, which is clamped at the
//     capacity.
//   * the causal mask is offset by the row's base and clamped at the
//     capacity; the tile loop ends at the last live key of its last query.
//   * f32 online softmax; P stays f32 (the plain version normalises in f32
//     before P.V, so nothing is rounded to the input dtype).

#include <math.h>

#include "common.cuh"

namespace {

using namespace ptt;

constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block

template <int BQ, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * D + static_cast<size_t>(BK) * (D + 1) +
          static_cast<size_t>(BK) * D + static_cast<size_t>(BQ) * (BK + 1));
}

template <typename TQ, typename TKV, int D, int BQ>
__global__ void __launch_bounds__(NT)
paged_verify_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp,
                    const __nv_bfloat16* __restrict__ sp,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ base_len, float* __restrict__ out,
                    int m, int H, int Hkv, int G, int page_size,
                    int max_pages, long long qsb, long long qss,
                    long long qsh, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;               // [BQ][D]
  float* sK = sQ + BQ * D;        // [BK][D + 1]
  float* sV = sK + BK * (D + 1);  // [BK][D]
  float* sS = sV + BK * D;        // [BQ][BK + 1]
  __shared__ long long sTok[BK];  // slab row of each key of the tile, or -1
  __shared__ float sKs[BK];       // k / v dequant scales (1 when not int8)
  __shared__ float sVs[BK];

  constexpr int RQ = BQ / 16;   // score rows per thread
  constexpr int TPR = NT / BQ;  // threads per query row (softmax, P.V)
  constexpr int DP = D / TPR;   // accumulator lanes per thread
  constexpr int VEC = 16 / static_cast<int>(sizeof(TKV));  // per load
  constexpr int CPR = D / VEC;  // 16-byte chunks per K/V row

  const int npos = BQ / G;  // query positions per tile
  const int group = H / Hkv;
  const int chunks = group / G;
  const int b = blockIdx.y;
  const int kvh = blockIdx.z / chunks;
  const int h0 = kvh * group + (blockIdx.z % chunks) * G;
  const int j0 = blockIdx.x * npos;
  const int tid = threadIdx.x;
  const int cap = max_pages * page_size;
  const int base = max(base_len[b], 0);
  const bool quant = sp != nullptr;
  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const int* bt = block_tables + static_cast<size_t>(b) * max_pages;

  // key limit of score row r (a pad row past m sees token 0 only)
  auto limit_of = [&](int r) {
    const int j = j0 + r / G;
    return j < m ? min(base + j + 1, cap) : 1;
  };
  const int lim_max = min(base + min(j0 + npos, m), cap);

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int j = j0 + r / G;
    const int h = h0 + r % G;
    sQ[i] = j < m ? to_f(q[b * qsb + j * qss + h * qsh + c]) : 0.f;
  }

  // score-tile mapping: rows ty*RQ .. ty*RQ+RQ-1, cols tx + 16*jj
  const int ty = tid >> 4, tx = tid & 15;
  // softmax / accumulator mapping: row `row`, lanes part + TPR*c
  const int row = tid / TPR, part = tid % TPR;
  float o[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) o[c] = 0.f;
  float m_i = -INFINITY, l_i = 0.f;

  const int n_kt = (lim_max + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // last tile's readers of sK / sV / sS / sTok are done
    if (tid < BK) {
      const int t = k0 + tid;
      long long tok = -1;
      float ks = 1.f, vs = 1.f;
      if (t < lim_max) {  // t < cap, so t / page_size < max_pages
        tok = static_cast<long long>(bt[t / page_size]) * page_size +
              t % page_size;
        if (quant) {
          const __nv_bfloat16* srow = sp + tok * 128;
          ks = to_f(srow[kvh]);
          vs = to_f(srow[Hkv + kvh]);
        }
      }
      sTok[tid] = tok;
      sKs[tid] = ks;
      sVs[tid] = vs;
    }
    __syncthreads();
    for (int i = tid; i < BK * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * VEC;
      const long long tok = sTok[r];
      float kf[VEC], vf[VEC];
      if (tok >= 0) {
        const size_t off = static_cast<size_t>(tok) * row_stride +
                           static_cast<size_t>(kvh) * D + c;
        load16(kp + off, kf);
        load16(vp + off, vf);
        const float ks = sKs[r], vs = sVs[r];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          kf[e] *= ks;
          vf[e] *= vs;
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sK[r * (D + 1) + c + e] = kf[e];
        sV[r * D + c + e] = vf[e];
      }
    }
    __syncthreads();

    float acc[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RQ], bk[4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = sQ[(ty * RQ + i) * D + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bk[jj] = sK[(tx + 16 * jj) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] += a[i] * bk[jj];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      const int lim = limit_of(r);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        sS[r * (BK + 1) + c] = k0 + c < lim ? acc[i][jj] * scale : -INFINITY;
      }
    }
    __syncthreads();

    float* srow = sS + row * (BK + 1);
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < BK / TPR; ++jj)
      mx = fmaxf(mx, srow[part + TPR * jj]);
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_i, mx);
    const bool dead = m_new == -INFINITY;  // every key so far masked
    const float alpha = dead ? 1.f : expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK / TPR; ++jj) {
      const int c = part + TPR * jj;
      const float s = srow[c];
      const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
      psum += p;
      srow[c] = p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    __syncwarp();  // the row's TPR threads share one warp

#pragma unroll
    for (int c = 0; c < DP; ++c) o[c] *= alpha;
    const int live = min(BK, lim_max - k0);  // keys past it are all masked
    for (int j = 0; j < live; ++j) {
      const float p = srow[j];
      const float* vr = sV + j * D + part;
#pragma unroll
      for (int c = 0; c < DP; ++c) o[c] += p * vr[TPR * c];
    }
  }

  const int j = j0 + row / G;
  if (j < m) {
    const int h = h0 + row % G;
    const float inv = 1.f / fmaxf(l_i, 1e-37f);
    float* orow = out + ((static_cast<size_t>(b) * m + j) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DP; ++c) orow[part + TPR * c] = o[c] * inv;
  }
}

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const void* sp;
  const int* bt;
  const int* base;
  float* out;
  int B, m, H, Hkv, G, ps, mp;
  long long qsb, qss, qsh;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int BQ>
cudaError_t launch_bq(const Args& a) {
  constexpr size_t smem = smem_bytes<BQ, D>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_verify_kernel<TQ, TKV, D, BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int npos = BQ / a.G;
  dim3 grid((a.m + npos - 1) / npos, a.B, a.Hkv * (a.H / a.Hkv / a.G));
  paged_verify_kernel<TQ, TKV, D, BQ><<<grid, NT, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp),
      static_cast<const __nv_bfloat16*>(a.sp), a.bt, a.base, a.out, a.m,
      a.H, a.Hkv, a.G, a.ps, a.mp, a.qsb, a.qss, a.qsh, a.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_d(const Args& a) {
  const long long rows = static_cast<long long>(a.m) * a.G;
  if (rows <= 16) return launch_bq<TQ, TKV, D, 16>(a);
  if (rows <= 32) return launch_bq<TQ, TKV, D, 32>(a);
  return launch_bq<TQ, TKV, D, 64>(a);
}

template <typename TQ, typename TKV>
cudaError_t launch_t(int D, const Args& a) {
  switch (D) {
    case 64:
      return launch_d<TQ, TKV, 64>(a);
    case 128:
      return launch_d<TQ, TKV, 128>(a);
    case 256:
      return launch_d<TQ, TKV, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, m, H, D] (f32 or bf16) with element strides (batch, position, head)
// and a contiguous last dim; pages [P, page_size, Hkv * D] of q's dtype, or
// int8 with scale_pages [P, page_size, 128] bf16; block_tables [B,
// max_pages] i32; base_len [B] i32; out [B, m, H, D] f32 contiguous.
// Returns the cudaError_t of the launch.
extern "C" int paged_verify_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* scale_pages, const void* block_tables, const void* base_len,
    void* out, int B, int m, int H, int Hkv, int D, int page_size,
    int max_pages, long long qsb, long long qss, long long qsh, int q_dtype,
    int kv_dtype, float scale, void* stream) {
  if (B <= 0 || m <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      page_size <= 0 || max_pages <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  const bool quant = kv_dtype == kI8;
  if (quant != (scale_pages != nullptr)) return cudaErrorInvalidValue;
  const int group = H / Hkv;
  int G = 1;
  while (G < 16 && group % (2 * G) == 0) G *= 2;
  if (static_cast<long long>(Hkv) * (group / G) > 65535)
    return cudaErrorInvalidValue;
  Args a{q, k_pages, v_pages, scale_pages,
         static_cast<const int*>(block_tables),
         static_cast<const int*>(base_len), static_cast<float*>(out),
         B, m, H, Hkv, G, page_size, max_pages, qsb, qss, qsh, scale,
         static_cast<cudaStream_t>(stream)};
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_t<__nv_bfloat16, __nv_bfloat16>(D, a);
  if (q_dtype == kF32 && kv_dtype == kF32) return launch_t<float, float>(D, a);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch_t<__nv_bfloat16, int8_t>(D, a);
  if (q_dtype == kF32 && kv_dtype == kI8) return launch_t<float, int8_t>(D, a);
  return cudaErrorInvalidValue;
}
