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
// move than the flops take on the bf16 tensor cores.
//
// What the design does: the TPU kernel DMA-gathers a row's whole window
// into VMEM and builds an [m, seq] score slab per head; a 4096-token
// llama2_7b window is 32 MB of K+V a row, far past any on-chip memory. So
// this is the flash tile loop instead. A block serves G q heads of one GQA
// group (G the largest power of two up to 16 dividing the group) at BQ / G
// query positions, so each K/V tile it loads serves all G heads; BQ (16,
// 32 or 64 score rows) is the smallest that holds m * G, so a 5-wide
// verify block does not pay for 64 rows. The causal mask is offset by the
// row's base and clamped at the capacity; the tile loop ends at the last
// live key of its last query. Block-table entries at or past max_pages are
// never read: keys stop at the block's largest limit, which is clamped at
// the capacity.
//
// Two bodies, chosen by the caller (`verify_body` in
// ops/cuda/paged_attention.py) and checked here:
//
// * the tensor-core body, bf16 q at D 64 and 128 with bf16 or int8 pages
//   (built on the flash forward's mma.sync body, csrc/tensor_core.cuh).
//   Blocks of BQ / 16 warps, each owning 16 score rows. Q is read once
//   with ordinary loads (any strides) into bf16 shared memory and held as
//   m16n8k16 A fragments. K and V stream through a two-stage ring of
//   64-key tiles filled by 16-byte cp.async copies: bf16 pages straight
//   into padded bf16 rows; int8 pages into an int8 ring (with each key's
//   two scale words, 4-byte copies), converted to bf16 in shared memory
//   once the tile has landed (int8 values are exact in bf16; a byte
//   permute and an f32 subtract each, not an int-to-float conversion).
//   The loader still walks the block table, each key's slab row looked
//   up once a tile, and the lookups run two tiles ahead of the copies
//   (the table read of tile t + 3 is in flight while tile t computes), so
//   no copy waits on a table read. S = Q K^T and O += P V run on
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate); the mask, the k scales
//   (each score column times its key's k scale) and the online softmax
//   (log2 domain) work on the S accumulators; P times each key's v scale
//   goes from the accumulators into the A fragments of P V.
//   Rounding points: the reference keeps P in f32 and normalises before
//   P.V; this body rounds the unnormalised P (times the v scale) to bf16,
//   as the flash kernels round P. Every sum stays f32, the output is f32.
// * the FMA body, f32 at every D (its checks are 1e-4, which bf16
//   products would break) and bf16 at D 256: each K/V tile staged as f32
//   in shared memory (int8 dequantised in the loader, value * scale in
//   f32), a 16 x 16 thread grid of f32 FMAs for the scores, P in f32
//   through shared memory (nothing rounded to the input dtype).
//
// Split-K over the window (both bodies): at narrow widths the grid of
// (q tiles x B x head groups) leaves most of the card idle while each
// block walks its row's whole window. The caller then passes `splits`
// chunks of `chunk` keys (a multiple of 64): block c of a row walks keys
// [c * chunk, (c + 1) * chunk) only and writes its partial, o normalised
// over its own keys and the log-sum-exp of its scores (-inf where the
// chunk holds no key of the row), in f32 to scratch; one merge kernel a
// call then weighs the chunks in log space. A chunk that starts past its
// row's limit contributes nothing.

#include <math.h>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using namespace ptt;

constexpr int BK = 64;  // keys per tile

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const __nv_bfloat16* sp;
  const int* bt;
  const int* base;
  float* out;
  float* part_o;    // [splits, B, m, H, D] (splits > 1)
  float* part_lse;  // [splits, B, m, H]
  int B, m, H, Hkv, G, ps, mp;
  long long qsb, qss, qsh;
  float scale;
  int splits, chunk;
  bool q_vec;  // q's base and strides are multiples of 16 bytes
  cudaStream_t stream;
};

// the block's place: q tile, split chunk, row, kv head and first q head
struct Place {
  int j0, b, kvh, h0, kbeg, kend, base, cap;
};

__device__ __forceinline__ Place place_of(int BQ, int m, int H, int Hkv,
                                          int G, int ps, int mp, int splits,
                                          int chunk, const int* base_len) {
  Place p;
  const int qt = blockIdx.x / splits, c = blockIdx.x % splits;
  const int group = H / Hkv, chunks = group / G;
  p.b = blockIdx.y;
  p.kvh = blockIdx.z / chunks;
  p.h0 = p.kvh * group + (blockIdx.z % chunks) * G;
  p.j0 = qt * (BQ / G);
  p.cap = mp * ps;
  p.kbeg = c * chunk;
  p.kend = min(p.kbeg + chunk, p.cap);
  p.base = max(base_len[p.b], 0);
  return p;
}

// where score row (b, j, h)'s D outputs go: the answer (splits == 1) or
// this block's chunk partial, whose lse (the natural log-sum-exp of the
// row's scaled scores over the chunk, -inf when it holds none of the
// row's keys) is stored when `store_lse`
__device__ __forceinline__ float* row_out(float* out, float* part_o,
                                          float* part_lse, int splits, int B,
                                          int m, int H, int D, int b, int j,
                                          int h, float lse, bool store_lse) {
  const size_t row = (static_cast<size_t>(b) * m + j) * H + h;
  if (splits == 1) return out + row * D;
  const size_t rows = static_cast<size_t>(B) * m * H;
  const size_t c = blockIdx.x % splits;
  if (store_lse) part_lse[c * rows + row] = lse;
  return part_o + (c * rows + row) * D;
}

// ------------------------------------------------ the FMA body
namespace body_fma {

constexpr int NT = 256;

template <int BQ, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * D + static_cast<size_t>(BK) * (D + 1) +
          static_cast<size_t>(BK) * D + static_cast<size_t>(BQ) * (BK + 1));
}

template <typename TQ, typename TKV, int D, int BQ>
__global__ void __launch_bounds__(NT)
verify_fma_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                  const TKV* __restrict__ vp,
                  const __nv_bfloat16* __restrict__ sp,
                  const int* __restrict__ block_tables,
                  const int* __restrict__ base_len, float* __restrict__ out,
                  float* __restrict__ part_o, float* __restrict__ part_lse,
                  int B, int m, int H, int Hkv, int G, int page_size,
                  int max_pages, long long qsb, long long qss, long long qsh,
                  float scale, int splits, int chunk) {
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

  const Place pl = place_of(BQ, m, H, Hkv, G, page_size, max_pages, splits,
                            chunk, base_len);
  const int npos = BQ / G;
  const int b = pl.b, kvh = pl.kvh, h0 = pl.h0, j0 = pl.j0;
  const int tid = threadIdx.x;
  const int cap = pl.cap, base = pl.base;
  const bool quant = sp != nullptr;
  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const int* bt = block_tables + static_cast<size_t>(b) * max_pages;

  // key limit of score row r (a pad row past m sees token 0 only), cut at
  // the chunk's end
  auto limit_of = [&](int r) {
    const int j = j0 + r / G;
    return min(j < m ? min(base + j + 1, cap) : 1, pl.kend);
  };
  const int lim_max = min(min(base + min(j0 + npos, m), cap), pl.kend);

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

  const int n_kt = lim_max > pl.kbeg ? (lim_max - pl.kbeg + BK - 1) / BK : 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = pl.kbeg + kt * BK;
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
    const float inv = 1.f / fmaxf(l_i, 1e-37f);
    const float lse = m_i == -INFINITY ? -INFINITY : m_i + logf(l_i);
    float* dst = row_out(out, part_o, part_lse, splits, B, m, H, D, b, j,
                         h0 + row % G, lse, part == 0);
#pragma unroll
    for (int c = 0; c < DP; ++c) dst[part + TPR * c] = o[c] * inv;
  }
}

template <typename TQ, typename TKV, int D, int BQ>
cudaError_t launch_bq(const Args& a) {
  constexpr size_t smem = smem_bytes<BQ, D>();
  auto kernel = verify_fma_kernel<TQ, TKV, D, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int npos = BQ / a.G;
  dim3 grid((a.m + npos - 1) / npos * a.splits, a.B,
            a.Hkv * (a.H / a.Hkv / a.G));
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), a.sp, a.bt, a.base, a.out, a.part_o,
      a.part_lse, a.B, a.m, a.H, a.Hkv, a.G, a.ps, a.mp, a.qsb, a.qss,
      a.qsh, a.scale, a.splits, a.chunk);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const Args& a) {
  const long long rows = static_cast<long long>(a.m) * a.G;
  if (rows <= 16) return launch_bq<TQ, TKV, D, 16>(a);
  if (rows <= 32) return launch_bq<TQ, TKV, D, 32>(a);
  return launch_bq<TQ, TKV, D, 64>(a);
}

}  // namespace body_fma

// ------------------------------------------------ the tensor-core body
namespace body_tc {

using bf16 = __nv_bfloat16;

template <int D, int BQ, bool Q8>
struct Shape {
  static constexpr int NT = BQ * 2;   // BQ / 16 warps
  static constexpr int LD = D + 8;    // bf16 row pitch: ldmatrix conflict-free
  static constexpr int LD8 = D + 16;  // int8 staging row pitch (bytes)
  static constexpr int RING = Q8 ? 1 : 2;  // bf16 K/V tiles
  static constexpr size_t q_bytes = sizeof(bf16) * BQ * LD;
  static constexpr size_t kv_bytes = sizeof(bf16) * 2 * RING * BK * LD;
  static constexpr size_t i8_bytes = Q8 ? 2 * 2 * BK * LD8 : 0;
  static constexpr size_t sc_bytes = Q8 ? sizeof(uint32_t) * 2 * 2 * BK : 0;
  static constexpr size_t smem =
      q_bytes + kv_bytes + i8_bytes + sc_bytes + sizeof(int) * 3 * BK;
};

// a bf16 half of a 32-bit scale word, as f32
__device__ __forceinline__ float half_bf16(uint32_t w, int hi) {
  return __uint_as_float((hi ? w >> 16 : w & 0xffffu) << 16);
}

// four int8 (one word, lowest byte first) to four bf16 (two words), exactly:
// each byte, its sign bit flipped, becomes the low mantissa byte of the
// f32 2^23, from which 2^23 + 128 is taken away (a byte permute and a
// subtract instead of the slower int-to-float conversion)
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.f;
  lo = pack_bf16(f[0], f[1]);
  hi = pack_bf16(f[2], f[3]);
}

// (at least one block an SM: a thread may take up to 255 registers)
template <int D, int BQ, bool Q8>
__global__ void __launch_bounds__(Shape<D, BQ, Q8>::NT, 1)
verify_tc_kernel(const bf16* __restrict__ q, const void* __restrict__ kpv,
                 const void* __restrict__ vpv,
                 const bf16* __restrict__ sp,
                 const int* __restrict__ block_tables,
                 const int* __restrict__ base_len, float* __restrict__ out,
                 float* __restrict__ part_o, float* __restrict__ part_lse,
                 int B, int m, int H, int Hkv, int G, int ps, int max_pages,
                 long long qsb, long long qss, long long qsh, float scale,
                 int splits, int chunk, int q_vec) {
  using Sh = Shape<D, BQ, Q8>;
  constexpr int NT = Sh::NT, LD = Sh::LD, LD8 = Sh::LD8;
  constexpr int CH = D / 8;    // 16-byte chunks of a bf16 row
  constexpr int CH8 = D / 16;  // 16-byte chunks of an int8 row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sK = sQ + BQ * LD;                       // [RING][BK][LD]
  bf16* sV = sK + Sh::RING * BK * LD;            // [RING][BK][LD]
  int8_t* sK8 = reinterpret_cast<int8_t*>(sV + Sh::RING * BK * LD);
  int8_t* sV8 = sK8 + (Q8 ? 2 * BK * LD8 : 0);   // int8 ring [2][BK][LD8]
  uint32_t* sSc = reinterpret_cast<uint32_t*>(sV8 + (Q8 ? 2 * BK * LD8 : 0));
  // sSc [2 stages][k, v][BK]: each key's scale words
  int* sTok = reinterpret_cast<int*>(sSc + (Q8 ? 4 * BK : 0));  // [3][BK]

  const Place pl =
      place_of(BQ, m, H, Hkv, G, ps, max_pages, splits, chunk, base_len);
  const int npos = BQ / G;
  const int b = pl.b, kvh = pl.kvh, h0 = pl.h0, j0 = pl.j0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int* bt = block_tables + static_cast<size_t>(b) * max_pages;
  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const int lim_max = min(min(pl.base + min(j0 + npos, m), pl.cap), pl.kend);
  const int n_kt =
      lim_max > pl.kbeg ? (lim_max - pl.kbeg + BK - 1) / BK : 0;

  // the physical page of key r of tile t, or -1 past the block's keys
  auto page_of = [&](int t, int r) {
    const int key = pl.kbeg + t * BK + r;
    return key < lim_max ? __ldg(bt + key / ps) : -1;
  };
  auto tok_of = [&](int page, int t, int r) {
    return page < 0 ? -1 : page * ps + (pl.kbeg + t * BK + r) % ps;
  };
  // tile t into ring stage st, slab rows from sTok[t % 3]
  auto issue = [&](int t, int st) {
    const int* tk = sTok + (t % 3) * BK;
    if constexpr (!Q8) {
      const bf16* kp = static_cast<const bf16*>(kpv);
      const bf16* vp = static_cast<const bf16*>(vpv);
      bf16* dk = sK + st * BK * LD;
      bf16* dv = sV + st * BK * LD;
      for (int i = tid; i < BK * CH; i += NT) {
        const int r = i / CH, c = i % CH, tok = tk[r];
        const size_t off = static_cast<size_t>(max(tok, 0)) * row_stride +
                           static_cast<size_t>(kvh) * D + 8 * c;
        cp_async16(dk + r * LD + 8 * c, kp + off, tok >= 0);
        cp_async16(dv + r * LD + 8 * c, vp + off, tok >= 0);
      }
    } else {
      const int8_t* kp = static_cast<const int8_t*>(kpv);
      const int8_t* vp = static_cast<const int8_t*>(vpv);
      int8_t* dk = sK8 + st * BK * LD8;
      int8_t* dv = sV8 + st * BK * LD8;
      for (int i = tid; i < BK * CH8; i += NT) {
        const int r = i / CH8, c = i % CH8, tok = tk[r];
        const size_t off = static_cast<size_t>(max(tok, 0)) * row_stride +
                           static_cast<size_t>(kvh) * D + 16 * c;
        cp_async16(dk + r * LD8 + 16 * c, kp + off, tok >= 0);
        cp_async16(dv + r * LD8 + 16 * c, vp + off, tok >= 0);
      }
      for (int r = tid; r < BK; r += NT) {  // zero scales past the keys
        const int tok = tk[r];
        const bf16* srow = sp + static_cast<size_t>(max(tok, 0)) * 128;
        cp_async4(sSc + (2 * st) * BK + r, srow + (kvh & ~1), tok >= 0);
        cp_async4(sSc + (2 * st + 1) * BK + r, srow + ((Hkv + kvh) & ~1),
                  tok >= 0);
      }
    }
  };

  // table lookups of tiles 0 and 1 now, tile 2's page reads in flight
  constexpr int PR = (BK + NT - 1) / NT;  // keys a thread looks up
  int pend[PR];
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int r = tid + i * NT;
    if (r < BK) {
      sTok[r] = tok_of(page_of(0, r), 0, r);
      sTok[BK + r] = tok_of(page_of(1, r), 1, r);
      pend[i] = page_of(2, r);
    }
  }

  // Q rows (position j0 + r / G, head h0 + r % G) into bf16 rows, zeros
  // past m; 16-byte loads where q's base and strides allow
  if (q_vec) {
    for (int i = tid; i < BQ * CH; i += NT) {
      const int r = i / CH, c = i % CH, j = j0 + r / G, h = h0 + r % G;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (j < m)
        v = __ldg(reinterpret_cast<const uint4*>(q + b * qsb + j * qss +
                                                 h * qsh + 8 * c));
      *reinterpret_cast<uint4*>(sQ + r * LD + 8 * c) = v;
    }
  } else {
    for (int i = tid; i < BQ * D; i += NT) {
      const int r = i / D, c = i % D, j = j0 + r / G, h = h0 + r % G;
      sQ[r * LD + c] =
          j < m ? q[b * qsb + j * qss + h * qsh + c] : __float2bfloat16(0.f);
    }
  }
  __syncthreads();  // sQ and the first lookups are visible
  if (n_kt > 0) issue(0, 0);
  cp_async_commit();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qf[kk], a_frag_row(sQ, LD, warp * 16, 16 * kk, lane));

  // this thread's two score rows (g and g + 8 of the warp): their key
  // limits, cut at the chunk's end (a pad row past m sees token 0 only)
  int lim[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int j = j0 + (warp * 16 + g + 8 * rr) / G;
    lim[rr] = min(j < m ? min(pl.base + j + 1, pl.cap) : 1, pl.kend);
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)
  const int khi = kvh & 1, vhi = (Hkv + kvh) & 1;

  for (int t = 0; t < n_kt; ++t) {
    const int st = t & 1;
    __syncthreads();  // stage st ^ 1 (tile t - 1) is read; sTok visible
    if (t + 1 < n_kt) issue(t + 1, st ^ 1);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < PR; ++i) {  // lookups run two tiles ahead of copies
      const int r = tid + i * NT;
      if (r < BK) {
        sTok[((t + 2) % 3) * BK + r] = tok_of(pend[i], t + 2, r);
        pend[i] = page_of(t + 3, r);
      }
    }
    cp_async_wait<1>();  // tile t landed for this thread ...
    __syncthreads();     // ... and for every thread
    const bf16* tK = sK + (Q8 ? 0 : st * BK * LD);
    const bf16* tV = sV + (Q8 ? 0 : st * BK * LD);
    if constexpr (Q8) {  // int8 -> bf16 (exact) into the one bf16 tile
      const int8_t* k8 = sK8 + st * BK * LD8;
      const int8_t* v8 = sV8 + st * BK * LD8;
      for (int i = tid; i < 2 * BK * CH8; i += NT) {
        const int kv = i / (BK * CH8), r = (i / CH8) % BK, c = i % CH8;
        const int8_t* src = (kv ? v8 : k8) + r * LD8 + 16 * c;
        bf16* dst = (kv ? sV : sK) + r * LD + 16 * c;
        const uint4 in = *reinterpret_cast<const uint4*>(src);
        const uint32_t words[4] = {in.x, in.y, in.z, in.w};
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) i8x4_to_bf16(words[e], w[2 * e],
                                                 w[2 * e + 1]);
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(dst + 8) =
            make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
    }
    const int k0 = pl.kbeg + t * BK;

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj) {
        uint32_t kf[4];
        ldsm_x4(kf, b_frag_row(tK, LD, 16 * jj, 16 * kk, lane));
        mma_bf16(s[2 * jj], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jj + 1], qf[kk], kf[2], kf[3]);
      }

    // scores (times each key's k scale) into the log2 domain, masked
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tq + (e & 1);
        float x = s[j][e] * sl2;
        if constexpr (Q8) x *= half_bf16(sSc[(2 * st) * BK + c], khi);
        s[j][e] = k0 + c < lim[e >> 1] ? x : -INFINITY;
      }

    // online softmax on the accumulators: each row lives in one quad
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with no key yet
      alpha[r] = exp2f(mrow[r] - mu[r]);
      mrow[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] - mu[e >> 1]);
        l[e >> 1] += p;
        if constexpr (Q8)
          p *= half_bf16(sSc[(2 * st + 1) * BK + 8 * j + 2 * tq + (e & 1)],
                         vhi);
        s[j][e] = p;
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // O += bf(P * vscale) V: P goes from the S accumulators into A
    // fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t vf[4];
        ldsm_x4_t(vf, bt_frag_row(tV, LD, 16 * kk, 16 * dd, lane));
        mma_bf16(o[2 * dd], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dd + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = warp * 16 + g + 8 * rr, j = j0 + r / G;
    if (j >= m) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-37f);
    const float lse = mrow[rr] == -INFINITY
                          ? -INFINITY
                          : mrow[rr] * 0.6931471805599453f + logf(l[rr]);
    float* dst = row_out(out, part_o, part_lse, splits, B, m, H, D, b, j,
                         h0 + r % G, lse, tq == 0);
    // lanes 8n + 2tq and 8n + 2tq + 1 of the row, as float2 stores
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n + 2 * tq) =
          make_float2(o[n][2 * rr] * inv, o[n][2 * rr + 1] * inv);
  }
}

template <int D, int BQ, bool Q8>
cudaError_t launch_bq(const Args& a) {
  using Sh = Shape<D, BQ, Q8>;
  auto kernel = verify_tc_kernel<D, BQ, Q8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Sh::smem));
  if (err != cudaSuccess) return err;
  const int npos = BQ / a.G;
  dim3 grid((a.m + npos - 1) / npos * a.splits, a.B,
            a.Hkv * (a.H / a.Hkv / a.G));
  kernel<<<grid, Sh::NT, Sh::smem, a.stream>>>(
      static_cast<const bf16*>(a.q), a.kp, a.vp, a.sp, a.bt, a.base, a.out,
      a.part_o, a.part_lse, a.B, a.m, a.H, a.Hkv, a.G, a.ps, a.mp, a.qsb,
      a.qss, a.qsh, a.scale, a.splits, a.chunk, a.q_vec ? 1 : 0);
  return cudaGetLastError();
}

template <int D, bool Q8>
cudaError_t launch(const Args& a) {
  const long long rows = static_cast<long long>(a.m) * a.G;
  if (rows <= 16) return launch_bq<D, 16, Q8>(a);
  if (rows <= 32) return launch_bq<D, 32, Q8>(a);
  return launch_bq<D, 64, Q8>(a);
}

}  // namespace body_tc

// ------------------------------------------------ the split-K merge
// out[row] = sum_c w_c o_c / sum_c w_c with w_c = exp(lse_c - max lse):
// one thread per 4 lanes of a row
__global__ void verify_merge_kernel(const float* __restrict__ part_o,
                                    const float* __restrict__ part_lse,
                                    float* __restrict__ out, long long rows,
                                    int D, int splits) {
  const int per_row = D / 4;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / per_row) +
      threadIdx.x / per_row;
  const int lane = threadIdx.x % per_row;
  if (row >= rows) return;
  float mx = -INFINITY;
  for (int c = 0; c < splits; ++c) mx = fmaxf(mx, part_lse[c * rows + row]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float wsum = 0.f;
  for (int c = 0; c < splits; ++c) {
    const float lse = part_lse[c * rows + row];
    if (lse == -INFINITY) continue;  // the chunk holds no key of the row
    const float w = expf(lse - mx);
    const float4 v = reinterpret_cast<const float4*>(
        part_o + (c * rows + row) * D)[lane];
    wsum += w;
    acc.x += w * v.x;
    acc.y += w * v.y;
    acc.z += w * v.z;
    acc.w += w * v.w;
  }
  const float inv = wsum > 0.f ? 1.f / wsum : 0.f;
  reinterpret_cast<float4*>(out + row * D)[lane] =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

// ------------------------------------------------ dispatch
using Launcher = cudaError_t (*)(const Args&);

template <typename TQ, typename TKV>
Launcher pick_fma(int D) {
  switch (D) {
    case 64:
      return body_fma::launch<TQ, TKV, 64>;
    case 128:
      return body_fma::launch<TQ, TKV, 128>;
    case 256:
      return body_fma::launch<TQ, TKV, 256>;
    default:
      return nullptr;
  }
}

// the launcher of a (body, q dtype, kv dtype, D) case; null when the
// kernel does not take it. body 1, the tensor-core body, takes bf16 q at
// D 64 and 128 with bf16 or int8 pages; body 0, the FMA body, every case
Launcher pick(int body, int q_dtype, int kv_dtype, int D) {
  const bool q8 = kv_dtype == kI8;
  if (body == 1) {
    if (q_dtype != kBF16 || !(kv_dtype == kBF16 || q8)) return nullptr;
    if (D == 64) return q8 ? body_tc::launch<64, true>
                           : body_tc::launch<64, false>;
    if (D == 128) return q8 ? body_tc::launch<128, true>
                            : body_tc::launch<128, false>;
    return nullptr;
  }
  if (body != 0) return nullptr;
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return pick_fma<__nv_bfloat16, __nv_bfloat16>(D);
  if (q_dtype == kF32 && kv_dtype == kF32) return pick_fma<float, float>(D);
  if (q_dtype == kBF16 && q8) return pick_fma<__nv_bfloat16, int8_t>(D);
  if (q_dtype == kF32 && q8) return pick_fma<float, int8_t>(D);
  return nullptr;
}

}  // namespace

// q [B, m, H, D] (f32 or bf16) with element strides (batch, position, head)
// and a contiguous last dim; pages [P, page_size, Hkv * D] of q's dtype, or
// int8 with scale_pages [P, page_size, 128] bf16; block_tables [B,
// max_pages] i32; base_len [B] i32; out [B, m, H, D] f32 contiguous. body
// 1 is the tensor-core body, 0 the FMA body. splits > 1 cuts each row's
// window into chunks of `chunk` keys (a multiple of 64, splits * chunk
// covering the capacity) and needs part_o [splits, B, m, H, D] and
// part_lse [splits, B, m, H] f32 scratch; the merge kernel then follows on
// the same stream. Returns the cudaError_t of the launches.
extern "C" int paged_verify_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* scale_pages, const void* block_tables, const void* base_len,
    void* out, void* part_o, void* part_lse, int B, int m, int H, int Hkv,
    int D, int page_size, int max_pages, long long qsb, long long qss,
    long long qsh, int q_dtype, int kv_dtype, float scale, int body,
    int splits, int chunk, void* stream) {
  if (B <= 0 || m <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      page_size <= 0 || max_pages <= 0 || B > 65535 || splits <= 0)
    return cudaErrorInvalidValue;
  const long long cap = static_cast<long long>(max_pages) * page_size;
  if (splits > 1 &&
      (chunk <= 0 || chunk % BK != 0 || part_o == nullptr ||
       part_lse == nullptr ||
       static_cast<long long>(splits - 1) * chunk >= cap ||
       static_cast<long long>(splits) * chunk < cap))
    return cudaErrorInvalidValue;
  if (splits == 1) chunk = static_cast<int>(cap < INT32_MAX ? cap : INT32_MAX);
  const bool quant = kv_dtype == kI8;
  if (quant != (scale_pages != nullptr)) return cudaErrorInvalidValue;
  const int group = H / Hkv;
  int G = 1;
  while (G < 16 && group % (2 * G) == 0) G *= 2;
  if (static_cast<long long>(Hkv) * (group / G) > 65535)
    return cudaErrorInvalidValue;
  const Launcher run = pick(body, q_dtype, kv_dtype, D);
  if (run == nullptr) return cudaErrorInvalidValue;
  const int qe = q_dtype == kF32 ? 4 : 2;
  const bool q_vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                     (qsb * qe) % 16 == 0 && (qss * qe) % 16 == 0 &&
                     (qsh * qe) % 16 == 0;
  float* final_out = static_cast<float*>(out);
  Args a{q, k_pages, v_pages,
         static_cast<const __nv_bfloat16*>(scale_pages),
         static_cast<const int*>(block_tables),
         static_cast<const int*>(base_len), final_out,
         static_cast<float*>(part_o), static_cast<float*>(part_lse),
         B, m, H, Hkv, G, page_size, max_pages, qsb, qss, qsh, scale,
         splits, chunk, q_vec, static_cast<cudaStream_t>(stream)};
  cudaError_t err = run(a);
  if (err != cudaSuccess || splits == 1) return err;
  const long long rows = static_cast<long long>(B) * m * H;
  const int per_block = 256 / (D / 4);
  verify_merge_kernel<<<static_cast<unsigned>((rows + per_block - 1) /
                                              per_block),
                        per_block * (D / 4), 0, a.stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_lse),
      final_out, rows, D, splits);
  return cudaGetLastError();
}
