// FlashAttention-2 forward for Hopper (sm_90a): online softmax in f32,
// causal, ragged-edge and position masks, optional log-sum-exp.
//
// Replaces the forward of the TPU kernel
// paddle_tpu/ops/pallas/flash_attention.py `flash_attention_fused` (`_fwd`,
// body `_fwd_kernel`, #2, with its position form), and serves the packed
// causal forwards of paddle_tpu/ops/pallas/causal_flash.py (`_fwd`,
// `_fwd_tiled`, `_fwd_row`, #7-#9: three VMEM regimes of this one
// function) through strided views of the packed QKV tensor. The backward
// is csrc/flash_attention_bwd.cu.
//
// What it computes: for q [B, Sq, H, D] and k, v [B, Sk, Hkv, D] in any
// strides whose last dim is contiguous (q head h reads kv head
// h // (H / Hkv)), out[b, i, h] (any strides, contiguous last dim) =
// sum_j softmax_j(q_i . k_j * scale) v_j over j < Sk and, when causal,
// j <= i. lse[b, h, i] = log sum_j exp(...) when an lse buffer is given.
// P is rounded to the input dtype before the P.V product (the reference's
// `p.astype(mxu)`), every sum is f32. Rows with no key give zeros and lse
// = -1e30 (the reference's NEG_INF), which a log-space merge treats as no
// weight.
//
// Position mode (the reference's `q_positions` / `kv_positions`, which
// ring attention passes on every ring step): given int32 positions
// q_pos [Sq] and kv_pos [Sk], query i sees key j iff q_pos[i] >= kv_pos[j]
// (`_mask_logits(pos=)`), and `causal` is ignored. Whole rows of a chunk
// can then be masked; they take the zero-row rule above. The block walks
// every kv tile but skips one whose smallest key position exceeds the
// largest query position of its q tile (`__syncthreads_or`): such a tile
// adds exactly nothing.
//
// What bounds it on the H100: at prefill and training shapes (S in the
// hundreds to thousands, D = 64 or 128) it does ~2 * S * D flops per byte
// it must move, far above the card's ~295 flop/byte ridge, so the bound is
// the tensor cores' 989 TFLOP/s bf16.
//
// Two bodies, chosen explicitly by dtype and D at compile time in
// `pick_d` below, so the library holds no FMA body for bf16 at D 64 or
// 128 (the wrapper's `flash_body` states the same rule and counts the
// tensor-core launches by it):
//
// * bf16 at D 64 and 128, the tensor-core body (FlashAttention-2's design
//   on mma.sync). A block takes a q tile of 64 rows (4 warps, each owning
//   16 query rows), two blocks an SM at D = 128 and three at D = 64 (on
//   the H100 faster than 128-row blocks of 8 warps, one an SM). Q is
//   copied once into bf16 shared memory and held in registers as
//   m16n8k16 A fragments (ldmatrix). K and V stream
//   through a two-stage ring of 64-key tiles in bf16 shared memory, rows
//   padded by 8 elements so ldmatrix is free of bank conflicts, filled by
//   16-byte cp.async copies (zero-filled past Sk); tile t+1's copies are
//   issued before tile t's products. S = Q K^T and O += P V run on
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate; V read with ldmatrix.trans
//   as the B operand). The scale (times log2 e, for exp2f), the masks and
//   the online softmax work on the S accumulators in registers, each row
//   reduced across its quad with __shfl_xor_sync; P is rounded to bf16
//   straight from the S accumulators into the A fragments of P V, so it
//   never touches shared memory. Masks are applied only on tiles that
//   cross the diagonal or the ragged edge (every tile in position mode),
//   and a warp whose rows all precede a causal tile skips it. O is scaled
//   by 1/l and stored through the output strides with 16-byte stores,
//   staged through the warp's own rows of the Q buffer. Every operand's
//   base and (batch, seq, head) strides must be multiples of 16 bytes
//   (the copies' alignment); the wrapper refuses others.
// * f32 at every D, and bf16 at D 16, 32 and 256: the FMA body. f32
//   keeps full-precision products (TF32 would break its 1e-4 checks); no
//   model on the port's paths uses bf16 at D 16, 32 or 256 (config 5's
//   export example runs f32 at D 16: four threads a row hold its 16
//   accumulators as 4 each, as at any D divisible by 4, so D 16 needs no
//   change of the thread mapping). Grid (q tiles of 64 rows,
//   B * H); Q, K and V tiles staged in shared memory as f32; each thread
//   computes a 4x4 block of the 64x64 score tile with f32 FMAs; four
//   threads own one query row for the online softmax and its D-wide f32
//   accumulator; P goes through shared memory.
//
// Both bodies schedule the heaviest causal q tiles first, walk K/V tiles
// only up to the diagonal when causal, read the [B, S, H, D] strides
// directly (no [B*H, S, D] transpose copy), and mask keys past Sk in the
// kernel, so any S works (the ragged edge, the Pallas kv_valid mask).
// Later work: wgmma with TMA and warp specialisation for the tensor-core
// body, and tensor cores at D 32 and 256.

#include <limits.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using namespace ptt;

constexpr float kNoKeyLse = -1.0e30f;  // the reference's NEG_INF

// ------------------------------------------------ the FMA body
namespace body_fma {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
             (static_cast<size_t>(BQ) * D + static_cast<size_t>(BK) * (D + 1) +
              static_cast<size_t>(BK) * D + static_cast<size_t>(BQ) * (BK + 1)) +
         sizeof(int) * (BQ + BK);
}

template <typename T, int D, bool POS>
__global__ void __launch_bounds__(NT)
flash_fwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ qpos,
                     const int* __restrict__ kpos, int H, int Hkv, int Sq,
                     int Sk, long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     long long osb, long long oss, long long osh, int causal,
                     float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                  // [BQ][D]
  float* sK = sQ + BQ * D;           // [BK][D + 1]
  float* sV = sK + BK * (D + 1);     // [BK][D]
  float* sS = sV + BK * D;           // [BQ][BK + 1]
  int* sQp = reinterpret_cast<int*>(sS + BQ * (BK + 1));  // [BQ] (POS)
  int* sKp = sQp + BQ;                                     // [BK] (POS)

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int s = q0 + r;
    sQ[i] = s < Sq ? to_f(qb[s * qss + c]) : 0.f;
  }

  // score-tile mapping: rows ty*4 .. ty*4+3, cols tx + 16*j
  const int ty = tid >> 4, tx = tid & 15;
  // softmax / accumulator mapping: row `row`, cols part + 4*c
  const int row = tid >> 2, part = tid & 3;
  constexpr int DP = D / 4;
  float o[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) o[c] = 0.f;
  float m_i = -INFINITY, l_i = 0.f;

  // the largest query position of the tile (rows past Sq see nothing)
  int qmax = INT_MIN;
  if (POS) {
    for (int i = tid; i < BQ; i += NT)
      sQp[i] = q0 + i < Sq ? qpos[q0 + i] : INT_MIN;
    __syncthreads();
    for (int i = 0; i < BQ; ++i) qmax = max(qmax, sQp[i]);
  }

  int n_kt = (Sk + BK - 1) / BK;
  if (causal && !POS) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // last tile's readers of sK / sV / sS / sKp are done
    if (POS) {
      int seen = 0;
      if (tid < BK) {
        const int s = k0 + tid;
        sKp[tid] = s < Sk ? kpos[s] : INT_MAX;
        seen = s < Sk && sKp[tid] <= qmax;
      }
      // no query of this tile sees a key of that one: it adds nothing
      if (!__syncthreads_or(seen)) continue;
    }
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int s = k0 + r;
      const bool ok = s < Sk;
      sK[r * (D + 1) + c] = ok ? to_f(kb[s * kss + c]) : 0.f;
      sV[r * D + c] = ok ? to_f(vb[s * vss + c]) : 0.f;
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bk[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int qi = q0 + r, ki = k0 + c;
        const bool keep =
            ki < Sk && (POS ? sQp[r] >= sKp[c] : (!causal || qi >= ki));
        sS[r * (BK + 1) + c] = keep ? acc[i][j] * scale : -INFINITY;
      }
    __syncthreads();

    float* srow = sS + row * (BK + 1);
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) mx = fmaxf(mx, srow[part + 4 * j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const bool dead = m_new == -INFINITY;  // every key so far masked
    const float alpha = dead ? 1.f : expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int c = part + 4 * j;
      const float s = srow[c];
      const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
      psum += p;
      srow[c] = round_to(p, T());
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    __syncwarp();  // the row's four threads share one warp

#pragma unroll
    for (int c = 0; c < DP; ++c) o[c] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = srow[j];
      const float* vr = sV + j * D + part;
#pragma unroll
      for (int c = 0; c < DP; ++c) o[c] += p * vr[4 * c];
    }
  }

  const int qi = q0 + row;
  if (qi < Sq) {
    const float inv = 1.f / fmaxf(l_i, 1e-37f);
    T* orow = out + b * osb + qi * oss + h * osh;
#pragma unroll
    for (int c = 0; c < DP; ++c) store_f(orow + part + 4 * c, o[c] * inv);
    if (lse != nullptr && part == 0)
      lse[static_cast<size_t>(bh) * Sq + qi] =
          m_i == -INFINITY ? kNoKeyLse : m_i + logf(fmaxf(l_i, 1e-37f));
  }
}

template <typename T, int D, bool POS>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const int* qpos, const int* kpos, int B, int H,
                   int Hkv, int Sq, int Sk, const long long* st, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma_kernel<T, D, POS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_fma_kernel<T, D, POS><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, qpos, kpos, H,
      Hkv, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], causal, scale);
  return cudaGetLastError();
}

}  // namespace body_fma

// ------------------------------------------------ the tensor-core body
namespace body_tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64;   // query rows a block: 4 warps of 16
constexpr int BK = 64;   // keys a K/V tile
constexpr int NT = 128;

template <int D>
struct Shape {
  static constexpr int LD = D + 8;  // padded row: ldmatrix conflict-free
  static constexpr size_t smem =
      sizeof(bf16) * static_cast<size_t>(BQ + 4 * BK) * LD +
      sizeof(int) * (BQ + 2 * BK);
};

// (at least one block an SM: ptxas may give a thread up to 255 registers;
// it takes 206-211 at D = 128, two blocks an SM, 155-162 at D = 64, three)
template <int D, bool POS>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, const int* __restrict__ qpos,
                    const int* __restrict__ kpos, int H, int Hkv, int Sq,
                    int Sk, long long qsb, long long qss, long long qsh,
                    long long ksb, long long kss, long long ksh,
                    long long vsb, long long vss, long long vsh,
                    long long osb, long long oss, long long osh, int causal,
                    float scale) {
  constexpr int LD = Shape<D>::LD, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);         // [BQ][LD]
  bf16* sK = sQ + BQ * LD;                              // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;                          // [2][BK][LD]
  int* sQp = reinterpret_cast<int*>(sV + 2 * BK * LD);  // [BQ] (POS)
  int* sKp = sQp + BQ;                                  // [2][BK] (POS)

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / Hkv);
  const int q0 = qt * BQ, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int qw = q0 + warp * 16;  // the warp's first query row
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + kvh * ksh;
  const bf16* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < BQ * CH; i += NT) {  // rows past Sq read as zeros
    const int r = i / CH, c = i % CH, s = q0 + r;
    cp_async16(sQ + r * LD + 8 * c, qb + (s < Sq ? s : 0) * qss + 8 * c,
               s < Sq);
  }
  // POS: the positions of this thread's two rows and the tile's largest
  int qmax = INT_MIN, qp0 = INT_MIN, qp1 = INT_MIN;
  if (POS) {
    for (int i = tid; i < BQ; i += NT)
      sQp[i] = q0 + i < Sq ? qpos[q0 + i] : INT_MIN;
    __syncthreads();
    for (int i = 0; i < BQ; ++i) qmax = max(qmax, sQp[i]);
    qp0 = sQp[warp * 16 + g];
    qp1 = sQp[warp * 16 + g + 8];
  }

  int n_kt = (Sk + BK - 1) / BK;
  if (causal && !POS) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  // K and V rows [t * BK, t * BK + BK) into stage st (zeros past Sk)
  auto load_kv = [&](int t, int st) {
    bf16* dk = sK + st * BK * LD;
    bf16* dv = sV + st * BK * LD;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = i % CH, s = t * BK + r;
      const long long row = s < Sk ? s : 0;
      cp_async16(dk + r * LD + 8 * c, kb + row * kss + 8 * c, s < Sk);
      cp_async16(dv + r * LD + 8 * c, vb + row * vss + 8 * c, s < Sk);
    }
  };
  // the first tile from t on that some query of the q tile sees (n_kt if
  // none), its key positions left in buf; every tile without positions
  auto next_live = [&](int t, int* buf) {
    if (!POS) return t;
    for (; t < n_kt; ++t) {
      int seen = 0;
      for (int i = tid; i < BK; i += NT) {
        const int s = t * BK + i;
        const int p = s < Sk ? kpos[s] : INT_MAX;
        buf[i] = p;
        seen |= s < Sk && p <= qmax;
      }
      if (__syncthreads_or(seen)) break;
    }
    return t;
  };

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // running max (log2 domain) and this thread's part of the row sums, for
  // rows g and g + 8 of the warp
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qf[D / 16][4];
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)

  int kt = next_live(0, sKp);
  if (kt < n_kt) load_kv(kt, 0);
  cp_async_commit();  // group: Q and the first K/V tile
  bool first = true;
  for (int st = 0; kt < n_kt; st ^= 1) {
    __syncthreads();  // every reader of stage st ^ 1 (the last tile) is done
    const int nxt = next_live(kt + 1, sKp + (st ^ 1) * BK);
    if (nxt < n_kt) load_kv(nxt, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q) landed for this thread ...
    __syncthreads();     // ... and for every thread
    if (first) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], a_frag_row(sQ, LD, warp * 16, 16 * kk, lane));
      first = false;
    }
    const int k0 = kt * BK;
    kt = nxt;
    // a causal tile after every row of the warp adds nothing to it
    if (!POS && causal && k0 > qw + 15) continue;
    const bf16* tK = sK + st * BK * LD;
    const bf16* tV = sV + st * BK * LD;

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

    // scores into the log2 domain; masks only where a key can be hidden
    const bool edge =
        POS || k0 + BK > Sk || (causal && k0 + BK - 1 > qw);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int c = 8 * j + 2 * tq + (e & 1), kj = k0 + c;
          const bool keep =
              kj < Sk && (POS ? (e < 2 ? qp0 : qp1) >= sKp[st * BK + c]
                              : (!causal || kj <= qw + g + 8 * (e >> 1)));
          if (!keep) x = -INFINITY;
        }
        s[j][e] = x;
      }

    // online softmax on the accumulators: each row lives in one quad
    float mx[2] = {m[0], m[1]};
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
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - mu[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // O += bf(P) V: P goes from the S accumulators into A fragments
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
  __syncthreads();  // no copy into Q's rows is in flight (no tile was live)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // the warp's Q rows are its own: they stage O for 16-byte stores
  store_rows<D>(o, 1.f / fmaxf(l[0], 1e-37f), 1.f / fmaxf(l[1], 1e-37f),
                sQ + warp * 16 * LD, LD, out + b * osb + h * osh, oss, qw,
                Sq, lane);
  if (lse != nullptr && tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qw + g + 8 * r;
      if (qi < Sq)
        lse[static_cast<size_t>(bh) * Sq + qi] =
            m[r] == -INFINITY
                ? kNoKeyLse
                : m[r] * 0.6931471805599453f + logf(fmaxf(l[r], 1e-37f));
    }
  }
}

template <int D, bool POS>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const int* qpos, const int* kpos, int B, int H,
                   int Hkv, int Sq, int Sk, const long long* st, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = Shape<D>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D, POS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_tc_kernel<D, POS><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, qpos, kpos,
      H, Hkv, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], causal, scale);
  return cudaGetLastError();
}

}  // namespace body_tc

// ------------------------------------------------ dispatch
// the body of a (dtype, D) case: tensor cores for bf16 at D 64 and 128,
// the FMA body for f32 and for bf16 at D 16, 32 and 256
constexpr bool tc_body(int dtype, int D) {
  return dtype == kBF16 && (D == 64 || D == 128);
}

using Launcher = cudaError_t (*)(const void*, const void*, const void*,
                                 void*, float*, const int*, const int*, int,
                                 int, int, int, int, const long long*, int,
                                 float, cudaStream_t);

template <typename T, int D>
Launcher pick_d(bool pos) {
  constexpr int code = std::is_same<T, float>::value ? kF32 : kBF16;
  if constexpr (tc_body(code, D)) {
    if (pos) return body_tc::launch<D, true>;
    return body_tc::launch<D, false>;
  } else {
    if (pos) return body_fma::launch<T, D, true>;
    return body_fma::launch<T, D, false>;
  }
}

template <typename T>
Launcher pick_t(int D, bool pos) {
  switch (D) {
    case 16:
      return pick_d<T, 16>(pos);
    case 32:
      return pick_d<T, 32>(pos);
    case 64:
      return pick_d<T, 64>(pos);
    case 128:
      return pick_d<T, 128>(pos);
    case 256:
      return pick_d<T, 256>(pos);
    default:
      return nullptr;
  }
}

// the launcher of a (dtype, D) case; null when the kernel does not take it
Launcher pick(int dtype, int D, bool pos) {
  if (dtype == kBF16) return pick_t<__nv_bfloat16>(D, pos);
  if (dtype == kF32) return pick_t<float>(D, pos);
  return nullptr;
}

}  // namespace

// q [B, Sq, H, D], k / v [B, Sk, Hkv, D] and out [B, Sq, H, D] with element
// strides (batch, seq, head) and a contiguous last dim, one dtype (f32 or
// bf16); lse [B, H, Sq] f32 contiguous or null; q_pos [Sq] and kv_pos [Sk]
// int32 contiguous, both null or both given (position mode, `causal`
// ignored). The tensor-core body (bf16, D 64 or 128) also needs 16-byte
// aligned bases and strides, which the caller checks. Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* q_pos, const void* kv_pos, int B,
    int H, int Hkv, int Sq, int Sk, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss,
    long long osh, int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      static_cast<long long>(B) * H > 65535 ||
      (q_pos == nullptr) != (kv_pos == nullptr))
    return cudaErrorInvalidValue;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  const Launcher run = pick(dtype, D, q_pos != nullptr);
  if (run == nullptr) return cudaErrorInvalidValue;
  return run(q, k, v, out, static_cast<float*>(lse),
             static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
             B, H, Hkv, Sq, Sk, st, causal, scale,
             static_cast<cudaStream_t>(stream));
}
