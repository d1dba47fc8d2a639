// FlashAttention-2 style forward for Hopper (sm_90a): online softmax in f32,
// causal and ragged-edge masks, optional log-sum-exp.
//
// Replaces the forward of the TPU kernel
// paddle_tpu/ops/pallas/flash_attention.py `flash_attention_fused` (`_fwd`,
// body `_fwd_kernel`), and serves the packed causal forwards of
// paddle_tpu/ops/pallas/causal_flash.py (`_fwd`, `_fwd_tiled`, `_fwd_row`:
// three VMEM regimes of this one function) through strided views of the
// packed QKV tensor. The backward is csrc/flash_attention_bwd.cu.
//
// What it computes: for q [B, Sq, H, D] and k, v [B, Sk, Hkv, D] in any
// strides whose last dim is contiguous (q head h reads kv head
// h // (H / Hkv)), out[b, i, h] (any strides, contiguous last dim) = sum_j softmax_j(q_i . k_j * scale) v_j
// over j < Sk and, when causal, j <= i. lse[b, h, i] = log sum_j exp(...)
// when an lse buffer is given. Rows with no key give zeros and lse = -1e30
// (the reference's NEG_INF), which a log-space merge treats as no weight.
//
// Position mode (the reference's `q_positions` / `kv_positions`, which
// ring attention passes on every ring step): given int32 positions
// q_pos [Sq] and kv_pos [Sk], query i sees key j iff q_pos[i] >= kv_pos[j]
// (`_mask_logits(pos=)`), and `causal` is ignored. Whole rows of a chunk
// can then be masked; they take the zero-row rule above. The block walks
// every kv tile but skips one whose smallest key position exceeds the
// largest query position of its q tile: such a tile adds exactly nothing.
//
// What bounds it on the H100: at prefill shapes (S in the hundreds to
// thousands, D = 128) it does ~2 * S * D flops per byte it must move, well
// above the card's ~295 flop/byte ridge, so the bound is the tensor cores'
// 989 TFLOP/s bf16. This first version does its products with f32 FMAs out
// of shared memory (no tensor cores yet), so it runs far from that bound:
// it is right and simple first; wgmma, TMA and warp specialisation are
// later work.
//
// What the design does: grid (q tiles of 64 rows, B * H); the heaviest
// causal tiles are scheduled first. The block takes the [B, S, H, D]
// strides directly (no [B*H, S, D] transpose copy), stages Q, K and V tiles
// in shared memory as f32, and walks K/V tiles only up to the diagonal when
// causal. Each thread computes a 4x4 block of the 64x64 score tile; four
// threads own one query row for the online softmax and its D-wide f32
// accumulator. P is rounded to the input dtype before the P.V product, as
// the Pallas kernel does, with f32 accumulation. Keys past Sk are masked
// in-kernel, so any S works (the ragged edge, the Pallas kv_valid mask).

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

using namespace ptt;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float kNoKeyLse = -1.0e30f;  // the reference's NEG_INF

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
             (static_cast<size_t>(BQ) * D + static_cast<size_t>(BK) * (D + 1) +
              static_cast<size_t>(BK) * D + static_cast<size_t>(BQ) * (BK + 1)) +
         sizeof(int) * (BQ + BK);
}

template <typename T, int D, bool POS>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, int H, int Hkv, int Sq, int Sk,
                 long long qsb, long long qss, long long qsh, long long ksb,
                 long long kss, long long ksh, long long vsb, long long vss,
                 long long vsh, long long osb, long long oss, long long osh,
                 int causal, float scale) {
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
cudaError_t launch_p(const void* q, const void* k, const void* v, void* out,
                     float* lse, const int* qpos, const int* kpos, int B,
                     int H, int Hkv, int Sq, int Sk, const long long* st,
                     int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, POS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D, POS><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, qpos, kpos, H,
      Hkv, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     float* lse, const int* qpos, const int* kpos, int B,
                     int H, int Hkv, int Sq, int Sk, const long long* st,
                     int causal, float scale, cudaStream_t stream) {
  if (qpos != nullptr)
    return launch_p<T, D, true>(q, k, v, out, lse, qpos, kpos, B, H, Hkv, Sq,
                                Sk, st, causal, scale, stream);
  return launch_p<T, D, false>(q, k, v, out, lse, qpos, kpos, B, H, Hkv, Sq,
                               Sk, st, causal, scale, stream);
}

template <typename T>
cudaError_t launch_t(int D, const void* q, const void* k, const void* v,
                     void* out, float* lse, const int* qpos, const int* kpos,
                     int B, int H, int Hkv, int Sq, int Sk,
                     const long long* st, int causal, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, out, lse, qpos, kpos, B, H, Hkv,
                             Sq, Sk, st, causal, scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, out, lse, qpos, kpos, B, H, Hkv,
                             Sq, Sk, st, causal, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, out, lse, qpos, kpos, B, H, Hkv,
                              Sq, Sk, st, causal, scale, stream);
    case 256:
      return launch_d<T, 256>(q, k, v, out, lse, qpos, kpos, B, H, Hkv,
                              Sq, Sk, st, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Sq, H, D], k / v [B, Sk, Hkv, D] and out [B, Sq, H, D] with element
// strides (batch, seq, head) and a contiguous last dim, one dtype (f32 or
// bf16); lse [B, H, Sq] f32 contiguous or null; q_pos [Sq] and kv_pos [Sk]
// int32 contiguous, both null or both given (position mode, `causal`
// ignored). Returns the cudaError_t of the launch.
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
  float* lse_f = static_cast<float*>(lse);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_t<__nv_bfloat16>(D, q, k, v, out, lse_f, qp, kp, B, H, Hkv,
                                   Sq, Sk, st, causal, scale, s);
  if (dtype == kF32)
    return launch_t<float>(D, q, k, v, out, lse_f, qp, kp, B, H, Hkv, Sq, Sk,
                           st, causal, scale, s);
  return cudaErrorInvalidValue;
}
