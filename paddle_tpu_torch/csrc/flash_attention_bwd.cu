// FlashAttention-2 backward for Hopper (sm_90a): dQ, dK and dV from q, k,
// v, the forward's output o, its cotangent dO and the forward's
// log-sum-exp, with an optional lse cotangent.
//
// Replaces the backward TPU kernels of the JAX package, which all compute
// this one function in different VMEM regimes:
//   paddle_tpu/ops/pallas/flash_attention.py `_bwd_fused` (#5, the fused
//     whole-sequence body `fused_bwd_math`) and `_bwd` (#6, the split
//     `_dkv_kernel` / `_dq_kernel` pair with delta and the lse cotangent);
//   paddle_tpu/ops/pallas/causal_flash.py `_bwd` (#11, `fused_bwd_math` on
//     the packed QKV layout) and `_bwd_tiled` (#10, the shared-p triangle
//     grid). The packed layouts reach this kernel as strided [B, S, H, D]
//     views, and dQ, dK, dV can be written straight into one packed dQKV.
//
// What it computes (the recompute scheme of `fused_bwd_math` / `_bwd`):
//   delta_i = sum_d dO_id O_id - dlse_i                     (f32)
//   P_ij    = exp(S_ij * scale - lse_i), exactly 0 where masked
//   dV_j    = sum_i bf(P_ij) dO_i
//   dP_ij   = dO_i . V_j
//   dS_ij   = bf(P_ij (dP_ij - delta_i))
//   dK_j    = scale * sum_i dS_ij Q_i,   dQ_i = scale * sum_j dS_ij K_j
// with bf() rounding to the input dtype (the reference's `.astype(mxu)`),
// every product accumulated in f32, and dq/dk/dv written in the input
// dtype. Masks: keys j >= Sk never count, and when causal query i sees
// keys j <= i (top-left alignment, as `_mask_logits` and the forward).
// Position mode (#6 with `qp` / `kp`, ring attention's chunks): int32
// q_pos [Sq] and kv_pos [Sk] are given, query i sees key j iff q_pos[i] >=
// kv_pos[j], and `causal` is ignored. A row that saw no key has lse = -1e30
// and every P entry of it exactly 0 (the reference's `_guard_p`), so it adds
// nothing. Both passes then walk every tile pair, skipping a pair in which
// no query position reaches the smallest key position (it adds nothing).
//
// What bounds it on the H100: at training shapes (S = 1024-8192, D = 64)
// the five products do ~5 * S * D flops per byte moved, far above the
// card's ~295 flop/byte ridge, so the bound is the tensor cores' 989
// TFLOP/s bf16. This first version runs its products on the f32 FMA units
// out of shared memory, like the forward kernel (#2): right and simple
// first; tensor cores (mma.sync / wgmma) and TMA are later work.
//
// What the design does: three launches on the caller's stream, no atomics,
// so the result is deterministic.
//   1. delta: one warp per query row.
//   2. dK/dV: one block per (k tile, b*h). K and V tiles stay in shared
//      memory; the block walks the causally live q tiles, re-forms S and
//      dP for the tile pair, and accumulates dK and dV in registers.
//   3. dQ: one block per (q tile, b*h), heaviest tiles first. Q and dO stay
//      in shared memory; the block walks the k tiles up to the diagonal.
// Tiles are 64 x 64 up to D = 128 and 32 x 32 at D = 256 (shared memory).
// Every operand is read through its own (batch, seq, head) strides with a
// contiguous last dim; keys and queries past the sequence ends are masked
// in the kernel, so no padding is needed.

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

using namespace ptt;

constexpr int NT = 256;

// element strides (batch, seq, head) of each [B, S, H, D] operand
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

template <int D>
struct Tile {
  static constexpr int B = D <= 128 ? 64 : 32;
};

template <int D>
constexpr size_t smem_bytes() {
  constexpr int BT = Tile<D>::B;
  return sizeof(float) *
             (4 * static_cast<size_t>(BT) * (D + 1) +
              2 * static_cast<size_t>(BT) * (BT + 1) +
              2 * static_cast<size_t>(BT)) +
         sizeof(int) * 2 * BT;
}

// rows [s0, s0 + R) of one head of a [B, S, H, D] operand into dst[R][D + 1]
// as f32; rows past S read as zeros
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long ss, int s0, int S) {
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D, c = i % D;
    const int s = s0 + r;
    dst[r * (D + 1) + c] =
        s < S ? to_f(src[static_cast<long long>(s) * ss + c]) : 0.f;
  }
}

template <int BQ>
__device__ __forceinline__ void load_rows(float* sL, float* sD,
                                          const float* __restrict__ lrow,
                                          const float* __restrict__ drow,
                                          int q0, int Sq) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int i = q0 + r;
    sL[r] = i < Sq ? lrow[i] : 0.f;
    sD[r] = i < Sq ? drow[i] : 0.f;
  }
}

// Position mode: the positions of q rows [q0, q0 + R) into sQp (INT_MIN
// past Sq, a row that sees nothing); true when one of them reaches kmin,
// the smallest key position of the partner tile. __syncthreads_or both
// publishes sQp and makes the answer the block's.
template <int R>
__device__ __forceinline__ bool q_tile_sees(int* sQp,
                                            const int* __restrict__ qpos,
                                            int q0, int Sq, int kmin) {
  int any = 0;
  for (int i = threadIdx.x; i < R; i += NT) {
    sQp[i] = q0 + i < Sq ? qpos[q0 + i] : INT_MIN;
    any |= q0 + i < Sq && sQp[i] >= kmin;
  }
  return __syncthreads_or(any) != 0;
}

// The same for key rows [k0, k0 + R) into sKp (INT_MAX past Sk): true when
// one of them is at most qmax, the largest query position of the partner.
template <int R>
__device__ __forceinline__ bool k_tile_seen(int* sKp,
                                            const int* __restrict__ kpos,
                                            int k0, int Sk, int qmax) {
  int any = 0;
  for (int i = threadIdx.x; i < R; i += NT) {
    sKp[i] = k0 + i < Sk ? kpos[k0 + i] : INT_MAX;
    any |= k0 + i < Sk && sKp[i] <= qmax;
  }
  return __syncthreads_or(any) != 0;
}

// S = Q K^T and dP = dO V^T for one (q tile, k tile) pair, thread (ty, tx)
// owning rows ty + 16 i and columns tx + 16 j; then P and dS into shared
// memory, rounded to T. sP may be null (the dQ pass needs dS only). POS:
// the mask is sQp[r] >= sKp[c] (the tile's positions) in place of causal.
template <typename T, int D, int BQ, int BK, bool POS>
__device__ __forceinline__ void pair_scores(
    const float* sQ, const float* sG, const float* sK, const float* sV,
    const float* sL, const float* sD, const int* sQp, const int* sKp,
    float* sP, float* sS, int q0, int k0, int Sq, int Sk, int causal,
    float scale) {
  constexpr int DP = D + 1, KP = BK + 1, RI = BQ / 16, RJ = BK / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[RI][RJ], dp[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RI], g[RI], kk[RJ], vv[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      a[i] = sQ[(ty + 16 * i) * DP + d];
      g[i] = sG[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      kk[j] = sK[(tx + 16 * j) * DP + d];
      vv[j] = sV[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        s[i][j] += a[i] * kk[j];
        dp[i][j] += g[i] * vv[j];
      }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const int qi = q0 + r, kj = k0 + c;
      const bool keep = qi < Sq && kj < Sk &&
                        (POS ? sQp[r] >= sKp[c] : (!causal || kj <= qi));
      const float p = keep ? expf(s[i][j] * scale - sL[r]) : 0.f;
      const float ds = p * (dp[i][j] - sD[r]);
      if (sP != nullptr) sP[r * KP + c] = round_to(p, T());
      sS[r * KP + c] = round_to(ds, T());
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
                       const float* __restrict__ dlse,
                       float* __restrict__ delta, int H, int Sq,
                       long long rows, Strides st) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (NT / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int i = static_cast<int>(row % Sq);
  const long long bh = row / Sq;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const T* orow = o + b * st.o[0] + i * st.o[1] + h * st.o[2];
  const T* grow = g + b * st.g[0] + i * st.g[1] + h * st.g[2];
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += to_f(orow[c]) * to_f(grow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc - (dlse != nullptr ? dlse[row] : 0.f);
}

template <typename T, int D, bool POS>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ qpos,
                     const int* __restrict__ kpos, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, Strides st,
                     int causal, float scale) {
  constexpr int BQ = Tile<D>::B, BK = Tile<D>::B;
  constexpr int DP = D + 1, KP = BK + 1, RJ = BK / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;             // [BK][DP]
  float* sV = sK + BK * DP;     // [BK][DP]
  float* sQ = sV + BK * DP;     // [BQ][DP]
  float* sG = sQ + BQ * DP;     // dO [BQ][DP]
  float* sP = sG + BQ * DP;     // [BQ][KP]
  float* sS = sP + BQ * KP;     // dS [BQ][KP]
  float* sL = sS + BQ * KP;     // lse [BQ]
  float* sD = sL + BQ;          // delta [BQ]
  int* sQp = reinterpret_cast<int*>(sD + BQ);  // [BQ] (POS)
  int* sKp = sQp + BQ;                         // [BK] (POS)

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  const T* gb = g + b * st.g[0] + h * st.g[2];
  const float* lrow = lse + static_cast<size_t>(bh) * Sq;
  const float* drow = delta + static_cast<size_t>(bh) * Sq;

  load_tile<T, D, BK>(sK, kb, st.k[1], k0, Sk);
  load_tile<T, D, BK>(sV, vb, st.v[1], k0, Sk);
  int kmin = INT_MAX;  // the smallest key position of the tile
  if (POS) {
    k_tile_seen<BK>(sKp, kpos, k0, Sk, INT_MIN);
    for (int i = 0; i < BK; ++i) kmin = min(kmin, sKp[i]);
  }

  // key rows tx + 16 j, head-dim columns ty + 16 c
  float adk[RJ][CD], adv[RJ][CD];
#pragma unroll
  for (int j = 0; j < RJ; ++j)
#pragma unroll
    for (int c = 0; c < CD; ++c) adk[j][c] = adv[j][c] = 0.f;

  const int nq = (Sq + BQ - 1) / BQ;
  // top-left causal: rows i >= k0 see this tile, the first in q tile k0/BQ
  for (int qt = causal && !POS ? k0 / BQ : 0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the last pair's readers of sQ / sG / sP / sS are done
    if (POS && !q_tile_sees<BQ>(sQp, qpos, q0, Sq, kmin)) continue;
    load_tile<T, D, BQ>(sQ, qb, st.q[1], q0, Sq);
    load_tile<T, D, BQ>(sG, gb, st.g[1], q0, Sq);
    load_rows<BQ>(sL, sD, lrow, drow, q0, Sq);
    __syncthreads();
    pair_scores<T, D, BQ, BK, POS>(sQ, sG, sK, sV, sL, sD, sQp, sKp, sP, sS,
                                   q0, k0, Sq, Sk, causal, scale);
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[RJ], sv[RJ], gv[CD], qv[CD];
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        pv[j] = sP[r * KP + tx + 16 * j];
        sv[j] = sS[r * KP + tx + 16 * j];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        gv[c] = sG[r * DP + ty + 16 * c];
        qv[c] = sQ[r * DP + ty + 16 * c];
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j)
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          adv[j][c] += pv[j] * gv[c];
          adk[j][c] += sv[j] * qv[c];
        }
    }
  }

#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    const int kj = k0 + tx + 16 * j;
    if (kj >= Sk) continue;
    T* dkr = dk + b * st.dk[0] + kj * st.dk[1] + h * st.dk[2];
    T* dvr = dv + b * st.dv[0] + kj * st.dv[1] + h * st.dv[2];
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      store_f(dkr + ty + 16 * c, adk[j][c] * scale);
      store_f(dvr + ty + 16 * c, adv[j][c]);
    }
  }
}

template <typename T, int D, bool POS>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ qpos,
                    const int* __restrict__ kpos, T* __restrict__ dq, int H,
                    int Sq, int Sk, Strides st, int causal, float scale) {
  constexpr int BQ = Tile<D>::B, BK = Tile<D>::B;
  constexpr int DP = D + 1, KP = BK + 1, RQ = BQ / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // [BQ][DP]
  float* sG = sQ + BQ * DP;     // dO [BQ][DP]
  float* sK = sG + BQ * DP;     // [BK][DP]
  float* sV = sK + BK * DP;     // [BK][DP]
  float* sS = sV + BK * DP;     // dS [BQ][KP]
  float* sL = sS + BQ * KP;     // lse [BQ]
  float* sD = sL + BQ;          // delta [BQ]
  int* sQp = reinterpret_cast<int*>(sD + BQ);  // [BQ] (POS)
  int* sKp = sQp + BQ;                         // [BK] (POS)

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  const T* gb = g + b * st.g[0] + h * st.g[2];

  load_tile<T, D, BQ>(sQ, qb, st.q[1], q0, Sq);
  load_tile<T, D, BQ>(sG, gb, st.g[1], q0, Sq);
  load_rows<BQ>(sL, sD, lse + static_cast<size_t>(bh) * Sq,
                delta + static_cast<size_t>(bh) * Sq, q0, Sq);
  int qmax = INT_MIN;  // the largest query position of the tile
  if (POS) {
    q_tile_sees<BQ>(sQp, qpos, q0, Sq, INT_MIN);
    for (int i = 0; i < BQ; ++i) qmax = max(qmax, sQp[i]);
  }

  // query rows tx + 16 i, head-dim columns ty + 16 c
  float adq[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) adq[i][c] = 0.f;

  int nk = (Sk + BK - 1) / BK;
  if (causal && !POS) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's readers of sK / sV / sS are done
    if (POS && !k_tile_seen<BK>(sKp, kpos, k0, Sk, qmax)) continue;
    load_tile<T, D, BK>(sK, kb, st.k[1], k0, Sk);
    load_tile<T, D, BK>(sV, vb, st.v[1], k0, Sk);
    __syncthreads();
    pair_scores<T, D, BQ, BK, POS>(sQ, sG, sK, sV, sL, sD, sQp, sKp, nullptr,
                                   sS, q0, k0, Sq, Sk, causal, scale);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float sv[RQ], kv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sv[i] = sS[(tx + 16 * i) * KP + c];
#pragma unroll
      for (int e = 0; e < CD; ++e) kv[e] = sK[c * DP + ty + 16 * e];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int e = 0; e < CD; ++e) adq[i][e] += sv[i] * kv[e];
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + tx + 16 * i;
    if (qi >= Sq) continue;
    T* dqr = dq + b * st.dq[0] + qi * st.dq[1] + h * st.dq[2];
#pragma unroll
    for (int c = 0; c < CD; ++c) store_f(dqr + ty + 16 * c, adq[i][c] * scale);
  }
}

// the dK/dV and dQ passes, with or without positions
template <typename T, int D, bool POS>
cudaError_t launch_passes(const T* q, const T* k, const T* v, const T* g,
                          const float* lse, const float* delta,
                          const int* qpos, const int* kpos, T* dq, T* dk,
                          T* dv, int B, int H, int Sq, int Sk,
                          const Strides& st, int causal, float scale,
                          cudaStream_t stream) {
  constexpr int BT = Tile<D>::B;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D, POS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D, POS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D, POS>
      <<<dim3((Sk + BT - 1) / BT, B * H), NT, smem, stream>>>(
          q, k, v, g, lse, delta, qpos, kpos, dk, dv, H, Sq, Sk, st, causal,
          scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D, POS>
      <<<dim3((Sq + BT - 1) / BT, B * H), NT, smem, stream>>>(
          q, k, v, g, lse, delta, qpos, kpos, dq, H, Sq, Sk, st, causal,
          scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* o, const void* g, const float* lse,
                     const float* dlse, const int* qpos, const int* kpos,
                     void* dq, void* dk, void* dv, float* delta, int B, int H,
                     int Sq, int Sk, const Strides& st, int causal,
                     float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const long long rows = static_cast<long long>(B) * H * Sq;
  const long long nblk = (rows + NT / 32 - 1) / (NT / 32);
  if (nblk > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T, D><<<static_cast<unsigned>(nblk), NT, 0, stream>>>(
      static_cast<const T*>(o), gt, dlse, delta, H, Sq, rows, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (qpos != nullptr)
    return launch_passes<T, D, true>(
        qt, kt, vt, gt, lse, delta, qpos, kpos, static_cast<T*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv), B, H, Sq, Sk, st, causal,
        scale, stream);
  return launch_passes<T, D, false>(
      qt, kt, vt, gt, lse, delta, qpos, kpos, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), B, H, Sq, Sk, st, causal,
      scale, stream);
}

template <typename T>
cudaError_t launch_t(int D, const void* q, const void* k, const void* v,
                     const void* o, const void* g, const float* lse,
                     const float* dlse, const int* qpos, const int* kpos,
                     void* dq, void* dk, void* dv, float* delta, int B, int H,
                     int Sq, int Sk, const Strides& st, int causal,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_d<T, 64>(q, k, v, o, g, lse, dlse, qpos, kpos, dq, dk, dv,
                             delta, B, H, Sq, Sk, st, causal, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, o, g, lse, dlse, qpos, kpos, dq, dk,
                              dv, delta, B, H, Sq, Sk, st, causal, scale,
                              stream);
    case 256:
      return launch_d<T, 256>(q, k, v, o, g, lse, dlse, qpos, kpos, dq, dk,
                              dv, delta, B, H, Sq, Sk, st, causal, scale,
                              stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dO, dq [B, Sq, H, D] and k, v, dk, dv [B, Sk, H, D] in any element
// strides with a contiguous last dim; `strides` holds 24 values, (batch,
// seq, head) of q, k, v, o, dO, dq, dk, dv in that order. lse and the
// optional dlse are [B, H, Sq] f32 contiguous; delta is caller-allocated
// [B, H, Sq] f32 scratch; q_pos [Sq] and kv_pos [Sk] int32 contiguous, both
// null or both given (position mode, `causal` ignored). f32 or bf16
// operands (all one dtype); D in {64, 128, 256}. Returns the cudaError_t of
// the launches.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* dlse, void* dq, void* dk,
    void* dv, void* delta, const void* q_pos, const void* kv_pos, int B,
    int H, int Sq, int Sk, int D, const long long* strides, int causal,
    float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || strides == nullptr ||
      static_cast<long long>(B) * H > 65535 ||
      (q_pos == nullptr) != (kv_pos == nullptr))
    return cudaErrorInvalidValue;
  Strides st;
  long long* dst[8] = {st.q, st.k, st.v, st.o, st.g, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) dst[t][j] = strides[3 * t + j];
  const float* lse_f = static_cast<const float*>(lse);
  const float* dlse_f = static_cast<const float*>(dlse);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  float* delta_f = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_t<__nv_bfloat16>(D, q, k, v, o, dout, lse_f, dlse_f, qp, kp,
                                   dq, dk, dv, delta_f, B, H, Sq, Sk, st,
                                   causal, scale, s);
  if (dtype == kF32)
    return launch_t<float>(D, q, k, v, o, dout, lse_f, dlse_f, qp, kp, dq, dk,
                           dv, delta_f, B, H, Sq, Sk, st, causal, scale, s);
  return cudaErrorInvalidValue;
}
