// FlashAttention-2 backward for Hopper (sm_90a): dQ, dK and dV from q, k,
// v, the forward's output o, its cotangent dO and the forward's
// log-sum-exp, with an optional lse cotangent.
//
// Replaces the backward TPU kernels of the JAX package, which all compute
// this one function in different VMEM regimes:
//   paddle_tpu/ops/pallas/flash_attention.py `_bwd_fused` (#5, the fused
//     whole-sequence body `fused_bwd_math`) and `_bwd` (#6, the split
//     `_dkv_kernel` / `_dq_kernel` pair with delta and the lse cotangent,
//     and its position form);
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
// the products do ~5 * S * D flops per byte moved, far above the card's
// ~295 flop/byte ridge, so the bound is the tensor cores' 989 TFLOP/s
// bf16.
//
// What the design does: three launches on the caller's stream and no
// atomics, so the result is bitwise deterministic. The dQ pass recomputes
// S and dP, which the dK/dV pass also forms: seven products a tile pair
// where an atomic dQ would need five (~2/5 more flops), the price of
// determinism.
//   1. delta: one warp per query row (both bodies).
//   2. dK/dV: one block per (k tile, b*h); K and V stay in shared memory;
//      the block walks the causally live (or, with positions, the live) q
//      tiles and accumulates dK and dV in registers.
//   3. dQ: one block per (q tile, b*h), heaviest tiles first; Q and dO stay
//      in shared memory; the block walks the k tiles up to the diagonal
//      (or the live ones).
// Two bodies serve passes 2 and 3, chosen explicitly by dtype and D at
// compile time in `launch_d` below, so the library holds no FMA body for
// bf16 at D 64 or 128 (the wrapper's `flash_body` states the same rule and
// counts the tensor-core launches by it):
// * bf16 at D 64 and 128, the tensor-core body. Blocks of 4 warps. In the
//   dK/dV pass each warp owns 16 keys and forms S^T = K Q^T and dP^T =
//   V dO^T with mma.sync.m16n8k16 (bf16 in, f32 accumulate; K and V as A
//   fragments by ldmatrix, Q and dO rows as B fragments), so the key rows
//   of the accumulators are already the rows of dK and dV: P^T and dS^T are
//   formed in registers, rounded to bf16 straight into A fragments, and
//   dV += P^T dO, dK += dS^T Q read dO and Q with ldmatrix.trans. Q, dO and
//   the rows of lse and delta stream through a two-stage cp.async ring of
//   32-row q tiles. The dQ pass mirrors it on 64-row q blocks with K and V
//   double-buffered (64-key tiles): S = Q K^T, dP = dO V^T, dS in
//   registers, dQ += dS K with K by ldmatrix.trans. Tiles
//   live in bf16 shared memory with rows padded by 8 elements (ldmatrix is
//   then free of bank conflicts); masks are applied only on tiles that
//   cross the diagonal or an edge (every tile in position mode), and a warp
//   skips a causal tile it cannot see. dK is scaled once in the epilogue;
//   dQ, dK and dV are stored with 16-byte stores through their own
//   strides, staged through the warp's own rows of the Q / K / V buffers.
//   Every operand's base and (batch, seq, head) strides must be multiples
//   of 16 bytes (the copies' alignment); the wrapper refuses others.
// * f32 at every D and bf16 at D 256: the FMA body. f32 keeps
//   full-precision products (TF32 would break its 1e-4 checks); no model
//   on the port's paths uses D 256. Tiles of 64 (32 at D = 256) staged in
//   shared memory as f32 padded to D + 1; S and dP re-formed with f32 FMAs
//   (16 x 16 threads), P and dS through shared memory.
// Every operand is read through its own (batch, seq, head) strides with a
// contiguous last dim; keys and queries past the sequence ends are masked
// in the kernel, so no padding is needed. Later work: wgmma with TMA and
// warp specialisation, and tensor cores at D 256.

#include <limits.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using namespace ptt;

constexpr int NT = 256;  // the delta pass and the FMA body

// element strides (batch, seq, head) of each [B, S, H, D] operand
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

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

// ------------------------------------------------ the FMA body
namespace body_fma {

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

template <typename T, int D, bool POS>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
flash_bwd_dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
      flash_bwd_dkv_fma_kernel<T, D, POS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_fma_kernel<T, D, POS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_fma_kernel<T, D, POS>
      <<<dim3((Sk + BT - 1) / BT, B * H), NT, smem, stream>>>(
          q, k, v, g, lse, delta, qpos, kpos, dk, dv, H, Sq, Sk, st, causal,
          scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_fma_kernel<T, D, POS>
      <<<dim3((Sq + BT - 1) / BT, B * H), NT, smem, stream>>>(
          q, k, v, g, lse, delta, qpos, kpos, dq, H, Sq, Sk, st, causal,
          scale);
  return cudaGetLastError();
}

}  // namespace body_fma

// ------------------------------------------------ the tensor-core body
namespace body_tc {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// dK/dV pass: a block of NW warps owns BK = 16 NW keys (16 a warp) and
// walks q tiles of BQ rows; dQ pass: a block of NW warps owns BQ2 = 16 NW
// query rows and walks k tiles of BK2 keys. 32-row q tiles keep the
// 16 x 32 score tiles small beside the dK and dV accumulators. At D = 64
// both passes are held to 168 registers a thread, so three blocks share an
// SM (faster on the H100 than two blocks of unbounded registers, and free
// of spills); at D = 128 the accumulators need more, two blocks an SM.
template <int D>
struct Shape {
  static constexpr int NW = 4;
  static constexpr int NT = 32 * NW;
  static constexpr int LD = D + 8;  // padded row
  static constexpr int BK = 16 * NW;
  static constexpr int BQ = 32;
  static constexpr int BQ2 = 16 * NW;
  static constexpr int BK2 = 64;
  static constexpr size_t smem_dkv =
      sizeof(bf16) * static_cast<size_t>(2 * BK + 4 * BQ) * LD +
      sizeof(float) * 4 * BQ + sizeof(int) * (2 * BQ + BK);
  static constexpr size_t smem_dq =
      sizeof(bf16) * static_cast<size_t>(2 * BQ2 + 4 * BK2) * LD +
      sizeof(int) * (BQ2 + 2 * BK2);
  // blocks an SM that ptxas must allow each pass
  static constexpr int MINB = D == 64 ? 3 : 1;
};

template <int D, bool POS>
__global__ void __launch_bounds__(Shape<D>::NT, Shape<D>::MINB)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ qpos,
                        const int* __restrict__ kpos, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int H, int Sq, int Sk,
                        Strides st, int causal, float scale) {
  using S = Shape<D>;
  constexpr int NT = S::NT, LD = S::LD, BK = S::BK, BQ = S::BQ, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD]
  bf16* sV = sK + BK * LD;                       // [BK][LD]
  bf16* sQ = sV + BK * LD;                       // [2][BQ][LD]
  bf16* sG = sQ + 2 * BQ * LD;                   // dO [2][BQ][LD]
  float* sL = reinterpret_cast<float*>(sG + 2 * BQ * LD);  // lse [2][BQ]
  float* sD = sL + 2 * BQ;                       // delta [2][BQ]
  int* sQp = reinterpret_cast<int*>(sD + 2 * BQ);  // [2][BQ] (POS)
  int* sKp = sQp + 2 * BQ;                         // [BK] (POS)

  const int k0 = blockIdx.x * BK;  // the longest causal walks first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int kw = k0 + warp * 16;  // the warp's first key
  const bf16* qb = q + b * st.q[0] + h * st.q[2];
  const bf16* kb = k + b * st.k[0] + h * st.k[2];
  const bf16* vb = v + b * st.v[0] + h * st.v[2];
  const bf16* gb = g + b * st.g[0] + h * st.g[2];
  const float* lrow = lse + static_cast<size_t>(bh) * Sq;
  const float* drow = delta + static_cast<size_t>(bh) * Sq;

  for (int i = tid; i < BK * CH; i += NT) {  // rows past Sk read as zeros
    const int r = i / CH, c = i % CH, s = k0 + r;
    const long long row = s < Sk ? s : 0;
    cp_async16(sK + r * LD + 8 * c, kb + row * st.k[1] + 8 * c, s < Sk);
    cp_async16(sV + r * LD + 8 * c, vb + row * st.v[1] + 8 * c, s < Sk);
  }
  // POS: the positions of this thread's two keys and the tile's smallest
  int kmin = INT_MAX, kp0 = INT_MAX, kp1 = INT_MAX;
  if (POS) {
    for (int i = tid; i < BK; i += NT)
      sKp[i] = k0 + i < Sk ? kpos[k0 + i] : INT_MAX;
    __syncthreads();
    for (int i = 0; i < BK; ++i) kmin = min(kmin, sKp[i]);
    kp0 = sKp[warp * 16 + gq];
    kp1 = sKp[warp * 16 + gq + 8];
  }

  const int nq = (Sq + BQ - 1) / BQ;
  // Q, dO, lse and delta rows [t * BQ, t * BQ + BQ) into stage st (zeros
  // past Sq)
  auto load_q = [&](int t, int stg) {
    bf16* dq_ = sQ + stg * BQ * LD;
    bf16* dg = sG + stg * BQ * LD;
    for (int i = tid; i < BQ * CH; i += NT) {
      const int r = i / CH, c = i % CH, s = t * BQ + r;
      const long long row = s < Sq ? s : 0;
      cp_async16(dq_ + r * LD + 8 * c, qb + row * st.q[1] + 8 * c, s < Sq);
      cp_async16(dg + r * LD + 8 * c, gb + row * st.g[1] + 8 * c, s < Sq);
    }
    for (int i = tid; i < BQ; i += NT) {
      const int s = t * BQ + i;
      cp_async4(sL + stg * BQ + i, lrow + (s < Sq ? s : 0), s < Sq);
      cp_async4(sD + stg * BQ + i, drow + (s < Sq ? s : 0), s < Sq);
    }
  };
  // the first q tile from t on with a query that sees a key of this tile
  // (nq if none), its positions left in buf; every tile without positions
  auto next_live = [&](int t, int* buf) {
    if (!POS) return t;
    for (; t < nq; ++t) {
      int seen = 0;
      for (int i = tid; i < BQ; i += NT) {
        const int s = t * BQ + i;
        const int p = s < Sq ? qpos[s] : INT_MIN;
        buf[i] = p;
        seen |= s < Sq && p >= kmin;
      }
      if (__syncthreads_or(seen)) break;
    }
    return t;
  };

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;
  const float sl2 = scale * kLog2e;

  // top-left causal: rows i >= k0 see this tile, the first in q tile k0/BQ
  int qt = next_live(causal && !POS ? k0 / BQ : 0, sQp);
  if (qt < nq) load_q(qt, 0);
  cp_async_commit();  // group: K, V and the first q tile
  for (int stg = 0; qt < nq; stg ^= 1) {
    __syncthreads();  // every reader of stage stg ^ 1 (the last tile) is done
    const int nxt = next_live(qt + 1, sQp + (stg ^ 1) * BQ);
    if (nxt < nq) load_q(nxt, stg ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this q tile (and K, V) landed for this thread ...
    __syncthreads();     // ... and for every thread
    const int q0 = qt * BQ;
    qt = nxt;
    // a causal q tile before every key of the warp adds nothing to it
    if (!POS && causal && kw > q0 + BQ - 1) continue;
    const bf16* tQ = sQ + stg * BQ * LD;
    const bf16* tG = sG + stg * BQ * LD;
    const float* tL = sL + stg * BQ;
    const float* tD = sD + stg * BQ;
    const int* tQp = sQp + stg * BQ;

    // S^T = K Q^T and dP^T = V dO^T: rows are the warp's 16 keys
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kf[4], vf[4];
      ldsm_x4(kf, a_frag_row(sK, LD, warp * 16, 16 * kk, lane));
      ldsm_x4(vf, a_frag_row(sV, LD, warp * 16, 16 * kk, lane));
#pragma unroll
      for (int jj = 0; jj < BQ / 16; ++jj) {
        uint32_t qf[4], gf[4];
        ldsm_x4(qf, b_frag_row(tQ, LD, 16 * jj, 16 * kk, lane));
        mma_bf16(s[2 * jj], kf, qf[0], qf[1]);
        mma_bf16(s[2 * jj + 1], kf, qf[2], qf[3]);
        ldsm_x4(gf, b_frag_row(tG, LD, 16 * jj, 16 * kk, lane));
        mma_bf16(dp[2 * jj], vf, gf[0], gf[1]);
        mma_bf16(dp[2 * jj + 1], vf, gf[2], gf[3]);
      }
    }
    // P^T = exp(S^T scale - lse), exactly 0 where masked; dS^T = P^T
    // (dP^T - delta), both still f32
    const bool edge = POS || q0 + BQ > Sq || k0 + BK > Sk ||
                      (causal && kw + 15 > q0);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tq + (e & 1), qi = q0 + c;
        const int kj = kw + gq + 8 * (e >> 1);
        const bool keep =
            !edge || (qi < Sq && kj < Sk &&
                      (POS ? tQp[c] >= (e < 2 ? kp0 : kp1)
                           : (!causal || kj <= qi)));
        const float p =
            keep ? exp2f(fmaf(s[j][e], sl2, -tL[c] * kLog2e)) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - tD[c]);
      }
    // dV += bf(P^T) dO and dK += bf(dS^T) Q over the tile's q rows
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t gf[4], qf[4];
        ldsm_x4_t(gf, bt_frag_row(tG, LD, 16 * kk, 16 * dd, lane));
        mma_bf16(adv[2 * dd], pa, gf[0], gf[1]);
        mma_bf16(adv[2 * dd + 1], pa, gf[2], gf[3]);
        ldsm_x4_t(qf, bt_frag_row(tQ, LD, 16 * kk, 16 * dd, lane));
        mma_bf16(adk[2 * dd], da, qf[0], qf[1]);
        mma_bf16(adk[2 * dd + 1], da, qf[2], qf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // no copy into K's or V's rows is in flight

  // the warp's K and V rows are its own: they stage dK and dV
  store_rows<D>(adk, scale, scale, sK + warp * 16 * LD, LD,
                dk + b * st.dk[0] + h * st.dk[2], st.dk[1], kw, Sk, lane);
  store_rows<D>(adv, 1.f, 1.f, sV + warp * 16 * LD, LD,
                dv + b * st.dv[0] + h * st.dv[2], st.dv[1], kw, Sk, lane);
}

template <int D, bool POS>
__global__ void __launch_bounds__(Shape<D>::NT, Shape<D>::MINB)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ g,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ qpos,
                       const int* __restrict__ kpos, bf16* __restrict__ dq,
                       int H, int Sq, int Sk, Strides st, int causal,
                       float scale) {
  using S = Shape<D>;
  constexpr int NT = S::NT, LD = S::LD, BK = S::BK2, BQ = S::BQ2, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);         // [BQ][LD]
  bf16* sG = sQ + BQ * LD;                              // dO [BQ][LD]
  bf16* sK = sG + BQ * LD;                              // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;                          // [2][BK][LD]
  int* sQp = reinterpret_cast<int*>(sV + 2 * BK * LD);  // [BQ] (POS)
  int* sKp = sQp + BQ;                                  // [2][BK] (POS)

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int qw = q0 + warp * 16;  // the warp's first query row
  const bf16* qb = q + b * st.q[0] + h * st.q[2];
  const bf16* kb = k + b * st.k[0] + h * st.k[2];
  const bf16* vb = v + b * st.v[0] + h * st.v[2];
  const bf16* gb = g + b * st.g[0] + h * st.g[2];

  for (int i = tid; i < BQ * CH; i += NT) {  // rows past Sq read as zeros
    const int r = i / CH, c = i % CH, s = q0 + r;
    const long long row = s < Sq ? s : 0;
    cp_async16(sQ + r * LD + 8 * c, qb + row * st.q[1] + 8 * c, s < Sq);
    cp_async16(sG + r * LD + 8 * c, gb + row * st.g[1] + 8 * c, s < Sq);
  }
  // lse (log2 domain) and delta of this thread's rows qw + gq and + 8
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + gq + 8 * r;
    const size_t at = static_cast<size_t>(bh) * Sq + (qi < Sq ? qi : 0);
    l2[r] = qi < Sq ? lse[at] * kLog2e : 0.f;
    dl[r] = qi < Sq ? delta[at] : 0.f;
  }
  // POS: the positions of this thread's two rows and the tile's largest
  int qmax = INT_MIN, qp0 = INT_MIN, qp1 = INT_MIN;
  if (POS) {
    for (int i = tid; i < BQ; i += NT)
      sQp[i] = q0 + i < Sq ? qpos[q0 + i] : INT_MIN;
    __syncthreads();
    for (int i = 0; i < BQ; ++i) qmax = max(qmax, sQp[i]);
    qp0 = sQp[warp * 16 + gq];
    qp1 = sQp[warp * 16 + gq + 8];
  }

  int nk = (Sk + BK - 1) / BK;
  if (causal && !POS) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  auto load_kv = [&](int t, int stg) {
    bf16* dk_ = sK + stg * BK * LD;
    bf16* dv_ = sV + stg * BK * LD;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = i % CH, s = t * BK + r;
      const long long row = s < Sk ? s : 0;
      cp_async16(dk_ + r * LD + 8 * c, kb + row * st.k[1] + 8 * c, s < Sk);
      cp_async16(dv_ + r * LD + 8 * c, vb + row * st.v[1] + 8 * c, s < Sk);
    }
  };
  auto next_live = [&](int t, int* buf) {
    if (!POS) return t;
    for (; t < nk; ++t) {
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

  float adq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[j][e] = 0.f;
  const float sl2 = scale * kLog2e;

  int kt = next_live(0, sKp);
  if (kt < nk) load_kv(kt, 0);
  cp_async_commit();  // group: Q, dO and the first K/V tile
  for (int stg = 0; kt < nk; stg ^= 1) {
    __syncthreads();  // every reader of stage stg ^ 1 (the last tile) is done
    const int nxt = next_live(kt + 1, sKp + (stg ^ 1) * BK);
    if (nxt < nk) load_kv(nxt, stg ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * BK;
    kt = nxt;
    if (!POS && causal && k0 > qw + 15) continue;
    const bf16* tK = sK + stg * BK * LD;
    const bf16* tV = sV + stg * BK * LD;

    // S = Q K^T and dP = dO V^T: rows are the warp's 16 queries
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4], gf[4];
      ldsm_x4(qf, a_frag_row(sQ, LD, warp * 16, 16 * kk, lane));
      ldsm_x4(gf, a_frag_row(sG, LD, warp * 16, 16 * kk, lane));
#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, b_frag_row(tK, LD, 16 * jj, 16 * kk, lane));
        mma_bf16(s[2 * jj], qf, kf[0], kf[1]);
        mma_bf16(s[2 * jj + 1], qf, kf[2], kf[3]);
        ldsm_x4(vf, b_frag_row(tV, LD, 16 * jj, 16 * kk, lane));
        mma_bf16(dp[2 * jj], gf, vf[0], vf[1]);
        mma_bf16(dp[2 * jj + 1], gf, vf[2], vf[3]);
      }
    }
    // dS = P (dP - delta) with P = exp(S scale - lse), 0 where masked
    // (rows past Sq are never stored, so only keys are masked there)
    const bool edge = POS || k0 + BK > Sk || (causal && k0 + BK - 1 > qw);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tq + (e & 1), kj = k0 + c;
        const int r = e >> 1, qi = qw + gq + 8 * r;
        const bool keep =
            !edge || (kj < Sk && (POS ? (r ? qp1 : qp0) >= sKp[stg * BK + c]
                                      : (!causal || kj <= qi)));
        const float p = keep ? exp2f(fmaf(s[j][e], sl2, -l2[r])) : 0.f;
        dp[j][e] = p * (dp[j][e] - dl[r]);
      }
    // dQ += bf(dS) K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t kf[4];
        ldsm_x4_t(kf, bt_frag_row(tK, LD, 16 * kk, 16 * dd, lane));
        mma_bf16(adq[2 * dd], da, kf[0], kf[1]);
        mma_bf16(adq[2 * dd + 1], da, kf[2], kf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // no copy into Q's rows is in flight

  store_rows<D>(adq, scale, scale, sQ + warp * 16 * LD, LD,
                dq + b * st.dq[0] + h * st.dq[2], st.dq[1], qw, Sq, lane);
}

template <int D, bool POS>
cudaError_t launch_passes(const bf16* q, const bf16* k, const bf16* v,
                          const bf16* g, const float* lse, const float* delta,
                          const int* qpos, const int* kpos, bf16* dq,
                          bf16* dk, bf16* dv, int B, int H, int Sq, int Sk,
                          const Strides& st, int causal, float scale,
                          cudaStream_t stream) {
  using S = Shape<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<D, POS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::smem_dkv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D, POS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::smem_dq));
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_tc_kernel<D, POS>
      <<<dim3((Sk + S::BK - 1) / S::BK, B * H), S::NT, S::smem_dkv,
         stream>>>(q, k, v, g, lse, delta, qpos, kpos, dk, dv, H, Sq, Sk, st,
                   causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc_kernel<D, POS>
      <<<dim3((Sq + S::BQ2 - 1) / S::BQ2, B * H), S::NT, S::smem_dq,
         stream>>>(q, k, v, g, lse, delta, qpos, kpos, dq, H, Sq, Sk, st,
                   causal, scale);
  return cudaGetLastError();
}

}  // namespace body_tc

// ------------------------------------------------ dispatch
// the body of a (dtype, D) case: tensor cores for bf16 at D 64 and 128,
// the FMA body for f32 and for bf16 at D 256
constexpr bool tc_body(int dtype, int D) {
  return dtype == kBF16 && (D == 64 || D == 128);
}

template <typename T>
constexpr int dtype_code() {
  return std::is_same<T, float>::value ? kF32 : kBF16;
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
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  if constexpr (tc_body(dtype_code<T>(), D)) {
    if (qpos != nullptr)
      return body_tc::launch_passes<D, true>(qt, kt, vt, gt, lse, delta, qpos,
                                        kpos, dqt, dkt, dvt, B, H, Sq, Sk, st,
                                        causal, scale, stream);
    return body_tc::launch_passes<D, false>(qt, kt, vt, gt, lse, delta, qpos, kpos,
                                       dqt, dkt, dvt, B, H, Sq, Sk, st,
                                       causal, scale, stream);
  } else {
    if (qpos != nullptr)
      return body_fma::launch_passes<T, D, true>(qt, kt, vt, gt, lse, delta, qpos,
                                            kpos, dqt, dkt, dvt, B, H, Sq, Sk,
                                            st, causal, scale, stream);
    return body_fma::launch_passes<T, D, false>(qt, kt, vt, gt, lse, delta, qpos,
                                           kpos, dqt, dkt, dvt, B, H, Sq, Sk,
                                           st, causal, scale, stream);
  }
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
// operands (all one dtype); D in {64, 128, 256}. The tensor-core body (bf16,
// D 64 or 128) also needs 16-byte aligned bases and strides, which the
// caller checks. Returns the cudaError_t of the launches.
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
