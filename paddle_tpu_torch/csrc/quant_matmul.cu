// Weight-only int8 / int4 matmul with the dequant inside the kernel, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/quant_matmul.py
// `quant_matmul_pallas` (bodies `_int8_kernel`, `_int4_kernel`,
// `_epilogue`).
//
// What it computes: y[m, n] = (sum_k x[m, k] * T(w[k, n])) * scale[n]
// (+ bias[n]), cast to T, where T is x's dtype (f32 or bf16), the sum is
// taken in f32 and the scale and bias apply in f32. w is int8 [K, N], or
// int4 packed [K / 2, N]: byte (k2, n) holds row 2 * k2 in its low nibble
// and row 2 * k2 + 1 in its high nibble (two's complement). Every int8 or
// int4 value is exact in bf16, so T(w) is w.
//
// What bounds it on the H100: at the decode rows it serves (M <= 256, 8 to
// 40 on the main path) the weight bytes. An int8 4096 x 11008 weight is
// 45.1 MB, 13.5 us at 3.35 TB/s, against 2 * M * K * N flops, a few flops
// per byte: far below the ~295 the card needs before compute matters.
//
// What the design does about that: every weight byte is read from device
// memory once per 8 rows of x (the 8-row tiles of one weight stretch are
// neighbouring blocks, so further tiles find it in L2), and the card is
// kept full at decode shapes by splitting K. A block is 256 threads for
// one (8-row tile of x, K split, 128-column tile of w): each lane owns 4
// columns, so a warp reads one 128-byte stretch of a weight row with one
// 4-byte load a lane. Each of the 8 warps takes its own contiguous run of
// the split's weight rows and streams it in batches of 4 rows held in
// registers: the next batch's loads are in flight while the current one
// computes, and nothing in the K loop waits at a barrier. At 8 rows of x
// each weight value feeds only 8 FMAs, so its conversion matters: a byte
// permute under a float exponent and one add (exact) replace the int-to-
// float instruction, which runs at an eighth of the FMA rate. x is small
// (8 rows x K) and read straight from L1, 4 consecutive k values of a row
// per 8- or 16-byte load, the same address across the warp. The warps'
// partial sums meet in shared memory and go to an f32 workspace
// [splits, M, N]; a second kernel sums the splits in order and applies
// scale, bias and the cast. The TPU kernel's even/odd split of the
// activation is a TPU layout trick and is not carried over. Measured, not
// yet understood: this sits at 4x its byte bound at 8 rows whatever the
// batch depth, the conversion or a 4-deep cp.async ring of 16-byte copies
// (tried and slower); later work: tensor cores for the larger row counts.

#include "common.cuh"

namespace {

using namespace ptt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 8;            // rows of x per block
constexpr int kBN = 32 * 4;       // columns per block: 4 per lane
constexpr int kU = 4;             // weight rows a batch

// Exact int -> float without I2F (an eighth of the FMA rate): a byte u in
// [0, 256) permuted under the exponent of 2^23 is the float 2^23 + u.
__device__ __forceinline__ float magic(uint32_t u4, int j) {
  return __uint_as_float(__byte_perm(u4, 0x4B000000u, 0x7540 + j));
}

// the 4 signed int8 of v
__device__ __forceinline__ void dequant_i8(uint32_t v, float* f) {
  const uint32_t u = v ^ 0x80808080u;  // b + 128, unsigned
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = magic(u, j) - 8388736.f;
}

// the low and high signed nibbles of the 4 bytes of v
__device__ __forceinline__ void dequant_i4(uint32_t v, float* lo, float* hi) {
  const uint32_t ul = (v & 0x0F0F0F0Fu) ^ 0x08080808u;  // s + 8, unsigned
  const uint32_t uh = ((v >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = magic(ul, j) - 8388616.f;
    hi[j] = magic(uh, j) - 8388616.f;
  }
}

// x[m, k .. k + 3] as floats (0 past K); VEC: one aligned 16- (f32) or
// 8-byte (bf16) load, valid when K % 4 == 0 and k % 4 == 0
template <bool VEC>
__device__ __forceinline__ float4 load_x4(const float* __restrict__ x,
                                          long off, int k, int K) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(x + off));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = k + j < K ? __ldg(x + off + j) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
template <bool VEC>
__device__ __forceinline__ float4 load_x4(const __nv_bfloat16* __restrict__ x,
                                          long off, int k, int K) {
  if (VEC) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(x + off));
    // a bf16 is the high half of the f32 with the same value
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = k + j < K ? __bfloat162float(x[off + j]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// the 4 bytes of weight row `row` at columns n0 .. n0 + 3 as one word
// (columns past N read as 0)
template <bool VEC>
__device__ __forceinline__ uint32_t load_word(const int8_t* __restrict__ w,
                                              long row, int n0, int N) {
  const int8_t* p = w + row * static_cast<long>(N) + n0;
  if (VEC) {
    if (n0 < N) return __ldg(reinterpret_cast<const uint32_t*>(p));
    return 0u;
  }
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n0 + j < N)
      v |= (static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + j))))
           << (8 * j);
  return v;
}

// x [M, K] (T); w int8 [K, N] or packed [K / 2, N]; ws f32 [splits, M, N];
// k_per_split is a multiple of 8
template <typename T, bool INT4, bool VEC, bool VECX>
__global__ void __launch_bounds__(kThreads, 3)
    quant_matmul_kernel(const T* __restrict__ x,
                        const int8_t* __restrict__ w,
                        float* __restrict__ ws, int M, int K, int N,
                        int k_per_split) {
  __shared__ float red[kWarps][kMT][kBN];
  constexpr int RPK = INT4 ? 2 : 1;  // k values a weight row holds
  constexpr int RG = 4 / RPK;        // weight rows per 4 k values
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kMT;
  const int mt = min(kMT, M - m0);  // rows of x in this tile
  const int split = blockIdx.y;
  const int n0 = blockIdx.z * kBN + lane * 4;
  const int k0 = split * k_per_split;
  const int k1 = min(K, k0 + k_per_split);
  // this warp's weight rows of the split: [r_begin, r_end), counted from
  // the split's first row k0 / RPK, a whole number of batches each
  const int nrows = (k1 - k0 + RPK - 1) / RPK;
  const int per_warp = ((nrows + kWarps - 1) / kWarps + kU - 1) / kU * kU;
  const int r_begin = warp * per_warp;
  const int r_end = min(nrows, r_begin + per_warp);
  const long wrow0 = k0 / RPK;

  float acc[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  uint32_t cur[kU], nxt[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u)
    cur[u] = r_begin + u < r_end ? load_word<VEC>(w, wrow0 + r_begin + u, n0,
                                                  N)
                                 : 0u;
  for (int r = r_begin; r < r_end; r += kU) {
    if (r + kU < r_end) {  // the next batch flies while this one computes
#pragma unroll
      for (int u = 0; u < kU; ++u)
        nxt[u] = r + kU + u < r_end
                     ? load_word<VEC>(w, wrow0 + r + kU + u, n0, N)
                     : 0u;
    }
#pragma unroll
    for (int g = 0; g < kU / RG; ++g) {
      if (r + g * RG >= r_end) break;
      // 4 consecutive k values from k (rows past the split are 0 words)
      const int k = k0 + (r + g * RG) * RPK;
      float wf[4][4];  // [k offset][column]
#pragma unroll
      for (int q = 0; q < RG; ++q) {
        if (INT4)
          dequant_i4(cur[g * RG + q], wf[2 * q], wf[2 * q + 1]);
        else
          dequant_i8(cur[g * RG + q], wf[q]);
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m >= mt) break;
        const float4 xv =
            load_x4<VECX>(x, static_cast<long>(m0 + m) * K + k, k, K);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = acc[m][j];
          a = fmaf(xv.x, wf[0][j], a);
          a = fmaf(xv.y, wf[1][j], a);
          a = fmaf(xv.z, wf[2][j], a);
          a = fmaf(xv.w, wf[3][j], a);
          acc[m][j] = a;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
  }

#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][m][lane * 4 + j] = acc[m][j];
  __syncthreads();
  for (int i = tid; i < kMT * kBN; i += kThreads) {
    const int mi = i / kBN, c = i % kBN;
    const int m = m0 + mi, n = blockIdx.z * kBN + c;
    if (m >= M || n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += red[wi][mi][c];
    ws[(static_cast<long>(split) * M + m) * N + n] = sum;
  }
}

// out[m, n] = T((sum_s ws[s, m, n]) * scale[n] + bias[n])
template <typename T>
__global__ void quant_matmul_epilogue(const float* __restrict__ ws,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ bias,
                                      T* __restrict__ out, int M, int N,
                                      int splits) {
  const long total = static_cast<long>(M) * N;
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[sp * total + i];
    const int n = static_cast<int>(i % N);
    float y = s * scale[n];
    if (bias != nullptr) y += bias[n];
    store_f(out + i, y);
  }
}

template <typename T, bool INT4>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* bias, float* ws, void* out, int M, int K,
                   int N, int splits, int kps, cudaStream_t st) {
  const dim3 grid((M + kMT - 1) / kMT, splits, (N + kBN - 1) / kBN);
  const bool vec = (N % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  const bool vecx = (K % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0);
  const T* xp = static_cast<const T*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  if (vec && vecx)
    quant_matmul_kernel<T, INT4, true, true>
        <<<grid, kThreads, 0, st>>>(xp, wp, ws, M, K, N, kps);
  else if (vec)
    quant_matmul_kernel<T, INT4, true, false>
        <<<grid, kThreads, 0, st>>>(xp, wp, ws, M, K, N, kps);
  else
    quant_matmul_kernel<T, INT4, false, false>
        <<<grid, kThreads, 0, st>>>(xp, wp, ws, M, K, N, kps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long total = static_cast<long>(M) * N;
  const long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  quant_matmul_epilogue<T><<<blocks, 256, 0, st>>>(
      ws, scale, bias, static_cast<T*>(out), M, N, splits);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] (f32 or bf16, contiguous); w int8 [K, N], or packed int4
// [K / 2, N] with int4 = 1; scale f32 [N]; bias f32 [N] or null; ws f32
// [splits, M, N] scratch; out [M, N] of x's dtype. Split s covers k in
// [s * k_per_split, min(K, (s + 1) * k_per_split)); k_per_split is a
// multiple of 8. Returns the cudaError_t of the launches.
extern "C" int quant_matmul(const void* x, const void* w, const void* scale,
                            const void* bias, void* ws, void* out, int M,
                            int K, int N, int splits, int k_per_split,
                            int x_dtype, int int4, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 || splits > 65535 ||
      k_per_split <= 0 || k_per_split % 8 || (int4 && K % 2) ||
      (N + kBN - 1) / kBN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* wsp = static_cast<float*>(ws);
  if (x_dtype == kBF16)
    return int4 ? launch<__nv_bfloat16, true>(x, w, sp, bp, wsp, out, M, K,
                                              N, splits, k_per_split, st)
                : launch<__nv_bfloat16, false>(x, w, sp, bp, wsp, out, M, K,
                                               N, splits, k_per_split, st);
  if (x_dtype == kF32)
    return int4 ? launch<float, true>(x, w, sp, bp, wsp, out, M, K, N,
                                      splits, k_per_split, st)
                : launch<float, false>(x, w, sp, bp, wsp, out, M, K, N,
                                       splits, k_per_split, st);
  return cudaErrorInvalidValue;
}
