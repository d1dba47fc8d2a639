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
// per byte: far below the ~295 the card needs before compute matters. So
// the work per weight byte must stay small enough that issuing it never
// binds before the bytes do, and enough bytes must be in flight.
//
// Two bodies; the wrapper picks one (ops/cuda/quant_matmul.py
// `quant_body`).
//
// The tensor-core body (bf16 x). One mma.sync m16n8k16 (bf16 in, f32
// accumulate) takes the weight as its A operand (16 output columns x 16
// k) and x as its B operand (16 k x 8 rows of x), so the 8 rows of a
// decode step fill the n8 side exactly. A block of 4 warps owns 128
// columns and up to 64 rows of x (8 n8 tiles that all reuse each
// dequantized A fragment: the 40 rows of a spec-verify step dequantize a
// weight once, not five times). The weight reaches shared memory as
// stored, 64 byte rows of 128 columns a stage, through a 4-stage ring of
// 16-byte cp.async copies (with the matching k range of x beside it), so
// up to three stages of every resident block are in flight while one
// computes. Rows are padded (144 bytes a row for int8, 160 for int4) so
// that fragment reads hit 32 distinct banks. The mma's 16 output rows are
// assigned so that a lane's rows g and g + 8 of two neighbouring m16
// tiles are the 4 adjacent columns 4g .. 4g + 3 of the warp's 32: one
// 32-bit shared load then gives a lane 4 columns of one k row. int8
// values become bf16 by a byte permute under the exponent of 2^23 and one
// f32 subtract (exact), the pair of k rows packed by a byte permute of the
// two high halves; an int4 byte already holds the (2k, 2k + 1) pair of
// one column, and its two nibbles become a bf16 pair by one permute, one
// logic op and one bf16x2 subtract (exact). K is split over blocks to fill
// the card; the splits' f32 partials go to a workspace [splits, M, N] and
// the last block of an output tile to arrive (an int32 counter per tile,
// which it resets) sums them in split order, then applies scale, bias and
// the cast: one launch a call, deterministic, with nothing read on the
// host.
//
// The FMA body (f32 x, whose 1e-4 checks TF32 products would break; and
// the yardstick the tensor-core body replaced). Every weight byte is read
// from device memory once per 8 rows of x (the 8-row tiles of one weight
// stretch are neighbouring blocks, so further tiles find it in L2), and
// the card is kept full at decode shapes by splitting K. A block is 256
// threads for one (8-row tile of x, K split, 128-column tile of w): each
// lane owns 4 columns, so a warp reads one 128-byte stretch of a weight
// row with one 4-byte load a lane. Each of the 8 warps takes its own
// contiguous run of the split's weight rows and streams it in batches of
// 4 rows held in registers. x is read straight from L1. The warps'
// partial sums meet in shared memory and go to an f32 workspace [splits,
// M, N]; a second kernel sums the splits in order and applies scale, bias
// and the cast. At 8 rows each weight value feeds 8 FMAs plus its
// dequant and the x unpacks, about 50 instructions a 4-byte word: issue
// binds it at ~4x its byte bound. The TPU kernel's even/odd split of the
// activation is a TPU layout trick and is not carried over.

#include "common.cuh"
#include "tensor_core.cuh"

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


// ----------------------------------------------------- tensor-core body
namespace tc {

constexpr int kThreads = 128;  // 4 warps of 32 columns each
constexpr int kBN = 128;       // columns a block
constexpr int kBM = 64;        // rows of x a block (up to 8 n8 tiles)
constexpr int kWRows = 64;     // weight byte rows a stage
constexpr int kStages = 4;
// blocks an SM must hold, which caps the registers a thread: 4 (128
// registers) at the decode rows (up to 16 rows of x), 2 above
template <int NT>
constexpr int kMinBlocks = NT <= 2 ? 4 : 2;

template <bool INT4, int NT>
struct Shape {
  static constexpr int KS = INT4 ? 128 : 64;   // k values a stage
  static constexpr int WP = INT4 ? 160 : 144;  // weight row pitch, bytes
  static constexpr int XP = KS * 2 + 16;       // x row pitch, bytes
  static constexpr int STAGE = kWRows * WP + NT * 8 * XP;
  static constexpr size_t smem = static_cast<size_t>(kStages) * STAGE;
};

// int8 columns j of the k-row words lo and hi (each already ^ 0x80808080,
// so a byte is the value + 128) as one bf16 pair (lo in the low half):
// exact through f32, then the two high halves
__device__ __forceinline__ uint32_t i8_pair(uint32_t lo, uint32_t hi,
                                            int j) {
  const float a =
      __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  const float b =
      __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// byte j of packed int4 columns (v ^ 0x88888888, so a nibble is the value
// + 8; vs = that >> 4) as the bf16 pair (low nibble, high nibble): the
// nibbles under the bf16 exponent of 2^7 give 128 + u, less 136
__device__ __forceinline__ uint32_t i4_pair(uint32_t v, uint32_t vs, int j) {
  uint32_t r = __byte_perm(v, vs, 0x0400 + j * 0x0101);
  r = (r & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&r);
  h = __hsub2(h, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&h);
}

// y[m, n0 .. n0 + 3] from the lane's 4 values of row m: to `out` (the last
// step) or to the workspace row
__device__ __forceinline__ void put4(float* __restrict__ dst, const float* v,
                                     int n, int N, bool vec) {
  if (vec) {
    if (n < N)
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (n + i < N) dst[i] = v[i];
}

__device__ __forceinline__ void finish4(__nv_bfloat16* __restrict__ dst,
                                        const float* v,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias,
                                        int n, int N, bool vec) {
  float y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    y[i] = 0.f;
    if (n + i < N) {
      y[i] = v[i] * scale[n + i];
      if (bias != nullptr) y[i] += bias[n + i];
    }
  }
  if (vec) {
    if (n < N)
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (n + i < N) dst[i] = __float2bfloat16(y[i]);
}

// Copy one stage of a split into shared memory: weight byte rows [wr, wr
// + 64) of columns [n0, n0 + 128) into sw (pitch WP; rows at or past wend
// and columns past N read as 0), and x rows [m0, m0 + 8 NT) at k [kb, kb +
// KS) into sx (pitch XP; rows past mt and k at or past k1 read as 0).
template <bool INT4, int NT, bool VECW, bool VECX>
__device__ __forceinline__ void load_stage(
    uint8_t* sw, uint8_t* sx, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ w, int kb, int wr, int wend, int k1, int m0,
    int mt, int n0, int K, int N, int tid) {
  using S = Shape<INT4, NT>;
  constexpr int KS = S::KS, WP = S::WP, XP = S::XP;
  if (VECW) {
#pragma unroll
    for (int c = tid; c < kWRows * 8; c += kThreads) {
      const int r = c >> 3, col = (c & 7) * 16;
      const bool ok = wr + r < wend && n0 + col < N;
      const int8_t* src =
          ok ? w + static_cast<long>(wr + r) * N + n0 + col : w;
      cp_async16(sw + r * WP + col, src, ok);
    }
  } else {
    for (int c = tid; c < kWRows * kBN; c += kThreads) {
      const int r = c / kBN, col = c % kBN;
      const bool ok = wr + r < wend && n0 + col < N;
      sw[r * WP + col] =
          ok ? static_cast<uint8_t>(
                   __ldg(w + static_cast<long>(wr + r) * N + n0 + col))
             : 0;
    }
  }
  constexpr int XC = KS / 8;  // 16-byte chunks of a row of x
  if (VECX) {
#pragma unroll
    for (int c = tid; c < NT * 8 * XC; c += kThreads) {
      const int r = c / XC, kc = (c % XC) * 8;
      const bool ok = r < mt && kb + kc < k1;
      const __nv_bfloat16* src =
          ok ? x + static_cast<long>(m0 + r) * K + kb + kc : x;
      cp_async16(sx + r * XP + kc * 2, src, ok);
    }
  } else {
    for (int c = tid; c < NT * 8 * KS; c += kThreads) {
      const int r = c / KS, kc = c % KS;
      const bool ok = r < mt && kb + kc < k1;
      reinterpret_cast<__nv_bfloat16*>(sx + r * XP)[kc] =
          ok ? x[static_cast<long>(m0 + r) * K + kb + kc]
             : __float2bfloat16(0.f);
    }
  }
}

// x [M, K] bf16; w int8 [K, N] or packed [K / 2, N]; ws f32 [splits, M,
// N] (splits > 1); counters int32, one per (row tile, column tile), zero
// on entry and on exit; out [M, N] bf16. Grid (row tiles of 64, column
// tiles of 128, splits: the blocks that run at once read neighbouring
// column stretches of the same weight rows); k_per_split is a multiple of
// the stage's k range.
// VECW: N % 16 == 0 and w 16-byte aligned; VECX: K % 8 == 0 and x 16-byte
// aligned (else the stage is filled by plain loads).
template <bool INT4, int NT, bool VECW, bool VECX>
__global__ void __launch_bounds__(kThreads, kMinBlocks<NT>)
    quant_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ ws,
                    int* __restrict__ counters,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N,
                    int k_per_split) {
  using S = Shape<INT4, NT>;
  constexpr int KS = S::KS, WP = S::WP, XP = S::XP;
  constexpr int RPK = INT4 ? 2 : 1;  // k values a weight byte row holds
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBM;
  const int mt = min(kBM, M - m0);
  const int live = (mt + 7) / 8;  // n8 tiles holding rows of x
  const int n0 = blockIdx.y * kBN;
  const int splits = gridDim.z, split = blockIdx.z;
  const int k0 = split * k_per_split;
  const int k1 = min(K, k0 + k_per_split);
  const int nst = (k1 - k0 + KS - 1) / KS;
  const int wend = k1 / RPK;  // first weight row past the split

  float acc[2][NT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.f;

  const int wr0 = k0 / RPK;  // the split's first weight row
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst)
      load_stage<INT4, NT, VECW, VECX>(
          smem + s * S::STAGE, smem + s * S::STAGE + kWRows * WP, x, w,
          k0 + s * KS, wr0 + s * kWRows, wend, k1, m0, mt, n0, K, N, tid);
    cp_async_commit();
  }
  const int wcol = warp * 32 + 4 * g;  // the lane's 4 columns in the tile
  for (int i = 0; i < nst; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; slot (i - 1) % kStages is free
    const int nx = i + kStages - 1;
    if (nx < nst) {
      uint8_t* slot = smem + (nx % kStages) * S::STAGE;
      load_stage<INT4, NT, VECW, VECX>(slot, slot + kWRows * WP, x, w,
                                       k0 + nx * KS, wr0 + nx * kWRows, wend,
                                       k1, m0, mt, n0, K, N, tid);
    }
    cp_async_commit();
    const uint8_t* sw = smem + (i % kStages) * S::STAGE;
    const uint8_t* sx = sw + kWRows * WP;
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t a0[4], a1[4];  // the two m16 tiles' A fragments
      if (INT4) {
        const uint8_t* p = sw + (kk * 8 + t) * WP + wcol;
        const uint32_t v0 = *reinterpret_cast<const uint32_t*>(p) ^
                            0x88888888u;
        const uint32_t v1 = *reinterpret_cast<const uint32_t*>(p + 4 * WP) ^
                            0x88888888u;
        const uint32_t s0 = v0 >> 4, s1 = v1 >> 4;
        a0[0] = i4_pair(v0, s0, 0);
        a0[1] = i4_pair(v0, s0, 1);
        a0[2] = i4_pair(v1, s1, 0);
        a0[3] = i4_pair(v1, s1, 1);
        a1[0] = i4_pair(v0, s0, 2);
        a1[1] = i4_pair(v0, s0, 3);
        a1[2] = i4_pair(v1, s1, 2);
        a1[3] = i4_pair(v1, s1, 3);
      } else {
        const uint8_t* p = sw + (kk * 16 + 2 * t) * WP + wcol;
        const uint32_t r0 = *reinterpret_cast<const uint32_t*>(p) ^
                            0x80808080u;
        const uint32_t r1 = *reinterpret_cast<const uint32_t*>(p + WP) ^
                            0x80808080u;
        const uint32_t r8 = *reinterpret_cast<const uint32_t*>(p + 8 * WP) ^
                            0x80808080u;
        const uint32_t r9 = *reinterpret_cast<const uint32_t*>(p + 9 * WP) ^
                            0x80808080u;
        a0[0] = i8_pair(r0, r1, 0);
        a0[1] = i8_pair(r0, r1, 1);
        a0[2] = i8_pair(r8, r9, 0);
        a0[3] = i8_pair(r8, r9, 1);
        a1[0] = i8_pair(r0, r1, 2);
        a1[1] = i8_pair(r0, r1, 3);
        a1[2] = i8_pair(r8, r9, 2);
        a1[3] = i8_pair(r8, r9, 3);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < live) {
          const uint8_t* q = sx + (8 * j + g) * XP + (kk * 16 + 2 * t) * 2;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(q + 16);
          mma_bf16(acc[0][j], a0, b0, b1);
          mma_bf16(acc[1][j], a1, b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();

  // lane (g, t) holds rows 8j + 2t and 8j + 2t + 1 of x at the columns
  // 4g .. 4g + 3 of its warp's 32: tile 0's mma rows g, g + 8, then tile
  // 1's
  const int n = n0 + wcol;
  const bool vec = (N % 4) == 0;
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + 8 * j + 2 * t + r;
        if (j < live && m < M) {
          const float v[4] = {acc[0][j][r], acc[0][j][2 + r], acc[1][j][r],
                              acc[1][j][2 + r]};
          finish4(out + static_cast<long>(m) * N + n, v, scale, bias, n, N,
                  vec);
        }
      }
    return;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + 8 * j + 2 * t + r;
      if (j < live && m < M) {
        const float v[4] = {acc[0][j][r], acc[0][j][2 + r], acc[1][j][r],
                            acc[1][j][2 + r]};
        put4(ws + (static_cast<long>(split) * M + m) * N + n, v, n, N, vec);
      }
    }
  if (!last_to_arrive(counters + blockIdx.y * gridDim.x + blockIdx.x,
                      splits))
    return;
  // the last block of the tile: the splits in order, then scale, bias and
  // the cast. A thread owns R groups of 4 columns of one row; the loads of
  // SB splits of all its groups are issued together before they are added
  // in split order (R * SB <= 8 float4 in flight, or R).
  constexpr int R = NT * 8 * (kBN / 4) / kThreads;
  constexpr int SB = R >= 8 ? 1 : 8 / R;
  const long plane = static_cast<long>(M) * N;
  float v[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) v[r][i] = 0.f;
  for (int s0 = 0; s0 < splits; s0 += SB) {
    float4 p[SB][R];
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = tid + r * kThreads;
        const int m = m0 + c / (kBN / 4);
        const int nn = n0 + (c % (kBN / 4)) * 4;
        p[j][r] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (s0 + j >= splits || m >= m0 + mt || nn >= N) continue;
        const float* at = ws + (s0 + j) * plane + static_cast<long>(m) * N +
                          nn;
        if (vec) {
          p[j][r] = __ldcg(reinterpret_cast<const float4*>(at));
        } else {
          p[j][r].x = __ldcg(at);
          if (nn + 1 < N) p[j][r].y = __ldcg(at + 1);
          if (nn + 2 < N) p[j][r].z = __ldcg(at + 2);
          if (nn + 3 < N) p[j][r].w = __ldcg(at + 3);
        }
      }
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[r][0] += p[j][r].x;
        v[r][1] += p[j][r].y;
        v[r][2] += p[j][r].z;
        v[r][3] += p[j][r].w;
      }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = tid + r * kThreads;
    const int m = m0 + c / (kBN / 4);
    const int nn = n0 + (c % (kBN / 4)) * 4;
    if (m < m0 + mt && nn < N)
      finish4(out + static_cast<long>(m) * N + nn, v[r], scale, bias, nn, N,
              vec);
  }
}

template <bool INT4, int NT, bool VECW, bool VECX>
cudaError_t launch_nt(const void* x, const void* w, const float* scale,
                      const float* bias, float* ws, int* counters, void* out,
                      int M, int K, int N, int splits, int kps,
                      cudaStream_t st) {
  constexpr size_t smem = Shape<INT4, NT>::smem;
  auto* kernel = quant_tc_kernel<INT4, NT, VECW, VECX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, splits);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      scale, bias, ws, counters, static_cast<__nv_bfloat16*>(out), M, K, N,
      kps);
  return cudaGetLastError();
}

template <bool INT4, bool VECW, bool VECX>
cudaError_t launch_v(const void* x, const void* w, const float* scale,
                     const float* bias, float* ws, int* counters, void* out,
                     int M, int K, int N, int splits, int kps,
                     cudaStream_t st) {
  // the n8 tiles that hold a block's rows (M > 64 takes 8)
  switch ((min(M, kBM) + 7) / 8) {
#define PTT_NT(nt)                                                          \
  case nt:                                                                  \
    return launch_nt<INT4, nt, VECW, VECX>(x, w, scale, bias, ws, counters, \
                                           out, M, K, N, splits, kps, st);
    PTT_NT(1)
    PTT_NT(2)
    PTT_NT(3)
    PTT_NT(4)
    PTT_NT(5)
    PTT_NT(6)
    PTT_NT(7)
#undef PTT_NT
    default:
      return launch_nt<INT4, 8, VECW, VECX>(x, w, scale, bias, ws, counters,
                                            out, M, K, N, splits, kps, st);
  }
}

template <bool INT4>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* bias, float* ws, int* counters, void* out,
                   int M, int K, int N, int splits, int kps,
                   cudaStream_t st) {
  const bool vecw =
      N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool vecx =
      K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vecw && vecx)
    return launch_v<INT4, true, true>(x, w, scale, bias, ws, counters, out,
                                      M, K, N, splits, kps, st);
  if (vecw)
    return launch_v<INT4, true, false>(x, w, scale, bias, ws, counters, out,
                                       M, K, N, splits, kps, st);
  if (vecx)
    return launch_v<INT4, false, true>(x, w, scale, bias, ws, counters, out,
                                       M, K, N, splits, kps, st);
  return launch_v<INT4, false, false>(x, w, scale, bias, ws, counters, out,
                                      M, K, N, splits, kps, st);
}

}  // namespace tc

}  // namespace

// x [M, K] (f32 or bf16, contiguous); w int8 [K, N], or packed int4
// [K / 2, N] with int4 = 1; scale f32 [N]; bias f32 [N] or null; ws f32
// [splits, M, N] scratch (unused when splits is 1 on the tensor-core
// body); out [M, N] of x's dtype. Split s covers k in [s * k_per_split,
// min(K, (s + 1) * k_per_split)). tc = 1 takes the tensor-core body (bf16
// x only; k_per_split a multiple of 64 for int8, 128 for int4; counters:
// int32, one per (64-row, 128-column) output tile, zero on entry, left
// zero), tc = 0 the FMA body and its epilogue kernel (k_per_split a
// multiple of 8). Returns the cudaError_t of the launches.
extern "C" int quant_matmul(const void* x, const void* w, const void* scale,
                            const void* bias, void* ws, void* counters,
                            void* out, int M, int K, int N, int splits,
                            int k_per_split, int x_dtype, int int4, int tc,
                            void* stream) {
  const int ks = tc ? (int4 ? 128 : 64) : 8;
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 || splits > 65535 ||
      k_per_split <= 0 || k_per_split % ks || (int4 && K % 2) ||
      (N + kBN - 1) / kBN > 65535 ||
      (tc && (x_dtype != kBF16 || (M + tc::kBM - 1) / tc::kBM > 65535 ||
              (splits > 1 && counters == nullptr))))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* wsp = static_cast<float*>(ws);
  if (tc) {
    int* cp = static_cast<int*>(counters);
    return int4 ? tc::launch<true>(x, w, sp, bp, wsp, cp, out, M, K, N,
                                   splits, k_per_split, st)
                : tc::launch<false>(x, w, sp, bp, wsp, cp, out, M, K, N,
                                    splits, k_per_split, st);
  }
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
