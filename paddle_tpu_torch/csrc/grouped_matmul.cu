// Ragged grouped matmul (`ragged_dot` with zeroed tails) over stacked
// expert weights, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/grouped_matmul.py
// `grouped_matmul_pallas` (body `_grouped_kernel`).
//
// What it computes: lhs [M, K] holds the experts' rows back to back, group
// e being the next s_e = max(group_sizes[e], 0) rows (cut where the groups
// run past M). Row l of group e gives out = lhs_row . rhs[e] (rhs [E, K,
// N]), summed in f32 and cast to lhs's dtype, when l < valid_sizes[e] (all
// of the group when valid_sizes is null); every other row, and every row
// past the last group, comes back exactly 0.
//
// What bounds it on the H100: at decode (8 experts with 3 capacity rows
// each on the main path) the expert weight bytes, about 2 flops a byte; at
// a prefill wave (1280 capacity rows an expert) the flops, 2 * rows * K *
// N, on the tensor cores.
//
// What the design does about that: the TPU kernel's scalar-prefetched
// block-to-expert map becomes a lookup each block does itself. Block
// (i, j) takes output column tile j (64 columns) and row tile i of the
// groups laid out with every group padded up to 64 rows (the padding rows
// do not exist in the output); thread 0 walks the E group sizes from
// device memory to find its group, so the routing never leaves the card
// and the caller never syncs. A tile whose rows are all past its group's
// valid count writes zeros and loads nothing, neither activations nor
// weights. Extra row tiles zero the rows past the last group. A live tile
// runs the K loop with 32-deep (bf16) or 16-deep (f32) tiles staged in
// shared memory and the next tile's global loads in flight while the
// current one computes: bf16 on the tensor cores through WMMA 16x16x16
// fragments (4 warps, 32 x 32 outputs each, f32 accumulators), f32 on the
// FMA units (4 x 8 outputs a thread), since tf32 would not hold an f32
// result to 1e-4. Not done yet (later work): wgmma and TMA, larger tiles
// for prefill, split-K for the 14336-deep down projection at decode.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace ptt;

constexpr int kThreads = 128;
constexpr int kBM = 64;  // rows a tile
constexpr int kBN = 64;  // columns a tile

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int BK = 32;
  static constexpr int APAD = 8, BPAD = 8;
};
template <>
struct Cfg<float> {
  static constexpr int BK = 16;
  static constexpr int APAD = 4, BPAD = 4;
};

__device__ __forceinline__ void zero_val(float* v) { *v = 0.f; }
__device__ __forceinline__ void zero_val(__nv_bfloat16* v) {
  *v = __float2bfloat16(0.f);
}

// One thread's share of a ROWS x COLS tile of a row-major matrix: 32 bytes
// of one row (two 16-byte loads where the row is aligned and whole).
template <typename T, int ROWS, int COLS>
struct TileLoad {
  static constexpr int EPT = 32 / static_cast<int>(sizeof(T));
  static constexpr int TPR = COLS / EPT;  // threads a row
  static_assert(ROWS * TPR == kThreads, "tile must take every thread once");
  union {
    uint4 raw[2];
    T v[EPT];
  } u;
  int r, c;

  __device__ __forceinline__ void load(const T* __restrict__ base, long ld,
                                       int rows_ok, int col0, int ncol,
                                       bool vec) {
    r = threadIdx.x / TPR;
    c = (threadIdx.x % TPR) * EPT;
    const int col = col0 + c;
    if (r < rows_ok) {
      const T* p = base + r * ld + col;
      if (vec && col + EPT <= ncol) {
        u.raw[0] = __ldg(reinterpret_cast<const uint4*>(p));
        u.raw[1] = __ldg(reinterpret_cast<const uint4*>(p) + 1);
        return;
      }
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        if (col + e < ncol)
          u.v[e] = p[e];
        else
          zero_val(&u.v[e]);
      }
      return;
    }
    u.raw[0] = make_uint4(0, 0, 0, 0);
    u.raw[1] = make_uint4(0, 0, 0, 0);
  }
};

struct Tile {
  int group;  // -1: no group (past the last one)
  int l0;     // first local row of the tile in its group
  int rows;   // rows of the tile that exist in the output
  int live;   // rows of the tile that are computed (below valid)
  long row0;  // packed row of local row l0
};

// thread 0 maps row tile `ti` to its group; the total rows of all groups
// go to *total
__device__ Tile find_tile(int ti, const int* __restrict__ sizes,
                          const int* __restrict__ valid, int E, int M,
                          int* total) {
  Tile t{-1, 0, 0, 0, 0};
  const long r = static_cast<long>(ti) * kBM;
  long aoff = 0, poff = 0;
  for (int e = 0; e < E; ++e) {
    long s = sizes[e];
    s = s < 0 ? 0 : s;
    s = s > M - poff ? M - poff : s;
    long v = valid != nullptr ? valid[e] : s;
    v = v < 0 ? 0 : (v > s ? s : v);
    const long al = (s + kBM - 1) / kBM * kBM;
    if (t.group < 0 && r >= aoff && r < aoff + al) {
      t.group = e;
      t.l0 = static_cast<int>(r - aoff);
      const long rows = s - t.l0, live = v - t.l0;
      t.rows = static_cast<int>(rows < kBM ? rows : kBM);
      t.live = static_cast<int>(live <= 0 ? 0 : (live < kBM ? live : kBM));
      t.row0 = poff + t.l0;
    }
    aoff += al;
    poff += s;
  }
  *total = static_cast<int>(poff);
  return t;
}

template <typename T>
__device__ void zero_rows(T* __restrict__ out, long row0, int rows, int n0,
                          int N) {
  for (int i = threadIdx.x; i < rows * kBN; i += kThreads) {
    const int rr = i / kBN, cc = i % kBN;
    if (n0 + cc < N) zero_val(out + (row0 + rr) * N + n0 + cc);
  }
}

// the K loop of one live tile: acc += A[live rows] . B, with f32 sums
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int BK = Cfg<T>::BK;
  static constexpr int LDA = BK + Cfg<T>::APAD, LDB = kBN + Cfg<T>::BPAD;
  static constexpr int LDC = kBN + 4;
  // WMMA loads and stores need 256-bit aligned tile pointers
  struct alignas(32) Smem {
    union {
      struct {
        T a[kBM][LDA];
        T b[BK][LDB];
      } ab;
      float c[kBM][LDC];
    };
  };

  static __device__ void run(Smem& sm, const T* __restrict__ A, int K,
                             int live, const T* __restrict__ B, int N,
                             int n0, bool vec_a, bool vec_b,
                             T* __restrict__ out, long row0, int rows) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 1, wn = warp & 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    TileLoad<T, kBM, BK> la;
    TileLoad<T, BK, kBN> lb;
    const int nk = (K + BK - 1) / BK;
    la.load(A, K, live, 0, K, vec_a);
    lb.load(B, N, K, n0, N, vec_b);
    for (int kt = 0; kt < nk; ++kt) {
      *reinterpret_cast<uint4*>(&sm.ab.a[la.r][la.c]) = la.u.raw[0];
      *reinterpret_cast<uint4*>(&sm.ab.a[la.r][la.c + 8]) = la.u.raw[1];
      *reinterpret_cast<uint4*>(&sm.ab.b[lb.r][lb.c]) = lb.u.raw[0];
      *reinterpret_cast<uint4*>(&sm.ab.b[lb.r][lb.c + 8]) = lb.u.raw[1];
      __syncthreads();
      if (kt + 1 < nk) {  // the next tile's loads fly during the products
        const int k0 = (kt + 1) * BK;
        la.load(A, K, live, k0, K, vec_a);
        lb.load(B + static_cast<long>(k0) * N, N, K - k0, n0, N, vec_b);
      }
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &sm.ab.a[wm * 32 + i * 16][kk], LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &sm.ab.b[kk][wn * 32 + j * 16], LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&sm.c[wm * 32 + i * 16][wn * 32 + j * 16],
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * kBN; i += kThreads) {
      const int rr = i / kBN, cc = i % kBN;
      if (n0 + cc >= N) continue;
      store_f(out + (row0 + rr) * N + n0 + cc, rr < live ? sm.c[rr][cc] : 0.f);
    }
  }
};

template <>
struct Mma<float> {
  using T = float;
  static constexpr int BK = Cfg<T>::BK;
  static constexpr int LDA = kBM + Cfg<T>::APAD, LDB = kBN + Cfg<T>::BPAD;
  struct alignas(16) Smem {
    float a[BK][LDA];  // transposed: a[k][m]
    float b[BK][LDB];
  };

  static __device__ void run(Smem& sm, const T* __restrict__ A, int K,
                             int live, const T* __restrict__ B, int N,
                             int n0, bool vec_a, bool vec_b,
                             T* __restrict__ out, long row0, int rows) {
    const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;  // 16 x 8
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    TileLoad<T, kBM, BK> la;
    TileLoad<T, BK, kBN> lb;
    const int nk = (K + BK - 1) / BK;
    la.load(A, K, live, 0, K, vec_a);
    lb.load(B, N, K, n0, N, vec_b);
    for (int kt = 0; kt < nk; ++kt) {
#pragma unroll
      for (int e = 0; e < TileLoad<T, kBM, BK>::EPT; ++e)
        sm.a[la.c + e][la.r] = la.u.v[e];
      *reinterpret_cast<uint4*>(&sm.b[lb.r][lb.c]) = lb.u.raw[0];
      *reinterpret_cast<uint4*>(&sm.b[lb.r][lb.c + 4]) = lb.u.raw[1];
      __syncthreads();
      if (kt + 1 < nk) {
        const int k0 = (kt + 1) * BK;
        la.load(A, K, live, k0, K, vec_a);
        lb.load(B + static_cast<long>(k0) * N, N, K - k0, n0, N, vec_b);
      }
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&sm.a[k][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[k][tx * 8]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&sm.b[k][tx * 8 + 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty * 4 + i;
      if (rr >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx * 8 + j;
        if (n < N) out[(row0 + rr) * N + n] = rr < live ? acc[i][j] : 0.f;
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_matmul_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                          const int* __restrict__ sizes,
                          const int* __restrict__ valid, T* __restrict__ out,
                          int M, int K, int N, int E, int group_tiles,
                          bool vec_a, bool vec_b) {
  __shared__ typename Mma<T>::Smem sm;
  __shared__ Tile tile;
  __shared__ int total;
  if (threadIdx.x == 0) {
    int tot = 0;
    tile = find_tile(blockIdx.x < group_tiles ? blockIdx.x : 0, sizes, valid,
                     E, M, &tot);
    total = tot;
  }
  __syncthreads();
  const int n0 = blockIdx.y * kBN;
  if (blockIdx.x >= group_tiles) {
    // the rows past the last group: [total, M) in kBM-row tiles
    const long r0 = static_cast<long>(blockIdx.x - group_tiles) * kBM;
    const long lo = r0 > total ? r0 : total;
    const long hi = r0 + kBM < M ? r0 + kBM : M;
    if (lo < hi) zero_rows(out, lo, static_cast<int>(hi - lo), n0, N);
    return;
  }
  const Tile t = tile;
  if (t.group < 0 || t.rows <= 0) return;
  if (t.live <= 0) {  // capacity padding only: no loads, exact zeros
    zero_rows(out, t.row0, t.rows, n0, N);
    return;
  }
  Mma<T>::run(sm, lhs + t.row0 * K, K, t.live,
              rhs + static_cast<long>(t.group) * K * N, N, n0, vec_a, vec_b,
              out, t.row0, t.rows);
}

template <typename T>
cudaError_t launch(const void* lhs, const void* rhs, const int* sizes,
                   const int* valid, void* out, int M, int K, int N, int E,
                   cudaStream_t st) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int mt = (M + kBM - 1) / kBM;
  const int group_tiles = mt + E;
  const dim3 grid(group_tiles + mt, (N + kBN - 1) / kBN);
  const bool vec_a =
      K % V == 0 && reinterpret_cast<uintptr_t>(lhs) % 16 == 0;
  const bool vec_b =
      N % V == 0 && reinterpret_cast<uintptr_t>(rhs) % 16 == 0;
  grouped_matmul_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs), sizes, valid,
      static_cast<T*>(out), M, K, N, E, group_tiles, vec_a, vec_b);
  return cudaGetLastError();
}

}  // namespace

// lhs [M, K] and rhs [E, K, N] of one dtype (f32 or bf16), contiguous;
// group_sizes [E] i32 and valid_sizes [E] i32 (or null) on the card; out
// [M, N] of lhs's dtype, every element written. Returns the cudaError_t of
// the launch.
extern "C" int grouped_matmul(const void* lhs, const void* rhs,
                              const void* group_sizes,
                              const void* valid_sizes, void* out, int M,
                              int K, int N, int E, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || E <= 0 ||
      (N + kBN - 1) / kBN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  const int* vs = static_cast<const int*>(valid_sizes);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(lhs, rhs, gs, vs, out, M, K, N, E, st);
  if (dtype == kF32)
    return launch<float>(lhs, rhs, gs, vs, out, M, K, N, E, st);
  return cudaErrorInvalidValue;
}
