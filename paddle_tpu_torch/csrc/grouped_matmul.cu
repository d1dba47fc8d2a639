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
// Two bodies, chosen by the caller from host-known shapes (`grouped_body`
// in ops/cuda/grouped_matmul.py) and passed as `body`:
//
// * the wgmma body (1): bf16 with M / E >= 64 capacity rows an expert and
//   K, N multiples of 8 (TMA needs 16-byte global strides), i.e. prefill
//   waves, where the work is a plain large GEMM far above the card's ridge
//   and only wgmma reaches the tensor cores' rate. A block computes a 128
//   x BN output tile (BN 256 when N >= 1024, else 128) of one group: one
//   producer warp keeps TMA loads of A [128 rows, 64] (a 2-D tensor map
//   over lhs [M, K]: a group's rows start at any row, since TMA
//   coordinates are element indices, so nothing is padded or copied) and
//   B [64, BN] (a 3-D map over rhs [E, K, N], BN / 64 boxes of 64 columns)
//   in flight through a four-stage ring on mbarriers; two consumer
//   warpgroups each run wgmma.m64n128k16 (A K-major, B N-major through the
//   transpose bit, both in 128-byte swizzled shared memory) on 64 of the
//   rows, f32 accumulators in registers. Rows of a box that belong to the
//   next group, or lie past M (zero-filled by TMA), are computed and never
//   stored. The epilogue rounds to bf16 in registers and stores straight
//   to global memory with the row mask. Blocks run over (row tile, column
//   tile) pairs in groups of 16 row tiles, so the A rows and B columns that
//   concurrent blocks share stay in L2.
// * the WMMA body (0), every other call: decode (3 capacity rows an
//   expert, where the expert weight bytes bound it) and every f32 call.
//   64 x 64 output tiles, 4 warps; a live tile runs the K loop with
//   32-deep (bf16) or 16-deep (f32) tiles staged in shared memory and the
//   next tile's global loads in flight while the current one computes:
//   bf16 on the tensor cores through WMMA 16x16x16 fragments (32 x 32
//   outputs a warp, f32 accumulators), f32 on the FMA units (4 x 8 outputs
//   a thread), since tf32 would not hold an f32 result to 1e-4.
//
// Both keep the TPU kernel's routing on the card: its scalar-prefetched
// block-to-expert map becomes a lookup each block does itself. Row tile i
// of the groups is laid out with every group padded up to the tile's rows
// (the padding rows do not exist in the output); one thread walks the E
// group sizes from device memory to find its group, so the routing never
// leaves the card and the caller never syncs. The grid is the static bound
// of ceil(M / rows) + E group tiles plus the tail tiles that zero the rows
// past the last group. A tile whose rows are all past its group's valid
// count writes zeros and loads nothing, neither activations nor weights.
// Later work: split-K for the 14336-deep down projection at decode.

#include <cuda.h>
#include <mma.h>

#include "common.cuh"
#include "tensor_core.cuh"

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

// thread 0 maps row tile `ti` (of BM rows) to its group; the total rows of
// all groups go to *total
template <int BM>
__device__ Tile find_tile(int ti, const int* __restrict__ sizes,
                          const int* __restrict__ valid, int E, int M,
                          int* total) {
  Tile t{-1, 0, 0, 0, 0};
  const long r = static_cast<long>(ti) * BM;
  long aoff = 0, poff = 0;
  for (int e = 0; e < E; ++e) {
    long s = sizes[e];
    s = s < 0 ? 0 : s;
    s = s > M - poff ? M - poff : s;
    long v = valid != nullptr ? valid[e] : s;
    v = v < 0 ? 0 : (v > s ? s : v);
    const long al = (s + BM - 1) / BM * BM;
    if (t.group < 0 && r >= aoff && r < aoff + al) {
      t.group = e;
      t.l0 = static_cast<int>(r - aoff);
      const long rows = s - t.l0, live = v - t.l0;
      t.rows = static_cast<int>(rows < BM ? rows : BM);
      t.live = static_cast<int>(live <= 0 ? 0 : (live < BM ? live : BM));
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
    tile = find_tile<kBM>(blockIdx.x < group_tiles ? blockIdx.x : 0, sizes,
                          valid, E, M, &tot);
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

// ------------------------------------------------ the wgmma body
namespace body_wgmma {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;     // rows a tile: two consumer warpgroups of 64
constexpr int BK = 64;      // K a stage: one 128-byte swizzled row
constexpr int STAGES = 4;
constexpr int GROUP_M = 16; // row tiles whose blocks run side by side
constexpr int NT = 2 * 128 + 32;  // two consumer warpgroups, a producer warp

template <int BN>
struct Shape {
  static constexpr int A_BYTES = BM * BK * 2;  // one TMA box [128, 64]
  static constexpr int B_BYTES = BK * BN * 2;  // BN / 64 boxes [64, 64]
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // 1024 bytes of slack: a 128-byte swizzle atom must start 1024-aligned
  static constexpr size_t smem = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// arrive, and expect `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// a wgmma shared-memory descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128)
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | (1ull << 62);
}

// d (64 x 128, f32) += A (64 x 16 bf16, K-major) * B (16 x 128 bf16,
// N-major: the transpose bit), both read from shared memory through their
// descriptors (PTX ISA, wgmma.mma_async; the register order is the m16n8
// C fragment's, repeated over 16 column blocks of 8)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// out rows [row0, row0 + rows) x columns [n0, n0 + BN) cut at N, zeros
template <int BN>
__device__ void zero_tile(bf16* __restrict__ out, long row0, int rows,
                          int n0, int N) {
  const int chunks = min(BN, N - n0) / 8;  // N is a multiple of 8
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i % chunks;
    *reinterpret_cast<uint4*>(out + (row0 + r) * N + n0 + 8 * c) =
        make_uint4(0, 0, 0, 0);
  }
}

template <int BN>
__global__ void __launch_bounds__(NT, 1)
grouped_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_b,
                     const int* __restrict__ sizes,
                     const int* __restrict__ valid, bf16* __restrict__ out,
                     int M, int K, int N, int E, int group_tiles,
                     int row_tiles, int col_tiles) {
  using Sh = Shape<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * Sh::STAGE);
  uint64_t* empty = full + STAGES;
  __shared__ Tile tile;
  __shared__ int total;

  // (row tile, column tile): GROUP_M row tiles at a time, row tiles fastest
  const int per = GROUP_M * col_tiles;
  const int first = static_cast<int>(blockIdx.x) / per * GROUP_M;
  const int gm = min(GROUP_M, row_tiles - first);
  const int rest = static_cast<int>(blockIdx.x) % per;
  const int mt = first + rest % gm, n0 = rest / gm * BN;
  const int tid = threadIdx.x;
  if (tid == 0) {
    int tot = 0;
    tile = find_tile<BM>(mt < group_tiles ? mt : 0, sizes, valid, E, M, &tot);
    total = tot;
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);       // the producer's expect_tx
      mbar_init(empty + s, 8);      // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (mt >= group_tiles) {
    // the rows past the last group: [total, M) in BM-row tiles
    const long r0 = static_cast<long>(mt - group_tiles) * BM;
    const long lo = r0 > total ? r0 : total;
    const long hi = r0 + BM < M ? r0 + BM : M;
    if (lo < hi) zero_tile<BN>(out, lo, static_cast<int>(hi - lo), n0, N);
    return;
  }
  const Tile t = tile;
  if (t.group < 0 || t.rows <= 0) return;
  if (t.live <= 0) {  // capacity padding only: no loads, exact zeros
    zero_tile<BN>(out, t.row0, t.rows, n0, N);
    return;
  }
  const int nk = (K + BK - 1) / BK;
  const int warp = tid >> 5, lane = tid & 31;
  if (warp == 8) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES, use = kt / STAGES;
        if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
        unsigned char* st = base + s * Sh::STAGE;
        mbar_expect_tx(full + s, Sh::STAGE);
        tma_load_2d(st, &tm_a, full + s, kt * BK, static_cast<int>(t.row0));
#pragma unroll
        for (int nb = 0; nb < BN / 64; ++nb)
          tma_load_3d(st + Sh::A_BYTES + nb * BK * 128, &tm_b, full + s,
                      n0 + 64 * nb, kt * BK, t.group);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2;
  float acc[BN / 128][64];
#pragma unroll
  for (int h = 0; h < BN / 128; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + s, (kt / STAGES) & 1);
    const unsigned char* a = base + s * Sh::STAGE + wg * 64 * 128;
    const unsigned char* b = base + s * Sh::STAGE + Sh::A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart, k16
      // steps of 32 bytes inside the swizzled row
      const uint64_t da = desc(a + 32 * k, 16, 1024);
#pragma unroll
      for (int h = 0; h < BN / 128; ++h)
        // B: N-major; 64-column boxes 8192 bytes apart (LBO), 8-row
        // groups of K 1024 apart (SBO), k16 steps of 16 rows
        wgmma_m64n128k16(acc[h], da,
                         desc(b + h * 2 * BK * 128 + k * 16 * 128,
                              BK * 128, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (lane == 0) mbar_arrive(empty + s);  // this warp is done with s
  }

  // the accumulator rows of this thread: g and g + 8 of its warp's 16
  const int wq = warp & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = wg * 64 + wq * 16 + (lane >> 2) + 8 * rr;
    if (r >= t.rows) continue;
    const bool keep = r < t.live;
    bf16* orow = out + (t.row0 + r) * N;
#pragma unroll
    for (int h = 0; h < BN / 128; ++h)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = n0 + h * 128 + 8 * i + 2 * (lane & 3);
        if (col < N)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              keep ? __floats2bfloat162_rn(acc[h][4 * i + 2 * rr],
                                           acc[h][4 * i + 2 * rr + 1])
                   : __floats2bfloat162_rn(0.f, 0.f);
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links nothing beyond the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int BN>
cudaError_t launch(const void* lhs, const void* rhs, const int* sizes,
                   const int* valid, void* out, int M, int K, int N, int E,
                   cudaStream_t st) {
  if (K % 8 || N % 8 || reinterpret_cast<uintptr_t>(lhs) % 16 ||
      reinterpret_cast<uintptr_t>(rhs) % 16)
    return cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  // A: lhs [M, K], boxes of [128 rows, 64]; B: rhs [E, K, N], boxes of
  // [1, 64, 64]; both 128-byte swizzled, zeros past every edge
  CUtensorMap ta, tb;
  const cuuint32_t one[3] = {1, 1, 1};
  const cuuint64_t adim[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(M)};
  const cuuint64_t astride[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t abox[2] = {BK, BM};
  const cuuint64_t bdim[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t bstride[2] = {static_cast<cuuint64_t>(N) * 2,
                                 static_cast<cuuint64_t>(K) * N * 2};
  const cuuint32_t bbox[3] = {64, BK, 1};
  if (enc(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(lhs),
          adim, astride, abox, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      enc(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(rhs),
          bdim, bstride, bbox, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  constexpr size_t smem = Shape<BN>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int mt = (M + BM - 1) / BM;
  const int group_tiles = mt + E, row_tiles = group_tiles + mt;
  const int col_tiles = (N + BN - 1) / BN;
  const long long blocks = static_cast<long long>(row_tiles) * col_tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  grouped_wgmma_kernel<BN><<<static_cast<unsigned>(blocks), NT, smem, st>>>(
      ta, tb, sizes, valid, static_cast<bf16*>(out), M, K, N, E,
      group_tiles, row_tiles, col_tiles);
  return cudaGetLastError();
}

}  // namespace body_wgmma

}  // namespace

// lhs [M, K] and rhs [E, K, N] of one dtype (f32 or bf16), contiguous;
// group_sizes [E] i32 and valid_sizes [E] i32 (or null) on the card; out
// [M, N] of lhs's dtype, every element written. body 0 is the WMMA body;
// body 1 the wgmma body (bf16, K and N multiples of 8, lhs and rhs
// 16-byte aligned), its column tile 256 when N >= 1024 else 128. Returns
// the cudaError_t of the launch.
extern "C" int grouped_matmul(const void* lhs, const void* rhs,
                              const void* group_sizes,
                              const void* valid_sizes, void* out, int M,
                              int K, int N, int E, int dtype, int body,
                              void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || E <= 0 ||
      (N + kBN - 1) / kBN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  const int* vs = static_cast<const int*>(valid_sizes);
  if (body == 1) {
    if (dtype != kBF16) return cudaErrorInvalidValue;
    if (N >= 1024)
      return body_wgmma::launch<256>(lhs, rhs, gs, vs, out, M, K, N, E, st);
    return body_wgmma::launch<128>(lhs, rhs, gs, vs, out, M, K, N, E, st);
  }
  if (body != 0) return cudaErrorInvalidValue;
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(lhs, rhs, gs, vs, out, M, K, N, E, st);
  if (dtype == kF32)
    return launch<float>(lhs, rhs, gs, vs, out, M, K, N, E, st);
  return cudaErrorInvalidValue;
}
