// The training layers' f32 GEMM on the CUDA cores (no TF32, no tensor
// cores, no library call), shaped for throughput at the encoder's 9,800
// rows and still filling the card at the NMT's and the decoder's 800-850.
// Only layer_train.cu uses it.
//
//   C = epilogue(A . B)     B [K, N] row-major (ldb)
//
// A is [M, K] row-major (lda), or, with AK, stored k-major as a[k * lda + m]
// (the weight gradient dW = X^T dY reads the activations X [rows, M] that
// way, its K being the rows). The epilogue is a functor called once per
// float4 of C after the whole K reduction: epi(row, col, acc4, 0), as
// gemm.cuh's epilogues take it. With COLSUM (weight gradients), the blocks
// of the first row tile also sum B's columns over K into colsum [N] (the
// bias gradient from the dY tiles the product loads anyway).
//
// What bounds an f32 GEMM here: an SM issues 128 FMAs a clock but reads 128
// bytes of shared memory a clock, so a thread tile of TM x TN, which loads
// TM + TN floats for TM * TN FMAs a k, needs shared memory at
// 32 (TM + TN) / (4 TM TN) of its rate to keep the FMAs busy: an 8 x 8 tile
// all of it (a 4 x 4 tile twice it). Larger thread tiles need
// more than the 255 registers a thread has to keep their loads in flight
// (an 8 x 16 tile ran slower, at 255 registers), so a thread here holds
// 8 x 8, and the design keeps its loads conflict-free and in flight.
//
// Design. A block of 256 threads (8 warps) computes a 128 x 128 tile; a
// warp is 4 thread rows x 8 thread columns, 32 rows x 64 columns. K
// streams through a 3-stage cp.async ring of 32-deep K tiles in dynamic
// shared memory (16-byte copies, zero-filled past M, N and K; two blocks
// an SM); nothing is transposed on the way in:
//
//   - a row-major A tile stays row-major ([m][BK + 4]); a thread's 8 rows
//     are ty + 16 i, so a warp's four ty read four neighbouring rows, whose
//     float4 along k fall on four different bank groups, each a broadcast
//     to the warp's eight tx;
//   - a k-major A tile stays k-major ([k][128]); a thread's rows are two
//     float4, 4 ty + {0..3} and 64 + 4 ty + {0..3};
//   - the B tile is [k][128]; a thread's columns are float4s at 4 tx and
//     64 + 4 tx: eight neighbouring float4 a warp.
//
// Filling the card (`tg_plan`), the likely trouble spot. The card holds
// `slots` blocks at once (two an SM: 264), and a product of 308 tiles
// (M = 9,800, N = 512) would run a second round with 44 blocks, a sixth of
// the card, as long as the first. So the row tiles that fill whole rounds
// run in one launch, K unsplit, and the rest in a second launch whose K is
// split across a thread-block cluster of CS blocks, CS from 1 to 16
// (Hopper's non-portable size), each rank two K tiles at least. CS is the
// one with the least modelled time: rounds of the clusters the card holds
// at once (cudaOccupancyMaxActiveClusters, read once for every CS) times a
// rank's K tiles and its fill, drain and sum. A product with fewer tiles
// than slots (a weight gradient's 16-48, K = 9,800 rows; the NMT's and the
// decoder's 800 rows) is that second launch alone. Each block of a cluster
// reduces its K slice of the same tile, parks the partial tile in its own
// shared memory, and after cluster.sync() block r sums its share of the
// rows over the cluster's partials through distributed shared memory in
// rank order 0..CS-1 and runs the epilogue on them (as decode_gemm.cuh
// does); the column sums go the same way. No scratch, no atomics: a rerun
// gives the same bits.
//
// Widths. Where K and N (M too with AK), lda and ldb are multiples of 4
// and A and B 16-byte aligned, the tiles land by 16-byte copies and the
// epilogue takes float4 (V4); any other shape (a d_ff of 510, a width d
// of 6) runs the instance that copies 4 bytes at a time and calls the
// epilogue's `one` per element, the same tiles and sums otherwise.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "gemm.cuh"   // gemm_sm_count()

namespace uic_train {

namespace cg = cooperative_groups;

constexpr int TG_BM = 128, TG_BN = 128, TG_BK = 32;
constexpr int TG_STAGES = 3;
constexpr int TG_THREADS = 256;
constexpr int TG_TM = 8, TG_TN = 8;          // a thread's tile
constexpr int TG_A_LD = TG_BK + 4;           // padded row of a row-major A
constexpr int TG_MAX_CLUSTER = 16;           // Hopper's non-portable size

template <bool AK>
struct TgShape {
  static constexpr int A_FLOATS = AK ? TG_BK * TG_BM : TG_BM * TG_A_LD;
  static constexpr int STAGE = A_FLOATS + TG_BK * TG_BN;
  static constexpr int SMEM = TG_STAGES * STAGE * (int)sizeof(float);
  static_assert(TG_BM * TG_BN <= TG_STAGES * STAGE,
                "the partial tile fits in the ring");
};

__device__ __forceinline__ void tg_cp16(float* dst, const float* src,
                                        bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void tg_cp4(float* dst, const float* src,
                                       bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void tg_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void tg_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct TrainGemm {
  const float* a;
  const float* b;
  float* colsum;       // [N] (COLSUM only)
  int lda, ldb, M, N, K;
  int m_begin;         // the launch's first row
  int k_slice;         // K rows a cluster rank reduces (a multiple of BK)
};

// The tile row of register row i of thread row ty.
template <bool AK>
__device__ __forceinline__ int tg_row(int ty, int i) {
  return AK ? (i / 4) * 64 + ty * 4 + (i % 4) : ty + 16 * i;
}

// A and B rows [k0, k0 + BK) of the tile into one stage by 16-byte copies
// (V4) or 4-byte ones; zero past M, N and the slice's K.
template <bool AK, bool V4>
__device__ __forceinline__ void tg_load_stage(float* As, const TrainGemm& p,
                                              int m0, int n0, int k0,
                                              int k_end) {
  float* Bs = As + TgShape<AK>::A_FLOATS;
  const int tid = threadIdx.x;
  if (!V4) {
    for (int e = tid; e < TG_BM * TG_BK; e += TG_THREADS) {
      if (AK) {
        const int kk = e / TG_BM, mm = e % TG_BM;
        const int k = k0 + kk, m = m0 + mm;
        const bool ok = k < k_end && m < p.M;
        tg_cp4(As + kk * TG_BM + mm, ok ? p.a + (size_t)k * p.lda + m : p.a,
               ok);
      } else {
        const int row = e / TG_BK, kk = e % TG_BK;
        const int m = m0 + row, k = k0 + kk;
        const bool ok = m < p.M && k < k_end;
        tg_cp4(As + row * TG_A_LD + kk,
               ok ? p.a + (size_t)m * p.lda + k : p.a, ok);
      }
    }
    for (int e = tid; e < TG_BK * TG_BN; e += TG_THREADS) {
      const int kk = e / TG_BN, c = e % TG_BN;
      const int k = k0 + kk, n = n0 + c;
      const bool ok = k < k_end && n < p.N;
      tg_cp4(Bs + kk * TG_BN + c, ok ? p.b + (size_t)k * p.ldb + n : p.b, ok);
    }
    return;
  }
#pragma unroll
  for (int e = tid; e < TG_BM * TG_BK / 4; e += TG_THREADS) {
    if (AK) {
      const int kk = e / (TG_BM / 4), mq = (e % (TG_BM / 4)) * 4;
      const int k = k0 + kk, m = m0 + mq;
      const bool ok = k < k_end && m < p.M;
      tg_cp16(As + kk * TG_BM + mq, ok ? p.a + (size_t)k * p.lda + m : p.a,
              ok);
    } else {
      const int row = e / (TG_BK / 4), kq = (e % (TG_BK / 4)) * 4;
      const int m = m0 + row, k = k0 + kq;
      const bool ok = m < p.M && k < k_end;
      tg_cp16(As + row * TG_A_LD + kq, ok ? p.a + (size_t)m * p.lda + k : p.a,
              ok);
    }
  }
#pragma unroll
  for (int e = tid; e < TG_BK * TG_BN / 4; e += TG_THREADS) {
    const int kk = e / (TG_BN / 4), c = (e % (TG_BN / 4)) * 4;
    const int k = k0 + kk, n = n0 + c;
    const bool ok = k < k_end && n < p.N;
    tg_cp16(Bs + kk * TG_BN + c, ok ? p.b + (size_t)k * p.ldb + n : p.b, ok);
  }
}

// the epilogue over the four columns c .. c + 3 of row r: one float4 (V4),
// else each column below N
template <bool V4, class Epi>
__device__ __forceinline__ void tg_epilogue(const Epi& epi, int r, int c,
                                            int N, float4 v) {
  if (V4) {
    epi(r, c, v, 0);
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < N) epi.one(r, c + j, e[j]);
}

template <bool AK, bool COLSUM, class Epi, bool V4>
__global__ void __launch_bounds__(TG_THREADS, 2)
train_gemm_kernel(TrainGemm p, Epi epi) {
  using S = TgShape<AK>;
  constexpr int BN = TG_BN, BK = TG_BK, TM = TG_TM, TN = TG_TN;
  extern __shared__ __align__(16) float tg_smem[];
  __shared__ float col_part[COLSUM ? BN : 1];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / cs) * BN;
  const int m0 = p.m_begin + blockIdx.y * TG_BM;
  const int k_begin = rank * p.k_slice;
  const int k_end = min(p.K, k_begin + p.k_slice);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // a warp is 4 thread rows x 8 thread columns
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  const bool sums = COLSUM && m0 == 0 && tid < BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float csum = 0.0f;

#pragma unroll
  for (int s = 0; s < TG_STAGES - 1; ++s) {
    if (s < n_tiles)
      tg_load_stage<AK, V4>(tg_smem + s * S::STAGE, p, m0, n0,
                            k_begin + s * BK, k_end);
    tg_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    tg_wait<TG_STAGES - 2>();
    // tile t has landed for every thread, and every thread is done with
    // tile t-1, whose stage the prefetch below overwrites
    __syncthreads();
    const int nt = t + TG_STAGES - 1;
    if (nt < n_tiles)
      tg_load_stage<AK, V4>(tg_smem + (nt % TG_STAGES) * S::STAGE, p, m0,
                            n0, k_begin + nt * BK, k_end);
    tg_commit();
    const float* As = tg_smem + (t % TG_STAGES) * S::STAGE;
    const float* Bs = As + S::A_FLOATS;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float a[TM][4];
      if (AK) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 v = *reinterpret_cast<const float4*>(
                As + (kq + q) * TG_BM + h * 64 + ty * 4);
            a[h * 4][q] = v.x;
            a[h * 4 + 1][q] = v.y;
            a[h * 4 + 2][q] = v.z;
            a[h * 4 + 3][q] = v.w;
          }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              As + tg_row<false>(ty, i) * TG_A_LD + kq);
          a[i][0] = v.x;
          a[i][1] = v.y;
          a[i][2] = v.z;
          a[i][3] = v.w;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[TN];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              Bs + (kq + q) * BN + h * 64 + tx * 4);
          b[h * 4] = v.x;
          b[h * 4 + 1] = v.y;
          b[h * 4 + 2] = v.z;
          b[h * 4 + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][q], b[j], acc[i][j]);
      }
    }
    if (sums) {
      // this rank's column sums in row order (rows past K are zeros)
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) csum += Bs[kk * BN + tid];
    }
  }
  tg_wait<0>();
  __syncthreads();   // the ring is free for the partial tile

  if (cs == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + tg_row<AK>(ty, i);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + h * 64 + tx * 4;
        if (r < p.M && c < p.N)
          tg_epilogue<V4>(epi, r, c, p.N,
                          make_float4(acc[i][h * 4], acc[i][h * 4 + 1],
                                      acc[i][h * 4 + 2], acc[i][h * 4 + 3]));
      }
    }
    if (sums && n0 + tid < p.N) p.colsum[n0 + tid] = csum;
    return;
  }
  float* part = tg_smem;                       // [BM][BN]
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(part + tg_row<AK>(ty, i) * BN + h * 64 +
                                 tx * 4) =
          make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                      acc[i][h * 4 + 3]);
  if (sums) col_part[tid] = csum;
  cluster.sync();
  const int r_lo = rank * TG_BM / cs, r_hi = (rank + 1) * TG_BM / cs;
  for (int e = tid; e < (r_hi - r_lo) * (BN / 4); e += TG_THREADS) {
    const int row = r_lo + e / (BN / 4);
    const int cq = (e % (BN / 4)) * 4;
    float4 s = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, 0) + row * BN + cq);
    for (int src = 1; src < cs; ++src) {              // fixed order: same bits
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, src) + row * BN + cq);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int r = m0 + row, c = n0 + cq;
    if (r < p.M && c < p.N) tg_epilogue<V4>(epi, r, c, p.N, s);
  }
  if (sums && rank == 0 && n0 + tid < p.N) {
    float s = 0.0f;
    for (int src = 0; src < cs; ++src)                // rank order
      s += cluster.map_shared_rank(col_part, src)[tid];
    p.colsum[n0 + tid] = s;
  }
  // no block leaves while another still reads its shared memory
  cluster.sync();
}

inline int tg_cdiv(int a, int b) { return (a + b - 1) / b; }

struct TgPlan {
  int full_rows;   // row tiles run in whole rounds, K unsplit
  int rows;        // row tiles in all
  int cs;          // cluster size of the rest: blocks splitting K
};

// Whole rounds of the slots first, then the rest of the row tiles with K
// split across clusters of the size with the least modelled time (see the
// header comment). clusters[cs]: the clusters of cs blocks the card holds
// at once (clusters[1]: the slots).
inline TgPlan tg_plan(int M, int N, int K, const int* clusters) {
  constexpr int FILL = 2, REDUCE = 2;   // K tiles' worth of fill, of a sum
  const int slots = clusters[1];
  const int n_col = tg_cdiv(N, TG_BN), rows = tg_cdiv(M, TG_BM);
  const int tiles = rows * n_col, k_tiles = tg_cdiv(K, TG_BK);
  const int full = tiles > slots ? tiles / slots * slots / n_col : 0;
  const int rest = (rows - full) * n_col;
  int best = 1;
  long long best_cost = -1;
  for (int cs = 1; cs <= TG_MAX_CLUSTER; ++cs) {
    if (cs > 1 && k_tiles < 2 * cs) break;
    if (clusters[cs] < 1) continue;
    const long long cost =
        (long long)tg_cdiv(rest, clusters[cs]) *
        (tg_cdiv(k_tiles, cs) + FILL + (cs > 1 ? REDUCE : 0));
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = cs;
    }
  }
  return TgPlan{full, rows, best};
}

// The clusters of cs blocks the card holds at once of one instance of the
// kernel, for cs = 1 .. TG_MAX_CLUSTER (entry 0: read), as the occupancy
// calculator reads its registers and shared memory, after the opt-ins
// every launch needs: above 48 KB of shared memory and clusters of 16.
// Sizes the card refuses count 0.
template <bool AK, bool COLSUM, class Epi, bool V4 = true>
const int* tg_clusters() {
  static int table[TG_MAX_CLUSTER + 1] = {0};
  if (table[0]) return table;
  auto kernel = train_gemm_kernel<AK, COLSUM, Epi, V4>;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           TgShape<AK>::SMEM) != cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess)
    return table;
  for (int cs = 1; cs <= TG_MAX_CLUSTER; ++cs) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs);
    cfg.blockDim = dim3(TG_THREADS);
    cfg.dynamicSmemBytes = TgShape<AK>::SMEM;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    table[cs] = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) ==
                        cudaSuccess
                    ? n
                    : 0;
  }
  (void)cudaGetLastError();   // a refused size is not the caller's error
  table[0] = table[1] > 0;
  return table;
}

// One launch over `row_tiles` row tiles from p.m_begin, K split across
// clusters of cs.
template <bool AK, bool COLSUM, bool V4, class Epi>
int tg_launch(TrainGemm p, int row_tiles, int cs, const Epi& epi,
              cudaStream_t st) {
  p.k_slice = tg_cdiv(tg_cdiv(p.K, TG_BK), cs) * TG_BK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tg_cdiv(p.N, TG_BN) * cs, row_tiles);
  cfg.blockDim = dim3(TG_THREADS);
  cfg.dynamicSmemBytes = TgShape<AK>::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, train_gemm_kernel<AK, COLSUM, Epi, V4>, p,
                         epi);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// C = epi(A . B) on `st` in the plan's one or two launches; `colsum`
// (COLSUM) receives B's column sums over K. Returns the launch error.
template <bool AK, bool COLSUM, bool V4, class Epi>
int train_gemm_as(const TrainGemm& p, const Epi& epi, cudaStream_t st) {
  const int* clusters = tg_clusters<AK, COLSUM, Epi, V4>();
  if (!clusters[0]) return (int)cudaErrorInvalidConfiguration;
  const TgPlan plan = tg_plan(p.M, p.N, p.K, clusters);
  TrainGemm q = p;
  q.m_begin = 0;
  if (plan.full_rows > 0) {
    const int err = tg_launch<AK, COLSUM, V4>(q, plan.full_rows, 1, epi, st);
    if (err) return err;
  }
  if (plan.full_rows == plan.rows) return 0;
  q.m_begin = plan.full_rows * TG_BM;
  return tg_launch<AK, COLSUM, V4>(q, plan.rows - plan.full_rows, plan.cs,
                                   epi, st);
}

template <bool AK, bool COLSUM, class Epi>
int train_gemm(const TrainGemm& p, const Epi& epi, cudaStream_t st) {
  if (p.M <= 0 || p.N <= 0) return (int)cudaGetLastError();
  const bool v4 = p.K % 4 == 0 && p.N % 4 == 0 && (!AK || p.M % 4 == 0) &&
                  p.lda % 4 == 0 && p.ldb % 4 == 0 &&
                  ((size_t)p.a | (size_t)p.b) % 16 == 0;
  return v4 ? train_gemm_as<AK, COLSUM, true>(p, epi, st)
            : train_gemm_as<AK, COLSUM, false>(p, epi, st);
}

}  // namespace uic_train
