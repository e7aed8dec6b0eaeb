// The decoder step's f32 GEMM on the CUDA cores (no TF32, no tensor cores,
// no library call), shaped for decoding: few rows (M = 250 or 750 at the
// pivot's beams), K = 512 or 2048, N = 512, 1536 or 2048. The transformer
// decoder step (transformer_decode.cu) and the fused att -> LSTM -> att
// decode step (additive_attention.cu, 50 rows) use it.
//
//   C = epilogue(A . W)      A [M, K] row-major (lda), W [K, N] row-major
//
// The epilogue is a functor called once per float4 of C after the whole K
// reduction: epi(row, col, acc4, 0), as gemm.cuh's epilogues take it.
//
// Design. A block computes a BM x BN = 64 x 64 tile with 128 threads, each
// an 8 x 4 register tile: rows {4 ty + i, 32 + 4 ty + i}, i < 4, and one
// float4 of columns. Per four k, 12 shared-memory loads of 16 bytes feed
// 128 FMAs (a 4 x 4 tile: 8 loads for 64); the two row groups of a warp
// fall on different banks. K streams through a 3-stage cp.async ring of
// BK = 32 deep tiles (16-byte copies, zero-filled past M, N and K), two
// tiles in flight while one is multiplied.
//
// Filling the card. At M = 250 a 64 x 64 grid has 32 tiles for N = 512 and
// 96 for N = 1536; at M = 750, 96 for N = 512 and 288 for N = 1536, which
// leave SMs idle or unevenly loaded. So the K reduction is split across a
// thread-block cluster of CS in {1, 2, 4, 8} blocks (cudaLaunchKernelEx),
// doubled while the grid has fewer than DG_FILL blocks per SM and every
// block keeps at least two K tiles. Each block of a cluster reduces its K
// slice of the same tile, parks the partial tile in its own shared memory,
// and after cluster.sync() block r sums rows [r*BM/CS, (r+1)*BM/CS) over
// the cluster's partials through distributed shared memory, in rank order
// 0..CS-1, and runs the epilogue on them (as lstm_cell.cu does). No
// scratch, no atomics: a rerun gives the same bits.
//
// Types. W may be bf16 (the compute dtype): its tile is then converted as
// it loads, by the threads (not cp.async), into the same f32 tile; the
// products stay f32 FMA, as JAX promotes a product with an f32 operand.
// Where A and W are both bf16, decode_gemm_bf16 runs the same tiles, ring
// and cluster plan on the tensor cores: mma.sync m16n8k16 bf16 products
// with f32 sums (mma_bf16.cuh), each warp a 32 x 32 quarter of the tile,
// A's fragments by ldmatrix and W's [k][n] rows by ldmatrix.trans, both
// tiles landing by 16-byte cp.async copies; the f32 tile is parked in
// shared memory and the epilogue reads it back as float4, alone or summed
// over the cluster's ranks in rank order (dg_finish, shared with the f32
// core's cluster reduction).
//
// Widths. Where K, N and lda are multiples of 4 and A and W 16-byte
// aligned, the tiles land by 16-byte copies and the epilogue takes float4
// (V4); any other shape (a d_ff of 510, an odd hidden width) runs the
// instance that copies 4 bytes at a time and calls the epilogue's `one`
// per element, the same tiles and sums otherwise.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "bf16.cuh"
#include "gemm.cuh"   // the epilogues, gemm_sm_count()
#include "mma_bf16.cuh"

namespace uic_decode {

namespace cg = cooperative_groups;

constexpr int DG_BM = 64, DG_BN = 64, DG_BK = 32;
constexpr int DG_STAGES = 3;
constexpr int DG_TM = 8, DG_TN = 4;          // register tile of a thread
constexpr int DG_HM = DG_BM / 2;             // the second row group
constexpr int DG_THREADS = (DG_BM / DG_TM) * (DG_BN / DG_TN);
constexpr int DG_A_LD = DG_BK + 4;           // padded row of the A tile
constexpr int DG_A_FLOATS = DG_BM * DG_A_LD;
constexpr int DG_STAGE_FLOATS = DG_A_FLOATS + DG_BK * DG_BN;
constexpr int DG_SMEM = DG_STAGES * DG_STAGE_FLOATS * (int)sizeof(float);
constexpr int DG_MAX_CLUSTER = 8;            // the portable cluster size
constexpr int DG_FILL = 3;                   // blocks per SM the plan aims at
static_assert(DG_BM * DG_BN <= DG_STAGES * DG_STAGE_FLOATS,
              "the partial tile fits in the ring");

__device__ __forceinline__ void dg_cp16(float* dst, const float* src,
                                        bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void dg_cp4(float* dst, const float* src,
                                       bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void dg_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void dg_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct DecodeGemm {
  const float* a;
  const void* w;       // f32, or bf16 where wbf
  int lda, M, N, K;
  int k_slice;         // K rows a cluster rank reduces (a multiple of BK)
  int wbf = 0;         // W stored as bf16: converting loads (bf16.cuh)
};

// A and W rows [k0, k0 + BK) of the tile into one stage, both row-major
// (As[m][k], Ws[k][n]) by 16-byte copies (V4) or 4-byte ones; zero past M,
// N and the slice's K.
template <bool V4>
__device__ __forceinline__ void dg_load_stage(float* As, const DecodeGemm& p,
                                              int m0, int n0, int k0,
                                              int k_end) {
  float* Ws = As + DG_A_FLOATS;
  const int tid = threadIdx.x;
  if (p.wbf) {
    // A by cp.async as below; a bf16 W tile by the threads themselves,
    // converted as it loads (four at a time where V4: 8-byte rows)
    constexpr int W = V4 ? 4 : 1;
    for (int e = tid; e < DG_BM * DG_BK / W; e += DG_THREADS) {
      const int row = e / (DG_BK / W), kk = (e % (DG_BK / W)) * W;
      const int r = m0 + row, k = k0 + kk;
      const bool ok = r < p.M && k < k_end;
      const float* src = ok ? p.a + (size_t)r * p.lda + k : p.a;
      if constexpr (V4)
        dg_cp16(As + row * DG_A_LD + kk, src, ok);
      else
        dg_cp4(As + row * DG_A_LD + kk, src, ok);
    }
    for (int e = tid; e < DG_BK * DG_BN / W; e += DG_THREADS) {
      const int kk = e / (DG_BN / W), c = (e % (DG_BN / W)) * W;
      const int k = k0 + kk, n = n0 + c;
      const bool ok = k < k_end && n < p.N;
      const size_t i = (size_t)k * p.N + n;
      if constexpr (V4)
        *reinterpret_cast<float4*>(Ws + kk * DG_BN + c) =
            ok ? uic_bf16::ld4t<true>(p.w, i)
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      else
        Ws[kk * DG_BN + c] = ok ? uic_bf16::ldt<true>(p.w, i) : 0.0f;
    }
    return;
  }
  const float* pw = static_cast<const float*>(p.w);
  if (!V4) {
    for (int e = tid; e < DG_BM * DG_BK; e += DG_THREADS) {
      const int row = e / DG_BK, kk = e % DG_BK;
      const int r = m0 + row, k = k0 + kk;
      const bool ok = r < p.M && k < k_end;
      dg_cp4(As + row * DG_A_LD + kk, ok ? p.a + (size_t)r * p.lda + k : p.a,
             ok);
    }
    for (int e = tid; e < DG_BK * DG_BN; e += DG_THREADS) {
      const int kk = e / DG_BN, c = e % DG_BN;
      const int k = k0 + kk, n = n0 + c;
      const bool ok = k < k_end && n < p.N;
      dg_cp4(Ws + kk * DG_BN + c, ok ? pw + (size_t)k * p.N + n : pw, ok);
    }
    return;
  }
#pragma unroll
  for (int e = tid; e < DG_BM * DG_BK / 4; e += DG_THREADS) {
    const int row = e / (DG_BK / 4), kq = (e % (DG_BK / 4)) * 4;
    const int r = m0 + row, k = k0 + kq;
    const bool ok = r < p.M && k < k_end;
    dg_cp16(As + row * DG_A_LD + kq, ok ? p.a + (size_t)r * p.lda + k : p.a,
            ok);
  }
#pragma unroll
  for (int e = tid; e < DG_BK * DG_BN / 4; e += DG_THREADS) {
    const int kk = e / (DG_BN / 4), c = (e % (DG_BN / 4)) * 4;
    const int k = k0 + kk, n = n0 + c;
    const bool ok = k < k_end && n < p.N;
    dg_cp16(Ws + kk * DG_BN + c, ok ? pw + (size_t)k * p.N + n : pw, ok);
  }
}

// the epilogue over the four columns c .. c + 3 of row r: one float4 (V4),
// else each column below N
template <bool V4, class Epi>
__device__ __forceinline__ void dg_epilogue(const Epi& epi, int r, int c,
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

// The epilogue over a block's parked f32 tile part [BM][LDP]: alone
// (a cluster of one), or, after cluster.sync(), rank r's rows [r*BM/CS,
// (r+1)*BM/CS) summed over the cluster's partials through distributed
// shared memory in rank order 0..CS-1 (no atomics: a rerun gives the same
// bits); the second cluster.sync() keeps every block until the others
// have read its tile.
template <bool V4, int LDP, class Epi>
__device__ __forceinline__ void dg_finish(cg::cluster_group& cluster,
                                          float* part, const Epi& epi,
                                          int m0, int n0, int M, int N) {
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  if (cs == 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < DG_BM * (DG_BN / 4); e += blockDim.x) {
      const int row = e / (DG_BN / 4), cq = (e % (DG_BN / 4)) * 4;
      const int r = m0 + row, cc = n0 + cq;
      if (r < M && cc < N)
        dg_epilogue<V4>(epi, r, cc, N,
                        *reinterpret_cast<const float4*>(part + row * LDP +
                                                         cq));
    }
    return;
  }
  cluster.sync();
  const int rows = DG_BM / cs;
  for (int e = threadIdx.x; e < rows * (DG_BN / 4); e += blockDim.x) {
    const int row = rank * rows + e / (DG_BN / 4);
    const int cq = (e % (DG_BN / 4)) * 4;
    float4 v[DG_MAX_CLUSTER];
#pragma unroll
    for (int src = 0; src < DG_MAX_CLUSTER; ++src)   // all loads in flight
      if (src < cs)
        v[src] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, src) + row * LDP + cq);
    float4 s = v[0];
#pragma unroll
    for (int src = 1; src < DG_MAX_CLUSTER; ++src)   // fixed order: same bits
      if (src < cs) {
        s.x += v[src].x;
        s.y += v[src].y;
        s.z += v[src].z;
        s.w += v[src].w;
      }
    const int r = m0 + row, cc = n0 + cq;
    if (r < M && cc < N) dg_epilogue<V4>(epi, r, cc, N, s);
  }
  // no block leaves while another still reads its shared memory
  cluster.sync();
}

template <class Epi, bool V4>
__global__ void __launch_bounds__(DG_THREADS)
decode_gemm_kernel(DecodeGemm p, Epi epi) {
  extern __shared__ __align__(16) float dg_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / cs) * DG_BN, m0 = blockIdx.y * DG_BM;
  const int k_begin = rank * p.k_slice;
  const int k_end = min(p.K, k_begin + p.k_slice);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + DG_BK - 1) / DG_BK : 0;
  constexpr int TX = DG_BN / DG_TN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  constexpr int HM = DG_HM;

  float acc[DG_TM][DG_TN];
#pragma unroll
  for (int i = 0; i < DG_TM; ++i)
#pragma unroll
    for (int j = 0; j < DG_TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < DG_STAGES - 1; ++s) {
    if (s < n_tiles)
      dg_load_stage<V4>(dg_smem + s * DG_STAGE_FLOATS, p, m0, n0,
                        k_begin + s * DG_BK, k_end);
    dg_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    dg_wait<DG_STAGES - 2>();
    // tile t has landed for every thread, and every thread is done with
    // tile t-1, whose stage the prefetch below overwrites
    __syncthreads();
    const int nt = t + DG_STAGES - 1;
    if (nt < n_tiles)
      dg_load_stage<V4>(dg_smem + (nt % DG_STAGES) * DG_STAGE_FLOATS, p, m0,
                        n0, k_begin + nt * DG_BK, k_end);
    dg_commit();
    const float* As = dg_smem + (t % DG_STAGES) * DG_STAGE_FLOATS;
    const float* Ws = As + DG_A_FLOATS;
#pragma unroll
    for (int kq = 0; kq < DG_BK; kq += 4) {
      float a[DG_TM][4];
#pragma unroll
      for (int i = 0; i < DG_TM; ++i) {
        const int row = i < 4 ? ty * 4 + i : HM + ty * 4 + i - 4;
        const float4 v =
            *reinterpret_cast<const float4*>(As + row * DG_A_LD + kq);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(Ws + (kq + q) * DG_BN + tx * 4);
        const float w[DG_TN] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < DG_TM; ++i)
#pragma unroll
          for (int j = 0; j < DG_TN; ++j)
            acc[i][j] = fmaf(a[i][q], w[j], acc[i][j]);
      }
    }
  }
  dg_wait<0>();
  __syncthreads();   // the ring is free for the partial tile

  const int c = n0 + tx * 4;
  if (cs == 1) {
#pragma unroll
    for (int i = 0; i < DG_TM; ++i) {
      const int r = m0 + (i < 4 ? ty * 4 + i : HM + ty * 4 + i - 4);
      if (r < p.M && c < p.N)
        dg_epilogue<V4>(epi, r, c, p.N,
                        make_float4(acc[i][0], acc[i][1], acc[i][2],
                                    acc[i][3]));
    }
    return;
  }
  float* part = dg_smem;                       // [BM][BN]
#pragma unroll
  for (int i = 0; i < DG_TM; ++i) {
    const int row = i < 4 ? ty * 4 + i : HM + ty * 4 + i - 4;
    *reinterpret_cast<float4*>(part + row * DG_BN + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  dg_finish<V4, DG_BN>(cluster, part, epi, m0, n0, p.M, p.N);
}

inline int dg_cdiv(int a, int b) { return (a + b - 1) / b; }

// The cluster size for an M x N x K product: doubled while the grid has
// fewer than DG_FILL blocks per SM and each block keeps at least
// `rank_tiles` K tiles (2 for the decoder step; the 50-row products of the
// fused decode step take 1, so that their 8 tiles fill 64 blocks).
inline int dg_cluster(int M, int N, int K, int rank_tiles) {
  const int tiles = dg_cdiv(M, DG_BM) * dg_cdiv(N, DG_BN);
  const int k_tiles = dg_cdiv(K, DG_BK);
  int cs = 1;
  while (cs < DG_MAX_CLUSTER &&
         tiles * cs < DG_FILL * uic::gemm_sm_count() &&
         k_tiles >= rank_tiles * (2 * cs))
    cs *= 2;
  return cs;
}

template <class Epi, bool V4>
int decode_gemm_as(const DecodeGemm& p, int cs, const Epi& epi,
                   cudaStream_t st) {
  // the opt-in above 48 KB, on the current device
  cudaError_t e = cudaFuncSetAttribute(
      decode_gemm_kernel<Epi, V4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, DG_SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(dg_cdiv(p.N, DG_BN) * cs, dg_cdiv(p.M, DG_BM));
  cfg.blockDim = dim3(DG_THREADS);
  cfg.dynamicSmemBytes = DG_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_gemm_kernel<Epi, V4>, p, epi);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// C = epi(a [M, K] . w [K, N]) on `st`; returns the launch error. wbf: w
// is bf16 (the A operand is always f32).
template <class Epi>
int decode_gemm(const float* a, int lda, const void* w, int M, int N, int K,
                const Epi& epi, cudaStream_t st, int rank_tiles = 2,
                int wbf = 0) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const int cs = dg_cluster(M, N, K, rank_tiles);
  DecodeGemm p{a, w, lda, M, N, K,
               dg_cdiv(dg_cdiv(K, DG_BK), cs) * DG_BK, wbf};
  const bool v4 = K % 4 == 0 && N % 4 == 0 && lda % 4 == 0 &&
                  ((size_t)a | (size_t)w) % 16 == 0;
  return v4 ? decode_gemm_as<Epi, true>(p, cs, epi, st)
            : decode_gemm_as<Epi, false>(p, cs, epi, st);
}

// ---------------------------------------------------------------------------
// bf16 A and W on the tensor cores
// ---------------------------------------------------------------------------

constexpr int DGT_A_LD = DG_BK + 8;   // bf16 of a padded A row: 80 bytes
constexpr int DGT_W_LD = DG_BN + 8;   // of a padded W row: 144 bytes
constexpr int DGT_STAGE = DG_BM * DGT_A_LD + DG_BK * DGT_W_LD;  // bf16
constexpr int DGT_P_LD = DG_BN + 4;   // floats of a row of the parked tile
constexpr int DGT_SMEM = DG_STAGES * DGT_STAGE * 2;
static_assert(DG_BM * DGT_P_LD * 4 <= DGT_SMEM,
              "the partial tile fits in the ring");

struct DecodeGemmBf16 {
  const unsigned short* a;   // [M, K] bf16, row stride lda
  const unsigned short* w;   // [K, N] bf16
  int lda, M, N, K;
  int k_slice;
};

// A rows [m0, m0 + BM) and W rows [k0, k0 + BK) of the tile into one
// stage, 8 bf16 (16 bytes) a copy; zero past M, N and the slice's K (K, N
// and lda multiples of 8, so a copy is whole or empty)
__device__ __forceinline__ void dgt_load_stage(unsigned short* As,
                                               const DecodeGemmBf16& p,
                                               int m0, int n0, int k0,
                                               int k_end) {
  unsigned short* Ws = As + DG_BM * DGT_A_LD;
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = tid; e < DG_BM * (DG_BK / 8); e += DG_THREADS) {
    const int row = e / (DG_BK / 8), kc = (e % (DG_BK / 8)) * 8;
    const int r = m0 + row, k = k0 + kc;
    const bool ok = r < p.M && k < k_end;
    uic_mma::cp16(As + row * DGT_A_LD + kc,
                  ok ? p.a + (size_t)r * p.lda + k : p.a, ok);
  }
#pragma unroll
  for (int e = tid; e < DG_BK * (DG_BN / 8); e += DG_THREADS) {
    const int kk = e / (DG_BN / 8), c = (e % (DG_BN / 8)) * 8;
    const int k = k0 + kk, n = n0 + c;
    const bool ok = k < k_end && n < p.N;
    uic_mma::cp16(Ws + kk * DGT_W_LD + c,
                  ok ? p.w + (size_t)k * p.N + n : p.w, ok);
  }
}

template <class Epi>
__global__ void __launch_bounds__(DG_THREADS)
decode_gemm_bf16_kernel(DecodeGemmBf16 p, Epi epi) {
  extern __shared__ __align__(16) unsigned short dgt_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / cs) * DG_BN, m0 = blockIdx.y * DG_BM;
  const int k_begin = rank * p.k_slice;
  const int k_end = min(p.K, k_begin + p.k_slice);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + DG_BK - 1) / DG_BK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  // each lane's ldmatrix offsets within a stage's A and W tiles
  const int a_off =
      (wm + uic_mma::frag_row(lane)) * DGT_A_LD + uic_mma::frag_col(lane);
  const int w_off =
      uic_mma::frag_row(lane) * DGT_W_LD + wn + uic_mma::frag_col(lane);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < DG_STAGES - 1; ++s) {
    if (s < n_tiles)
      dgt_load_stage(dgt_smem + s * DGT_STAGE, p, m0, n0,
                     k_begin + s * DG_BK, k_end);
    uic_mma::commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    uic_mma::wait<DG_STAGES - 2>();
    // tile t has landed for every thread, and every thread is done with
    // tile t-1, whose stage the prefetch below overwrites
    __syncthreads();
    const int nt = t + DG_STAGES - 1;
    if (nt < n_tiles)
      dgt_load_stage(dgt_smem + (nt % DG_STAGES) * DGT_STAGE, p, m0, n0,
                     k_begin + nt * DG_BK, k_end);
    uic_mma::commit();
    const unsigned short* As = dgt_smem + (t % DG_STAGES) * DGT_STAGE;
    const unsigned short* Ws = As + DG_BM * DGT_A_LD;
#pragma unroll
    for (int ks = 0; ks < DG_BK; ks += 16) {
      unsigned af[2][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        uic_mma::ldsm_x4(af[i], As + a_off + i * 16 * DGT_A_LD + ks);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        uic_mma::ldsm_x4_t(bf[j], Ws + w_off + ks * DGT_W_LD + j * 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          uic_mma::mma(acc[i][j], af[i], bf[j / 2][(j % 2) * 2],
                       bf[j / 2][(j % 2) * 2 + 1]);
    }
  }
  uic_mma::wait<0>();
  __syncthreads();   // the ring is free for the partial tile

  float* part = reinterpret_cast<float*>(dgt_smem);   // [BM][DGT_P_LD]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = wm + i * 16 + lane / 4, col = wn + j * 8 + 2 * (lane % 4);
      *reinterpret_cast<float2*>(part + row * DGT_P_LD + col) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(part + (row + 8) * DGT_P_LD + col) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  dg_finish<true, DGT_P_LD>(cluster, part, epi, m0, n0, p.M, p.N);
}

// Whether an M x N x K product of bf16 a (row stride lda) and bf16 w takes
// the tensor cores: K, N and lda multiples of 8 and both arrays on 16
// bytes, so that every copy is a whole 16-byte chunk; other widths keep
// decode_gemm's converting-load core.
inline bool dg_bf16_ok(const void* a, int lda, const void* w, int N, int K) {
  return K % 8 == 0 && N % 8 == 0 && lda % 8 == 0 &&
         ((size_t)a | (size_t)w) % 16 == 0;
}

// C = epi(a [M, K] . w [K, N]), both bf16, on the tensor cores, with
// decode_gemm's tiles and cluster plan; the shape must satisfy dg_bf16_ok.
template <class Epi>
int decode_gemm_bf16(const void* a, int lda, const void* w, int M, int N,
                     int K, const Epi& epi, cudaStream_t st,
                     int rank_tiles = 2) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (!dg_bf16_ok(a, lda, w, N, K)) return (int)cudaErrorInvalidValue;
  const int cs = dg_cluster(M, N, K, rank_tiles);
  const DecodeGemmBf16 p{static_cast<const unsigned short*>(a),
                         static_cast<const unsigned short*>(w), lda, M, N,
                         K, dg_cdiv(dg_cdiv(K, DG_BK), cs) * DG_BK};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(dg_cdiv(N, DG_BN) * cs, dg_cdiv(M, DG_BM));
  cfg.blockDim = dim3(DG_THREADS);
  cfg.dynamicSmemBytes = DGT_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, decode_gemm_bf16_kernel<Epi>, p, epi);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace uic_decode
