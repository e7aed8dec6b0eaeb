// The port's f32 GEMM on the CUDA cores (no TF32, no tensor cores, no
// library call), shared by the decoder step (transformer_decode.cu) and the
// whole-layer training kernels (layer_train.cu):
//
//   C = epilogue(prologue(A) . B)     over the K range of blockIdx.z
//
// A is [M, K] read as a[m * lda + k], or, with TA, stored transposed and
// read as a[k * lda + m] (the weight gradient A^T dY reads its activations
// that way); B is [K, N] read as w[k * ldw + n], or, with TB, as
// w[n * ldw + k] (dX = dY W^T). The LN prologue (TA false only) takes the
// mean and the deviation of the block's rows of A (unbiased variance, eps
// outside the sqrt) and normalises A tiles as it loads them. The epilogue
// is a functor called once per float4 of C: epi(row, col, acc4, split).
//
// Tiling as the LSTM cell's (lstm_cell.cu): BK = 32 deep K tiles, double
// buffered in shared memory with one barrier per tile, A stored k-major so
// a thread's 4 rows are one float4, a 4 x 4 register tile per thread. The
// host picks a 64 x 64, 32 x 64 or 32 x 32 block tile so that the grid
// covers the SMs. Requirements (the callers' wrappers check them): the
// float4 direction of each operand (K for A and for TB's B, M for TA's A,
// N for B and C) a multiple of 4, lda / ldw multiples of 4, 16-byte aligned
// pointers, and a split's K range a multiple of BK.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace uic {

constexpr int GEMM_BK = 32;          // reduction depth per tile
constexpr int GEMM_TM = 4;           // register tile per thread: rows
constexpr int GEMM_TN = 4;           //   and columns
constexpr float GEMM_LN_EPS = 1e-6f;

struct GemmArgs {
  const float* a;
  const float* w;
  const float* ln_s;   // [K] LN scale (LN prologue only)
  const float* ln_b;   // [K] LN offset
  int lda, ldw;
  int M, N, K;
  int k_chunk;         // K rows per blockIdx.z; K for a single split
};

__device__ __forceinline__ float gemm_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int BM, int BN, bool LN, bool TA, bool TB, class Epi>
__global__ void __launch_bounds__((BM / GEMM_TM) * (BN / GEMM_TN))
gemm_kernel(GemmArgs p, Epi epi) {
  constexpr int BK = GEMM_BK, TM = GEMM_TM, TN = GEMM_TN;
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int AS_LD = BM + 4;                     // padded k-major A row
  constexpr int A_LOADS = BM * BK / 4 / THREADS;    // float4 per thread
  constexpr int W_LOADS = BK * BN / 4 / THREADS;
  static_assert(BM * BK / 4 % THREADS == 0, "A tile must split evenly");
  static_assert(BK * BN / 4 % THREADS == 0, "W tile must split evenly");
  static_assert(!(LN && TA), "the LN prologue reads rows of A");
  __shared__ __align__(16) float As[2][BK][AS_LD];
  __shared__ __align__(16) float Ws[2][BK][BN];
  __shared__ float s_mean[LN ? BM : 1], s_den[LN ? BM : 1];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = p.M, N = p.N;
  const int k_lo = blockIdx.z * p.k_chunk;
  const int k_hi = min(p.K, k_lo + p.k_chunk);

  if (LN) {
    // the LN statistics of this block's rows, one warp per row, two passes
    // over the row as the reference computes them
    const int lane = tid & 31, K = p.K;
    for (int i = tid >> 5; i < BM; i += THREADS / 32) {
      const int r = m0 + i;
      float mean = 0.0f, den = 1.0f;
      if (r < M) {
        const float* xr = p.a + (size_t)r * p.lda;
        float s = 0.0f;
        for (int k = lane; k < K; k += 32) s += xr[k];
        mean = gemm_warp_sum(s) / (float)K;
        float q = 0.0f;
        for (int k = lane; k < K; k += 32) {
          const float dv = xr[k] - mean;
          q = fmaf(dv, dv, q);
        }
        den = sqrtf(gemm_warp_sum(q) / (float)(K - 1)) + GEMM_LN_EPS;
      }
      if (lane == 0) {
        s_mean[i] = mean;
        s_den[i] = den;
      }
    }
    __syncthreads();
  }

  float4 a_reg[A_LOADS], w_reg[W_LOADS];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int n = 0; n < A_LOADS; ++n) {
      const int e = tid + n * THREADS;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (TA) {
        // 4 rows m of one k: a[k * lda + m .. m + 3]
        const int k = k0 + e / (BM / 4), r = m0 + (e % (BM / 4)) * 4;
        if (k < k_hi && r < M)
          v = *reinterpret_cast<const float4*>(p.a + (size_t)k * p.lda + r);
      } else {
        // 4 k of one row m: a[m * lda + k .. k + 3]
        const int row = e / (BK / 4), k = k0 + (e % (BK / 4)) * 4;
        const int r = m0 + row;
        if (r < M && k < k_hi) {
          v = *reinterpret_cast<const float4*>(p.a + (size_t)r * p.lda + k);
          if (LN) {
            const float mu = s_mean[row], dn = s_den[row];
            v.x = (v.x - mu) / dn * p.ln_s[k] + p.ln_b[k];
            v.y = (v.y - mu) / dn * p.ln_s[k + 1] + p.ln_b[k + 1];
            v.z = (v.z - mu) / dn * p.ln_s[k + 2] + p.ln_b[k + 2];
            v.w = (v.w - mu) / dn * p.ln_s[k + 3] + p.ln_b[k + 3];
          }
        }
      }
      a_reg[n] = v;
    }
#pragma unroll
    for (int n = 0; n < W_LOADS; ++n) {
      const int e = tid + n * THREADS;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (TB) {
        // 4 k of one column n: w[n * ldw + k .. k + 3]
        const int c = n0 + e / (BK / 4), kr = k0 + (e % (BK / 4)) * 4;
        if (kr < k_hi && c < N)
          v = *reinterpret_cast<const float4*>(p.w + (size_t)c * p.ldw + kr);
      } else {
        // 4 columns n of one k: w[k * ldw + n .. n + 3]
        const int kr = k0 + e / (BN / 4), c = n0 + (e % (BN / 4)) * 4;
        if (kr < k_hi && c < N)
          v = *reinterpret_cast<const float4*>(p.w + (size_t)kr * p.ldw + c);
      }
      w_reg[n] = v;
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int n = 0; n < A_LOADS; ++n) {
      const int e = tid + n * THREADS;
      if (TA) {
        *reinterpret_cast<float4*>(
            &As[buf][e / (BM / 4)][(e % (BM / 4)) * 4]) = a_reg[n];
      } else {
        const int row = e / (BK / 4), kq = (e % (BK / 4)) * 4;
        As[buf][kq][row] = a_reg[n].x;
        As[buf][kq + 1][row] = a_reg[n].y;
        As[buf][kq + 2][row] = a_reg[n].z;
        As[buf][kq + 3][row] = a_reg[n].w;
      }
    }
#pragma unroll
    for (int n = 0; n < W_LOADS; ++n) {
      const int e = tid + n * THREADS;
      if (TB) {
        const int c = e / (BK / 4), kq = (e % (BK / 4)) * 4;
        Ws[buf][kq][c] = w_reg[n].x;
        Ws[buf][kq + 1][c] = w_reg[n].y;
        Ws[buf][kq + 2][c] = w_reg[n].z;
        Ws[buf][kq + 3][c] = w_reg[n].w;
      } else {
        *reinterpret_cast<float4*>(
            &Ws[buf][e / (BN / 4)][(e % (BN / 4)) * 4]) = w_reg[n];
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  if (n_tiles > 0) {
    load_tile(k_lo);
    store_tile(0);
  }
  __syncthreads();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) load_tile(k_lo + (tile + 1) * BK);  // in flight
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * TM]);
      const float4 w4 = *reinterpret_cast<const float4*>(&Ws[buf][kk][tx * TN]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float w[TN] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    if (tile + 1 < n_tiles) store_tile(buf ^ 1);
    // one barrier per tile: the next buffer is complete, and nobody reads
    // this one again before it is overwritten two tiles on
    __syncthreads();
  }

  const int c = n0 + tx * TN;
  if (c >= N) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= M) continue;
    epi(r, c, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]),
        (int)blockIdx.z);
  }
}

// the SM count of the current device, read once per process
inline int gemm_sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <int BM, int BN, bool LN, bool TA, bool TB, class Epi>
void gemm_launch_tile(const GemmArgs& p, const Epi& epi, int splits,
                      cudaStream_t st) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  gemm_kernel<BM, BN, LN, TA, TB, Epi>
      <<<grid, (BM / GEMM_TM) * (BN / GEMM_TN), 0, st>>>(p, epi);
}

// Launch over `splits` K ranges of p.k_chunk rows (the largest tile whose
// grid still covers the SMs, twice for 64 x 64); returns the launch error.
template <bool LN, bool TA, bool TB, class Epi>
int gemm(const GemmArgs& p, const Epi& epi, cudaStream_t st, int splits = 1) {
  const int sms = gemm_sm_count();
  auto blocks = [&](int bm, int bn) {
    return ((p.M + bm - 1) / bm) * ((p.N + bn - 1) / bn) * splits;
  };
  if (blocks(64, 64) >= 2 * sms)
    gemm_launch_tile<64, 64, LN, TA, TB>(p, epi, splits, st);
  else if (blocks(32, 64) >= sms)
    gemm_launch_tile<32, 64, LN, TA, TB>(p, epi, splits, st);
  else
    gemm_launch_tile<32, 32, LN, TA, TB>(p, epi, splits, st);
  return (int)cudaGetLastError();
}

// C = acc + bias, row stride ldo
struct EpiBias {
  const float* bias;
  float* out;
  int ldo;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const float4 b4 = *reinterpret_cast<const float4*>(bias + c);
    *reinterpret_cast<float4*>(out + (size_t)r * ldo + c) =
        make_float4(acc.x + b4.x, acc.y + b4.y, acc.z + b4.z, acc.w + b4.w);
  }
};

// C += acc + bias, in place
struct EpiRes {
  const float* bias;
  float* out;
  int ldo;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const float4 b4 = *reinterpret_cast<const float4*>(bias + c);
    float* o = out + (size_t)r * ldo + c;
    const float4 x4 = *reinterpret_cast<const float4*>(o);
    const float4 v =
        make_float4(acc.x + b4.x, acc.y + b4.y, acc.z + b4.z, acc.w + b4.w);
    *reinterpret_cast<float4*>(o) =
        make_float4(x4.x + v.x, x4.y + v.y, x4.z + v.z, x4.w + v.w);
  }
};

// C = relu(acc + bias)
struct EpiRelu {
  const float* bias;
  float* out;
  int ldo;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const float4 b4 = *reinterpret_cast<const float4*>(bias + c);
    *reinterpret_cast<float4*>(out + (size_t)r * ldo + c) = make_float4(
        fmaxf(acc.x + b4.x, 0.0f), fmaxf(acc.y + b4.y, 0.0f),
        fmaxf(acc.z + b4.z, 0.0f), fmaxf(acc.w + b4.w, 0.0f));
  }
};

}  // namespace uic
