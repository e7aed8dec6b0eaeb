// Training multi-head attention, forward and backward, for Hopper (sm_90a).
// Replaces the TPU kernels unpaired_image_captioning_tpu/ops/mha_train.py
// ::_fwd_kernel and ::_bwd_kernel (`fused_mha_train`).
//
// Per (batch b, head h), with dh = d / H and maskadd [B, 1|T, S]:
//   s    = q_h k_h^T / sqrt(dh);  s = -1e9 where maskadd < 0
//   p    = softmax(s) (rows whole, f32)
//   attn = keep ? p / (1 - rate) : 0      keep: the splitmix32 hash below
//   o_h  = attn v_h
// The backward recomputes s, p and the dropout mask from the seed (no
// [B, H, T, S] residual is ever stored):
//   dv = attn^T g;  dp = keep ? (g v^T) / (1 - rate) : 0
//   ds = p (dp - D), D_i = g_i . o_i (= sum_j dp_ij p_ij);  ds = 0 masked
//   dq = ds k / sqrt(dh);  dk = ds^T q / sqrt(dh)
//
// What bounds it on the card: at the encoder shape (B 50, T = S = 196,
// d 512, 8 heads) the forward is 3.9 GFLOP against 80 MB of q/k/v/mask/o,
// so the f32 FMA rate bounds it (59 us at 67 TFLOP/s; the bytes take
// 24 us). Without TF32 the tensor cores are out, so this is a tiled FMA
// kernel: 256 threads, each a 2 x 4 register tile of scores (2 query rows
// by 4 keys) from shared-memory tiles padded to DH + 1 columns (no bank
// conflicts), and whole score rows of the block's 32 queries in shared
// memory so the softmax stays exact. The backward is deterministic without
// float atomics: one kernel per (b, h, 32 query rows) recomputes p, writes
// the row stats (max, sum, D) and dq; a second per (b, h, 64 keys) walks
// every query row in order and owns its keys' dk and dv.
//
// The kernels read q / k / v and write their gradients with row strides of
// their own and draw the dropout of block b * pid_b + h (mha_train.cuh), so
// the whole-layer kernels (layer_train.cu) attend over the column blocks of
// a packed [rows, 3d] projection with their own dropout site ids.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mha_train.cuh"

namespace {

using uic::Attn;
using uic::hash_base;
using uic::keep_hash;

constexpr int NT = 256;  // threads per block: tx = tid % 16, ty = tid / 16
constexpr int QT = 32;   // query rows per block (2 per ty)
constexpr int KC = 64;   // keys per chunk (4 per tx)
constexpr float NEG = -1e9f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rows [r0, r0 + ROWS) of head h of one batch element's [L, ld] matrix
// into dst [ROWS][DH + 1]; rows past L are zero
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int L, int ld, int h) {
  for (int i = threadIdx.x; i < ROWS * DH; i += NT) {
    const int r = i / DH, c = i % DH, row = r0 + r;
    dst[r * (DH + 1) + c] = row < L ? src[(size_t)row * ld + h * DH + c] : 0.f;
  }
}

// acc[r][m] = A[ty*2 + r] . B[tx + 16*m] over DH, A [QT][DH+1], B [KC][DH+1]
template <int DH>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         float acc[2][4], int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[r][m] = 0.f;
  const float* a0 = A + (ty * 2) * (DH + 1);
  const float* a1 = a0 + (DH + 1);
#pragma unroll 8
  for (int c = 0; c < DH; ++c) {
    const float x0 = a0[c], x1 = a1[c];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float y = B[(tx + 16 * m) * (DH + 1) + c];
      acc[0][m] += x0 * y;
      acc[1][m] += x1 * y;
    }
  }
}

__device__ __forceinline__ const float* mask_row(const float* mask, int b,
                                                 int row, int mask_rows,
                                                 int S) {
  return mask + ((size_t)b * mask_rows + (mask_rows == 1 ? 0 : row)) * S;
}

// scores of the block's QT query rows (already in qs) against all S keys,
// scaled and masked, into sc [QT][S]
template <int DH>
__device__ void scores_pass(const float* qs, float* kv, float* sc,
                            const float* kb, const float* mask, int b, int q0,
                            int T, int S, int lk, int h, int mask_rows,
                            float sqrt_dh) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k0 = 0; k0 < S; k0 += KC) {
    __syncthreads();
    load_tile<DH, KC>(kv, kb, k0, S, lk, h);
    __syncthreads();
    float acc[2][4];
    tile_dot<DH>(qs, kv, acc, ty, tx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + ty * 2 + r;
      if (row >= T) continue;
      const float* mrow = mask_row(mask, b, row, mask_rows, S);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int key = k0 + tx + 16 * m;
        if (key < S) {
          const float s = acc[r][m] / sqrt_dh;
          sc[(ty * 2 + r) * S + key] = mrow[key] < 0.f ? NEG : s;
        }
      }
    }
  }
  __syncthreads();
}

// softmax of each valid row of sc in place (a warp per row); with `stats`
// given, each row's max and sum go to stats[3 * (stat_base + row) + 0 / 1]
__device__ void softmax_rows(float* sc, int q0, int T, int S, float* stats,
                             size_t stat_base) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < QT; r += NT / 32) {
    const int row = q0 + r;
    if (row >= T) continue;
    float* srow = sc + r * S;
    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) mx = fmaxf(mx, srow[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32) srow[j] = srow[j] / sum;
    if (stats != nullptr && lane == 0) {
      stats[3 * (stat_base + row)] = mx;
      stats[3 * (stat_base + row) + 1] = sum;
    }
  }
  __syncthreads();
}

template <int DH>
__global__ void __launch_bounds__(NT)
    mha_fwd_kernel(const Attn a, float* __restrict__ out, float sqrt_dh) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [QT][DH+1]
  float* kv = qs + QT * (DH + 1);    // [KC][DH+1]
  float* sc = kv + KC * (DH + 1);    // [QT][S]
  const int T = a.T, S = a.S;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qb = a.q + (size_t)b * T * a.lq;
  const float* kb = a.k + (size_t)b * S * a.lk;
  const float* vb = a.v + (size_t)b * S * a.lv;

  load_tile<DH, QT>(qs, qb, q0, T, a.lq, h);
  scores_pass<DH>(qs, kv, sc, kb, a.mask, b, q0, T, S, a.lk, h, a.mask_rows,
                  sqrt_dh);
  softmax_rows(sc, q0, T, S, nullptr, 0);
  if (a.dropout) {
    const uint32_t base = hash_base(*a.seed, b * a.pid_b + h);
    for (int i = threadIdx.x; i < QT * S; i += NT) {
      const int r = i / S, j = i % S, row = q0 + r;
      if (row >= T) continue;
      const uint32_t x = keep_hash(base, (uint32_t)(row * S + j));
      sc[i] = x >= a.thresh ? sc[i] / a.keep_div : 0.f;
    }
  }

  constexpr int CPT = DH / 16;  // output columns per thread
  float o[2][CPT];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[r][c] = 0.f;
  for (int k0 = 0; k0 < S; k0 += KC) {
    __syncthreads();
    load_tile<DH, KC>(kv, vb, k0, S, a.lv, h);
    __syncthreads();
    const int kn = min(KC, S - k0);
    const float* a0 = sc + (ty * 2) * S + k0;
    const float* a1 = a0 + S;
    for (int j = 0; j < kn; ++j) {
      const float x0 = a0[j], x1 = a1[j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float y = kv[j * (DH + 1) + tx + 16 * c];
        o[0][c] += x0 * y;
        o[1][c] += x1 * y;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + ty * 2 + r;
    if (row >= T) continue;
    float* orow = out + ((size_t)b * T + row) * a.lo + h * DH;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = o[r][c];
  }
}

// backward, pass 1: per (b, h, QT query rows): p, the row stats
// (max, sum, D) into stats [B*H*T][3], and dq
template <int DH>
__global__ void __launch_bounds__(NT)
    mha_bwd_dq_kernel(const Attn a, const float* __restrict__ g,
                      const float* __restrict__ o, float* __restrict__ dq,
                      float* __restrict__ stats, float sqrt_dh) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [QT][DH+1]
  float* gs = qs + QT * (DH + 1);    // [QT][DH+1]
  float* kv = gs + QT * (DH + 1);    // [KC][DH+1]
  float* sc = kv + KC * (DH + 1);    // [QT][S]
  __shared__ float dsum[QT];
  const int T = a.T, S = a.S, mask_rows = a.mask_rows;
  const float* mask = a.mask;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qb = a.q + (size_t)b * T * a.lq;
  const float* kb = a.k + (size_t)b * S * a.lk;
  const float* vb = a.v + (size_t)b * S * a.lv;
  const size_t stat_base = (size_t)(b * a.H + h) * T;

  load_tile<DH, QT>(qs, qb, q0, T, a.lq, h);
  load_tile<DH, QT>(gs, g + (size_t)b * T * a.lo, q0, T, a.lo, h);
  __syncthreads();
  // D_i = g_i . o_i over the head's columns
  for (int r = warp; r < QT; r += NT / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < T) {
      const float* orow = o + ((size_t)b * T + row) * a.lo + h * DH;
      for (int c = lane; c < DH; c += 32) acc += gs[r * (DH + 1) + c] * orow[c];
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      dsum[r] = acc;
      if (row < T) stats[3 * (stat_base + row) + 2] = acc;
    }
  }
  scores_pass<DH>(qs, kv, sc, kb, mask, b, q0, T, S, a.lk, h, mask_rows,
                  sqrt_dh);
  softmax_rows(sc, q0, T, S, stats, stat_base);

  // ds / sqrt(dh) into sc, chunk by chunk of V
  const int dropout = a.dropout;
  const uint32_t thresh = a.thresh;
  const float keep_div = a.keep_div;
  const uint32_t base = dropout ? hash_base(*a.seed, b * a.pid_b + h) : 0u;
  for (int k0 = 0; k0 < S; k0 += KC) {
    __syncthreads();
    load_tile<DH, KC>(kv, vb, k0, S, a.lv, h);
    __syncthreads();
    float acc[2][4];
    tile_dot<DH>(gs, kv, acc, ty, tx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + ty * 2 + r;
      if (row >= T) continue;
      const float* mrow = mask_row(mask, b, row, mask_rows, S);
      const float dr = dsum[ty * 2 + r];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int key = k0 + tx + 16 * m;
        if (key >= S) continue;
        float dp = acc[r][m];
        if (dropout) {
          const uint32_t x = keep_hash(base, (uint32_t)(row * S + key));
          dp = x >= thresh ? dp / keep_div : 0.f;
        }
        float* cell = sc + (ty * 2 + r) * S + key;
        const float ds = mrow[key] < 0.f ? 0.f : *cell * (dp - dr);
        *cell = ds / sqrt_dh;
      }
    }
  }

  // dq = (ds / sqrt(dh)) k
  constexpr int CPT = DH / 16;
  float accq[2][CPT];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) accq[r][c] = 0.f;
  for (int k0 = 0; k0 < S; k0 += KC) {
    __syncthreads();
    load_tile<DH, KC>(kv, kb, k0, S, a.lk, h);
    __syncthreads();
    const int kn = min(KC, S - k0);
    const float* a0 = sc + (ty * 2) * S + k0;
    const float* a1 = a0 + S;
    for (int j = 0; j < kn; ++j) {
      const float x0 = a0[j], x1 = a1[j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float y = kv[j * (DH + 1) + tx + 16 * c];
        accq[0][c] += x0 * y;
        accq[1][c] += x1 * y;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + ty * 2 + r;
    if (row >= T) continue;
    float* drow = dq + ((size_t)b * T + row) * a.lq + h * DH;
#pragma unroll
    for (int c = 0; c < CPT; ++c) drow[tx + 16 * c] = accq[r][c];
  }
}

// backward, pass 2: per (b, h, KC keys): every query row in order of QT
// rows; the block owns its keys' dk and dv, so no two blocks write one
// element
template <int DH>
__global__ void __launch_bounds__(NT)
    mha_bwd_dkdv_kernel(const Attn a, const float* __restrict__ g,
                        const float* __restrict__ stats,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float sqrt_dh) {
  extern __shared__ float smem[];
  float* ks = smem;                   // [KC][DH+1]
  float* vs = ks + KC * (DH + 1);     // [KC][DH+1]
  float* qs = vs + KC * (DH + 1);     // [QT][DH+1]
  float* gs = qs + QT * (DH + 1);     // [QT][DH+1]
  float* pt = gs + QT * (DH + 1);     // [QT][KC+1] attn
  float* dt = pt + QT * (KC + 1);     // [QT][KC+1] ds / sqrt(dh)
  __shared__ float rs[QT][3];
  const int T = a.T, S = a.S, mask_rows = a.mask_rows, dropout = a.dropout;
  const float* mask = a.mask;
  const uint32_t thresh = a.thresh;
  const float keep_div = a.keep_div;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * KC;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qb = a.q + (size_t)b * T * a.lq;
  const float* gb = g + (size_t)b * T * a.lo;
  const size_t stat_base = (size_t)(b * a.H + h) * T;
  const uint32_t base = dropout ? hash_base(*a.seed, b * a.pid_b + h) : 0u;

  load_tile<DH, KC>(ks, a.k + (size_t)b * S * a.lk, k0, S, a.lk, h);
  load_tile<DH, KC>(vs, a.v + (size_t)b * S * a.lv, k0, S, a.lv, h);
  constexpr int CPT = DH / 16;
  float adk[4][CPT], adv[4][CPT];  // keys ty*4 + m, columns tx + 16*c
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) adk[m][c] = adv[m][c] = 0.f;

  for (int q0 = 0; q0 < T; q0 += QT) {
    __syncthreads();
    load_tile<DH, QT>(qs, qb, q0, T, a.lq, h);
    load_tile<DH, QT>(gs, gb, q0, T, a.lo, h);
    for (int i = threadIdx.x; i < QT * 3; i += NT) {
      const int r = i / 3, row = q0 + r;
      rs[r][i % 3] = row < T ? stats[3 * (stat_base + row) + i % 3] : 0.f;
    }
    __syncthreads();
    float accs[2][4], accd[2][4];
    tile_dot<DH>(qs, ks, accs, ty, tx);
    tile_dot<DH>(gs, vs, accd, ty, tx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = ty * 2 + r, row = q0 + rr;
      const float* mrow =
          row < T ? mask_row(mask, b, row, mask_rows, S) : nullptr;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int kk = tx + 16 * m, key = k0 + kk;
        float attn = 0.f, dsd = 0.f;
        if (row < T && key < S) {
          const bool masked = mrow[key] < 0.f;
          const float s = masked ? NEG : accs[r][m] / sqrt_dh;
          const float p = expf(s - rs[rr][0]) / rs[rr][1];
          float dp = accd[r][m];
          attn = p;
          if (dropout) {
            const uint32_t x = keep_hash(base, (uint32_t)(row * S + key));
            const bool keep = x >= thresh;
            attn = keep ? p / keep_div : 0.f;
            dp = keep ? dp / keep_div : 0.f;
          }
          dsd = masked ? 0.f : p * (dp - rs[rr][2]) / sqrt_dh;
        }
        pt[rr * (KC + 1) + kk] = attn;
        dt[rr * (KC + 1) + kk] = dsd;
      }
    }
    __syncthreads();
    const int qn = min(QT, T - q0);
    for (int i = 0; i < qn; ++i) {
      float gv[CPT], qv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        gv[c] = gs[i * (DH + 1) + tx + 16 * c];
        qv[c] = qs[i * (DH + 1) + tx + 16 * c];
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float at = pt[i * (KC + 1) + ty * 4 + m];
        const float s = dt[i * (KC + 1) + ty * 4 + m];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          adv[m][c] += at * gv[c];
          adk[m][c] += s * qv[c];
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int key = k0 + ty * 4 + m;
    if (key >= S) continue;
    float* krow = dk + ((size_t)b * S + key) * a.lk + h * DH;
    float* vrow = dv + ((size_t)b * S + key) * a.lv + h * DH;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      krow[tx + 16 * c] = adk[m][c];
      vrow[tx + 16 * c] = adv[m][c];
    }
  }
}

size_t fwd_smem(int dh, int S) {
  return sizeof(float) * ((size_t)(QT + KC) * (dh + 1) + (size_t)QT * S);
}
size_t dq_smem(int dh, int S) {
  return sizeof(float) * ((size_t)(2 * QT + KC) * (dh + 1) + (size_t)QT * S);
}
size_t dkdv_smem(int dh) {
  return sizeof(float) * ((size_t)(2 * KC + 2 * QT) * (dh + 1) +
                          (size_t)2 * QT * (KC + 1));
}

// opt the kernel in to `smem` bytes of dynamic shared memory (above 48 KB)
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DH>
int fwd(const Attn& a, float* out, cudaStream_t stream) {
  const size_t smem = fwd_smem(DH, a.S);
  dim3 grid((a.T + QT - 1) / QT, a.H, a.B);
  cudaError_t err = allow_smem(mha_fwd_kernel<DH>, smem);
  if (err != cudaSuccess) return (int)err;
  mha_fwd_kernel<DH><<<grid, NT, smem, stream>>>(a, out, sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <int DH>
int bwd(const Attn& a, const float* g, const float* o, float* dq, float* dk,
        float* dv, float* stats, cudaStream_t stream) {
  const float sqrt_dh = sqrtf((float)DH);
  const size_t s1 = dq_smem(DH, a.S), s2 = dkdv_smem(DH);
  dim3 g1((a.T + QT - 1) / QT, a.H, a.B), g2((a.S + KC - 1) / KC, a.H, a.B);
  cudaError_t err = allow_smem(mha_bwd_dq_kernel<DH>, s1);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(mha_bwd_dkdv_kernel<DH>, s2);
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dq_kernel<DH><<<g1, NT, s1, stream>>>(a, g, o, dq, stats, sqrt_dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dkdv_kernel<DH><<<g2, NT, s2, stream>>>(a, g, stats, dk, dv,
                                                 sqrt_dh);
  return (int)cudaGetLastError();
}

// the attention kernel's own calls: q, k, v, out and g contiguous
// [B, T|S, H*dh], dropout block ids b*H + h
Attn plain_attn(const float* q, const float* k, const float* v,
                const float* mask, const int* seed, int B, int T, int S,
                int H, int dh, int mask_rows, unsigned int thresh,
                float keep_div, int dropout) {
  const int d = H * dh;
  return Attn{q, k, v, mask, seed, d, d, d, d, B, T, S, H, dh, mask_rows, H,
              thresh, keep_div, dropout};
}

}  // namespace

namespace uic {

int attn_fwd(const Attn& a, float* out, cudaStream_t st) {
  switch (a.dh) {
    case 32: return fwd<32>(a, out, st);
    case 64: return fwd<64>(a, out, st);
    case 128: return fwd<128>(a, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int attn_bwd(const Attn& a, const float* g, const float* o, float* dq,
             float* dk, float* dv, float* stats, cudaStream_t st) {
  switch (a.dh) {
    case 32: return bwd<32>(a, g, o, dq, dk, dv, stats, st);
    case 64: return bwd<64>(a, g, o, dq, dk, dv, stats, st);
    case 128: return bwd<128>(a, g, o, dq, dk, dv, stats, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace uic

extern "C" {

// q [B,T,H*dh], k/v [B,S,H*dh], mask [B,mask_rows,S] f32 (< 0: masked),
// seed int32 [1] on the card, out [B,T,H*dh]; dh in {32, 64, 128}, S <= 1024
int mha_train_fwd_f32(const float* q, const float* k, const float* v,
                      const float* mask, const int* seed, float* out, int B,
                      int T, int S, int H, int dh, int mask_rows,
                      unsigned int thresh, float keep_div, int dropout,
                      void* stream) {
  return uic::attn_fwd(plain_attn(q, k, v, mask, seed, B, T, S, H, dh,
                                  mask_rows, thresh, keep_div, dropout),
                       out, (cudaStream_t)stream);
}

// g, o [B,T,H*dh] (the upstream gradient and the forward output);
// dq [B,T,H*dh], dk/dv [B,S,H*dh]; stats scratch [B*H*T*3] f32
int mha_train_bwd_f32(const float* q, const float* k, const float* v,
                      const float* mask, const int* seed, const float* g,
                      const float* o, float* dq, float* dk, float* dv,
                      float* stats, int B, int T, int S, int H, int dh,
                      int mask_rows, unsigned int thresh, float keep_div,
                      int dropout, void* stream) {
  return uic::attn_bwd(plain_attn(q, k, v, mask, seed, B, T, S, H, dh,
                                  mask_rows, thresh, keep_div, dropout),
                       g, o, dq, dk, dv, stats, (cudaStream_t)stream);
}

}  // extern "C"
