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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block: tx = tid % 16, ty = tid / 16
constexpr int QT = 32;   // query rows per block (2 per ty)
constexpr int KC = 64;   // keys per chunk (4 per tx)
constexpr float NEG = -1e9f;

__device__ __forceinline__ uint32_t hash_base(int seed, int pid) {
  return ((uint32_t)seed * 0x9E3779B9u) ^ ((uint32_t)pid * 0x85EBCA6Bu);
}

// `_keep_mask` of the Pallas kernel: splitmix32 of (seed, b*H + h, row*S+col)
__device__ __forceinline__ uint32_t keep_hash(uint32_t base, uint32_t idx) {
  uint32_t x = base ^ (idx * 0x2545F491u);
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

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

// rows [r0, r0 + ROWS) of head h of one batch element's [L, d] matrix into
// dst [ROWS][DH + 1]; rows past L are zero
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int L, int d, int h) {
  for (int i = threadIdx.x; i < ROWS * DH; i += NT) {
    const int r = i / DH, c = i % DH, row = r0 + r;
    dst[r * (DH + 1) + c] = row < L ? src[(size_t)row * d + h * DH + c] : 0.f;
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
                            int T, int S, int d, int h, int mask_rows,
                            float sqrt_dh) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k0 = 0; k0 < S; k0 += KC) {
    __syncthreads();
    load_tile<DH, KC>(kv, kb, k0, S, d, h);
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
    mha_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ mask,
                   const int* __restrict__ seed, float* __restrict__ out,
                   int T, int S, int H, int mask_rows, float sqrt_dh,
                   uint32_t thresh, float keep_div, int dropout) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [QT][DH+1]
  float* kv = qs + QT * (DH + 1);    // [KC][DH+1]
  float* sc = kv + KC * (DH + 1);    // [QT][S]
  const int d = H * DH, b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qb = q + (size_t)b * T * d;
  const float* kb = k + (size_t)b * S * d;
  const float* vb = v + (size_t)b * S * d;

  load_tile<DH, QT>(qs, qb, q0, T, d, h);
  scores_pass<DH>(qs, kv, sc, kb, mask, b, q0, T, S, d, h, mask_rows,
                  sqrt_dh);
  softmax_rows(sc, q0, T, S, nullptr, 0);
  if (dropout) {
    const uint32_t base = hash_base(*seed, b * H + h);
    for (int i = threadIdx.x; i < QT * S; i += NT) {
      const int r = i / S, j = i % S, row = q0 + r;
      if (row >= T) continue;
      const uint32_t x = keep_hash(base, (uint32_t)(row * S + j));
      sc[i] = x >= thresh ? sc[i] / keep_div : 0.f;
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
    load_tile<DH, KC>(kv, vb, k0, S, d, h);
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
    float* orow = out + ((size_t)b * T + row) * d + h * DH;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = o[r][c];
  }
}

// backward, pass 1: per (b, h, QT query rows): p, the row stats
// (max, sum, D) into stats [B*H*T][3], and dq
template <int DH>
__global__ void __launch_bounds__(NT)
    mha_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ mask,
                      const int* __restrict__ seed,
                      const float* __restrict__ g, const float* __restrict__ o,
                      float* __restrict__ dq, float* __restrict__ stats, int T,
                      int S, int H, int mask_rows, float sqrt_dh,
                      uint32_t thresh, float keep_div, int dropout) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [QT][DH+1]
  float* gs = qs + QT * (DH + 1);    // [QT][DH+1]
  float* kv = gs + QT * (DH + 1);    // [KC][DH+1]
  float* sc = kv + KC * (DH + 1);    // [QT][S]
  __shared__ float dsum[QT];
  const int d = H * DH, b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qb = q + (size_t)b * T * d;
  const float* kb = k + (size_t)b * S * d;
  const float* vb = v + (size_t)b * S * d;
  const size_t stat_base = (size_t)(b * H + h) * T;

  load_tile<DH, QT>(qs, qb, q0, T, d, h);
  load_tile<DH, QT>(gs, g + (size_t)b * T * d, q0, T, d, h);
  __syncthreads();
  // D_i = g_i . o_i over the head's columns
  for (int r = warp; r < QT; r += NT / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < T) {
      const float* orow = o + ((size_t)b * T + row) * d + h * DH;
      for (int c = lane; c < DH; c += 32) acc += gs[r * (DH + 1) + c] * orow[c];
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      dsum[r] = acc;
      if (row < T) stats[3 * (stat_base + row) + 2] = acc;
    }
  }
  scores_pass<DH>(qs, kv, sc, kb, mask, b, q0, T, S, d, h, mask_rows,
                  sqrt_dh);
  softmax_rows(sc, q0, T, S, stats, stat_base);

  // ds / sqrt(dh) into sc, chunk by chunk of V
  const uint32_t base = dropout ? hash_base(*seed, b * H + h) : 0u;
  for (int k0 = 0; k0 < S; k0 += KC) {
    __syncthreads();
    load_tile<DH, KC>(kv, vb, k0, S, d, h);
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
    load_tile<DH, KC>(kv, kb, k0, S, d, h);
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
    float* drow = dq + ((size_t)b * T + row) * d + h * DH;
#pragma unroll
    for (int c = 0; c < CPT; ++c) drow[tx + 16 * c] = accq[r][c];
  }
}

// backward, pass 2: per (b, h, KC keys): every query row in order of QT
// rows; the block owns its keys' dk and dv, so no two blocks write one
// element
template <int DH>
__global__ void __launch_bounds__(NT)
    mha_bwd_dkdv_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ mask,
                        const int* __restrict__ seed,
                        const float* __restrict__ g,
                        const float* __restrict__ stats,
                        float* __restrict__ dk, float* __restrict__ dv, int T,
                        int S, int H, int mask_rows, float sqrt_dh,
                        uint32_t thresh, float keep_div, int dropout) {
  extern __shared__ float smem[];
  float* ks = smem;                   // [KC][DH+1]
  float* vs = ks + KC * (DH + 1);     // [KC][DH+1]
  float* qs = vs + KC * (DH + 1);     // [QT][DH+1]
  float* gs = qs + QT * (DH + 1);     // [QT][DH+1]
  float* pt = gs + QT * (DH + 1);     // [QT][KC+1] attn
  float* dt = pt + QT * (KC + 1);     // [QT][KC+1] ds / sqrt(dh)
  __shared__ float rs[QT][3];
  const int d = H * DH, b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * KC;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qb = q + (size_t)b * T * d;
  const float* gb = g + (size_t)b * T * d;
  const size_t stat_base = (size_t)(b * H + h) * T;
  const uint32_t base = dropout ? hash_base(*seed, b * H + h) : 0u;

  load_tile<DH, KC>(ks, k + (size_t)b * S * d, k0, S, d, h);
  load_tile<DH, KC>(vs, v + (size_t)b * S * d, k0, S, d, h);
  constexpr int CPT = DH / 16;
  float adk[4][CPT], adv[4][CPT];  // keys ty*4 + m, columns tx + 16*c
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) adk[m][c] = adv[m][c] = 0.f;

  for (int q0 = 0; q0 < T; q0 += QT) {
    __syncthreads();
    load_tile<DH, QT>(qs, qb, q0, T, d, h);
    load_tile<DH, QT>(gs, gb, q0, T, d, h);
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
        const float a = pt[i * (KC + 1) + ty * 4 + m];
        const float s = dt[i * (KC + 1) + ty * 4 + m];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          adv[m][c] += a * gv[c];
          adk[m][c] += s * qv[c];
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int key = k0 + ty * 4 + m;
    if (key >= S) continue;
    float* krow = dk + ((size_t)b * S + key) * d + h * DH;
    float* vrow = dv + ((size_t)b * S + key) * d + h * DH;
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
int fwd(const float* q, const float* k, const float* v, const float* mask,
        const int* seed, float* out, int B, int T, int S, int H,
        int mask_rows, uint32_t thresh, float keep_div, int dropout,
        cudaStream_t stream) {
  const size_t smem = fwd_smem(DH, S);
  dim3 grid((T + QT - 1) / QT, H, B);
  cudaError_t err = allow_smem(mha_fwd_kernel<DH>, smem);
  if (err != cudaSuccess) return (int)err;
  mha_fwd_kernel<DH><<<grid, NT, smem, stream>>>(
      q, k, v, mask, seed, out, T, S, H, mask_rows, sqrtf((float)DH), thresh,
      keep_div, dropout);
  return (int)cudaGetLastError();
}

template <int DH>
int bwd(const float* q, const float* k, const float* v, const float* mask,
        const int* seed, const float* g, const float* o, float* dq, float* dk,
        float* dv, float* stats, int B, int T, int S, int H, int mask_rows,
        uint32_t thresh, float keep_div, int dropout, cudaStream_t stream) {
  const float sqrt_dh = sqrtf((float)DH);
  const size_t s1 = dq_smem(DH, S), s2 = dkdv_smem(DH);
  dim3 g1((T + QT - 1) / QT, H, B), g2((S + KC - 1) / KC, H, B);
  cudaError_t err = allow_smem(mha_bwd_dq_kernel<DH>, s1);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(mha_bwd_dkdv_kernel<DH>, s2);
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dq_kernel<DH><<<g1, NT, s1, stream>>>(
      q, k, v, mask, seed, g, o, dq, stats, T, S, H, mask_rows, sqrt_dh,
      thresh, keep_div, dropout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dkdv_kernel<DH><<<g2, NT, s2, stream>>>(
      q, k, v, mask, seed, g, stats, dk, dv, T, S, H, mask_rows, sqrt_dh,
      thresh, keep_div, dropout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,T,H*dh], k/v [B,S,H*dh], mask [B,mask_rows,S] f32 (< 0: masked),
// seed int32 [1] on the card, out [B,T,H*dh]; dh in {32, 64, 128}, S <= 1024
int mha_train_fwd_f32(const float* q, const float* k, const float* v,
                      const float* mask, const int* seed, float* out, int B,
                      int T, int S, int H, int dh, int mask_rows,
                      unsigned int thresh, float keep_div, int dropout,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 32:
      return fwd<32>(q, k, v, mask, seed, out, B, T, S, H, mask_rows, thresh,
                     keep_div, dropout, st);
    case 64:
      return fwd<64>(q, k, v, mask, seed, out, B, T, S, H, mask_rows, thresh,
                     keep_div, dropout, st);
    case 128:
      return fwd<128>(q, k, v, mask, seed, out, B, T, S, H, mask_rows, thresh,
                      keep_div, dropout, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// g, o [B,T,H*dh] (the upstream gradient and the forward output);
// dq [B,T,H*dh], dk/dv [B,S,H*dh]; stats scratch [B*H*T*3] f32
int mha_train_bwd_f32(const float* q, const float* k, const float* v,
                      const float* mask, const int* seed, const float* g,
                      const float* o, float* dq, float* dk, float* dv,
                      float* stats, int B, int T, int S, int H, int dh,
                      int mask_rows, unsigned int thresh, float keep_div,
                      int dropout, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 32:
      return bwd<32>(q, k, v, mask, seed, g, o, dq, dk, dv, stats, B, T, S, H,
                     mask_rows, thresh, keep_div, dropout, st);
    case 64:
      return bwd<64>(q, k, v, mask, seed, g, o, dq, dk, dv, stats, B, T, S, H,
                     mask_rows, thresh, keep_div, dropout, st);
    case 128:
      return bwd<128>(q, k, v, mask, seed, g, o, dq, dk, dv, stats, B, T, S,
                      H, mask_rows, thresh, keep_div, dropout, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
