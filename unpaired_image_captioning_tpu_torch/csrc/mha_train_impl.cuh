// The kernels of the training attention and their host launchers, as
// templates over the head width. mha_train.cu instantiates dh 64 and holds
// the entry points; mha_train_dh32.cu and mha_train_dh128.cu instantiate the
// other widths, so the three compile in parallel (see mha_train.cu for the
// design).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mha_train.cuh"

namespace uic {
namespace mha {

constexpr int NT = 256;           // threads a block: tx = tid % 16, ty = tid / 16
constexpr int TILE = 64;          // queries and keys per tile
constexpr int PAD = 4;            // floats after each shared row
constexpr int LDP = TILE + PAD;   // row of a [64][64] probability tile
constexpr float NEG = -1e9f;

template <int N>
struct IC {
  static constexpr int value = N;
};

template <int DH>
struct Lay {
  static constexpr int LD = DH + PAD;           // row of a [64][DH] tile
  static constexpr int TILE_F = TILE * LD;
  static constexpr int VEC = DH >= 64 ? 4 : 2;  // adjacent output columns
  static constexpr int NV = DH / (16 * VEC);    // vectors of them a thread
  static constexpr int CPT = DH / 16;           // output columns a thread
  static constexpr int MIN_BLOCKS = DH <= 64 ? 2 : 1;
};

static __device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

static __device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

static __device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// over the 16 lanes of one ty (lanes 0-15 and 16-31 of a warp)
static __device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static __device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f(IC<n>) for n in 1..4: the 16-row groups of a tile that hold valid rows
// or keys, as a compile-time extent
template <typename F>
__device__ __forceinline__ void with_extent(int n, F&& f) {
  switch (n) {
    case 1: f(IC<1>{}); break;
    case 2: f(IC<2>{}); break;
    case 3: f(IC<3>{}); break;
    default: f(IC<4>{}); break;
  }
}

static __device__ __forceinline__ int groups(int n) { return (n + 15) / 16; }

// rows [r0, r0 + 64) of head h of one batch element's [L, ld] matrix into
// dst [64][DH + PAD]; rows past L are zero
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int L, int ld, int h) {
  constexpr int C4 = DH / 4;
  for (int e = threadIdx.x; e < TILE * C4; e += NT) {
    const int r = e / C4, c = (e % C4) * 4, row = r0 + r;
    const bool ok = row < L;
    cp16(dst + r * Lay<DH>::LD + c,
         ok ? src + (size_t)row * ld + h * DH + c : src, ok);
  }
}

// acc[i][j] = A[ty + 16i] . B[tx + 16j] over DH, i < IN, j < JN
template <int DH, int IN, int JN>
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         float (&acc)[4][4], int ty, int tx) {
  constexpr int LD = Lay<DH>::LD;
#pragma unroll
  for (int i = 0; i < IN; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DH; c += 4) {
    float4 av[IN], bv[JN];
#pragma unroll
    for (int i = 0; i < IN; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + c);
#pragma unroll
    for (int j = 0; j < JN; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + c);
#pragma unroll
    for (int i = 0; i < IN; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j)
        acc[i][j] = fmaf(av[i].w, bv[j].w,
                         fmaf(av[i].z, bv[j].z,
                              fmaf(av[i].y, bv[j].y,
                                   fmaf(av[i].x, bv[j].x, acc[i][j]))));
  }
}

// acc[r][n*VEC + v] += sum over k < kn of P[ty + 16r][k] * M[k][col] for
// r < R, col = n*16*VEC + tx*VEC + v; P [64][LDP], M [64][DH + PAD]; kn a
// multiple of 4
template <int DH, int R>
__device__ __forceinline__ void acc_rows(const float* P, const float* M,
                                         int kn, float (&acc)[4][DH / 16],
                                         int ty, int tx) {
  using L = Lay<DH>;
#pragma unroll 2
  for (int k = 0; k < kn; k += 4) {
    float4 pv[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      pv[r] = *reinterpret_cast<const float4*>(P + (ty + 16 * r) * LDP + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* mrow = M + (k + q) * L::LD + tx * L::VEC;
      float mv[L::CPT];
#pragma unroll
      for (int n = 0; n < L::NV; ++n) {
        if constexpr (L::VEC == 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(mrow + n * 16 * L::VEC);
          mv[n * 4] = t.x;
          mv[n * 4 + 1] = t.y;
          mv[n * 4 + 2] = t.z;
          mv[n * 4 + 3] = t.w;
        } else {
          const float2 t =
              *reinterpret_cast<const float2*>(mrow + n * 16 * L::VEC);
          mv[n * 2] = t.x;
          mv[n * 2 + 1] = t.y;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int cc = 0; cc < L::CPT; ++cc)
          acc[r][cc] = fmaf(comp(pv[r], q), mv[cc], acc[r][cc]);
    }
  }
}

// dst[col] = vals[cc] over the thread's columns of one head row
template <int DH>
__device__ __forceinline__ void store_row(float* dst, const float* vals,
                                          int tx) {
  using L = Lay<DH>;
#pragma unroll
  for (int n = 0; n < L::NV; ++n) {
    float* p = dst + n * 16 * L::VEC + tx * L::VEC;
    const float* v = vals + n * L::VEC;
    if constexpr (L::VEC == 4)
      *reinterpret_cast<float4*>(p) =
          make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

static __device__ __forceinline__ const float* mask_row(const Attn& a, int b,
                                                 int row) {
  const int r = a.mask_rows == 1 ? 0 : min(row, a.T - 1);
  return a.mask + ((size_t)b * a.mask_rows + r) * a.S;
}

// One block's forward over query rows [q0, q0 + 16 QG).
template <int DH, int QG>
__device__ __forceinline__ void fwd_block(const Attn& a,
                                          float* __restrict__ out,
                                          float* __restrict__ stats,
                                          float inv_sqrt, float* smem,
                                          int q0) {
  using L = Lay<DH>;
  constexpr int CPT = L::CPT;
  float* qs = smem;                    // [64][LD]
  float* kvs = qs + L::TILE_F;         // 2 stages x (K, V), [64][LD] each
  float* ps = kvs + 4 * L::TILE_F;     // [64][LDP] probabilities
  const int T = a.T, S = a.S;
  const int b = blockIdx.z, h = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* kb = a.k + (size_t)b * S * a.lk;
  const float* vb = a.v + (size_t)b * S * a.lv;
  const int q_end = min(T, q0 + 16 * QG);
  const int in = groups(q_end - q0);
  const int n_kt = (S + TILE - 1) / TILE;
  const uint32_t base = a.dropout ? hash_base(*a.seed, b * a.pid_b + h) : 0u;
  const float* mrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mrow[i] = mask_row(a, b, q0 + ty + 16 * i);

  load_tile<DH>(qs, a.q + (size_t)b * T * a.lq, q0, q_end, a.lq, h);
  load_tile<DH>(kvs, kb, 0, S, a.lk, h);
  load_tile<DH>(kvs + L::TILE_F, vb, 0, S, a.lv, h);
  cp_commit();

  float o[4][CPT], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE;
    if (kt + 1 < n_kt) {
      float* nxt = kvs + ((kt + 1) & 1) * 2 * L::TILE_F;
      load_tile<DH>(nxt, kb, k0 + TILE, S, a.lk, h);
      load_tile<DH>(nxt + L::TILE_F, vb, k0 + TILE, S, a.lv, h);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* ks = kvs + (kt & 1) * 2 * L::TILE_F;
    const float* vs = ks + L::TILE_F;
    const int nk = min(TILE, S - k0);
    with_extent(groups(nk), [&](auto J) {
      constexpr int IN = QG, JN = decltype(J)::value;
      float s[4][4];
      dot_tile<DH, IN, JN>(qs, ks, s, ty, tx);
      float mk[JN];   // row 0's mask, every row's where the mask is [B,1,S]
#pragma unroll
      for (int i = 0; i < IN; ++i) {
        const int row = q0 + ty + 16 * i;
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          const int key = k0 + tx + 16 * j;
          float v = -INFINITY;    // past S: not a key of the row
          if (key < S) {
            if (i == 0 || a.mask_rows != 1) mk[j] = mrow[i][key];
            v = mk[j] < 0.f ? NEG : s[i][j] * inv_sqrt;
          }
          s[i][j] = v;
          tmax = fmaxf(tmax, v);
        }
        const float mn = fmaxf(m[i], group_max(tmax));
        const float alpha = __expf(m[i] - mn);   // 0 on the first tile
        m[i] = mn;
        l[i] *= alpha;
#pragma unroll
        for (int c = 0; c < CPT; ++c) o[i][c] *= alpha;
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          const int key = k0 + tx + 16 * j;
          const float e = __expf(s[i][j] - mn);
          l[i] += e;
          float p = e;
          if (a.dropout && key < S &&
              keep_hash(base, (uint32_t)(row * S + key)) < a.thresh)
            p = 0.f;
          ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        }
      }
      __syncthreads();
      acc_rows<DH, IN>(ps, vs, (nk + 3) & ~3, o, ty, tx);
    });
    // every thread is done with this stage and with ps before the next
    // tile's prefetch and probabilities overwrite them
    __syncthreads();
  }

  const size_t bh = (size_t)b * a.H + h;
  float* st_m = stats + bh * T;
  float* st_l = stats + (size_t)a.B * a.H * T + bh * T;
#pragma unroll
  for (int i = 0; i < QG; ++i) {
    const float lt = group_sum(l[i]);
    const int row = q0 + ty + 16 * i;
    if (i >= in || row >= T) continue;
    const float inv = a.dropout ? 1.f / (lt * a.keep_div) : 1.f / lt;
    float vals[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) vals[c] = o[i][c] * inv;
    store_row<DH>(out + ((size_t)b * T + row) * a.lo + h * DH, vals, tx);
    if (tx == 0) {
      st_m[row] = m[i];
      st_l[row] = lt;
    }
  }
}

// A block per (b, h, tile_rows queries) (32 where T <= 32, else 64), which
// runs as 16, 32 or 64 rows after the rows its tile holds: the ragged last
// tile of T = 196 (4 rows) costs a quarter of a full one.
template <int DH>
__global__ void __launch_bounds__(NT, Lay<DH>::MIN_BLOCKS)
    mha_fwd_kernel(const __grid_constant__ Attn a, float* __restrict__ out,
                   float* __restrict__ stats, float inv_sqrt, int tile_rows) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * tile_rows, rows = min(tile_rows, a.T - q0);
  if (rows <= 16)
    fwd_block<DH, 1>(a, out, stats, inv_sqrt, smem, q0);
  else if (rows <= 32)
    fwd_block<DH, 2>(a, out, stats, inv_sqrt, smem, q0);
  else
    fwd_block<DH, 4>(a, out, stats, inv_sqrt, smem, q0);
}

// D_i = g_i . o_i over head h's columns: a warp per (b, t, h)
static __global__ void __launch_bounds__(256)
    mha_dsum_kernel(const __grid_constant__ Attn a, const float* __restrict__ g,
                    const float* __restrict__ o, float* __restrict__ dsum) {
  const int warp = (int)((blockIdx.x * 256u + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= a.B * a.T * a.H) return;
  const int h = warp % a.H, bt = warp / a.H;
  const int b = bt / a.T, t = bt % a.T;
  const float* gr = g + (size_t)bt * a.lo + h * a.dh;
  const float* orow = o + (size_t)bt * a.lo + h * a.dh;
  float acc = 0.f;
  for (int c = lane; c < a.dh; c += 32) acc += gr[c] * orow[c];
  acc = warp_sum(acc);
  if (lane == 0) dsum[((size_t)b * a.H + h) * a.T + t] = acc;
}

// attn and ds of one score-tile element; row < T and key < S
struct Grad {
  float attn, ds;
};

// (inv_l = 1 / l, inv_keep = 1 / (1 - rate), inv_sqrt = 1 / sqrt(dh))
static __device__ __forceinline__ Grad grad_at(const Attn& a, uint32_t base,
                                        const float* mrow, int row, int key,
                                        float s, float dp, float m,
                                        float inv_l, float d, float inv_keep,
                                        float inv_sqrt) {
  const bool masked = mrow[key] < 0.f;
  const float p = __expf((masked ? NEG : s * inv_sqrt) - m) * inv_l;
  float attn = p;
  if (a.dropout) {
    const bool keep = keep_hash(base, (uint32_t)(row * a.S + key)) >= a.thresh;
    attn = keep ? p * inv_keep : 0.f;
    dp = keep ? dp * inv_keep : 0.f;
  }
  return Grad{attn, masked ? 0.f : p * (dp - d) * inv_sqrt};
}

// One block of the dk / dv kernel over keys [k0, k0 + 16 JN).
template <int DH, int JN>
__device__ __forceinline__ void dkdv_block(
    const Attn& a, const float* __restrict__ g,
    const float* __restrict__ stats, const float* __restrict__ dsum,
    float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ ds_out, float inv_sqrt, float* smem, int k0) {
  using L = Lay<DH>;
  constexpr int CPT = L::CPT;
  float* ks = smem;                    // [64][LD] each
  float* vs = ks + L::TILE_F;
  float* qs = vs + L::TILE_F;
  float* gs = qs + L::TILE_F;
  float* pt = gs + L::TILE_F;          // [key][query] attn, [64][LDP]
  float* dt = pt + TILE * LDP;         // [key][query] ds
  __shared__ float rm[TILE], rl[TILE], rd[TILE];
  const int T = a.T, S = a.S;
  const int b = blockIdx.z, h = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qb = a.q + (size_t)b * T * a.lq;
  const float* gb = g + (size_t)b * T * a.lo;
  const size_t bh = (size_t)b * a.H + h;
  const float* st_m = stats + bh * T;
  const float* st_l = stats + (size_t)a.B * a.H * T + bh * T;
  const float* dd = dsum + bh * T;
  const int lds = (S + 3) & ~3;
  float* dsg = ds_out + bh * T * lds;
  const uint32_t base = a.dropout ? hash_base(*a.seed, b * a.pid_b + h) : 0u;
  const float inv_keep = 1.f / a.keep_div;

  load_tile<DH>(ks, a.k + (size_t)b * S * a.lk, k0, S, a.lk, h);
  load_tile<DH>(vs, a.v + (size_t)b * S * a.lv, k0, S, a.lv, h);
  cp_commit();
  float adk[4][CPT], adv[4][CPT];   // keys ty + 16j, the thread's columns
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < CPT; ++c) adk[j][c] = adv[j][c] = 0.f;

  for (int q0 = 0; q0 < T; q0 += TILE) {
    __syncthreads();   // the previous tile's qs, gs, pt, dt are read
    load_tile<DH>(qs, qb, q0, T, a.lq, h);
    load_tile<DH>(gs, gb, q0, T, a.lo, h);
    cp_commit();
    if (threadIdx.x < TILE) {
      const int row = q0 + threadIdx.x;
      const bool ok = row < T;
      rm[threadIdx.x] = ok ? st_m[row] : 0.f;
      rl[threadIdx.x] = ok ? 1.f / st_l[row] : 1.f;
      rd[threadIdx.x] = ok ? dd[row] : 0.f;
    }
    cp_wait<0>();
    __syncthreads();
    const int nq = min(TILE, T - q0);
    with_extent(groups(nq), [&](auto I) {
      constexpr int IN = decltype(I)::value;
      float s[4][4], dp[4][4];
      dot_tile<DH, IN, JN>(qs, ks, s, ty, tx);
      dot_tile<DH, IN, JN>(gs, vs, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < IN; ++i) {
        const int qi = ty + 16 * i, row = q0 + qi;
        const float* mrow = mask_row(a, b, row);
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          const int kj = tx + 16 * j, key = k0 + kj;
          Grad gr{0.f, 0.f};
          if (row < T && key < S)
            gr = grad_at(a, base, mrow, row, key, s[i][j], dp[i][j], rm[qi],
                         rl[qi], rd[qi], inv_keep, inv_sqrt);
          pt[kj * LDP + qi] = gr.attn;
          dt[kj * LDP + qi] = gr.ds;
          if (row < T && key < lds) dsg[(size_t)row * lds + key] = gr.ds;
        }
      }
      __syncthreads();
      const int kn = (nq + 3) & ~3;
      acc_rows<DH, JN>(pt, gs, kn, adv, ty, tx);
      acc_rows<DH, JN>(dt, qs, kn, adk, ty, tx);
    });
  }
#pragma unroll
  for (int j = 0; j < JN; ++j) {
    const int key = k0 + ty + 16 * j;
    if (key >= S) continue;
    store_row<DH>(dk + ((size_t)b * S + key) * a.lk + h * DH, adk[j], tx);
    store_row<DH>(dv + ((size_t)b * S + key) * a.lv + h * DH, adv[j], tx);
  }
}

// backward: a block per (b, h, 64 keys) walks the query tiles in order,
// owns its keys' dk and dv, and writes its columns of ds / sqrt(dh) to
// ds_out [B, H, T, lds] (lds = S rounded up to 4; zero past S). A last
// tile of at most 16 keys runs as a 16-key block.
template <int DH>
__global__ void __launch_bounds__(NT, Lay<DH>::MIN_BLOCKS)
    mha_bwd_dkdv_kernel(const __grid_constant__ Attn a,
                        const float* __restrict__ g,
                        const float* __restrict__ stats,
                        const float* __restrict__ dsum,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ ds_out, float inv_sqrt) {
  extern __shared__ __align__(16) float smem[];
  const int k0 = blockIdx.x * TILE;
  if (a.S - k0 <= 16)
    dkdv_block<DH, 1>(a, g, stats, dsum, dk, dv, ds_out, inv_sqrt, smem, k0);
  else
    dkdv_block<DH, 4>(a, g, stats, dsum, dk, dv, ds_out, inv_sqrt, smem, k0);
}

// One block of the dq kernel over query rows [q0, q0 + 16 QG): it walks the
// key tiles in order and owns its rows' dq = sum over keys of ds k, from
// the ds tiles the dk / dv kernel wrote (ds [B, H, T, lds]),
// double-buffered with K.
template <int DH, int QG>
__device__ __forceinline__ void dq_block(const Attn& a,
                                         const float* __restrict__ ds,
                                         float* __restrict__ dq, float* smem,
                                         int q0) {
  using L = Lay<DH>;
  constexpr int CPT = L::CPT;
  constexpr int STAGE = TILE * LDP + L::TILE_F;   // ds tile, then K tile
  const int T = a.T, S = a.S, lds = (S + 3) & ~3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q_end = min(T, q0 + 16 * QG);
  const float* dsb = ds + ((size_t)b * a.H + h) * T * lds;
  const float* kb = a.k + (size_t)b * S * a.lk;
  const int n_kt = (S + TILE - 1) / TILE;

  auto load = [&](int stage, int k0) {
    float* d_s = smem + stage * STAGE;
    for (int e = threadIdx.x; e < 16 * QG * (TILE / 4); e += NT) {
      const int r = e / (TILE / 4), c = (e % (TILE / 4)) * 4;
      const int row = q0 + r, col = k0 + c;
      const bool ok = row < q_end && col < lds;
      cp16(d_s + r * LDP + c, ok ? dsb + (size_t)row * lds + col : dsb, ok);
    }
    load_tile<DH>(d_s + TILE * LDP, kb, k0, S, a.lk, h);
    cp_commit();
  };

  float adq[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) adq[i][c] = 0.f;
  load(0, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE;
    if (kt + 1 < n_kt) {
      load((kt + 1) & 1, k0 + TILE);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* d_s = smem + (kt & 1) * STAGE;
    acc_rows<DH, QG>(d_s, d_s + TILE * LDP, (min(TILE, S - k0) + 3) & ~3,
                     adq, ty, tx);
    // every thread is done with this stage before the next prefetch
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < QG; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
    store_row<DH>(dq + ((size_t)b * T + row) * a.lq + h * DH, adq[i], tx);
  }
}

// A block per (b, h, tile_rows queries), run as 16, 32 or 64 rows (as the
// forward's).
template <int DH>
__global__ void __launch_bounds__(NT)
    mha_bwd_dq_kernel(const __grid_constant__ Attn a,
                      const float* __restrict__ ds, float* __restrict__ dq,
                      int tile_rows) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * tile_rows, rows = min(tile_rows, a.T - q0);
  if (rows <= 16)
    dq_block<DH, 1>(a, ds, dq, smem, q0);
  else if (rows <= 32)
    dq_block<DH, 2>(a, ds, dq, smem, q0);
  else
    dq_block<DH, 4>(a, ds, dq, smem, q0);
}

template <int DH>
size_t fwd_smem() {
  return sizeof(float) * (5 * Lay<DH>::TILE_F + TILE * LDP);
}
template <int DH>
size_t dkdv_smem() {
  return sizeof(float) * (4 * Lay<DH>::TILE_F + 2 * TILE * LDP);
}
template <int DH>
size_t dq_smem() {
  return sizeof(float) * 2 * (TILE * LDP + Lay<DH>::TILE_F);
}

// opt the kernel in to `smem` bytes of dynamic shared memory (above 48 KB)
// on the current device; every launch asks, so each device is opted in
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

static inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// 1 / sqrt(dh), as the kernels scale the scores
template <int DH>
float inv_sqrt() {
  return 1.0f / sqrtf((float)DH);
}

// the query rows of a block's tile: 32 for short sequences (the decoder's
// 17 tokens), else 64
inline int tile_rows(int T) { return T <= 32 ? 32 : 64; }

template <int DH>
int fwd(const Attn& a, float* out, float* stats, cudaStream_t stream) {
  const size_t smem = fwd_smem<DH>();
  const cudaError_t err = allow_smem(mha_fwd_kernel<DH>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = tile_rows(a.T);
  mha_fwd_kernel<DH><<<dim3(cdiv(a.T, rows), a.H, a.B), NT, smem, stream>>>(
      a, out, stats, inv_sqrt<DH>(), rows);
  return (int)cudaGetLastError();
}

template <int DH>
int bwd(const Attn& a, const float* g, const float* o, const float* stats,
        float* dq, float* dk, float* dv, float* scratch, cudaStream_t stream) {
  float* dsum = scratch;
  float* ds = scratch + attn_dsum_floats(a.B, a.H, a.T);
  const float is = inv_sqrt<DH>();
  const size_t s1 = dkdv_smem<DH>(), s2 = dq_smem<DH>();
  cudaError_t err;
  if ((err = allow_smem(mha_bwd_dkdv_kernel<DH>, s1)) != cudaSuccess)
    return (int)err;
  if ((err = allow_smem(mha_bwd_dq_kernel<DH>, s2)) != cudaSuccess)
    return (int)err;
  const long long n_rows = (long long)a.B * a.T * a.H;
  mha_dsum_kernel<<<(unsigned)((n_rows * 32 + 255) / 256), 256, 0, stream>>>(
      a, g, o, dsum);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mha_bwd_dkdv_kernel<DH><<<dim3(cdiv(a.S, TILE), a.H, a.B), NT, s1,
                            stream>>>(a, g, stats, dsum, dk, dv, ds, is);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int rows = tile_rows(a.T);
  mha_bwd_dq_kernel<DH><<<dim3(cdiv(a.T, rows), a.H, a.B), NT, s2, stream>>>(
      a, ds, dq, rows);
  return (int)cudaGetLastError();
}

}  // namespace mha
}  // namespace uic
