// The kernels of the training attention and their host launchers, as
// templates over a head-width bucket DH and a mode: PADDED runs any head
// width dh <= DH that is a multiple of 4, its tiles DH wide with the columns
// past dh zero (loaded as zeros, never stored); FULL runs dh = DH alone, with
// those bounds compiled out; ODD runs any dh <= DH with 4-byte copies and
// scalar stores, for a width or a row stride that is not a multiple of 4
// (16-byte rows) or a tensor not 16-byte aligned. Bucket 256 also runs
// every dh above 256 (the *_wide kernels: column chunks of 256). mha_train.cu
// instantiates DH 64 and holds the entry points; mha_train_dh32.cu,
// _dh128.cu and _dh256.cu instantiate the other buckets, so the four
// compile in parallel (see mha_train.cu for the design).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"
#include "mha_train.cuh"

namespace uic {
namespace mha {

using uic_bf16::ld4t;
using uic_bf16::ldf;
using uic_bf16::ldt;
using uic_bf16::rnd_if;
using uic_bf16::round_bf16;
using uic_bf16::stf;

constexpr int NT = 256;           // threads a block: tx = tid % 16, ty = tid / 16
constexpr int PAD = 4;            // floats after each shared row
constexpr float NEG = -1e9f;
constexpr int WIDE = 256;         // the column chunk of a head wider than 256

// the modes of an instance (see above)
constexpr int FULL = 0, PADDED = 1, ODD = 2;

template <int N>
struct IC {
  static constexpr int value = N;
};

template <int DH>
struct Lay {
  // queries and keys a tile: 64, or 32 at DH 256, whose [64][DH] tiles
  // would not fit the forward's five in 227 KB of shared memory
  static constexpr int TILE = DH <= 128 ? 64 : 32;
  static constexpr int G = TILE / 16;           // 16-row groups a tile
  static constexpr int LDP = TILE + PAD;        // row of a probability tile
  static constexpr int LD = DH + PAD;           // row of a [TILE][DH] tile
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

static __device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
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

// f(IC<n>) for n in 1..G: the 16-row groups of a tile that hold valid rows
// or keys, as a compile-time extent
template <int G, typename F>
__device__ __forceinline__ void with_extent(int n, F&& f) {
  if constexpr (G == 2) {
    if (n <= 1) f(IC<1>{}); else f(IC<2>{});
  } else {
    switch (n) {
      case 1: f(IC<1>{}); break;
      case 2: f(IC<2>{}); break;
      case 3: f(IC<3>{}); break;
      default: f(IC<4>{}); break;
    }
  }
}

static __device__ __forceinline__ int groups(int n) { return (n + 15) / 16; }

// rows [r0, r0 + TILE) of the dh columns from col0 of one batch element's
// [L, ld] matrix, which starts `off` elements into src, into dst
// [TILE][DH + PAD]; rows past L and columns past dh are zero. V4: 16-byte
// copies (dh, ld and col0 multiples of 4, src 16-byte aligned), else 4-byte
// ones. bf: src is bf16, read through converting loads (four at a time
// with V4) and stored to shared memory as f32 by the threads themselves.
template <int DH, bool V4 = true>
__device__ __forceinline__ void load_tile(float* dst, const void* src_v,
                                          size_t off, int r0, int L, int ld,
                                          int col0, int dh, bool bf) {
  if (bf) {
    constexpr int W = V4 ? 4 : 1;
    for (int e = threadIdx.x; e < Lay<DH>::TILE * DH / W; e += NT) {
      const int r = e / (DH / W), c = (e % (DH / W)) * W, row = r0 + r;
      const bool ok = row < L && c < dh;
      const size_t i = off + (size_t)row * ld + col0 + c;
      float* d = dst + r * Lay<DH>::LD + c;
      if constexpr (V4)
        *reinterpret_cast<float4*>(d) =
            ok ? ld4t<true>(src_v, i) : make_float4(0.f, 0.f, 0.f, 0.f);
      else
        *d = ok ? ldt<true>(src_v, i) : 0.f;
    }
    return;
  }
  const float* src = static_cast<const float*>(src_v) + off;
  if constexpr (!V4) {
    for (int e = threadIdx.x; e < Lay<DH>::TILE * DH; e += NT) {
      const int r = e / DH, c = e % DH, row = r0 + r;
      const bool ok = row < L && c < dh;
      cp4(dst + r * Lay<DH>::LD + c,
          ok ? src + (size_t)row * ld + col0 + c : src, ok);
    }
    return;
  }
  constexpr int C4 = DH / 4;
  for (int e = threadIdx.x; e < Lay<DH>::TILE * C4; e += NT) {
    const int r = e / C4, c = (e % C4) * 4, row = r0 + r;
    const bool ok = row < L && c < dh;
    cp16(dst + r * Lay<DH>::LD + c,
         ok ? src + (size_t)row * ld + col0 + c : src, ok);
  }
}

// acc[i][j] = A[ty + 16i] . B[tx + 16j] over DH, i < IN, j < JN (ZERO
// false: added to acc, the wide kernels' sum over column chunks)
template <int DH, int IN, int JN, bool ZERO = true>
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         float (&acc)[4][4], int ty, int tx) {
  constexpr int LD = Lay<DH>::LD;
  if constexpr (ZERO) {
#pragma unroll
    for (int i = 0; i < IN; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
  }
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
// r < R, col = n*16*VEC + tx*VEC + v; P [TILE][LDP], M [TILE][DH + PAD]; kn
// a multiple of 4
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
      pv[r] = *reinterpret_cast<const float4*>(P + (ty + 16 * r) * L::LDP + k);
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

// dst[col] = vals[cc] over the thread's columns of one head row, which
// starts `off` elements into dst, the columns below dh (V4: a multiple of 4,
// so a vector is in or out whole; else element by element); bf: dst is
// bf16, each value rounded as it is stored; rnd: the values rounded to bf16
// in an f32 dst
template <int DH, bool V4 = true>
__device__ __forceinline__ void store_row(void* dst_v, size_t off,
                                          const float* vals, int tx, int dh,
                                          bool bf, bool rnd) {
  using L = Lay<DH>;
  float* dst = static_cast<float*>(dst_v) + off;
#pragma unroll
  for (int n = 0; n < L::NV; ++n) {
    const int col = n * 16 * L::VEC + tx * L::VEC;
    if (col >= dh) continue;
    if (bf || rnd) {
#pragma unroll
      for (int v = 0; v < L::VEC; ++v)
        if (col + v < dh)
          stf(dst_v, off + col + v, rnd_if(vals[n * L::VEC + v], rnd), bf);
      continue;
    }
    if constexpr (!V4) {
#pragma unroll
      for (int v = 0; v < L::VEC; ++v)
        if (col + v < dh) dst[col + v] = vals[n * L::VEC + v];
      continue;
    }
    float* p = dst + col;
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

// An unmasked score q.k scaled: s / sqrt(dh) in f32 (as s * inv_sqrt), or
// on the bf16 cast points (rnd) s rounded to bf16 and divided in bf16 by
// sqrt(dh) rounded to bf16 (sqrt_bf), as the TPU kernel's bf16 route and
// the plain einsum with a bf16 q compute it
static __device__ __forceinline__ float scaled(float s, float inv_sqrt,
                                               float sqrt_bf, bool rnd) {
  return rnd ? round_bf16(round_bf16(s) / sqrt_bf) : s * inv_sqrt;
}

// sqrt(dh) rounded to bf16, the divisor of the bf16 route
static __device__ __forceinline__ float sqrt_bf_of(int dh) {
  return round_bf16(sqrtf((float)dh));
}

// One block's forward over query rows [q0, q0 + 16 QG).
template <int DH, int QG, int MODE>
__device__ __forceinline__ void fwd_block(const Attn& a,
                                          void* __restrict__ out,
                                          float* __restrict__ stats,
                                          float inv_sqrt, float* smem,
                                          int q0) {
  using L = Lay<DH>;
  constexpr int CPT = L::CPT;
  float* qs = smem;                    // [TILE][LD]
  float* kvs = qs + L::TILE_F;         // 2 stages x (K, V), [TILE][LD] each
  float* ps = kvs + 4 * L::TILE_F;     // [TILE][LDP] probabilities
  const int T = a.T, S = a.S;
  const int b = blockIdx.z, h = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t kb = (size_t)b * S * a.lk, vb = (size_t)b * S * a.lv;
  const bool qbf = a.fl & ATT_Q_BF, kvbf = a.fl & ATT_KV_BF;
  const bool obf = a.fl & ATT_O_BF, rnd = a.fl & ATT_RND;
  const float sqrt_bf = sqrt_bf_of(a.dh);
  const int q_end = min(T, q0 + 16 * QG);
  const int in = groups(q_end - q0);
  const int n_kt = (S + L::TILE - 1) / L::TILE;
  const int dh = MODE == FULL ? DH : a.dh;   // FULL: nothing padded
  const int col0 = h * dh;
  const uint32_t base = a.dropout ? hash_base(*a.seed, b * a.pid_b + h) : 0u;
  const float* mrow[L::G];
#pragma unroll
  for (int i = 0; i < L::G; ++i) mrow[i] = mask_row(a, b, q0 + ty + 16 * i);

  load_tile<DH, MODE != ODD>(qs, a.q, (size_t)b * T * a.lq, q0, q_end, a.lq,
                             col0, dh, qbf);
  load_tile<DH, MODE != ODD>(kvs, a.k, kb, 0, S, a.lk, col0, dh, kvbf);
  load_tile<DH, MODE != ODD>(kvs + L::TILE_F, a.v, vb, 0, S, a.lv, col0, dh,
                             kvbf);
  cp_commit();

  float o[4][CPT], m[4], l[4], inv_l[4];
#pragma unroll
  for (int i = 0; i < QG; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    inv_l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.f;
  }
  const float inv_keep = 1.f / a.keep_div;

  // f32: one pass with an online softmax. The bf16 cast points (rnd): a
  // first pass takes each row's max and sum over every key tile, and a
  // second rounds the normalised probabilities themselves (with their
  // dropout) to bf16 before P.V, as the TPU kernel casts attn.
  for (int pass = rnd ? 0 : 1; pass < 2; ++pass) {
    const bool stats_only = pass == 0;
    const bool exact = rnd && pass == 1;
    if (exact) {
#pragma unroll
      for (int i = 0; i < QG; ++i) inv_l[i] = 1.f / group_sum(l[i]);
      load_tile<DH, MODE != ODD>(kvs, a.k, kb, 0, S, a.lk, col0, dh, kvbf);
      load_tile<DH, MODE != ODD>(kvs + L::TILE_F, a.v, vb, 0, S, a.lv, col0,
                                 dh, kvbf);
      cp_commit();
    }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * L::TILE;
    if (kt + 1 < n_kt) {
      float* nxt = kvs + ((kt + 1) & 1) * 2 * L::TILE_F;
      load_tile<DH, MODE != ODD>(nxt, a.k, kb, k0 + L::TILE, S, a.lk, col0,
                                 dh, kvbf);
      load_tile<DH, MODE != ODD>(nxt + L::TILE_F, a.v, vb, k0 + L::TILE, S,
                                 a.lv, col0, dh, kvbf);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* ks = kvs + (kt & 1) * 2 * L::TILE_F;
    const float* vs = ks + L::TILE_F;
    const int nk = min(L::TILE, S - k0);
    with_extent<L::G>(groups(nk), [&](auto J) {
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
            v = mk[j] < 0.f ? NEG : scaled(s[i][j], inv_sqrt, sqrt_bf, rnd);
          }
          s[i][j] = v;
          tmax = fmaxf(tmax, v);
        }
        if (exact) {
#pragma unroll
          for (int j = 0; j < JN; ++j) {
            const int key = k0 + tx + 16 * j;
            float p = __expf(s[i][j] - m[i]) * inv_l[i];
            if (a.dropout)
              p = key < S && keep_hash(base, (uint32_t)row * (uint32_t)S +
                                                 key) >= a.thresh
                      ? p * inv_keep
                      : 0.f;
            ps[(ty + 16 * i) * L::LDP + tx + 16 * j] = round_bf16(p);
          }
          continue;
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
              keep_hash(base, (uint32_t)row * (uint32_t)S + key) < a.thresh)
            p = 0.f;
          ps[(ty + 16 * i) * L::LDP + tx + 16 * j] = p;
        }
      }
      if (stats_only) return;
      __syncthreads();
      acc_rows<DH, IN>(ps, vs, (nk + 3) & ~3, o, ty, tx);
    });
    // every thread is done with this stage and with ps before the next
    // tile's prefetch and probabilities overwrite them
    __syncthreads();
  }
  }

  const size_t bh = (size_t)b * a.H + h;
  float* st_m = stats + bh * T;
  float* st_l = stats + (size_t)a.B * a.H * T + bh * T;
#pragma unroll
  for (int i = 0; i < QG; ++i) {
    const float lt = group_sum(l[i]);
    const int row = q0 + ty + 16 * i;
    if (i >= in || row >= T) continue;
    // the bf16 route's second pass summed normalised probabilities
    const float inv = rnd ? 1.f
                          : a.dropout ? 1.f / (lt * a.keep_div) : 1.f / lt;
    float vals[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) vals[c] = o[i][c] * inv;
    store_row<DH, MODE != ODD>(out, ((size_t)b * T + row) * a.lo + col0,
                               vals, tx, dh, obf, rnd);
    if (tx == 0) {
      st_m[row] = m[i];
      st_l[row] = lt;
    }
  }
}

// A block per (b, h, tile_rows queries) (32 where T <= 32 or the tile is
// 32 rows, else 64), which runs as 16, 32 or 64 rows after the rows its
// tile holds: the ragged last tile of T = 196 (4 rows) costs a quarter of a
// full one.
template <int DH, int MODE>
__global__ void __launch_bounds__(NT, Lay<DH>::MIN_BLOCKS)
    mha_fwd_kernel(const __grid_constant__ Attn a, void* __restrict__ out,
                   float* __restrict__ stats, float inv_sqrt, int tile_rows) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * tile_rows, rows = min(tile_rows, a.T - q0);
  if (rows <= 16)
    fwd_block<DH, 1, MODE>(a, out, stats, inv_sqrt, smem, q0);
  else if (Lay<DH>::G == 2 || rows <= 32)
    fwd_block<DH, 2, MODE>(a, out, stats, inv_sqrt, smem, q0);
  else if constexpr (Lay<DH>::G == 4)
    fwd_block<DH, 4, MODE>(a, out, stats, inv_sqrt, smem, q0);
}

// D_i = g_i . o_i over head h's columns: a warp per (b, t, h)
static __global__ void __launch_bounds__(256)
    mha_dsum_kernel(const __grid_constant__ Attn a, const void* __restrict__ g,
                    const void* __restrict__ o, float* __restrict__ dsum) {
  const int warp = (int)((blockIdx.x * 256u + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= a.B * a.T * a.H) return;
  const int h = warp % a.H, bt = warp / a.H;
  const int b = bt / a.T, t = bt % a.T;
  const size_t row = (size_t)bt * a.lo + h * a.dh;
  const bool obf = a.fl & ATT_O_BF;
  float acc = 0.f;
  for (int c = lane; c < a.dh; c += 32)
    acc += ldf(g, row + c, obf) * ldf(o, row + c, obf);
  acc = warp_sum(acc);
  if (lane == 0) dsum[((size_t)b * a.H + h) * a.T + t] = acc;
}

// attn and ds of one score-tile element; row < T and key < S
struct Grad {
  float attn, ds;
};

// (inv_l = 1 / l, inv_keep = 1 / (1 - rate), inv_sqrt = 1 / sqrt(dh),
// sqrt_bf = sqrt(dh) in bf16); on the bf16 cast points attn and ds are
// rounded to bf16, as the TPU kernel casts them before dV, dq and dk
static __device__ __forceinline__ Grad grad_at(const Attn& a, uint32_t base,
                                        const float* mrow, int row, int key,
                                        float s, float dp, float m,
                                        float inv_l, float d, float inv_keep,
                                        float inv_sqrt, float sqrt_bf) {
  const bool masked = mrow[key] < 0.f, rnd = a.fl & ATT_RND;
  const float p =
      __expf((masked ? NEG : scaled(s, inv_sqrt, sqrt_bf, rnd)) - m) * inv_l;
  float attn = p;
  if (a.dropout) {
    const bool keep =
        keep_hash(base, (uint32_t)row * (uint32_t)a.S + key) >= a.thresh;
    attn = keep ? p * inv_keep : 0.f;
    dp = keep ? dp * inv_keep : 0.f;
  }
  return Grad{rnd_if(attn, rnd),
              masked ? 0.f : rnd_if(p * (dp - d) * inv_sqrt, rnd)};
}

// One block of the dk / dv kernel over keys [k0, k0 + 16 JN).
template <int DH, int JN, int MODE>
__device__ __forceinline__ void dkdv_block(
    const Attn& a, const void* __restrict__ g,
    const float* __restrict__ stats, const float* __restrict__ dsum,
    void* __restrict__ dk, void* __restrict__ dv,
    float* __restrict__ ds_out, float inv_sqrt, float* smem, int k0) {
  using L = Lay<DH>;
  constexpr int CPT = L::CPT;
  float* ks = smem;                    // [64][LD] each
  float* vs = ks + L::TILE_F;
  float* qs = vs + L::TILE_F;
  float* gs = qs + L::TILE_F;
  float* pt = gs + L::TILE_F;          // [key][query] attn, [TILE][LDP]
  float* dt = pt + L::TILE * L::LDP;   // [key][query] ds
  __shared__ float rm[L::TILE], rl[L::TILE], rd[L::TILE];
  const int T = a.T, S = a.S;
  const int b = blockIdx.z, h = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qb = (size_t)b * T * a.lq, gb = (size_t)b * T * a.lo;
  const bool qbf = a.fl & ATT_Q_BF, kvbf = a.fl & ATT_KV_BF;
  const bool obf = a.fl & ATT_O_BF, rnd = a.fl & ATT_RND;
  const float sqrt_bf = sqrt_bf_of(a.dh);
  const size_t bh = (size_t)b * a.H + h;
  const float* st_m = stats + bh * T;
  const float* st_l = stats + (size_t)a.B * a.H * T + bh * T;
  const float* dd = dsum + bh * T;
  const int lds = (S + 3) & ~3;
  float* dsg = ds_out + bh * T * lds;
  const uint32_t base = a.dropout ? hash_base(*a.seed, b * a.pid_b + h) : 0u;
  const float inv_keep = 1.f / a.keep_div;
  const int dh = MODE == FULL ? DH : a.dh;   // FULL: nothing padded
  const int col0 = h * dh;

  load_tile<DH, MODE != ODD>(ks, a.k, (size_t)b * S * a.lk, k0, S, a.lk,
                             col0, dh, kvbf);
  load_tile<DH, MODE != ODD>(vs, a.v, (size_t)b * S * a.lv, k0, S, a.lv,
                             col0, dh, kvbf);
  cp_commit();
  float adk[4][CPT], adv[4][CPT];   // keys ty + 16j, the thread's columns
#pragma unroll
  for (int j = 0; j < JN; ++j)
#pragma unroll
    for (int c = 0; c < CPT; ++c) adk[j][c] = adv[j][c] = 0.f;

  for (int q0 = 0; q0 < T; q0 += L::TILE) {
    __syncthreads();   // the previous tile's qs, gs, pt, dt are read
    load_tile<DH, MODE != ODD>(qs, a.q, qb, q0, T, a.lq, col0, dh, qbf);
    load_tile<DH, MODE != ODD>(gs, g, gb, q0, T, a.lo, col0, dh, obf);
    cp_commit();
    if (threadIdx.x < L::TILE) {
      const int row = q0 + threadIdx.x;
      const bool ok = row < T;
      rm[threadIdx.x] = ok ? st_m[row] : 0.f;
      rl[threadIdx.x] = ok ? 1.f / st_l[row] : 1.f;
      rd[threadIdx.x] = ok ? dd[row] : 0.f;
    }
    cp_wait<0>();
    __syncthreads();
    const int nq = min(L::TILE, T - q0);
    with_extent<L::G>(groups(nq), [&](auto I) {
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
                         rl[qi], rd[qi], inv_keep, inv_sqrt, sqrt_bf);
          pt[kj * L::LDP + qi] = gr.attn;
          dt[kj * L::LDP + qi] = gr.ds;
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
    store_row<DH, MODE != ODD>(dk, ((size_t)b * S + key) * a.lk + col0,
                               adk[j], tx, dh, kvbf, rnd);
    store_row<DH, MODE != ODD>(dv, ((size_t)b * S + key) * a.lv + col0,
                               adv[j], tx, dh, kvbf, rnd);
  }
}

// backward: a block per (b, h, TILE keys) walks the query tiles in order,
// owns its keys' dk and dv, and writes its columns of ds / sqrt(dh) to
// ds_out [B, H, T, lds] (lds = S rounded up to 4; zero past S). A last
// tile of at most 16 keys runs as a 16-key block.
template <int DH, int MODE>
__global__ void __launch_bounds__(NT, Lay<DH>::MIN_BLOCKS)
    mha_bwd_dkdv_kernel(const __grid_constant__ Attn a,
                        const void* __restrict__ g,
                        const float* __restrict__ stats,
                        const float* __restrict__ dsum,
                        void* __restrict__ dk, void* __restrict__ dv,
                        float* __restrict__ ds_out, float inv_sqrt) {
  extern __shared__ __align__(16) float smem[];
  const int k0 = blockIdx.x * Lay<DH>::TILE;
  if (a.S - k0 <= 16)
    dkdv_block<DH, 1, MODE>(a, g, stats, dsum, dk, dv, ds_out, inv_sqrt,
                            smem, k0);
  else
    dkdv_block<DH, Lay<DH>::G, MODE>(a, g, stats, dsum, dk, dv, ds_out,
                                     inv_sqrt, smem, k0);
}

// One block of the dq kernel over query rows [q0, q0 + 16 QG): it walks the
// key tiles in order and owns its rows' dq = sum over keys of ds k, from
// the ds tiles the dk / dv kernel wrote (ds [B, H, T, lds]),
// double-buffered with K. CHUNK (a head wider than 256): the block's dq
// columns are the chunk of width `chunk_w` at column chunk_off of the head.
template <int DH, int QG, int MODE, bool CHUNK = false>
__device__ __forceinline__ void dq_block(const Attn& a,
                                         const float* __restrict__ ds,
                                         void* __restrict__ dq, float* smem,
                                         int q0, int chunk_off = 0,
                                         int chunk_w = 0) {
  using L = Lay<DH>;
  constexpr int CPT = L::CPT;
  constexpr int TILE = L::TILE, LDP = L::LDP;
  constexpr int STAGE = TILE * LDP + L::TILE_F;   // ds tile, then K tile
  const int T = a.T, S = a.S, lds = (S + 3) & ~3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q_end = min(T, q0 + 16 * QG);
  const float* dsb = ds + ((size_t)b * a.H + h) * T * lds;
  const size_t kb = (size_t)b * S * a.lk;
  const bool kvbf = a.fl & ATT_KV_BF;
  const int n_kt = (S + TILE - 1) / TILE;
  const int dh = CHUNK ? chunk_w : MODE == FULL ? DH : a.dh;
  const int col0 = CHUNK ? h * a.dh + chunk_off : h * dh;

  auto load = [&](int stage, int k0) {
    float* d_s = smem + stage * STAGE;
    for (int e = threadIdx.x; e < 16 * QG * (TILE / 4); e += NT) {
      const int r = e / (TILE / 4), c = (e % (TILE / 4)) * 4;
      const int row = q0 + r, col = k0 + c;
      const bool ok = row < q_end && col < lds;
      cp16(d_s + r * LDP + c, ok ? dsb + (size_t)row * lds + col : dsb, ok);
    }
    load_tile<DH, MODE != ODD>(d_s + TILE * LDP, a.k, kb, k0, S, a.lk, col0,
                               dh, kvbf);
    cp_commit();
  };

  float adq[4][CPT];
#pragma unroll
  for (int i = 0; i < QG; ++i)
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
    store_row<DH, MODE != ODD>(dq, ((size_t)b * T + row) * a.lq + col0,
                               adq[i], tx, dh, a.fl & ATT_Q_BF,
                               a.fl & ATT_RND);
  }
}

// A block per (b, h, tile_rows queries), run as 16, 32 or 64 rows (as the
// forward's).
template <int DH, int MODE>
__global__ void __launch_bounds__(NT)
    mha_bwd_dq_kernel(const __grid_constant__ Attn a,
                      const float* __restrict__ ds, void* __restrict__ dq,
                      int tile_rows) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * tile_rows, rows = min(tile_rows, a.T - q0);
  if (rows <= 16)
    dq_block<DH, 1, MODE>(a, ds, dq, smem, q0);
  else if (Lay<DH>::G == 2 || rows <= 32)
    dq_block<DH, 2, MODE>(a, ds, dq, smem, q0);
  else if constexpr (Lay<DH>::G == 4)
    dq_block<DH, 4, MODE>(a, ds, dq, smem, q0);
}

// Heads wider than 256 run in bucket 256 over column chunks of WIDE: q.k
// and g.v are summed over the chunks (each chunk's tiles loaded in turn,
// the sums in chunk order), and a block writes one chunk of its output
// columns, so every output chunk recomputes the scores: simple, not fast.
// The grid's x holds (tile, output chunk) pairs; the row statistics and ds
// are written by the chunk-0 blocks. A block per 32 queries or keys, as in
// bucket 256.
template <bool V4>
__global__ void __launch_bounds__(NT)
    mha_fwd_wide_kernel(const __grid_constant__ Attn a,
                        void* __restrict__ out, float* __restrict__ stats,
                        float inv_sqrt) {
  using L = Lay<WIDE>;
  constexpr int CPT = L::CPT, QG = L::G;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [TILE][LD] each
  float* ks = qs + L::TILE_F;
  float* vs = ks + L::TILE_F;
  float* ps = vs + L::TILE_F;          // [TILE][LDP] probabilities
  const int T = a.T, S = a.S, dh = a.dh, nc = (dh + WIDE - 1) / WIDE;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (blockIdx.x / nc) * L::TILE, oc = blockIdx.x % nc;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qb = (size_t)b * T * a.lq, kb = (size_t)b * S * a.lk;
  const size_t vb = (size_t)b * S * a.lv;
  const bool qbf = a.fl & ATT_Q_BF, kvbf = a.fl & ATT_KV_BF;
  const bool rnd = a.fl & ATT_RND;
  const float sqrt_bf = sqrt_bf_of(dh);
  const int col0 = h * dh, ow = min(WIDE, dh - oc * WIDE);
  const int q_end = min(T, q0 + L::TILE);
  const uint32_t base = a.dropout ? hash_base(*a.seed, b * a.pid_b + h) : 0u;
  const float* mrow[QG];
#pragma unroll
  for (int i = 0; i < QG; ++i) mrow[i] = mask_row(a, b, q0 + ty + 16 * i);
  float o[4][CPT], m[4], l[4];
#pragma unroll
  for (int i = 0; i < QG; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += L::TILE) {
    float s[4][4];
    for (int c = 0; c < nc; ++c) {
      const int cw = min(WIDE, dh - c * WIDE);
      load_tile<WIDE, V4>(qs, a.q, qb, q0, q_end, a.lq, col0 + c * WIDE, cw,
                          qbf);
      load_tile<WIDE, V4>(ks, a.k, kb, k0, S, a.lk, col0 + c * WIDE, cw,
                          kvbf);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      if (c == 0)
        dot_tile<WIDE, QG, QG, true>(qs, ks, s, ty, tx);
      else
        dot_tile<WIDE, QG, QG, false>(qs, ks, s, ty, tx);
      __syncthreads();
    }
    load_tile<WIDE, V4>(vs, a.v, vb, k0, S, a.lv, col0 + oc * WIDE, ow,
                        kvbf);
    cp_commit();
    const int nk = min(L::TILE, S - k0);
    float mk[QG];
#pragma unroll
    for (int i = 0; i < QG; ++i) {
      const int row = q0 + ty + 16 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < QG; ++j) {
        const int key = k0 + tx + 16 * j;
        float v = -INFINITY;
        if (key < S) {
          if (i == 0 || a.mask_rows != 1) mk[j] = mrow[i][key];
          v = mk[j] < 0.f ? NEG : scaled(s[i][j], inv_sqrt, sqrt_bf, rnd);
        }
        s[i][j] = v;
        tmax = fmaxf(tmax, v);
      }
      const float mn = fmaxf(m[i], group_max(tmax));
      const float alpha = __expf(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < QG; ++j) {
        const int key = k0 + tx + 16 * j;
        const float e = __expf(s[i][j] - mn);
        l[i] += e;
        float p = rnd_if(e, rnd);
        if (a.dropout && key < S &&
            keep_hash(base, (uint32_t)row * (uint32_t)S + key) < a.thresh)
          p = 0.f;
        ps[(ty + 16 * i) * L::LDP + tx + 16 * j] = p;
      }
    }
    cp_wait<0>();
    __syncthreads();
    acc_rows<WIDE, QG>(ps, vs, (nk + 3) & ~3, o, ty, tx);
    __syncthreads();
  }
  const size_t bh = (size_t)b * a.H + h;
  float* st_m = stats + bh * T;
  float* st_l = stats + (size_t)a.B * a.H * T + bh * T;
#pragma unroll
  for (int i = 0; i < QG; ++i) {
    const float lt = group_sum(l[i]);
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
    const float inv = a.dropout ? 1.f / (lt * a.keep_div) : 1.f / lt;
    float vals[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) vals[c] = o[i][c] * inv;
    store_row<WIDE, V4>(out, ((size_t)b * T + row) * a.lo + col0 + oc * WIDE,
                        vals, tx, ow, a.fl & ATT_O_BF, rnd);
    if (tx == 0 && oc == 0) {
      st_m[row] = m[i];
      st_l[row] = lt;
    }
  }
}

template <bool V4>
__global__ void __launch_bounds__(NT)
    mha_bwd_dkdv_wide_kernel(const __grid_constant__ Attn a,
                             const void* __restrict__ g,
                             const float* __restrict__ stats,
                             const float* __restrict__ dsum,
                             void* __restrict__ dk, void* __restrict__ dv,
                             float* __restrict__ ds_out, float inv_sqrt) {
  using L = Lay<WIDE>;
  constexpr int CPT = L::CPT, G = L::G;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [TILE][LD] each
  float* vs = ks + L::TILE_F;
  float* qs = vs + L::TILE_F;
  float* gs = qs + L::TILE_F;
  float* pt = gs + L::TILE_F;          // [key][query] attn, [TILE][LDP]
  float* dt = pt + L::TILE * L::LDP;   // [key][query] ds
  __shared__ float rm[L::TILE], rl[L::TILE], rd[L::TILE];
  const int T = a.T, S = a.S, dh = a.dh, nc = (dh + WIDE - 1) / WIDE;
  const int b = blockIdx.z, h = blockIdx.y;
  const int k0 = (blockIdx.x / nc) * L::TILE, oc = blockIdx.x % nc;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qb = (size_t)b * T * a.lq, gb = (size_t)b * T * a.lo;
  const size_t kb = (size_t)b * S * a.lk, vb = (size_t)b * S * a.lv;
  const bool qbf = a.fl & ATT_Q_BF, kvbf = a.fl & ATT_KV_BF;
  const bool obf = a.fl & ATT_O_BF, rnd = a.fl & ATT_RND;
  const float sqrt_bf = sqrt_bf_of(dh);
  const size_t bh = (size_t)b * a.H + h;
  const float* st_m = stats + bh * T;
  const float* st_l = stats + (size_t)a.B * a.H * T + bh * T;
  const float* dd = dsum + bh * T;
  const int lds = (S + 3) & ~3;
  float* dsg = ds_out + bh * T * lds;
  const uint32_t base = a.dropout ? hash_base(*a.seed, b * a.pid_b + h) : 0u;
  const float inv_keep = 1.f / a.keep_div;
  const int col0 = h * dh, ocol = col0 + oc * WIDE;
  const int ow = min(WIDE, dh - oc * WIDE);
  float adk[4][CPT], adv[4][CPT];   // keys ty + 16j, the thread's columns
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int c = 0; c < CPT; ++c) adk[j][c] = adv[j][c] = 0.f;

  for (int q0 = 0; q0 < T; q0 += L::TILE) {
    float s[4][4], dp[4][4];
    for (int c = 0; c < nc; ++c) {
      const int cw = min(WIDE, dh - c * WIDE), cc = col0 + c * WIDE;
      __syncthreads();   // the tiles and rm / rl / rd are free
      load_tile<WIDE, V4>(qs, a.q, qb, q0, T, a.lq, cc, cw, qbf);
      load_tile<WIDE, V4>(gs, g, gb, q0, T, a.lo, cc, cw, obf);
      load_tile<WIDE, V4>(ks, a.k, kb, k0, S, a.lk, cc, cw, kvbf);
      load_tile<WIDE, V4>(vs, a.v, vb, k0, S, a.lv, cc, cw, kvbf);
      cp_commit();
      if (c == 0 && threadIdx.x < L::TILE) {
        const int row = q0 + threadIdx.x;
        const bool ok = row < T;
        rm[threadIdx.x] = ok ? st_m[row] : 0.f;
        rl[threadIdx.x] = ok ? 1.f / st_l[row] : 1.f;
        rd[threadIdx.x] = ok ? dd[row] : 0.f;
      }
      cp_wait<0>();
      __syncthreads();
      if (c == 0) {
        dot_tile<WIDE, G, G, true>(qs, ks, s, ty, tx);
        dot_tile<WIDE, G, G, true>(gs, vs, dp, ty, tx);
      } else {
        dot_tile<WIDE, G, G, false>(qs, ks, s, ty, tx);
        dot_tile<WIDE, G, G, false>(gs, vs, dp, ty, tx);
      }
    }
    __syncthreads();   // the last chunk's tiles are read
    load_tile<WIDE, V4>(qs, a.q, qb, q0, T, a.lq, ocol, ow, qbf);
    load_tile<WIDE, V4>(gs, g, gb, q0, T, a.lo, ocol, ow, obf);
    cp_commit();
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int qi = ty + 16 * i, row = q0 + qi;
      const float* mrow = mask_row(a, b, row);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int kj = tx + 16 * j, key = k0 + kj;
        Grad gr{0.f, 0.f};
        if (row < T && key < S)
          gr = grad_at(a, base, mrow, row, key, s[i][j], dp[i][j], rm[qi],
                       rl[qi], rd[qi], inv_keep, inv_sqrt, sqrt_bf);
        pt[kj * L::LDP + qi] = gr.attn;
        dt[kj * L::LDP + qi] = gr.ds;
        if (oc == 0 && row < T && key < lds)
          dsg[(size_t)row * lds + key] = gr.ds;
      }
    }
    cp_wait<0>();
    __syncthreads();
    const int kn = (min(L::TILE, T - q0) + 3) & ~3;
    acc_rows<WIDE, G>(pt, gs, kn, adv, ty, tx);
    acc_rows<WIDE, G>(dt, qs, kn, adk, ty, tx);
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int key = k0 + ty + 16 * j;
    if (key >= S) continue;
    store_row<WIDE, V4>(dk, ((size_t)b * S + key) * a.lk + ocol, adk[j], tx,
                        ow, kvbf, rnd);
    store_row<WIDE, V4>(dv, ((size_t)b * S + key) * a.lv + ocol, adv[j], tx,
                        ow, kvbf, rnd);
  }
}

template <bool V4>
__global__ void __launch_bounds__(NT)
    mha_bwd_dq_wide_kernel(const __grid_constant__ Attn a,
                           const float* __restrict__ ds,
                           void* __restrict__ dq) {
  extern __shared__ __align__(16) float smem[];
  const int nc = (a.dh + WIDE - 1) / WIDE, oc = blockIdx.x % nc;
  dq_block<WIDE, Lay<WIDE>::G, V4 ? PADDED : ODD, true>(
      a, ds, dq, smem, (blockIdx.x / nc) * Lay<WIDE>::TILE, oc * WIDE,
      min(WIDE, a.dh - oc * WIDE));
}

template <int DH>
size_t fwd_smem() {
  using L = Lay<DH>;
  return sizeof(float) * (5 * L::TILE_F + L::TILE * L::LDP);
}
template <int DH>
size_t dkdv_smem() {
  using L = Lay<DH>;
  return sizeof(float) * (4 * L::TILE_F + 2 * L::TILE * L::LDP);
}
template <int DH>
size_t dq_smem() {
  using L = Lay<DH>;
  return sizeof(float) * 2 * (L::TILE * L::LDP + L::TILE_F);
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
inline float inv_sqrt(int dh) { return 1.0f / sqrtf((float)dh); }

// the query rows of a block's tile: 32 for short sequences (the decoder's
// 17 tokens) and for 32-row tiles, else 64
template <int DH>
int tile_rows(int T) {
  return T <= 32 ? 32 : Lay<DH>::TILE;
}

template <int DH, int MODE>
int fwd_as(const Attn& a, void* out, float* stats, cudaStream_t stream) {
  const size_t smem = fwd_smem<DH>();
  const cudaError_t err = allow_smem(mha_fwd_kernel<DH, MODE>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = tile_rows<DH>(a.T);
  mha_fwd_kernel<DH, MODE>
      <<<dim3(cdiv(a.T, rows), a.H, a.B), NT, smem, stream>>>(
          a, out, stats, inv_sqrt(a.dh), rows);
  return (int)cudaGetLastError();
}

template <int DH, int MODE>
int bwd_as(const Attn& a, const void* g, const void* o, const float* stats,
           void* dq, void* dk, void* dv, float* scratch,
           cudaStream_t stream) {
  float* dsum = scratch;
  float* ds = scratch + attn_dsum_floats(a.B, a.H, a.T);
  const float is = inv_sqrt(a.dh);
  const size_t s1 = dkdv_smem<DH>(), s2 = dq_smem<DH>();
  cudaError_t err;
  if ((err = allow_smem(mha_bwd_dkdv_kernel<DH, MODE>, s1)) != cudaSuccess)
    return (int)err;
  if ((err = allow_smem(mha_bwd_dq_kernel<DH, MODE>, s2)) != cudaSuccess)
    return (int)err;
  const long long n_rows = (long long)a.B * a.T * a.H;
  mha_dsum_kernel<<<(unsigned)((n_rows * 32 + 255) / 256), 256, 0, stream>>>(
      a, g, o, dsum);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mha_bwd_dkdv_kernel<DH, MODE>
      <<<dim3(cdiv(a.S, Lay<DH>::TILE), a.H, a.B), NT, s1, stream>>>(
          a, g, stats, dsum, dk, dv, ds, is);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int rows = tile_rows<DH>(a.T);
  mha_bwd_dq_kernel<DH, MODE>
      <<<dim3(cdiv(a.T, rows), a.H, a.B), NT, s2, stream>>>(a, ds, dq, rows);
  return (int)cudaGetLastError();
}

template <bool V4>
int fwd_wide(const Attn& a, void* out, float* stats, cudaStream_t stream) {
  using L = Lay<WIDE>;
  const size_t smem = sizeof(float) * (3 * L::TILE_F + L::TILE * L::LDP);
  const cudaError_t err = allow_smem(mha_fwd_wide_kernel<V4>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = cdiv(a.dh, WIDE);
  mha_fwd_wide_kernel<V4>
      <<<dim3(cdiv(a.T, L::TILE) * nc, a.H, a.B), NT, smem, stream>>>(
          a, out, stats, inv_sqrt(a.dh));
  return (int)cudaGetLastError();
}

template <bool V4>
int bwd_wide(const Attn& a, const void* g, const void* o,
             const float* stats, void* dq, void* dk, void* dv,
             float* scratch, cudaStream_t stream) {
  using L = Lay<WIDE>;
  float* dsum = scratch;
  float* ds = scratch + attn_dsum_floats(a.B, a.H, a.T);
  const size_t s1 = sizeof(float) * (4 * L::TILE_F + 2 * L::TILE * L::LDP);
  const size_t s2 = dq_smem<WIDE>();
  const int nc = cdiv(a.dh, WIDE);
  cudaError_t err;
  if ((err = allow_smem(mha_bwd_dkdv_wide_kernel<V4>, s1)) != cudaSuccess)
    return (int)err;
  if ((err = allow_smem(mha_bwd_dq_wide_kernel<V4>, s2)) != cudaSuccess)
    return (int)err;
  const long long n_rows = (long long)a.B * a.T * a.H;
  mha_dsum_kernel<<<(unsigned)((n_rows * 32 + 255) / 256), 256, 0, stream>>>(
      a, g, o, dsum);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mha_bwd_dkdv_wide_kernel<V4>
      <<<dim3(cdiv(a.S, L::TILE) * nc, a.H, a.B), NT, s1, stream>>>(
          a, g, stats, dsum, dk, dv, ds, inv_sqrt(a.dh));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mha_bwd_dq_wide_kernel<V4>
      <<<dim3(cdiv(a.T, L::TILE) * nc, a.H, a.B), NT, s2, stream>>>(a, ds, dq);
  return (int)cudaGetLastError();
}

// Whether every row a call reads or writes starts on 16 bytes (the head
// width, the row strides and the pointers), so that its tiles move by
// 16-byte copies.
inline bool rows16(const Attn& a, const void* const* ptrs, int n) {
  size_t bits = (size_t)a.q | (size_t)a.k | (size_t)a.v;
  for (int i = 0; i < n; ++i) bits |= (size_t)ptrs[i];
  return a.dh % 4 == 0 && a.lq % 4 == 0 && a.lk % 4 == 0 && a.lv % 4 == 0 &&
         a.lo % 4 == 0 && bits % 16 == 0;
}

// A head width of the bucket's own runs the instance with nothing padded
// (the columns' bounds compiled out), a narrower one the padded instance,
// rows not on 16 bytes the ODD instance, and (bucket 256) a head wider than
// 256 the column-chunked kernels.
template <int DH>
int fwd(const Attn& a, void* out, float* stats, cudaStream_t stream) {
  const void* ptrs[] = {out};
  const bool v4 = rows16(a, ptrs, 1);
  if constexpr (DH == WIDE) {
    if (a.dh > WIDE)
      return v4 ? fwd_wide<true>(a, out, stats, stream)
                : fwd_wide<false>(a, out, stats, stream);
  }
  if (!v4) return fwd_as<DH, ODD>(a, out, stats, stream);
  return a.dh == DH ? fwd_as<DH, FULL>(a, out, stats, stream)
                    : fwd_as<DH, PADDED>(a, out, stats, stream);
}

template <int DH>
int bwd(const Attn& a, const void* g, const void* o, const float* stats,
        void* dq, void* dk, void* dv, float* scratch, cudaStream_t stream) {
  const void* ptrs[] = {g, o, dq, dk, dv};
  const bool v4 = rows16(a, ptrs, 5);
  if constexpr (DH == WIDE) {
    if (a.dh > WIDE)
      return v4 ? bwd_wide<true>(a, g, o, stats, dq, dk, dv, scratch, stream)
                : bwd_wide<false>(a, g, o, stats, dq, dk, dv, scratch,
                                  stream);
  }
  if (!v4)
    return bwd_as<DH, ODD>(a, g, o, stats, dq, dk, dv, scratch, stream);
  return a.dh == DH
             ? bwd_as<DH, FULL>(a, g, o, stats, dq, dk, dv, scratch, stream)
             : bwd_as<DH, PADDED>(a, g, o, stats, dq, dk, dv, scratch,
                                  stream);
}

}  // namespace mha
}  // namespace uic
