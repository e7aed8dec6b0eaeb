// The tensor-core instance of the training attention (the design note is at
// the head of mha_train.cu): the all-bf16 calls on the bf16 cast points
// whose head width dh <= 256 is a multiple of 8 and whose rows start on 16
// bytes. Every product is `mma.sync.m16n8k16` bf16 with f32 sums
// (mma_bf16.cuh); q, k, v and g stay bf16 in shared memory, copied in by
// 16-byte cp.async with no staging; operands load through ldmatrix.
// Included by mha_train_impl.cuh, which instantiates it in each head-width
// bucket DH (32, 64, 128, 256; narrower heads padded with zero columns,
// FULL compiling the column bounds out at dh = DH).
//
// The work between the products (per score: two bf16 roundings, the mask,
// an exp, the dropout hash) is written without branches, so the compiler
// can interleave the scores of a tile: each key tile's mask entries come
// into shared memory by cp.async with its K / V rows (stage_mask), rows
// past T and keys past S are computed and selected away, and the dk / dv
// kernel's [B, T, S] mask entries load predicated (ld_if).
#pragma once

#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace uic {
namespace mha {
namespace tc {

using bf = __nv_bfloat16;
using uic_mma::frag_col;
using uic_mma::frag_row;
using uic_mma::kmaj_col;
using uic_mma::kmaj_row;
using uic_mma::ldsm_x4;
using uic_mma::ldsm_x4_t;

constexpr int NW = 4;          // warps a block, 16 rows each
constexpr int NTC = 32 * NW;   // threads a block
constexpr int BM = 16 * NW;    // a block's queries (forward, dq) or keys (dk / dv)
constexpr int BK = 64;         // keys (forward, dq) or queries (dk / dv) a tile
constexpr int SP = 8;          // bf16 after each shared row: 16 bytes, so the
                               // 8 rows of an ldmatrix hit distinct banks

template <int DH>
struct TL {
  static constexpr int LD = DH + SP;            // a [rows][DH] tile's row
  // output columns of a forward or dq block (the grid holds DH / OW
  // chunks), and of a dk / dv block (DH / CW chunks): they bound the f32
  // sums a thread holds, 16 x OW / 32 and 2 x 16 x CW / 32
  static constexpr int OW = DH < 128 ? DH : 128;
  static constexpr int LDO = OW + SP;
  static constexpr int CW = DH < 64 ? DH : 64;
  static constexpr int KS = DH / 16;            // k16 steps over a head
  // blocks an SM holds at least: the forward, row pass and dq kernels at
  // 128 registers a thread up to DH 64; dk / dv, with two [16][CW] sums a
  // thread besides its score tiles, at 168
  static constexpr int MINB = DH <= 64 ? 4 : 2;
  static constexpr int MINB_DKDV = DH <= 64 ? 3 : 2;
  // the row pass's K / V stages: one at DH 256, whose two would leave no
  // room for a [B, T, S] mask's rows in 227 KB
  static constexpr int RSTAGES = DH < 256 ? 2 : 1;
};

// Short rows split the keys too: the forward's and the row pass's 4 warps
// are 4 / kw row groups of 16 rows times kw key slices (kw 1 where T > 32,
// 2 where T > 16, else 4), each warp taking BK / kw keys of every key
// tile, so that a decoder's 17 rows over 196 keys keep 4 warps busy; the
// slices' row terms and partial sums combine through shared memory in
// slice order (the same bits on every run).
__host__ __device__ __forceinline__ int key_slices(int T) {
  return T <= 16 ? 4 : T <= 32 ? 2 : 1;
}

// two f32 values as one register of bf16 fragment pairs (nearest even;
// `lo`, the lower column, in the low half)
__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// x and y rounded to bf16 (nearest even) and back, in one conversion
__device__ __forceinline__ void round2(float& x, float& y) {
  const unsigned u = pack(x, y);
  x = __uint_as_float(u << 16);
  y = __uint_as_float(u & 0xffff0000u);
}

// a bf16 route's scores: q.k rounded to bf16, divided in bf16 by sqrt(dh)
// in bf16 (mha_train_impl.cuh: scaled), here as a product with `inv` =
// 1 / sqrt(dh)'s bf16, rounded to f32. It rounds to the same bf16: x / y
// of two bf16 values x, y (8-bit significands) lies at least 2^-17 (in
// relative terms) from any bf16 rounding midpoint (a midpoint m = x / y
// would make x = m y a product of a 9-bit odd significand by y's, which
// no 8-bit x is), while x * inv is within 2^-23 of x / y.
// P2: sqrt(dh) is a power of two (dh 64 and 256 at FULL), so the product
// of a bf16 by `inv` is itself a bf16 and the second rounding is void.
template <bool P2>
__device__ __forceinline__ void scaled2(float& x, float& y, float inv) {
  round2(x, y);
  x *= inv;
  y *= inv;
  if constexpr (!P2) round2(x, y);
}

// whether sqrt(dh) is a power of two in an instance (FULL at DH 64, 256)
template <int DH, int MODE>
constexpr bool kPow2Root = MODE == FULL && (DH == 64 || DH == 256);

// *p where ok, else dflt: a predicated read-only load, with no branch (p
// need not be a valid address where !ok)
__device__ __forceinline__ float ld_if(const float* p, bool ok, float dflt) {
  float v;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\tmov.f32 %0, %3;\n\t"
      "@q ld.global.nc.f32 %0, [%1];\n\t}"
      : "=&f"(v)
      : "l"(p), "r"((int)ok), "f"(dflt));
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows [r0, r0 + R) of the W columns from c0 of a head (its dh columns
// start `base` elements into src, rows `ld` apart) into dst [R][LDS]; rows
// at or past L and columns at or past dh are zero (FULL: every column is
// in)
template <int W, int LDS, int MODE>
__device__ __forceinline__ void cp_tile(bf* dst, const bf* src, size_t base,
                                        int R, int r0, int L, int ld, int c0,
                                        int dh) {
  constexpr int CH = W / 8;
  for (int e = threadIdx.x; e < R * CH; e += NTC) {
    const int r = e / CH, c = (e % CH) * 8, row = r0 + r;
    const bool ok = row < L && (MODE == FULL || c0 + c < dh);
    uic_mma::cp16(dst + r * LDS + c,
                  ok ? src + base + (size_t)row * ld + c0 + c : src, ok);
  }
}

// acc[j] (j < 2 JN, 8 columns each) = A . B^T over the head's DH columns:
// A the warp's 16 rows at `a`, B 16 JN rows at `b`, both row-major [rows]
// [LD] (S = Q K^T; K Q^T and V G^T in the backward)
template <int DH, int JN>
__device__ __forceinline__ void nt_product(const bf* a, const bf* b,
                                           float (&acc)[8][4], int lane) {
  constexpr int LD = TL<DH>::LD;
#pragma unroll
  for (int j = 0; j < 2 * JN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const bf* ap = a + frag_row(lane) * LD + frag_col(lane);
  const bf* bp = b + kmaj_row(lane) * LD + kmaj_col(lane);
#pragma unroll
  for (int kk = 0; kk < TL<DH>::KS; ++kk) {
    unsigned af[4];
    ldsm_x4(af, ap + kk * 16);
#pragma unroll
    for (int jj = 0; jj < JN; ++jj) {
      unsigned bq[4];
      ldsm_x4(bq, bp + jj * 16 * LD + kk * 16);
      uic_mma::mma(acc[2 * jj], af, bq[0], bq[1]);
      uic_mma::mma(acc[2 * jj + 1], af, bq[2], bq[3]);
    }
  }
}

// acc[n] (n < W / 8) += P . M: P the warp's 16 x 16 JN operand held in
// registers as the C fragments of 2 JN 8-column tiles packed to bf16 pairs
// (pk[j][r] = pack(c[2r], c[2r + 1]) of tile j: an m16n8 tile's
// accumulator is the A fragment of the next k16 product, two bf16 a
// register), M row-major [16 JN][LDM] from its first column at `m` (V in
// the forward; G and Q in the backward)
template <int W, int LDM, int JN>
__device__ __forceinline__ void rn_product(const unsigned (&pk)[8][2],
                                           const bf* m, float (&acc)[W / 8][4],
                                           int lane) {
  const bf* mp = m + frag_row(lane) * LDM + frag_col(lane);
#pragma unroll
  for (int kk = 0; kk < JN; ++kk) {
    const unsigned a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0],
                           pk[2 * kk + 1][1]};
#pragma unroll
    for (int nn = 0; nn < W / 16; ++nn) {
      unsigned bm[4];
      ldsm_x4_t(bm, mp + kk * 16 * LDM + nn * 16);
      uic_mma::mma(acc[2 * nn], a, bm[0], bm[1]);
      uic_mma::mma(acc[2 * nn + 1], a, bm[2], bm[3]);
    }
  }
}

// rows `row` (< L) of a [*, ld] bf16 array from column col0 of a head:
// the 16-row warp tile's C fragments acc[n] (columns c0 + 8n + 2q, +1),
// rounded to bf16, half r (0: fragment row g, 1: g + 8)
template <int W, int MODE>
__device__ __forceinline__ void store_rows(bf* dst, const float (&acc)[W / 8][4],
                                           int r, int c0, int dh, int lane) {
  const int qd = lane & 3;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    const int col = c0 + 8 * n + 2 * qd;
    if (MODE == FULL || col < dh)
      *reinterpret_cast<unsigned*>(dst + col) =
          pack(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// A key tile's mask entries, copied into shared memory by cp.async with
// the tile's K / V rows: bs [mr][BK] (mr rows: 1 where the mask is
// [B, 1, S], else the block's rows from q0). Only the 16-key groups that
// hold keys of the tile, and only rows before T, are copied (zeros past
// S); no other entry is read for a row whose scores are kept.
__device__ __forceinline__ void stage_mask(float* bs, const Attn& a, int b,
                                           int q0, int mr, int k0) {
  const int nc = min(BK, (a.S - k0 + 15) & ~15);
  const int nr = min(mr, a.T - q0);
  for (int e = threadIdx.x; e < nr * BK; e += NTC) {
    const int r = e / BK, i = e % BK, key = k0 + i;
    if (i < nc) {
      const bool ok = key < a.S;
      cp4(bs + e, ok ? mask_row(a, b, q0 + r) + key : a.mask, ok);
    }
  }
}

// The masked, scaled scores of the thread's elements of one 8-column tile
// of S (keys kc and kc + 1 of its two rows: c[0], c[1] and c[2], c[3]), in
// place: -inf past S (no key of the row), NEG where the mask is < 0; bp[r]:
// row r's stage_mask entries at key kc.
template <bool P2>
__device__ __forceinline__ void mask_scale(float (&c)[4],
                                           const float* const (&bp)[2],
                                           int kc, int S, float inv) {
  scaled2<P2>(c[0], c[1], inv);
  scaled2<P2>(c[2], c[3], inv);
  const bool ok[2] = {kc < S, kc + 1 < S};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float2 m = *reinterpret_cast<const float2*>(bp[r]);
    const float s0 = m.x < 0.f ? NEG : c[2 * r];
    const float s1 = m.y < 0.f ? NEG : c[2 * r + 1];
    c[2 * r] = ok[0] ? s0 : -INFINITY;
    c[2 * r + 1] = ok[1] ? s1 : -INFINITY;
  }
}

// p with its dropout: kept (the hash of the row's `idx` past the
// threshold) p / (1 - rate), else 0
__device__ __forceinline__ float dropped(const Attn& a, float p,
                                         uint32_t base, uint32_t idx,
                                         float inv_keep) {
  if (!a.dropout) return p;
  return keep_hash(base, idx) >= a.thresh ? p * inv_keep : 0.f;
}

// the kw slices' (max, sum) pairs of each row group's rows, combined in
// slice order: red [NW][16][2] floats in shared memory
__device__ __forceinline__ void combine_stats(float* red, float (&m)[2],
                                              float (&l)[2], int kw,
                                              int warp, int lane) {
  const int g = lane >> 2, w0 = warp - warp % kw;
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      red[(warp * 16 + g + 8 * r) * 2] = m[r];
      red[(warp * 16 + g + 8 * r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = -INFINITY, lt = 0.f;
    for (int w = 0; w < kw; ++w)
      mt = fmaxf(mt, red[((w0 + w) * 16 + g + 8 * r) * 2]);
    for (int w = 0; w < kw; ++w) {
      const float* x = red + ((w0 + w) * 16 + g + 8 * r) * 2;
      lt += x[1] * __expf(x[0] - mt);   // 0 for a slice with no key
    }
    m[r] = mt;
    l[r] = lt;
  }
}

// The forward: a block per (b, h, 64 / kw queries, OW output columns),
// its warps in row groups and key slices (key_slices). Pass 1 streams the
// key tiles for S = Q K^T alone and keeps each row's max and sum in
// registers; pass 2 recomputes S, forms round_bf16(exp(s - m) / l) with
// its dropout and feeds it to P.V from registers. The two passes' key
// tiles (K, and V in pass 2) stream through one double-buffered pipeline,
// so pass 2's first tile loads while pass 1's last is computed.
template <int DH, int MODE>
__global__ void __launch_bounds__(NTC, TL<DH>::MINB)
    mha_fwd_tc_kernel(const __grid_constant__ Attn a, bf* __restrict__ out,
                      float* __restrict__ stats, int nchunks) {
  using L = TL<DH>;
  constexpr bool P2 = kPow2Root<DH, MODE>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf* qs = reinterpret_cast<bf*>(tc_smem);    // [BM][LD]
  bf* ks = qs + BM * L::LD;                    // 2 stages of [BK][LD]
  bf* vs = ks + 2 * BK * L::LD;                // 2 stages of [BK][LDO]
  float* red = reinterpret_cast<float*>(vs + 2 * BK * L::LDO);
  float* msk = red + NW * 16 * 2;   // 2 stages of mask entries [mr][BK]
  const int T = a.T, S = a.S;
  const int kw = key_slices(T), n_rows = BM / kw, n_keys = BK / kw;
  const int mr = a.mask_rows == 1 ? 1 : n_rows;
  const int oc = blockIdx.x % nchunks, q0 = blockIdx.x / nchunks * n_rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int rg = warp / kw, sl = warp % kw;
  const int dh = MODE == FULL ? DH : a.dh;
  const int col0 = h * dh, hc = oc * L::OW;
  const bf* k = static_cast<const bf*>(a.k);
  const bf* v = static_cast<const bf*>(a.v);
  const size_t kb = (size_t)b * S * a.lk + col0;
  const size_t vb = (size_t)b * S * a.lv + col0;
  const float inv = 1.f / sqrt_bf_of(a.dh);
  const uint32_t base = a.dropout ? hash_base(*a.seed, b * a.pid_b + h) : 0u;
  const float inv_keep = 1.f / a.keep_div;
  const int rows[2] = {q0 + rg * 16 + g, q0 + rg * 16 + g + 8};
  const uint32_t rs[2] = {(uint32_t)rows[0] * (uint32_t)S,
                          (uint32_t)rows[1] * (uint32_t)S};
  // the rows' entries of a stage's mask tile, from the warp's key slice
  const int boff[2] = {(mr == 1 ? 0 : rg * 16 + g) * BK + sl * n_keys + 2 * qd,
                       (mr == 1 ? 0 : rg * 16 + g + 8) * BK + sl * n_keys +
                           2 * qd};
  const bool active = q0 + rg * 16 < T;
  const int n_kt = (S + BK - 1) / BK;
  const bf* qw = qs + rg * 16 * L::LD;

  // tile t of the two passes' 2 n_kt into stage t % 2: its K (and in pass
  // 2 its V) tile and its mask entries
  auto load = [&](int t) {
    const int st = t & 1, k0 = (t < n_kt ? t : t - n_kt) * BK;
    cp_tile<DH, L::LD, MODE>(ks + st * BK * L::LD, k, kb, BK, k0, S, a.lk,
                             0, dh);
    if (t >= n_kt)
      cp_tile<L::OW, L::LDO, MODE>(vs + st * BK * L::LDO, v, vb, BK, k0, S,
                                   a.lv, hc, dh);
    stage_mask(msk + st * mr * BK, a, b, q0, mr, k0);
    uic_mma::commit();
  };

  cp_tile<DH, L::LD, MODE>(qs, static_cast<const bf*>(a.q),
                           (size_t)b * T * a.lq + col0, n_rows, q0, T, a.lq,
                           0, dh);
  load(0);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  float o[L::OW / 8][4];
#pragma unroll
  for (int n = 0; n < L::OW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int t = 0; t < 2 * n_kt; ++t) {
    if (t + 1 < 2 * n_kt) {
      load(t + 1);
      uic_mma::wait<1>();
    } else {
      uic_mma::wait<0>();
    }
    __syncthreads();
    if (t == n_kt) {
      // pass 1 is done: the rows' whole sums (every thread takes part)
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
      if (kw > 1) combine_stats(red, m, l, kw, warp, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / l[r];
    }
    const bool pass2 = t >= n_kt;
    const int k0 = (pass2 ? t - n_kt : t) * BK + sl * n_keys;   // the slice
    if (active && k0 < S) {
      const int st = t & 1;
      const bf* kst = ks + st * BK * L::LD + sl * n_keys * L::LD;
      const bf* vst = vs + st * BK * L::LDO + sl * n_keys * L::LDO;
      const float* bs = msk + st * mr * BK;
      with_extent<4>(groups(min(n_keys, S - k0)), [&](auto J) {
        constexpr int JN = decltype(J)::value;
        float s[8][4];
        nt_product<DH, JN>(qw, kst, s, lane);
#pragma unroll
        for (int j = 0; j < 2 * JN; ++j) {
          const float* const bp[2] = {bs + boff[0] + 8 * j,
                                      bs + boff[1] + 8 * j};
          mask_scale<P2>(s[j], bp, k0 + 8 * j + 2 * qd, S, inv);
        }
        if (!pass2) {
          // pass 1: each row's max m and sum l of exp(s - m), online
          float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < 2 * JN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float mn = fmaxf(m[r], quad_max(tmax[r]));
            l[r] *= __expf(m[r] - mn);   // 0 on the first tile
            m[r] = mn;
          }
#pragma unroll
          for (int j = 0; j < 2 * JN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              l[e >> 1] += __expf(s[j][e] - m[e >> 1]);
        } else {
          // pass 2: the exact probabilities, rounded, through P.V
          unsigned pk[8][2];
#pragma unroll
          for (int j = 0; j < 2 * JN; ++j) {
            const int kc = k0 + 8 * j + 2 * qd;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              // 0 past S: exp(-inf)
              s[j][e] = dropped(a, __expf(s[j][e] - m[r]) * inv_l[r], base,
                                rs[r] + kc + (e & 1), inv_keep);
            }
            pk[j][0] = pack(s[j][0], s[j][1]);
            pk[j][1] = pack(s[j][2], s[j][3]);
          }
          rn_product<L::OW, L::LDO, JN>(pk, vst, o, lane);
        }
      });
    }
    // every thread is done with this stage before the next prefetch
    __syncthreads();
  }
  if (kw > 1) {
    // the slices' partial sums, added to slice 0's in slice order (the
    // stages are free: the loop ended on a barrier)
    float* part = reinterpret_cast<float*>(ks);   // [NW][OW / 8][4][32]
    if (sl != 0) {
#pragma unroll
      for (int n = 0; n < L::OW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[((warp * (L::OW / 8) + n) * 4 + e) * 32 + lane] = o[n][e];
    }
    __syncthreads();
    if (sl != 0) return;
    for (int w = 1; w < kw; ++w)
#pragma unroll
      for (int n = 0; n < L::OW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n][e] += part[(((warp + w) * (L::OW / 8) + n) * 4 + e) * 32 + lane];
  }
  if (!active) return;
  const size_t bh = (size_t)b * a.H + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= T) continue;
    store_rows<L::OW, MODE>(out + ((size_t)b * T + row) * a.lo + col0, o, r,
                            hc, dh, lane);
    if (oc == 0 && qd == 0) {
      stats[bh * T + row] = m[r];
      stats[(size_t)a.B * a.H * T + bh * T + row] = l[r];
    }
  }
}

// The backward's row terms D_i = sum over keys of dattn p (dattn = keep ?
// dP / (1 - rate) : 0), as the plain backward and the TPU kernel take them
// (ops/mha_train.py:136-140 of the JAX package): a block per (b, h, 64 /
// kw queries), walking the key tiles (K and V double-buffered) for
// S = Q K^T and dP = G V^T, p from the forward's row statistics; short rows
// split the keys as the forward does. (g . o over the rounded output, the
// FMA core's D, differs from it by the output's and the probabilities'
// bf16 roundings: up to about 1% of dk's scale where a causal row holds
// one key.)
template <int DH, int MODE>
__global__ void __launch_bounds__(NTC, TL<DH>::MINB)
    mha_bwd_rows_tc_kernel(const __grid_constant__ Attn a,
                           const bf* __restrict__ g,
                           const float* __restrict__ stats,
                           float* __restrict__ dsum) {
  using L = TL<DH>;
  constexpr bool P2 = kPow2Root<DH, MODE>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf* qs = reinterpret_cast<bf*>(tc_smem);    // [BM][LD] each
  bf* gs = qs + BM * L::LD;
  bf* ks = gs + BM * L::LD;                    // stages of K, V [BK][LD]
  float* red = reinterpret_cast<float*>(ks + L::RSTAGES * 2 * BK * L::LD);
  float* msk = red + NW * 16;       // stages of mask entries [mr][BK]
  const int T = a.T, S = a.S;
  const int kw = key_slices(T), n_rows = BM / kw, n_keys = BK / kw;
  const int mr = a.mask_rows == 1 ? 1 : n_rows;
  const int q0 = blockIdx.x * n_rows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qd = lane & 3, rg = warp / kw, sl = warp % kw;
  const int dh = MODE == FULL ? DH : a.dh;
  const int col0 = h * dh;
  const bf* k = static_cast<const bf*>(a.k);
  const bf* v = static_cast<const bf*>(a.v);
  const size_t kb = (size_t)b * S * a.lk + col0;
  const size_t vb = (size_t)b * S * a.lv + col0;
  const float inv = 1.f / sqrt_bf_of(a.dh);
  const uint32_t base = a.dropout ? hash_base(*a.seed, b * a.pid_b + h) : 0u;
  const float inv_keep = 1.f / a.keep_div;
  const size_t bh = (size_t)b * a.H + h;
  const int rows[2] = {q0 + rg * 16 + (lane >> 2),
                       q0 + rg * 16 + (lane >> 2) + 8};
  const uint32_t rs[2] = {(uint32_t)rows[0] * (uint32_t)S,
                          (uint32_t)rows[1] * (uint32_t)S};
  const int boff[2] = {
      (mr == 1 ? 0 : rg * 16 + (lane >> 2)) * BK + sl * n_keys + 2 * qd,
      (mr == 1 ? 0 : rg * 16 + (lane >> 2) + 8) * BK + sl * n_keys + 2 * qd};
  const bool active = q0 + rg * 16 < T;
  const int n_kt = (S + BK - 1) / BK;
  float m[2], inv_l[2], dacc[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < T;
    m[r] = ok ? stats[bh * T + rows[r]] : 0.f;
    inv_l[r] = ok ? 1.f / stats[(size_t)a.B * a.H * T + bh * T + rows[r]]
                  : 1.f;
  }
  auto load_kv = [&](int stage, int k0) {
    bf* st = ks + stage * 2 * BK * L::LD;
    cp_tile<DH, L::LD, MODE>(st, k, kb, BK, k0, S, a.lk, 0, dh);
    cp_tile<DH, L::LD, MODE>(st + BK * L::LD, v, vb, BK, k0, S, a.lv, 0, dh);
    stage_mask(msk + stage * mr * BK, a, b, q0, mr, k0);
    uic_mma::commit();
  };
  cp_tile<DH, L::LD, MODE>(qs, static_cast<const bf*>(a.q),
                           (size_t)b * T * a.lq + col0, n_rows, q0, T, a.lq,
                           0, dh);
  cp_tile<DH, L::LD, MODE>(gs, g, (size_t)b * T * a.lo + col0, n_rows, q0, T,
                           a.lo, 0, dh);
  load_kv(0, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK + sl * n_keys;   // the warp's slice
    const int st = L::RSTAGES == 2 ? kt & 1 : 0;
    if (L::RSTAGES == 2 && kt + 1 < n_kt) {
      load_kv((kt + 1) & 1, (kt + 1) * BK);
      uic_mma::wait<1>();
    } else {
      uic_mma::wait<0>();
    }
    __syncthreads();
    if (active && k0 < S) {
      const bf* kst = ks + st * 2 * BK * L::LD + sl * n_keys * L::LD;
      const float* bs = msk + st * mr * BK;
      with_extent<4>(groups(min(n_keys, S - k0)), [&](auto J) {
        constexpr int JN = decltype(J)::value;
        float s[8][4], dp[8][4];
        nt_product<DH, JN>(qs + rg * 16 * L::LD, kst, s, lane);
        nt_product<DH, JN>(gs + rg * 16 * L::LD, kst + BK * L::LD, dp,
                           lane);
#pragma unroll
        for (int j = 0; j < 2 * JN; ++j) {
          const int kc = k0 + 8 * j + 2 * qd;
          const float* const bp[2] = {bs + boff[0] + 8 * j,
                                      bs + boff[1] + 8 * j};
          mask_scale<P2>(s[j], bp, kc, S, inv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            // 0 past S: exp(-inf), against dP 0 (zero V rows)
            const float p = __expf(s[j][e] - m[r]) * inv_l[r];
            dacc[r] += dropped(a, dp[j][e], base, rs[r] + kc + (e & 1),
                               inv_keep) *
                       p;
          }
        }
      });
    }
    // every thread is done with this stage before the next prefetch
    __syncthreads();
    if (L::RSTAGES == 1 && kt + 1 < n_kt) load_kv(0, (kt + 1) * BK);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) dacc[r] = quad_sum(dacc[r]);
  if (kw > 1) {
    // the slices' sums, in slice order
    if (qd == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        red[warp * 16 + (lane >> 2) + 8 * r] = dacc[r];
    }
    __syncthreads();
    if (sl != 0) return;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      for (int w = 1; w < kw; ++w)
        dacc[r] += red[(warp + w) * 16 + (lane >> 2) + 8 * r];
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (qd == 0 && rows[r] < T) dsum[bh * T + rows[r]] = dacc[r];
}

// The backward's dk / dv: a block per (b, h, BM keys, CW columns of dk and
// dv), 4 warps of 16 keys, walking the query tiles in order. The key-major
// products S^T = K Q^T and dP^T = V G^T put the keys on the accumulators'
// rows, so attn^T and ds^T feed dV += attn^T G and dK += ds^T Q from
// registers; D is the row pass's (mha_bwd_rows_tc_kernel); the chunk-0
// blocks write ds^T (bf16, [B, H, S, T rounded up to 8]) for the dq
// kernel.
template <int DH, int MODE>
__global__ void __launch_bounds__(NTC, TL<DH>::MINB_DKDV)
    mha_bwd_dkdv_tc_kernel(const __grid_constant__ Attn a,
                           const bf* __restrict__ g,
                           const float* __restrict__ stats,
                           const float* __restrict__ dsum,
                           bf* __restrict__ dk, bf* __restrict__ dv,
                           bf* __restrict__ ds_t, int nchunks,
                           float inv_sqrt) {
  using L = TL<DH>;
  constexpr bool P2 = kPow2Root<DH, MODE>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf* ks = reinterpret_cast<bf*>(tc_smem);    // [BM][LD] each
  bf* vs = ks + BM * L::LD;
  bf* qs = vs + BM * L::LD;                    // [BK][LD] each
  bf* gs = qs + BK * L::LD;
  float* rm = reinterpret_cast<float*>(gs + BK * L::LD);   // [BK] each
  float* rl = rm + BK;
  float* rd = rl + BK;
  const int oc = blockIdx.x % nchunks, k0 = blockIdx.x / nchunks * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, qd = lane & 3;
  const int T = a.T, S = a.S, lds = (T + 7) & ~7;
  const int dh = MODE == FULL ? DH : a.dh;
  const int col0 = h * dh, hc = oc * L::CW;
  const bf* q = static_cast<const bf*>(a.q);
  const bf* k = static_cast<const bf*>(a.k);
  const bf* v = static_cast<const bf*>(a.v);
  const size_t qb = (size_t)b * T * a.lq + col0;
  const size_t gb = (size_t)b * T * a.lo + col0;
  const float inv = 1.f / sqrt_bf_of(a.dh);
  const uint32_t base = a.dropout ? hash_base(*a.seed, b * a.pid_b + h) : 0u;
  const float inv_keep = 1.f / a.keep_div;
  const size_t bh = (size_t)b * a.H + h;
  const float* st_m = stats + bh * T;
  const float* st_l = stats + (size_t)a.B * a.H * T + bh * T;
  const float* dd = dsum + bh * T;
  bf* dsw = ds_t + bh * S * lds;
  const int keys[2] = {k0 + warp * 16 + gq, k0 + warp * 16 + gq + 8};
  const int at[2] = {min(keys[0], S - 1), min(keys[1], S - 1)};
  const bool active = k0 + warp * 16 < S;
  const bool mrow1 = a.mask_rows == 1;
  // a [B, 1, S] mask: the thread's two keys' entries
  float mk1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mk1[r] = mrow1 ? a.mask[(size_t)b * S + at[r]] : 0.f;

  cp_tile<DH, L::LD, MODE>(ks, k, (size_t)b * S * a.lk + col0, BM, k0, S,
                           a.lk, 0, dh);
  cp_tile<DH, L::LD, MODE>(vs, v, (size_t)b * S * a.lv + col0, BM, k0, S,
                           a.lv, 0, dh);
  uic_mma::commit();
  float adk[L::CW / 8][4], adv[L::CW / 8][4];
#pragma unroll
  for (int n = 0; n < L::CW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  const bf* kw = ks + warp * 16 * L::LD;
  const bf* vw = vs + warp * 16 * L::LD;

  for (int q0 = 0; q0 < T; q0 += BK) {
    __syncthreads();   // the previous tile's qs, gs and row terms are read
    cp_tile<DH, L::LD, MODE>(qs, q, qb, BK, q0, T, a.lq, 0, dh);
    cp_tile<DH, L::LD, MODE>(gs, g, gb, BK, q0, T, a.lo, 0, dh);
    uic_mma::commit();
    if (threadIdx.x < BK) {
      const int row = q0 + threadIdx.x;
      const bool ok = row < T;
      rm[threadIdx.x] = ok ? st_m[row] : 0.f;
      rl[threadIdx.x] = ok ? 1.f / st_l[row] : 1.f;
      rd[threadIdx.x] = ok ? dd[row] : 0.f;
    }
    uic_mma::wait<0>();
    __syncthreads();
    if (!active) continue;
    // the tile in halves of 32 queries: two fewer [16][32] f32 tiles a
    // thread than whole 64-query steps would hold
    for (int qh = 0; qh < BK && q0 + qh < T; qh += 32) {
      with_extent<2>(groups(min(32, T - q0 - qh)), [&](auto I) {
        constexpr int IN = decltype(I)::value;
        const int qt = q0 + qh;   // the half's first query
        // the masked bits (4 j + e) of the 16 keys x 16 IN queries
        unsigned mb;
        if (mrow1) {
          mb = ((mk1[0] < 0.f ? 3u : 0u) | (mk1[1] < 0.f ? 12u : 0u)) *
               0x11111111u;
        } else {
          mb = 0u;
#pragma unroll
          for (int j = 0; j < 2 * IN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = qt + 8 * j + 2 * qd + (e & 1);
              const float mv = ld_if(
                  a.mask + ((size_t)b * T + row) * S + keys[e >> 1],
                  row < T && keys[e >> 1] < S, 0.f);
              mb |= (unsigned)(mv < 0.f) << (4 * j + e);
            }
        }
        // p (0 where masked or past T / S), attn (rounded to bf16 pairs)
        // and the dropout's keep bits; rows past T read zero q rows and
        // the neutral row terms, so every value is finite before it is
        // selected away
        float p[8][4];
        unsigned pk[8][2], keep = 0u;
        nt_product<DH, IN>(kw, qs + qh * L::LD, p, lane);
#pragma unroll
        for (int j = 0; j < 2 * IN; ++j) {
          scaled2<P2>(p[j][0], p[j][1], inv);
          scaled2<P2>(p[j][2], p[j][3], inv);
          float av[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, key = keys[r];
            const int qi = qh + 8 * j + 2 * qd + (e & 1), row = q0 + qi;
            const bool live = key < S && row < T;
            const bool msk = (mb >> (4 * j + e)) & 1u;
            const float pv = __expf((msk ? NEG : p[j][e]) - rm[qi]) * rl[qi];
            float kept = pv;
            if (a.dropout) {
              const bool kp =
                  keep_hash(base, (uint32_t)row * (uint32_t)S + key) >=
                  a.thresh;
              kept = kp ? pv * inv_keep : 0.f;
              keep |= (unsigned)kp << (4 * j + e);
            }
            p[j][e] = live && !msk ? pv : 0.f;
            av[e] = live ? kept : 0.f;
          }
          pk[j][0] = pack(av[0], av[1]);
          pk[j][1] = pack(av[2], av[3]);
        }
        rn_product<L::CW, L::LD, IN>(pk, gs + qh * L::LD + hc, adv, lane);
        float dp[8][4];
        nt_product<DH, IN>(vw, gs + qh * L::LD, dp, lane);
#pragma unroll
        for (int j = 0; j < 2 * IN; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qh + 8 * j + 2 * qd + (e & 1);
            float d = dp[j][e];
            if (a.dropout)
              d = (keep >> (4 * j + e)) & 1u ? d * inv_keep : 0.f;
            p[j][e] = p[j][e] * (d - rd[qi]) * inv_sqrt;   // ds / sqrt(dh)
          }
          pk[j][0] = pack(p[j][0], p[j][1]);   // rounded to bf16
          pk[j][1] = pack(p[j][2], p[j][3]);
        }
        if (oc == 0) {
#pragma unroll
          for (int j = 0; j < 2 * IN; ++j) {
            const int col = qt + 8 * j + 2 * qd;
            if (col >= lds) continue;
#pragma unroll
            for (int r = 0; r < 2; ++r)
              if (keys[r] < S)
                *reinterpret_cast<unsigned*>(dsw + (size_t)keys[r] * lds +
                                             col) = pk[j][r];
          }
        }
        rn_product<L::CW, L::LD, IN>(pk, qs + qh * L::LD + hc, adk, lane);
      });
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = keys[r];
    if (key >= S) continue;
    store_rows<L::CW, MODE>(dk + ((size_t)b * S + key) * a.lk + col0, adk, r,
                            hc, dh, lane);
    store_rows<L::CW, MODE>(dv + ((size_t)b * S + key) * a.lv + col0, adv, r,
                            hc, dh, lane);
  }
}

// The backward's dq = ds K: a block per (b, h, BM queries, OW columns), 4
// warps of 16 queries, walking the key tiles of ds^T (key-major, so its A
// fragments load through ldmatrix.trans) and K, double-buffered.
template <int DH, int MODE>
__global__ void __launch_bounds__(NTC, TL<DH>::MINB)
    mha_bwd_dq_tc_kernel(const __grid_constant__ Attn a,
                         const bf* __restrict__ ds_t, bf* __restrict__ dq,
                         int nchunks) {
  using L = TL<DH>;
  constexpr int LDD = BM + SP;                  // a ds^T tile's row
  constexpr int STAGE = BK * LDD + BK * L::LDO; // ds^T tile, then K tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf* sm = reinterpret_cast<bf*>(tc_smem);
  const int oc = blockIdx.x % nchunks, q0 = blockIdx.x / nchunks * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = a.T, S = a.S, lds = (T + 7) & ~7;
  const int dh = MODE == FULL ? DH : a.dh;
  const int col0 = h * dh, hc = oc * L::OW;
  const bf* k = static_cast<const bf*>(a.k);
  const size_t kb = (size_t)b * S * a.lk + col0;
  const bf* dsb = ds_t + ((size_t)b * a.H + h) * S * lds;
  const bool active = q0 + warp * 16 < T;
  const int n_kt = (S + BK - 1) / BK;

  auto load = [&](int stage, int k0) {
    bf* st = sm + stage * STAGE;
    constexpr int CH = BM / 8;
    for (int e = threadIdx.x; e < BK * CH; e += NTC) {
      const int r = e / CH, c = (e % CH) * 8, key = k0 + r;
      const bool ok = key < S && q0 + c < lds;
      uic_mma::cp16(st + r * LDD + c,
                    ok ? dsb + (size_t)key * lds + q0 + c : dsb, ok);
    }
    cp_tile<L::OW, L::LDO, MODE>(st + BK * LDD, k, kb, BK, k0, S, a.lk, hc,
                                 dh);
    uic_mma::commit();
  };

  float acc[L::OW / 8][4];
#pragma unroll
  for (int n = 0; n < L::OW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  load(0, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < n_kt) {
      load((kt + 1) & 1, k0 + BK);
      uic_mma::wait<1>();
    } else {
      uic_mma::wait<0>();
    }
    __syncthreads();
    if (active) {
      const bf* dst = sm + (kt & 1) * STAGE;
      const bf* kst = dst + BK * LDD;
      with_extent<4>(groups(min(BK, S - k0)), [&](auto J) {
        constexpr int JN = decltype(J)::value;
        const bf* ap = dst + kmaj_row(lane) * LDD + warp * 16 + kmaj_col(lane);
        const bf* bp = kst + frag_row(lane) * L::LDO + frag_col(lane);
#pragma unroll
        for (int kk = 0; kk < JN; ++kk) {
          unsigned af[4];
          ldsm_x4_t(af, ap + kk * 16 * LDD);
#pragma unroll
          for (int nn = 0; nn < L::OW / 16; ++nn) {
            unsigned bk[4];
            ldsm_x4_t(bk, bp + kk * 16 * L::LDO + nn * 16);
            uic_mma::mma(acc[2 * nn], af, bk[0], bk[1]);
            uic_mma::mma(acc[2 * nn + 1], af, bk[2], bk[3]);
          }
        }
      });
    }
    // every thread is done with this stage before the next prefetch
    __syncthreads();
  }
  if (!active) return;
  const int row0 = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < T)
      store_rows<L::OW, MODE>(dq + ((size_t)b * T + row) * a.lq + col0, acc,
                              r, hc, dh, lane);
  }
}

// the mask rows of a call's tiles (stage_mask): 1 for a [B, 1, S] mask,
// else the block's rows
inline int staged_rows(const Attn& a) {
  return a.mask_rows == 1 ? 1 : BM / key_slices(a.T);
}
template <int DH>
size_t fwd_smem(const Attn& a) {
  using L = TL<DH>;
  return sizeof(bf) * (BM * L::LD + 2 * BK * L::LD + 2 * BK * L::LDO) +
         sizeof(float) * (NW * 16 * 2 + 2 * staged_rows(a) * BK);
}
template <int DH>
size_t rows_smem(const Attn& a) {
  using L = TL<DH>;
  return sizeof(bf) * (2 * BM * L::LD + L::RSTAGES * 2 * BK * L::LD) +
         sizeof(float) * (NW * 16 + L::RSTAGES * staged_rows(a) * BK);
}
template <int DH>
size_t dkdv_smem() {
  using L = TL<DH>;
  return sizeof(bf) * (2 * BM * L::LD + 2 * BK * L::LD) +
         sizeof(float) * 3 * BK;
}
template <int DH>
size_t dq_smem() {
  using L = TL<DH>;
  return sizeof(bf) * 2 * (BK * (BM + SP) + BK * L::LDO);
}

}  // namespace tc
}  // namespace mha
}  // namespace uic
