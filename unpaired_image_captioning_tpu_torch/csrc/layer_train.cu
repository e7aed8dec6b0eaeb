// Whole-layer training transformer layers, forward and backward, for Hopper
// (sm_90a). Replaces the TPU kernels unpaired_image_captioning_tpu/ops/
// layer_train.py::_fwd_kernel, ::_bwd_ffn_kernel and ::_bwd_attn_kernel
// (`fused_enc_layer`), and ::_dec_fwd_kernel and ::_bwd_cross_kernel
// (`fused_dec_layer`, whose backward reuses the encoder's two programs).
//
// The function (ops/layer_train.py states it in full): a pre-norm encoder
// layer over x [B, T, d], all rows M = B*T at once,
//
//   y1 = LN1(x);  qkv = y1 Wqkv + bqkv;  ao = attn(q | k | v of qkv)
//   x2 = x + drop(ao Wo + bo, site 1)
//   y2 = LN2(x2); hd = drop(relu(y2 W1 + b1), site 2)
//   out = x2 + drop(hd W2 + b2, site 3)
//
// and the decoder layer, which adds y2' = LN2(x2), qc = y2' Wq + bq,
// co = attn(qc, mk, mv), x3 = x2 + drop'(co Wo2 + bo2, site 1) under the
// second seed, and runs the FFN on LN3(x3). LN is the reference's (unbiased
// variance, eps outside the sqrt); dropout is the Pallas splitmix32 hash at
// block id (b * 4 + site) * H + h and element t * cols + c of the batch
// element's [T, cols] block; attention probabilities are site 0 per head.
//
// Design. The Pallas kernel runs one program per batch element with the
// layer's weights resident in VMEM and sums the weight gradients along its
// sequential grid. A Hopper block cannot hold the 3-6 MB of weights, so
// here every product runs over all M rows, as a fixed sequence of short
// kernels launched from one C call per layer and direction:
//
//   - LayerNorm: ln_train.cu's kernels (ln_train.cuh); the backward adds the
//     residual gradient into dx and sums d_scale / d_offset in block order;
//   - products: gemm.cuh's f32 GEMM (no TF32, no tensor cores, no library
//     call) with the dropout, relu and residual work in its epilogues; the
//     input gradients as dY W^T; the weight gradients as A^T dY split over
//     at most 16 row ranges whose partial products are then added in range
//     order, and the bias gradients as column sums the same way: no float
//     atomics, the same bits every run;
//   - attention: mha_train.cu's kernels (mha_train.cuh) over the q | k | v
//     column blocks of the packed [M, 3d] projection, with the layer's
//     site-0 block ids.
//
// Save, do not recompute: the Pallas backward keeps only x and x2 (x3)
// because VMEM is small; here the forward also writes y1, qkv, ao, y2 and hd
// (the decoder qc, co and y3 too), 161 MB a layer at the captioner's
// encoder shape (9,800 rows of 4,096 floats), so the backward runs no
// forward product again.
//
// What bounds it on the card: operations. At the captioner's encoder layer
// (M = 9,800, d = d_ff = 512, T = 196, 8 heads) the forward is 30.8 GFLOP
// of products and 3.9 of attention (0.52 ms at 67 TFLOP/s f32) against
// about 0.3 GB of traffic (0.09 ms); the backward about twice the
// products. The f32 GEMM tiles reach a fraction of that peak (see PERF.md);
// bf16 / wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "gemm.cuh"
#include "ln_train.cuh"
#include "mha_train.cuh"

namespace {

using uic::Attn;
using uic::EpiBias;
using uic::GemmArgs;

constexpr int N_SITES = 4;        // dropout sites per (layer, element)
constexpr float EPS = 1e-6f;      // LayerNorm eps, outside the sqrt
constexpr int SPLIT_ROWS = 256;   // rows per range of a weight gradient, at least
constexpr int MAX_SPLITS = 16;    // ranges of a weight gradient, at most
constexpr int ELT_THREADS = 256;

struct Dims {
  int B, T, S, d, f, H;
  unsigned int thresh;
  float keep_div;
  int dropout;
};

// the dropout of one residual or FFN site over [M, cols] (h = 0)
struct Drop {
  const int* seed;
  int T, H, site, cols;
  unsigned int thresh;
  float keep_div;
  int on;

  __device__ __forceinline__ float one(uint32_t base, int t, int c,
                                       float v) const {
    const uint32_t x = uic::keep_hash(base, (uint32_t)(t * cols + c));
    return x >= thresh ? v / keep_div : 0.0f;
  }
  __device__ __forceinline__ uint32_t base_of(int r, int* t) const {
    const int b = r / T;
    *t = r - b * T;
    return uic::hash_base(*seed, (b * N_SITES + site) * H);
  }
  __device__ __forceinline__ float4 apply(int r, int c, float4 v) const {
    if (!on) return v;
    int t;
    const uint32_t base = base_of(r, &t);
    return make_float4(one(base, t, c, v.x), one(base, t, c + 1, v.y),
                       one(base, t, c + 2, v.z), one(base, t, c + 3, v.w));
  }
};

Drop drop_at(const int* seed, const Dims& m, int site, int cols) {
  return Drop{seed, m.T, m.H, site, cols, m.thresh, m.keep_div, m.dropout};
}

// out = res + drop(acc + bias)
struct EpiResDrop {
  const float* bias;
  const float* res;
  float* out;
  int ld;
  Drop drop;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const float4 b4 = *reinterpret_cast<const float4*>(bias + c);
    const float4 v = drop.apply(
        r, c,
        make_float4(acc.x + b4.x, acc.y + b4.y, acc.z + b4.z, acc.w + b4.w));
    const size_t o = (size_t)r * ld + c;
    const float4 x4 = *reinterpret_cast<const float4*>(res + o);
    *reinterpret_cast<float4*>(out + o) =
        make_float4(x4.x + v.x, x4.y + v.y, x4.z + v.z, x4.w + v.w);
  }
};

// out = drop(relu(acc + bias))
struct EpiReluDrop {
  const float* bias;
  float* out;
  int ld;
  Drop drop;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const float4 b4 = *reinterpret_cast<const float4*>(bias + c);
    *reinterpret_cast<float4*>(out + (size_t)r * ld + c) = drop.apply(
        r, c,
        make_float4(fmaxf(acc.x + b4.x, 0.0f), fmaxf(acc.y + b4.y, 0.0f),
                    fmaxf(acc.z + b4.z, 0.0f), fmaxf(acc.w + b4.w, 0.0f)));
  }
};

// the FFN's relu and dropout backward from the forward's hd = drop(relu(h)):
// hd > 0 exactly where h > 0 and the mask keeps, so
// out = hd > 0 ? acc / (1 - rate) : 0 (acc itself at rate 0)
struct EpiDrelu {
  const float* hd;
  float* out;
  int ld;
  Drop drop;
  __device__ __forceinline__ float one(float h, float v) const {
    return h > 0.0f ? (drop.on ? v / drop.keep_div : v) : 0.0f;
  }
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const size_t o = (size_t)r * ld + c;
    const float4 h4 = *reinterpret_cast<const float4*>(hd + o);
    *reinterpret_cast<float4*>(out + o) =
        make_float4(one(h4.x, acc.x), one(h4.y, acc.y), one(h4.z, acc.z),
                    one(h4.w, acc.w));
  }
};

struct EpiStore {
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    *reinterpret_cast<float4*>(out + (size_t)r * ld + c) = acc;
  }
};

// one row range's partial product: out[split][r][c]
struct EpiPartial {
  float* out;
  int M, N;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int split) const {
    *reinterpret_cast<float4*>(out + ((size_t)split * M + r) * N + c) = acc;
  }
};

// out = drop(g) over [M, cols]
__global__ void __launch_bounds__(ELT_THREADS)
    drop_kernel(const float* __restrict__ g, float* __restrict__ out, int M,
                Drop drop) {
  const size_t n = (size_t)M * drop.cols;
  for (size_t e = (size_t)blockIdx.x * ELT_THREADS + threadIdx.x; e < n;
       e += (size_t)gridDim.x * ELT_THREADS) {
    const int r = (int)(e / drop.cols), c = (int)(e % drop.cols);
    int t;
    const uint32_t base = drop.base_of(r, &t);
    out[e] = drop.one(base, t, c, g[e]);
  }
}

// partial[split][c] = sum of y[r][c] over the split's rows, in row order
__global__ void __launch_bounds__(ELT_THREADS)
    colsum_kernel(const float* __restrict__ y, int ld, int M, int N,
                  int chunk, float* __restrict__ partial) {
  const int c = blockIdx.x * ELT_THREADS + threadIdx.x;
  if (c >= N) return;
  const int r0 = blockIdx.y * chunk, r1 = min(M, r0 + chunk);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += y[(size_t)r * ld + c];
  partial[(size_t)blockIdx.y * N + c] = s;
}

// out[i] = sum over the splits, in split order, of partial[split][i]
__global__ void __launch_bounds__(ELT_THREADS)
    sum_splits_kernel(const float* __restrict__ partial, int splits, int n,
                      float* __restrict__ out) {
  const int i = blockIdx.x * ELT_THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * n + i];
  out[i] = s;
}

int blocks_for(size_t n) {
  const size_t b = (n + ELT_THREADS - 1) / ELT_THREADS;
  return (int)(b < 65535 * 16 ? b : 65535 * 16);
}

// the row ranges of a weight gradient over M rows: (count, rows a range,
// a multiple of the GEMM's depth tile)
struct Split {
  int n, chunk;
};

Split split_rows(int M) {
  int n = (M + SPLIT_ROWS - 1) / SPLIT_ROWS;
  n = n < 1 ? 1 : (n > MAX_SPLITS ? MAX_SPLITS : n);
  const int bk = uic::GEMM_BK;
  const int chunk = ((M + n - 1) / n + bk - 1) / bk * bk;
  return Split{(M + chunk - 1) / chunk, chunk};
}

// C [M, N] = A [M, K] W [K, N]
GemmArgs fwd_args(const float* a, const float* w, int M, int N, int K) {
  return GemmArgs{a, w, nullptr, nullptr, K, N, M, N, K, K};
}

// C [M, N] = dY [M, K] W^T for W [N, K] row-major
GemmArgs dx_args(const float* dy, const float* w, int M, int N, int K) {
  return GemmArgs{dy, w, nullptr, nullptr, K, K, M, N, K, K};
}

// The scratch of a backward call: gradients of the layer's activations,
// the attention's row statistics and the partial sums of the weight
// gradients. carve() lays it out from `base` (null: only to size it).
struct Work {
  float *df, *dlin, *dy, *dx2, *dx3, *dout, *dattn, *dqkv, *stats, *partial,
      *ln_partial;
  size_t floats;
};

Work carve(float* base, int kind, int B, int T, int d, int f, int H) {
  const size_t M = (size_t)B * T;
  size_t at = 0;
  auto take = [&](size_t n) {
    float* p = base ? base + at : nullptr;
    at += (n + 3) / 4 * 4;   // 16-byte aligned regions
    return p;
  };
  const size_t wmax = (size_t)d * (3 * d > f ? 3 * d : f);
  Work w;
  w.df = take(M * d);
  w.dlin = take(M * f);
  w.dy = take(M * d);
  w.dx2 = take(M * d);
  w.dx3 = kind == 1 ? take(M * d) : nullptr;
  w.dout = take(M * d);
  w.dattn = take(M * d);
  w.dqkv = take(M * 3 * d);
  w.stats = take((size_t)B * H * T * 3);
  w.partial = take((size_t)MAX_SPLITS * wmax);
  w.ln_partial = take((size_t)uic::LN_BWD_MAX_BLOCKS * 2 * d);
  w.floats = at;
  return w;
}

// dw [K, N] = A^T dY and db [N] = column sums of dY, both over M rows, in
// row-range order; A [M, K] with row stride lda, dY [M, N] with ldy
int wgrad(const float* a, int lda, int K, const float* dy, int ldy, int N,
          int M, float* dw, float* db, float* partial, cudaStream_t st) {
  const Split sp = split_rows(M);
  const GemmArgs p{a, dy, nullptr, nullptr, lda, ldy, K, N, M, sp.chunk};
  int err = uic::gemm<false, true, false>(p, EpiPartial{partial, K, N}, st,
                                          sp.n);
  if (err) return err;
  const int n = K * N;
  sum_splits_kernel<<<(n + ELT_THREADS - 1) / ELT_THREADS, ELT_THREADS, 0,
                      st>>>(partial, sp.n, n, dw);
  if ((err = (int)cudaGetLastError())) return err;
  colsum_kernel<<<dim3((N + ELT_THREADS - 1) / ELT_THREADS, sp.n),
                  ELT_THREADS, 0, st>>>(dy, ldy, M, N, sp.chunk, partial);
  if ((err = (int)cudaGetLastError())) return err;
  sum_splits_kernel<<<(N + ELT_THREADS - 1) / ELT_THREADS, ELT_THREADS, 0,
                      st>>>(partial, sp.n, N, db);
  return (int)cudaGetLastError();
}

// g itself at rate 0, else drop(g) in `out`
const float* dropped(const float* g, float* out, const Drop& drop, int M,
                     cudaStream_t st, int* err) {
  if (!drop.on) return g;
  drop_kernel<<<blocks_for((size_t)M * drop.cols), ELT_THREADS, 0, st>>>(
      g, out, M, drop);
  *err = (int)cudaGetLastError();
  return out;
}

Attn attn_args(const float* q, int lq, const float* k, int lk, const float* v,
               int lv, const float* mask, int mask_rows, const int* seed,
               int S, const Dims& m) {
  return Attn{q, k, v, mask, seed, lq, lk, lv, m.d, m.B, m.T, S, m.H,
              m.d / m.H, mask_rows, N_SITES * m.H, m.thresh, m.keep_div,
              m.dropout};
}

// The self-attention sublayer: x2 = x + drop(attn(LN1(x) Wqkv + bqkv) Wo +
// bo, site 1); keeps y1, qkv and ao
int self_fwd(const float* x, const float* mask, int mask_rows,
             const int* seed, const float* wqkv, const float* bqkv,
             const float* wo, const float* bo, const float* ls,
             const float* lb, float* y1, float* qkv, float* ao, float* x2,
             const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d;
  int err = uic::ln_fwd(x, ls, lb, y1, M, d, EPS, st);
  if (err) return err;
  if ((err = uic::gemm<false, false, false>(fwd_args(y1, wqkv, M, 3 * d, d),
                                            EpiBias{bqkv, qkv, 3 * d}, st)))
    return err;
  if ((err = uic::attn_fwd(attn_args(qkv, 3 * d, qkv + d, 3 * d, qkv + 2 * d,
                                     3 * d, mask, mask_rows, seed, m.T, m),
                           ao, st)))
    return err;
  return uic::gemm<false, false, false>(
      fwd_args(ao, wo, M, d, d),
      EpiResDrop{bo, x, x2, d, drop_at(seed, m, 1, d)}, st);
}

// The cross-attention sublayer: x3 = x2 + drop(attn(LN2(x2) Wq + bq, mk, mv)
// Wo2 + bo2, site 1) under seed2; keeps y2, qc and co
int cross_fwd(const float* x2, const float* mk, const float* mv,
              const float* sm, const int* seed2, const float* wq,
              const float* bq, const float* wo2, const float* bo2,
              const float* ls, const float* lb, float* y2, float* qc,
              float* co, float* x3, const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d;
  int err = uic::ln_fwd(x2, ls, lb, y2, M, d, EPS, st);
  if (err) return err;
  if ((err = uic::gemm<false, false, false>(fwd_args(y2, wq, M, d, d),
                                            EpiBias{bq, qc, d}, st)))
    return err;
  if ((err = uic::attn_fwd(attn_args(qc, d, mk, d, mv, d, sm, 1, seed2, m.S,
                                     m),
                           co, st)))
    return err;
  return uic::gemm<false, false, false>(
      fwd_args(co, wo2, M, d, d),
      EpiResDrop{bo2, x2, x3, d, drop_at(seed2, m, 1, d)}, st);
}

// The FFN sublayer: out = xa + drop(drop(relu(LN(xa) W1 + b1), site 2) W2 +
// b2, site 3); keeps y and hd
int ffn_fwd(const float* xa, const int* seed, const float* w1,
            const float* b1, const float* w2, const float* b2,
            const float* ls, const float* lb, float* y, float* hd,
            float* out, const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d, f = m.f;
  int err = uic::ln_fwd(xa, ls, lb, y, M, d, EPS, st);
  if (err) return err;
  if ((err = uic::gemm<false, false, false>(
           fwd_args(y, w1, M, f, d),
           EpiReluDrop{b1, hd, f, drop_at(seed, m, 2, f)}, st)))
    return err;
  return uic::gemm<false, false, false>(
      fwd_args(hd, w2, M, d, f),
      EpiResDrop{b2, xa, out, d, drop_at(seed, m, 3, d)}, st);
}

// The FFN half of the backward (the Pallas `_bwd_ffn_kernel`): from
// g = d(out) to dxa = g + d(LN) and the FFN / LN weight gradients
int ffn_bwd(const float* xa, const float* y, const float* hd, const float* g,
            const int* seed, const float* w1, const float* w2,
            const float* ls, float* dxa, float* dw1, float* db1, float* dw2,
            float* db2, float* dls, float* dlb, const Work& w, const Dims& m,
            cudaStream_t st) {
  const int M = m.B * m.T, d = m.d, f = m.f;
  int err = 0;
  const float* df = dropped(g, w.df, drop_at(seed, m, 3, d), M, st, &err);
  if (err) return err;
  if ((err = wgrad(hd, f, f, df, d, d, M, dw2, db2, w.partial, st)))
    return err;
  if ((err = uic::gemm<false, false, true>(
           dx_args(df, w2, M, f, d),
           EpiDrelu{hd, w.dlin, f, drop_at(seed, m, 2, f)}, st)))
    return err;
  if ((err = wgrad(y, d, d, w.dlin, f, f, M, dw1, db1, w.partial, st)))
    return err;
  if ((err = uic::gemm<false, false, true>(dx_args(w.dlin, w1, M, d, f),
                                           EpiStore{w.dy, d}, st)))
    return err;
  return uic::ln_bwd(xa, ls, w.dy, g, dxa, dls, dlb, w.ln_partial, M, d,
                     uic::ln_bwd_blocks(M), EPS, st);
}

// The self-attention half (the Pallas `_bwd_attn_kernel`): from g2 = d(x2)
// to dx = g2 + d(LN1) and the QKV / O / LN1 weight gradients
int self_bwd(const float* x, const float* mask, int mask_rows,
             const int* seed, const float* y1, const float* qkv,
             const float* ao, const float* g2, const float* wqkv,
             const float* wo, const float* ls, float* dx, float* dwqkv,
             float* dbqkv, float* dwo, float* dbo, float* dls, float* dlb,
             const Work& w, const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d;
  int err = 0;
  const float* dout = dropped(g2, w.dout, drop_at(seed, m, 1, d), M, st,
                              &err);
  if (err) return err;
  if ((err = wgrad(ao, d, d, dout, d, d, M, dwo, dbo, w.partial, st)))
    return err;
  if ((err = uic::gemm<false, false, true>(dx_args(dout, wo, M, d, d),
                                           EpiStore{w.dattn, d}, st)))
    return err;
  if ((err = uic::attn_bwd(
           attn_args(qkv, 3 * d, qkv + d, 3 * d, qkv + 2 * d, 3 * d, mask,
                     mask_rows, seed, m.T, m),
           w.dattn, ao, w.dqkv, w.dqkv + d, w.dqkv + 2 * d, w.stats, st)))
    return err;
  if ((err = wgrad(y1, d, d, w.dqkv, 3 * d, 3 * d, M, dwqkv, dbqkv, w.partial,
                   st)))
    return err;
  if ((err = uic::gemm<false, false, true>(dx_args(w.dqkv, wqkv, M, d, 3 * d),
                                           EpiStore{w.dy, d}, st)))
    return err;
  return uic::ln_bwd(x, ls, w.dy, g2, dx, dls, dlb, w.ln_partial, M, d,
                     uic::ln_bwd_blocks(M), EPS, st);
}

// The cross-attention half (the Pallas `_bwd_cross_kernel`): from
// g3 = d(x3) to dx2 = g3 + d(LN2), dmk, dmv and the Wq / Wo2 / LN2 weight
// gradients
int cross_bwd(const float* x2, const float* mk, const float* mv,
              const float* sm, const int* seed2, const float* y2,
              const float* qc, const float* co, const float* g3,
              const float* wq, const float* wo2, const float* ls, float* dx2,
              float* dmk, float* dmv, float* dwq, float* dbq, float* dwo2,
              float* dbo2, float* dls, float* dlb, const Work& w,
              const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d;
  int err = 0;
  const float* dout = dropped(g3, w.dout, drop_at(seed2, m, 1, d), M, st,
                              &err);
  if (err) return err;
  if ((err = wgrad(co, d, d, dout, d, d, M, dwo2, dbo2, w.partial, st)))
    return err;
  if ((err = uic::gemm<false, false, true>(dx_args(dout, wo2, M, d, d),
                                           EpiStore{w.dattn, d}, st)))
    return err;
  float* dqc = w.dqkv;   // [M, d]
  if ((err = uic::attn_bwd(attn_args(qc, d, mk, d, mv, d, sm, 1, seed2, m.S,
                                     m),
                           w.dattn, co, dqc, dmk, dmv, w.stats, st)))
    return err;
  if ((err = wgrad(y2, d, d, dqc, d, d, M, dwq, dbq, w.partial, st)))
    return err;
  if ((err = uic::gemm<false, false, true>(dx_args(dqc, wq, M, d, d),
                                           EpiStore{w.dy, d}, st)))
    return err;
  return uic::ln_bwd(x2, ls, w.dy, g3, dx2, dls, dlb, w.ln_partial, M, d,
                     uic::ln_bwd_blocks(M), EPS, st);
}

Dims dims(int B, int T, int S, int d, int f, int H, unsigned int thresh,
          float keep_div, int dropout) {
  return Dims{B, T, S, d, f, H, thresh, keep_div, dropout};
}

#define F(i) (static_cast<const float*>(p[i]))
#define O(i) (static_cast<float*>(const_cast<void*>(p[i])))
#define I(i) (static_cast<const int*>(p[i]))

}  // namespace

extern "C" {

// Floats of scratch a backward call takes: kind 0 the encoder layer, 1 the
// decoder layer; -1 past 2^31 - 1.
int layer_train_ws_f32(int kind, int B, int T, int S, int d, int f, int H) {
  (void)S;
  const size_t n = carve(nullptr, kind, B, T, d, f, H).floats;
  return n > 0x7FFFFFFF ? -1 : (int)n;
}

// p: x, mask [B, mask_rows, T], seed [1], wqkv, bqkv, wo, bo, w1, b1, w2,
// b2, l1s, l1b, l2s, l2b; out; saved x2, y1, qkv [B*T, 3d], ao, y2,
// hd [B*T, f]. Activations [B*T, d] unless stated.
int enc_layer_fwd_f32(const void* const* p, int B, int T, int d, int f, int H,
                      int mask_rows, unsigned int thresh, float keep_div,
                      int dropout, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims m = dims(B, T, T, d, f, H, thresh, keep_div, dropout);
  int err = self_fwd(F(0), F(1), mask_rows, I(2), F(3), F(4), F(5), F(6),
                     F(11), F(12), O(17), O(18), O(19), O(16), m, st);
  if (err) return err;
  return ffn_fwd(O(16), I(2), F(7), F(8), F(9), F(10), F(13), F(14), O(20),
                 O(21), O(15), m, st);
}

// p: x, mask, seed, the 12 weights as above (3-14), saved x2, y1, qkv, ao,
// y2, hd (15-20), g (21); dx (22) and the 12 weight gradients (23-34) in
// the weights' order. ws: layer_train_ws_f32(0, ...) floats.
int enc_layer_bwd_f32(const void* const* p, int B, int T, int d, int f, int H,
                      int mask_rows, unsigned int thresh, float keep_div,
                      int dropout, float* ws, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims m = dims(B, T, T, d, f, H, thresh, keep_div, dropout);
  const Work w = carve(ws, 0, B, T, d, f, H);
  int err = ffn_bwd(F(15), F(19), F(20), F(21), I(2), F(7), F(9), F(13),
                    w.dx2, O(27), O(28), O(29), O(30), O(33), O(34), w, m,
                    st);
  if (err) return err;
  return self_bwd(F(0), F(1), mask_rows, I(2), F(16), F(17), F(18), w.dx2,
                  F(3), F(5), F(11), O(22), O(23), O(24), O(25), O(26),
                  O(31), O(32), w, m, st);
}

// p: x, mk [B, S, d], mv, tgt mask [B, tmask_rows, T], src mask [B, 1, S],
// seeds [2] (0-5); wqkv, bqkv, wo, bo, wq, bq, wo2, bo2, w1, b1, w2, b2,
// l1s, l1b, l2s, l2b, l3s, l3b (6-23); out (24); saved x2, x3, y1, qkv, ao,
// y2, qc, co, y3, hd (25-34).
int dec_layer_fwd_f32(const void* const* p, int B, int T, int S, int d,
                      int f, int H, int tmask_rows, unsigned int thresh,
                      float keep_div, int dropout, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims m = dims(B, T, S, d, f, H, thresh, keep_div, dropout);
  const int* seed = I(5);
  int err = self_fwd(F(0), F(3), tmask_rows, seed, F(6), F(7), F(8), F(9),
                     F(18), F(19), O(27), O(28), O(29), O(25), m, st);
  if (err) return err;
  if ((err = cross_fwd(O(25), F(1), F(2), F(4), seed + 1, F(10), F(11),
                       F(12), F(13), F(20), F(21), O(30), O(31), O(32), O(26),
                       m, st)))
    return err;
  return ffn_fwd(O(26), seed, F(14), F(15), F(16), F(17), F(22), F(23),
                 O(33), O(34), O(24), m, st);
}

// p: the 24 forward inputs (0-23), saved as above (24-33), g (34); dx (35),
// dmk (36), dmv (37) and the 18 weight gradients (38-55) in the weights'
// order. ws: layer_train_ws_f32(1, ...) floats.
int dec_layer_bwd_f32(const void* const* p, int B, int T, int S, int d,
                      int f, int H, int tmask_rows, unsigned int thresh,
                      float keep_div, int dropout, float* ws, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims m = dims(B, T, S, d, f, H, thresh, keep_div, dropout);
  const Work w = carve(ws, 1, B, T, d, f, H);
  const int* seed = I(5);
  int err = ffn_bwd(F(25), F(32), F(33), F(34), seed, F(14), F(16), F(22),
                    w.dx3, O(46), O(47), O(48), O(49), O(54), O(55), w, m,
                    st);
  if (err) return err;
  if ((err = cross_bwd(F(24), F(1), F(2), F(4), seed + 1, F(29), F(30),
                       F(31), w.dx3, F(10), F(12), F(20), w.dx2, O(36), O(37),
                       O(42), O(43), O(44), O(45), O(52), O(53), w, m, st)))
    return err;
  return self_bwd(F(0), F(3), tmask_rows, seed, F(26), F(27), F(28), w.dx2,
                  F(6), F(8), F(18), O(35), O(38), O(39), O(40), O(41),
                  O(50), O(51), w, m, st);
}

}  // extern "C"
