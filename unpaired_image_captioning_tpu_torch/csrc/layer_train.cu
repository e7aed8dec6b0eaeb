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
//     residual gradient into dx and sums d_scale / d_offset in a fixed
//     order in the same launch;
//   - products: train_gemm.cuh's f32 GEMM (no TF32, no tensor cores, no
//     library call; 128 x 128 tiles, 8 x 8 register tiles, a 3-stage
//     cp.async ring) with the dropout, relu and residual work in its
//     epilogues. The input gradients dY W^T read W^T, which one launch at
//     the start of a backward writes for all the layer's weights, so every
//     product reads B row-major. A weight gradient X^T dY over the M rows is
//     one launch: K split across a thread-block cluster, the partial tiles
//     summed in rank order through distributed shared memory, the bias
//     gradient summed from the dY tiles in the same launch. No float
//     atomics, the same bits every run;
//   - attention: mha_train.cu's kernels (mha_train.cuh) over the q | k | v
//     column blocks of the packed [M, 3d] projection, with the layer's
//     site-0 block ids; the forward's row statistics of the softmax go to a
//     saved array the wrapper allocates, and the backward reads them.
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
// about 0.3 GB of traffic (0.09 ms); the backward 61.6 GFLOP of products
// and about 10 of attention (1.07 ms). The products take most of the time
// at the f32 FMA rate train_gemm.cuh reaches (PERF.md); the attention
// (mha_train.cu) and the LayerNorm and dropout passes (bytes) the rest.
// wgmma and TMA wait on a numerics decision: the core stays f32 FMA.
//
// Types (the compute dtype). A call is all f32 or, on the bf16 route, all
// bf16 (x, mk, mv, the weights, g and the outputs, each weight's gradient
// in its weight's type), as the TPU kernel runs with a bf16 x under a
// bf16 copy of the parameters. A bf16 call widens its bf16 inputs once
// into f32 staging (one converting pass; the backward then stages W^T
// from those as it always does), runs the same f32 FMA sequence with the
// TPU kernel's bf16 cast points, and rounds its outputs into their bf16
// tensors in one pass at the end. The cast points (ops/layer_train.py:
// 60-95, :131-253, :444-520 of the JAX package): LayerNorm in f32 to a
// bf16 y; each `_linear` rounds its f32 product to bf16 and adds the
// bias in bf16; a forward dropout divides in bf16 by 1 - rate in bf16;
// the residual sums round; the attention as mha_train.cu's bf16 route;
// in the backward each product's cotangent is rounded where the TPU kernel
// casts it (dfc, dlinc, doc, dao, dq / dk / dv), the LayerNorm input
// gradients dy stay f32 and dx rounds; the weight gradients are summed in
// f32 and rounded once. One difference: a bias gradient here sums the
// rounded cotangent that its weight gradient reads, where the TPU kernel
// sums it unrounded (a 2^-9 relative rounding a row, within the bf16
// tolerance).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16.cuh"
#include "train_gemm.cuh"
#include "ln_train.cuh"
#include "mha_train.cuh"

namespace {

using uic::Attn;
using uic_bf16::rnd4_if;
using uic_bf16::rnd_if;
using uic_train::TrainGemm;
using uic_train::train_gemm;

constexpr int N_SITES = 4;        // dropout sites per (layer, element)
constexpr float EPS = 1e-6f;      // LayerNorm eps, outside the sqrt
constexpr int MAX_WEIGHTS = 6;    // weights a backward transposes
constexpr int ELT_THREADS = 256;

struct Dims {
  int B, T, S, d, f, H;
  unsigned int thresh;
  float keep_div;
  int dropout;
  bool rnd;   // the bf16 cast points (values rounded in f32 scratch)
};

// the dropout of one residual or FFN site over [M, cols] (h = 0): a kept
// value v / div, div = 1 - rate; on the bf16 cast points (rnd) the result
// is rounded, and in the forward div is 1 - rate in bf16, as the TPU
// kernel's `_drop` divides a bf16 value by the weakly typed 1 - rate (its
// backward divides in f32 and rounds after)
struct Drop {
  const int* seed;
  int T, H, site, cols;
  unsigned int thresh;
  float keep_div;
  int on;
  bool rnd;
  float div;

  __device__ __forceinline__ float one(uint32_t base, int t, int c,
                                       float v) const {
    const uint32_t x = uic::keep_hash(base, (uint32_t)(t * cols + c));
    return x >= thresh ? rnd_if(v / div, rnd) : 0.0f;
  }
  __device__ __forceinline__ uint32_t base_of(int r, int* t) const {
    const int b = r / T;
    *t = r - b * T;
    return uic::hash_base(*seed, (b * N_SITES + site) * H);
  }
  __device__ __forceinline__ float one_at(int r, int c, float v) const {
    if (!on) return v;
    int t;
    const uint32_t base = base_of(r, &t);
    return one(base, t, c, v);
  }
  __device__ __forceinline__ float4 apply(int r, int c, float4 v) const {
    if (!on) return v;
    int t;
    const uint32_t base = base_of(r, &t);
    return make_float4(one(base, t, c, v.x), one(base, t, c + 1, v.y),
                       one(base, t, c + 2, v.z), one(base, t, c + 3, v.w));
  }
};

// a site's dropout; fwd: the forward's (its divisor in bf16 where m.rnd)
Drop drop_at(const int* seed, const Dims& m, int site, int cols,
             bool fwd = false) {
  const float div = fwd && m.rnd ? uic_bf16::host_round_bf16(m.keep_div)
                                 : m.keep_div;
  return Drop{seed, m.T, m.H, site, cols, m.thresh, m.keep_div, m.dropout,
              m.rnd, div};
}

// `_linear` of the TPU kernel: acc + bias in f32, or on the bf16 cast
// points (rnd) the product rounded to bf16 and the bias added in bf16
__device__ __forceinline__ float lin(float acc, float b, bool rnd) {
  return rnd ? uic_bf16::round_bf16(uic_bf16::round_bf16(acc) + b)
             : acc + b;
}

__device__ __forceinline__ float4 lin4(float4 acc, float4 b, bool rnd) {
  return make_float4(lin(acc.x, b.x, rnd), lin(acc.y, b.y, rnd),
                     lin(acc.z, b.z, rnd), lin(acc.w, b.w, rnd));
}

// out = acc + bias (`_linear`)
struct EpiLin {
  const float* bias;
  float* out;
  int ld;
  bool rnd;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    *reinterpret_cast<float4*>(out + (size_t)r * ld + c) =
        lin4(acc, *reinterpret_cast<const float4*>(bias + c), rnd);
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    out[(size_t)r * ld + c] = lin(acc, bias[c], rnd);
  }
};

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
    const float4 v = drop.apply(r, c, lin4(acc, b4, drop.rnd));
    const size_t o = (size_t)r * ld + c;
    const float4 x4 = *reinterpret_cast<const float4*>(res + o);
    *reinterpret_cast<float4*>(out + o) = rnd4_if(
        make_float4(x4.x + v.x, x4.y + v.y, x4.z + v.z, x4.w + v.w),
        drop.rnd);
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    const size_t o = (size_t)r * ld + c;
    out[o] = rnd_if(
        res[o] + drop.one_at(r, c, lin(acc, bias[c], drop.rnd)), drop.rnd);
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
    const float4 v =
        lin4(acc, *reinterpret_cast<const float4*>(bias + c), drop.rnd);
    *reinterpret_cast<float4*>(out + (size_t)r * ld + c) = drop.apply(
        r, c,
        make_float4(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f), fmaxf(v.z, 0.0f),
                    fmaxf(v.w, 0.0f)));
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    out[(size_t)r * ld + c] =
        drop.one_at(r, c, fmaxf(lin(acc, bias[c], drop.rnd), 0.0f));
  }
};

// the FFN's relu and dropout backward from the forward's hd = drop(relu(h)):
// hd > 0 exactly where h > 0 and the mask keeps, so
// out = hd > 0 ? acc / (1 - rate) : 0 (acc itself at rate 0), rounded on
// the bf16 cast points (the TPU kernel's dlinc)
struct EpiDrelu {
  const float* hd;
  float* out;
  int ld;
  Drop drop;
  __device__ __forceinline__ float one(float h, float v) const {
    return h > 0.0f ? rnd_if(drop.on ? v / drop.keep_div : v, drop.rnd)
                    : 0.0f;
  }
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const size_t o = (size_t)r * ld + c;
    const float4 h4 = *reinterpret_cast<const float4*>(hd + o);
    *reinterpret_cast<float4*>(out + o) =
        make_float4(one(h4.x, acc.x), one(h4.y, acc.y), one(h4.z, acc.z),
                    one(h4.w, acc.w));
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    const size_t o = (size_t)r * ld + c;
    out[o] = one(hd[o], acc);
  }
};

// out = acc (rnd: rounded to bf16, a cast point of the bf16 route)
struct EpiStore {
  float* out;
  int ld;
  bool rnd = false;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    *reinterpret_cast<float4*>(out + (size_t)r * ld + c) = rnd4_if(acc, rnd);
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    out[(size_t)r * ld + c] = rnd_if(acc, rnd);
  }
};

// out = drop(g) over [M, cols] (rounded with drop.rnd)
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

// The bf16 entries' staging: job j converts n[j] elements from src[j] to
// dst[j], bf16 -> f32 (exact; `to_bf` 0) or f32 -> bf16 (rounded to
// nearest even; `to_bf` 1), a grid-stride loop over each job in turn
constexpr int MAX_CONV = 40;
struct Convs {
  const void* src[MAX_CONV];
  void* dst[MAX_CONV];
  size_t n[MAX_CONV];
  int to_bf, count;
};

__global__ void __launch_bounds__(ELT_THREADS) convert_kernel(Convs c) {
  for (int j = 0; j < c.count; ++j)
    for (size_t e = (size_t)blockIdx.x * ELT_THREADS + threadIdx.x;
         e < c.n[j]; e += (size_t)gridDim.x * ELT_THREADS)
      uic_bf16::stf(c.dst[j], e, uic_bf16::ldf(c.src[j], e, !c.to_bf),
                    c.to_bf);
}

// The weights' transposes at the start of a backward: job j writes
// dst[c * rows + r] = src[r * cols + c] for its [rows, cols] weight, one
// 32 x 32 tile a block, blocks of all jobs in one grid
struct Transposes {
  const float* src[MAX_WEIGHTS];
  float* dst[MAX_WEIGHTS];
  int rows[MAX_WEIGHTS], cols[MAX_WEIGHTS];
  int first[MAX_WEIGHTS + 1];   // the jobs' first blocks; first[n] in all
  int n;
};

__global__ void __launch_bounds__(256)
    weight_transpose_kernel(Transposes t) {
  __shared__ float tile[32][33];
  int j = 0;
  while (j + 1 < t.n && (int)blockIdx.x >= t.first[j + 1]) ++j;
  const int blk = blockIdx.x - t.first[j];
  const int R = t.rows[j], C = t.cols[j], col_tiles = (C + 31) / 32;
  const int r0 = (blk / col_tiles) * 32, c0 = (blk % col_tiles) * 32;
  const int x = threadIdx.x % 32, y = threadIdx.x / 32;
  for (int i = y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + x;
    if (r < R && c < C) tile[i][x] = t.src[j][(size_t)r * C + c];
  }
  __syncthreads();
  for (int i = y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + x;
    if (c < C && r < R) t.dst[j][(size_t)c * R + r] = tile[x][i];
  }
}

int blocks_for(size_t n) {
  const size_t b = (n + ELT_THREADS - 1) / ELT_THREADS;
  return (int)(b < 65535 * 16 ? b : 65535 * 16);
}

// C [M, N] = A [M, K] B [K, N], both row-major and packed (the input
// gradients read a weight's transpose as B)
TrainGemm nn(const float* a, const float* b, int M, int N, int K) {
  return TrainGemm{a, b, nullptr, K, N, M, N, K, 0, 0};
}

// The scratch of a backward call: gradients of the layer's activations,
// the attention backward's scratch (the rows' g . o and ds), the weights'
// transposes and the LN backward's partial sums. carve() lays it out from
// `base` (null: only to size it).
struct Work {
  float *df, *dlin, *dy, *dx2, *dx3, *dout, *dattn, *dqkv, *attn,
      *ln_partial;
  float *wqkv_t, *wo_t, *w1_t, *w2_t, *wq_t, *wo2_t;   // W^T [N, K]
  size_t floats;
};

Work carve(float* base, int kind, int B, int T, int S, int d, int f,
           int H) {
  const size_t M = (size_t)B * T;
  size_t at = 0;
  auto take = [&](size_t n) {
    float* p = base ? base + at : nullptr;
    at += (n + 3) / 4 * 4;   // 16-byte aligned regions
    return p;
  };
  Work w;
  w.df = take(M * d);
  w.dlin = take(M * f);
  w.dy = take(M * d);
  w.dx2 = take(M * d);
  w.dx3 = kind == 1 ? take(M * d) : nullptr;
  w.dout = take(M * d);
  w.dattn = take(M * d);
  w.dqkv = take(M * 3 * d);
  w.attn = take(uic::attn_bwd_scratch_floats(B, H, T, S > T ? S : T));
  w.ln_partial = take((size_t)uic::ln_bwd_ws_floats(d));
  w.wqkv_t = take((size_t)3 * d * d);
  w.wo_t = take((size_t)d * d);
  w.w1_t = take((size_t)f * d);
  w.w2_t = take((size_t)d * f);
  w.wq_t = kind == 1 ? take((size_t)d * d) : nullptr;
  w.wo2_t = kind == 1 ? take((size_t)d * d) : nullptr;
  w.floats = at;
  return w;
}

// dst [cols, rows] = src [rows, cols]^T for each (src, dst, rows, cols)
// job, in one launch
int transpose_weights(const float* const* src, float* const* dst,
                      const int* rows, const int* cols, int n,
                      cudaStream_t st) {
  Transposes t{};
  t.n = n;
  int blocks = 0;
  for (int j = 0; j < n; ++j) {
    t.src[j] = src[j];
    t.dst[j] = dst[j];
    t.rows[j] = rows[j];
    t.cols[j] = cols[j];
    t.first[j] = blocks;
    blocks += ((rows[j] + 31) / 32) * ((cols[j] + 31) / 32);
  }
  t.first[n] = blocks;
  weight_transpose_kernel<<<blocks, 256, 0, st>>>(t);
  return (int)cudaGetLastError();
}

// dw [K, N] = A^T dY and db [N] = column sums of dY, both over M rows, in
// one launch; A [M, K] with row stride lda, dY [M, N] with ldy
int wgrad(const float* a, int lda, int K, const float* dy, int ldy, int N,
          int M, float* dw, float* db, cudaStream_t st) {
  return train_gemm<true, true>(
      TrainGemm{a, dy, db, lda, ldy, K, N, M, 0, 0}, EpiStore{dw, N}, st);
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
              m.dropout, m.rnd ? uic::ATT_RND : 0};
}

// the LayerNorm's flags: y / dx rounded on the bf16 cast points
int ln_fl(const Dims& m) { return m.rnd ? uic::LN_RND : 0; }

// The self-attention sublayer: x2 = x + drop(attn(LN1(x) Wqkv + bqkv) Wo +
// bo, site 1); keeps y1, qkv, ao and the attention's row statistics
int self_fwd(const float* x, const float* mask, int mask_rows,
             const int* seed, const float* wqkv, const float* bqkv,
             const float* wo, const float* bo, const float* ls,
             const float* lb, float* y1, float* qkv, float* ao, float* stats,
             float* x2, const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d;
  int err = uic::ln_fwd(x, ls, lb, y1, M, d, EPS, st, ln_fl(m));
  if (err) return err;
  if ((err = train_gemm<false, false>(nn(y1, wqkv, M, 3 * d, d),
                                      EpiLin{bqkv, qkv, 3 * d, m.rnd}, st)))
    return err;
  if ((err = uic::attn_fwd(attn_args(qkv, 3 * d, qkv + d, 3 * d, qkv + 2 * d,
                                     3 * d, mask, mask_rows, seed, m.T, m),
                           ao, stats, st)))
    return err;
  return train_gemm<false, false>(
      nn(ao, wo, M, d, d),
      EpiResDrop{bo, x, x2, d, drop_at(seed, m, 1, d, true)}, st);
}

// The cross-attention sublayer: x3 = x2 + drop(attn(LN2(x2) Wq + bq, mk, mv)
// Wo2 + bo2, site 1) under seed2; keeps y2, qc, co and the attention's row
// statistics
int cross_fwd(const float* x2, const float* mk, const float* mv,
              const float* sm, const int* seed2, const float* wq,
              const float* bq, const float* wo2, const float* bo2,
              const float* ls, const float* lb, float* y2, float* qc,
              float* co, float* stats, float* x3, const Dims& m,
              cudaStream_t st) {
  const int M = m.B * m.T, d = m.d;
  int err = uic::ln_fwd(x2, ls, lb, y2, M, d, EPS, st, ln_fl(m));
  if (err) return err;
  if ((err = train_gemm<false, false>(nn(y2, wq, M, d, d),
                                      EpiLin{bq, qc, d, m.rnd}, st)))
    return err;
  if ((err = uic::attn_fwd(attn_args(qc, d, mk, d, mv, d, sm, 1, seed2, m.S,
                                     m),
                           co, stats, st)))
    return err;
  return train_gemm<false, false>(
      nn(co, wo2, M, d, d),
      EpiResDrop{bo2, x2, x3, d, drop_at(seed2, m, 1, d, true)}, st);
}

// The FFN sublayer: out = xa + drop(drop(relu(LN(xa) W1 + b1), site 2) W2 +
// b2, site 3); keeps y and hd
int ffn_fwd(const float* xa, const int* seed, const float* w1,
            const float* b1, const float* w2, const float* b2,
            const float* ls, const float* lb, float* y, float* hd,
            float* out, const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d, f = m.f;
  int err = uic::ln_fwd(xa, ls, lb, y, M, d, EPS, st, ln_fl(m));
  if (err) return err;
  if ((err = train_gemm<false, false>(
           nn(y, w1, M, f, d),
           EpiReluDrop{b1, hd, f, drop_at(seed, m, 2, f, true)}, st)))
    return err;
  return train_gemm<false, false>(
      nn(hd, w2, M, d, f),
      EpiResDrop{b2, xa, out, d, drop_at(seed, m, 3, d, true)}, st);
}

// The FFN half of the backward (the Pallas `_bwd_ffn_kernel`): from
// g = d(out) to dxa = g + d(LN) and the FFN / LN weight gradients
int ffn_bwd(const float* xa, const float* y, const float* hd, const float* g,
            const int* seed, const float* ls, float* dxa, float* dw1,
            float* db1, float* dw2, float* db2, float* dls, float* dlb,
            const Work& w, const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d, f = m.f;
  int err = 0;
  const float* df = dropped(g, w.df, drop_at(seed, m, 3, d), M, st, &err);
  if (err) return err;
  if ((err = wgrad(hd, f, f, df, d, d, M, dw2, db2, st))) return err;
  if ((err = train_gemm<false, false>(
           nn(df, w.w2_t, M, f, d),
           EpiDrelu{hd, w.dlin, f, drop_at(seed, m, 2, f)}, st)))
    return err;
  if ((err = wgrad(y, d, d, w.dlin, f, f, M, dw1, db1, st))) return err;
  if ((err = train_gemm<false, false>(nn(w.dlin, w.w1_t, M, d, f),
                                      EpiStore{w.dy, d}, st)))
    return err;
  return uic::ln_bwd(xa, ls, w.dy, g, dxa, dls, dlb, w.ln_partial, M, d,
                     EPS, st, ln_fl(m));
}

// The self-attention half (the Pallas `_bwd_attn_kernel`): from g2 = d(x2)
// to dx = g2 + d(LN1) and the QKV / O / LN1 weight gradients
int self_bwd(const float* x, const float* mask, int mask_rows,
             const int* seed, const float* y1, const float* qkv,
             const float* ao, const float* stats, const float* g2,
             const float* ls, float* dx, float* dwqkv,
             float* dbqkv, float* dwo, float* dbo, float* dls, float* dlb,
             const Work& w, const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d;
  int err = 0;
  const float* dout = dropped(g2, w.dout, drop_at(seed, m, 1, d), M, st,
                              &err);
  if (err) return err;
  if ((err = wgrad(ao, d, d, dout, d, d, M, dwo, dbo, st))) return err;
  if ((err = train_gemm<false, false>(nn(dout, w.wo_t, M, d, d),
                                      EpiStore{w.dattn, d, m.rnd}, st)))
    return err;
  if ((err = uic::attn_bwd(
           attn_args(qkv, 3 * d, qkv + d, 3 * d, qkv + 2 * d, 3 * d, mask,
                     mask_rows, seed, m.T, m),
           w.dattn, ao, stats, w.dqkv, w.dqkv + d, w.dqkv + 2 * d, w.attn,
           st)))
    return err;
  if ((err = wgrad(y1, d, d, w.dqkv, 3 * d, 3 * d, M, dwqkv, dbqkv, st)))
    return err;
  if ((err = train_gemm<false, false>(nn(w.dqkv, w.wqkv_t, M, d, 3 * d),
                                      EpiStore{w.dy, d}, st)))
    return err;
  return uic::ln_bwd(x, ls, w.dy, g2, dx, dls, dlb, w.ln_partial, M, d,
                     EPS, st, ln_fl(m));
}

// The cross-attention half (the Pallas `_bwd_cross_kernel`): from
// g3 = d(x3) to dx2 = g3 + d(LN2), dmk, dmv and the Wq / Wo2 / LN2 weight
// gradients
int cross_bwd(const float* x2, const float* mk, const float* mv,
              const float* sm, const int* seed2, const float* y2,
              const float* qc, const float* co, const float* stats,
              const float* g3, const float* ls, float* dx2,
              float* dmk, float* dmv, float* dwq, float* dbq, float* dwo2,
              float* dbo2, float* dls, float* dlb, const Work& w,
              const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d;
  int err = 0;
  const float* dout = dropped(g3, w.dout, drop_at(seed2, m, 1, d), M, st,
                              &err);
  if (err) return err;
  if ((err = wgrad(co, d, d, dout, d, d, M, dwo2, dbo2, st))) return err;
  if ((err = train_gemm<false, false>(nn(dout, w.wo2_t, M, d, d),
                                      EpiStore{w.dattn, d, m.rnd}, st)))
    return err;
  float* dqc = w.dqkv;   // [M, d]
  if ((err = uic::attn_bwd(attn_args(qc, d, mk, d, mv, d, sm, 1, seed2, m.S,
                                     m),
                           w.dattn, co, stats, dqc, dmk, dmv, w.attn, st)))
    return err;
  if ((err = wgrad(y2, d, d, dqc, d, d, M, dwq, dbq, st))) return err;
  if ((err = train_gemm<false, false>(nn(dqc, w.wq_t, M, d, d),
                                      EpiStore{w.dy, d}, st)))
    return err;
  return uic::ln_bwd(x2, ls, w.dy, g3, dx2, dls, dlb, w.ln_partial, M, d,
                     EPS, st, ln_fl(m));
}

Dims dims(int B, int T, int S, int d, int f, int H, unsigned int thresh,
          float keep_div, int dropout, int bf) {
  return Dims{B, T, S, d, f, H, thresh, keep_div, dropout, bf != 0};
}

// The bf16 entries. Every tensor of a call is either f32 or (bf) bf16:
// x, mk, mv, the weights, g, and every output but the saved activations,
// which stay the f32 scratch the forward writes. A bf16 call converts its
// bf16 inputs once into f32 staging (exact: the values are the same), runs
// the f32 sequence above with the bf16 cast points (Dims::rnd), and
// converts its outputs to bf16 in one pass at the end (rounded to nearest
// even). n_of(...) gives each pointer's element count in a call, or 0 for
// the pointers that are never bf16 (masks, seeds, saved activations).
enum Call { ENC_FWD = 0, ENC_BWD = 1, DEC_FWD = 2, DEC_BWD = 3 };

// elements of the layer's i-th weight (ENC_WEIGHTS / DEC_WEIGHTS order)
size_t weight_n(int kind, int i, int d, int f) {
  static const char enc[] = "QqOoFfGgllll", dec[] = "QqOoOoOoFfGgllllll";
  const char c = (kind == 0 ? enc : dec)[i];
  const size_t dd = (size_t)d * d;
  switch (c) {
    case 'Q': return 3 * dd;
    case 'q': return 3 * (size_t)d;
    case 'O': return dd;
    case 'F':
    case 'G': return (size_t)d * f;
    case 'f': return (size_t)f;
    default: return (size_t)d;   // o, g, l: [d]
  }
}

// (element count, whether an output) of pointer i of a call; 0: not staged
struct Slot {
  size_t n;
  bool out;
};

Slot slot_of(Call c, int i, int B, int T, int S, int d, int f) {
  const size_t Md = (size_t)B * T * d, Sd = (size_t)B * S * d;
  switch (c) {
    case ENC_FWD:
      if (i == 0) return {Md, false};
      if (i >= 3 && i <= 14) return {weight_n(0, i - 3, d, f), false};
      if (i == 15) return {Md, true};
      return {0, false};
    case ENC_BWD:
      if (i == 0 || i == 22) return {Md, false};
      if (i >= 3 && i <= 14) return {weight_n(0, i - 3, d, f), false};
      if (i == 23) return {Md, true};
      if (i >= 24 && i <= 35) return {weight_n(0, i - 24, d, f), true};
      return {0, false};
    case DEC_FWD:
      if (i == 0) return {Md, false};
      if (i == 1 || i == 2) return {Sd, false};
      if (i >= 6 && i <= 23) return {weight_n(1, i - 6, d, f), false};
      if (i == 24) return {Md, true};
      return {0, false};
    default:   // DEC_BWD
      if (i == 0 || i == 36) return {Md, false};
      if (i == 1 || i == 2) return {Sd, false};
      if (i >= 6 && i <= 23) return {weight_n(1, i - 6, d, f), false};
      if (i == 37) return {Md, true};
      if (i == 38 || i == 39) return {Sd, true};
      if (i >= 40 && i <= 57) return {weight_n(1, i - 40, d, f), true};
      return {0, false};
  }
}

constexpr int CALL_PTRS[] = {23, 36, 37, 58};

// floats of a bf16 call's staging, 16-byte aligned regions
size_t stage_floats(Call c, int B, int T, int S, int d, int f) {
  size_t at = 0;
  for (int i = 0; i < CALL_PTRS[c]; ++i)
    at += (slot_of(c, i, B, T, S, d, f).n + 3) / 4 * 4;
  return at;
}

int run_converts(Convs& cv, cudaStream_t st) {
  if (!cv.count) return 0;
  size_t most = 0;
  for (int j = 0; j < cv.count; ++j) most = cv.n[j] > most ? cv.n[j] : most;
  convert_kernel<<<blocks_for(most), ELT_THREADS, 0, st>>>(cv);
  return (int)cudaGetLastError();
}

// body(q): the f32 sequence over the pointers q; with bf, q points the
// staged pointers at f32 staging, widens the inputs first and narrows the
// outputs after
template <typename Body>
int staged(Call c, const void* const* p, int bf, float* stage, int B, int T,
           int S, int d, int f, cudaStream_t st, Body body) {
  const void* q[64];
  const int n = CALL_PTRS[c];
  for (int i = 0; i < n; ++i) q[i] = p[i];
  if (!bf) return body(q);
  Convs in{}, out{};
  in.to_bf = 0;
  out.to_bf = 1;
  size_t at = 0;
  for (int i = 0; i < n; ++i) {
    const Slot sl = slot_of(c, i, B, T, S, d, f);
    if (!sl.n) continue;
    q[i] = stage + at;
    at += (sl.n + 3) / 4 * 4;
    Convs& cv = sl.out ? out : in;
    cv.src[cv.count] = sl.out ? q[i] : p[i];
    cv.dst[cv.count] = const_cast<void*>(sl.out ? p[i] : q[i]);
    cv.n[cv.count++] = sl.n;
  }
  int err = run_converts(in, st);
  if (err) return err;
  if ((err = body(q))) return err;
  return run_converts(out, st);
}

#define F(i) (static_cast<const float*>(p[i]))
#define O(i) (static_cast<float*>(const_cast<void*>(p[i])))
#define I(i) (static_cast<const int*>(p[i]))

}  // namespace

extern "C" {

// Floats of scratch a backward call takes into *n: kind 0 the encoder
// layer, 1 the decoder layer. Returns 0.
int layer_train_ws_f32(int kind, int B, int T, int S, int d, int f, int H,
                      long long* n) {
  *n = (long long)carve(nullptr, kind, B, T, S, d, f, H).floats;
  return 0;
}

// Floats of a bf16 call's staging into *n: call 0 / 1 the encoder layer's
// forward / backward, 2 / 3 the decoder layer's. Returns 0.
int layer_train_stage_floats(int call, int B, int T, int S, int d, int f,
                             long long* n) {
  *n = (long long)stage_floats((Call)call, B, T, S, d, f);
  return 0;
}

// The plan of train_gemm.cuh for an M x N x K product into out[4], on the
// forward's kernel instance (EpiLin): the row tiles run in whole rounds,
// the row tiles in all, the cluster size of the rest and the clusters of
// that size the card holds at once. Returns 0, or a CUDA error.
int layer_train_gemm_plan(int M, int N, int K, int* out) {
  const int* clusters = uic_train::tg_clusters<false, false, EpiLin>();
  if (!clusters[0]) return (int)cudaErrorInvalidConfiguration;
  const uic_train::TgPlan plan = uic_train::tg_plan(M, N, K, clusters);
  out[0] = plan.full_rows;
  out[1] = plan.rows;
  out[2] = plan.cs;
  out[3] = clusters[plan.cs];
  return 0;
}

// p: x, mask [B, mask_rows, T], seed [1], wqkv, bqkv, wo, bo, w1, b1, w2,
// b2, l1s, l1b, l2s, l2b; out; saved x2, y1, qkv [B*T, 3d], ao, the
// attention's row statistics [2, B, H, T], y2, hd [B*T, f]. Activations
// [B*T, d] unless stated. bf: x, the weights and out bf16 (the saved
// activations f32), with `stage` of layer_train_stage_floats(0, ...)
// floats; else every tensor f32 and stage unused.
int enc_layer_fwd_mixed(const void* const* p, int B, int T, int d, int f,
                        int H, int mask_rows, unsigned int thresh,
                        float keep_div, int dropout, int bf, float* stage,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims m = dims(B, T, T, d, f, H, thresh, keep_div, dropout, bf);
  return staged(ENC_FWD, p, bf, stage, B, T, T, d, f, st,
                [&](const void* const* p) {
    int err = self_fwd(F(0), F(1), mask_rows, I(2), F(3), F(4), F(5), F(6),
                       F(11), F(12), O(17), O(18), O(19), O(20), O(16), m,
                       st);
    if (err) return err;
    return ffn_fwd(O(16), I(2), F(7), F(8), F(9), F(10), F(13), F(14),
                   O(21), O(22), O(15), m, st);
  });
}

// p: x, mask, seed, the 12 weights as above (3-14), saved x2, y1, qkv, ao,
// stats, y2, hd (15-21), g (22); dx (23) and the 12 weight gradients
// (24-35) in the weights' order, each in its weight's type. ws:
// layer_train_ws_f32(0, ...) floats; bf and stage as the forward's
// (layer_train_stage_floats(1, ...)).
int enc_layer_bwd_mixed(const void* const* p, int B, int T, int d, int f,
                        int H, int mask_rows, unsigned int thresh,
                        float keep_div, int dropout, int bf, float* ws,
                        float* stage, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims m = dims(B, T, T, d, f, H, thresh, keep_div, dropout, bf);
  const Work w = carve(ws, 0, B, T, T, d, f, H);
  return staged(ENC_BWD, p, bf, stage, B, T, T, d, f, st,
                [&](const void* const* p) {
    // wqkv, wo, w1, w2
    const float* src[] = {F(3), F(5), F(7), F(9)};
    float* const dst[] = {w.wqkv_t, w.wo_t, w.w1_t, w.w2_t};
    const int rows[] = {d, d, d, f}, cols[] = {3 * d, d, f, d};
    int err = transpose_weights(src, dst, rows, cols, 4, st);
    if (err) return err;
    if ((err = ffn_bwd(F(15), F(20), F(21), F(22), I(2), F(13), w.dx2,
                       O(28), O(29), O(30), O(31), O(34), O(35), w, m, st)))
      return err;
    return self_bwd(F(0), F(1), mask_rows, I(2), F(16), F(17), F(18), F(19),
                    w.dx2, F(11), O(23), O(24), O(25), O(26), O(27), O(32),
                    O(33), w, m, st);
  });
}

// p: x, mk [B, S, d], mv, tgt mask [B, tmask_rows, T], src mask [B, 1, S],
// seeds [2] (0-5); wqkv, bqkv, wo, bo, wq, bq, wo2, bo2, w1, b1, w2, b2,
// l1s, l1b, l2s, l2b, l3s, l3b (6-23); out (24); saved x2, x3, y1, qkv, ao,
// y2, qc, co, y3, the self and cross attentions' row statistics
// [2, B, H, T] each, hd (25-36). bf: x, mk, mv, the weights and out bf16,
// with `stage` of layer_train_stage_floats(2, ...) floats.
int dec_layer_fwd_mixed(const void* const* p, int B, int T, int S, int d,
                        int f, int H, int tmask_rows, unsigned int thresh,
                        float keep_div, int dropout, int bf, float* stage,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims m = dims(B, T, S, d, f, H, thresh, keep_div, dropout, bf);
  return staged(DEC_FWD, p, bf, stage, B, T, S, d, f, st,
                [&](const void* const* p) {
    const int* seed = I(5);
    int err = self_fwd(F(0), F(3), tmask_rows, seed, F(6), F(7), F(8), F(9),
                       F(18), F(19), O(27), O(28), O(29), O(34), O(25), m,
                       st);
    if (err) return err;
    if ((err = cross_fwd(O(25), F(1), F(2), F(4), seed + 1, F(10), F(11),
                         F(12), F(13), F(20), F(21), O(30), O(31), O(32),
                         O(35), O(26), m, st)))
      return err;
    return ffn_fwd(O(26), seed, F(14), F(15), F(16), F(17), F(22), F(23),
                   O(33), O(36), O(24), m, st);
  });
}

// p: the 24 forward inputs (0-23), saved as above (24-35), g (36); dx (37),
// dmk (38), dmv (39) and the 18 weight gradients (40-57) in the weights'
// order. ws: layer_train_ws_f32(1, ...) floats; bf and stage as the
// forward's (layer_train_stage_floats(3, ...)).
int dec_layer_bwd_mixed(const void* const* p, int B, int T, int S, int d,
                        int f, int H, int tmask_rows, unsigned int thresh,
                        float keep_div, int dropout, int bf, float* ws,
                        float* stage, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims m = dims(B, T, S, d, f, H, thresh, keep_div, dropout, bf);
  const Work w = carve(ws, 1, B, T, S, d, f, H);
  return staged(DEC_BWD, p, bf, stage, B, T, S, d, f, st,
                [&](const void* const* p) {
    const int* seed = I(5);
    // wqkv, wo, wq, wo2, w1, w2
    const float* src[] = {F(6), F(8), F(10), F(12), F(14), F(16)};
    float* const dst[] = {w.wqkv_t, w.wo_t, w.wq_t, w.wo2_t, w.w1_t, w.w2_t};
    const int rows[] = {d, d, d, d, d, f}, cols[] = {3 * d, d, d, d, f, d};
    int err = transpose_weights(src, dst, rows, cols, 6, st);
    if (err) return err;
    if ((err = ffn_bwd(F(25), F(32), F(35), F(36), seed, F(22), w.dx3,
                       O(48), O(49), O(50), O(51), O(56), O(57), w, m, st)))
      return err;
    if ((err = cross_bwd(F(24), F(1), F(2), F(4), seed + 1, F(29), F(30),
                         F(31), F(34), w.dx3, F(20), w.dx2, O(38), O(39),
                         O(44), O(45), O(46), O(47), O(54), O(55), w, m,
                         st)))
      return err;
    return self_bwd(F(0), F(3), tmask_rows, seed, F(26), F(27), F(28), F(33),
                    w.dx2, F(18), O(37), O(40), O(41), O(42), O(43), O(52),
                    O(53), w, m, st);
  });
}

}  // extern "C"
