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
//   - products: train_gemm.cuh's GEMM core (no library call; 128 x 128
//     tiles, a cp.async ring; the f32 route on f32 FMA register tiles, the
//     bf16 route on the tensor cores) with the dropout, relu and residual
//     work in its epilogues. The input gradients dY W^T read W^T on the f32
//     route, which one launch at the start of a backward writes for all the
//     layer's weights, and W itself on the bf16 route (the tensor-core
//     instance's transposed B tile). A weight gradient X^T dY over the
//     M rows is one launch: K split across a thread-block cluster, the
//     partial tiles summed in rank order through distributed shared memory,
//     the bias gradient summed from the dY tiles in the same launch. No
//     float atomics, the same bits every run;
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
// of products and 3.9 of attention against about 0.3 GB of traffic in f32
// (0.09 ms); the backward 61.6 GFLOP of products and about 10 of
// attention. On the f32 route that is 0.52 and 1.07 ms at 67 TFLOP/s f32,
// and the products take most of the time at the f32 FMA rate
// train_gemm.cuh reaches (PERF.md). On the bf16 route the products run at
// the bf16 tensor-core rate (989 TFLOP/s: 0.031 and 0.062 ms), and the
// attention (mha_train.cu's bf16 route, two passes over the keys), the
// LayerNorm and the dropout passes (bytes) take the larger share.
//
// Types (the compute dtype). A call is all f32 or, on the bf16 route, all
// bf16 (x, mk, mv, the weights, g and the outputs, each weight's gradient
// in its weight's type), as the TPU kernel runs with a bf16 x under a
// bf16 copy of the parameters. The sequence is one template over the
// storage type: a bf16 call keeps every value the TPU kernel holds in bf16
// in bf16 (the saved activations but the softmax statistics, the
// backward's cotangents, the weights' transposes), so its products run
// train_gemm.cuh's bf16 tensor-core instance on bf16 operands with no
// staging, the LayerNorm (ln_train.cu) and the attention (mha_train.cu)
// read and write those arrays through their bf16 flags, the epilogues load
// and store bf16, and the backward's dropout of g takes four columns a
// thread. The cast points (ops/layer_train.py: 60-95,
// :131-253, :444-520 of the JAX package): LayerNorm in f32 to a bf16 y;
// each `_linear` rounds its f32 product to bf16 and adds the bias in bf16;
// a forward dropout divides in bf16 by 1 - rate in bf16; the residual sums
// round; the attention as mha_train.cu's bf16 route; in the backward each
// product's cotangent is rounded where the TPU kernel casts it (dfc,
// dlinc, doc, dao, dq / dk / dv), the LayerNorm input gradients dy stay
// f32 and dx rounds; the weight gradients are summed in f32 and rounded
// once. One difference: a bias gradient here sums the rounded cotangent
// that its weight gradient reads, where the TPU kernel sums it unrounded (a
// 2^-9 relative rounding a row, within the bf16 tolerance).

#include <cuda_bf16.h>
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
using uic_train::TrainGemmBf;
using bf16 = __nv_bfloat16;

constexpr int N_SITES = 4;        // dropout sites per (layer, element)
constexpr float EPS = 1e-6f;      // LayerNorm eps, outside the sqrt
constexpr int MAX_WEIGHTS = 6;    // weights a backward transposes
constexpr int ELT_THREADS = 256;

// The storage type of a call's values: float (the f32 route) or bf16.
template <class T>
constexpr bool BF = sizeof(T) == 2;

template <class T>
__device__ __forceinline__ float4 ld4v(const T* p, size_t i) {
  return uic_bf16::ld4t<BF<T>>(p, i);
}
template <class T>
__device__ __forceinline__ float ld1v(const T* p, size_t i) {
  return uic_bf16::ldt<BF<T>>(p, i);
}
template <class T>
__device__ __forceinline__ void st4v(T* p, size_t i, float4 v) {
  uic_bf16::st4(p, i, v, BF<T>);
}
template <class T>
__device__ __forceinline__ void st1v(T* p, size_t i, float v) {
  uic_bf16::stf(p, i, v, BF<T>);
}

struct Dims {
  int B, T, S, d, f, H;
  unsigned int thresh;
  float keep_div;
  int dropout;
  bool rnd;   // the bf16 cast points (a bf16 call)
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
template <class T>
struct EpiLin {
  const T* bias;
  T* out;
  int ld;
  bool rnd;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    st4v(out, (size_t)r * ld + c, lin4(acc, ld4v(bias, c), rnd));
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    st1v(out, (size_t)r * ld + c, lin(acc, ld1v(bias, c), rnd));
  }
};

// out = res + drop(acc + bias)
template <class T>
struct EpiResDrop {
  const T* bias;
  const T* res;
  T* out;
  int ld;
  Drop drop;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const float4 v = drop.apply(r, c, lin4(acc, ld4v(bias, c), drop.rnd));
    const size_t o = (size_t)r * ld + c;
    const float4 x4 = ld4v(res, o);
    st4v(out, o,
         rnd4_if(make_float4(x4.x + v.x, x4.y + v.y, x4.z + v.z, x4.w + v.w),
                 drop.rnd));
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    const size_t o = (size_t)r * ld + c;
    st1v(out, o,
         rnd_if(ld1v(res, o) +
                    drop.one_at(r, c, lin(acc, ld1v(bias, c), drop.rnd)),
                drop.rnd));
  }
};

// out = drop(relu(acc + bias))
template <class T>
struct EpiReluDrop {
  const T* bias;
  T* out;
  int ld;
  Drop drop;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const float4 v = lin4(acc, ld4v(bias, c), drop.rnd);
    st4v(out, (size_t)r * ld + c,
         drop.apply(r, c,
                    make_float4(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f),
                                fmaxf(v.z, 0.0f), fmaxf(v.w, 0.0f))));
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    st1v(out, (size_t)r * ld + c,
         drop.one_at(r, c, fmaxf(lin(acc, ld1v(bias, c), drop.rnd), 0.0f)));
  }
};

// the FFN's relu and dropout backward from the forward's hd = drop(relu(h)):
// hd > 0 exactly where h > 0 and the mask keeps, so
// out = hd > 0 ? acc / (1 - rate) : 0 (acc itself at rate 0), rounded on
// the bf16 cast points (the TPU kernel's dlinc)
template <class T>
struct EpiDrelu {
  const T* hd;
  T* out;
  int ld;
  Drop drop;
  __device__ __forceinline__ float one(float h, float v) const {
    return h > 0.0f ? rnd_if(drop.on ? v / drop.keep_div : v, drop.rnd)
                    : 0.0f;
  }
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const size_t o = (size_t)r * ld + c;
    const float4 h4 = ld4v(hd, o);
    st4v(out, o,
         make_float4(one(h4.x, acc.x), one(h4.y, acc.y), one(h4.z, acc.z),
                     one(h4.w, acc.w)));
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    const size_t o = (size_t)r * ld + c;
    st1v(out, o, one(ld1v(hd, o), acc));
  }
};

// out = acc (rnd: rounded to bf16, a cast point of the bf16 route; a bf16
// out rounds as it stores)
template <class T>
struct EpiStore {
  T* out;
  int ld;
  bool rnd = false;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    st4v(out, (size_t)r * ld + c, rnd4_if(acc, rnd));
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    st1v(out, (size_t)r * ld + c, rnd_if(acc, rnd));
  }
};

// out = drop(g) over [M, cols] (rounded with drop.rnd)
template <class T>
__global__ void __launch_bounds__(ELT_THREADS)
    drop_kernel(const T* __restrict__ g, T* __restrict__ out, int M,
                Drop drop) {
  const size_t n = (size_t)M * drop.cols;
  for (size_t e = (size_t)blockIdx.x * ELT_THREADS + threadIdx.x; e < n;
       e += (size_t)gridDim.x * ELT_THREADS) {
    const int r = (int)(e / drop.cols), c = (int)(e % drop.cols);
    int t;
    const uint32_t base = drop.base_of(r, &t);
    st1v(out, e, drop.one(base, t, c, ld1v(g, e)));
  }
}

// the same over bf16 arrays four columns a thread (cols a multiple of 4):
// one row, hash base and 8-byte load and store for four elements
__global__ void __launch_bounds__(ELT_THREADS)
    drop4_bf16_kernel(const bf16* __restrict__ g, bf16* __restrict__ out,
                      int M, Drop drop) {
  const size_t n = (size_t)M * drop.cols / 4;
  for (size_t e = (size_t)blockIdx.x * ELT_THREADS + threadIdx.x; e < n;
       e += (size_t)gridDim.x * ELT_THREADS) {
    const size_t i = 4 * e;
    const int r = (int)(i / drop.cols), c = (int)(i % drop.cols);
    st4v(out, i, drop.apply(r, c, ld4v(g, i)));
  }
}

// The weights' transposes at the start of an f32 backward: job j writes
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

// C = epi(A . B) on the core of the operands' type: the f32 FMA core, or
// the bf16 tensor-core instance (BT: B given as B^T [N, K])
template <bool AK, bool BT, bool COLSUM, class Epi>
int gemm(const float* a, int lda, const float* b, int ldb, float* colsum,
         int M, int N, int K, const Epi& epi, cudaStream_t st) {
  static_assert(!BT, "the f32 core reads B row-major");
  return uic_train::train_gemm<AK, COLSUM>(
      TrainGemm{a, b, colsum, lda, ldb, M, N, K, 0, 0}, epi, st);
}

template <bool AK, bool BT, bool COLSUM, class Epi>
int gemm(const bf16* a, int lda, const bf16* b, int ldb, bf16* colsum,
         int M, int N, int K, const Epi& epi, cudaStream_t st) {
  return uic_train::train_gemm_bf16<AK, BT, COLSUM>(
      TrainGemmBf{a, b, colsum, lda, ldb, M, N, K, 0, 0}, epi, st);
}

// C [M, N] = epi(A [M, K] B [K, N]), both row-major and packed
template <class T, class Epi>
int nn(const T* a, const T* b, int M, int N, int K, const Epi& epi,
       cudaStream_t st) {
  return gemm<false, false, false>(a, K, b, N, static_cast<T*>(nullptr), M,
                                   N, K, epi, st);
}

// An input gradient C [M, N] = epi(A [M, K] W^T) of a weight W [N, K]: the
// f32 core reads W^T (w_t, which the backward's first launch wrote), the
// bf16 instance W itself
template <class T, class Epi>
int xwt(const T* a, const T* w, const T* w_t, int M, int N, int K,
        const Epi& epi, cudaStream_t st) {
  if constexpr (BF<T>)
    return gemm<false, true, false>(a, K, w, K, static_cast<T*>(nullptr), M,
                                    N, K, epi, st);
  else
    return nn(a, w_t, M, N, K, epi, st);
}

// The scratch of a backward call: gradients of the layer's activations,
// the attention backward's scratch (the rows' g . o and ds), the weights'
// transposes (f32 only: the bf16 instance reads W itself) and the LN
// backward's partial sums, in the call's type but for dy (the LayerNorm's
// f32 input gradient), the attention's scratch (f32, its ds bf16 on the
// tensor-core instance) and the LayerNorm's f32 partial sums. carve() lays it out from `base` (null: only to size it),
// 16-byte aligned regions.
template <class T>
struct Work {
  T *df, *dlin;
  float* dy;
  T *dx2, *dx3, *dout, *dattn, *dqkv;
  void* attn;           // the attention backward's, attn_bytes of it
  size_t attn_bytes;
  float* ln_partial;
  T *wqkv_t, *wo_t, *w1_t, *w2_t, *wq_t, *wo2_t;   // W^T [N, K]
  size_t bytes;
};

template <class T>
Work<T> carve(void* base, int kind, int B, int T_, int S, int d, int f,
              int H) {
  const size_t M = (size_t)B * T_;
  size_t at = 0;
  auto take = [&](size_t n, size_t elem) {
    void* p = base ? static_cast<char*>(base) + at : nullptr;
    at += (n * elem + 15) / 16 * 16;
    return p;
  };
  auto typed = [&](size_t n) { return static_cast<T*>(take(n, sizeof(T))); };
  auto f32 = [&](size_t n) { return static_cast<float*>(take(n, 4)); };
  Work<T> w;
  w.df = typed(M * d);
  w.dlin = typed(M * f);
  w.dy = f32(M * d);
  w.dx2 = typed(M * d);
  w.dx3 = kind == 1 ? typed(M * d) : nullptr;
  w.dout = typed(M * d);
  w.dattn = typed(M * d);
  w.dqkv = typed(M * 3 * d);
  // either attention route's, for the self (T_ keys) and cross (S) calls
  w.attn_bytes = uic::attn_bwd_scratch_bytes_any(B, H, T_, S > T_ ? S : T_);
  w.attn = take(w.attn_bytes, 1);
  w.ln_partial = f32((size_t)uic::ln_bwd_ws_floats(d));
  const bool tr = !BF<T>;
  w.wqkv_t = tr ? typed((size_t)3 * d * d) : nullptr;
  w.wo_t = tr ? typed((size_t)d * d) : nullptr;
  w.w1_t = tr ? typed((size_t)f * d) : nullptr;
  w.w2_t = tr ? typed((size_t)d * f) : nullptr;
  w.wq_t = tr && kind == 1 ? typed((size_t)d * d) : nullptr;
  w.wo2_t = tr && kind == 1 ? typed((size_t)d * d) : nullptr;
  w.bytes = at;
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
template <class T>
int wgrad(const T* a, int lda, int K, const T* dy, int ldy, int N, int M,
          T* dw, T* db, cudaStream_t st) {
  return gemm<true, false, true>(a, lda, dy, ldy, db, K, N, M,
                                 EpiStore<T>{dw, N}, st);
}

// g itself at rate 0, else drop(g) in `out`
template <class T>
const T* dropped(const T* g, T* out, const Drop& drop, int M,
                 cudaStream_t st, int* err) {
  if (!drop.on) return g;
  if constexpr (BF<T>) {
    if (drop.cols % 4 == 0) {
      drop4_bf16_kernel<<<blocks_for((size_t)M * drop.cols / 4),
                          ELT_THREADS, 0, st>>>(g, out, M, drop);
      *err = (int)cudaGetLastError();
      return out;
    }
  }
  drop_kernel<T><<<blocks_for((size_t)M * drop.cols), ELT_THREADS, 0, st>>>(
      g, out, M, drop);
  *err = (int)cudaGetLastError();
  return out;
}

// the attention's flags: its arrays in the call's type, the bf16 cast
// points on the bf16 route
template <class T>
Attn attn_args(const T* q, int lq, const T* k, int lk, const T* v, int lv,
               const float* mask, int mask_rows, const int* seed, int S,
               const Dims& m) {
  const int fl = (m.rnd ? uic::ATT_RND : 0) |
                 (BF<T> ? uic::ATT_Q_BF | uic::ATT_KV_BF | uic::ATT_O_BF
                        : 0);
  return Attn{q, k, v, mask, seed, lq, lk, lv, m.d, m.B, m.T, S, m.H,
              m.d / m.H, mask_rows, N_SITES * m.H, m.thresh, m.keep_div,
              m.dropout, fl};
}

// the LayerNorm's flags: x, the parameters and y (the backward's res, dx
// and parameter gradients; its dy stays f32) in the call's type; y / dx
// rounded on the bf16 cast points
template <class T>
int ln_fl(const Dims& m) {
  return (m.rnd ? uic::LN_RND : 0) |
         (BF<T> ? uic::LN_X_BF | uic::LN_P_BF | uic::LN_Y_BF : 0);
}
template <class T>
int ln_bwd_fl(const Dims& m) {
  return ln_fl<T>(m) | (BF<T> ? uic::LN_R_BF | uic::LN_D_BF : 0);
}

// The self-attention sublayer: x2 = x + drop(attn(LN1(x) Wqkv + bqkv) Wo +
// bo, site 1); keeps y1, qkv, ao and the attention's row statistics
template <class T>
int self_fwd(const T* x, const float* mask, int mask_rows, const int* seed,
             const T* wqkv, const T* bqkv, const T* wo, const T* bo,
             const T* ls, const T* lb, T* y1, T* qkv, T* ao, float* stats,
             T* x2, const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d;
  int err = uic::ln_fwd(x, ls, lb, y1, M, d, EPS, st, ln_fl<T>(m));
  if (err) return err;
  if ((err = nn(y1, wqkv, M, 3 * d, d, EpiLin<T>{bqkv, qkv, 3 * d, m.rnd},
                st)))
    return err;
  if ((err = uic::attn_fwd(attn_args(qkv, 3 * d, qkv + d, 3 * d, qkv + 2 * d,
                                     3 * d, mask, mask_rows, seed, m.T, m),
                           ao, stats, st)))
    return err;
  return nn(ao, wo, M, d, d,
            EpiResDrop<T>{bo, x, x2, d, drop_at(seed, m, 1, d, true)}, st);
}

// The cross-attention sublayer: x3 = x2 + drop(attn(LN2(x2) Wq + bq, mk, mv)
// Wo2 + bo2, site 1) under seed2; keeps y2, qc, co and the attention's row
// statistics
template <class T>
int cross_fwd(const T* x2, const T* mk, const T* mv, const float* sm,
              const int* seed2, const T* wq, const T* bq, const T* wo2,
              const T* bo2, const T* ls, const T* lb, T* y2, T* qc, T* co,
              float* stats, T* x3, const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d;
  int err = uic::ln_fwd(x2, ls, lb, y2, M, d, EPS, st, ln_fl<T>(m));
  if (err) return err;
  if ((err = nn(y2, wq, M, d, d, EpiLin<T>{bq, qc, d, m.rnd}, st)))
    return err;
  if ((err = uic::attn_fwd(attn_args(qc, d, mk, d, mv, d, sm, 1, seed2, m.S,
                                     m),
                           co, stats, st)))
    return err;
  return nn(co, wo2, M, d, d,
            EpiResDrop<T>{bo2, x2, x3, d, drop_at(seed2, m, 1, d, true)},
            st);
}

// The FFN sublayer: out = xa + drop(drop(relu(LN(xa) W1 + b1), site 2) W2 +
// b2, site 3); keeps y and hd
template <class T>
int ffn_fwd(const T* xa, const int* seed, const T* w1, const T* b1,
            const T* w2, const T* b2, const T* ls, const T* lb, T* y, T* hd,
            T* out, const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d, f = m.f;
  int err = uic::ln_fwd(xa, ls, lb, y, M, d, EPS, st, ln_fl<T>(m));
  if (err) return err;
  if ((err = nn(y, w1, M, f, d,
                EpiReluDrop<T>{b1, hd, f, drop_at(seed, m, 2, f, true)},
                st)))
    return err;
  return nn(hd, w2, M, d, f,
            EpiResDrop<T>{b2, xa, out, d, drop_at(seed, m, 3, d, true)}, st);
}

// The FFN half of the backward (the Pallas `_bwd_ffn_kernel`): from
// g = d(out) to dxa = g + d(LN) and the FFN / LN weight gradients
template <class T>
int ffn_bwd(const T* xa, const T* y, const T* hd, const T* g,
            const int* seed, const T* w1, const T* w2, const T* ls, T* dxa,
            T* dw1, T* db1, T* dw2, T* db2, T* dls, T* dlb, const Work<T>& w,
            const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d, f = m.f;
  int err = 0;
  const T* df = dropped(g, w.df, drop_at(seed, m, 3, d), M, st, &err);
  if (err) return err;
  if ((err = wgrad(hd, f, f, df, d, d, M, dw2, db2, st))) return err;
  if ((err = xwt(df, w2, w.w2_t, M, f, d,
                 EpiDrelu<T>{hd, w.dlin, f, drop_at(seed, m, 2, f)}, st)))
    return err;
  if ((err = wgrad(y, d, d, w.dlin, f, f, M, dw1, db1, st))) return err;
  if ((err = xwt(w.dlin, w1, w.w1_t, M, d, f, EpiStore<float>{w.dy, d},
                 st)))
    return err;
  return uic::ln_bwd(xa, ls, w.dy, g, dxa, dls, dlb, w.ln_partial, M, d,
                     EPS, st, ln_bwd_fl<T>(m));
}

// The self-attention half (the Pallas `_bwd_attn_kernel`): from g2 = d(x2)
// to dx = g2 + d(LN1) and the QKV / O / LN1 weight gradients
template <class T>
int self_bwd(const T* x, const float* mask, int mask_rows, const int* seed,
             const T* y1, const T* qkv, const T* ao, const float* stats,
             const T* g2, const T* wqkv, const T* wo, const T* ls, T* dx,
             T* dwqkv, T* dbqkv, T* dwo, T* dbo, T* dls, T* dlb,
             const Work<T>& w, const Dims& m, cudaStream_t st) {
  const int M = m.B * m.T, d = m.d;
  int err = 0;
  const T* dout = dropped(g2, w.dout, drop_at(seed, m, 1, d), M, st, &err);
  if (err) return err;
  if ((err = wgrad(ao, d, d, dout, d, d, M, dwo, dbo, st))) return err;
  if ((err = xwt(dout, wo, w.wo_t, M, d, d, EpiStore<T>{w.dattn, d, m.rnd},
                 st)))
    return err;
  if ((err = uic::attn_bwd(
           attn_args(qkv, 3 * d, qkv + d, 3 * d, qkv + 2 * d, 3 * d, mask,
                     mask_rows, seed, m.T, m),
           w.dattn, ao, stats, w.dqkv, w.dqkv + d, w.dqkv + 2 * d, w.attn,
           w.attn_bytes, st)))
    return err;
  if ((err = wgrad(y1, d, d, w.dqkv, 3 * d, 3 * d, M, dwqkv, dbqkv, st)))
    return err;
  if ((err = xwt(w.dqkv, wqkv, w.wqkv_t, M, d, 3 * d,
                 EpiStore<float>{w.dy, d}, st)))
    return err;
  return uic::ln_bwd(x, ls, w.dy, g2, dx, dls, dlb, w.ln_partial, M, d, EPS,
                     st, ln_bwd_fl<T>(m));
}

// The cross-attention half (the Pallas `_bwd_cross_kernel`): from
// g3 = d(x3) to dx2 = g3 + d(LN2), dmk, dmv and the Wq / Wo2 / LN2 weight
// gradients
template <class T>
int cross_bwd(const T* x2, const T* mk, const T* mv, const float* sm,
              const int* seed2, const T* y2, const T* qc, const T* co,
              const float* stats, const T* g3, const T* wq, const T* wo2,
              const T* ls, T* dx2, T* dmk, T* dmv, T* dwq, T* dbq, T* dwo2,
              T* dbo2, T* dls, T* dlb, const Work<T>& w, const Dims& m,
              cudaStream_t st) {
  const int M = m.B * m.T, d = m.d;
  int err = 0;
  const T* dout = dropped(g3, w.dout, drop_at(seed2, m, 1, d), M, st, &err);
  if (err) return err;
  if ((err = wgrad(co, d, d, dout, d, d, M, dwo2, dbo2, st))) return err;
  if ((err = xwt(dout, wo2, w.wo2_t, M, d, d,
                 EpiStore<T>{w.dattn, d, m.rnd}, st)))
    return err;
  T* dqc = w.dqkv;   // [M, d]
  if ((err = uic::attn_bwd(attn_args(qc, d, mk, d, mv, d, sm, 1, seed2, m.S,
                                     m),
                           w.dattn, co, stats, dqc, dmk, dmv, w.attn,
                           w.attn_bytes, st)))
    return err;
  if ((err = wgrad(y2, d, d, dqc, d, d, M, dwq, dbq, st))) return err;
  if ((err = xwt(dqc, wq, w.wq_t, M, d, d, EpiStore<float>{w.dy, d}, st)))
    return err;
  return uic::ln_bwd(x2, ls, w.dy, g3, dx2, dls, dlb, w.ln_partial, M, d,
                     EPS, st, ln_bwd_fl<T>(m));
}

Dims dims(int B, int T, int S, int d, int f, int H, unsigned int thresh,
          float keep_div, int dropout, int bf) {
  return Dims{B, T, S, d, f, H, thresh, keep_div, dropout, bf != 0};
}

// A call's pointers by role: the layer's values in the call's type T,
// the masks and the softmax statistics f32, the seeds int32.
template <class T>
struct Ptrs {
  const void* const* p;
  const T* in(int i) const { return static_cast<const T*>(p[i]); }
  T* out(int i) const { return static_cast<T*>(const_cast<void*>(p[i])); }
  const float* mask(int i) const { return static_cast<const float*>(p[i]); }
  float* stats(int i) const {
    return static_cast<float*>(const_cast<void*>(p[i]));
  }
  const int* seed(int i) const { return static_cast<const int*>(p[i]); }
};

// The four calls over the pointers of their C entries below.
template <class T>
int enc_fwd(Ptrs<T> q, int mask_rows, const Dims& m, cudaStream_t st) {
  int err = self_fwd(q.in(0), q.mask(1), mask_rows, q.seed(2), q.in(3),
                     q.in(4), q.in(5), q.in(6), q.in(11), q.in(12),
                     q.out(17), q.out(18), q.out(19), q.stats(20),
                     q.out(16), m, st);
  if (err) return err;
  return ffn_fwd(q.in(16), q.seed(2), q.in(7), q.in(8), q.in(9), q.in(10),
                 q.in(13), q.in(14), q.out(21), q.out(22), q.out(15), m, st);
}

template <class T>
int enc_bwd(Ptrs<T> q, int mask_rows, void* ws, const Dims& m,
            cudaStream_t st) {
  const int d = m.d, f = m.f;
  const Work<T> w = carve<T>(ws, 0, m.B, m.T, m.T, d, f, m.H);
  int err = 0;
  if constexpr (!BF<T>) {
    // wqkv, wo, w1, w2
    const T* src[] = {q.in(3), q.in(5), q.in(7), q.in(9)};
    T* const dst[] = {w.wqkv_t, w.wo_t, w.w1_t, w.w2_t};
    const int rows[] = {d, d, d, f}, cols[] = {3 * d, d, f, d};
    if ((err = transpose_weights(src, dst, rows, cols, 4, st))) return err;
  }
  if ((err = ffn_bwd(q.in(15), q.in(20), q.in(21), q.in(22), q.seed(2),
                     q.in(7), q.in(9), q.in(13), w.dx2, q.out(28),
                     q.out(29), q.out(30), q.out(31), q.out(34), q.out(35),
                     w, m, st)))
    return err;
  return self_bwd(q.in(0), q.mask(1), mask_rows, q.seed(2), q.in(16),
                  q.in(17), q.in(18), q.mask(19), w.dx2, q.in(3), q.in(5),
                  q.in(11), q.out(23), q.out(24), q.out(25), q.out(26),
                  q.out(27), q.out(32), q.out(33), w, m, st);
}

template <class T>
int dec_fwd(Ptrs<T> q, int tmask_rows, const Dims& m, cudaStream_t st) {
  const int* seed = q.seed(5);
  int err = self_fwd(q.in(0), q.mask(3), tmask_rows, seed, q.in(6), q.in(7),
                     q.in(8), q.in(9), q.in(18), q.in(19), q.out(27),
                     q.out(28), q.out(29), q.stats(34), q.out(25), m, st);
  if (err) return err;
  if ((err = cross_fwd(q.in(25), q.in(1), q.in(2), q.mask(4), seed + 1,
                       q.in(10), q.in(11), q.in(12), q.in(13), q.in(20),
                       q.in(21), q.out(30), q.out(31), q.out(32),
                       q.stats(35), q.out(26), m, st)))
    return err;
  return ffn_fwd(q.in(26), seed, q.in(14), q.in(15), q.in(16), q.in(17),
                 q.in(22), q.in(23), q.out(33), q.out(36), q.out(24), m, st);
}

template <class T>
int dec_bwd(Ptrs<T> q, int tmask_rows, void* ws, const Dims& m,
            cudaStream_t st) {
  const int d = m.d, f = m.f;
  const Work<T> w = carve<T>(ws, 1, m.B, m.T, m.S, d, f, m.H);
  const int* seed = q.seed(5);
  int err = 0;
  if constexpr (!BF<T>) {
    // wqkv, wo, wq, wo2, w1, w2
    const T* src[] = {q.in(6), q.in(8), q.in(10), q.in(12), q.in(14),
                      q.in(16)};
    T* const dst[] = {w.wqkv_t, w.wo_t, w.wq_t, w.wo2_t, w.w1_t, w.w2_t};
    const int rows[] = {d, d, d, d, d, f}, cols[] = {3 * d, d, d, d, f, d};
    if ((err = transpose_weights(src, dst, rows, cols, 6, st))) return err;
  }
  if ((err = ffn_bwd(q.in(25), q.in(32), q.in(35), q.in(36), seed,
                     q.in(14), q.in(16), q.in(22), w.dx3, q.out(48),
                     q.out(49), q.out(50), q.out(51), q.out(56), q.out(57),
                     w, m, st)))
    return err;
  if ((err = cross_bwd(q.in(24), q.in(1), q.in(2), q.mask(4), seed + 1,
                       q.in(29), q.in(30), q.in(31), q.mask(34), w.dx3,
                       q.in(10), q.in(12), q.in(20), w.dx2, q.out(38),
                       q.out(39), q.out(44), q.out(45), q.out(46), q.out(47),
                       q.out(54), q.out(55), w, m, st)))
    return err;
  return self_bwd(q.in(0), q.mask(3), tmask_rows, seed, q.in(26), q.in(27),
                  q.in(28), q.mask(33), w.dx2, q.in(6), q.in(8), q.in(18),
                  q.out(37), q.out(40), q.out(41), q.out(42), q.out(43),
                  q.out(52), q.out(53), w, m, st);
}

}  // namespace

extern "C" {

// Floats of scratch a backward call takes into *n: kind 0 the encoder
// layer, 1 the decoder layer; bf: a bf16 call (its scratch half bf16).
// Returns 0.
int layer_train_ws_f32(int kind, int B, int T, int S, int d, int f, int H,
                       int bf, long long* n) {
  const size_t bytes =
      bf ? carve<bf16>(nullptr, kind, B, T, S, d, f, H).bytes
         : carve<float>(nullptr, kind, B, T, S, d, f, H).bytes;
  *n = (long long)(bytes / 4);
  return 0;
}

// The plan of train_gemm.cuh for an M x N x K product into out[4], on the
// forward's kernel instance (EpiLin) of the f32 core, or with bf of the
// bf16 tensor-core instance: the row tiles run in whole rounds, the row
// tiles in all, the cluster size of the rest and the clusters of that size
// the card holds at once. Returns 0, or a CUDA error.
int layer_train_gemm_plan(int M, int N, int K, int bf, int* out) {
  const int* clusters =
      bf ? uic_train::tb_clusters<false, false, false, EpiLin<bf16>, true>()
         : uic_train::tg_clusters<false, false, EpiLin<float>>();
  if (!clusters[0]) return (int)cudaErrorInvalidConfiguration;
  const uic_train::TgPlan plan = uic_train::tg_plan(
      M, N, K, clusters, bf ? uic_train::TB_BK : uic_train::TG_BK);
  out[0] = plan.full_rows;
  out[1] = plan.rows;
  out[2] = plan.cs;
  out[3] = clusters[plan.cs];
  return 0;
}

// p: x, mask [B, mask_rows, T], seed [1], wqkv, bqkv, wo, bo, w1, b1, w2,
// b2, l1s, l1b, l2s, l2b; out; saved x2, y1, qkv [B*T, 3d], ao, the
// attention's row statistics [2, B, H, T], y2, hd [B*T, f]. Activations
// [B*T, d] unless stated. bf: every tensor but the mask and the statistics
// bf16 (the products on the tensor cores), else every tensor f32.
int enc_layer_fwd_mixed(const void* const* p, int B, int T, int d, int f,
                        int H, int mask_rows, unsigned int thresh,
                        float keep_div, int dropout, int bf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims m = dims(B, T, T, d, f, H, thresh, keep_div, dropout, bf);
  return bf ? enc_fwd(Ptrs<bf16>{p}, mask_rows, m, st)
            : enc_fwd(Ptrs<float>{p}, mask_rows, m, st);
}

// p: x, mask, seed, the 12 weights as above (3-14), saved x2, y1, qkv, ao,
// stats, y2, hd (15-21), g (22); dx (23) and the 12 weight gradients
// (24-35) in the weights' order, each in its weight's type. ws:
// layer_train_ws_f32(0, ..., bf) floats; bf as the forward's.
int enc_layer_bwd_mixed(const void* const* p, int B, int T, int d, int f,
                        int H, int mask_rows, unsigned int thresh,
                        float keep_div, int dropout, int bf, float* ws,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims m = dims(B, T, T, d, f, H, thresh, keep_div, dropout, bf);
  return bf ? enc_bwd(Ptrs<bf16>{p}, mask_rows, ws, m, st)
            : enc_bwd(Ptrs<float>{p}, mask_rows, ws, m, st);
}

// p: x, mk [B, S, d], mv, tgt mask [B, tmask_rows, T], src mask [B, 1, S],
// seeds [2] (0-5); wqkv, bqkv, wo, bo, wq, bq, wo2, bo2, w1, b1, w2, b2,
// l1s, l1b, l2s, l2b, l3s, l3b (6-23); out (24); saved x2, x3, y1, qkv, ao,
// y2, qc, co, y3, the self and cross attentions' row statistics
// [2, B, H, T] each, hd (25-36). bf: as the encoder's.
int dec_layer_fwd_mixed(const void* const* p, int B, int T, int S, int d,
                        int f, int H, int tmask_rows, unsigned int thresh,
                        float keep_div, int dropout, int bf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims m = dims(B, T, S, d, f, H, thresh, keep_div, dropout, bf);
  return bf ? dec_fwd(Ptrs<bf16>{p}, tmask_rows, m, st)
            : dec_fwd(Ptrs<float>{p}, tmask_rows, m, st);
}

// p: the 24 forward inputs (0-23), saved as above (24-35), g (36); dx (37),
// dmk (38), dmv (39) and the 18 weight gradients (40-57) in the weights'
// order. ws: layer_train_ws_f32(1, ..., bf) floats; bf as the forward's.
int dec_layer_bwd_mixed(const void* const* p, int B, int T, int S, int d,
                        int f, int H, int tmask_rows, unsigned int thresh,
                        float keep_div, int dropout, int bf, float* ws,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims m = dims(B, T, S, d, f, H, thresh, keep_div, dropout, bf);
  return bf ? dec_bwd(Ptrs<bf16>{p}, tmask_rows, ws, m, st)
            : dec_bwd(Ptrs<float>{p}, tmask_rows, ws, m, st);
}

}  // extern "C"
