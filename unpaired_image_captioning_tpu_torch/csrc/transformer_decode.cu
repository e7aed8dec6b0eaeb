// Transformer decoder step: the Hopper counterpart of the TPU kernels
// unpaired_image_captioning_tpu/ops/transformer_decode.py::_stack_kernel
// (all L layers of one decode step) and ::_layer_kernel (one layer).
//
// One step through one pre-norm decoder layer, for R = B*kb rows (the kb
// beams of an image are consecutive rows), as `_layer_math` there:
//
//   y = LN1(x); [q | k_t | v_t] = y @ Wqkv + bqkv; cache[r, t[r]] = k_t, v_t
//   x += selfattn(q, cache; tau <= t[r]) @ Wo_s + bo_s
//   y = LN2(x); q2 = y @ Wq_c + bq_c
//   x += crossattn(q2, K/V of row r's image; src_mask) @ Wo_c + bo_c
//   x += relu(LN3(x) @ W1 + b1) @ W2 + b2
//
// LN is the reference's: two passes, unbiased (n-1) variance, eps 1e-6
// outside the sqrt. Masked scores are -1e9, softmax in f32, scale
// 1/sqrt(dh). A row with t < 0 masks every position, so it attends
// uniformly over all T slots, as the reference's softmax of equal scores
// does; a row with t >= T writes no slot and attends over all T. In the
// lazy-cache mode (anc != null) position tau of row r is read from
// physical row image*kb + anc[r, tau]. Products are plain f32 FMA on the
// CUDA cores: no TF32, no tensor cores, no library call.
//
// What bounds it on an H100. Caption (R = 250, d = d_ff = 512, S = 196,
// 6 layers): 6.3 GFLOP of projections (0.094 ms at the f32 FMA rate of 67
// TFLOP/s) against 241 MB of cross-attention K/V (0.072 ms at 3.35 TB/s)
// plus 50 MB of weights: bytes and operations about level. NMT (R = 750,
// d_ff = 2048, S = 16, lazy cache): 33 GFLOP, so the f32 FMA rate bounds it
// (0.49 ms).
//
// Design. A Hopper block cannot hold a 12.6 MB layer in its 227 KB of
// shared memory, so each layer is a fixed sequence of short kernels, all
// launched from one C call per decode step (`tfd_stack_step_f32` loops over
// the L layers); y lives in the `att` scratch between an LN and its GEMM:
//
//   1. ln_rows: y = LN1(x), a warp per row, each row's statistics once
//      (layer 0 also copies x_in to x_out: no separate copy);
//   2. decode_gemm<QKV>: q out, k_t / v_t scattered into slot t[r] of the
//      cache, in place;
//   3. self_attn: a warp per (row, head); lanes over positions, each a
//      q.k over 16-byte loads (no per-position warp sum), a warp-shuffle
//      softmax, then lanes over dh for P.V, position groups summed by
//      shuffles in a fixed order;
//   4. decode_gemm<RES>: x += att @ Wo_s + bo_s, in place;
//   5. ln_rows: y = LN2(x);  6. decode_gemm<BIAS>: q2 = y @ Wq_c + bq_c;
//   7. cross_attn: flash-decoding over the image's unexpanded K/V. A
//      cluster of CS <= 8 blocks per (image, head, query group), each over
//      a slice of about 64 of the S slots (the query group is all kb beams
//      unless their shared memory would not fit a block: then the fewest
//      groups that fit, as at dh 256 and beam 32): the slice's K, then its
//      V, land in shared memory through 16-byte cp.async copies (V while
//      the scores and the softmax run), once for the group's beams, whose
//      queries sit in shared memory beside them. Each block takes a
//      softmax over its slice and writes (max, sum, unnormalised P.V)
//      into rank 0's shared memory
//      (after a split barrier that shows rank 0 has started: arrive as
//      the copies go out, wait after the scores); after one more cluster
//      barrier rank 0 combines the slices in rank order (max, rescaled
//      sums) and the others are done. With want_attn the
//      per-head weights go to [R, H, S] scratch and head_mean sums them
//      over heads in a fixed order (the NMT's UNK replacement takes their
//      argmax, so a rerun must give the same bits);
//   8. decode_gemm<RES>: x += att @ Wo_c + bo_c;
//   9. ln_rows: y = LN3(x);  10. decode_gemm<RELU>: h1 = relu(y @ W1 + b1);
//  11. decode_gemm<RES>: x += h1 @ W2 + b2.
//
// decode_gemm.cuh holds the GEMM: 64 x 64 tiles, 8 x 4 f32 register tiles,
// a 3-stage cp.async ring of 32-deep K tiles, the K reduction split across
// a cluster where the tiles alone leave SMs idle or unevenly loaded.
// Nothing sums with atomics: a rerun gives the same bits. Per step the C
// call launches 11 kernels a layer (12 on the last with want_attn), each
// short: launch latency, the GEMMs' f32 FMA rate and, at the caption, the
// cross-attention's K/V stream are what is left.
//
// Types (the compute dtype). x (the step's compute type dt), the weights,
// the caches and the cross-attention memory are each f32 or bf16 (TFD_*
// flags): f32 weights and x over bf16 caches and memory where the card's
// serving and eval decode rounded features, all bf16 where the SCST
// sample runs under a bf16 copy of the parameters. A step with any bf16
// operand runs run_layer_typed: every operand read in its type through
// converting loads into the f32 FMA core, and JAX's cast points
// (ops/transformer_decode.py:88, :116-118, :523-580 of the JAX package):
// LN to dt; each product plus its f32 bias cast to dt (qkv, q2, h1, each
// sublayer's output before the residual add in dt); the caches written in
// their type; the scores and softmax f32, the weights and the attention
// outputs cast to dt. An all-f32 step runs the kernels above unchanged.
//
// Widths. Any d, d_ff and head width: where d or the head width is not a
// multiple of 4 the LN and the products (decode_gemm.cuh) run instances
// with scalar loads, the same sums otherwise. The two attentions keep the
// kernels above for every shape they take and hand the rest to a second
// kernel each: self_attn_kernel_chunked (a cache longer than a warp's
// shared memory holds, in chunks with an online softmax, rows off 16
// bytes, or a head past 7,200 columns, its q staged in column chunks whose
// partial scores add up) and cross_attn_kernel_pieces (a slice whose K / V
// or a head whose queries would not fit a block's shared memory, walked in
// pieces, or rows off 16 bytes). A head so wide that one query and one
// slot of it would not fit a block (past about 5,000 columns) runs
// cross_attn_kernel_wide: a row a block, the scores summed over column
// chunks of q, then the value pass column by column into the output row.
// No width is refused.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "bf16.cuh"
#include "decode_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

using uic_bf16::ldf;
using uic_bf16::rnd_if;
using uic_bf16::stf;

// The operands' types (the compute dtype), flags of a step call: each
// names arrays stored as bf16, read through converting loads and written
// rounded to nearest even. x's type is the step's compute type dt (JAX's
// `_layer_math`: y, qkv, the attention weights and outputs, q2, h1 and
// each sublayer's output cast to x.dtype); the caches and the memory keep
// their own types.
constexpr int TFD_X_BF = 1;   // x_in / x_out
constexpr int TFD_W_BF = 2;   // the 18 packed weights
constexpr int TFD_C_BF = 4;   // the self-attention caches
constexpr int TFD_M_BF = 8;   // the cross-attention K / V (the memory)

using uic::EpiBias;
using uic::EpiRelu;
using uic::EpiRes;
using uic_decode::decode_gemm;

constexpr float MASKED = -1e9f;  // the reference's masked score
constexpr float LN_EPS = 1e-6f;
constexpr int ROW_WARPS = 8;     // warps per LN and self-attention block
constexpr int CROSS_THREADS = 128;
constexpr int CROSS_MAX_CLUSTER = 8;
constexpr int CROSS_SLICE = 64;  // slots a cross-attention block aims at
constexpr long long MAX_SMEM = 227 * 1024;  // bytes a block can opt into

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

// A split cluster barrier: a block arrives (relaxed: it orders no memory)
// and later waits; once the wait returns every block of the cluster has
// started, so its shared memory may be written through DSMEM.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}

__device__ __forceinline__ float4 fma4(float a, float4 b, float4 c) {
  return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y), fmaf(a, b.z, c.z),
                     fmaf(a, b.w, c.w));
}

// q . k over dh4 float4 of each, four partial sums
__device__ __forceinline__ float dot4(const float4* a, const float4* b,
                                      int dh4) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 4
  for (int j = 0; j < dh4; ++j) {
    const float4 x = a[j], y = b[j];
    s0 = fmaf(x.x, y.x, s0);
    s1 = fmaf(x.y, y.y, s1);
    s2 = fmaf(x.z, y.z, s2);
    s3 = fmaf(x.w, y.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// The packed LN1 -> QKV projection's epilogue: q (columns [0, d)) to
// q [M, d]; k_t / v_t into slot t[r] of row r's cache, in place. A float4
// of columns never straddles q | k | v (the float4 instance runs only where
// d % 4 == 0; `one` takes an element at a time).
struct EpiQkv {
  const float* bias;   // [3d]
  float* q;            // [M, d]
  float* cache_k;      // row r, slot t at cache_k + r * cache_row + t * d
  float* cache_v;
  const int* t;        // [M] slot per row
  size_t cache_row;    // floats between two rows of the cache
  int d;
  int T;               // cache slots
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const float4 b4 = *reinterpret_cast<const float4*>(bias + c);
    const float4 v =
        make_float4(acc.x + b4.x, acc.y + b4.y, acc.z + b4.z, acc.w + b4.w);
    const int part = c / d, cc = c - part * d;
    if (part == 0) {
      *reinterpret_cast<float4*>(q + (size_t)r * d + cc) = v;
      return;
    }
    const int slot = t[r];
    if (slot >= 0 && slot < T) {
      float* cache = part == 1 ? cache_k : cache_v;
      *reinterpret_cast<float4*>(cache + (size_t)r * cache_row +
                                 (size_t)slot * d + cc) = v;
    }
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    const float v = acc + bias[c];
    const int part = c / d, cc = c - part * d;
    if (part == 0) {
      q[(size_t)r * d + cc] = v;
      return;
    }
    const int slot = t[r];
    if (slot >= 0 && slot < T)
      (part == 1 ? cache_k : cache_v)[(size_t)r * cache_row +
                                      (size_t)slot * d + cc] = v;
  }
};

// The typed step's epilogues (any TFD_* flags): the product plus the f32
// bias, cast to dt (rnd: dt is bf16) as `(_mm(y, w) + b).astype(dt)`.
// EpiQkv's: q to q [M, d] (f32 scratch holding dt values), k_t / v_t into
// slot t[r] of row r's caches in the caches' type
struct EpiQkvT {
  const void* bias;
  float* q;
  void* cache_k;
  void* cache_v;
  const int* t;
  size_t cache_row;
  int d, T;
  bool wbf, cbf, rnd;
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    const float v = rnd_if(acc + ldf(bias, c, wbf), rnd);
    const int part = c / d, cc = c - part * d;
    if (part == 0) {
      q[(size_t)r * d + cc] = v;
      return;
    }
    const int slot = t[r];
    if (slot >= 0 && slot < T)
      stf(part == 1 ? cache_k : cache_v,
          (size_t)r * cache_row + (size_t)slot * d + cc, v, cbf);
  }
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    one(r, c, acc.x);
    one(r, c + 1, acc.y);
    one(r, c + 2, acc.z);
    one(r, c + 3, acc.w);
  }
};

// x += (acc + bias) in dt, in place (x in dt)
struct EpiResT {
  const void* bias;
  void* x;
  int d;
  bool wbf, xbf;
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    const size_t o = (size_t)r * d + c;
    const float v = rnd_if(acc + ldf(bias, c, wbf), xbf);
    stf(x, o, ldf(x, o, xbf) + v, xbf);
  }
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    one(r, c, acc.x);
    one(r, c + 1, acc.y);
    one(r, c + 2, acc.z);
    one(r, c + 3, acc.w);
  }
};

// out = (acc + bias) or relu of it, in dt, into f32 scratch [M, ld]
struct EpiLinT {
  const void* bias;
  float* out;
  int ld;
  bool wbf, rnd, relu;
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    float v = acc + ldf(bias, c, wbf);
    if (relu) v = fmaxf(v, 0.0f);
    out[(size_t)r * ld + c] = rnd_if(v, rnd);
  }
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    one(r, c, acc.x);
    one(r, c + 1, acc.y);
    one(r, c + 2, acc.z);
    one(r, c + 3, acc.w);
  }
};

// ln_rows_kernel for operands of any types: x in dt (copied to x_copy in
// dt), scale / offset in the weights' type, y (f32 scratch) rounded to dt
__global__ void __launch_bounds__(ROW_WARPS * 32)
ln_rows_typed_kernel(const void* __restrict__ x, void* __restrict__ x_copy,
                     const void* __restrict__ scale,
                     const void* __restrict__ offset, float* __restrict__ y,
                     int R, int d, bool xbf, bool wbf) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  const size_t o = (size_t)r * d;
  float s = 0.0f;
  for (int j = lane; j < d; j += 32) s += ldf(x, o + j, xbf);
  const float mean = warp_sum(s) / (float)d;
  float q = 0.0f;
  for (int j = lane; j < d; j += 32) {
    const float a = ldf(x, o + j, xbf) - mean;
    q = fmaf(a, a, q);
  }
  const float den = sqrtf(warp_sum(q) / (float)(d - 1)) + LN_EPS;
  for (int j = lane; j < d; j += 32) {
    const float u = ldf(x, o + j, xbf);
    y[o + j] = rnd_if(
        (u - mean) / den * ldf(scale, j, wbf) + ldf(offset, j, wbf), xbf);
    if (x_copy) stf(x_copy, o + j, u, xbf);
  }
}

// y = LN(x) row by row, a warp per row, the row's mean and deviation taken
// once (two passes, as the reference, over the row held in registers: at
// most LN_REG float4 a lane, d <= 512; a longer row is read again from
// memory); with x_copy != null the row is also copied there (layer 0's
// x_in -> x_out). V4 false (d not a multiple of 4): the same passes over
// scalar elements, read from memory.
constexpr int LN_REG = 4;

template <bool V4>
__global__ void __launch_bounds__(ROW_WARPS * 32)
ln_rows_kernel(const float* __restrict__ x, float* __restrict__ x_copy,
               const float* __restrict__ scale,
               const float* __restrict__ offset, float* __restrict__ y, int R,
               int d) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  if constexpr (!V4) {
    const float* xr = x + (size_t)r * d;
    float s = 0.0f;
    for (int j = lane; j < d; j += 32) s += xr[j];
    const float mean = warp_sum(s) / (float)d;
    float q = 0.0f;
    for (int j = lane; j < d; j += 32) {
      const float a = xr[j] - mean;
      q = fmaf(a, a, q);
    }
    const float den = sqrtf(warp_sum(q) / (float)(d - 1)) + LN_EPS;
    for (int j = lane; j < d; j += 32) {
      const float u = xr[j];
      y[(size_t)r * d + j] = (u - mean) / den * scale[j] + offset[j];
      if (x_copy) x_copy[(size_t)r * d + j] = u;
    }
    return;
  }
  const int d4 = d / 4;
  const bool in_reg = d4 <= 32 * LN_REG;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)r * d);
  float4 v[LN_REG];
#pragma unroll
  for (int i = 0; i < LN_REG; ++i) {
    const int j = lane + 32 * i;
    v[i] = in_reg && j < d4 ? xr[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // f(u, j) over the lane's float4 u = x[r, 4j .. 4j + 3], in order
  auto pass = [&](auto&& f) {
    if (in_reg) {
#pragma unroll
      for (int i = 0; i < LN_REG; ++i)
        if (lane + 32 * i < d4) f(v[i], lane + 32 * i);
    } else {
      for (int j = lane; j < d4; j += 32) f(xr[j], j);
    }
  };
  float s = 0.0f;
  pass([&](float4 u, int) { s += (u.x + u.y) + (u.z + u.w); });
  const float mean = warp_sum(s) / (float)d;
  float q = 0.0f;
  pass([&](float4 u, int) {
    const float a = u.x - mean, b = u.y - mean, c = u.z - mean,
                e = u.w - mean;
    q = fmaf(a, a, q);
    q = fmaf(b, b, q);
    q = fmaf(c, c, q);
    q = fmaf(e, e, q);
  });
  const float den = sqrtf(warp_sum(q) / (float)(d - 1)) + LN_EPS;
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  const float4* o4 = reinterpret_cast<const float4*>(offset);
  float4* yr = reinterpret_cast<float4*>(y + (size_t)r * d);
  float4* cr =
      x_copy ? reinterpret_cast<float4*>(x_copy + (size_t)r * d) : nullptr;
  pass([&](float4 u, int j) {
    const float4 sc = s4[j], of = o4[j];
    yr[j] = make_float4((u.x - mean) / den * sc.x + of.x,
                        (u.y - mean) / den * sc.y + of.y,
                        (u.z - mean) / den * sc.z + of.z,
                        (u.w - mean) / den * sc.w + of.w);
    if (cr) cr[j] = u;
  });
}

__host__ __device__ inline long long round4(long long n) {
  return (n + 3) & ~3LL;
}

// floats of shared memory a self-attention warp keeps: qc of q's columns
// [padded to 4], then the scores and physical rows of a chunk of tc
// positions [tc each, padded to 4]
__host__ __device__ inline long long self_warp_floats(int qc, int tc) {
  return round4(qc) + 2 * round4(tc);
}

// the columns of q a warp of self_attn_kernel_chunked stages at once: the
// whole head where that leaves room for 32 positions, else column chunks
// of that many (a multiple of 4)
constexpr long long SELF_WARP_FLOATS = MAX_SMEM / 4 / ROW_WARPS;
__host__ __device__ inline int self_qcols(int dh) {
  const long long most = SELF_WARP_FLOATS - 64;
  return round4(dh) <= most ? (int)round4(dh) : (int)most;
}

// the positions a self-attention warp takes at once: all T where they and
// the whole head fit the block's shared memory, else the most that fit
// beside self_qcols(dh) columns of q (a multiple of 32)
inline int self_chunk(int dh, int T) {
  if (self_warp_floats(dh, T) <= SELF_WARP_FLOATS) return T;
  return (int)(((SELF_WARP_FLOATS - self_qcols(dh)) / 2) & ~31LL);
}

// q . k over dh elements (V4: dh / 4 float4 of each, four partial sums)
template <bool V4>
__device__ __forceinline__ float dot_row(const float* a, const float* b,
                                         int dh) {
  if (V4)
    return dot4(reinterpret_cast<const float4*>(a),
                reinterpret_cast<const float4*>(b), dh / 4);
  float s = 0.0f;
  for (int j = 0; j < dh; ++j) s = fmaf(a[j], b[j], s);
  return s;
}

// Self-attention of one decode step: warp (r, h) attends with row r's query
// over the positions tau <= t[r] of its cache (or, lazily, of the rows anc
// names). q and out are [R, d]; the caches hold row r's slot tau of this
// layer at cache + r * cache_row + tau * d. dh and d multiples of 4, the
// positions within a warp's shared memory (self_attn_kernel_chunked takes
// every other shape).
__global__ void __launch_bounds__(ROW_WARPS * 32)
self_attn_kernel(const float* __restrict__ q, const float* cache_k,
                 const float* cache_v, const int* __restrict__ t,
                 const int* __restrict__ anc, float* __restrict__ out, int R,
                 int kb, int H, int dh, int d, int T, size_t cache_row,
                 float scale_div) {
  extern __shared__ __align__(16) float sa_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * ROW_WARPS + warp;
  if (gw >= R * H) return;                 // no block barrier below
  const int r = gw / H, h = gw - r * H;
  const int Tp = (int)round4(T), dh4 = dh / 4;
  float* qs = sa_smem + warp * self_warp_floats(dh, T);
  float* sc = qs + dh;
  int* krow = reinterpret_cast<int*>(sc + Tp);
  const int tr = t[r];
  const bool none = tr < 0;                // every position masked
  const int n = (none || tr >= T) ? T : tr + 1;
  const int base = r - r % kb;
  const size_t hoff = (size_t)h * dh;

  const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)r * d + hoff);
  for (int j = lane; j < dh4; j += 32) reinterpret_cast<float4*>(qs)[j] = q4[j];
  __syncwarp();

  // scores: lanes over positions
  float m = -INFINITY;
  for (int tau = lane; tau < n; tau += 32) {
    const int kr = anc ? base + anc[(size_t)r * T + tau] : r;
    krow[tau] = kr;
    float s = MASKED;
    if (!none)
      s = dot4(reinterpret_cast<const float4*>(qs),
               reinterpret_cast<const float4*>(
                   cache_k + (size_t)kr * cache_row + (size_t)tau * d + hoff),
               dh4) /
          scale_div;
    sc[tau] = s;
    m = fmaxf(m, s);
  }
  m = warp_max(m);
  float z = 0.0f;
  for (int tau = lane; tau < n; tau += 32) {
    const float e = expf(sc[tau] - m);
    sc[tau] = e;
    z += e;
  }
  z = warp_sum(z);
  for (int tau = lane; tau < n; tau += 32) sc[tau] = sc[tau] / z;
  __syncwarp();

  // P.V past 128 columns: each lane owns the float4 columns lane,
  // lane + 32, ..., each summed over the positions in order
  if (dh4 > 32) {
    for (int c4 = lane; c4 < dh4; c4 += 32) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int tau = 0; tau < n; ++tau)
        acc = fma4(sc[tau],
                   reinterpret_cast<const float4*>(
                       cache_v + (size_t)krow[tau] * cache_row +
                       (size_t)tau * d + hoff)[c4],
                   acc);
      reinterpret_cast<float4*>(out + (size_t)r * d + hoff)[c4] = acc;
    }
    return;
  }
  // P.V: lp lanes over the dh4 float4 of a row, 32 / lp position groups
  int lp = 1;
  while (lp < dh4) lp <<= 1;
  const int c4 = lane & (lp - 1), g = lane / lp, groups = 32 / lp;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (c4 < dh4)
    for (int tau = g; tau < n; tau += groups)
      acc = fma4(sc[tau],
                 reinterpret_cast<const float4*>(
                     cache_v + (size_t)krow[tau] * cache_row +
                     (size_t)tau * d + hoff)[c4],
                 acc);
  for (int o = lp; o < 32; o <<= 1) {      // fixed order: same bits
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
  }
  if (g == 0 && c4 < dh4)
    reinterpret_cast<float4*>(out + (size_t)r * d + hoff)[c4] = acc;
}

// The self-attention of self_attn_kernel for the shapes it does not take:
// a cache longer than a warp's shared memory holds (about 3,400 slots at
// dh 512), rows off 16 bytes (V4 false: scalar loads) or a head too wide
// to stage whole beside 32 positions (past 7,200 columns). The positions
// run in chunks of tc with an online softmax (a running max and sum, the
// output rescaled when the max grows); a single chunk normalises its
// weights before P.V, as the reference does. A head past self_qcols(dh)
// columns stages q in column chunks: each chunk's partial q . k is added
// to the positions' scores before the softmax, and the value pass walks
// the columns a lane at a time as it does for any width.
//
// TYPED (with V4 false): the caches in their type (cbf: bf16, converting
// loads), the weights of a single chunk and the output rounded to dt
// (rnd: dt bf16), as JAX's `softmax(...).astype(dt)` and `out.astype(dt)`.
template <bool V4, bool TYPED = false>
__global__ void __launch_bounds__(ROW_WARPS * 32)
self_attn_kernel_chunked(const float* __restrict__ q, const void* cache_kv,
                 const void* cache_vv, const int* __restrict__ t,
                 const int* __restrict__ anc, float* __restrict__ out, int R,
                 int kb, int H, int dh, int d, int T, int tc,
                 size_t cache_row, float scale_div, bool cbf = false,
                 bool rnd = false) {
  const float* cache_k = static_cast<const float*>(cache_kv);
  const float* cache_v = static_cast<const float*>(cache_vv);
  extern __shared__ __align__(16) float sa_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * ROW_WARPS + warp;
  if (gw >= R * H) return;                 // no block barrier below
  const int r = gw / H, h = gw - r * H;
  const int dh4 = dh / 4;
  const int qc = self_qcols(dh);
  const bool whole_q = qc >= dh;           // q staged once
  float* qs = sa_smem + warp * self_warp_floats(qc, tc);
  float* sc = qs + round4(qc);
  int* krow = reinterpret_cast<int*>(sc + round4(tc));
  const int tr = t[r];
  const bool none = tr < 0;                // every position masked
  const int n = (none || tr >= T) ? T : tr + 1;
  const bool single = n <= tc;
  const int base = r - r % kb;
  const size_t hoff = (size_t)h * dh;
  float* orow = out + (size_t)r * d + hoff;

  // q's columns [q0, q0 + qn) into qs
  auto stage_q = [&](int q0, int qn) {
    const float* qr = q + (size_t)r * d + hoff + q0;
    if (V4) {
      for (int j = lane; j < qn / 4; j += 32)
        reinterpret_cast<float4*>(qs)[j] =
            reinterpret_cast<const float4*>(qr)[j];
    } else {
      for (int j = lane; j < qn; j += 32) qs[j] = qr[j];
    }
  };
  if (whole_q) stage_q(0, dh);
  __syncwarp();

  float M = -INFINITY, Z = 0.0f;           // running max and sum
  for (int c0 = 0; c0 < n; c0 += tc) {
    const int cn = min(tc, n - c0);
    // scores: lanes over positions, q . k summed over q's column chunks
    for (int i = lane; i < cn; i += 32)
      krow[i] = anc ? base + anc[(size_t)r * T + c0 + i] : r;
    for (int q0 = 0; q0 < dh; q0 += qc) {
      const int qn = min(qc, dh - q0);
      if (!whole_q) {
        __syncwarp();                      // the last chunk's q is read
        stage_q(q0, qn);
        __syncwarp();
      }
      for (int i = lane; i < cn; i += 32) {
        if (none) break;
        const size_t ko = (size_t)krow[i] * cache_row +
                          (size_t)(c0 + i) * d + hoff + q0;
        float part;
        if constexpr (TYPED) {
          part = 0.0f;
          for (int j = 0; j < qn; ++j)
            part = fmaf(qs[j], ldf(cache_kv, ko + j, cbf), part);
        } else {
          part = dot_row<V4>(qs, cache_k + ko, qn);
        }
        sc[i] = q0 == 0 ? part : sc[i] + part;
      }
    }
    float m = -INFINITY;
    for (int i = lane; i < cn; i += 32) {
      const float s = none ? MASKED : sc[i] / scale_div;
      sc[i] = s;
      m = fmaxf(m, s);
    }
    const float mn = fmaxf(M, warp_max(m));
    const float alpha = expf(M - mn);      // 0 on the first chunk
    float z = 0.0f;
    for (int i = lane; i < cn; i += 32) {
      const float e = expf(sc[i] - mn);
      sc[i] = e;
      z += e;
    }
    Z = Z * alpha + warp_sum(z);
    M = mn;
    if (single)
      for (int i = lane; i < cn; i += 32) sc[i] = rnd_if(sc[i] / Z, rnd);
    __syncwarp();
    // the chunk's P.V into the output row: written (one chunk), or added
    // to the rescaled running sum, by the lane that owns the column
    auto put = [&](float* o, float v) {
      *o = c0 == 0 ? rnd_if(v, rnd && single) : *o * alpha + v;
    };
    auto put4 = [&](float4* o, float4 v) {
      if (c0 > 0) {
        const float4 p = *o;
        v = make_float4(fmaf(p.x, alpha, v.x), fmaf(p.y, alpha, v.y),
                        fmaf(p.z, alpha, v.z), fmaf(p.w, alpha, v.w));
      }
      *o = v;
    };
    auto vrow = [&](int i) {
      return cache_v + (size_t)krow[i] * cache_row + (size_t)(c0 + i) * d +
             hoff;
    };
    if (!V4) {
      // lanes over columns, each summed over the positions in order
      for (int c = lane; c < dh; c += 32) {
        float acc = 0.0f;
        for (int i = 0; i < cn; ++i) {
          if constexpr (TYPED)
            acc = fmaf(sc[i],
                       ldf(cache_vv,
                           (size_t)krow[i] * cache_row +
                               (size_t)(c0 + i) * d + hoff + c,
                           cbf),
                       acc);
          else
            acc = fmaf(sc[i], vrow(i)[c], acc);
        }
        put(orow + c, acc);
      }
    } else if (dh4 > 32) {
      // past 128 columns: each lane owns the float4 columns lane,
      // lane + 32, ..., each summed over the positions in order
      for (int c4 = lane; c4 < dh4; c4 += 32) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int i = 0; i < cn; ++i)
          acc = fma4(sc[i], reinterpret_cast<const float4*>(vrow(i))[c4],
                     acc);
        put4(reinterpret_cast<float4*>(orow) + c4, acc);
      }
    } else {
      // lp lanes over the dh4 float4 of a row, 32 / lp position groups
      int lp = 1;
      while (lp < dh4) lp <<= 1;
      const int c4 = lane & (lp - 1), g = lane / lp, groups = 32 / lp;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c4 < dh4)
        for (int i = g; i < cn; i += groups)
          acc = fma4(sc[i], reinterpret_cast<const float4*>(vrow(i))[c4],
                     acc);
      for (int o = lp; o < 32; o <<= 1) {    // fixed order: same bits
        acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
        acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
        acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
        acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
      }
      if (g == 0 && c4 < dh4) put4(reinterpret_cast<float4*>(orow) + c4, acc);
    }
    __syncwarp();    // sc and krow are read before the next chunk
  }
  if (!single) {
    __syncwarp();
    for (int c = lane; c < dh; c += 32) orow[c] = rnd_if(orow[c] / Z, rnd);
  }
}

// The cross-attention's split: of the S slots, a cluster of cs blocks (a
// power of two, at most 8) of `chunk` slots each, about CROSS_SLICE a
// block; of an image's kb beams, qg groups of kq queries, a cluster each.
struct CrossSplit {
  int cs, chunk, qg, kq;
};

// A slice's partial result as rank 0 receives it: m and l [kb] each (the
// slice's max and sum, m then overwritten by the slice's weight in the
// combination), acc [kb][dh] (unnormalised P.V), p [kb][chunk] (the
// slice's exp(score - m), for want_attn)
__host__ __device__ inline long long cross_part_floats(long long kb, int dh,
                                                       long long chunk) {
  return round4(2 * kb) + kb * dh + round4(kb * chunk);
}

// Shared memory of a cross-attention block, in floats: Q [kb][dh+4],
// K [chunk][dh+4], V [chunk][dh], P [kb][chunk], and the cs partials rank 0
// receives.
inline long long cross_floats(long long kb, int dh, long long chunk, int cs) {
  return kb * (dh + 4) + chunk * (dh + 4) + chunk * dh + round4(kb * chunk) +
         cs * cross_part_floats(kb, dh, chunk);
}

// The slots split as above; the beams in one group where that fits a
// block's shared memory, else in the fewest groups (halving kq) that fit.
// Fewer slots a block would not help: the cs partials rank 0 receives grow
// with cs as the slice shrinks, while Q, P and the partials shrink with kq.
// At dh 256, S 196 and kb 32 one group needs 300 KB, two 195 KB.
inline CrossSplit cross_split(int S, int kb, int dh) {
  int cs = 1;
  while (cs < CROSS_MAX_CLUSTER && cs * CROSS_SLICE < S) cs *= 2;
  const int chunk = (S + cs - 1) / cs;
  int qg = 1, kq = kb;
  while (kq > 1 && cross_floats(kq, dh, chunk, cs) * 4 > MAX_SMEM) {
    qg *= 2;
    kq = (kb + qg - 1) / qg;
  }
  return CrossSplit{cs, chunk, (kb + kq - 1) / kq, kq};
}

// Cross-attention of one decode step. Block (rank, h, b * qg + g) of a
// cluster of cs blocks along x serves query rows [g*kq, g*kq + kq) of image
// b's kb for head h over slots [rank*chunk, rank*chunk + chunk) of S.
// Each block writes its partial (max, sum, unnormalised P.V) into rank 0's
// shared memory, once a split barrier shows that rank 0 has started, and
// leaves after a second cluster barrier; rank 0 combines the slices in rank
// order. q2 and out are [R, d]; ck/cv [B, S, d]; mask [B, S]. With
// attn_h != null the softmax weights go to attn_h [R, H, S].
__global__ void __launch_bounds__(CROSS_THREADS)
cross_attn_kernel(const float* __restrict__ q2, const float* __restrict__ ck,
                  const float* __restrict__ cv, const float* __restrict__ mask,
                  float* __restrict__ out, float* __restrict__ attn_h, int kb,
                  int H, int dh, int d, int S, int chunk, int qg, int kq,
                  float scale_div) {
  extern __shared__ __align__(16) float ca_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z / qg;
  // this group's kn queries, rows row0 .. row0 + kn - 1 of q2 and out; the
  // shared layout is for kq of them (the last group may hold fewer)
  const int q0 = (blockIdx.z - b * qg) * kq, kn = min(kb - q0, kq);
  const size_t row0 = (size_t)b * kb + q0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = rank * chunk;
  const int ns = max(0, min(S, s0 + chunk) - s0);
  const int LD = dh + 4, dh4 = dh / 4;
  const int part = (int)cross_part_floats(kq, dh, chunk);
  float* Qs = ca_smem;                        // [kq][LD]
  float* Ks = Qs + kq * LD;                   // [chunk][LD]
  float* Vs = Ks + chunk * LD;                // [chunk][dh]
  float* Ps = Vs + chunk * dh;                // [kq][chunk]
  float* rcv = Ps + round4(kq * chunk);       // [cs] partials (rank 0's)
  // this block's partial, in rank 0's shared memory
  float* mine = cluster.map_shared_rank(rcv, 0) + rank * part;
  float *m_out = mine, *l_out = mine + kq, *acc_out = mine + round4(2 * kq),
        *p_out = acc_out + kq * dh;
  const size_t hoff = (size_t)h * dh;

  for (int e = tid; e < kn * dh4; e += CROSS_THREADS) {
    const int k = e / dh4, c = (e - k * dh4) * 4;
    uic_decode::dg_cp16(Qs + k * LD + c, q2 + (row0 + k) * d + hoff + c,
                        true);
  }
  for (int e = tid; e < ns * dh4; e += CROSS_THREADS) {
    const int s = e / dh4, c = (e - s * dh4) * 4;
    uic_decode::dg_cp16(Ks + s * LD + c,
                        ck + ((size_t)b * S + s0 + s) * d + hoff + c, true);
  }
  uic_decode::dg_commit();
  // V lands while the scores and the softmax run
  for (int e = tid; e < ns * dh4; e += CROSS_THREADS) {
    const int s = e / dh4, c = (e - s * dh4) * 4;
    uic_decode::dg_cp16(Vs + s * dh + c,
                        cv + ((size_t)b * S + s0 + s) * d + hoff + c, true);
  }
  uic_decode::dg_commit();
  // rank 0 must have started before a partial lands in its shared memory:
  // arrive now, wait after the scores, while the copies are in flight
  if (cs > 1) cluster_arrive_relaxed();
  uic_decode::dg_wait<1>();
  __syncthreads();

  // scores of the slice
  for (int e = tid; e < kn * ns; e += CROSS_THREADS) {
    const int k = e / ns, s = e - k * ns;
    const float dot = dot4(reinterpret_cast<const float4*>(Qs + k * LD),
                           reinterpret_cast<const float4*>(Ks + s * LD), dh4);
    Ps[k * chunk + s] =
        mask[(size_t)b * S + s0 + s] > 0.0f ? dot / scale_div : MASKED;
  }
  __syncthreads();
  if (cs > 1) cluster_wait();
  // the slice's softmax statistics, a warp per query
  for (int k = warp; k < kn; k += CROSS_THREADS / 32) {
    float* p = Ps + k * chunk;
    float m = -INFINITY;
    for (int s = lane; s < ns; s += 32) m = fmaxf(m, p[s]);
    m = warp_max(m);
    float l = 0.0f;
    for (int s = lane; s < ns; s += 32) {
      const float e = expf(p[s] - m);
      p[s] = e;
      if (attn_h) p_out[k * chunk + s] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_out[k] = m;
      l_out[k] = l;
    }
  }
  uic_decode::dg_wait<0>();
  __syncthreads();
  // the slice's unnormalised P.V
  for (int e = tid; e < kn * dh4; e += CROSS_THREADS) {
    const int k = e / dh4, c = (e - k * dh4) * 4;
    const float* p = Ps + k * chunk;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int s = 0; s < ns; ++s)
      acc = fma4(p[s], *reinterpret_cast<const float4*>(Vs + s * dh + c), acc);
    *reinterpret_cast<float4*>(acc_out + k * dh + c) = acc;
  }
  // every partial has reached rank 0; the other ranks are done
  if (cs > 1)
    cluster.sync();
  else
    __syncthreads();
  if (rank != 0) return;

  // per query M = max m_r, L = sum exp(m_r - M) l_r over the slices in
  // rank order; slice r's weight exp(m_r - M) / L replaces m_r
  for (int k = tid; k < kn; k += CROSS_THREADS) {
    float M = -INFINITY;
    for (int src = 0; src < cs; ++src) M = fmaxf(M, rcv[src * part + k]);
    float L = 0.0f;
    for (int src = 0; src < cs; ++src)
      L += expf(rcv[src * part + k] - M) * rcv[src * part + kq + k];
    for (int src = 0; src < cs; ++src)
      rcv[src * part + k] = expf(rcv[src * part + k] - M) / L;
  }
  __syncthreads();
  for (int e = tid; e < kn * dh4; e += CROSS_THREADS) {
    const int k = e / dh4, c = (e - k * dh4) * 4;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int src = 0; src < cs; ++src)          // fixed order: same bits
      acc = fma4(rcv[src * part + k],
                 *reinterpret_cast<const float4*>(
                     rcv + src * part + round4(2 * kq) + k * dh + c),
                 acc);
    *reinterpret_cast<float4*>(out + (row0 + k) * d + hoff + c) = acc;
  }
  if (attn_h)
    for (int e = tid; e < kn * S; e += CROSS_THREADS) {
      const int k = e / S, s = e - k * S, src = s / chunk;
      const float* pr = rcv + src * part + round4(2 * kq) + kq * dh;
      attn_h[((row0 + k) * H + h) * S + s] =
          pr[k * chunk + s - src * chunk] * rcv[src * part + k];
    }
}

// attn[r, s] = (sum over h, in order, of attn_h[r, h, s]) / H
__global__ void head_mean_kernel(const float* __restrict__ attn_h,
                                 float* __restrict__ attn, int R, int H,
                                 int S) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= R * S) return;
  const int r = e / S, s = e - r * S;
  float acc = 0.0f;
  for (int h = 0; h < H; ++h) acc += attn_h[((size_t)r * H + h) * S + s];
  attn[e] = acc / (float)H;
}

// The split of cross_attn_kernel_pieces, which takes the shapes
// cross_attn_kernel does not (a slice whose K and V, or a head whose query
// rows, would not fit a block's shared memory, or rows off 16 bytes): the
// same clusters and query groups, each block walking its chunk in pieces of
// `sub` slots.
struct PieceSplit {
  int cs, chunk, sub, qg, kq;
};

// A slice's partial result as rank 0 of cross_attn_kernel_pieces receives
// it: m and l [kb] each and acc [kb][dh, padded to 4] (unnormalised P.V)
__host__ __device__ inline long long piece_part_floats(long long kb, int dh) {
  return round4(2 * kb) + kb * round4(dh);
}

// Shared memory of a cross_attn_kernel_pieces block, in floats: Q
// [kb][LD], K [sub][LD], V [sub][dh padded], P [kb][sub], the running max,
// sum and rescale factor [kb] each, and the cs partials rank 0 receives
// (LD = dh padded to 4, plus 4).
inline long long piece_floats(long long kb, int dh, long long sub, int cs) {
  const long long ld = round4(dh) + 4;
  return kb * ld + sub * ld + sub * round4(dh) + round4(kb * sub) +
         3 * round4(kb) + cs * piece_part_floats(kb, dh);
}

// The slots split as cross_split splits them; the beams in the fewest
// groups (halving kq) that fit, and past one query a group, the slice
// walked in pieces (halving sub).
inline PieceSplit piece_split(int S, int kb, int dh) {
  int cs = 1;
  while (cs < CROSS_MAX_CLUSTER && cs * CROSS_SLICE < S) cs *= 2;
  const int chunk = (S + cs - 1) / cs;
  int qg = 1, kq = kb, sub = chunk;
  while (kq > 1 && piece_floats(kq, dh, sub, cs) * 4 > MAX_SMEM) {
    qg *= 2;
    kq = (kb + qg - 1) / qg;
  }
  while (sub > 1 && piece_floats(kq, dh, sub, cs) * 4 > MAX_SMEM)
    sub = (sub + 1) / 2;
  return PieceSplit{cs, chunk, sub, (kb + kq - 1) / kq, kq};
}

// cross_attn_kernel in pieces: block (rank, h, b * qg + g) walks its slots
// in pieces of `sub` with an online softmax (a running max and sum, the
// partial P.V rescaled when the max grows). With attn_h != null
// ([R, H, S + 2]) each block writes its slots' scores there and rank 0
// each row's max and sum (the last two floats), which
// head_mean_kernel_scores turns into weights. V4: dh and d multiples of 4;
// else scalar loads.
template <bool V4>
__global__ void __launch_bounds__(CROSS_THREADS)
cross_attn_kernel_pieces(const float* __restrict__ q2, const float* __restrict__ ck,
                  const float* __restrict__ cv, const float* __restrict__ mask,
                  float* __restrict__ out, float* __restrict__ attn_h, int kb,
                  int H, int dh, int d, int S, int chunk, int sub, int qg,
                  int kq, float scale_div) {
  extern __shared__ __align__(16) float ca_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z / qg;
  // this group's kn queries, rows row0 .. row0 + kn - 1 of q2 and out; the
  // shared layout is for kq of them (the last group may hold fewer)
  const int q0 = (blockIdx.z - b * qg) * kq, kn = min(kb - q0, kq);
  const size_t row0 = (size_t)b * kb + q0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = rank * chunk;
  const int ns = max(0, min(S, s0 + chunk) - s0);
  const int DV = (int)round4(dh), LD = DV + 4, dh4 = dh / 4;
  const int part = (int)piece_part_floats(kq, dh);
  float* Qs = ca_smem;                        // [kq][LD]
  float* Ks = Qs + kq * LD;                   // [sub][LD]
  float* Vs = Ks + sub * LD;                  // [sub][DV]
  float* Ps = Vs + sub * DV;                  // [kq][sub]
  float* run_m = Ps + round4(kq * sub);       // [kq] each
  float* run_l = run_m + round4(kq);
  float* scl = run_l + round4(kq);
  float* rcv = scl + round4(kq);              // [cs] partials (rank 0's)
  // this block's partial, in rank 0's shared memory
  float* mine = cluster.map_shared_rank(rcv, 0) + rank * part;
  float *m_out = mine, *l_out = mine + kq, *acc_out = mine + round4(2 * kq);
  const size_t hoff = (size_t)h * dh;
  const size_t a_row = (size_t)S + 2;         // an attn_h row

  // rows [r0, r0 + n) of src ([., d], head h's columns) into dst [n][ld]
  auto load_rows = [&](float* dst, int ld, const float* src, int n) {
    if (V4) {
      for (int e = tid; e < n * dh4; e += CROSS_THREADS) {
        const int k = e / dh4, c = (e - k * dh4) * 4;
        uic_decode::dg_cp16(dst + k * ld + c, src + (size_t)k * d + hoff + c,
                            true);
      }
    } else {
      for (int e = tid; e < n * dh; e += CROSS_THREADS) {
        const int k = e / dh, c = e - k * dh;
        uic_decode::dg_cp4(dst + k * ld + c, src + (size_t)k * d + hoff + c,
                           true);
      }
    }
  };

  load_rows(Qs, LD, q2 + row0 * d, kn);
  for (int k = tid; k < kq; k += CROSS_THREADS) {
    run_m[k] = -INFINITY;
    run_l[k] = 0.0f;
  }
  // rank 0 must have started before a partial lands in its shared memory:
  // arrive now, wait after the first piece's scores, while its copies are
  // in flight
  if (cs > 1) cluster_arrive_relaxed();
  bool waited = cs == 1;
  for (int p0 = 0; p0 < ns; p0 += sub) {
    const int np = min(sub, ns - p0);
    const size_t slot0 = (size_t)b * S + s0 + p0;
    if (p0 > 0) __syncthreads();      // the last piece's K, V, P are read
    load_rows(Ks, LD, ck + slot0 * d, np);
    uic_decode::dg_commit();
    // V lands while the scores and the softmax run
    load_rows(Vs, DV, cv + slot0 * d, np);
    uic_decode::dg_commit();
    uic_decode::dg_wait<1>();
    __syncthreads();

    // scores of the piece
    for (int e = tid; e < kn * np; e += CROSS_THREADS) {
      const int k = e / np, s = e - k * np;
      const float dot = dot_row<V4>(Qs + k * LD, Ks + s * LD, dh);
      const float v =
          mask[slot0 + s] > 0.0f ? dot / scale_div : MASKED;
      Ps[k * sub + s] = v;
      if (attn_h) attn_h[((row0 + k) * H + h) * a_row + s0 + p0 + s] = v;
    }
    __syncthreads();
    if (!waited) {
      cluster_wait();
      waited = true;
    }
    // the running softmax statistics, a warp per query
    for (int k = warp; k < kn; k += CROSS_THREADS / 32) {
      float* p = Ps + k * sub;
      float m = -INFINITY;
      for (int s = lane; s < np; s += 32) m = fmaxf(m, p[s]);
      const float mo = run_m[k], mn = fmaxf(mo, warp_max(m));
      float l = 0.0f;
      for (int s = lane; s < np; s += 32) {
        const float e = expf(p[s] - mn);
        p[s] = e;
        l += e;
      }
      l = warp_sum(l);
      if (lane == 0) {
        const float a = expf(mo - mn);   // 0 on the first piece
        scl[k] = a;
        run_l[k] = run_l[k] * a + l;
        run_m[k] = mn;
      }
    }
    uic_decode::dg_wait<0>();
    __syncthreads();
    // the piece's unnormalised P.V, added to the rescaled running sum
    if (V4) {
      for (int e = tid; e < kn * dh4; e += CROSS_THREADS) {
        const int k = e / dh4, c = (e - k * dh4) * 4;
        const float* p = Ps + k * sub;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
        for (int s = 0; s < np; ++s)
          acc = fma4(p[s], *reinterpret_cast<const float4*>(Vs + s * DV + c),
                     acc);
        float4* o = reinterpret_cast<float4*>(acc_out + k * DV + c);
        if (p0 > 0) {
          const float4 w = *o;
          const float a = scl[k];
          acc = make_float4(fmaf(w.x, a, acc.x), fmaf(w.y, a, acc.y),
                            fmaf(w.z, a, acc.z), fmaf(w.w, a, acc.w));
        }
        *o = acc;
      }
    } else {
      for (int e = tid; e < kn * dh; e += CROSS_THREADS) {
        const int k = e / dh, c = e - k * dh;
        const float* p = Ps + k * sub;
        float acc = 0.0f;
        for (int s = 0; s < np; ++s) acc = fmaf(p[s], Vs[s * DV + c], acc);
        float* o = acc_out + k * DV + c;
        *o = p0 > 0 ? fmaf(*o, scl[k], acc) : acc;
      }
    }
  }
  if (!waited) cluster_wait();
  if (ns == 0)          // no slots: an empty partial
    for (int e = tid; e < kn * DV; e += CROSS_THREADS) acc_out[e] = 0.0f;
  __syncthreads();
  for (int k = tid; k < kn; k += CROSS_THREADS) {
    m_out[k] = run_m[k];
    l_out[k] = run_l[k];
  }
  // every partial has reached rank 0; the other ranks are done
  if (cs > 1)
    cluster.sync();
  else
    __syncthreads();
  if (rank != 0) return;

  // per query M = max m_r, L = sum exp(m_r - M) l_r over the slices in
  // rank order; slice r's weight exp(m_r - M) / L replaces m_r
  for (int k = tid; k < kn; k += CROSS_THREADS) {
    float M = -INFINITY;
    for (int src = 0; src < cs; ++src) M = fmaxf(M, rcv[src * part + k]);
    float L = 0.0f;
    for (int src = 0; src < cs; ++src)
      L += expf(rcv[src * part + k] - M) * rcv[src * part + kq + k];
    for (int src = 0; src < cs; ++src)
      rcv[src * part + k] = expf(rcv[src * part + k] - M) / L;
    if (attn_h) {
      float* st = attn_h + ((row0 + k) * H + h) * a_row + S;
      st[0] = M;
      st[1] = L;
    }
  }
  __syncthreads();
  if (V4) {
    for (int e = tid; e < kn * dh4; e += CROSS_THREADS) {
      const int k = e / dh4, c = (e - k * dh4) * 4;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int src = 0; src < cs; ++src)          // fixed order: same bits
        acc = fma4(rcv[src * part + k],
                   *reinterpret_cast<const float4*>(
                       rcv + src * part + round4(2 * kq) + k * DV + c),
                   acc);
      *reinterpret_cast<float4*>(out + (row0 + k) * d + hoff + c) = acc;
    }
  } else {
    for (int e = tid; e < kn * dh; e += CROSS_THREADS) {
      const int k = e / dh, c = e - k * dh;
      float acc = 0.0f;
      for (int src = 0; src < cs; ++src)          // fixed order: same bits
        acc = fmaf(rcv[src * part + k],
                   rcv[src * part + round4(2 * kq) + k * DV + c], acc);
      out[(row0 + k) * d + hoff + c] = acc;
    }
  }
}

// attn[r, s] = (sum over h, in order, of exp(score - M) / L) / H, from the
// scores and each (row, head)'s max M and sum L in attn_h [R, H, S + 2]
// (cross_attn_kernel_pieces)
__global__ void head_mean_kernel_scores(const float* __restrict__ attn_h,
                                 float* __restrict__ attn, int R, int H,
                                 int S) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= R * S) return;
  const int r = e / S, s = e - r * S;
  float acc = 0.0f;
  for (int h = 0; h < H; ++h) {
    const float* row = attn_h + ((size_t)r * H + h) * (S + 2);
    acc += expf(row[s] - row[S]) / row[S + 1];
  }
  attn[e] = acc / (float)H;
}

// The cross-attention of a head too wide for cross_attn_kernel_pieces
// (one query and one slot of it past a block's shared memory: dh past
// about 5,000 at S > 448, 14,000 at S <= 64). Block (r, h) serves query row
// r alone over its image's S slots, in pieces of WIDE_SUB, with no cluster,
// so the running P.V lives in the output row itself:
//   1. scores: q's columns staged WIDE_QCOLS at a time in shared memory, a
//      warp a slot, lanes over the chunk's columns; each chunk's partial
//      q . k is added to the slot's score before the softmax;
//   2. the piece's max and sum (warps combined in order) update the
//      running ones;
//   3. the value pass, a thread a column (float4 where V4), chunk by
//      chunk of the head's columns: the piece's P.V written, or added to
//      the rescaled running sum; a single piece normalises its weights
//      first, as the reference does, more pieces divide at the end.
// With attn_h != null ([R, H, S + 2]) it writes the scores and the row's
// max and sum, as cross_attn_kernel_pieces does.
constexpr int WIDE_QCOLS = 4096;
constexpr int WIDE_SUB = 4096;

//
// TYPED (with V4 false): the memory's K / V in their type (mbf: bf16,
// converting loads), the weights of a single piece and the output rounded
// to dt (rnd), as JAX's `wgt32.astype(dt)` and `out2.astype(dt)`; the
// scores for the head mean stay f32.
template <bool V4, bool TYPED = false>
__global__ void __launch_bounds__(CROSS_THREADS)
cross_attn_kernel_wide(const float* __restrict__ q2,
                       const void* __restrict__ ckv,
                       const void* __restrict__ cvv,
                       const float* __restrict__ mask, float* __restrict__ out,
                       float* __restrict__ attn_h, int kb, int H, int dh,
                       int d, int S, float scale_div, bool mbf = false,
                       bool rnd = false) {
  const float* ck = static_cast<const float*>(ckv);
  const float* cv = static_cast<const float*>(cvv);
  constexpr int NW = CROSS_THREADS / 32;
  __shared__ __align__(16) float qs[WIDE_QCOLS];
  __shared__ float ps[WIDE_SUB];
  __shared__ float red[NW];
  const int r = blockIdx.x, h = blockIdx.y, b = r / kb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t hoff = (size_t)h * dh;
  const float* qr = q2 + (size_t)r * d + hoff;
  float* orow = out + (size_t)r * d + hoff;
  float* arow = attn_h ? attn_h + ((size_t)r * H + h) * (S + 2) : nullptr;
  const bool single = S <= WIDE_SUB;
  float M = -INFINITY, Z = 0.0f;            // running max and sum

  // the block's max (op: fmaxf) or sum of v, warps in order
  auto block_reduce = [&](float v, bool is_max) {
    v = is_max ? warp_max(v) : warp_sum(v);
    __syncthreads();                        // red is free
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float a = red[0];
    for (int w = 1; w < NW; ++w) a = is_max ? fmaxf(a, red[w]) : a + red[w];
    return a;
  };

  for (int p0 = 0; p0 < S; p0 += WIDE_SUB) {
    const int np = min(WIDE_SUB, S - p0);
    const size_t slot0 = (size_t)b * S + p0;
    // 1. scores over q's column chunks
    for (int q0 = 0; q0 < dh; q0 += WIDE_QCOLS) {
      const int qn = min(WIDE_QCOLS, dh - q0);
      __syncthreads();                      // qs and ps are free
      for (int j = tid; j < qn; j += CROSS_THREADS) qs[j] = qr[q0 + j];
      __syncthreads();
      for (int s = warp; s < np; s += NW) {
        const size_t ko = (slot0 + s) * d + hoff + q0;
        const float* kr = ck + ko;
        float part = 0.0f;
        if constexpr (TYPED) {
          for (int j = lane; j < qn; j += 32)
            part = fmaf(qs[j], ldf(ckv, ko + j, mbf), part);
        } else if (V4) {
          for (int j = lane; j < qn / 4; j += 32) {
            const float4 a = reinterpret_cast<const float4*>(qs)[j];
            const float4 k = reinterpret_cast<const float4*>(kr)[j];
            part = fmaf(a.x, k.x, part);
            part = fmaf(a.y, k.y, part);
            part = fmaf(a.z, k.z, part);
            part = fmaf(a.w, k.w, part);
          }
        } else {
          for (int j = lane; j < qn; j += 32) part = fmaf(qs[j], kr[j], part);
        }
        part = warp_sum(part);
        if (lane == 0) ps[s] = q0 == 0 ? part : ps[s] + part;
      }
    }
    __syncthreads();
    // 2. the piece's softmax terms and the running max and sum
    float m = -INFINITY;
    for (int s = tid; s < np; s += CROSS_THREADS) {
      const float v = mask[slot0 + s] > 0.0f ? ps[s] / scale_div : MASKED;
      ps[s] = v;
      if (arow) arow[p0 + s] = v;
      m = fmaxf(m, v);
    }
    const float mn = fmaxf(M, block_reduce(m, true));
    const float alpha = expf(M - mn);       // 0 on the first piece
    float l = 0.0f;
    for (int s = tid; s < np; s += CROSS_THREADS) {
      const float e = expf(ps[s] - mn);
      ps[s] = e;
      l += e;
    }
    Z = Z * alpha + block_reduce(l, false);
    M = mn;
    if (single)
      for (int s = tid; s < np; s += CROSS_THREADS)
        ps[s] = rnd_if(ps[s] / Z, rnd);
    __syncthreads();
    // 3. the piece's P.V, a thread a column, into the output row
    const float* vr = cv + slot0 * d + hoff;
    if (V4) {
      for (int c4 = tid; c4 < dh / 4; c4 += CROSS_THREADS) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int s = 0; s < np; ++s)
          acc = fma4(ps[s],
                     reinterpret_cast<const float4*>(vr + (size_t)s * d)[c4],
                     acc);
        float4* o = reinterpret_cast<float4*>(orow) + c4;
        if (p0 > 0) {
          const float4 w = *o;
          acc = make_float4(fmaf(w.x, alpha, acc.x), fmaf(w.y, alpha, acc.y),
                            fmaf(w.z, alpha, acc.z), fmaf(w.w, alpha, acc.w));
        }
        *o = acc;
      }
    } else {
      for (int c = tid; c < dh; c += CROSS_THREADS) {
        float acc = 0.0f;
        for (int s = 0; s < np; ++s) {
          if constexpr (TYPED)
            acc = fmaf(ps[s], ldf(cvv, (slot0 + s) * d + hoff + c, mbf),
                       acc);
          else
            acc = fmaf(ps[s], vr[(size_t)s * d + c], acc);
        }
        orow[c] = p0 > 0 ? fmaf(orow[c], alpha, acc)
                         : rnd_if(acc, rnd && single);
      }
    }
  }
  if (!single)
    for (int c = tid; c < dh; c += CROSS_THREADS)
      orow[c] = rnd_if(orow[c] / Z, rnd);
  if (arow && tid == 0) {
    arow[S] = M;
    arow[S + 1] = Z;
  }
}

// whether a head of width dh is past cross_attn_kernel_pieces: one query
// and one slot of it do not fit a block's shared memory
inline bool cross_wide(int S, int kb, int dh) {
  const PieceSplit sp = piece_split(S, kb, dh);
  return piece_floats(sp.kq, dh, sp.sub, sp.cs) * 4 > MAX_SMEM;
}

// the dynamic shared memory a launch needs past 48 KB, opted into on the
// current device before the launch
template <typename K>
int smem_opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the 18 packed weights of one layer, in WKEYS order
struct Layer {
  const float *ln1_s, *ln1_b, *wqkv, *bqkv, *wo_s, *bo_s, *ln2_s, *ln2_b,
      *wq_c, *bq_c, *wo_c, *bo_c, *ln3_s, *ln3_b, *w1, *b1, *w2, *b2;
};

// element i of an array of f32 (esize 4) or bf16 (esize 2) elements
inline const float* elt(const void* p, size_t i, int esize) {
  return reinterpret_cast<const float*>(static_cast<const char*>(p) +
                                        i * esize);
}

// layer `l` of a stack packed as [L, ...] per key (l = 0 for one layer),
// the weights' elements of esize bytes (a bf16 layer's pointers are only
// handed on to the typed kernels, which read them as bf16)
Layer layer_of(const void* const* w, int l, int d, int dff, int esize = 4) {
  const size_t dd = (size_t)d * d, ld = (size_t)l * d;
  auto at = [&](int k, size_t i) { return elt(w[k], i, esize); };
  Layer y;
  y.ln1_s = at(0, ld);
  y.ln1_b = at(1, ld);
  y.wqkv = at(2, l * 3 * dd);
  y.bqkv = at(3, 3 * ld);
  y.wo_s = at(4, l * dd);
  y.bo_s = at(5, ld);
  y.ln2_s = at(6, ld);
  y.ln2_b = at(7, ld);
  y.wq_c = at(8, l * dd);
  y.bq_c = at(9, ld);
  y.wo_c = at(10, l * dd);
  y.bo_c = at(11, ld);
  y.ln3_s = at(12, ld);
  y.ln3_b = at(13, ld);
  y.w1 = at(14, (size_t)l * d * dff);
  y.b1 = at(15, (size_t)l * dff);
  y.w2 = at(16, (size_t)l * dff * d);
  y.b2 = at(17, ld);
  return y;
}

// Whether the kernels refuse d in H heads: only where d does not split into
// H heads, as the JAX package's head split requires
// (unpaired_image_captioning_tpu/ops/transformer_decode.py:298, a reshape
// of d into H heads). Every other shape runs: widths that are not
// multiples of 4 take the scalar instances, a long cache or a head past
// 7,200 columns the self-attention in chunks (of positions, of q's
// columns), many source slots the cross-attention in pieces and a head
// past what pieces take cross_attn_kernel_wide.
bool refuses(int d, int H) { return H <= 0 || d % H; }

// the launch of a cluster kernel: grid, blocks of `threads`, `smem` bytes,
// clusters of cs along x
template <typename K, typename... Args>
int launch_clusters(K kernel, dim3 grid, int threads, size_t smem, int cs,
                    cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  return err ? err : (int)cudaGetLastError();
}

struct Step {
  float* x;                  // [R, d] residual stream, updated in place
                             // (in dt: bf16 where fl has TFD_X_BF)
  const int* t;              // [R]
  const int* anc;            // [R, T] or null
  const float* mask;         // [B, S]
  float *q, *att, *h1;       // scratch [R, d], [R, d] (also y), [R, dff]
  float* attn_h;             // scratch [R, H, S] or null
  float* attn;               // [R, S] or null
  int R, B, S, d, T, dff, H;
  int fl;                    // TFD_* types; 0: every array f32
};

int ln_rows(const float* x, float* x_copy, const float* scale,
            const float* offset, float* y, int R, int d, cudaStream_t st) {
  const unsigned blocks = (R + ROW_WARPS - 1) / ROW_WARPS;
  if (d % 4 == 0)
    ln_rows_kernel<true><<<blocks, ROW_WARPS * 32, 0, st>>>(
        x, x_copy, scale, offset, y, R, d);
  else
    ln_rows_kernel<false><<<blocks, ROW_WARPS * 32, 0, st>>>(
        x, x_copy, scale, offset, y, R, d);
  return (int)cudaGetLastError();
}

// One layer; x_in != null: layer 0 reads x_in and copies it to s.x.
int run_layer(const Step& s, const Layer& w, const float* ck, const float* cv,
              float* cache_k, float* cache_v, size_t cache_row, bool last,
              const float* x_in, cudaStream_t st) {
  const int R = s.R, d = s.d, kb = s.R / s.B, dh = s.d / s.H;
  const float scale_div = (float)sqrt((double)dh);
  // 16-byte rows for the attentions (the products and LN choose their own)
  const bool v4 = dh % 4 == 0 && d % 4 == 0 && cache_row % 4 == 0 &&
                  ((size_t)s.q | (size_t)s.att | (size_t)ck | (size_t)cv |
                   (size_t)cache_k | (size_t)cache_v) % 16 == 0;
  float* y = s.att;
  int err;

  // 1-2. LN1 -> packed QKV; q out, k_t / v_t into cache slot t
  if ((err = ln_rows(x_in ? x_in : s.x, x_in ? s.x : nullptr, w.ln1_s,
                     w.ln1_b, y, R, d, st)))
    return err;
  if ((err = decode_gemm(y, d, w.wqkv, R, 3 * d, d,
                         EpiQkv{w.bqkv, s.q, cache_k, cache_v, s.t,
                                cache_row, d, s.T},
                         st)))
    return err;

  // 3. self-attention (every position at once where a warp's shared
  // memory holds them, else in chunks)
  {
    const int tc = self_chunk(dh, s.T);
    const bool whole = v4 && tc == s.T;
    const size_t smem =
        (size_t)ROW_WARPS * sizeof(float) *
        (whole ? self_warp_floats(dh, tc)
               : self_warp_floats(self_qcols(dh), tc));
    const int blocks = (R * s.H + ROW_WARPS - 1) / ROW_WARPS;
    if (whole) {
      if ((err = smem_opt_in(self_attn_kernel, smem))) return err;
      self_attn_kernel<<<blocks, ROW_WARPS * 32, smem, st>>>(
          s.q, cache_k, cache_v, s.t, s.anc, s.att, R, kb, s.H, dh, d, s.T,
          cache_row, scale_div);
    } else if (v4) {
      if ((err = smem_opt_in(self_attn_kernel_chunked<true>, smem)))
        return err;
      self_attn_kernel_chunked<true><<<blocks, ROW_WARPS * 32, smem, st>>>(
          s.q, cache_k, cache_v, s.t, s.anc, s.att, R, kb, s.H, dh, d, s.T,
          tc, cache_row, scale_div);
    } else {
      if ((err = smem_opt_in(self_attn_kernel_chunked<false>, smem)))
        return err;
      self_attn_kernel_chunked<false><<<blocks, ROW_WARPS * 32, smem, st>>>(
          s.q, cache_k, cache_v, s.t, s.anc, s.att, R, kb, s.H, dh, d, s.T,
          tc, cache_row, scale_div);
    }
    if ((err = (int)cudaGetLastError())) return err;
  }

  // 4. x += att @ Wo_s + bo_s
  if ((err = decode_gemm(s.att, d, w.wo_s, R, d, d, EpiRes{w.bo_s, s.x, d},
                         st)))
    return err;

  // 5-6. q2 = LN2(x) @ Wq_c + bq_c
  if ((err = ln_rows(s.x, nullptr, w.ln2_s, w.ln2_b, y, R, d, st)))
    return err;
  if ((err = decode_gemm(y, d, w.wq_c, R, d, d, EpiBias{w.bq_c, s.q, d},
                         st)))
    return err;

  // 7. cross-attention over the image's unexpanded K/V: each block's
  // slice at once where its shared memory holds it, else in pieces, and a
  // head too wide for pieces a row at a time
  {
    float* attn_h = last ? s.attn_h : nullptr;
    const CrossSplit sp = cross_split(s.S, kb, dh);
    const size_t whole =
        (size_t)cross_floats(sp.kq, dh, sp.chunk, sp.cs) * sizeof(float);
    if (v4 && whole <= (size_t)MAX_SMEM) {
      if ((err = smem_opt_in(cross_attn_kernel, whole))) return err;
      if ((err = launch_clusters(cross_attn_kernel,
                                 dim3(sp.cs, s.H, s.B * sp.qg),
                                 CROSS_THREADS, whole, sp.cs, st,
                                 (const float*)s.q, ck, cv, s.mask, s.att,
                                 attn_h, kb, s.H, dh, d, s.S, sp.chunk,
                                 sp.qg, sp.kq, scale_div)))
        return err;
      if (attn_h) {
        const int n = R * s.S;
        head_mean_kernel<<<(n + 255) / 256, 256, 0, st>>>(attn_h, s.attn, R,
                                                          s.H, s.S);
        if ((err = (int)cudaGetLastError())) return err;
      }
    } else {
      if (cross_wide(s.S, kb, dh)) {
        auto kernel = v4 ? cross_attn_kernel_wide<true>
                         : cross_attn_kernel_wide<false>;
        kernel<<<dim3(R, s.H), CROSS_THREADS, 0, st>>>(
            s.q, ck, cv, s.mask, s.att, attn_h, kb, s.H, dh, d, s.S,
            scale_div, false, false);
        if ((err = (int)cudaGetLastError())) return err;
      } else {
        const PieceSplit pp = piece_split(s.S, kb, dh);
        const size_t smem =
            (size_t)piece_floats(pp.kq, dh, pp.sub, pp.cs) * sizeof(float);
        auto kernel = v4 ? cross_attn_kernel_pieces<true>
                         : cross_attn_kernel_pieces<false>;
        if ((err = smem_opt_in(kernel, smem))) return err;
        if ((err = launch_clusters(kernel, dim3(pp.cs, s.H, s.B * pp.qg),
                                   CROSS_THREADS, smem, pp.cs, st,
                                   (const float*)s.q, ck, cv, s.mask, s.att,
                                   attn_h, kb, s.H, dh, d, s.S, pp.chunk,
                                   pp.sub, pp.qg, pp.kq, scale_div)))
          return err;
      }
      if (attn_h) {
        const int n = R * s.S;
        head_mean_kernel_scores<<<(n + 255) / 256, 256, 0, st>>>(
            attn_h, s.attn, R, s.H, s.S);
        if ((err = (int)cudaGetLastError())) return err;
      }
    }
  }

  // 8. x += att @ Wo_c + bo_c
  if ((err = decode_gemm(s.att, d, w.wo_c, R, d, d, EpiRes{w.bo_c, s.x, d},
                         st)))
    return err;

  // 9-10. h1 = relu(LN3(x) @ W1 + b1)
  if ((err = ln_rows(s.x, nullptr, w.ln3_s, w.ln3_b, y, R, d, st)))
    return err;
  if ((err = decode_gemm(y, d, w.w1, R, s.dff, d, EpiRelu{w.b1, s.h1, s.dff},
                         st)))
    return err;

  // 11. x += h1 @ W2 + b2
  return decode_gemm(s.h1, s.dff, w.w2, R, d, s.dff, EpiRes{w.b2, s.x, d},
                     st);
}

// One layer of a step whose operands are not all f32 (s.fl): the same
// eleven launches on the typed instances. The LN, the products' bf16 W
// tiles, the epilogues and both attentions read each operand in its type
// and keep JAX's cast points (TFD_* above); q, att (y) and h1 stay f32
// scratch holding dt values. The attentions run their scalar instances
// (self_attn_kernel_chunked and cross_attn_kernel_wide, a row and head a
// block), which take every shape: simple, not fast.
int run_layer_typed(const Step& s, const Layer& w, const void* ck,
                    const void* cv, void* cache_k, void* cache_v,
                    size_t cache_row, bool last, const void* x_in,
                    cudaStream_t st) {
  const int R = s.R, d = s.d, kb = s.R / s.B, dh = s.d / s.H;
  const float scale_div = (float)sqrt((double)dh);
  const bool xbf = s.fl & TFD_X_BF, wbf = s.fl & TFD_W_BF;
  const bool cbf = s.fl & TFD_C_BF, mbf = s.fl & TFD_M_BF;
  float* y = s.att;
  const unsigned ln_blocks = (R + ROW_WARPS - 1) / ROW_WARPS;
  int err;
  auto ln = [&](const void* x, void* copy, const float* sc, const float* of) {
    ln_rows_typed_kernel<<<ln_blocks, ROW_WARPS * 32, 0, st>>>(
        x, copy, sc, of, y, R, d, xbf, wbf);
    return (int)cudaGetLastError();
  };

  // 1-2. LN1 -> packed QKV; q out, k_t / v_t into cache slot t
  if ((err = ln(x_in ? x_in : s.x, x_in ? s.x : nullptr, w.ln1_s, w.ln1_b)))
    return err;
  if ((err = decode_gemm(y, d, w.wqkv, R, 3 * d, d,
                         EpiQkvT{w.bqkv, s.q, cache_k, cache_v, s.t,
                                 cache_row, d, s.T, wbf, cbf, xbf},
                         st, 2, wbf)))
    return err;

  // 3. self-attention, in chunks of positions
  {
    const int tc = self_chunk(dh, s.T);
    const size_t smem = (size_t)ROW_WARPS * sizeof(float) *
                        self_warp_floats(self_qcols(dh), tc);
    const int blocks = (R * s.H + ROW_WARPS - 1) / ROW_WARPS;
    auto kernel = self_attn_kernel_chunked<false, true>;
    if ((err = smem_opt_in(kernel, smem))) return err;
    kernel<<<blocks, ROW_WARPS * 32, smem, st>>>(
        s.q, cache_k, cache_v, s.t, s.anc, s.att, R, kb, s.H, dh, d, s.T, tc,
        cache_row, scale_div, cbf, xbf);
    if ((err = (int)cudaGetLastError())) return err;
  }

  // 4. x += att @ Wo_s + bo_s
  if ((err = decode_gemm(s.att, d, w.wo_s, R, d, d,
                         EpiResT{w.bo_s, s.x, d, wbf, xbf}, st, 2, wbf)))
    return err;

  // 5-6. q2 = LN2(x) @ Wq_c + bq_c
  if ((err = ln(s.x, nullptr, w.ln2_s, w.ln2_b))) return err;
  if ((err = decode_gemm(y, d, w.wq_c, R, d, d,
                         EpiLinT{w.bq_c, s.q, d, wbf, xbf, false}, st, 2,
                         wbf)))
    return err;

  // 7. cross-attention over the image's unexpanded K/V, a row and head a
  // block
  {
    float* attn_h = last ? s.attn_h : nullptr;
    cross_attn_kernel_wide<false, true><<<dim3(R, s.H), CROSS_THREADS, 0,
                                          st>>>(
        s.q, ck, cv, s.mask, s.att, attn_h, kb, s.H, dh, d, s.S, scale_div,
        mbf, xbf);
    if ((err = (int)cudaGetLastError())) return err;
    if (attn_h) {
      const int n = R * s.S;
      head_mean_kernel_scores<<<(n + 255) / 256, 256, 0, st>>>(
          attn_h, s.attn, R, s.H, s.S);
      if ((err = (int)cudaGetLastError())) return err;
    }
  }

  // 8. x += att @ Wo_c + bo_c
  if ((err = decode_gemm(s.att, d, w.wo_c, R, d, d,
                         EpiResT{w.bo_c, s.x, d, wbf, xbf}, st, 2, wbf)))
    return err;

  // 9-10. h1 = relu(LN3(x) @ W1 + b1)
  if ((err = ln(s.x, nullptr, w.ln3_s, w.ln3_b))) return err;
  if ((err = decode_gemm(y, d, w.w1, R, s.dff, d,
                         EpiLinT{w.b1, s.h1, s.dff, wbf, xbf, true}, st, 2,
                         wbf)))
    return err;

  // 11. x += h1 @ W2 + b2
  return decode_gemm(s.h1, s.dff, w.w2, R, d, s.dff,
                     EpiResT{w.b2, s.x, d, wbf, xbf}, st, 2, wbf);
}

}  // namespace

// One decode step through all L layers. x_in [R, d] is read, x_out [R, d]
// receives the result; t [R] int32; ck/cv [L, B, S, d]; mask [B, S] f32;
// cache_k/v [R, L, T, d], slot t[r] of every layer written in place; anc
// [R, T] int32 or null; w: host array of the 18 packed [L, ...] weights in
// WKEYS order; scratch q, att [R, d], h1 [R, dff]; with attn != null,
// attn_h [R, H, S + 2] scratch and attn [R, S] receive the last layer's
// mean-head cross-attention weights. fl: the TFD_* types of x (x_in and
// x_out), the weights, the caches and ck / cv; 0 runs the f32 kernels
// above. Returns the first CUDA error, or cudaErrorInvalidValue for a shape
// the kernels do not take (refuses).
extern "C" int tfd_stack_step_mixed(const void* x_in, void* x_out,
                                    const int* t, const void* ck,
                                    const void* cv, const float* mask,
                                    void* cache_k, void* cache_v,
                                    const int* anc, const void* const* w,
                                    float* q, float* att, float* h1,
                                    float* attn_h, float* attn, int R, int B,
                                    int S, int d, int T, int dff, int H,
                                    int L, int fl, cudaStream_t stream) {
  if (R <= 0) return (int)cudaGetLastError();
  if (B <= 0 || R % B || refuses(d, H))
    return (int)cudaErrorInvalidValue;
  const Step s = {static_cast<float*>(x_out), t, anc, mask, q, att, h1,
                  attn_h, attn, R, B, S, d, T, dff, H, fl};
  const int cs = fl & TFD_C_BF ? 2 : 4, ms = fl & TFD_M_BF ? 2 : 4;
  const size_t cache_row = (size_t)L * T * d;
  const size_t kv_layer = (size_t)B * S * d;
  for (int l = 0; l < L; ++l) {
    const Layer lw = layer_of(w, l, d, dff, fl & TFD_W_BF ? 2 : 4);
    const void* ckl = elt(ck, l * kv_layer, ms);
    const void* cvl = elt(cv, l * kv_layer, ms);
    void* kl = const_cast<float*>(elt(cache_k, (size_t)l * T * d, cs));
    void* vl = const_cast<float*>(elt(cache_v, (size_t)l * T * d, cs));
    const bool last = attn != nullptr && l == L - 1;
    const void* xi = l == 0 ? x_in : nullptr;
    const int err =
        fl ? run_layer_typed(s, lw, ckl, cvl, kl, vl, cache_row, last, xi,
                             stream)
           : run_layer(s, lw, static_cast<const float*>(ckl),
                       static_cast<const float*>(cvl),
                       static_cast<float*>(kl), static_cast<float*>(vl),
                       cache_row, last, static_cast<const float*>(xi),
                       stream);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

// One decode step through one layer: as above with L = 1, ck/cv [B, S, d],
// cache_k/v [R, T, d], w the 18 packed weights of the layer, no lazy cache
// and no attention output.
extern "C" int tfd_layer_step_mixed(const void* x_in, void* x_out,
                                    const int* t, const void* ck,
                                    const void* cv, const float* mask,
                                    void* cache_k, void* cache_v,
                                    const void* const* w, float* q,
                                    float* att, float* h1, int R, int B,
                                    int S, int d, int T, int dff, int H,
                                    int fl, cudaStream_t stream) {
  if (R <= 0) return (int)cudaGetLastError();
  if (B <= 0 || R % B || refuses(d, H))
    return (int)cudaErrorInvalidValue;
  const Step s = {static_cast<float*>(x_out), t, nullptr, mask, q, att, h1,
                  nullptr, nullptr, R, B, S, d, T, dff, H, fl};
  const Layer lw = layer_of(w, 0, d, dff, fl & TFD_W_BF ? 2 : 4);
  const int err =
      fl ? run_layer_typed(s, lw, ck, cv, cache_k, cache_v, (size_t)T * d,
                           false, x_in, stream)
         : run_layer(s, lw, static_cast<const float*>(ck),
                     static_cast<const float*>(cv),
                     static_cast<float*>(cache_k),
                     static_cast<float*>(cache_v), (size_t)T * d, false,
                     static_cast<const float*>(x_in), stream);
  if (err) return err;
  return (int)cudaGetLastError();
}
