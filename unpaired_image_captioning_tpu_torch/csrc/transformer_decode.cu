// Transformer decoder step, f32: the Hopper counterpart of the TPU kernels
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
// LN is the reference's: unbiased (n-1) variance, eps 1e-6 outside the
// sqrt. Masked scores are -1e9, softmax in f32, scale 1/sqrt(dh). In the
// lazy-cache mode (anc != null) position tau of row r is read from physical
// row image*kb + anc[r, tau]. Products are plain f32 FMA on the CUDA cores:
// no TF32, no tensor cores, no library call.
//
// Design. The TPU kernel keeps a layer's weights in VMEM and runs the
// whole layer in one program per block of images. A Hopper block cannot
// hold a 12.6 MB layer (d 512, d_ff 2048) in its 227 KB of shared memory,
// so each layer is a fixed sequence of short kernels, all launched from one
// C call per decode step (`tfd_stack_step_f32` loops over the L layers):
//
//   1. gemm<LN, QKV>: LN1 computed in the GEMM's prologue (each block takes
//      the mean and the deviation of its own rows, then normalises A tiles
//      as it loads them), epilogue writes q and scatters k_t/v_t into slot
//      t[r] of the cache, in place;
//   2. self_attn: one warp per (row, head), lanes over dh; scores over the
//      row's positions tau <= t[r] in shared memory; masked positions are
//      skipped, which is exact: exp(-1e9 - max) is 0 in f32;
//   3. gemm<-, RES>: x += att @ Wo_s + bo_s, residual added in place;
//   4. gemm<LN, BIAS>: q2 = LN2(x) @ Wq_c + bq_c;
//   5. cross_attn: one block per (image, head); the image's [S, dh] K and V
//      of that head are loaded into shared memory once for all kb beams,
//      which is the point of the TPU design's unexpanded cross memory;
//      with want_attn the per-head weights go to [R, H, S] scratch and
//      head_mean sums them over heads in a fixed order (deterministic: the
//      NMT's UNK replacement takes their argmax);
//   6. gemm<-, RES>: x += att @ Wo_c + bo_c;
//   7. gemm<LN, RELU>: h1 = relu(LN3(x) @ W1 + b1);
//   8. gemm<-, RES>: x += h1 @ W2 + b2.
//
// The GEMM is gemm.cuh's (the LSTM cell's tiling: BK = 32 deep K tiles,
// double buffered in shared memory, a 4 x 4 register tile per thread, a
// 64 x 64, 32 x 64 or 32 x 32 block tile so that the grid covers the SMs),
// with the epilogues below.
//
// What bounds it. Per layer and row the step does 4 d^2 + 2 d d_ff
// multiply-adds of projections against T d + S d of attention; at the NMT's
// R = 750 (d 512, d_ff 2048) that is 33 GFLOP a step for 6 layers, so the
// f32 FMA rate (67 TFLOP/s) bounds it. At small R (the captioner's 250
// rows, or a short micro-batch) each weight byte feeds only R/2 FLOPs and
// the weight stream (about 44 MB a step for the NMT stack) plus the 8
// launches a layer (9 with the attention mean) bound it instead.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gemm.cuh"

namespace {

using uic::EpiBias;
using uic::EpiRelu;
using uic::EpiRes;
using uic::GemmArgs;

constexpr float MASKED = -1e9f;  // the reference's masked score
constexpr int ATTN_WARPS = 8;    // warps per self-attention block

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

// The packed LN1 -> QKV projection's epilogue: q (columns [0, d)) to
// q [M, d]; k_t / v_t into slot t[r] of row r's cache, in place. A float4
// of columns never straddles q | k | v (d % 4 == 0).
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
};

// a GEMM over all M rows of [M, K] x [K, N] row-major
GemmArgs gemm_args(const float* a, const float* w, int M, int N, int K,
                   const float* ln_s = nullptr, const float* ln_b = nullptr) {
  return GemmArgs{a, w, ln_s, ln_b, K, N, M, N, K, K};
}

// Self-attention of one decode step: warp (r, h) attends with row r's query
// over the positions tau <= t[r] of its cache (or, lazily, of the rows anc
// names). q and out are [R, d]; the caches hold row r's slot tau of this
// layer at cache + r * cache_row + tau * d. Shared memory: ATTN_WARPS * T
// scores. NQ * 32 >= dh.
template <int NQ>
__global__ void __launch_bounds__(ATTN_WARPS * 32)
self_attn_kernel(const float* __restrict__ q, const float* cache_k,
                 const float* cache_v, const int* __restrict__ t,
                 const int* __restrict__ anc, float* __restrict__ out, int R,
                 int kb, int H, int dh, int d, int T, size_t cache_row,
                 float scale_div) {
  extern __shared__ float sc_all[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * ATTN_WARPS + warp;
  if (gw >= R * H) return;                 // no block barrier below
  const int r = gw / H, h = gw - r * H;
  float* sc = sc_all + warp * T;
  const int tr = t[r];
  const int n = tr < 0 ? 0 : (tr >= T ? T : tr + 1);   // valid positions
  const int base = r - r % kb;
  const size_t hoff = (size_t)h * dh;

  float qv[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const int i = lane + 32 * j;
    qv[j] = i < dh ? q[(size_t)r * d + hoff + i] : 0.0f;
  }
  for (int tau = 0; tau < n; ++tau) {
    const int krow = anc ? base + anc[(size_t)r * T + tau] : r;
    const float* kp = cache_k + (size_t)krow * cache_row + (size_t)tau * d + hoff;
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int i = lane + 32 * j;
      if (i < dh) part = fmaf(qv[j], kp[i], part);
    }
    part = warp_sum(part);
    if (lane == 0) sc[tau] = part / scale_div;
  }
  __syncwarp();
  float m = -INFINITY;
  for (int tau = lane; tau < n; tau += 32) m = fmaxf(m, sc[tau]);
  m = warp_max(m);
  float z = 0.0f;
  for (int tau = lane; tau < n; tau += 32) {
    const float e = expf(sc[tau] - m);
    sc[tau] = e;
    z += e;
  }
  z = warp_sum(z);
  __syncwarp();
  float acc[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) acc[j] = 0.0f;
  for (int tau = 0; tau < n; ++tau) {
    const int krow = anc ? base + anc[(size_t)r * T + tau] : r;
    const float* vp = cache_v + (size_t)krow * cache_row + (size_t)tau * d + hoff;
    const float wgt = sc[tau] / z;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int i = lane + 32 * j;
      if (i < dh) acc[j] = fmaf(wgt, vp[i], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const int i = lane + 32 * j;
    if (i < dh) out[(size_t)r * d + hoff + i] = acc[j];
  }
}

// Cross-attention of one decode step: block (b, h) reads image b's K/V of
// head h ([S, dh] each, from ck/cv [B, S, d]) into shared memory once and
// serves the kb query rows of that image. q2 and out are [R, d]; mask is
// [B, S]. With attn_h != null the softmax weights go to attn_h [R, H, S].
// Shared memory: S*(dh+1) + S*dh + kb*dh + kb*S floats.
__global__ void __launch_bounds__(128)
cross_attn_kernel(const float* __restrict__ q2, const float* __restrict__ ck,
                  const float* __restrict__ cv, const float* __restrict__ mask,
                  float* __restrict__ out, float* __restrict__ attn_h, int kb,
                  int H, int dh, int d, int S, float scale_div) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int KLD = dh + 1;                  // odd row stride: no bank conflicts
  float* Ks = sm;                          // [S][dh + 1]
  float* Vs = Ks + (size_t)S * KLD;        // [S][dh]
  float* Qs = Vs + (size_t)S * dh;         // [kb][dh]
  float* Pw = Qs + (size_t)kb * dh;        // [kb][S]
  const size_t hoff = (size_t)h * dh;

  for (int e = tid; e < S * dh; e += nthr) {
    const int s = e / dh, i = e - s * dh;
    const size_t g = ((size_t)b * S + s) * d + hoff + i;
    Ks[s * KLD + i] = ck[g];
    Vs[e] = cv[g];
  }
  for (int e = tid; e < kb * dh; e += nthr) {
    const int k = e / dh, i = e - k * dh;
    Qs[e] = q2[((size_t)b * kb + k) * d + hoff + i];
  }
  __syncthreads();
  for (int e = tid; e < kb * S; e += nthr) {
    const int k = e / S, s = e - k * S;
    float acc = 0.0f;
    for (int i = 0; i < dh; ++i) acc = fmaf(Qs[k * dh + i], Ks[s * KLD + i], acc);
    Pw[e] = mask[(size_t)b * S + s] > 0.0f ? acc / scale_div : MASKED;
  }
  __syncthreads();
  for (int k = warp; k < kb; k += nwarps) {
    float* p = Pw + k * S;
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, p[s]);
    m = warp_max(m);
    float z = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(p[s] - m);
      p[s] = e;
      z += e;
    }
    z = warp_sum(z);
    __syncwarp();
    float* ah = attn_h ? attn_h + (((size_t)b * kb + k) * H + h) * S : nullptr;
    for (int s = lane; s < S; s += 32) {
      const float wgt = p[s] / z;
      p[s] = wgt;
      if (ah) ah[s] = wgt;
    }
  }
  __syncthreads();
  for (int e = tid; e < kb * dh; e += nthr) {
    const int k = e / dh, i = e - k * dh;
    const float* p = Pw + k * S;
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc = fmaf(p[s], Vs[s * dh + i], acc);
    out[((size_t)b * kb + k) * d + hoff + i] = acc;
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

int g_cross_smem_set = 0;      // dynamic shared memory opted in for cross_attn

// the 18 packed weights of one layer, in WKEYS order
struct Layer {
  const float *ln1_s, *ln1_b, *wqkv, *bqkv, *wo_s, *bo_s, *ln2_s, *ln2_b,
      *wq_c, *bq_c, *wo_c, *bo_c, *ln3_s, *ln3_b, *w1, *b1, *w2, *b2;
};

// layer `l` of a stack packed as [L, ...] per key (l = 0 for one layer)
Layer layer_of(const float* const* w, int l, int d, int dff) {
  const size_t dd = (size_t)d * d, ld = (size_t)l * d;
  Layer y;
  y.ln1_s = w[0] + ld;
  y.ln1_b = w[1] + ld;
  y.wqkv = w[2] + l * 3 * dd;
  y.bqkv = w[3] + 3 * ld;
  y.wo_s = w[4] + l * dd;
  y.bo_s = w[5] + ld;
  y.ln2_s = w[6] + ld;
  y.ln2_b = w[7] + ld;
  y.wq_c = w[8] + l * dd;
  y.bq_c = w[9] + ld;
  y.wo_c = w[10] + l * dd;
  y.bo_c = w[11] + ld;
  y.ln3_s = w[12] + ld;
  y.ln3_b = w[13] + ld;
  y.w1 = w[14] + (size_t)l * d * dff;
  y.b1 = w[15] + (size_t)l * dff;
  y.w2 = w[16] + (size_t)l * dff * d;
  y.b2 = w[17] + ld;
  return y;
}

struct Step {
  float* x;                  // [R, d] residual stream, updated in place
  const int* t;              // [R]
  const int* anc;            // [R, T] or null
  const float* mask;         // [B, S]
  float *q, *att, *h1;       // scratch [R, d], [R, d], [R, dff]
  float* attn_h;             // scratch [R, H, S] or null
  float* attn;               // [R, S] or null
  int R, B, S, d, T, dff, H;
};

int run_layer(const Step& s, const Layer& w, const float* ck, const float* cv,
              float* cache_k, float* cache_v, size_t cache_row, bool last,
              cudaStream_t st) {
  const int kb = s.R / s.B, dh = s.d / s.H;
  const float scale_div = (float)sqrt((double)dh);
  int err;

  const int R = s.R, d = s.d;
  // 1. LN1 -> packed QKV; q out, k_t / v_t into cache slot t
  if ((err = uic::gemm<true, false, false>(
           gemm_args(s.x, w.wqkv, R, 3 * d, d, w.ln1_s, w.ln1_b),
           EpiQkv{w.bqkv, s.q, cache_k, cache_v, s.t, cache_row, d, s.T},
           st)))
    return err;

  // 2. self-attention
  {
    const int warps = s.R * s.H;
    const dim3 grid((warps + ATTN_WARPS - 1) / ATTN_WARPS);
    const size_t smem = (size_t)ATTN_WARPS * s.T * sizeof(float);
    if (dh <= 32)
      self_attn_kernel<1><<<grid, ATTN_WARPS * 32, smem, st>>>(
          s.q, cache_k, cache_v, s.t, s.anc, s.att, s.R, kb, s.H, dh, s.d,
          s.T, cache_row, scale_div);
    else if (dh <= 64)
      self_attn_kernel<2><<<grid, ATTN_WARPS * 32, smem, st>>>(
          s.q, cache_k, cache_v, s.t, s.anc, s.att, s.R, kb, s.H, dh, s.d,
          s.T, cache_row, scale_div);
    else if (dh <= 128)
      self_attn_kernel<4><<<grid, ATTN_WARPS * 32, smem, st>>>(
          s.q, cache_k, cache_v, s.t, s.anc, s.att, s.R, kb, s.H, dh, s.d,
          s.T, cache_row, scale_div);
    else
      return (int)cudaErrorInvalidValue;
    if ((err = (int)cudaGetLastError())) return err;
  }

  // 3. x += att @ Wo_s + bo_s
  if ((err = uic::gemm<false, false, false>(gemm_args(s.att, w.wo_s, R, d, d),
                                            EpiRes{w.bo_s, s.x, d}, st)))
    return err;

  // 4. q2 = LN2(x) @ Wq_c + bq_c
  if ((err = uic::gemm<true, false, false>(
           gemm_args(s.x, w.wq_c, R, d, d, w.ln2_s, w.ln2_b),
           EpiBias{w.bq_c, s.q, d}, st)))
    return err;

  // 5. cross-attention over the image's unexpanded K/V
  {
    const size_t smem = ((size_t)s.S * (dh + 1) + (size_t)s.S * dh +
                         (size_t)kb * dh + (size_t)kb * s.S) * sizeof(float);
    if (smem > 48 * 1024 && (int)smem > g_cross_smem_set) {
      if ((err = (int)cudaFuncSetAttribute(
               cross_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
               (int)smem)))
        return err;
      g_cross_smem_set = (int)smem;
    }
    float* attn_h = last ? s.attn_h : nullptr;
    cross_attn_kernel<<<dim3(s.B, s.H), 128, smem, st>>>(
        s.q, ck, cv, s.mask, s.att, attn_h, kb, s.H, dh, s.d, s.S, scale_div);
    if ((err = (int)cudaGetLastError())) return err;
    if (attn_h) {
      const int n = s.R * s.S;
      head_mean_kernel<<<(n + 255) / 256, 256, 0, st>>>(attn_h, s.attn, s.R,
                                                        s.H, s.S);
      if ((err = (int)cudaGetLastError())) return err;
    }
  }

  // 6. x += att @ Wo_c + bo_c
  if ((err = uic::gemm<false, false, false>(gemm_args(s.att, w.wo_c, R, d, d),
                                            EpiRes{w.bo_c, s.x, d}, st)))
    return err;

  // 7. h1 = relu(LN3(x) @ W1 + b1)
  if ((err = uic::gemm<true, false, false>(
           gemm_args(s.x, w.w1, R, s.dff, d, w.ln3_s, w.ln3_b),
           EpiRelu{w.b1, s.h1, s.dff}, st)))
    return err;

  // 8. x += h1 @ W2 + b2
  return uic::gemm<false, false, false>(gemm_args(s.h1, w.w2, R, d, s.dff),
                                        EpiRes{w.b2, s.x, d}, st);
}

int prepare(const float* x_in, float* x_out, int R, int d, cudaStream_t st) {
  return (int)cudaMemcpyAsync(x_out, x_in, (size_t)R * d * sizeof(float),
                              cudaMemcpyDeviceToDevice, st);
}

}  // namespace

// One decode step through all L layers. x_in [R, d] is read, x_out [R, d]
// receives the result; t [R] int32; ck/cv [L, B, S, d]; mask [B, S] f32;
// cache_k/v [R, L, T, d], slot t[r] of every layer written in place; anc
// [R, T] int32 or null; w: host array of the 18 packed [L, ...] weights in
// WKEYS order; scratch q, att [R, d], h1 [R, dff]; with attn != null,
// attn_h [R, H, S] scratch and attn [R, S] receive the last layer's
// mean-head cross-attention weights. Returns the first CUDA error.
extern "C" int tfd_stack_step_f32(const float* x_in, float* x_out,
                                  const int* t, const float* ck,
                                  const float* cv, const float* mask,
                                  float* cache_k, float* cache_v,
                                  const int* anc, const float* const* w,
                                  float* q, float* att, float* h1,
                                  float* attn_h, float* attn, int R, int B,
                                  int S, int d, int T, int dff, int H, int L,
                                  cudaStream_t stream) {
  if (R <= 0) return (int)cudaGetLastError();
  int err = prepare(x_in, x_out, R, d, stream);
  if (err) return err;
  const Step s = {x_out, t, anc, mask, q, att, h1, attn_h, attn,
                  R, B, S, d, T, dff, H};
  const size_t cache_row = (size_t)L * T * d;
  const size_t kv_layer = (size_t)B * S * d;
  for (int l = 0; l < L; ++l) {
    err = run_layer(s, layer_of(w, l, d, dff), ck + l * kv_layer,
                    cv + l * kv_layer, cache_k + (size_t)l * T * d,
                    cache_v + (size_t)l * T * d, cache_row,
                    attn != nullptr && l == L - 1, stream);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

// One decode step through one layer: as above with L = 1, ck/cv [B, S, d],
// cache_k/v [R, T, d], w the 18 packed weights of the layer, no lazy cache
// and no attention output.
extern "C" int tfd_layer_step_f32(const float* x_in, float* x_out,
                                  const int* t, const float* ck,
                                  const float* cv, const float* mask,
                                  float* cache_k, float* cache_v,
                                  const float* const* w, float* q, float* att,
                                  float* h1, int R, int B, int S, int d,
                                  int T, int dff, int H,
                                  cudaStream_t stream) {
  if (R <= 0) return (int)cudaGetLastError();
  int err = prepare(x_in, x_out, R, d, stream);
  if (err) return err;
  const Step s = {x_out, t, nullptr, mask, q, att, h1, nullptr, nullptr,
                  R, B, S, d, T, dff, H};
  err = run_layer(s, layer_of(w, 0, d, dff), ck, cv, cache_k, cache_v,
                  (size_t)T * d, false, stream);
  if (err) return err;
  return (int)cudaGetLastError();
}
