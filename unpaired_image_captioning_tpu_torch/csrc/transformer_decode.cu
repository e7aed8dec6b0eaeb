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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "decode_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

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

// y = LN(x) row by row, a warp per row, the row's mean and deviation taken
// once (two passes, as the reference, over the row held in registers: at
// most LN_REG float4 a lane, d <= 512; a longer row is read again from
// memory); with x_copy != null the row is also copied there (layer 0's
// x_in -> x_out).
constexpr int LN_REG = 4;

__global__ void __launch_bounds__(ROW_WARPS * 32)
ln_rows_kernel(const float* __restrict__ x, float* __restrict__ x_copy,
               const float* __restrict__ scale,
               const float* __restrict__ offset, float* __restrict__ y, int R,
               int d) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
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

// floats of shared memory a self-attention warp keeps: q [dh], scores and
// physical rows [T each, padded to 4]
__host__ __device__ inline long long self_warp_floats(int dh, int T) {
  return dh + 2 * round4(T);
}

// Self-attention of one decode step: warp (r, h) attends with row r's query
// over the positions tau <= t[r] of its cache (or, lazily, of the rows anc
// names). q and out are [R, d]; the caches hold row r's slot tau of this
// layer at cache + r * cache_row + tau * d. dh % 4 == 0, dh <= 256.
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

// 0 if the kernels take a step of kb beams an image, width d in H heads,
// d_ff, S source slots and T cache slots; else the first limit it breaks:
// 1 the head width d / H (a multiple of 4 for 16-byte rows, at most 256),
// 2 d_ff (a multiple of 4), 3 the self-attention's shared memory, 4 the
// cross-attention's (a block of one query over its slice). smem (or null)
// receives the two attentions' bytes.
int refuses(int kb, int d, int dff, int H, int S, int T, long long* smem) {
  if (H <= 0 || d % H) return 1;
  const int dh = d / H;
  const CrossSplit sp = cross_split(S, kb, dh);
  const long long self_b = ROW_WARPS * self_warp_floats(dh, T) * 4;
  const long long cross_b = cross_floats(sp.kq, dh, sp.chunk, sp.cs) * 4;
  if (smem) {
    smem[0] = self_b;
    smem[1] = cross_b;
  }
  if (dh % 4 || dh > 256) return 1;
  if (dff % 4) return 2;
  if (self_b > MAX_SMEM) return 3;
  if (cross_b > MAX_SMEM) return 4;
  return 0;
}

struct Step {
  float* x;                  // [R, d] residual stream, updated in place
  const int* t;              // [R]
  const int* anc;            // [R, T] or null
  const float* mask;         // [B, S]
  float *q, *att, *h1;       // scratch [R, d], [R, d] (also y), [R, dff]
  float* attn_h;             // scratch [R, H, S] or null
  float* attn;               // [R, S] or null
  int R, B, S, d, T, dff, H;
};

int ln_rows(const float* x, float* x_copy, const float* scale,
            const float* offset, float* y, int R, int d, cudaStream_t st) {
  ln_rows_kernel<<<(R + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, st>>>(
      x, x_copy, scale, offset, y, R, d);
  return (int)cudaGetLastError();
}

// One layer; x_in != null: layer 0 reads x_in and copies it to s.x.
int run_layer(const Step& s, const Layer& w, const float* ck, const float* cv,
              float* cache_k, float* cache_v, size_t cache_row, bool last,
              const float* x_in, cudaStream_t st) {
  const int R = s.R, d = s.d, kb = s.R / s.B, dh = s.d / s.H;
  const float scale_div = (float)sqrt((double)dh);
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

  // 3. self-attention
  {
    const size_t smem =
        (size_t)ROW_WARPS * self_warp_floats(dh, s.T) * sizeof(float);
    if ((err = smem_opt_in(self_attn_kernel, smem))) return err;
    const int warps = R * s.H;
    self_attn_kernel<<<(warps + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32,
                       smem, st>>>(s.q, cache_k, cache_v, s.t, s.anc, s.att,
                                   R, kb, s.H, dh, d, s.T, cache_row,
                                   scale_div);
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

  // 7. cross-attention over the image's unexpanded K/V
  {
    const CrossSplit sp = cross_split(s.S, kb, dh);
    const size_t smem =
        (size_t)cross_floats(sp.kq, dh, sp.chunk, sp.cs) * sizeof(float);
    if ((err = smem_opt_in(cross_attn_kernel, smem))) return err;
    float* attn_h = last ? s.attn_h : nullptr;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(sp.cs, s.H, s.B * sp.qg);
    cfg.blockDim = dim3(CROSS_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = sp.cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if ((err = (int)cudaLaunchKernelEx(&cfg, cross_attn_kernel,
                                       (const float*)s.q, ck, cv, s.mask,
                                       s.att, attn_h, kb, s.H, dh, d, s.S,
                                       sp.chunk, sp.qg, sp.kq, scale_div)))
      return err;
    if ((err = (int)cudaGetLastError())) return err;
    if (attn_h) {
      const int n = R * s.S;
      head_mean_kernel<<<(n + 255) / 256, 256, 0, st>>>(attn_h, s.attn, R,
                                                        s.H, s.S);
      if ((err = (int)cudaGetLastError())) return err;
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

}  // namespace

// The shape check of the two entries below, for the wrapper to name the
// limit a shape breaks (see refuses); smem int64 [2] or null.
extern "C" int tfd_refuses(int kb, int d, int dff, int H, int S, int T,
                           long long* smem) {
  return refuses(kb, d, dff, H, S, T, smem);
}

// One decode step through all L layers. x_in [R, d] is read, x_out [R, d]
// receives the result; t [R] int32; ck/cv [L, B, S, d]; mask [B, S] f32;
// cache_k/v [R, L, T, d], slot t[r] of every layer written in place; anc
// [R, T] int32 or null; w: host array of the 18 packed [L, ...] weights in
// WKEYS order; scratch q, att [R, d], h1 [R, dff]; with attn != null,
// attn_h [R, H, S] scratch and attn [R, S] receive the last layer's
// mean-head cross-attention weights. Returns the first CUDA error, or
// cudaErrorInvalidValue for a shape the kernels do not take (tfd_refuses).
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
  if (B <= 0 || R % B || refuses(R / B, d, dff, H, S, T, nullptr))
    return (int)cudaErrorInvalidValue;
  const Step s = {x_out, t, anc, mask, q, att, h1, attn_h, attn,
                  R, B, S, d, T, dff, H};
  const size_t cache_row = (size_t)L * T * d;
  const size_t kv_layer = (size_t)B * S * d;
  for (int l = 0; l < L; ++l) {
    const int err = run_layer(
        s, layer_of(w, l, d, dff), ck + l * kv_layer, cv + l * kv_layer,
        cache_k + (size_t)l * T * d, cache_v + (size_t)l * T * d, cache_row,
        attn != nullptr && l == L - 1, l == 0 ? x_in : nullptr, stream);
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
  if (B <= 0 || R % B || refuses(R / B, d, dff, H, S, T, nullptr))
    return (int)cudaErrorInvalidValue;
  const Step s = {x_out, t, nullptr, mask, q, att, h1, nullptr, nullptr,
                  R, B, S, d, T, dff, H};
  const int err = run_layer(s, layer_of(w, 0, d, dff), ck, cv, cache_k,
                            cache_v, (size_t)T * d, false, x_in, stream);
  if (err) return err;
  return (int)cudaGetLastError();
}
