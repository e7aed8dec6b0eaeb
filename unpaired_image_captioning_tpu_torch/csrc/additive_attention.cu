// Additive attention: the Hopper counterpart of the three TPU kernels of
// unpaired_image_captioning_tpu/ops/attention.py:
//
//   _fused_attention_kernel        one query per image   (additive_attention_mixed, K = 1)
//   _fused_attention_beams_kernel  K beam queries        (additive_attention_mixed, any K)
//   _att_lstm_att_kernel           att1 -> lstm1 -> att2 (att_lstm_att_mixed)
//
// For image b and query k (q [B, K, A], alpha [A], mask [B, N]):
//
//   s[n] = sum_a alpha[a] * tanh(p_att[b, n, a] + q[b, k, a])   (no alpha bias)
//   w    = exp(s - max_n s) * mask[b];   w /= max(sum_n w, 1e-9)
//   out[b, k, :] = sum_n w[n] * emb[b, n, :]
//
// The mask multiplies after the softmax and the row is renormalised, as the
// reference does (a row whose mask is all zeros gives zeros); tanh is the
// precise tanhf. The plain versions are in ops/attention.py.
//
// Types. As the TPU kernels read each operand in its own type and compute in
// f32: the memories p_att and emb are each f32 or bf16 (template flags of
// the kernel: they are read in its loops), and the queries, alpha and the
// mask each f32 or bf16 (flags of the launch: they are converted as they
// land in shared memory, or read once a slot). Every sum is the f32 core
// below; the output is stored in its own type (emb's for the attentions,
// f32 for att1 inside the decode step), rounded to nearest even where it is
// bf16 (bf16.cuh).
//
// What bounds it. At B 50, N 196, A = D = 512 the attention memory p_att and
// emb is 40.1 MB (12 us at 3.35 TB/s), and the B K N A tanh evaluations
// take the card's special-function units (16 a clock on each of 132 SMs) at
// least 25 M / 4.2 T/s = 6 us at K = 5 and 24 us at K = 20.
//
// Design. On the TPU each kernel's point is that the memory of a block of
// images is read into VMEM once for all its queries. Here one image's N
// slots are split across a thread-block cluster of C blocks (C <= 16,
// Hopper's non-portable size), so that B x groups x C blocks fill the
// card's block slots, where one block an image left 82 of 132 SMs idle at
// B 50. Each block of 256 threads takes a slice of about N / C slots for a
// group of up to 8 queries (wider beams are split into equal groups along
// the grid's y, each reading the memory once, the later ones mostly from
// L2):
//
//   1. the group's queries and alpha land in shared memory; the slice's
//      rows are read from device memory where they are used, so that the
//      block stays small (its shared memory holds no rows: three blocks an
//      SM, the grid of the path's shapes in one wave);
//   2. scores: a warp per (slot, query) pair, lanes over A (float4 loads
//      where A is a multiple of 4): 165 pairs over 8 warps at 33 slots and
//      5 queries, where a warp per slot gave some warps a fifth more;
//   3. the slice's softmax terms, a warp a query: its max m, e = exp(s - m)
//      * mask, and their sum l;
//   4. the slice's unnormalised P.V: a thread per column and four queries,
//      each emb element read once for the four;
//   5. after a cluster barrier each block gathers every rank's (m, l)
//      through distributed shared memory (a remote load a thread), forms
//      each query's weights exp(m_r - M) / max(sum_r exp(m_r - M) l_r,
//      1e-9) in rank order, and writes its share of the output columns as
//      the rank-ordered sum of the weighted partials (every remote load in
//      flight at once); a second barrier keeps every block's shared memory
//      alive until the others have read it.
//
// Why so (from timestamps of each block's phases while it was designed). A
// precise tanhf is an exp2, a reciprocal and a polynomial on the FMA pipe,
// not one special-function operation, so past K = 1 the scores are the
// bulk of the time and want every warp of the card busy. Rows staged in
// shared memory made the blocks too large for one wave; a combination read
// by one thread a query waited on 3 C remote loads in a row; an L2 prefetch
// of the slice, a prefetch of the next pair's row into registers and
// float4 P.V loads changed nothing or cost occupancy, and are not here.
//
// No atomics: a rerun gives the same bits. C comes from a model of the
// launch (`plan_of`): rounds of the clusters the card holds at once times
// a block's slots plus a fixed cost (a cluster of 6 at the path's shapes:
// clusters that need a second round of the card cost more than slices
// larger by a third); N < C leaves the last ranks without slots.
//
// att_lstm_att_mixed (decode only, no gradient). A block cannot hold an
// image's memory (803 KB at the widths above) or lstm1's weights (7.9 MB at
// H 512), so the TPU kernel's single program becomes five launches from one
// C call:
//
//   1. xcat[:, H:] = att1 = attention(q1), and xcat[:, :H] = h0d copied by
//      the same launch (each rank a share of the row)
//   2. h1, c1 = maxout LSTM(xcat, h1_prev, c1_prev)   (lstm_cell.cu's cell)
//   3. q2in = h1 + att1 @ emb2_w + emb2_b             (decode_gemm.cuh)
//   4. q2 = q2in @ h2att2_w + h2att2_b                (decode_gemm.cuh)
//   5. att2 = attention(q2)
//
// The 50-row products split their K reduction across a cluster of 8 (64
// blocks for an N of 512). The memory is read twice a step, not once as on
// the TPU; at 40 MB most of the second read can come from the 50 MB L2.
//
// Widths: any A, D and H >= 1. The float4 score loads need A and D
// multiples of 4 and the inputs 16-byte aligned; other shapes run the
// scalar instance. Where one query's A and D would not fit a block's
// shared memory (2 A + D past about 56,000), the block streams the query
// and alpha through shared memory in chunks of A (the score is a sum over
// a, so the chunks' partial scores add up) and takes the P.V and the
// combination in passes over chunks of D; every shape that fits keeps the
// single chunk and pass, and the same sums. The products take any width
// (decode_gemm.cuh), and so does the cell (lstm_cell.cu).
//
// In the decode step h0d and the carry (h1_prev, c1_prev) may be bf16, and
// w1, b1 and the products' weights too (a bf16 copy of the parameters): h1
// and c1 come out in the carry's type, att2 in emb's; att1, h1 + emb2(att1)
// and the att2 query stay f32 in the scratch, as the TPU kernel keeps them
// (h1 in that sum unrounded). Both products run decode_gemm.cuh's f32 FMA
// core either way: bf16 weights are converted as their tiles load (its
// `wbf`), and the epilogues read the biases in the weights' type (JAX
// casts the weights to f32 for these products, so no tensor cores).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

#include "bf16.cuh"
#include "decode_gemm.cuh"

namespace cg = cooperative_groups;
using uic_bf16::ld4t;
using uic_bf16::ldf;
using uic_bf16::ldt;
using uic_bf16::stf;

// the fused LSTM step of lstm_cell.cu (linked into the same library)
extern "C" int lstm_cell_mixed(const void* x, const void* h, const void* c,
                               const void* w, const void* b, void* h_out,
                               void* c_out, int B, int D, int H, int G,
                               int types, cudaStream_t stream);

namespace {

constexpr int ATT_THREADS = 256;
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr int BEAM_GROUP = 8;      // queries a block takes at most
constexpr int MAX_CLUSTER = 16;    // Hopper's non-portable cluster size
constexpr int BLOCK_FIXED = 8;     // a block's fixed cost, in slots (model)
constexpr size_t SMEM_MAX = 227 * 1024;

struct AttArgs {
  const void* p_att;   // [B, N, A]
  const void* q;       // [B, K, A]
  const void* alpha;   // [A]
  const void* mask;    // [B, N]
  const void* emb;     // [B, N, D]
  void* out;           // out[b * ldo + k * D + d]
  const void* copy_src;   // [B, copy_w] or null: copied to copy_dst rows
  float* copy_dst;        // copy_dst[b * copy_ld + j] (f32)
  int copy_ld, copy_w;
  // bf16 flags of the operands read once: q, alpha, mask, the copied row,
  // and of the output
  int qb, ab, mb, cb, ob;
  int N, A, D, K, ldo;
  int kg;     // queries a group (the last may hold fewer)
  int chunk;  // slots a block: ceil(N / C)
  int ac;     // columns of A staged at once (A, unless a query's would not
              // fit a block: then a multiple of 4)
  int dc;     // columns of D a pass of the P.V and the combination takes
};

__device__ __forceinline__ float att_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float att_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

// The regions of a block's shared memory, in floats: the group's queries
// [kg][ac] (ac columns of A at a time), alpha [ac], the scores then weights
// [kg][chunk], the partial P.V [kg][dc] (dc columns of D at a time), every
// rank's (m, l) [2][kg][MAX_CLUSTER] gathered for the combination, then
// its weights [kg][MAX_CLUSTER]. Every region starts on 16 bytes.
struct Smem {
  size_t q, alpha, w, acc, ml, wt, total;
};

__host__ __device__ inline Smem smem_of(int ac, int dc, int kg, int chunk) {
  Smem m;
  m.q = 0;
  m.alpha = m.q + round4((size_t)kg * ac);
  m.w = m.alpha + round4(ac);
  m.acc = m.w + round4((size_t)kg * chunk);
  m.ml = m.acc + round4((size_t)kg * dc);
  m.wt = m.ml + 2 * (size_t)kg * MAX_CLUSTER;
  m.total = m.wt + (size_t)kg * MAX_CLUSTER;
  return m;
}

__device__ __forceinline__ float tanh_dot4(float4 al, float4 p, float4 q) {
  return al.x * tanhf(p.x + q.x) + al.y * tanhf(p.y + q.y) +
         al.z * tanhf(p.z + q.z) + al.w * tanhf(p.w + q.w);
}

template <bool BF>
__device__ __forceinline__ float tanh_dot4(float4 al, const void* row,
                                           size_t i, float4 q) {
  return tanh_dot4(al, ld4t<BF>(row, i), q);
}

// CHUNKED: A and D taken in chunks of p.ac and p.dc (one query's A and D
// past a block's shared memory); otherwise each in one piece. PB, EB: p_att,
// emb stored as bf16.
template <bool V4, bool CHUNKED, bool PB, bool EB>
__global__ void __launch_bounds__(ATT_THREADS)
additive_attention_kernel(const __grid_constant__ AttArgs p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / cs;
  const int k0 = blockIdx.y * p.kg;            // this block's queries
  const int N = p.N, A = p.A, D = p.D, kg = p.kg, chunk = p.chunk;
  const int K = min(p.K - k0, kg);
  const int s0 = rank * chunk, ns = max(0, min(N - s0, chunk));
  const int ac = CHUNKED ? p.ac : A, dc = CHUNKED ? p.dc : D;
  const Smem m = smem_of(ac, dc, kg, chunk);
  float* q_s = smem + m.q;           // [kg][ac]
  float* alpha_s = smem + m.alpha;   // [ac]
  float* w_s = smem + m.w;           // [kg][chunk]
  float* acc_s = smem + m.acc;       // [kg][dc]
  float* ml_s = smem + m.ml;         // m, l [2][kg][MAX_CLUSTER]
  float* wt_s = smem + m.wt;         // [kg][MAX_CLUSTER]
  const size_t pb = ((size_t)b * N + s0) * A;   // element offsets of the
  const size_t eb = ((size_t)b * N + s0) * D;   // slice's first rows
  const size_t qb = ((size_t)b * p.K + k0) * A;

  if constexpr (!CHUNKED) {
    // 1. the queries and alpha; (B9c) this rank's share of the copied row
    for (int i = tid; i < K * A; i += ATT_THREADS)
      q_s[i] = ldf(p.q, qb + i, p.qb);
    for (int i = tid; i < A; i += ATT_THREADS)
      alpha_s[i] = ldf(p.alpha, i, p.ab);
    if (p.copy_src && blockIdx.y == 0) {
      const int w = p.copy_w, per = (w + cs - 1) / cs;
      const int c1 = min(w, (rank + 1) * per);
      for (int j = rank * per + tid; j < c1; j += ATT_THREADS)
        p.copy_dst[(size_t)b * p.copy_ld + j] =
            ldf(p.copy_src, (size_t)b * w + j, p.cb);
    }
    __syncthreads();

    // 2. scores: a warp per (slot, query) pair, lanes over A
    for (int u = warp; u < ns * K; u += ATT_WARPS) {
      const int n = u / K, k = u - n * K;
      float acc = 0.0f;
      if (V4) {
        const int A4 = A / 4;
        const size_t row = pb + (size_t)n * A;
        const float4* al4 = reinterpret_cast<const float4*>(alpha_s);
        const float4* q4 = reinterpret_cast<const float4*>(q_s + (size_t)k * A);
#pragma unroll 4
        for (int a4 = lane; a4 < A4; a4 += 32)
          acc += tanh_dot4<PB>(al4[a4], p.p_att, row + 4 * (size_t)a4,
                               q4[a4]);
      } else {
        const size_t row = pb + (size_t)n * A;
        const float* qk = q_s + (size_t)k * A;
#pragma unroll 4
        for (int a = lane; a < A; a += 32)
          acc += alpha_s[a] * tanhf(ldt<PB>(p.p_att, row + a) + qk[a]);
      }
      acc = att_warp_sum(acc);
      if (lane == 0) w_s[k * chunk + n] = acc;
    }
  } else {
    // (B9c) this rank's share of the copied row
    if (p.copy_src && blockIdx.y == 0) {
      const int w = p.copy_w, per = (w + cs - 1) / cs;
      const int c1 = min(w, (rank + 1) * per);
      for (int j = rank * per + tid; j < c1; j += ATT_THREADS)
        p.copy_dst[(size_t)b * p.copy_ld + j] =
            ldf(p.copy_src, (size_t)b * w + j, p.cb);
    }

    // 1.-2. per chunk of ac columns of A: the queries and alpha, then the
    // scores' partial sums, a warp per (slot, query) pair, lanes over the
    // chunk (one chunk unless a query's columns would not fit)
    for (int a0 = 0; a0 < A; a0 += ac) {
      const int an = min(ac, A - a0);
      if (a0 > 0) __syncthreads();   // the last chunk's q, alpha are read
      for (int i = tid; i < K * an; i += ATT_THREADS) {
        const int k = i / an, a = i - k * an;
        q_s[k * ac + a] = ldf(p.q, qb + (size_t)k * A + a0 + a, p.qb);
      }
      for (int i = tid; i < an; i += ATT_THREADS)
        alpha_s[i] = ldf(p.alpha, a0 + i, p.ab);
      __syncthreads();
      for (int u = warp; u < ns * K; u += ATT_WARPS) {
        const int n = u / K, k = u - n * K;
        float acc = 0.0f;
        if (V4) {
          const int A4 = an / 4;
          const size_t row = pb + (size_t)n * A + a0;
          const float4* al4 = reinterpret_cast<const float4*>(alpha_s);
          const float4* q4 =
              reinterpret_cast<const float4*>(q_s + (size_t)k * ac);
#pragma unroll 4
          for (int a4 = lane; a4 < A4; a4 += 32)
            acc += tanh_dot4<PB>(al4[a4], p.p_att, row + 4 * (size_t)a4,
                                 q4[a4]);
        } else {
          const size_t row = pb + (size_t)n * A + a0;
          const float* qk = q_s + (size_t)k * ac;
#pragma unroll 4
          for (int a = lane; a < an; a += 32)
            acc += alpha_s[a] * tanhf(ldt<PB>(p.p_att, row + a) + qk[a]);
        }
        acc = att_warp_sum(acc);
        if (lane == 0)
          w_s[k * chunk + n] = a0 == 0 ? acc : w_s[k * chunk + n] + acc;
      }
    }
  }
  __syncthreads();

  // 3. the slice's softmax terms, a warp a query: m, e = exp(s - m) * mask
  // in place of the scores, l = sum e (m = -inf, l = 0 for an empty slice)
  const size_t mb = (size_t)b * N + s0;
  float* st_m = ml_s + rank;                    // [k * MAX_CLUSTER + r]
  float* st_l = ml_s + kg * MAX_CLUSTER + rank;
  for (int k = warp; k < K; k += ATT_WARPS) {
    float* wr = w_s + k * chunk;
    float mx = -INFINITY;
    for (int n = lane; n < ns; n += 32) mx = fmaxf(mx, wr[n]);
    mx = att_warp_max(mx);
    float l = 0.0f;
    for (int n = lane; n < ns; n += 32) {
      const float e = expf(wr[n] - mx) * ldf(p.mask, mb + n, p.mb);
      wr[n] = e;
      l += e;
    }
    l = att_warp_sum(l);
    if (lane == 0) {
      st_m[k * MAX_CLUSTER] = mx;
      st_l[k * MAX_CLUSTER] = l;
    }
  }
  __syncthreads();

  if constexpr (!CHUNKED) {
    // 4. the slice's unnormalised P.V: a thread per column and four queries,
    // each emb element read once for the four
    for (int i = tid; i < ((K + 3) / 4) * D; i += ATT_THREADS) {
      const int kq = (i / D) * 4, c = i % D;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      const float* w0 = w_s + kq * chunk;
#pragma unroll 8
      for (int n = 0; n < ns; ++n) {
        const float e = ldt<EB>(p.emb, eb + (size_t)n * D + c);
        a0 = fmaf(w0[n], e, a0);
        if (kq + 1 < K) a1 = fmaf(w0[chunk + n], e, a1);
        if (kq + 2 < K) a2 = fmaf(w0[2 * chunk + n], e, a2);
        if (kq + 3 < K) a3 = fmaf(w0[3 * chunk + n], e, a3);
      }
      float* o = acc_s + (size_t)kq * D + c;
      o[0] = a0;
      if (kq + 1 < K) o[D] = a1;
      if (kq + 2 < K) o[2 * D] = a2;
      if (kq + 3 < K) o[3 * D] = a3;
    }

    // 5. every rank's partials are in its shared memory: gather each query's
    // (m, l) of every rank (one remote load a thread), the query's weights
    // over the ranks, then this rank's share of the columns
    cluster.sync();
    for (int i = tid; i < K * cs; i += ATT_THREADS) {
      const int k = i / cs, r = i - k * cs;
      if (r == rank) continue;
      const float* src = cluster.map_shared_rank(ml_s, r);
      ml_s[k * MAX_CLUSTER + r] = src[k * MAX_CLUSTER + r];
      ml_s[(kg + k) * MAX_CLUSTER + r] = src[(kg + k) * MAX_CLUSTER + r];
    }
    __syncthreads();
    for (int k = tid; k < K; k += ATT_THREADS) {
      const float* mk = ml_s + k * MAX_CLUSTER;
      const float* lk = ml_s + (kg + k) * MAX_CLUSTER;
      float M = -INFINITY;
      for (int r = 0; r < cs; ++r) M = fmaxf(M, mk[r]);
      float L = 0.0f;
      for (int r = 0; r < cs; ++r) L += expf(mk[r] - M) * lk[r];  // rank order
      const float den = fmaxf(L, 1e-9f);
      for (int r = 0; r < cs; ++r)
        wt_s[k * MAX_CLUSTER + r] = expf(mk[r] - M) / den;
    }
    __syncthreads();
    const int per = (D + cs - 1) / cs, c0 = rank * per;
    const int cw = max(0, min(D - c0, per));
    const size_t ob = (size_t)b * p.ldo + (size_t)k0 * D;
    for (int e = tid; e < K * cw; e += ATT_THREADS) {
      const int k = e / cw, c = c0 + e % cw;
      const size_t i = (size_t)k * D + c;
      float v[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)      // every remote load in flight
        if (r < cs) v[r] = cluster.map_shared_rank(acc_s, r)[i];
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)      // rank order: same bits
        if (r < cs) s = fmaf(wt_s[k * MAX_CLUSTER + r], v[r], s);
      stf(p.out, ob + i, s, p.ob);
    }
    // no block leaves while another still reads its shared memory
    cluster.sync();
  } else {
    // 4.-5. per pass of dc columns of D (one pass unless a query's columns
    // would not fit): the slice's unnormalised P.V, a thread per column and
    // four queries, each emb element read once for the four; then every
    // rank's partials are in its shared memory: on the first pass gather
    // each query's (m, l) of every rank (one remote load a thread) and the
    // query's weights over the ranks; then this rank's share of the pass's
    // columns. The pass's last barrier keeps every block's partials alive
    // until the others have read them.
    for (int d0 = 0; d0 < D; d0 += dc) {
      const int dn = min(dc, D - d0);
      for (int i = tid; i < ((K + 3) / 4) * dn; i += ATT_THREADS) {
        const int kq = (i / dn) * 4, c = i % dn;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        const float* w0 = w_s + kq * chunk;
#pragma unroll 8
        for (int n = 0; n < ns; ++n) {
          const float e = ldt<EB>(p.emb, eb + (size_t)n * D + d0 + c);
          a0 = fmaf(w0[n], e, a0);
          if (kq + 1 < K) a1 = fmaf(w0[chunk + n], e, a1);
          if (kq + 2 < K) a2 = fmaf(w0[2 * chunk + n], e, a2);
          if (kq + 3 < K) a3 = fmaf(w0[3 * chunk + n], e, a3);
        }
        float* o = acc_s + (size_t)kq * dc + c;
        o[0] = a0;
        if (kq + 1 < K) o[dc] = a1;
        if (kq + 2 < K) o[2 * dc] = a2;
        if (kq + 3 < K) o[3 * dc] = a3;
      }
      cluster.sync();
      if (d0 == 0) {
        for (int i = tid; i < K * cs; i += ATT_THREADS) {
          const int k = i / cs, r = i - k * cs;
          if (r == rank) continue;
          const float* src = cluster.map_shared_rank(ml_s, r);
          ml_s[k * MAX_CLUSTER + r] = src[k * MAX_CLUSTER + r];
          ml_s[(kg + k) * MAX_CLUSTER + r] = src[(kg + k) * MAX_CLUSTER + r];
        }
        __syncthreads();
        for (int k = tid; k < K; k += ATT_THREADS) {
          const float* mk = ml_s + k * MAX_CLUSTER;
          const float* lk = ml_s + (kg + k) * MAX_CLUSTER;
          float M = -INFINITY;
          for (int r = 0; r < cs; ++r) M = fmaxf(M, mk[r]);
          float L = 0.0f;
          for (int r = 0; r < cs; ++r)           // rank order
            L += expf(mk[r] - M) * lk[r];
          const float den = fmaxf(L, 1e-9f);
          for (int r = 0; r < cs; ++r)
            wt_s[k * MAX_CLUSTER + r] = expf(mk[r] - M) / den;
        }
        __syncthreads();
      }
      const int per = (dn + cs - 1) / cs, c0 = rank * per;
      const int cw = max(0, min(dn - c0, per));
      const size_t ob = (size_t)b * p.ldo + (size_t)k0 * D + d0;
      for (int e = tid; e < K * cw; e += ATT_THREADS) {
        const int k = e / cw, c = c0 + e % cw;
        const size_t i = (size_t)k * dc + c;
        float v[MAX_CLUSTER];
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r)    // every remote load in flight
          if (r < cs) v[r] = cluster.map_shared_rank(acc_s, r)[i];
        float s = 0.0f;
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r)      // rank order: same bits
          if (r < cs) s = fmaf(wt_s[k * MAX_CLUSTER + r], v[r], s);
        stf(p.out, ob + (size_t)k * D + c, s, p.ob);
      }
      // no block overwrites its partials or leaves while another reads them
      cluster.sync();
    }
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// A launch's cluster size C and its shared memory: C in 1..MAX_CLUSTER
// with the least modelled time, rounds of the clusters the card holds at
// once (cudaOccupancyMaxActiveClusters at C's shared memory) times a
// block's slots plus its fixed cost, the smaller C on a tie. Read once per
// shape and device.
struct Plan {
  int cs;
  size_t smem;
};

template <typename Kern>
Plan plan_of(Kern kernel, const AttArgs& p, int clusters) {
  struct Entry {
    const void* kernel;
    int A, D, kg, N, clusters, dev;
    Plan plan;
  };
  static Entry cache[64];
  static int n_cached = 0;
  static std::mutex mu;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cached; ++i) {
    const Entry& e = cache[i];
    if (e.kernel == (const void*)kernel && e.A == p.A && e.D == p.D &&
        e.kg == p.kg && e.N == p.N && e.clusters == clusters && e.dev == dev)
      return e.plan;
  }
  Plan best{0, 0};
  double best_cost = 0.0;
  for (int cs = 1; cs <= MAX_CLUSTER; ++cs) {
    const size_t smem =
        smem_of(p.ac, p.dc, p.kg, cdiv(p.N, cs)).total * sizeof(float);
    if (smem > SMEM_MAX ||
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess ||
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) != cudaSuccess) {
      (void)cudaGetLastError();   // a size the card refuses is no error
      continue;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs * clusters);
    cfg.blockDim = dim3(ATT_THREADS);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int fit = 0;
    if (cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg) != cudaSuccess ||
        fit < 1) {
      (void)cudaGetLastError();
      continue;
    }
    const double cost =
        (double)cdiv(clusters, fit) * (cdiv(p.N, cs) + BLOCK_FIXED);
    if (!best.cs || cost < best_cost) {
      best = Plan{cs, smem};
      best_cost = cost;
    }
  }
  if (best.cs && n_cached < 64)
    cache[n_cached++] = Entry{(const void*)kernel, p.A, p.D, p.kg, p.N,
                              clusters, dev, best};
  return best;
}

template <bool V4, bool CHUNKED, bool PB, bool EB>
int launch_group(const AttArgs& p, int B, int G, cudaStream_t st) {
  auto kernel = additive_attention_kernel<V4, CHUNKED, PB, EB>;
  const Plan plan = plan_of(kernel, p, B * G);
  if (!plan.cs) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (e != cudaSuccess) return (int)e;
  AttArgs a = p;
  a.chunk = cdiv(p.N, plan.cs);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.cs * B, G);
  cfg.blockDim = dim3(ATT_THREADS);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The groups of K queries: the fewest equal groups of at most BEAM_GROUP
// whose shared memory fits a block at the largest cluster; where even one
// query's does not (2 A + D past about 56,000), A and D are taken in
// column chunks (halving the larger share, multiples of 4) until it fits.
// Sets p.kg, p.ac and p.dc and returns the number of groups.
int group_queries(AttArgs& p) {
  const int least_chunk = cdiv(p.N, MAX_CLUSTER);
  auto fits = [&] {
    return smem_of(p.ac, p.dc, p.kg, least_chunk).total * 4 <= SMEM_MAX;
  };
  p.ac = p.A;
  p.dc = p.D;
  int G = cdiv(p.K, BEAM_GROUP);
  p.kg = cdiv(p.K, G);
  while (p.kg > 1 && !fits()) {
    ++G;
    p.kg = cdiv(p.K, G);
  }
  while (!fits() && (p.ac > 4 || p.dc > 4)) {
    if (2 * p.ac >= p.dc)
      p.ac = (int)round4((size_t)cdiv(p.ac, 2));
    else
      p.dc = (int)round4((size_t)cdiv(p.dc, 2));
  }
  return cdiv(p.K, p.kg);
}

bool rows16(const AttArgs& p) {
  return p.A % 4 == 0 && p.D % 4 == 0 &&
         ((size_t)p.p_att | (size_t)p.emb | (size_t)p.q | (size_t)p.alpha) %
                 16 ==
             0;
}

template <bool PB, bool EB>
int launch_typed(const AttArgs& p, int B, int G, cudaStream_t st) {
  if (p.ac < p.A || p.dc < p.D)
    return rows16(p) ? launch_group<true, true, PB, EB>(p, B, G, st)
                     : launch_group<false, true, PB, EB>(p, B, G, st);
  return rows16(p) ? launch_group<true, false, PB, EB>(p, B, G, st)
                   : launch_group<false, false, PB, EB>(p, B, G, st);
}

// One launch over B images and the groups of their K queries; pb, eb:
// p_att, emb stored as bf16.
int launch_attention(AttArgs p, int B, int pb, int eb, cudaStream_t st) {
  if (B <= 0) return (int)cudaGetLastError();
  if (p.K < 1 || p.N < 1 || p.A < 1 || p.D < 1)
    return (int)cudaErrorInvalidValue;
  const int G = group_queries(p);
  if (pb)
    return eb ? launch_typed<true, true>(p, B, G, st)
              : launch_typed<true, false>(p, B, G, st);
  return eb ? launch_typed<false, true>(p, B, G, st)
            : launch_typed<false, false>(p, B, G, st);
}

AttArgs att_args(const void* p_att, const void* q, const void* alpha,
                 const void* mask, const void* emb, void* out, int N, int A,
                 int D, int K, int ldo) {
  AttArgs p{};
  p.p_att = p_att;
  p.q = q;
  p.alpha = alpha;
  p.mask = mask;
  p.emb = emb;
  p.out = out;
  p.N = N;
  p.A = A;
  p.D = D;
  p.K = K;
  p.ldo = ldo;
  return p;
}

// C = (add + acc) + bias: the att2 query's h1 + emb2(att1); the bias f32
// or bf16 (bb: a bf16 copy of the weights)
struct EpiAddBias {
  const float* add;
  const void* bias;
  float* out;
  int ld;
  bool bb;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const float4 a4 = *reinterpret_cast<const float4*>(add + (size_t)r * ld + c);
    const float4 b4 = uic_bf16::ld4(bias, c, bb);
    *reinterpret_cast<float4*>(out + (size_t)r * ld + c) =
        make_float4((a4.x + acc.x) + b4.x, (a4.y + acc.y) + b4.y,
                    (a4.z + acc.z) + b4.z, (a4.w + acc.w) + b4.w);
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    const size_t i = (size_t)r * ld + c;
    out[i] = (add[i] + acc) + ldf(bias, c, bb);
  }
};

// C = acc + bias (uic::EpiBias with the bias f32 or bf16): the att2 query
struct EpiBiasT {
  const void* bias;
  float* out;
  int ldo;
  bool bb;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const float4 b4 = uic_bf16::ld4(bias, c, bb);
    *reinterpret_cast<float4*>(out + (size_t)r * ldo + c) =
        make_float4(acc.x + b4.x, acc.y + b4.y, acc.z + b4.z, acc.w + b4.w);
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    out[(size_t)r * ldo + c] = acc + ldf(bias, c, bb);
  }
};

// dst_h, dst_c [n] bf16 = h, c [n] f32 rounded to nearest even
__global__ void round_pair_kernel(const float* __restrict__ h,
                                  const float* __restrict__ c,
                                  void* __restrict__ dst_h,
                                  void* __restrict__ dst_c, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  stf(dst_h, i, h[i], true);
  stf(dst_c, i, c[i], true);
}

int round_pair(const float* h, const float* c, void* dst_h, void* dst_c,
               size_t n, cudaStream_t st) {
  round_pair_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(h, c, dst_h,
                                                                dst_c, n);
  return (int)cudaGetLastError();
}

}  // namespace

// out[b * ldo + k * D + d] for q [B, K, A]; K = 1 is the single-query
// kernel. Each operand f32 or bf16: `types` bit 0 p_att, 1 q, 2 alpha, 3
// mask, 4 emb, 5 out (0: all f32). Returns cudaGetLastError() after the
// launch.
extern "C" int additive_attention_mixed(const void* p_att, const void* q,
                                        const void* alpha, const void* mask,
                                        const void* emb, void* out, int B,
                                        int N, int A, int D, int K, int ldo,
                                        int types, cudaStream_t stream) {
  if (types < 0 || types > 63) return (int)cudaErrorInvalidValue;
  AttArgs p = att_args(p_att, q, alpha, mask, emb, out, N, A, D, K, ldo);
  p.qb = (types >> 1) & 1;
  p.ab = (types >> 2) & 1;
  p.mb = (types >> 3) & 1;
  p.ob = (types >> 5) & 1;
  return launch_attention(p, B, types & 1, (types >> 4) & 1, stream);
}

// The launch plan of additive_attention_mixed for a shape, with f32 16-byte
// rows:
// out = {cluster size, queries a group, groups, shared memory bytes a
// block}. Returns 0, or a CUDA error.
extern "C" int additive_attention_plan(int B, int N, int A, int D, int K,
                                       int* out) {
  AttArgs p = att_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                       N, A, D, K, K * D);
  if (B <= 0 || K < 1 || N < 1 || A < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const int G = group_queries(p);
  const Plan plan =
      p.ac < p.A || p.dc < p.D
          ? plan_of(additive_attention_kernel<true, true, false, false>, p,
                    B * G)
          : plan_of(additive_attention_kernel<true, false, false, false>, p,
                    B * G);
  out[0] = plan.cs;
  out[1] = p.kg;
  out[2] = G;
  out[3] = (int)plan.smem;
  return plan.cs ? 0 : (int)cudaErrorInvalidValue;
}

// The decode step att1 -> maxout lstm1 -> att2. `in` is a host array of the
// 15 inputs in the order of fused_att_lstm_att (p_att, emb, mask, q1, h0d,
// h1_prev, c1_prev, w1, b1, emb2_w, emb2_b, h2att2_w, h2att2_b, alpha1,
// alpha2); h1, c1 [B, H] (the carry's type) and att2 [B, D] (emb's) are
// written; `ws` holds B * (4 H + D + A) floats of scratch. `types`: bit 0
// p_att, 1 emb, 2 mask, 3 q1, 4 h0d, 5 the carry (h1_prev, c1_prev, h1,
// c1), 6 w1 and b1, 7 the products' weights and biases, 8 alpha1 and
// alpha2 stored as bf16. Five launches (six with a bf16 carry: h1 and c1
// are rounded from their f32 values, which the att2 query reads); returns
// the first launch error.
extern "C" int att_lstm_att_mixed(const void* const* in, void* h1, void* c1,
                                  void* att2, float* ws, int B, int N, int A,
                                  int D, int H, int types,
                                  cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (H < 1 || types < 0 || types > 511) return (int)cudaErrorInvalidValue;
  const void *p_att = in[0], *emb = in[1], *mask = in[2], *q1 = in[3],
             *h0d = in[4], *h1p = in[5], *c1p = in[6], *w1 = in[7],
             *b1 = in[8], *emb2_w = in[9], *emb2_b = in[10],
             *h2att2_w = in[11], *h2att2_b = in[12], *alpha1 = in[13],
             *alpha2 = in[14];
  const int pb = types & 1, eb = (types >> 1) & 1, mb = (types >> 2) & 1;
  const int qb = (types >> 3) & 1, hb = (types >> 4) & 1;
  const int cb = (types >> 5) & 1, wb = (types >> 6) & 1;
  const int gb = (types >> 7) & 1, ab = (types >> 8) & 1;
  const int xw = H + D;                 // [h0d | att1]
  float* xcat = ws;                     // [B, H + D]
  float* q2in = xcat + (size_t)B * xw;  // [B, H]
  float* q2 = q2in + (size_t)B * H;     // [B, A]
  // h1, c1 in f32: the outputs themselves with an f32 carry, else scratch
  float* h1f = cb ? q2 + (size_t)B * A : static_cast<float*>(h1);
  float* c1f = cb ? h1f + (size_t)B * H : static_cast<float*>(c1);
  int err;
  AttArgs att1 = att_args(p_att, q1, alpha1, mask, emb, xcat + H, N, A, D, 1,
                          xw);
  att1.qb = qb;
  att1.ab = ab;
  att1.mb = mb;
  att1.copy_src = h0d;
  att1.cb = hb;
  att1.copy_dst = xcat;
  att1.copy_ld = xw;
  att1.copy_w = H;
  if ((err = launch_attention(att1, B, pb, eb, stream))) return err;
  // x = xcat (f32), w1 / b1 in their type, the carry in its type; bit 3:
  // h1 and c1 out in f32 whatever the carry's type
  if ((err = lstm_cell_mixed(xcat, h1p, c1p, w1, b1, h1f, c1f, B, xw, H, 5,
                             (wb << 1) | (cb << 2) | (cb << 3), stream)))
    return err;
  if (cb && (err = round_pair(h1f, c1f, h1, c1, (size_t)B * H, stream)))
    return err;
  // the two products on decode_gemm's f32 FMA core, the weights converted
  // as they load where they are a bf16 copy (JAX computes both in f32)
  if ((err = uic_decode::decode_gemm(xcat + H, xw, emb2_w, B, H, D,
                                     EpiAddBias{h1f, emb2_b, q2in, H, gb != 0},
                                     stream, 1, gb)))
    return err;
  if ((err = uic_decode::decode_gemm(q2in, H, h2att2_w, B, A, H,
                                     EpiBiasT{h2att2_b, q2, A, gb != 0},
                                     stream, 1, gb)))
    return err;
  AttArgs att = att_args(p_att, q2, alpha2, mask, emb, att2, N, A, D, 1, D);
  att.ab = ab;
  att.mb = mb;
  att.ob = eb;
  return launch_attention(att, B, pb, eb, stream);
}
