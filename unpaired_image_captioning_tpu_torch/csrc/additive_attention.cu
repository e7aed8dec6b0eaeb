// Additive attention, f32: the Hopper counterpart of the three TPU kernels
// of unpaired_image_captioning_tpu/ops/attention.py:
//
//   _fused_attention_kernel        one query per image   (additive_attention_f32, K = 1)
//   _fused_attention_beams_kernel  K beam queries        (additive_attention_f32, any K)
//   _att_lstm_att_kernel           att1 -> lstm1 -> att2 (att_lstm_att_f32)
//
// For image b and query k (q [B, K, A], alpha [A], mask [B, N]):
//
//   s[n] = sum_a alpha[a] * tanh(p_att[b, n, a] + q[b, k, a])   (no alpha bias)
//   w    = exp(s - max_n s) * mask[b];   w /= max(sum_n w, 1e-9)
//   out[b, k, :] = sum_n w[n] * emb[b, n, :]
//
// The mask multiplies after the softmax and the row is renormalised, as the
// reference does (a row whose mask is all zeros gives zeros); the plain
// versions are in ops/attention.py.
//
// Design. On the TPU the point of each kernel is that one block of images
// reads the attention memory (p_att [N, A] and emb [N, D] of an image) into
// VMEM once. Here one block of 512 threads takes one image and reads each of
// its memory rows from device memory once, for all K queries:
//
//   1. the K queries and alpha go to shared memory; each warp takes slots n
//      and reduces over a with float4 loads of the p_att row, accumulating
//      all K scores from the one row it read (K is a template bucket 1, 2,
//      4, 8 or 16, so the K accumulators stay in registers; a beam wider
//      than 16 is split into groups of 16 queries, one block each along the
//      grid's y, so each group reads the image's memory once);
//   2. one warp per query: max, exp, mask and renormalisation over N, the
//      weights left in shared memory (K * N floats);
//   3. threads run over float4 columns of D (coalesced reads of each emb
//      row), each accumulating all K outputs; when D / 4 < 512 the N slots
//      are split over `parts` groups of threads whose partial sums are added
//      in a fixed order through shared memory.
//
// What bounds it. The memory read: at B 50, N 196, A = D = 512 p_att and emb
// are 40.1 MB, 12 us at 3.35 TB/s; the 2 B K N (A + D) operations are
// negligible beside it. Known weakness: one block per image puts 50 blocks
// on 132 SMs, so the read runs at the rate 50 SMs can pull, and the warps
// in flight on each SM set that rate (16 warps a block read it about 1.4x
// faster than 8 at these shapes; the register tile of the 16-beam bucket
// keeps the block from 32). Splitting N over several blocks per image (with
// a second pass for the softmax) is later work.
//
// att_lstm_att_f32 (decode only, no gradient). A block cannot hold an
// image's memory (803 KB at the widths above) or lstm1's weights (7.9 MB at
// H 512), so the TPU kernel's single program becomes a fixed sequence from
// one C call:
//
//   1. xcat[:, :H] = h0d                                 (cudaMemcpy2DAsync)
//   2. xcat[:, H:] = att1 = attention(q1)                (kernel above, K = 1)
//   3. h1, c1 = maxout LSTM(xcat, h1_prev, c1_prev)      (lstm_cell.cu's kernel)
//   4. q2in = h1 + att1 @ emb2_w + emb2_b                (gemm.cuh, EpiAddBias)
//   5. q2 = q2in @ h2att2_w + h2att2_b                   (gemm.cuh, EpiBias)
//   6. att2 = attention(q2)                              (kernel above, K = 1)
//
// The memory is therefore read twice a step, not once as on the TPU; at
// 40 MB most of the second read can come from the 50 MB L2. The LSTM step is
// the port's fused cell (its gates never reach device memory).
//
// Requirements (the wrappers check them): A, D and H multiples of 4, every
// pointer 16-byte aligned.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gemm.cuh"

// the fused LSTM step of lstm_cell.cu (linked into the same library)
extern "C" int lstm_cell_f32(const float* x, const float* h, const float* c,
                             const float* w, const float* b, float* h_out,
                             float* c_out, int B, int D, int H, int G,
                             cudaStream_t stream);

namespace {

constexpr int ATT_THREADS = 512;
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr int BEAM_GROUP = 16;    // queries a block takes
constexpr size_t SMEM_SOFT_CAP = 96 * 1024;    // partial sums give way above
constexpr size_t SMEM_MAX = 227 * 1024;

struct AttArgs {
  const float* p_att;  // [B, N, A]
  const float* q;      // [B, K, A]
  const float* alpha;  // [A]
  const float* mask;   // [B, N]
  const float* emb;    // [B, N, D]
  float* out;          // out[b * ldo + k * D + d]
  int N, A, D, K, ldo, parts;
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

// shared memory of one block, in floats: queries, alpha, the weights
// (rounded up to a float4) and, with parts > 1, the partial sums
size_t att_smem_floats(int N, int A, int D, int K, int parts) {
  const size_t w = ((size_t)K * N + 3) / 4 * 4;
  return (size_t)K * A + A + w + (parts > 1 ? (size_t)parts * K * D : 0);
}

__device__ __forceinline__ float tanh_dot4(float4 al, float4 p, float4 q) {
  return al.x * tanhf(p.x + q.x) + al.y * tanhf(p.y + q.y) +
         al.z * tanhf(p.z + q.z) + al.w * tanhf(p.w + q.w);
}

template <int KB>
__global__ void __launch_bounds__(ATT_THREADS)
additive_attention_kernel(AttArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int k0 = blockIdx.y * BEAM_GROUP;  // this block's group of queries
  const int N = p.N, A = p.A, D = p.D, K = min(p.K - k0, BEAM_GROUP);
  const int A4 = A / 4, D4 = D / 4;
  float* q_s = smem;
  float* alpha_s = q_s + (size_t)K * A;
  float* w_s = alpha_s + A;
  float* part_s = w_s + ((size_t)K * N + 3) / 4 * 4;

  const float* qb = p.q + ((size_t)b * p.K + k0) * A;
  for (int i = tid; i < K * A; i += ATT_THREADS) q_s[i] = qb[i];
  for (int i = tid; i < A; i += ATT_THREADS) alpha_s[i] = p.alpha[i];
  __syncthreads();

  // 1. scores: a warp per slot; the p_att row is read once for all queries
  const float* pb = p.p_att + (size_t)b * N * A;
  const float4* al4 = reinterpret_cast<const float4*>(alpha_s);
  for (int n = warp; n < N; n += ATT_WARPS) {
    const float4* row = reinterpret_cast<const float4*>(pb + (size_t)n * A);
    float acc[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int a4 = lane; a4 < A4; a4 += 32) {
      const float4 pv = row[a4];
      const float4 al = al4[a4];
#pragma unroll
      for (int k = 0; k < KB; ++k)
        if (k < K)
          acc[k] += tanh_dot4(
              al, pv, reinterpret_cast<const float4*>(q_s + k * A)[a4]);
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (k < K) {
        const float s = att_warp_sum(acc[k]);
        if (lane == 0) w_s[k * N + n] = s;
      }
    }
  }
  __syncthreads();

  // 2. softmax over N, then the mask and the renormalisation; a warp a query
  const float* mb = p.mask + (size_t)b * N;
  for (int k = warp; k < K; k += ATT_WARPS) {
    float* wr = w_s + k * N;
    float m = -INFINITY;
    for (int n = lane; n < N; n += 32) m = fmaxf(m, wr[n]);
    m = att_warp_max(m);
    float s = 0.0f;
    for (int n = lane; n < N; n += 32) {
      const float e = expf(wr[n] - m) * mb[n];
      wr[n] = e;
      s += e;
    }
    const float den = fmaxf(att_warp_sum(s), 1e-9f);
    for (int n = lane; n < N; n += 32) wr[n] = wr[n] / den;
  }
  __syncthreads();

  // 3. the weighted sums: float4 columns over threads, slots over `parts`
  const float* eb = p.emb + (size_t)b * N * D;
  const int parts = p.parts;
  float* ob = p.out + (size_t)b * p.ldo + (size_t)k0 * D;
  for (int slot = tid; slot < D4 * parts; slot += ATT_THREADS) {
    const int c4 = slot % D4, part = slot / D4;
    float4 acc[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int n = part; n < N; n += parts) {
      const float4 e = reinterpret_cast<const float4*>(eb + (size_t)n * D)[c4];
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k < K) {
          const float wk = w_s[k * N + n];
          acc[k].x = fmaf(wk, e.x, acc[k].x);
          acc[k].y = fmaf(wk, e.y, acc[k].y);
          acc[k].z = fmaf(wk, e.z, acc[k].z);
          acc[k].w = fmaf(wk, e.w, acc[k].w);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (k < K) {
        float* dst = parts == 1 ? ob + (size_t)k * D
                                : part_s + ((size_t)part * K + k) * D;
        reinterpret_cast<float4*>(dst)[c4] = acc[k];
      }
    }
  }
  if (parts > 1) {
    __syncthreads();
    for (int i = tid; i < K * D4; i += ATT_THREADS) {
      const int k = i / D4, c4 = i % D4;
      float4 s = reinterpret_cast<const float4*>(part_s + (size_t)k * D)[c4];
      for (int part = 1; part < parts; ++part) {
        const float4 v = reinterpret_cast<const float4*>(
            part_s + ((size_t)part * K + k) * D)[c4];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      reinterpret_cast<float4*>(ob + (size_t)k * D)[c4] = s;
    }
  }
}

template <int KB>
int launch_bucket(const AttArgs& p, dim3 grid, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        additive_attention_kernel<KB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  additive_attention_kernel<KB><<<grid, ATT_THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// One launch over B images and the groups of at most BEAM_GROUP queries;
// picks the thread groups over N and the K bucket of the widest group.
int launch_attention(AttArgs p, int B, cudaStream_t st) {
  if (B <= 0) return (int)cudaGetLastError();
  if (p.K < 1 || p.N < 1 || p.A % 4 || p.D % 4 || p.ldo % 4)
    return (int)cudaErrorInvalidValue;
  const int kg = p.K < BEAM_GROUP ? p.K : BEAM_GROUP;
  const dim3 grid(B, (p.K + BEAM_GROUP - 1) / BEAM_GROUP);
  const int d4 = p.D / 4;
  int parts = d4 >= ATT_THREADS ? 1 : ATT_THREADS / d4;
  while (parts > 1 &&
         att_smem_floats(p.N, p.A, p.D, kg, parts) * 4 > SMEM_SOFT_CAP)
    --parts;
  p.parts = parts;
  const size_t smem = att_smem_floats(p.N, p.A, p.D, kg, parts) * 4;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (kg == 1) return launch_bucket<1>(p, grid, smem, st);
  if (kg <= 2) return launch_bucket<2>(p, grid, smem, st);
  if (kg <= 4) return launch_bucket<4>(p, grid, smem, st);
  if (kg <= 8) return launch_bucket<8>(p, grid, smem, st);
  return launch_bucket<16>(p, grid, smem, st);
}

// C = (add + acc) + bias: the att2 query's h1 + emb2(att1)
struct EpiAddBias {
  const float* add;
  const float* bias;
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const float4 a4 = *reinterpret_cast<const float4*>(add + (size_t)r * ld + c);
    const float4 b4 = *reinterpret_cast<const float4*>(bias + c);
    *reinterpret_cast<float4*>(out + (size_t)r * ld + c) =
        make_float4((a4.x + acc.x) + b4.x, (a4.y + acc.y) + b4.y,
                    (a4.z + acc.z) + b4.z, (a4.w + acc.w) + b4.w);
  }
};

uic::GemmArgs gemm_args(const float* a, int lda, const float* w, int M,
                        int N, int K) {
  uic::GemmArgs g{};
  g.a = a;
  g.w = w;
  g.lda = lda;
  g.ldw = N;
  g.M = M;
  g.N = N;
  g.K = K;
  g.k_chunk = K;
  return g;
}

}  // namespace

// out[b * ldo + k * D + d] for q [B, K, A]; K = 1 is the single-query
// kernel. Returns cudaGetLastError() after the launch.
extern "C" int additive_attention_f32(const float* p_att, const float* q,
                                      const float* alpha, const float* mask,
                                      const float* emb, float* out, int B,
                                      int N, int A, int D, int K, int ldo,
                                      cudaStream_t stream) {
  AttArgs p{p_att, q, alpha, mask, emb, out, N, A, D, K, ldo, 1};
  return launch_attention(p, B, stream);
}

// The decode step att1 -> maxout lstm1 -> att2. `in` is a host array of the
// 15 inputs in the order of fused_att_lstm_att (p_att, emb, mask, q1, h0d,
// h1_prev, c1_prev, w1, b1, emb2_w, emb2_b, h2att2_w, h2att2_b, alpha1,
// alpha2); h1, c1 [B, H] and att2 [B, D] are written; `ws` holds
// B * (2 H + D + A) floats of scratch. Returns the first launch error.
extern "C" int att_lstm_att_f32(const float* const* in, float* h1, float* c1,
                                float* att2, float* ws, int B, int N, int A,
                                int D, int H, cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (H % 4) return (int)cudaErrorInvalidValue;
  const float *p_att = in[0], *emb = in[1], *mask = in[2], *q1 = in[3],
              *h0d = in[4], *h1p = in[5], *c1p = in[6], *w1 = in[7],
              *b1 = in[8], *emb2_w = in[9], *emb2_b = in[10],
              *h2att2_w = in[11], *h2att2_b = in[12], *alpha1 = in[13],
              *alpha2 = in[14];
  const int xw = H + D;                 // [h0d | att1]
  float* xcat = ws;                     // [B, H + D]
  float* q2in = xcat + (size_t)B * xw;  // [B, H]
  float* q2 = q2in + (size_t)B * H;     // [B, A]
  int err;
  if ((err = (int)cudaMemcpy2DAsync(xcat, xw * sizeof(float), h0d,
                                    H * sizeof(float), H * sizeof(float), B,
                                    cudaMemcpyDeviceToDevice, stream)))
    return err;
  if ((err = launch_attention(
           AttArgs{p_att, q1, alpha1, mask, emb, xcat + H, N, A, D, 1, xw, 1},
           B, stream)))
    return err;
  if ((err = lstm_cell_f32(xcat, h1p, c1p, w1, b1, h1, c1, B, xw, H, 5,
                           stream)))
    return err;
  if ((err = uic::gemm<false, false, false>(
           gemm_args(xcat + H, xw, emb2_w, B, H, D),
           EpiAddBias{h1, emb2_b, q2in, H}, stream)))
    return err;
  if ((err = uic::gemm<false, false, false>(gemm_args(q2in, H, h2att2_w, B, A,
                                                      H),
                                            uic::EpiBias{h2att2_b, q2, A},
                                            stream)))
    return err;
  return launch_attention(
      AttArgs{p_att, q2, alpha2, mask, emb, att2, N, A, D, 1, D, 1}, B,
      stream);
}
