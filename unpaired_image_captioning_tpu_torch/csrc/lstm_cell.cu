// Fused LSTM cell, one step, f32: the Hopper counterpart of the TPU kernel
// unpaired_image_captioning_tpu/ops/rnn.py::_fused_cell_kernel.
//
//   gates = x @ W[:D] + h @ W[D:] + b            [B, G*H], f32 accumulation
//   i, f, o = sigmoid(gates[0:H]), sigmoid(gates[H:2H]), sigmoid(gates[2H:3H])
//   g = tanh(gates[3H:4H])                        (G = 4)
//   g = max(gates[3H:4H], gates[4H:5H])           (G = 5, maxout)
//   c' = f * c + i * g,   h' = o * tanh(c')
//
// Layouts are the JAX package's: x [B, D], h and c [B, H], W [D+H, G*H] with
// the input rows first and gate order (i, f, o, g | m1, m2), b [G*H]. All
// row-major and contiguous; any B, D, H >= 1.
//
// Design. Each block owns a tile of BM batch rows and BN hidden units j, and
// accumulates all G gate columns {g*H + j} of those units, so the gate
// pre-activations stay in registers and the epilogue (sigmoid, tanh or
// maxout, the c/h update) runs on them directly: the [B, G*H] gate matrix
// never reaches device memory. Each thread holds a TM x TN x G register tile
// (TM rows, TN adjacent units, all gates), so one 16-byte shared load of
// [x|h] and G 8-byte loads of W feed TM*TN*G FMAs. The reduction runs over
// D+H in shared-memory tiles of depth BK, double-buffered: the next tile's
// global loads are in flight while the current one is multiplied, with one
// barrier per tile. A tile row k reads x for k < D and h for k >= D, so the
// concatenation [x | h] is never materialised. Products are plain f32 FMA
// on the CUDA cores (no TF32, no tensor cores). Ragged B, D and H are masked
// at the tile edges.
//
// What bounds it. W is the large operand: 15.7 MB at D+H = 1536, G*H = 2560
// (the captioner's maxout cells), and every row tile reads all of it once
// (from L2 after the first tile, since W fits in the 50 MB L2). Per weight
// byte the kernel does B/2 FLOPs. The card's f32 FMA rate over its HBM rate
// is about 20 FLOP/byte, so the weight stream bounds the small batches of the
// path (the NMT encoder at B = 50) and the f32 FMA rate would bound the
// beam batches (B = 250 and 750). In practice the kernel reaches neither:
// at B = 250 the grid is 4 x 32 = 128 blocks of 4 warps, about one per SM,
// so only the register tile's independent FMAs hide latencies, and
// instruction issue (loads, index arithmetic, barriers) bounds it. Deeper
// cp.async pipelines and tensor-core tiles (bf16 or TF32 wgmma, which would
// move the bound to the weight stream up to B of about 590) are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;                        // batch rows per block
constexpr int BN = 16;                        // hidden units per block
constexpr int BK = 32;                        // reduction depth per tile
constexpr int TM = 4;                         // rows per thread
constexpr int TN = 2;                         // adjacent units per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128
constexpr int AS_LD = BM + 4;                 // padded row of the A tile
// the A tile is loaded as runs of 4 consecutive k of one row
constexpr int A_RUNS = BM * BK / 4 / THREADS;  // 4 runs per thread
constexpr int A_ROW_STEP = THREADS / (BK / 4); // rows between a thread's runs

static_assert(BM * BK / 4 % THREADS == 0, "A tile must split evenly");

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

template <int G>
struct Tile {
  static constexpr int W_COLS = G * BN;                 // gate columns
  static constexpr int W_PER_THREAD = BK * W_COLS / THREADS;  // 4G
  static_assert(BK * W_COLS % THREADS == 0, "W tile must split evenly");
};

// at least 3 blocks per SM: the NMT decoder's 384 blocks (B = 750) then fit
// in one wave on 132 SMs
template <int G>
__global__ void __launch_bounds__(THREADS, 3)
lstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ c, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ h_out,
                 float* __restrict__ c_out, int B, int D, int H) {
  constexpr int W_COLS = Tile<G>::W_COLS;
  constexpr int W_PER_THREAD = Tile<G>::W_PER_THREAD;
  // A tile stored k-major ([k][row]) so a thread's TM rows are one float4
  __shared__ __align__(16) float As[2][BK][AS_LD];
  __shared__ __align__(16) float Ws[2][BK][W_COLS];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);             // units j0 + tx*TN + {0, 1}
  const int ty = tid / (BN / TN);             // rows r0 + ty*TM + {0..3}
  const int j0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int K = D + H;
  const int GH = G * H;

  // Loader coordinates, fixed for the whole K loop and computed once: the
  // kernel is bound by instruction issue, so index arithmetic inside the
  // loop costs time. A: runs of 4 consecutive k at rows
  // a_row + n * A_ROW_STEP. W: element n of the thread's share sits at tile
  // row w_kk[n], offset w_off[n] from the tile's first row of W, and shared
  // slot w_slot[n].
  const int a_row = tid / (BK / 4);
  const int a_k = (tid % (BK / 4)) * 4;
  int w_kk[W_PER_THREAD], w_off[W_PER_THREAD], w_slot[W_PER_THREAD];
  bool w_in[W_PER_THREAD];
#pragma unroll
  for (int n = 0; n < W_PER_THREAD; ++n) {
    const int e = tid + n * THREADS;
    const int u = e % BN, g = (e / BN) % G;
    w_kk[n] = e / W_COLS;
    w_off[n] = w_kk[n] * GH + g * H + j0 + u;
    w_slot[n] = w_kk[n] * W_COLS + g * BN + u;
    w_in[n] = j0 + u < H;
  }

  float a_reg[A_RUNS * 4];
  float w_reg[W_PER_THREAD];

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int n = 0; n < A_RUNS; ++n) {
      const int r = r0 + a_row + n * A_ROW_STEP;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + a_k + q;
        float v = 0.0f;
        if (r < B && k < K)
          v = (k < D) ? x[(size_t)r * D + k] : h[(size_t)r * H + (k - D)];
        a_reg[n * 4 + q] = v;
      }
    }
    const float* w_tile = w + (size_t)k0 * GH;
#pragma unroll
    for (int n = 0; n < W_PER_THREAD; ++n)
      w_reg[n] = (k0 + w_kk[n] < K && w_in[n]) ? w_tile[w_off[n]] : 0.0f;
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int n = 0; n < A_RUNS; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        As[buf][a_k + q][a_row + n * A_ROW_STEP] = a_reg[n * 4 + q];
#pragma unroll
    for (int n = 0; n < W_PER_THREAD; ++n) (&Ws[buf][0][0])[w_slot[n]] = w_reg[n];
  };

  float acc[TM][TN][G];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int u = 0; u < TN; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) acc[i][u][g] = 0.0f;

  const int n_tiles = (K + BK - 1) / BK;
  load_tile(0);
  store_tile(0);
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_tile((t + 1) * BK);   // in flight during FMAs

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * TM]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      float2 wv[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        wv[g] = *reinterpret_cast<const float2*>(&Ws[buf][kk][g * BN + tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[i][0][g] = fmaf(a[i], wv[g].x, acc[i][0][g]);
          acc[i][1][g] = fmaf(a[i], wv[g].y, acc[i][1][g]);
        }
    }

    if (t + 1 < n_tiles) store_tile(buf ^ 1);
    // one barrier per tile: the next buffer is complete, and nobody reads
    // this buffer again before it is overwritten two tiles on
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < TN; ++u) {
    const int j = j0 + tx * TN + u;
    if (j >= H) continue;
    float bias[G];
#pragma unroll
    for (int g = 0; g < G; ++g) bias[g] = b[g * H + j];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = r0 + ty * TM + i;
      if (r >= B) continue;
      const float ig = sigmoid_f32(acc[i][u][0] + bias[0]);
      const float fg = sigmoid_f32(acc[i][u][1] + bias[1]);
      const float og = sigmoid_f32(acc[i][u][2] + bias[2]);
      float in_t;
      if (G == 5)
        in_t = fmaxf(acc[i][u][3] + bias[3], acc[i][u][G - 1] + bias[G - 1]);
      else
        in_t = tanhf(acc[i][u][3] + bias[3]);
      const size_t o = (size_t)r * H + j;
      const float cn = fg * c[o] + ig * in_t;
      c_out[o] = cn;
      h_out[o] = og * tanhf(cn);
    }
  }
}

}  // namespace

// Launches one step on `stream`. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported G), so a refused launch is seen
// by the caller.
extern "C" int lstm_cell_f32(const float* x, const float* h, const float* c,
                             const float* w, const float* b, float* h_out,
                             float* c_out, int B, int D, int H, int G,
                             cudaStream_t stream) {
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  const dim3 grid((H + BN - 1) / BN, (B + BM - 1) / BM);
  if (G == 4)
    lstm_cell_kernel<4><<<grid, THREADS, 0, stream>>>(x, h, c, w, b, h_out,
                                                      c_out, B, D, H);
  else if (G == 5)
    lstm_cell_kernel<5><<<grid, THREADS, 0, stream>>>(x, h, c, w, b, h_out,
                                                      c_out, B, D, H);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
