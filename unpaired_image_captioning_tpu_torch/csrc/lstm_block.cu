// Timestep-blocked LSTM chain, f32, forward and backward: the Hopper
// counterpart of the TPU kernels
// unpaired_image_captioning_tpu/ops/lstm_block.py::_chain_fwd_kernel and
// ::_chain_bwd_kernel.
//
// Forward, for t = 0 .. T-1 (time-major, the JAX package's layout):
//   gates_t = x_contrib[t] + h_{t-1} @ W            x_contrib [T, B, G*H]
//   i, f, o = sigmoid(gates_t[0:H | H:2H | 2H:3H])  W [H, G*H], h_{-1} = h0
//   g = tanh(gates_t[3H:4H])  (G = 4)  or  max(m1, m2)  (G = 5, maxout)
//   c_t = f * c_{t-1} + i * g,   h_t = o * tanh(c_t)
// emitting hs, cs [T, B, H] and the gates [T, B, G*H] for the backward.
// Backward, for t = T-1 .. 0, with dh, dc carried (zero at T-1):
//   the cell's local derivatives (the Pallas kernel's formulas, with the
//   maxout tie going wholly to m1) give dgates_t [B, G*H];
//   dh <- dgates_t @ W^T,   dc <- dct * f
// emitting dgates (= dx_contrib), and dh0, dc0 after t = 0. dW = hs_prev^T
// @ dgates is one matrix product outside the kernel, as in the JAX package.
//
// Design. The TPU kernel walks a sequential grid over T with all of W in
// VMEM. A Hopper block cannot hold W (5.24 MB at H = 512, G = 5), and blocks
// run in parallel, so the chain is ONE cooperative persistent launch in each
// direction (cudaLaunchCooperativeKernel, a grid-wide barrier between
// steps). Block k owns U hidden units j in [k*U, k*U + U) and all G gate
// columns of those units, so its slice of W stays in shared memory for all T
// steps, laid out [k][g][u] in both directions: W[k, g*H + j] in the forward
// and W[j, g*H + k] (rows of W) in the backward (H * G * U floats, 40 KB at
// H = 512, G = 5, U = 4). U is the fewest of 4, 8, 16 that puts at most one
// block on each SM (128 blocks at H = 512 on 132 SMs). Each step the blocks
// exchange h_t through the output hs itself (the forward) or dgates_t
// through the output dgates (the backward): a block writes its units, the
// grid synchronises, and every block reads the whole [B, H] (or [B*G, H])
// through L2 (ld.global.cg, not L1, which is not coherent across SMs) into
// shared memory, in chunks as wide as the shared memory left allows (all of
// H in the forward at B = 50; 160 columns in the backward), with 16 float4
// loads in flight per thread. Threads own (row b, gate g) pairs and
// accumulate U columns each with float4 shared loads; the per-(b, unit)
// cell epilogue then runs on the block's own gate sums. A shape whose grid
// cannot be co-resident (H > 16 x the SM count, or no chunk fitting in
// shared memory) is refused with cudaErrorCooperativeLaunchTooLarge, and
// the wrapper raises; nothing falls back.
//
// What bounds it. The bound is small: at B 50, T 17, H 512, G 5 each
// direction is 2 * T * B * H * G*H = 2.2 GFLOP (0.033 ms at 67 TFLOP/s) and
// moves its inputs and outputs once (13–26 MB, under 0.008 ms). The chain's
// time is set instead by its T dependent steps: each is a grid barrier, the
// exchange read from L2 by every block (128 x 100 KB a step in the forward,
// 128 x 500 KB in the backward, whose exchange is G times wider) and
// B * G * U * H FMAs a block on one SM. Exchanging per-block partial dh
// sums instead of dgates would cut the backward's L2 traffic G-fold: later
// work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int LB = 16;           // staging loads in flight per thread
constexpr int SMEM_BUDGET = 220 * 1024;   // of a block's 227 KB

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Copy columns [k0, k0 + kc) of `rows` rows of length H (row stride H) from
// global memory, through L2 (the rows were written by other blocks), into
// shared rows of stride kc + 4; columns past H read as 0. LB loads are in
// flight per thread before the first is stored. VEC: float4 loads (H a
// multiple of 4, src 16-byte aligned).
template <bool VEC>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* src, int rows, int H,
                                      int k0, int kc) {
  const int ld = kc + 4;
  constexpr int W = VEC ? 4 : 1;
  const int per_row = kc / W;
  const int n = rows * per_row;
  for (int e0 = threadIdx.x; e0 < n; e0 += THREADS * LB) {
    float4 v[LB];
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = e0 + i * THREADS;
      v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (e < n) {
        const int r = e / per_row, k = k0 + (e - r * per_row) * W;
        const float* a = src + (size_t)r * H + k;
        if (VEC) {
          if (k < H) v[i] = __ldcg(reinterpret_cast<const float4*>(a));
        } else if (k < H) {
          v[i].x = __ldcg(a);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = e0 + i * THREADS;
      if (e < n) {
        const int r = e / per_row, kk = (e - r * per_row) * W;
        if (VEC)
          *reinterpret_cast<float4*>(dst + r * ld + kk) = v[i];
        else
          dst[r * ld + kk] = v[i].x;
      }
    }
  }
}

// acc[u] += sum_kk a[kk] * w[kk * stride + u] over kc staged columns; a is a
// staged row, w the resident slice at the chunk's first column
template <int U>
__device__ __forceinline__ void chunk_fma(float (&acc)[U],
                                          const float* __restrict__ a,
                                          const float* __restrict__ w,
                                          int stride, int kc) {
#pragma unroll 2
  for (int kk = 0; kk < kc; kk += 4) {
    const float4 av = *reinterpret_cast<const float4*>(a + kk);
    const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* wq = w + (kk + q) * stride;
#pragma unroll
      for (int u = 0; u < U; u += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(wq + u);
        acc[u] = fmaf(ak[q], wv.x, acc[u]);
        acc[u + 1] = fmaf(ak[q], wv.y, acc[u + 1]);
        acc[u + 2] = fmaf(ak[q], wv.z, acc[u + 2]);
        acc[u + 3] = fmaf(ak[q], wv.w, acc[u + 3]);
      }
    }
  }
}

// shared floats: the resident slice [HP][G][U], the staged chunk [rows][kc +
// 4], the sums [B][G][U] and `carries` [B][U] arrays
size_t smem_bytes(int B, int H, int G, int U, int rows, int kc, int carries) {
  return sizeof(float) * ((size_t)round_up(H, 32) * G * U +
                          (size_t)rows * (kc + 4) + (size_t)B * G * U +
                          (size_t)carries * B * U);
}

// the widest chunk (a multiple of 32 columns, at most the padded H) whose
// staging fits the budget; 0 if none does
int chunk_cols(int B, int H, int G, int U, int rows, int carries) {
  for (int kc = round_up(H, 32); kc >= 32; kc -= 32)
    if (smem_bytes(B, H, G, U, rows, kc, carries) <= (size_t)SMEM_BUDGET)
      return kc;
  return 0;
}

template <int U, bool VEC>
__global__ void __launch_bounds__(THREADS)
chain_fwd_kernel(const float* __restrict__ x, const float* __restrict__ h0,
                 const float* __restrict__ c0, const float* __restrict__ w,
                 float* hs, float* __restrict__ cs,
                 float* __restrict__ gates, int T, int B, int H, int G,
                 int kc) {
  extern __shared__ __align__(16) float smem[];
  const int GU = G * U, GH = G * H, HP = round_up(H, 32);
  float* w_s = smem;                          // [HP][G][U]: W[k, g*H + j]
  float* h_s = w_s + (size_t)HP * GU;         // [B][kc + 4] staged h_{t-1}
  float* a_s = h_s + (size_t)B * (kc + 4);    // [B][G][U] h @ W sums
  float* c_s = a_s + (size_t)B * GU;          // [B][U] c carry
  const int j0 = blockIdx.x * U;

  for (int e = threadIdx.x; e < HP * GU; e += THREADS) {
    const int k = e / GU, r = e - k * GU, g = r / U, j = j0 + r - g * U;
    w_s[e] = (k < H && j < H) ? w[(size_t)k * GH + g * H + j] : 0.0f;
  }
  for (int q = threadIdx.x; q < B * U; q += THREADS) {
    const int b = q / U, j = j0 + q - b * U;
    c_s[q] = j < H ? c0[(size_t)b * H + j] : 0.0f;
  }
  cg::grid_group grid = cg::this_grid();

  for (int t = 0; t < T; ++t) {
    const float* hp = t == 0 ? h0 : hs + (size_t)(t - 1) * B * H;
    for (int e = threadIdx.x; e < B * GU; e += THREADS) a_s[e] = 0.0f;
    for (int k0 = 0; k0 < H; k0 += kc) {
      __syncthreads();   // the previous chunk's readers are done
      stage<VEC>(h_s, hp, B, H, k0, kc);
      __syncthreads();
      const int n = min(kc, HP - k0);
      for (int p = threadIdx.x; p < B * G; p += THREADS) {
        const int b = p / G, g = p - b * G;
        float acc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) acc[u] = a_s[p * U + u];
        chunk_fma<U>(acc, h_s + b * (kc + 4), w_s + (size_t)k0 * GU + g * U,
                     GU, n);
#pragma unroll
        for (int u = 0; u < U; ++u) a_s[p * U + u] = acc[u];
      }
    }
    __syncthreads();
    // gates = x_contrib + h @ W, then the cell on this block's units
    for (int q = threadIdx.x; q < B * U; q += THREADS) {
      const int b = q / U, u = q - b * U, j = j0 + u;
      if (j >= H) continue;
      const size_t row = (size_t)t * B + b;
      const float* xr = x + row * GH + j;
      float* gr = gates + row * GH + j;
      const float* ar = a_s + (size_t)b * GU + u;
      float gv[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int g = 0; g < 5; ++g) {
        if (g < G) {
          gv[g] = xr[g * H] + ar[g * U];
          gr[g * H] = gv[g];
        }
      }
      const float i_g = sigmoid_f32(gv[0]);
      const float f_g = sigmoid_f32(gv[1]);
      const float o_g = sigmoid_f32(gv[2]);
      const float in_t = G == 5 ? fmaxf(gv[3], gv[4]) : tanhf(gv[3]);
      const float c = f_g * c_s[q] + i_g * in_t;
      c_s[q] = c;
      hs[row * H + j] = o_g * tanhf(c);
      cs[row * H + j] = c;
    }
    if (t + 1 < T) grid.sync();   // h_t is written by every block
  }
}

template <int U, bool VEC>
__global__ void __launch_bounds__(THREADS)
chain_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                 const float* __restrict__ c0, const float* __restrict__ dhs,
                 const float* __restrict__ dcs, const float* __restrict__ w,
                 float* dgates, float* __restrict__ dh0,
                 float* __restrict__ dc0, int T, int B, int H, int G,
                 int kc) {
  extern __shared__ __align__(16) float smem[];
  const int GU = G * U, GH = G * H, HP = round_up(H, 32);
  float* wt_s = smem;                         // [HP][G][U]: W[j, g*H + k]
  float* d_s = wt_s + (size_t)HP * GU;        // [B*G][kc + 4] staged dgates_t
  float* a_s = d_s + (size_t)B * G * (kc + 4);  // [B][G][U] dgates @ W^T
  float* dh_s = a_s + (size_t)B * GU;         // [B][U] dh carry
  float* dc_s = dh_s + (size_t)B * U;         // [B][U] dc carry
  const int j0 = blockIdx.x * U;

  // W's rows j0 .. j0 + U - 1, read along the row
  for (int e = threadIdx.x; e < U * G * HP; e += THREADS) {
    const int u = e / (G * HP), r = e - u * G * HP, g = r / HP,
              k = r - g * HP, j = j0 + u;
    wt_s[((size_t)k * G + g) * U + u] =
        (k < H && j < H) ? w[(size_t)j * GH + g * H + k] : 0.0f;
  }
  for (int q = threadIdx.x; q < B * U; q += THREADS) {
    dh_s[q] = 0.0f;
    dc_s[q] = 0.0f;
  }
  cg::grid_group grid = cg::this_grid();

  for (int t = T - 1; t >= 0; --t) {
    // the cell's local derivatives on this block's units
    for (int q = threadIdx.x; q < B * U; q += THREADS) {
      const int b = q / U, j = j0 + q - b * U;
      if (j >= H) continue;
      const size_t row = (size_t)t * B + b;
      const float* gr = gates + row * GH + j;
      const float i_g = sigmoid_f32(gr[0]);
      const float f_g = sigmoid_f32(gr[H]);
      const float o_g = sigmoid_f32(gr[2 * H]);
      const float m1 = gr[3 * H];
      const float m2 = G == 5 ? gr[4 * H] : 0.0f;
      const float in_t = G == 5 ? fmaxf(m1, m2) : tanhf(m1);
      const float c_t = cs[row * H + j];
      const float c_prev =
          t > 0 ? cs[(row - B) * H + j] : c0[(size_t)b * H + j];
      const float th = tanhf(c_t);
      const float dh = dhs[row * H + j] + dh_s[q];
      const float d_o = dh * th;
      const float dct =
          dh * o_g * (1.0f - th * th) + dc_s[q] + dcs[row * H + j];
      float* dg = dgates + row * GH + j;
      dg[0] = dct * in_t * i_g * (1.0f - i_g);
      dg[H] = dct * c_prev * f_g * (1.0f - f_g);
      dg[2 * H] = d_o * o_g * (1.0f - o_g);
      const float dm = dct * i_g;
      if (G == 5) {
        const bool pick = m1 >= m2;           // a tie goes wholly to m1
        dg[3 * H] = pick ? dm : 0.0f;
        dg[4 * H] = pick ? 0.0f : dm;
      } else {
        dg[3 * H] = dm * (1.0f - in_t * in_t);
      }
      dc_s[q] = dct * f_g;
    }
    grid.sync();   // dgates_t is written by every block
    // dh = dgates_t @ W^T on this block's units: per (b, g) over gate g's H
    // columns (dgates_t read as B*G rows of H), then summed over g
    for (int e = threadIdx.x; e < B * GU; e += THREADS) a_s[e] = 0.0f;
    const float* dt = dgates + (size_t)t * B * GH;
    for (int k0 = 0; k0 < H; k0 += kc) {
      __syncthreads();
      stage<VEC>(d_s, dt, B * G, H, k0, kc);
      __syncthreads();
      const int n = min(kc, HP - k0);
      for (int p = threadIdx.x; p < B * G; p += THREADS) {
        const int g = p % G;
        float acc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) acc[u] = a_s[p * U + u];
        chunk_fma<U>(acc, d_s + p * (kc + 4), wt_s + (size_t)k0 * GU + g * U,
                     GU, n);
#pragma unroll
        for (int u = 0; u < U; ++u) a_s[p * U + u] = acc[u];
      }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < B * U; q += THREADS) {
      const int b = q / U, u = q - b * U;
      float s = 0.0f;
      for (int g = 0; g < G; ++g) s += a_s[((size_t)b * G + g) * U + u];
      dh_s[q] = s;
    }
    __syncthreads();
  }
  for (int q = threadIdx.x; q < B * U; q += THREADS) {
    const int b = q / U, j = j0 + q - b * U;
    if (j < H) {
      dh0[(size_t)b * H + j] = dh_s[q];
      dc0[(size_t)b * H + j] = dc_s[q];
    }
  }
}

// One cooperative launch of `kernel` over ceil(H / U) blocks with `smem`
// bytes, refused when the grid cannot be co-resident.
cudaError_t launch_coop(const void* kernel, int H, int U, size_t smem,
                        void** args, cudaStream_t stream) {
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    smem);
  if (e != cudaSuccess) return e;
  const int nblk = (H + U - 1) / U;
  if (per_sm * nsm < nblk) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(kernel, dim3(nblk), dim3(THREADS), args,
                                  smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// units per block: the fewest of 4, 8, 16 that give one block per SM at most
int units_per_block(int H) {
  int dev = 0, nsm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  for (int u = 4; u <= 16; u *= 2)
    if ((H + u - 1) / u <= nsm) return u;
  return 0;
}

bool aligned(const void* p) { return ((size_t)p & 15) == 0; }

template <int U>
cudaError_t fwd(const float* x, const float* h0, const float* c0,
                const float* w, float* hs, float* cs, float* gates, int T,
                int B, int H, int G, cudaStream_t stream) {
  int kc = chunk_cols(B, H, G, U, B, 1);
  if (kc == 0) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&x, &h0, &c0, &w, &hs, &cs, &gates, &T, &B, &H, &G, &kc};
  const size_t smem = smem_bytes(B, H, G, U, B, kc, 1);
  const bool vec = H % 4 == 0 && aligned(h0) && aligned(hs);
  return launch_coop(vec ? (const void*)chain_fwd_kernel<U, true>
                         : (const void*)chain_fwd_kernel<U, false>,
                     H, U, smem, args, stream);
}

template <int U>
cudaError_t bwd(const float* gates, const float* cs, const float* c0,
                const float* dhs, const float* dcs, const float* w,
                float* dgates, float* dh0, float* dc0, int T, int B, int H,
                int G, cudaStream_t stream) {
  int kc = chunk_cols(B, H, G, U, B * G, 2);
  if (kc == 0) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&gates, &cs, &c0, &dhs, &dcs, &w, &dgates, &dh0, &dc0,
                  &T, &B, &H, &G, &kc};
  const size_t smem = smem_bytes(B, H, G, U, B * G, kc, 2);
  const bool vec = H % 4 == 0 && aligned(dgates);
  return launch_coop(vec ? (const void*)chain_bwd_kernel<U, true>
                         : (const void*)chain_bwd_kernel<U, false>,
                     H, U, smem, args, stream);
}

bool valid(int T, int B, int H, int G) {
  return T >= 1 && B >= 1 && H >= 1 && (G == 4 || G == 5);
}

}  // namespace

extern "C" {

// x [T, B, G*H], h0 / c0 [B, H], w [H, G*H] -> hs, cs [T, B, H], gates
// [T, B, G*H]
int lstm_chain_fwd_f32(const float* x, const float* h0, const float* c0,
                       const float* w, float* hs, float* cs, float* gates,
                       int T, int B, int H, int G, void* stream) {
  if (!valid(T, B, H, G)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (units_per_block(H)) {
    case 4: return (int)fwd<4>(x, h0, c0, w, hs, cs, gates, T, B, H, G, s);
    case 8: return (int)fwd<8>(x, h0, c0, w, hs, cs, gates, T, B, H, G, s);
    case 16: return (int)fwd<16>(x, h0, c0, w, hs, cs, gates, T, B, H, G, s);
    default: return (int)cudaErrorCooperativeLaunchTooLarge;
  }
}

// gates [T, B, G*H], cs / dhs / dcs [T, B, H], c0 [B, H], w [H, G*H] ->
// dgates [T, B, G*H], dh0 / dc0 [B, H]
int lstm_chain_bwd_f32(const float* gates, const float* cs, const float* c0,
                       const float* dhs, const float* dcs, const float* w,
                       float* dgates, float* dh0, float* dc0, int T, int B,
                       int H, int G, void* stream) {
  if (!valid(T, B, H, G)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (units_per_block(H)) {
    case 4:
      return (int)bwd<4>(gates, cs, c0, dhs, dcs, w, dgates, dh0, dc0, T, B,
                         H, G, s);
    case 8:
      return (int)bwd<8>(gates, cs, c0, dhs, dcs, w, dgates, dh0, dc0, T, B,
                         H, G, s);
    case 16:
      return (int)bwd<16>(gates, cs, c0, dhs, dcs, w, dgates, dh0, dc0, T, B,
                          H, G, s);
    default: return (int)cudaErrorCooperativeLaunchTooLarge;
  }
}

// the blocks of a chain launch over H units (0: H is too wide)
int lstm_chain_blocks(int H) {
  const int u = units_per_block(H);
  return u ? (H + u - 1) / u : 0;
}

}  // extern "C"
