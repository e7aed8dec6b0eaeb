// Timestep-blocked LSTM chain, forward and backward: the Hopper
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
// Types, as the TPU kernels keep them: x_contrib, the gates and dgates are
// f32; the carry (h0, c0, hs, cs, their cotangents dhs, dcs and dh0, dc0)
// and W are each f32 or bf16 (`hb`, `wb`). A bf16 operand is converted as
// it is read; the sums and the cell are the f32 core below. A bf16 carry
// holds each step's h and c rounded to nearest even (the next step reads
// the rounded values, as the TPU kernel's scratch in the carry's type
// does); with a bf16 W the backward rounds dgates_t to bf16 before its
// product with W^T (`dgates.astype(wT.dtype)`), and stores dgates in f32.
//
// Design. The TPU kernel walks a sequential grid over T with all of W in
// VMEM. A Hopper block cannot hold W (5.24 MB at H = 512, G = 5), and blocks
// run in parallel, so the chain is ONE cooperative persistent launch in each
// direction (cudaLaunchCooperativeKernel, a grid-wide barrier between
// steps). Block k owns U hidden units j in [k*U, k*U + U) and all G gate
// columns of those units (G*U columns of W), which stay in shared memory
// for all T steps (H * G * U floats, 40 KB at H = 512, G = 5, U = 4). U is
// the fewest of 4, 8, 16 that puts at most one block on each SM (128
// blocks at H = 512 on 132 SMs).
//
// Forward step: every block copies h_{t-1} [B, H] from the output hs
// through L2 (not L1, which is not coherent across SMs) into shared memory,
// in column chunks as wide as the shared memory left allows (all of H at
// B = 50), then multiplies it by its slice with register tiles: the K
// reduction is split across the block's 8 warps, and a warp's lanes are
// (gate, four units) column groups x row groups, a lane holding R rows x 4
// columns (R = 7 at G = 4, 9 at G = 5: a batch of 50 in one pass; larger
// batches take more passes). Per four k a lane loads R + 4 float4 from
// shared memory for 16 R FMAs, where one (row, gate) pair a thread loads
// 5 for 16 and is bound by those loads. The warps' partial sums meet in
// shared memory and are added in warp order;
// the cell then runs on the block's own units.
//
// Backward step: the block computes the cell's derivatives of its own
// units, dgates_t for its G*U columns, and multiplies them by its slice
// transposed: a partial dh_k [B, H] = dgates_t[:, own] @ W[:, own]^T (a
// thread holds 28 rows x 4 columns of it, 20 K terms at G = 5, U = 4) that
// it writes to a workspace [2][blocks][B, H] (alternating between steps).
// After the grid barrier each block sums, for its own units only, the
// blocks' partials in block order (four runs of a quarter of the blocks,
// then the four in order): 4 B U floats of each of the 128 partials,
// about 100 KB a block a step, where reading all of dgates_t into every
// block would take B * G * H floats (500 KB). So the exchange is G times
// narrower, each step writes 100 KB a block to L2 instead, and nothing is
// summed in a varying order: a rerun gives the same bits in both
// directions.
//
// A shape whose grid cannot be co-resident (H > 16 x the SM count, or
// shared memory past the budget at large B) is refused with
// cudaErrorCooperativeLaunchTooLarge, and the wrapper raises; nothing falls
// back.
//
// What bounds it. The bound is small: at B 50, T 17, H 512, G 5 each
// direction is 2 * T * B * H * G*H = 2.2 GFLOP (0.033 ms at 67 TFLOP/s) and
// moves its inputs and outputs once (13–26 MB, under 0.008 ms). The chain's
// time is set instead by its T dependent steps, each a grid barrier, a
// 100 KB exchange a block through L2 and B * G * U * H FMAs a block on one
// SM (about 2,300 FMAs a lane at G = 5 with the padding rows).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bf16.cuh"

namespace cg = cooperative_groups;
using uic_bf16::ldf;
using uic_bf16::round_bf16;
using uic_bf16::stf;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LB = 16;           // staging loads in flight per thread
constexpr int SMEM_BUDGET = 220 * 1024;   // of a block's 227 KB
constexpr int BWD_ROWS = 28;     // rows of a backward thread's tile
constexpr int EX_RUNS = 4;       // runs of blocks the exchange sums apart

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// The forward's lane tile: column groups of four units of one gate, row
// groups across the rest of the warp, rows a lane takes in one pass (at
// U = 4 enough for a batch of 50 in one pass).
template <int G, int U>
struct FwdTile {
  static constexpr int CG = G * U / 4;              // column groups
  static constexpr int RG = 32 / CG;                // row groups
  static constexpr int R = U == 4 ? (G == 4 ? 7 : 9) : 4;
  static_assert(CG <= 32, "a warp covers the block's columns");
};

// Copy columns [k0, k0 + kc) of `rows` rows of length H (row stride H,
// starting at element `off` of src, bf16 where `bf`) from global memory,
// through L2 (the rows were written by other blocks), into shared f32 rows
// of stride kc + 4; columns past H read as 0. LB loads are in flight per
// thread before the first is stored. VEC: four elements a load (H a
// multiple of 4, src 16-byte aligned).
template <bool VEC>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const void* src, size_t off, bool bf,
                                      int rows, int H, int k0, int kc) {
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
        const size_t a = off + (size_t)r * H + k;
        if (VEC) {
          if (k < H) v[i] = uic_bf16::ld4cg(src, a, bf);
        } else if (k < H) {
          v[i].x = uic_bf16::ldcg(src, a, bf);
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

// forward shared floats: the resident slice [HP][G][U], the staged chunk
// [B][kc + 4], the warps' partial sums [WARPS][B][G][U] and the c carry
// [B][U]
size_t fwd_smem(int B, int H, int G, int U, int kc) {
  return sizeof(float) * ((size_t)round_up(H, 32) * G * U +
                          (size_t)B * (kc + 4) + (size_t)WARPS * B * G * U +
                          (size_t)B * U);
}

// the widest chunk (a multiple of 32 columns, at most the padded H) whose
// staging fits the budget; 0 if none does
int fwd_chunk(int B, int H, int G, int U) {
  for (int kc = round_up(H, 32); kc >= 32; kc -= 32)
    if (fwd_smem(B, H, G, U, kc) <= (size_t)SMEM_BUDGET) return kc;
  return 0;
}

// backward shared floats: the resident slice transposed [G][U][HP], the
// block's dgates_t [G][U][BP] (BP: B padded to the row tile), the exchange's
// runs [EX_RUNS][B][U] and the dh, dc carries [B][U]
size_t bwd_smem(int B, int H, int G, int U) {
  return sizeof(float) * ((size_t)G * U * round_up(H, 32) +
                          (size_t)G * U * round_up(B, BWD_ROWS) +
                          (size_t)(EX_RUNS + 2) * B * U);
}

template <int G, int U>
__global__ void __launch_bounds__(THREADS, 1)
chain_fwd_kernel(const float* __restrict__ x, const void* __restrict__ h0,
                 const void* __restrict__ c0, const void* __restrict__ w,
                 void* hs, void* __restrict__ cs,
                 float* __restrict__ gates, int T, int B, int H, int kc,
                 int vec, int hb, int wb) {
  using Tile = FwdTile<G, U>;
  constexpr int GU = G * U, R = Tile::R, RG = Tile::RG, CG = Tile::CG;
  extern __shared__ __align__(16) float smem[];
  const int GH = G * H, HP = round_up(H, 32);
  float* w_s = smem;                          // [HP][G][U]: W[k, g*H + j]
  float* h_s = w_s + (size_t)HP * GU;         // [B][kc + 4] staged h_{t-1}
  float* red = h_s + (size_t)B * (kc + 4);    // [WARPS][B][G][U]
  float* c_s = red + (size_t)WARPS * B * GU;  // [B][U] c carry
  const int j0 = blockIdx.x * U;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cgp = lane % CG, rg = lane / CG;  // column group, row group
  const bool works = lane < CG * RG;
  const int ks = kc / WARPS;                  // this warp's K slice of a chunk

  for (int e = threadIdx.x; e < HP * GU; e += THREADS) {
    const int k = e / GU, r = e - k * GU, g = r / U, j = j0 + r - g * U;
    w_s[e] = (k < H && j < H) ? ldf(w, (size_t)k * GH + g * H + j, wb)
                              : 0.0f;
  }
  for (int q = threadIdx.x; q < B * U; q += THREADS) {
    const int b = q / U, j = j0 + q - b * U;
    c_s[q] = j < H ? ldf(c0, (size_t)b * H + j, hb) : 0.0f;
  }
  cg::grid_group grid = cg::this_grid();

  for (int t = 0; t < T; ++t) {
    const void* hp = t == 0 ? h0 : hs;
    const size_t hoff = t == 0 ? 0 : (size_t)(t - 1) * B * H;
    for (int k0 = 0; k0 < H; k0 += kc) {
      __syncthreads();   // the previous chunk's readers are done
      if (vec)
        stage<true>(h_s, hp, hoff, hb, B, H, k0, kc);
      else
        stage<false>(h_s, hp, hoff, hb, B, H, k0, kc);
      __syncthreads();
      const int kb = warp * ks;
      // the slice's columns inside the padded H (a last chunk may end past it)
      const int kn = max(0, min(ks, HP - k0 - kb));
      for (int b0 = 0; b0 < B; b0 += RG * R) {
        if (!works) continue;
        float acc[R][4];
        const float* hr[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
          // rows past B repeat row B-1; their sums are dropped
          hr[r] = h_s + min(b0 + rg + RG * r, B - 1) * (kc + 4) + kb;
        }
        const float* wr = w_s + (size_t)(k0 + kb) * GU + cgp * 4;
#pragma unroll 2
        for (int kk = 0; kk < kn; kk += 4) {
          float4 hv[R];
#pragma unroll
          for (int r = 0; r < R; ++r)
            hv[r] = *reinterpret_cast<const float4*>(hr[r] + kk);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 wv =
                *reinterpret_cast<const float4*>(wr + (kk + q) * GU);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float a = q == 0 ? hv[r].x
                              : q == 1 ? hv[r].y
                              : q == 2 ? hv[r].z
                                       : hv[r].w;
              acc[r][0] = fmaf(a, wv.x, acc[r][0]);
              acc[r][1] = fmaf(a, wv.y, acc[r][1]);
              acc[r][2] = fmaf(a, wv.z, acc[r][2]);
              acc[r][3] = fmaf(a, wv.w, acc[r][3]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int b = b0 + rg + RG * r;
          if (b >= B) continue;
          float4* dst = reinterpret_cast<float4*>(
              red + ((size_t)warp * B + b) * GU + cgp * 4);
          float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          if (k0 > 0) {   // later chunks add to this warp's earlier sums
            const float4 o = *dst;
            v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
          }
          *dst = v;
        }
      }
    }
    __syncthreads();
    // gates = x_contrib + h @ W (the warps' sums in warp order), then the
    // cell on this block's units
    for (int q = threadIdx.x; q < B * U; q += THREADS) {
      const int b = q / U, u = q - b * U, j = j0 + u;
      if (j >= H) continue;
      const size_t row = (size_t)t * B + b;
      const float* xr = x + row * GH + j;
      float* gr = gates + row * GH + j;
      float gv[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.0f;
#pragma unroll
        for (int wp = 0; wp < WARPS; ++wp)
          s += red[((size_t)wp * B + b) * GU + g * U + u];
        gv[g] = xr[g * H] + s;
        gr[g * H] = gv[g];
      }
      const float i_g = sigmoid_f32(gv[0]);
      const float f_g = sigmoid_f32(gv[1]);
      const float o_g = sigmoid_f32(gv[2]);
      const float in_t = G == 5 ? fmaxf(gv[3], gv[4]) : tanhf(gv[3]);
      const float c = f_g * c_s[q] + i_g * in_t;
      c_s[q] = hb ? round_bf16(c) : c;   // the carry's value
      stf(hs, row * H + j, o_g * tanhf(c), hb);
      stf(cs, row * H + j, c, hb);
    }
    if (t + 1 < T) grid.sync();   // h_t is written by every block
  }
}

template <int G, int U>
__global__ void __launch_bounds__(THREADS, 1)
chain_bwd_kernel(const float* __restrict__ gates, const void* __restrict__ cs,
                 const void* __restrict__ c0, const void* __restrict__ dhs,
                 const void* __restrict__ dcs, const void* __restrict__ w,
                 float* __restrict__ dgates, void* __restrict__ dh0,
                 void* __restrict__ dc0, float* part, int T, int B, int H,
                 int hb, int wb) {
  constexpr int GU = G * U, RB = BWD_ROWS;
  extern __shared__ __align__(16) float smem[];
  const int GH = G * H, HP = round_up(H, 32), BP = round_up(B, RB);
  const int nblk = gridDim.x, blk = blockIdx.x;
  float* wt_s = smem;                         // [G][U][HP]: W[k, g*H + j]
  float* dg_s = wt_s + (size_t)GU * HP;       // [G][U][BP] own dgates_t
  float* ex_s = dg_s + (size_t)GU * BP;       // [EX_RUNS][B][U]
  float* dh_s = ex_s + (size_t)EX_RUNS * B * U;   // [B][U] dh carry
  float* dc_s = dh_s + (size_t)B * U;         // [B][U] dc carry
  const int j0 = blk * U;
  const size_t part_step = (size_t)nblk * B * HP;   // one buffer's floats

  for (int e = threadIdx.x; e < GU * HP; e += THREADS) {
    const int r = e / HP, k = e - r * HP, g = r / U, j = j0 + r - g * U;
    wt_s[e] = (k < H && j < H) ? ldf(w, (size_t)k * GH + g * H + j, wb)
                               : 0.0f;
  }
  for (int e = threadIdx.x; e < GU * BP; e += THREADS) dg_s[e] = 0.0f;
  for (int q = threadIdx.x; q < B * U; q += THREADS) {
    dh_s[q] = 0.0f;
    dc_s[q] = 0.0f;
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();

  for (int t = T - 1; t >= 0; --t) {
    // the cell's local derivatives on this block's units
    for (int q = threadIdx.x; q < B * U; q += THREADS) {
      const int b = q / U, u = q - b * U, j = j0 + u;
      if (j >= H) continue;
      const size_t row = (size_t)t * B + b;
      const float* gr = gates + row * GH + j;
      const float i_g = sigmoid_f32(gr[0]);
      const float f_g = sigmoid_f32(gr[H]);
      const float o_g = sigmoid_f32(gr[2 * H]);
      const float m1 = gr[3 * H];
      const float m2 = G == 5 ? gr[4 * H] : 0.0f;
      const float in_t = G == 5 ? fmaxf(m1, m2) : tanhf(m1);
      const float c_t = ldf(cs, row * H + j, hb);
      const float c_prev = t > 0 ? ldf(cs, (row - B) * H + j, hb)
                                 : ldf(c0, (size_t)b * H + j, hb);
      const float th = tanhf(c_t);
      const float dh = ldf(dhs, row * H + j, hb) + dh_s[q];
      const float d_o = dh * th;
      const float dct = dh * o_g * (1.0f - th * th) + dc_s[q] +
                        ldf(dcs, row * H + j, hb);
      float dgv[5];
      dgv[0] = dct * in_t * i_g * (1.0f - i_g);
      dgv[1] = dct * c_prev * f_g * (1.0f - f_g);
      dgv[2] = d_o * o_g * (1.0f - o_g);
      const float dm = dct * i_g;
      if (G == 5) {
        const bool pick = m1 >= m2;           // a tie goes wholly to m1
        dgv[3] = pick ? dm : 0.0f;
        dgv[4] = pick ? 0.0f : dm;
      } else {
        dgv[3] = dm * (1.0f - in_t * in_t);
      }
      float* dg = dgates + row * GH + j;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        dg[g * H] = dgv[g];
        dg_s[(g * U + u) * BP + b] = wb ? round_bf16(dgv[g]) : dgv[g];
      }
      dc_s[q] = dct * f_g;
    }
    __syncthreads();
    // this block's partial dh [B, H] = dgates_t[:, own] @ W[:, own]^T: a
    // thread's tile is RB rows x 4 columns, its K the block's G*U columns
    float* pb = part + (size_t)(t & 1) * part_step + (size_t)blk * B * HP;
    const int nq = HP / 4, nrg = BP / RB;
    for (int item = threadIdx.x; item < nq * nrg; item += THREADS) {
      const int kq = item % nq, b0 = (item / nq) * RB;
      float acc[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
#pragma unroll 4
      for (int c = 0; c < GU; ++c) {
        const float4 wv =
            *reinterpret_cast<const float4*>(wt_s + (size_t)c * HP + kq * 4);
        const float* dr = dg_s + (size_t)c * BP + b0;
#pragma unroll
        for (int r4 = 0; r4 < RB; r4 += 4) {
          const float4 dv = *reinterpret_cast<const float4*>(dr + r4);
          const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[r4 + i][0] = fmaf(dd[i], wv.x, acc[r4 + i][0]);
            acc[r4 + i][1] = fmaf(dd[i], wv.y, acc[r4 + i][1]);
            acc[r4 + i][2] = fmaf(dd[i], wv.z, acc[r4 + i][2]);
            acc[r4 + i][3] = fmaf(dd[i], wv.w, acc[r4 + i][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (b0 + r < B)
          __stcg(reinterpret_cast<float4*>(pb + (size_t)(b0 + r) * HP +
                                           kq * 4),
                 make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    }
    grid.sync();   // every block's partial is written
    // dh on this block's units: the blocks' partials in block order, as
    // EX_RUNS runs of consecutive blocks, then the runs in order
    const float* pt = part + (size_t)(t & 1) * part_step;
    const int per_run = (nblk + EX_RUNS - 1) / EX_RUNS;
    for (int item = threadIdx.x; item < EX_RUNS * B * (U / 4);
         item += THREADS) {
      const int run = item / (B * (U / 4)), rest = item % (B * (U / 4));
      const int b = rest / (U / 4), uq = (rest % (U / 4)) * 4;
      const int i0 = run * per_run, i1 = min(nblk, i0 + per_run);
      const float* src = pt + (size_t)b * HP + j0 + uq;
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int i = i0; i < i1; i += LB) {
        float4 v[LB];
#pragma unroll
        for (int n = 0; n < LB; ++n)   // all loads in flight
          v[n] = i + n < i1 ? __ldcg(reinterpret_cast<const float4*>(
                                  src + (size_t)(i + n) * B * HP))
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int n = 0; n < LB; ++n) {
          s.x += v[n].x;
          s.y += v[n].y;
          s.z += v[n].z;
          s.w += v[n].w;
        }
      }
      *reinterpret_cast<float4*>(ex_s + ((size_t)run * B + b) * U + uq) = s;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < B * U; q += THREADS) {
      float s = ex_s[q];
#pragma unroll
      for (int run = 1; run < EX_RUNS; ++run) s += ex_s[(size_t)run * B * U + q];
      dh_s[q] = s;
    }
    __syncthreads();
  }
  for (int q = threadIdx.x; q < B * U; q += THREADS) {
    const int b = q / U, j = j0 + q - b * U;
    if (j < H) {
      stf(dh0, (size_t)b * H + j, dh_s[q], hb);
      stf(dc0, (size_t)b * H + j, dc_s[q], hb);
    }
  }
}

// One cooperative launch of `kernel` over ceil(H / U) blocks with `smem`
// bytes, refused when the grid cannot be co-resident.
cudaError_t launch_coop(const void* kernel, int H, int U, size_t smem,
                        void** args, cudaStream_t stream) {
  if (smem > (size_t)SMEM_BUDGET) return cudaErrorCooperativeLaunchTooLarge;
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

template <int G, int U>
cudaError_t fwd(const float* x, const void* h0, const void* c0,
                const void* w, void* hs, void* cs, float* gates, int T,
                int B, int H, int hb, int wb, cudaStream_t stream) {
  int kc = fwd_chunk(B, H, G, U);
  if (kc == 0) return cudaErrorCooperativeLaunchTooLarge;
  int vec = H % 4 == 0 && aligned(h0) && aligned(hs);
  void* args[] = {&x,  &h0, &c0, &w,  &hs,  &cs, &gates,
                  &T,  &B,  &H,  &kc, &vec, &hb, &wb};
  return launch_coop((const void*)chain_fwd_kernel<G, U>, H, U,
                     fwd_smem(B, H, G, U, kc), args, stream);
}

template <int G, int U>
cudaError_t bwd(const float* gates, const void* cs, const void* c0,
                const void* dhs, const void* dcs, const void* w,
                float* dgates, void* dh0, void* dc0, float* part, int T,
                int B, int H, int hb, int wb, cudaStream_t stream) {
  void* args[] = {&gates, &cs, &c0, &dhs, &dcs, &w,  &dgates, &dh0,
                  &dc0,   &part, &T, &B, &H, &hb, &wb};
  return launch_coop((const void*)chain_bwd_kernel<G, U>, H, U,
                     bwd_smem(B, H, G, U), args, stream);
}

template <int G>
cudaError_t fwd_g(const float* x, const void* h0, const void* c0,
                  const void* w, void* hs, void* cs, float* gates, int T,
                  int B, int H, int hb, int wb, cudaStream_t s) {
  switch (units_per_block(H)) {
    case 4:
      return fwd<G, 4>(x, h0, c0, w, hs, cs, gates, T, B, H, hb, wb, s);
    case 8:
      return fwd<G, 8>(x, h0, c0, w, hs, cs, gates, T, B, H, hb, wb, s);
    case 16:
      return fwd<G, 16>(x, h0, c0, w, hs, cs, gates, T, B, H, hb, wb, s);
    default: return cudaErrorCooperativeLaunchTooLarge;
  }
}

template <int G>
cudaError_t bwd_g(const float* gates, const void* cs, const void* c0,
                  const void* dhs, const void* dcs, const void* w,
                  float* dgates, void* dh0, void* dc0, float* part, int T,
                  int B, int H, int hb, int wb, cudaStream_t s) {
  switch (units_per_block(H)) {
    case 4:
      return bwd<G, 4>(gates, cs, c0, dhs, dcs, w, dgates, dh0, dc0, part, T,
                       B, H, hb, wb, s);
    case 8:
      return bwd<G, 8>(gates, cs, c0, dhs, dcs, w, dgates, dh0, dc0, part, T,
                       B, H, hb, wb, s);
    case 16:
      return bwd<G, 16>(gates, cs, c0, dhs, dcs, w, dgates, dh0, dc0, part,
                        T, B, H, hb, wb, s);
    default: return cudaErrorCooperativeLaunchTooLarge;
  }
}

bool valid(int T, int B, int H, int G) {
  return T >= 1 && B >= 1 && H >= 1 && (G == 4 || G == 5);
}

}  // namespace

extern "C" {

// x [T, B, G*H], h0 / c0 [B, H], w [H, G*H] -> hs, cs [T, B, H], gates
// [T, B, G*H]; x and the gates f32, `types` bit 0: the carry (h0, c0, hs,
// cs) bf16, bit 1: w bf16
int lstm_chain_fwd_mixed(const float* x, const void* h0, const void* c0,
                         const void* w, void* hs, void* cs, float* gates,
                         int T, int B, int H, int G, int types,
                         void* stream) {
  if (!valid(T, B, H, G) || types < 0 || types > 3)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int hb = types & 1, wb = (types >> 1) & 1;
  return (int)(G == 4 ? fwd_g<4>(x, h0, c0, w, hs, cs, gates, T, B, H, hb,
                                 wb, s)
                      : fwd_g<5>(x, h0, c0, w, hs, cs, gates, T, B, H, hb,
                                 wb, s));
}

// Floats of the backward's workspace (two buffers of every block's partial
// dh [B, H padded to 32]) into *n; 0 when H is too wide for a launch.
int lstm_chain_bwd_ws_f32(int B, int H, long long* n) {
  const int u = units_per_block(H);
  *n = u ? 2LL * ((H + u - 1) / u) * B * round_up(H, 32) : 0;
  return 0;
}

// gates [T, B, G*H], cs / dhs / dcs [T, B, H], c0 [B, H], w [H, G*H], ws
// (lstm_chain_bwd_ws_f32 floats) -> dgates [T, B, G*H], dh0 / dc0 [B, H]
// (the carry: cs, c0, dhs, dcs, dh0, dc0; `types` as the forward's)
int lstm_chain_bwd_mixed(const float* gates, const void* cs, const void* c0,
                         const void* dhs, const void* dcs, const void* w,
                         float* dgates, void* dh0, void* dc0, float* ws,
                         int T, int B, int H, int G, int types,
                         void* stream) {
  if (!valid(T, B, H, G) || types < 0 || types > 3)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int hb = types & 1, wb = (types >> 1) & 1;
  return (int)(G == 4 ? bwd_g<4>(gates, cs, c0, dhs, dcs, w, dgates, dh0,
                                 dc0, ws, T, B, H, hb, wb, s)
                      : bwd_g<5>(gates, cs, c0, dhs, dcs, w, dgates, dh0,
                                 dc0, ws, T, B, H, hb, wb, s));
}

// the blocks of a chain launch over H units (0: H is too wide)
int lstm_chain_blocks(int H) {
  const int u = units_per_block(H);
  return u ? (H + u - 1) / u : 0;
}

}  // extern "C"
