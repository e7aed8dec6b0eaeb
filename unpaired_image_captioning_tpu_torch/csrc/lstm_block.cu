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
// Tensor-core instances (chain_fwd_tc_kernel, chain_bwd_tc_kernel). Where
// a product multiplies two bf16 operands in JAX (the rule chain_tc: the
// forward with the carry and W bf16, the backward whenever W is bf16) it
// runs on mma.sync m16n8k16 (bf16 in, f32 sums; mma_bf16.cuh), one
// cooperative launch each way, no atomics. The forward keeps the FMA core's
// blocks, barrier and cell: the block's columns of W stay in shared memory
// as bf16, each warp stages its own sixteenth-multiple of K of the bf16
// h_{t-1} by 16-byte cp.async through L2 (no block barrier before its
// products), and x_contrib of the next step lands while the grid waits.
// The backward changes what crosses the grid: instead of every block's
// f32 partial dh [B, H] (100 KB a block a step, whose stores and reads
// took more than half of a step), each block publishes its columns of
// dgates_t rounded to bf16, as JAX's dgates.astype(wT.dtype) rounds them,
// and a thread-block cluster of 2 blocks computes dh of its 8 units (16 at
// wider H) from all of dgates_t: rank r takes half of the G*H columns, and
// the two partials are summed in rank order through distributed shared
// memory. The next step's cell inputs are loaded into registers before the
// barrier. (The FMA core's exchange with its products on the tensor cores,
// at 4 or 8 units a block, and with the partials summed across a cluster
// through DSMEM first, each read slower on an H100 at B 50, T 17, H 512.)
// Neither instance falls back to the FMA core: a shape it cannot take
// raises.
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
#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core instances (bf16 products, f32 sums; mma_bf16.cuh)
// ---------------------------------------------------------------------------

// Columns of a block: n = g * U + u (gate g of unit j0 + u), padded to
// 8-column tiles (an even number of them, for ldmatrix.x4 pairs) with zero
// weights.
template <int G, int U>
struct TcDims {
  static constexpr int GU = G * U;
  static constexpr int NT = (GU + 7) / 8;        // 8-column tiles
  static constexpr int NTE = NT + (NT & 1);      // rounded up to pairs
  static constexpr int NPR = NT * 8 + 4;         // f32 row of a warp's sums
};

// the forward's shared bytes: the resident slice w_s [NTE * 8][ldk] and
// the staged rows h_s [rp][ldk] (bf16, ldk = H padded to 16, plus 8), the
// warps' partial sums [WARPS][rp][NPR], x_contrib of the pass [rp][G][U]
// and the c carry [B][U]
template <int G, int U>
size_t tc_fwd_smem(int B, int H, int rp) {
  using D = TcDims<G, U>;
  const size_t ldk = round_up(H, 16) + 8;
  return 2 * ((size_t)D::NTE * 8 + rp) * ldk +
         4 * ((size_t)WARPS * rp * D::NPR + (size_t)rp * D::GU +
              (size_t)B * U);
}

// rows a pass of a tensor-core instance: a multiple of 16 up to 64 (and to
// B rounded up to 16), the most whose shared memory smem(rows) fits; 0 if
// none does
template <class Smem>
int tc_rows(int B, Smem smem) {
  const int most = round_up(B, 16);
  for (int rp = most < 64 ? most : 64; rp >= 16; rp -= 16)
    if (smem(rp) <= (size_t)SMEM_BUDGET) return rp;
  return 0;
}

// The backward's plan: a cluster of C blocks owns U units (C x H / U
// blocks); rank r runs the cells of U / C of them and multiplies the r-th
// C-th of the G*H columns. Its shared bytes: its K slice of the rows of W
// of the cluster's units wt_s [UP][ldw] and of dgates_t ch_s [rp][ldw]
// (bf16, UP = U padded to 8, ldw = the slice plus 8), the warps' sums
// [WARPS][rp][UP + 4], the block's partial dh [B][U] and the dh, dc
// carries [B][U / C].
template <int G, int U, int C>
size_t tc_bwd_smem(int B, int H, int rp) {
  constexpr int UP = (U + 7) / 8 * 8;
  const size_t ldw = round_up(G * H, 16 * C) / C + 8;
  return 2 * ((size_t)UP + rp) * ldw +
         4 * ((size_t)WARPS * rp * (UP + 4) + (size_t)B * U +
              2 * (size_t)B * (U / C));
}

struct TcFwdArgs {
  const float* x;
  const void *h0, *c0, *w;
  void *hs, *cs;
  float* gates;
  int T, B, H, rp, vec_h, vec_x;
};

struct TcBwdArgs {
  const float* gates;
  const void *cs, *c0, *dhs, *dcs, *w;
  float* dgates;
  void *dh0, *dc0;
  float* ws;
  int T, B, H, hb, rp;
};

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

// x_contrib of rows [r0, r0 + rows) of step t, units [j0, j0 + U), into
// xs [rows][G][U] by cp.async (16 bytes where vec: H a multiple of 4, x
// 16-byte aligned); columns past H read as 0. The caller waits.
template <int G, int U>
__device__ __forceinline__ void tc_stage_x(float* xs, const float* x, int t,
                                           int r0, int rows, int B, int H,
                                           int j0, bool vec) {
  const size_t base = ((size_t)t * B + r0) * G * H + j0;
  if (vec) {
    constexpr int Q = U / 4;
    for (int e = threadIdx.x; e < rows * G * Q; e += THREADS) {
      const int rr = e / (G * Q), r = e - rr * G * Q, g = r / Q;
      const int u = (r - g * Q) * 4;
      const bool ok = j0 + u < H;
      uic_mma::cp16(xs + (rr * G + g) * U + u,
                    ok ? x + base + ((size_t)rr * G + g) * H + u : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * G * U; e += THREADS) {
      const int rr = e / (G * U), r = e - rr * G * U, g = r / U;
      const int u = r - g * U;
      const bool ok = j0 + u < H;
      cp4(xs + (rr * G + g) * U + u,
          ok ? x + base + ((size_t)rr * G + g) * H + u : x, ok);
    }
  }
  uic_mma::commit();
}

// the warp's columns [kc0, kc1) of rows [r0, r0 + rows) of h_{t-1} (bf16
// [B, H] at hp, written by other blocks: through L2) into h_s at columns
// [kc0 - kb, kc1 - kb); 16-byte cp.async where vec (H a multiple of 8, hp
// 16-byte aligned), else 2-byte loads. The caller waits.
__device__ __forceinline__ void tc_stage_h(unsigned short* h_s, int ldk,
                                           const unsigned short* hp, int r0,
                                           int rows, int H, int kb, int kc0,
                                           int kc1, bool vec, int lane) {
  if (kc1 <= kc0) return;
  if (vec) {
    const int per = (kc1 - kc0) / 8;
    for (int e = lane; e < rows * per; e += 32) {
      const int rr = e / per, k = kc0 + (e - rr * per) * 8;
      uic_mma::cp16(h_s + (size_t)rr * ldk + k - kb,
                    hp + (size_t)(r0 + rr) * H + k, true);
    }
    uic_mma::commit();
  } else {
    const int wd = kc1 - kc0;
    for (int e = lane; e < rows * wd; e += 32) {
      const int rr = e / wd, k = kc0 + e - rr * wd;
      h_s[(size_t)rr * ldk + k - kb] =
          __ldcg(hp + (size_t)(r0 + rr) * H + k);
    }
  }
}

// The forward on the tensor cores (the carry and W bf16). Block k owns the
// units [k U, k U + U) as the FMA core's does; its G*U columns of W stay in
// shared memory, transposed (w_s[n][k]), for all T steps. A step takes the
// batch in passes of rp rows (one at B <= 64): each warp stages its own
// slice of K of h_{t-1} (a sixteenth-multiple of H over the 8 warps) by
// 16-byte cp.async through L2, with no block barrier, and multiplies it by
// the slice with mma.sync m16n8k16 (A by ldmatrix from h_s, B by ldmatrix
// from w_s); the warps' f32 sums meet in shared memory and are added in
// warp order, then x_contrib (staged by cp.async before the grid barrier
// that precedes the step) and the cell on the block's units. (A cluster's
// K split with a DSMEM sum of the partial gates, as the backward's, read
// slower on an H100 at B 50, T 17, H 512: its cluster barrier and DSMEM
// reads cost more than the halved staging saves.)
template <int G, int U>
__global__ void __launch_bounds__(THREADS, 1)
chain_fwd_tc_kernel(TcFwdArgs a) {
  using D = TcDims<G, U>;
  constexpr int GU = D::GU, NT = D::NT, NTE = D::NTE, NPR = D::NPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = a.H, B = a.B, GH = G * H, rp = a.rp, mtp = rp / 16;
  const int ks_all = (H + 15) / 16, ldk = ks_all * 16 + 8;
  unsigned short* w_s = reinterpret_cast<unsigned short*>(smem_raw);
  unsigned short* h_s = w_s + (size_t)NTE * 8 * ldk;
  float* red = reinterpret_cast<float*>(h_s + (size_t)rp * ldk);
  float* xs = red + (size_t)WARPS * rp * NPR;
  float* c_s = xs + (size_t)rp * GU;
  const int j0 = blockIdx.x * U;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = (ks_all + WARPS - 1) / WARPS;   // K steps a warp
  const int ks0 = min(ks_all, warp * kw), ks1 = min(ks_all, ks0 + kw);
  const int kc0 = ks0 * 16, kc1 = min(H, ks1 * 16);
  const unsigned short* wsrc = static_cast<const unsigned short*>(a.w);

  for (int e = threadIdx.x; e < NTE * 8 * ks_all * 16; e += THREADS) {
    const int k = e / (NTE * 8), n = e - k * (NTE * 8);
    unsigned short v = 0;
    if (n < GU && k < H) {
      const int g = n / U, j = j0 + n - g * U;
      if (j < H) v = wsrc[(size_t)k * GH + g * H + j];
    }
    w_s[(size_t)n * ldk + k] = v;
  }
  for (int e = threadIdx.x; e < rp * ldk; e += THREADS) h_s[e] = 0;
  for (int q = threadIdx.x; q < B * U; q += THREADS) {
    const int b = q / U, j = j0 + q - b * U;
    c_s[q] = j < H ? ldf(a.c0, (size_t)b * H + j, true) : 0.0f;
  }
  tc_stage_x<G, U>(xs, a.x, 0, 0, min(rp, B), B, H, j0, a.vec_x);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const int npass = (B + rp - 1) / rp;
  const int gq = lane / 4, q2 = (lane % 4) * 2;

  for (int t = 0; t < a.T; ++t) {
    const unsigned short* hp =
        static_cast<const unsigned short*>(t == 0 ? a.h0 : a.hs) +
        (t == 0 ? 0 : (size_t)(t - 1) * B * H);
    for (int p = 0; p < npass; ++p) {
      const int r0 = p * rp, rows = min(rp, B - r0);
      if (p > 0) tc_stage_x<G, U>(xs, a.x, t, r0, rows, B, H, j0, a.vec_x);
      tc_stage_h(h_s, ldk, hp, r0, rows, H, 0, kc0, kc1, a.vec_h, lane);
      uic_mma::wait<0>();
      __syncwarp();
      float acc[4][NT][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
              acc[mt][nt][3] = 0.0f;
      for (int ks = ks0; ks < ks1; ++ks) {
        unsigned bf[NTE][2];
#pragma unroll
        for (int np = 0; np < NTE; np += 2) {
          unsigned r[4];
          uic_mma::ldsm_x4(r, w_s + (size_t)(np * 8 + uic_mma::kmaj_row(lane)) *
                                        ldk +
                                  ks * 16 + uic_mma::kmaj_col(lane));
          bf[np][0] = r[0];
          bf[np][1] = r[1];
          bf[np + 1][0] = r[2];
          bf[np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt < mtp) {
            unsigned af[4];
            uic_mma::ldsm_x4(
                af, h_s + (size_t)(mt * 16 + uic_mma::frag_row(lane)) * ldk +
                        ks * 16 + uic_mma::frag_col(lane));
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              uic_mma::mma(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
          }
        }
      }
      float* rw = red + (size_t)warp * rp * NPR;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= mtp) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* o = rw + (size_t)(mt * 16 + gq) * NPR + nt * 8 + q2;
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[mt][nt][0], acc[mt][nt][1]);
          *reinterpret_cast<float2*>(o + 8 * NPR) =
              make_float2(acc[mt][nt][2], acc[mt][nt][3]);
        }
      }
      __syncthreads();
      // gates = x_contrib + h @ W (the warps' sums in warp order), then the
      // cell on this block's units; h and c rounded to bf16
      for (int q = threadIdx.x; q < rows * U; q += THREADS) {
        const int rr = q / U, u = q - rr * U, j = j0 + u, b = r0 + rr;
        if (j >= H) continue;
        const size_t row = (size_t)t * B + b;
        float gv[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = 0.0f;
#pragma unroll
          for (int wp = 0; wp < WARPS; ++wp)
            s += red[((size_t)wp * rp + rr) * NPR + g * U + u];
          gv[g] = xs[(rr * G + g) * U + u] + s;
          a.gates[row * GH + g * H + j] = gv[g];
        }
        const float i_g = sigmoid_f32(gv[0]);
        const float f_g = sigmoid_f32(gv[1]);
        const float o_g = sigmoid_f32(gv[2]);
        const float in_t = G == 5 ? fmaxf(gv[3], gv[4]) : tanhf(gv[3]);
        const float c = f_g * c_s[b * U + u] + i_g * in_t;
        c_s[b * U + u] = round_bf16(c);
        stf(a.hs, row * H + j, o_g * tanhf(c), true);
        stf(a.cs, row * H + j, c, true);
      }
      __syncthreads();
    }
    if (t + 1 < a.T) {
      // the next step's x_contrib lands while the grid waits
      tc_stage_x<G, U>(xs, a.x, t + 1, 0, min(rp, B), B, H, j0, a.vec_x);
      grid.sync();   // h_t is written by every block
    }
  }
}

// a backward cell's inputs at (t, b, unit j)
struct CellIn {
  float g[5], c, cp, dh, dc;
};

template <int G>
__device__ __forceinline__ CellIn tc_cell_in(const TcBwdArgs& a, int t, int b,
                                             int j) {
  CellIn v;
  const size_t row = (size_t)t * a.B + b;
  const float* gr = a.gates + row * G * a.H + j;
#pragma unroll
  for (int g = 0; g < G; ++g) v.g[g] = gr[g * a.H];
  if (G == 4) v.g[4] = 0.0f;
  v.c = ldf(a.cs, row * a.H + j, a.hb);
  v.cp = t > 0 ? ldf(a.cs, (row - a.B) * a.H + j, a.hb)
               : ldf(a.c0, (size_t)b * a.H + j, a.hb);
  v.dh = ldf(a.dhs, row * a.H + j, a.hb);
  v.dc = ldf(a.dcs, row * a.H + j, a.hb);
  return v;
}

// two 8 x 8 b16 matrices (lanes 0-15 give the rows)
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// The backward on the tensor cores (W bf16, the carry f32 or bf16). A
// thread-block cluster of C blocks owns U units; its rank r runs the cell
// derivatives of U / C of them (as the FMA core's blocks do theirs) and
// publishes their columns of dgates_t rounded to bf16 (what JAX's
// dgates.astype(wT.dtype) feeds the product) to a workspace [2][B][G*H
// padded] in global memory. After the grid barrier rank r stages its C-th
// of the G*H columns of dgates_t by 16-byte cp.async through L2 (each warp
// its own part of the slice, no block barrier) and multiplies it by the
// same columns of the rows of W of the cluster's units (wt_s[u][k] =
// W[units + u, slice + k], resident), mma.sync m16n8k16 with the slice's K
// split across the 8 warps, whose f32 sums are added in warp order into the
// block's partial dh [B][U]. After a cluster barrier each rank sums, for
// its own units, the C ranks' partials in rank order through distributed
// shared memory. No float atomics: a rerun gives the same bits. The next
// step's cell inputs are loaded into registers before the grid barrier.
template <int G, int U, int C>
__global__ void __launch_bounds__(THREADS, 1)
chain_bwd_tc_kernel(TcBwdArgs a) {
  constexpr int UP = (U + 7) / 8 * 8, NT = UP / 8, NPR = UP + 4;
  constexpr int UC = U / C;   // units of a rank's cells
  constexpr int PF = 2;       // cell items a thread loads early
  static_assert(NT == 1 || NT == 2, "one or two 8-unit tiles");
  static_assert(U % C == 0, "whole units a rank");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = a.H, B = a.B, GH = G * H, rp = a.rp;
  const int ghp = round_up(GH, 16 * C), kslice = ghp / C, ldw = kslice + 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int jc = (int)(blockIdx.x / C) * U;   // the cluster's units
  const int j0 = jc + rank * UC;               // this rank's cells
  const int kb = rank * kslice;                // this rank's K slice
  unsigned short* wt_s = reinterpret_cast<unsigned short*>(smem_raw);
  unsigned short* ch_s = wt_s + (size_t)UP * ldw;
  float* red = reinterpret_cast<float*>(ch_s + (size_t)rp * ldw);
  float* pd_s = red + (size_t)WARPS * rp * NPR;   // [B][U]
  float* dh_s = pd_s + (size_t)B * U;             // [B][UC]
  float* dc_s = dh_s + (size_t)B * UC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned short* dgx = reinterpret_cast<unsigned short*>(a.ws);
  const size_t dgx_step = (size_t)B * ghp;   // one buffer's elements
  const unsigned short* wsrc = static_cast<const unsigned short*>(a.w);
  const int ks_all = kslice / 16, kw = (ks_all + WARPS - 1) / WARPS;
  const int k0w = min(ks_all, warp * kw) * 16;
  const int k1w = min(ks_all, warp * kw + kw) * 16;

  for (int e = threadIdx.x; e < UP * kslice; e += THREADS) {
    const int n = e / kslice, k = e - n * kslice;
    wt_s[(size_t)n * ldw + k] = n < U && jc + n < H && kb + k < GH
                                    ? wsrc[(size_t)(jc + n) * GH + kb + k]
                                    : 0;
  }
  for (int e = threadIdx.x; e < rp * ldw; e += THREADS) ch_s[e] = 0;
  for (int q = threadIdx.x; q < B * UC; q += THREADS) {
    dh_s[q] = 0.0f;
    dc_s[q] = 0.0f;
  }
  if (blockIdx.x == 0 && ghp > GH) {   // the padding columns read as 0
    const int pad = ghp - GH;
    for (int e = threadIdx.x; e < 2 * B * pad; e += THREADS) {
      const int rb = e / pad;
      dgx[(size_t)rb * ghp + GH + (e - rb * pad)] = 0;
    }
  }
  CellIn pf[PF];
#pragma unroll
  for (int i = 0; i < PF; ++i) {
    const int q = threadIdx.x + i * THREADS, b = q / UC, j = j0 + q - b * UC;
    if (q < B * UC && j < H) pf[i] = tc_cell_in<G>(a, a.T - 1, b, j);
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();

  for (int t = a.T - 1; t >= 0; --t) {
    unsigned short* dgt = dgx + (size_t)(t & 1) * dgx_step;
    // the cell's local derivatives on this rank's units
    auto cell = [&](int q, const CellIn& v) {
      const int b = q / UC, j = j0 + q - b * UC;
      const float i_g = sigmoid_f32(v.g[0]);
      const float f_g = sigmoid_f32(v.g[1]);
      const float o_g = sigmoid_f32(v.g[2]);
      const float m1 = v.g[3], m2 = v.g[4];
      const float in_t = G == 5 ? fmaxf(m1, m2) : tanhf(m1);
      const float th = tanhf(v.c);
      const float dh = v.dh + dh_s[q];
      const float d_o = dh * th;
      const float dct = dh * o_g * (1.0f - th * th) + dc_s[q] + v.dc;
      float dgv[5];
      dgv[0] = dct * in_t * i_g * (1.0f - i_g);
      dgv[1] = dct * v.cp * f_g * (1.0f - f_g);
      dgv[2] = d_o * o_g * (1.0f - o_g);
      const float dm = dct * i_g;
      if (G == 5) {
        const bool pick = m1 >= m2;           // a tie goes wholly to m1
        dgv[3] = pick ? dm : 0.0f;
        dgv[4] = pick ? 0.0f : dm;
      } else {
        dgv[3] = dm * (1.0f - in_t * in_t);
      }
      float* dg = a.dgates + ((size_t)t * B + b) * GH + j;
      unsigned short* dx = dgt + (size_t)b * ghp + j;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        dg[g * H] = dgv[g];
        dx[g * H] = (unsigned short)uic_bf16::bits(dgv[g]);
      }
      dc_s[q] = dct * f_g;
    };
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int q = threadIdx.x + i * THREADS, b = q / UC, j = j0 + q - b * UC;
      if (q < B * UC && j < H) cell(q, pf[i]);
    }
    for (int q = threadIdx.x + PF * THREADS; q < B * UC; q += THREADS) {
      const int b = q / UC, j = j0 + q - b * UC;
      if (j < H) cell(q, tc_cell_in<G>(a, t, b, j));
    }
    if (t > 0) {
      // the next step's cell inputs arrive while the grid waits
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        const int q = threadIdx.x + i * THREADS, b = q / UC,
                  j = j0 + q - b * UC;
        if (q < B * UC && j < H) pf[i] = tc_cell_in<G>(a, t - 1, b, j);
      }
    }
    grid.sync();   // every rank's columns of dgates_t are written
    // the block's partial dh [B][U] over its K slice, rows in passes
    for (int r0 = 0; r0 < B; r0 += rp) {
      const int rows = min(rp, B - r0), mtp = (rows + 15) / 16;
      if (k1w > k0w) {
        const int per = (k1w - k0w) / 8;
        for (int e = lane; e < rows * per; e += 32) {
          const int rr = e / per, k = k0w + (e - rr * per) * 8;
          uic_mma::cp16(ch_s + (size_t)rr * ldw + k,
                        dgt + (size_t)(r0 + rr) * ghp + kb + k, true);
        }
        uic_mma::commit();
        uic_mma::wait<0>();
      }
      __syncwarp();
      float acc[4][NT][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
              acc[mt][nt][3] = 0.0f;
      for (int k = k0w; k < k1w; k += 16) {
        unsigned bw[NT][2];
        if constexpr (NT == 1) {
          ldsm_x2(bw[0], wt_s + (size_t)(lane & 7) * ldw + k +
                             ((lane >> 3) & 1) * 8);
        } else {
          unsigned r[4];
          uic_mma::ldsm_x4(r, wt_s + (size_t)uic_mma::kmaj_row(lane) * ldw +
                                  k + uic_mma::kmaj_col(lane));
          bw[0][0] = r[0];
          bw[0][1] = r[1];
          bw[1][0] = r[2];
          bw[1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt < mtp) {
            unsigned af[4];
            uic_mma::ldsm_x4(
                af, ch_s + (size_t)(mt * 16 + uic_mma::frag_row(lane)) * ldw +
                        k + uic_mma::frag_col(lane));
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              uic_mma::mma(acc[mt][nt], af, bw[nt][0], bw[nt][1]);
          }
        }
      }
      __syncwarp();   // ch_s is read before the next pass restages it
      float* rw = red + (size_t)warp * rp * NPR;
      const int gq = lane / 4, q2 = (lane % 4) * 2;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= mtp) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* o = rw + (size_t)(mt * 16 + gq) * NPR + nt * 8 + q2;
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[mt][nt][0], acc[mt][nt][1]);
          *reinterpret_cast<float2*>(o + 8 * NPR) =
              make_float2(acc[mt][nt][2], acc[mt][nt][3]);
        }
      }
      __syncthreads();
      for (int q = threadIdx.x; q < rows * U; q += THREADS) {
        const int rr = q / U, u = q - rr * U;
        float s = 0.0f;
#pragma unroll
        for (int wp = 0; wp < WARPS; ++wp)
          s += red[((size_t)wp * rp + rr) * NPR + u];
        pd_s[(size_t)(r0 + rr) * U + u] = s;
      }
      __syncthreads();
    }
    // dh of this rank's units: the cluster's partials in rank order
    cluster.sync();
    for (int q = threadIdx.x; q < B * UC; q += THREADS) {
      const int b = q / UC, n = rank * UC + q - b * UC;
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < C; ++r)
        s += cluster.map_shared_rank(pd_s, r)[(size_t)b * U + n];
      dh_s[q] = s;
    }
    __syncthreads();
  }
  cluster.sync();   // no rank leaves while another reads its partial
  for (int q = threadIdx.x; q < B * UC; q += THREADS) {
    const int b = q / UC, j = j0 + q - b * UC;
    if (j < H) {
      stf(a.dh0, (size_t)b * H + j, dh_s[q], a.hb);
      stf(a.dc0, (size_t)b * H + j, dc_s[q], a.hb);
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

// One cooperative launch of the backward: clusters of C blocks, C x
// ceil(H / U) blocks, refused when they cannot be co-resident.
cudaError_t launch_coop_cluster(const void* kernel, int H, int U, int C,
                                size_t smem, void** args,
                                cudaStream_t stream) {
  if (smem > (size_t)SMEM_BUDGET) return cudaErrorCooperativeLaunchTooLarge;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int clusters = (H + U - 1) / U;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  int fit = 0;
  e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (fit < clusters) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int G, int U>
cudaError_t fwd_tc(const float* x, const void* h0, const void* c0,
                   const void* w, void* hs, void* cs, float* gates, int T,
                   int B, int H, cudaStream_t s) {
  const int rp =
      tc_rows(B, [&](int r) { return tc_fwd_smem<G, U>(B, H, r); });
  if (rp == 0) return cudaErrorCooperativeLaunchTooLarge;
  TcFwdArgs a{x, h0, c0, w, hs, cs, gates, T, B, H, rp,
              H % 8 == 0 && aligned(h0) && aligned(hs),
              H % 4 == 0 && aligned(x)};
  void* args[] = {&a};
  return launch_coop((const void*)chain_fwd_tc_kernel<G, U>, H, U,
                     tc_fwd_smem<G, U>(B, H, rp), args, s);
}

template <int G, int U, int C>
cudaError_t bwd_tc(const float* gates, const void* cs, const void* c0,
                   const void* dhs, const void* dcs, const void* w,
                   float* dgates, void* dh0, void* dc0, float* ws, int T,
                   int B, int H, int hb, cudaStream_t s) {
  const int rp =
      tc_rows(B, [&](int r) { return tc_bwd_smem<G, U, C>(B, H, r); });
  if (rp == 0) return cudaErrorCooperativeLaunchTooLarge;
  TcBwdArgs a{gates, cs, c0, dhs, dcs, w, dgates, dh0, dc0, ws, T, B, H,
              hb, rp};
  void* args[] = {&a};
  return launch_coop_cluster((const void*)chain_bwd_tc_kernel<G, U, C>, H, U,
                             C, tc_bwd_smem<G, U, C>(B, H, rp), args, s);
}

// The tensor-core instances' plans, each the first that fits (shared
// memory, and a grid that can be co-resident); a launch refused for room
// runs nothing, so the next plan is tried. The forward: 4 units a block,
// else 8 (the FMA core's plan). The backward: clusters of 2 blocks over 8
// units (H up to about 4 x the SM count), else over 16 (about 8 x).
template <int G>
cudaError_t fwd_tc_g(const float* x, const void* h0, const void* c0,
                     const void* w, void* hs, void* cs, float* gates, int T,
                     int B, int H, cudaStream_t s) {
  cudaError_t e = fwd_tc<G, 4>(x, h0, c0, w, hs, cs, gates, T, B, H, s);
  if (e == cudaErrorCooperativeLaunchTooLarge)
    e = fwd_tc<G, 8>(x, h0, c0, w, hs, cs, gates, T, B, H, s);
  return e;
}

template <int G>
cudaError_t bwd_tc_g(const float* gates, const void* cs, const void* c0,
                     const void* dhs, const void* dcs, const void* w,
                     float* dgates, void* dh0, void* dc0, float* ws, int T,
                     int B, int H, int hb, cudaStream_t s) {
  cudaError_t e = bwd_tc<G, 8, 2>(gates, cs, c0, dhs, dcs, w, dgates, dh0,
                                  dc0, ws, T, B, H, hb, s);
  if (e == cudaErrorCooperativeLaunchTooLarge)
    e = bwd_tc<G, 16, 2>(gates, cs, c0, dhs, dcs, w, dgates, dh0, dc0, ws, T,
                         B, H, hb, s);
  return e;
}

// The routing rule (kernels/lstm_block.py::tensor_core), JAX's cast points:
// the forward's h @ W is a product of two bf16 operands exactly when the
// carry and W are bf16 (types 3); the backward's dgates.astype(W's type)
// @ W^T whenever W is bf16 (types & 2).
bool chain_tc(int types, bool backward) {
  return backward ? (types & 2) != 0 : types == 3;
}

bool valid(int T, int B, int H, int G) {
  return T >= 1 && B >= 1 && H >= 1 && (G == 4 || G == 5);
}

}  // namespace

extern "C" {

// x [T, B, G*H], h0 / c0 [B, H], w [H, G*H] -> hs, cs [T, B, H], gates
// [T, B, G*H]; x and the gates f32, `types` bit 0: the carry (h0, c0, hs,
// cs) bf16, bit 1: w bf16. *route: 1 where the tensor-core instance ran
// (chain_tc), else 0.
int lstm_chain_fwd_mixed(const float* x, const void* h0, const void* c0,
                         const void* w, void* hs, void* cs, float* gates,
                         int T, int B, int H, int G, int types, int* route,
                         void* stream) {
  if (!valid(T, B, H, G) || types < 0 || types > 3)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int hb = types & 1, wb = (types >> 1) & 1;
  *route = chain_tc(types, false);
  if (*route)
    return (int)(G == 4 ? fwd_tc_g<4>(x, h0, c0, w, hs, cs, gates, T, B, H,
                                      s)
                        : fwd_tc_g<5>(x, h0, c0, w, hs, cs, gates, T, B, H,
                                      s));
  return (int)(G == 4 ? fwd_g<4>(x, h0, c0, w, hs, cs, gates, T, B, H, hb,
                                 wb, s)
                      : fwd_g<5>(x, h0, c0, w, hs, cs, gates, T, B, H, hb,
                                 wb, s));
}

// Floats of the backward's workspace into *n, for either instance: the FMA
// core's two buffers of every block's partial dh [B, H padded to 32], the
// tensor-core instance's two buffers of dgates_t in bf16 [B, G*H padded to
// 32]; 0 when H is too wide for a launch.
int lstm_chain_bwd_ws_f32(int B, int H, long long* n) {
  const int u = units_per_block(H);
  const long long fma = 2LL * ((H + u - 1) / u) * B * round_up(H, 32);
  const long long tc = (long long)B * round_up(5 * H, 32);   // bf16 [2][B][.]
  *n = u ? (fma > tc ? fma : tc) : 0;
  return 0;
}

// gates [T, B, G*H], cs / dhs / dcs [T, B, H], c0 [B, H], w [H, G*H], ws
// (lstm_chain_bwd_ws_f32 floats) -> dgates [T, B, G*H], dh0 / dc0 [B, H]
// (the carry: cs, c0, dhs, dcs, dh0, dc0; `types` and *route as the
// forward's)
int lstm_chain_bwd_mixed(const float* gates, const void* cs, const void* c0,
                         const void* dhs, const void* dcs, const void* w,
                         float* dgates, void* dh0, void* dc0, float* ws,
                         int T, int B, int H, int G, int types, int* route,
                         void* stream) {
  if (!valid(T, B, H, G) || types < 0 || types > 3)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int hb = types & 1, wb = (types >> 1) & 1;
  *route = chain_tc(types, true);
  if (*route)
    return (int)(G == 4 ? bwd_tc_g<4>(gates, cs, c0, dhs, dcs, w, dgates,
                                      dh0, dc0, ws, T, B, H, hb, s)
                        : bwd_tc_g<5>(gates, cs, c0, dhs, dcs, w, dgates,
                                      dh0, dc0, ws, T, B, H, hb, s));
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
