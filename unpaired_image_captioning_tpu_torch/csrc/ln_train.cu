// Training LayerNorm, forward and backward, for Hopper (sm_90a). Replaces
// the TPU kernels unpaired_image_captioning_tpu/ops/ln_train.py::_fwd_kernel
// and ::_bwd_kernel (`fused_layer_norm`).
//
// The reference formula: per row of d values, in f32,
//   mean = sum(x) / d;  var = sum((x - mean)^2) / (d - 1)   (unbiased)
//   s = sqrt(var) + eps                                     (eps outside)
//   y = (x - mean) / s * scale + offset
// and its exact derivative (the Pallas kernel's `_bwd_kernel`):
//   dxhat = g scale;  dvar = sum(dxhat (x - mean)) (-1 / s^2) (0.5 / sqrt(var))
//   dmean = -sum(dxhat) / s
//   dx = dxhat / s + dvar (2 / (d - 1)) (x - mean) + dmean / d
//   d_scale = sum over rows of g (x - mean) / s;  d_offset = sum of g
//
// Types (the compute dtype). As the TPU kernel, x, scale / offset and the
// backward's g are each f32 or bf16: every operand is read in its own type
// through a converting load (bf16.cuh), the statistics and the derivative
// run in f32, y and dx are stored in x's type (rounded to nearest even),
// and d_scale / d_offset are summed in f32 and stored in scale's type
// (ops/ln_train.py:137-143 of the JAX package). All-f32 operands keep the
// f32 kernels below. A call with a bf16 x whose rows fit a warp's
// registers runs the typed register-row instances (see "Typed rows"
// below); every other typed call the general typed instances
// (ln_fwd_typed_kernel, ln_bwd_any_kernel<true>: scalar converting loads).
// The whole-layer kernels (layer_train.cu) also use the flags to round y
// and dx to bf16 values in their f32 scratch (LN_RND).
//
// What bounds it on the card: bytes. At [50, 196, 512] f32 the forward
// reads x and writes y (40 MB, 12 us at 3.35 TB/s) and the backward reads
// x and g and writes dx (60 MB, 18 us); the arithmetic is a few operations
// an element. The forward: a warp owns a row, reads it from device memory
// once (the second and third passes over the 2 KB row hit L1) and writes
// it once.
//
// The backward. The TPU carried d_scale / d_offset across its sequential
// grid; here blocks run in parallel, one a SM (a whole round of the card),
// and the column sums are taken in a fixed order so that a rerun gives the
// same bits (no float atomics):
//
//   ln_bwd_rows_kernel<NV> (d a multiple of 4, at most 1,024, 16-byte
//   rows): a warp owns a row and holds its x and g in registers, NV float4
//   a lane, read once with 16-byte loads; up to d = 512 the next row's
//   loads are in flight while a row is worked on. The row's mean, then its
//   variance and both sums of the derivative (sum dxhat (x - mean), sum
//   dxhat) in one pass and one interleaved warp reduction; dx (plus res)
//   goes out in 16-byte stores. A lane owns the same columns in every
//   row, so it keeps d_scale / d_offset for them in registers across its
//   warp's rows; the block's 16 warps are added once, in warp order,
//   through shared memory.
//   ln_bwd_any_kernel (every other d, rows off 16 bytes, d past 1,024): the
//   block takes rows in groups of a row per warp; each warp takes its row's
//   statistics walking the row through L1 / L2, then the block's threads
//   walk the columns, a thread a column over the group's rows (dx, and the
//   column sums kept in the block's partial row in device memory). Nothing
//   is held per column in shared memory, so nothing caps d.
//
// Both write one partial row a block and add the partials in the same
// launch: it is cooperative (every block resident, at most one an SM), so
// after a grid barrier the blocks share the columns and each column's
// partials are read at once, a lane a block, and summed in a fixed order.
// (The last block to finish, found by an integer ticket, summing the
// partials in two levels of groups cost 5 us of a 31 us call at [50, 196,
// 512] against 2.5 us for the barrier and the shared sum, on an H100.) The
// whole-layer kernels (layer_train.cu) call the forward and the backward
// through ln_train.cuh; their backward adds the residual gradient into dx
// (`res`).
//
// Typed rows (ln_fwd_rows_typed_kernel, ln_bwd_rows_typed_kernel): the
// register design above with the operands' types compiled in. A lane owns
// chunks of 8 columns (chunk lane + 32 i), the same in every row and in
// every operand: a bf16 chunk is one 16-byte load, an f32 chunk (B6 / B7's
// dy, f32 parameters) two, so bf16 x and f32 dy of one call meet in the
// same lane. The row's x, g and res come in once as raw chunks and are
// widened to f32 in registers; the next row's x and g are in flight while
// a row is worked on at every width the instances take (held raw, so a
// bf16 row costs half f32's registers); y and dx go out in 16-byte rounded
// stores. The forward keeps scale and offset for its columns in registers
// across a grid-stride walk of rows; the backward keeps d_scale / d_offset
// for them in f32 registers and ends as ln_bwd_rows_kernel does. They take
// a bf16 x, with y / dx and res bf16 and g or the parameters bf16 (the
// routes' mixtures: all bf16, bf16 x over f32 parameters, B6 / B7's f32
// dy), at d a multiple of 8 up to 1,024 on 16-byte pointers
// (kernels/ln_train.py::register_instance states the rule; uic::ln_fwd /
// ln_bwd report the route a call ran). A backward with two rows in flight
// and d_scale / d_offset kept in the warp's shared slot took 0.0211 ms
// against this design's 0.0182-0.0186 at [50, 196, 512] all bf16 on an
// H100: each row's chain of reductions and divisions, not the bytes in
// flight, sets the time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"
#include "gemm.cuh"
#include "ln_train.cuh"

namespace cg = cooperative_groups;

namespace {

using uic_bf16::bits;
using uic_bf16::hi;
using uic_bf16::ldf;
using uic_bf16::lo;
using uic_bf16::rnd_if;
using uic_bf16::stf;

constexpr int WARPS = 8;         // rows in flight per forward block
constexpr int ANY_WARPS = 32;    // rows a group of ln_bwd_any_kernel
constexpr int MAX_NV = 8;        // float4 a lane of the register kernels

// warps a block of ln_bwd_rows_kernel<NV> (a block a SM): 16, so that a
// lane may hold up to 128 registers: x, g, d_scale and d_offset take 16 NV,
// and up to NV = 4 (d <= 512) the next row's x and g 8 NV more
constexpr int ROWS_WARPS = 16;
__host__ __device__ constexpr bool rows_prefetch(int nv) { return nv <= 4; }

// The typed register-row instances: NV8 chunks of 8 columns a lane (d <=
// 1,024: NV8 <= 4). The backward's warps a block, at one block an SM, sized
// to the registers a lane needs (d_scale / d_offset, x and g widened: 32
// NV8; the next row's raw chunks and res: up to 16 NV8 more): 16 warps (128
// registers a lane) up to NV8 = 2 (d <= 512), 8 (255) past it. The
// forward's blocks have 8 warps, as many an SM as its registers allow.
constexpr int MAX_NV8 = 4;
constexpr int FWD_ROWS_WARPS = 8;
__host__ __device__ constexpr int typed_rows_warps(int nv8) {
  return nv8 <= 2 ? 16 : 8;
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 consecutive values of an operand as stored: bf16 (BF), one 16-byte
// load, or f32, two
template <bool BF>
struct Raw8;
template <>
struct Raw8<true> {
  uint4 u;
};
template <>
struct Raw8<false> {
  float4 a, b;
};

// chunk c (values 8c .. 8c + 7) of p, 16-byte aligned
template <bool BF>
__device__ __forceinline__ Raw8<BF> ld8(const void* p, size_t c) {
  if constexpr (BF) {
    return Raw8<true>{reinterpret_cast<const uint4*>(p)[c]};
  } else {
    const float4* q = reinterpret_cast<const float4*>(p) + 2 * c;
    return Raw8<false>{q[0], q[1]};
  }
}

template <bool BF>
__device__ __forceinline__ Raw8<BF> zero8() {
  if constexpr (BF)
    return Raw8<true>{make_uint4(0u, 0u, 0u, 0u)};
  else
    return Raw8<false>{make_float4(0.f, 0.f, 0.f, 0.f),
                       make_float4(0.f, 0.f, 0.f, 0.f)};
}

// the f32 values of a raw chunk (bf16 -> f32 is exact)
template <bool BF>
__device__ __forceinline__ void widen(const Raw8<BF>& r, float (&v)[8]) {
  if constexpr (BF) {
    const unsigned w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = lo(w[k]);
      v[2 * k + 1] = hi(w[k]);
    }
  } else {
    const float4 a = r.a, b = r.b;
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

// chunk c of p := v, rounded to nearest even where p is bf16 (BF)
template <bool BF>
__device__ __forceinline__ void st8(void* p, size_t c, const float (&v)[8]) {
  if constexpr (BF) {
    reinterpret_cast<uint4*>(p)[c] =
        make_uint4(bits(v[0]) | bits(v[1]) << 16, bits(v[2]) | bits(v[3]) << 16,
                   bits(v[4]) | bits(v[5]) << 16, bits(v[6]) | bits(v[7]) << 16);
  } else {
    float4* q = reinterpret_cast<float4*>(p) + 2 * c;
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

__device__ __forceinline__ float sum8(const float (&v)[8]) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

// mean and s = sqrt(var) + eps of one row, and sqrt(var)
__device__ __forceinline__ void row_stats(const float* xr, int d, float eps,
                                          int lane, float* mean, float* sd,
                                          float* root) {
  float s = 0.f;
  for (int j = lane; j < d; j += 32) s += xr[j];
  const float m = warp_sum(s) / (float)d;
  float q = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float t = xr[j] - m;
    q += t * t;
  }
  const float var = warp_sum(q) / (float)(d - 1);
  *mean = m;
  *root = sqrtf(var);
  *sd = *root + eps;
}

__global__ void __launch_bounds__(WARPS * 32)
    ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ offset, float* __restrict__ y,
                  int rows, int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * d;
  float* yr = y + (size_t)row * d;
  float mean, sd, root;
  row_stats(xr, d, eps, lane, &mean, &sd, &root);
  for (int j = lane; j < d; j += 32)
    yr[j] = (xr[j] - mean) / sd * scale[j] + offset[j];
}

// The row's backward coefficients from its sums: dx = dxhat / sd + c1 *
// (x - mean) + c2
// The forward over operands of any types (uic::LN_* flags): a warp a row,
// converting loads and rounding stores, the f32 kernel's sums otherwise.
__global__ void __launch_bounds__(WARPS * 32)
    ln_fwd_typed_kernel(const void* __restrict__ x,
                        const void* __restrict__ scale,
                        const void* __restrict__ offset, void* __restrict__ y,
                        int rows, int d, float eps, int fl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= rows) return;
  const bool xb = fl & uic::LN_X_BF, pb = fl & uic::LN_P_BF;
  const bool yb = fl & uic::LN_Y_BF, rnd = fl & uic::LN_RND;
  const size_t o = (size_t)row * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) s += ldf(x, o + j, xb);
  const float mean = warp_sum(s) / (float)d;
  float q = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float t = ldf(x, o + j, xb) - mean;
    q += t * t;
  }
  const float sd = sqrtf(warp_sum(q) / (float)(d - 1)) + eps;
  for (int j = lane; j < d; j += 32)
    stf(y, o + j,
        rnd_if((ldf(x, o + j, xb) - mean) / sd * ldf(scale, j, pb) +
                   ldf(offset, j, pb),
               rnd),
        yb);
}

// The forward over typed rows: x and y bf16, scale / offset of type PB
// (bf16 where true); a warp a row, walking rows by the grid's stride, the
// row read once into registers for both statistics and the output; rnd:
// y rounded to bf16 values (LN_RND)
template <bool PB, int NV8>
__global__ void __launch_bounds__(FWD_ROWS_WARPS * 32)
    ln_fwd_rows_typed_kernel(const void* __restrict__ x,
                             const void* __restrict__ scale,
                             const void* __restrict__ offset,
                             void* __restrict__ y, int rows, int d, float eps,
                             bool rnd) {
  constexpr int W = FWD_ROWS_WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d8 = d >> 3;
  float sc[NV8][8], of[NV8][8];
#pragma unroll
  for (int i = 0; i < NV8; ++i) {
    const int c = lane + 32 * i;
    widen(c < d8 ? ld8<PB>(scale, c) : zero8<PB>(), sc[i]);
    widen(c < d8 ? ld8<PB>(offset, c) : zero8<PB>(), of[i]);
  }
  // row r's chunks (zeros past the row or the rows)
  auto load = [&](int r, Raw8<true>* xo) {
    const size_t o = (size_t)r * d8;
#pragma unroll
    for (int i = 0; i < NV8; ++i) {
      const int c = lane + 32 * i;
      xo[i] = r < rows && c < d8 ? ld8<true>(x, o + c) : zero8<true>();
    }
  };
  const int stride = gridDim.x * W;
  Raw8<true> xn[NV8];
  load(blockIdx.x * W + warp, xn);
  for (int row = blockIdx.x * W + warp; row < rows; row += stride) {
    float u[NV8][8];
#pragma unroll
    for (int i = 0; i < NV8; ++i) widen(xn[i], u[i]);
    load(row + stride, xn);            // in flight while this row is worked
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV8; ++i) s += sum8(u[i]);
    const float mean = warp_sum(s) / (float)d;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < NV8; ++i) {
      if (lane + 32 * i >= d8) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        u[i][k] -= mean;
        q += u[i][k] * u[i][k];
      }
    }
    const float sd = sqrtf(warp_sum(q) / (float)(d - 1)) + eps;
    const size_t o = (size_t)row * d8;
#pragma unroll
    for (int i = 0; i < NV8; ++i) {
      const int c = lane + 32 * i;
      if (c >= d8) continue;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = rnd_if(u[i][k] / sd * sc[i][k] + of[i][k], rnd);
      st8<true>(y, o + c, v);
    }
  }
}

struct RowCoef {
  float sd, c1, c2;
};

__device__ __forceinline__ RowCoef row_coef(float q, float s1, float s2,
                                            int d, float eps) {
  const float var = q / (float)(d - 1);
  const float root = sqrtf(var), sd = root + eps;
  const float dvar = s1 * (-1.0f / (sd * sd)) * (0.5f / root);
  const float dmean = -s2 / sd;
  return RowCoef{sd, dvar * (2.0f / (float)(d - 1)), dmean / (float)d};
}

// d_scale / d_offset from the float4 c of a sum row ([2][dp])
// d_scale / d_offset, f32 or (pb) bf16, rounded
__device__ __forceinline__ void put_sums(float4 s, int c, int d, int dp,
                                         void* dscale, void* doffset,
                                         bool pb) {
  const float e[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * c + k;
    if (j < d)
      stf(dscale, j, e[k], pb);
    else if (j >= dp && j - dp < d)
      stf(doffset, j - dp, e[k], pb);
  }
}

// After every block has written its partial row ws[blockIdx.x] ([2][dp]:
// d_scale's d columns, then d_offset's, dp = d rounded up to 4), past a
// grid barrier: the blocks share the float4 columns, each column's rows
// read at once by ceil(blocks / 32) warps (a lane a row), summed in each
// warp by a butterfly and then over the warps in order: one round of
// loads, and the same order, so the same bits, on every run. Every thread
// of the block calls it.
__device__ void sum_partials(const float* ws, int d, void* dscale,
                             void* doffset, bool pb) {
  __shared__ float4 red[32];
  const int nblk = gridDim.x, dp = round4(d), n4 = dp / 2;
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  cg::this_grid().sync();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpc = (nblk + 31) / 32;              // warps a column
  const int cpp = (blockDim.x >> 5) / wpc;       // columns a pass
  for (int c0 = blockIdx.x * cpp; c0 < n4; c0 += gridDim.x * cpp) {
    const int col = c0 + warp / wpc, part = warp % wpc, r = part * 32 + lane;
    const bool mine = warp < cpp * wpc && col < n4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mine && r < nblk) v = __ldcg(w4 + (size_t)r * n4 + col);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
      v.z += __shfl_xor_sync(0xffffffffu, v.z, o);
      v.w += __shfl_xor_sync(0xffffffffu, v.w, o);
    }
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (mine && part == 0 && lane == 0) {
      float4 s = red[warp];
      for (int q = 1; q < wpc; ++q) {
        s.x += red[warp + q].x;
        s.y += red[warp + q].y;
        s.z += red[warp + q].z;
        s.w += red[warp + q].w;
      }
      put_sums(s, col, d, dp, dscale, doffset, pb);
    }
    __syncthreads();                   // red is the next pass's
  }
}

template <int NV>
__global__ void __launch_bounds__(ROWS_WARPS * 32, 1)
    ln_bwd_rows_kernel(const float* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ g, const float* res,
                       float* dx, float* __restrict__ ws,
                       float* __restrict__ dscale,
                       float* __restrict__ doffset, int rows, int d,
                       float eps) {
  constexpr int W = ROWS_WARPS;
  extern __shared__ __align__(16) float acc[];   // [W][2][d]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d4 = d >> 2;
  const float4* sc4 = reinterpret_cast<const float4*>(scale);
  float4 ds[NV], db[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    ds[i] = db[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // row r's x and g into the lane's registers (zeros past the row)
  auto load = [&](int r, float4* xo, float4* go) {
    const float4* xr = reinterpret_cast<const float4*>(x + (size_t)r * d);
    const float4* gr = reinterpret_cast<const float4*>(g + (size_t)r * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = lane + 32 * i;
      const bool in = r < rows && j < d4;
      xo[i] = in ? xr[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      go[i] = in ? gr[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  const int stride = gridDim.x * W;
  float4 xv[NV], gv[NV];
  load(blockIdx.x * W + warp, xv, gv);
  for (int row = blockIdx.x * W + warp; row < rows; row += stride) {
    // the next row's loads in flight while this one is worked on
    float4 xn[NV], gn[NV];
    if (rows_prefetch(NV)) load(row + stride, xn, gn);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) s += (xv[i].x + xv[i].y) + (xv[i].z + xv[i].w);
    const float mean = warp_sum(s) / (float)d;
    // x - mean in place; the variance and both sums of the derivative
    float q = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = lane + 32 * i;
      if (j >= d4) continue;
      const float4 sc = __ldg(sc4 + j);
      float4& u = xv[i];
      u.x -= mean;
      u.y -= mean;
      u.z -= mean;
      u.w -= mean;
      const float h0 = gv[i].x * sc.x, h1 = gv[i].y * sc.y,
                  h2 = gv[i].z * sc.z, h3 = gv[i].w * sc.w;
      q += (u.x * u.x + u.y * u.y) + (u.z * u.z + u.w * u.w);
      s1 += (h0 * u.x + h1 * u.y) + (h2 * u.z + h3 * u.w);
      s2 += (h0 + h1) + (h2 + h3);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {   // the three sums interleaved
      q += __shfl_xor_sync(0xffffffffu, q, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const RowCoef k = row_coef(q, s1, s2, d, eps);
    float4* dxr = reinterpret_cast<float4*>(dx + (size_t)row * d);
    const float4* rr =
        res ? reinterpret_cast<const float4*>(res + (size_t)row * d)
            : nullptr;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = lane + 32 * i;
      if (j >= d4) continue;
      const float4 sc = __ldg(sc4 + j), u = xv[i], gg = gv[i];
      float4 v = make_float4(gg.x * sc.x / k.sd + k.c1 * u.x + k.c2,
                             gg.y * sc.y / k.sd + k.c1 * u.y + k.c2,
                             gg.z * sc.z / k.sd + k.c1 * u.z + k.c2,
                             gg.w * sc.w / k.sd + k.c1 * u.w + k.c2);
      if (rr) {
        const float4 r = rr[j];
        v = make_float4(r.x + v.x, r.y + v.y, r.z + v.z, r.w + v.w);
      }
      dxr[j] = v;
      ds[i].x += gg.x * (u.x / k.sd);
      ds[i].y += gg.y * (u.y / k.sd);
      ds[i].z += gg.z * (u.z / k.sd);
      ds[i].w += gg.w * (u.w / k.sd);
      db[i].x += gg.x;
      db[i].y += gg.y;
      db[i].z += gg.z;
      db[i].w += gg.w;
    }
    if (rows_prefetch(NV)) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        xv[i] = xn[i];
        gv[i] = gn[i];
      }
    } else {
      load(row + stride, xv, gv);
    }
  }

  // the block's warps added in warp order into its partial row
  float4* a4 = reinterpret_cast<float4*>(acc);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + 32 * i;
    if (j < d4) {
      a4[(size_t)(2 * warp) * d4 + j] = ds[i];
      a4[(size_t)(2 * warp + 1) * d4 + j] = db[i];
    }
  }
  __syncthreads();
  float4* part = reinterpret_cast<float4*>(ws) + (size_t)blockIdx.x * 2 * d4;
  for (int c = threadIdx.x; c < 2 * d4; c += W * 32) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < W; ++w) {
      const float4 v = a4[(size_t)w * 2 * d4 + c];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    part[c] = s;
  }
  sum_partials(ws, d, dscale, doffset, false);
}

// The backward over typed rows: x, res and dx bf16, g of type GB, scale of
// type PB (bf16 where true); d_scale / d_offset bf16 where fl has
// LN_D_BF, dx rounded to bf16 values where it has LN_RND. ln_bwd_rows_kernel's
// design on raw chunks (see the file's head).
template <bool GB, bool PB, int NV8>
__global__ void __launch_bounds__(typed_rows_warps(NV8) * 32, 1)
    ln_bwd_rows_typed_kernel(const void* __restrict__ x,
                             const void* __restrict__ scale,
                             const void* __restrict__ g, const void* res,
                             void* dx, float* __restrict__ ws,
                             void* __restrict__ dscale,
                             void* __restrict__ doffset, int rows, int d,
                             float eps, int fl) {
  constexpr int W = typed_rows_warps(NV8);
  extern __shared__ __align__(16) float acc[];   // [W][2][d]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d8 = d >> 3, d4 = d >> 2;
  const bool rnd = fl & uic::LN_RND;
  float ds[NV8][8], db[NV8][8];
#pragma unroll
  for (int i = 0; i < NV8; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) ds[i][k] = db[i][k] = 0.f;

  // row r's x and g chunks (zeros past the row or the rows)
  auto load = [&](int r, Raw8<true>* xo, Raw8<GB>* go) {
    const size_t o = (size_t)r * d8;
#pragma unroll
    for (int i = 0; i < NV8; ++i) {
      const int c = lane + 32 * i;
      const bool in = r < rows && c < d8;
      xo[i] = in ? ld8<true>(x, o + c) : zero8<true>();
      go[i] = in ? ld8<GB>(g, o + c) : zero8<GB>();
    }
  };
  const int stride = gridDim.x * W;
  Raw8<true> xn[NV8];
  Raw8<GB> gn[NV8];
  load(blockIdx.x * W + warp, xn, gn);
  for (int row = blockIdx.x * W + warp; row < rows; row += stride) {
    const size_t o = (size_t)row * d8;
    float u[NV8][8], gg[NV8][8];
#pragma unroll
    for (int i = 0; i < NV8; ++i) {
      widen(xn[i], u[i]);
      widen(gn[i], gg[i]);
    }
    // this row's res, then the next row's x and g, in flight while this row
    // is worked on
    Raw8<true> rv[NV8];
#pragma unroll
    for (int i = 0; i < NV8; ++i)
      rv[i] = res && lane + 32 * i < d8 ? ld8<true>(res, o + lane + 32 * i)
                                        : zero8<true>();
    load(row + stride, xn, gn);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV8; ++i) s += sum8(u[i]);
    const float mean = warp_sum(s) / (float)d;
    // x - mean in place; the variance and both sums of the derivative
    float q = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV8; ++i) {
      const int c = lane + 32 * i;
      if (c >= d8) continue;
      float sc[8];
      widen(ld8<PB>(scale, c), sc);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        u[i][k] -= mean;
        const float h = gg[i][k] * sc[k];
        q += u[i][k] * u[i][k];
        s1 += h * u[i][k];
        s2 += h;
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {   // the three sums interleaved
      q += __shfl_xor_sync(0xffffffffu, q, m);
      s1 += __shfl_xor_sync(0xffffffffu, s1, m);
      s2 += __shfl_xor_sync(0xffffffffu, s2, m);
    }
    const RowCoef k = row_coef(q, s1, s2, d, eps);
#pragma unroll
    for (int i = 0; i < NV8; ++i) {
      const int c = lane + 32 * i;
      if (c >= d8) continue;
      float sc[8], r[8], v[8];
      widen(ld8<PB>(scale, c), sc);
      widen(rv[i], r);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float uu = u[i][j], gj = gg[i][j];
        const float w = gj * sc[j] / k.sd + k.c1 * uu + k.c2;
        v[j] = rnd_if(res ? r[j] + w : w, rnd);
        ds[i][j] += gj * (uu / k.sd);
        db[i][j] += gj;
      }
      st8<true>(dx, o + c, v);
    }
  }

  // the block's warps added in warp order into its partial row ([2][d]:
  // d_scale's columns, then d_offset's)
  float4* a4 = reinterpret_cast<float4*>(acc);
#pragma unroll
  for (int i = 0; i < NV8; ++i) {
    const int c = lane + 32 * i;
    if (c < d8) {
      float4* as = a4 + (size_t)(2 * warp) * d4 + 2 * c;
      float4* ab = a4 + (size_t)(2 * warp + 1) * d4 + 2 * c;
      as[0] = make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
      as[1] = make_float4(ds[i][4], ds[i][5], ds[i][6], ds[i][7]);
      ab[0] = make_float4(db[i][0], db[i][1], db[i][2], db[i][3]);
      ab[1] = make_float4(db[i][4], db[i][5], db[i][6], db[i][7]);
    }
  }
  __syncthreads();
  float4* part = reinterpret_cast<float4*>(ws) + (size_t)blockIdx.x * 2 * d4;
  for (int c = threadIdx.x; c < 2 * d4; c += W * 32) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < W; ++w) {
      const float4 v = a4[(size_t)w * 2 * d4 + c];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    part[c] = s;
  }
  sum_partials(ws, d, dscale, doffset, fl & uic::LN_D_BF);
}

// TYPED: the operands of any types (uic::LN_* flags in fl), read through
// converting loads, dx rounded where it is a bf16 value
template <bool TYPED>
__global__ void __launch_bounds__(ANY_WARPS * 32, 1)
    ln_bwd_any_kernel(const void* __restrict__ xv,
                      const void* __restrict__ scale_v,
                      const void* __restrict__ gv, const void* res,
                      void* dxv, float* __restrict__ ws,
                      void* __restrict__ dscale,
                      void* __restrict__ doffset, int rows, int d,
                      float eps, int fl) {
  __shared__ float st[ANY_WARPS][4];   // the group's mean, sd, c1, c2
  const bool xb = TYPED && (fl & uic::LN_X_BF);
  const bool gb = TYPED && (fl & uic::LN_G_BF);
  const bool rb = TYPED && (fl & uic::LN_R_BF);
  const bool pb = TYPED && (fl & uic::LN_P_BF);
  const bool yb = TYPED && (fl & uic::LN_Y_BF);
  const bool rnd = TYPED && (fl & uic::LN_RND);
  auto X = [&](size_t i) { return ldf(xv, i, xb); };
  auto G = [&](size_t i) { return ldf(gv, i, gb); };
  auto SC = [&](size_t i) { return ldf(scale_v, i, pb); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dp = round4(d);
  float* part = ws + (size_t)blockIdx.x * 2 * dp;
  bool first = true;
  for (int r0 = blockIdx.x * ANY_WARPS; r0 < rows;
       r0 += gridDim.x * ANY_WARPS) {
    const int row = r0 + warp;
    if (row < rows) {
      const size_t o = (size_t)row * d;
      float s = 0.f;
      for (int j = lane; j < d; j += 32) s += X(o + j);
      const float mean = warp_sum(s) / (float)d;
      float q = 0.f, s1 = 0.f, s2 = 0.f;
      for (int j = lane; j < d; j += 32) {
        const float u = X(o + j) - mean, h = G(o + j) * SC(j);
        q += u * u;
        s1 += h * u;
        s2 += h;
      }
      const RowCoef k =
          row_coef(warp_sum(q), warp_sum(s1), warp_sum(s2), d, eps);
      if (lane == 0) {
        st[warp][0] = mean;
        st[warp][1] = k.sd;
        st[warp][2] = k.c1;
        st[warp][3] = k.c2;
      }
    }
    __syncthreads();
    const int nr = min(ANY_WARPS, rows - r0);
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      const float sc = SC(j);
      float as = 0.f, ab = 0.f;
      for (int r = 0; r < nr; ++r) {
        const size_t o = (size_t)(r0 + r) * d + j;
        const float u = X(o) - st[r][0], gg = G(o), sd = st[r][1];
        const float v = gg * sc / sd + st[r][2] * u + st[r][3];
        stf(dxv, o, rnd_if(res ? ldf(res, o, rb) + v : v, rnd), yb);
        as += gg * (u / sd);
        ab += gg;
      }
      part[j] = first ? as : part[j] + as;
      part[dp + j] = first ? ab : part[dp + j] + ab;
    }
    first = false;
    __syncthreads();                   // st is the next group's
  }
  // a block without rows adds zeros; the columns past d are padding
  for (int j = threadIdx.x; j < dp; j += blockDim.x) {
    if (first || j >= d) {
      part[j] = 0.f;
      part[dp + j] = 0.f;
    }
  }
  sum_partials(ws, d, dscale, doffset, TYPED && (fl & uic::LN_D_BF));
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// One cooperative launch (its blocks all resident: the partial sums pass a
// grid barrier) of a block an SM at most and a row a warp at least.
template <typename K, typename... Extra>
int launch_bwd(K kernel, int warps, size_t smem, const void* x,
               const void* scale, const void* dy, const void* res,
               void* dx, void* dscale, void* doffset, float* ws, int rows,
               int d, float eps, cudaStream_t st, Extra... extra) {
  int nblk = cdiv(rows, warps);
  const int sms = uic::gemm_sm_count();
  nblk = nblk < 1 ? 1 : (nblk > sms ? sms : nblk);
  // (the partial sums' static shared memory comes on top of smem)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&x, &scale, &dy, &res, &dx, &ws, &dscale, &doffset,
                  &rows, &d, &eps, &extra...};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(nblk),
                                    dim3(warps * 32), args, smem, st);
  if (err != cudaSuccess) (void)cudaGetLastError();   // not left behind
  return (int)err;
}

template <int NV>
int launch_rows(const float* x, const float* scale, const float* dy,
                const float* res, float* dx, float* dscale, float* doffset,
                float* ws, int rows, int d, float eps, cudaStream_t st) {
  return launch_bwd(ln_bwd_rows_kernel<NV>, ROWS_WARPS,
                    sizeof(float) * (size_t)ROWS_WARPS * 2 * d, x, scale, dy,
                    res, dx,
                    dscale, doffset, ws, rows, d, eps, st);
}

// the launch of ln_bwd_any_kernel<TYPED>: args as the kernel takes them
template <bool TYPED>
int launch_any(const void* x, const void* scale, const void* dy,
               const void* res, void* dx, void* dscale, void* doffset,
               float* ws, int rows, int d, float eps, cudaStream_t st,
               int fl) {
  return launch_bwd(ln_bwd_any_kernel<TYPED>, ANY_WARPS, 0, x, scale, dy,
                    res, dx, dscale, doffset, ws, rows, d, eps, st, fl);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The typed register-row instances' rule (kernels/ln_train.py::
// register_instance): x bf16 with y / dx bf16, g or the parameters bf16
// (the routes' mixtures), and res bf16 where the call has one; d a
// multiple of 8 up to 1,024; every pointer on 16 bytes.
bool typed_rows(int d, int fl, bool aligned, bool has_res) {
  return (fl & uic::LN_X_BF) && (fl & uic::LN_Y_BF) &&
         (fl & (uic::LN_G_BF | uic::LN_P_BF)) && d % 8 == 0 &&
         d >= 8 && d <= 8 * 32 * MAX_NV8 && aligned &&
         (!has_res || (fl & uic::LN_R_BF));
}

template <bool PB, int NV8>
int launch_fwd_rows(const void* x, const void* scale, const void* offset,
                    void* y, int rows, int d, float eps, bool rnd,
                    cudaStream_t st) {
  constexpr int W = FWD_ROWS_WARPS;
  auto kernel = ln_fwd_rows_typed_kernel<PB, NV8>;
  static int per_sm = 0;   // resident blocks an SM (the grid's stride)
  if (per_sm < 1) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, W * 32, 0);
    if (err != cudaSuccess) return (int)err;
    per_sm = per_sm < 1 ? 1 : per_sm;
  }
  const int most = uic::gemm_sm_count() * per_sm;
  const int blocks = cdiv(rows, W) < most ? cdiv(rows, W) : most;
  kernel<<<blocks, W * 32, 0, st>>>(x, scale, offset, y, rows, d, eps, rnd);
  return (int)cudaGetLastError();
}

// the forward's typed register-row launch for the parameters' type and d
template <bool PB>
int fwd_rows(const void* x, const void* scale, const void* offset, void* y,
             int rows, int d, float eps, bool rnd, cudaStream_t st) {
  switch (cdiv(d / 8, 32)) {
    case 1: return launch_fwd_rows<PB, 1>(x, scale, offset, y, rows, d, eps,
                                          rnd, st);
    case 2: return launch_fwd_rows<PB, 2>(x, scale, offset, y, rows, d, eps,
                                          rnd, st);
    case 3: return launch_fwd_rows<PB, 3>(x, scale, offset, y, rows, d, eps,
                                          rnd, st);
    default: return launch_fwd_rows<PB, 4>(x, scale, offset, y, rows, d, eps,
                                           rnd, st);
  }
}

template <bool GB, bool PB, int NV8>
int launch_bwd_rows(const void* x, const void* scale, const void* dy,
                    const void* res, void* dx, void* dscale, void* doffset,
                    float* ws, int rows, int d, float eps, cudaStream_t st,
                    int fl) {
  constexpr int W = typed_rows_warps(NV8);
  const size_t smem = sizeof(float) * W * 2 * (size_t)d;   // [W][2][d]
  return launch_bwd(ln_bwd_rows_typed_kernel<GB, PB, NV8>, W, smem, x, scale,
                    dy, res, dx, dscale, doffset, ws, rows, d, eps, st, fl);
}

// the backward's typed register-row launch for g's and the parameters'
// types and d
template <bool GB, bool PB>
int bwd_rows(const void* x, const void* scale, const void* dy,
             const void* res, void* dx, void* dscale, void* doffset,
             float* ws, int rows, int d, float eps, cudaStream_t st, int fl) {
  switch (cdiv(d / 8, 32)) {
    case 1: return launch_bwd_rows<GB, PB, 1>(x, scale, dy, res, dx, dscale,
                                              doffset, ws, rows, d, eps, st,
                                              fl);
    case 2: return launch_bwd_rows<GB, PB, 2>(x, scale, dy, res, dx, dscale,
                                              doffset, ws, rows, d, eps, st,
                                              fl);
    case 3: return launch_bwd_rows<GB, PB, 3>(x, scale, dy, res, dx, dscale,
                                              doffset, ws, rows, d, eps, st,
                                              fl);
    default: return launch_bwd_rows<GB, PB, 4>(x, scale, dy, res, dx, dscale,
                                               doffset, ws, rows, d, eps, st,
                                               fl);
  }
}

}  // namespace

namespace uic {

long long ln_bwd_ws_floats(int d) {
  return (long long)gemm_sm_count() * 2 * round4(d);
}

int ln_fwd(const void* xv, const void* scale_v, const void* offset_v,
           void* yv, int rows, int d, float eps, cudaStream_t st, int fl,
           int* route) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  if (typed_rows(d, fl,
                 aligned16(xv) && aligned16(scale_v) && aligned16(offset_v) &&
                     aligned16(yv),
                 false)) {
    if (route) *route = LN_ROUTE_ROWS;
    return fl & LN_P_BF
               ? fwd_rows<true>(xv, scale_v, offset_v, yv, rows, d, eps,
                                fl & LN_RND, st)
               : fwd_rows<false>(xv, scale_v, offset_v, yv, rows, d, eps,
                                 fl & LN_RND, st);
  }
  if (route) *route = fl ? LN_ROUTE_TYPED : LN_ROUTE_F32;
  if (fl)
    ln_fwd_typed_kernel<<<blocks, WARPS * 32, 0, st>>>(
        xv, scale_v, offset_v, yv, rows, d, eps, fl);
  else
    ln_fwd_kernel<<<blocks, WARPS * 32, 0, st>>>(
        static_cast<const float*>(xv), static_cast<const float*>(scale_v),
        static_cast<const float*>(offset_v), static_cast<float*>(yv), rows,
        d, eps);
  return (int)cudaGetLastError();
}

int ln_bwd(const void* xv, const void* scale_v, const void* dyv,
           const void* res_v, void* dxv, void* dscale_v, void* doffset_v,
           float* ws, int rows, int d, float eps, cudaStream_t st, int fl,
           int* route) {
  if (d < 2 || rows < 0) return (int)cudaErrorInvalidValue;
  // operands of other types than f32: the typed register-row instances
  // where their rule holds (g or the parameters bf16: typed_rows), else the
  // typed instance of the general kernel (converting loads, rounding
  // stores)
  if (typed_rows(d, fl,
                 aligned16(xv) && aligned16(scale_v) && aligned16(dyv) &&
                     aligned16(dxv) && (!res_v || aligned16(res_v)),
                 res_v != nullptr)) {
    if (route) *route = LN_ROUTE_ROWS;
    switch (fl & (LN_G_BF | LN_P_BF)) {
      case LN_G_BF | LN_P_BF:
        return bwd_rows<true, true>(xv, scale_v, dyv, res_v, dxv, dscale_v,
                                    doffset_v, ws, rows, d, eps, st, fl);
      case LN_G_BF:
        return bwd_rows<true, false>(xv, scale_v, dyv, res_v, dxv, dscale_v,
                                     doffset_v, ws, rows, d, eps, st, fl);
      default:   // LN_P_BF
        return bwd_rows<false, true>(xv, scale_v, dyv, res_v, dxv, dscale_v,
                                     doffset_v, ws, rows, d, eps, st, fl);
    }
  }
  if (route) *route = fl ? LN_ROUTE_TYPED : LN_ROUTE_F32;
  if (fl)
    return launch_any<true>(xv, scale_v, dyv, res_v, dxv, dscale_v,
                            doffset_v, ws, rows, d, eps, st, fl);
  const float* x = static_cast<const float*>(xv);
  const float* scale = static_cast<const float*>(scale_v);
  const float* dy = static_cast<const float*>(dyv);
  const float* res = static_cast<const float*>(res_v);
  float* dx = static_cast<float*>(dxv);
  float* dscale = static_cast<float*>(dscale_v);
  float* doffset = static_cast<float*>(doffset_v);
  const int nv = (d / 4 + 31) / 32;
  const bool regs = d % 4 == 0 && nv <= MAX_NV && aligned16(x) &&
                    aligned16(scale) && aligned16(dy) && aligned16(dx) &&
                    (!res || aligned16(res));
  if (regs) {
    switch (nv) {
      case 1: return launch_rows<1>(x, scale, dy, res, dx, dscale, doffset,
                                    ws, rows, d, eps, st);
      case 2: return launch_rows<2>(x, scale, dy, res, dx, dscale, doffset,
                                    ws, rows, d, eps, st);
      case 3: return launch_rows<3>(x, scale, dy, res, dx, dscale, doffset,
                                    ws, rows, d, eps, st);
      case 4: return launch_rows<4>(x, scale, dy, res, dx, dscale, doffset,
                                    ws, rows, d, eps, st);
      case 5: return launch_rows<5>(x, scale, dy, res, dx, dscale, doffset,
                                    ws, rows, d, eps, st);
      case 6: return launch_rows<6>(x, scale, dy, res, dx, dscale, doffset,
                                    ws, rows, d, eps, st);
      case 7: return launch_rows<7>(x, scale, dy, res, dx, dscale, doffset,
                                    ws, rows, d, eps, st);
      default: return launch_rows<8>(x, scale, dy, res, dx, dscale, doffset,
                                     ws, rows, d, eps, st);
    }
  }
  return launch_any<false>(x, scale, dy, res, dx, dscale, doffset, ws, rows,
                          d, eps, st, 0);
}

}  // namespace uic

extern "C" {

// x, y [rows, d], scale / offset [d]; fl: the uic::LN_* types of the
// operands (y in x's type); *route (host) receives the uic::LN_ROUTE_* the
// call ran.
int ln_train_fwd_mixed(const void* x, const void* scale, const void* offset,
                       void* y, int rows, int d, float eps, int fl,
                       int* route, void* stream) {
  return uic::ln_fwd(x, scale, offset, y, rows, d, eps, (cudaStream_t)stream,
                     fl, route);
}

// Floats of the backward's scratch for width d into *n. Returns 0.
int ln_train_bwd_ws_f32(int d, long long* n) {
  *n = uic::ln_bwd_ws_floats(d);
  return 0;
}

// g, dx [rows, d]; ws scratch of ln_train_bwd_ws_f32(d) floats; dscale /
// doffset [d]. One launch. fl: the uic::LN_* types of the operands (x and
// g of one type, dx in it; d_scale / d_offset in scale's type); *route
// (host) receives the uic::LN_ROUTE_* the call ran.
int ln_train_bwd_mixed(const void* x, const void* scale, const void* g,
                       void* dx, void* dscale, void* doffset, float* ws,
                       int rows, int d, float eps, int fl, int* route,
                       void* stream) {
  return uic::ln_bwd(x, scale, g, nullptr, dx, dscale, doffset, ws, rows, d,
                     eps, (cudaStream_t)stream, fl, route);
}

}  // extern "C"
