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
// (ops/ln_train.py:137-143 of the JAX package). Operands other than f32
// run the typed instances (ln_fwd_typed_kernel, ln_bwd_any_kernel<true>:
// scalar converting loads); all-f32 operands keep the f32 kernels below.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"
#include "gemm.cuh"
#include "ln_train.cuh"

namespace cg = cooperative_groups;

namespace {

using uic_bf16::ldf;
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

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

}  // namespace

namespace uic {

long long ln_bwd_ws_floats(int d) {
  return (long long)gemm_sm_count() * 2 * round4(d);
}

int ln_fwd(const void* xv, const void* scale_v, const void* offset_v,
           void* yv, int rows, int d, float eps, cudaStream_t st, int fl) {
  const int blocks = (rows + WARPS - 1) / WARPS;
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
           float* ws, int rows, int d, float eps, cudaStream_t st, int fl) {
  if (d < 2 || rows < 0) return (int)cudaErrorInvalidValue;
  // operands of other types than f32 take the typed instance of the
  // general kernel (converting loads, rounding stores)
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
// operands (y in x's type)
int ln_train_fwd_mixed(const void* x, const void* scale, const void* offset,
                       void* y, int rows, int d, float eps, int fl,
                       void* stream) {
  return uic::ln_fwd(x, scale, offset, y, rows, d, eps, (cudaStream_t)stream,
                     fl);
}

// Floats of the backward's scratch for width d into *n. Returns 0.
int ln_train_bwd_ws_f32(int d, long long* n) {
  *n = uic::ln_bwd_ws_floats(d);
  return 0;
}

// g, dx [rows, d]; ws scratch of ln_train_bwd_ws_f32(d) floats; dscale /
// doffset [d]. One launch. fl: the uic::LN_* types of the operands (x and
// g of one type, dx in it; d_scale / d_offset in scale's type).
int ln_train_bwd_mixed(const void* x, const void* scale, const void* g,
                       void* dx, void* dscale, void* doffset, float* ws,
                       int rows, int d, float eps, int fl, void* stream) {
  return uic::ln_bwd(x, scale, g, nullptr, dx, dscale, doffset, ws, rows, d,
                     eps, (cudaStream_t)stream, fl);
}

}  // extern "C"
