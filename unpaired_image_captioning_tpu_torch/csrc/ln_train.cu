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
// What bounds it on the card: bytes. At [50, 196, 512] f32 the forward
// reads x and writes y (40 MB, 12 us at 3.35 TB/s) and the backward reads
// x and g and writes dx (60 MB, 18 us); the arithmetic is a few operations
// an element. So a warp owns a row, reads it from device memory once (the
// second and third passes over the 2 KB row hit L1) and writes it once. The
// TPU carried d_scale / d_offset across its sequential grid; here blocks
// run in parallel, so each block of the backward sums its rows' terms in
// shared memory (warp by warp, in order) and writes one partial row, and a
// second kernel adds the partials in block order: no float atomics, the
// same bits every run. The whole-layer kernels (layer_train.cu) call the
// forward and the backward through ln_train.cuh; their backward adds the
// residual gradient into dx (`res`).

#include <cuda_runtime.h>
#include <math.h>

#include "ln_train.cuh"

namespace {

constexpr int WARPS = 8;         // rows in flight per block
constexpr int RED_GROUPS = 8;    // row groups per column in the reduction

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

// dx (plus res where given) for the block's rows, and the block's partial
// d_scale / d_offset into partial [gridDim.x][2][d]
__global__ void __launch_bounds__(WARPS * 32)
    ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ g, const float* __restrict__ res,
                  float* __restrict__ dx, float* __restrict__ partial,
                  int rows, int d, float eps) {
  extern __shared__ float acc[];  // [WARPS][2][d]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ads = acc + (size_t)warp * 2 * d;
  float* adb = ads + d;
  for (int j = lane; j < d; j += 32) ads[j] = adb[j] = 0.f;
  const float two_n1 = 2.0f / (float)(d - 1);
  for (int row = blockIdx.x * WARPS + warp; row < rows;
       row += gridDim.x * WARPS) {
    const float* xr = x + (size_t)row * d;
    const float* gr = g + (size_t)row * d;
    float mean, sd, root;
    row_stats(xr, d, eps, lane, &mean, &sd, &root);
    float s1 = 0.f, s2 = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float dxhat = gr[j] * scale[j];
      s1 += dxhat * (xr[j] - mean);
      s2 += dxhat;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float dvar = s1 * (-1.0f / (sd * sd)) * (0.5f / root);
    const float dmean = -s2 / sd;
    float* dxr = dx + (size_t)row * d;
    const float* rr = res ? res + (size_t)row * d : nullptr;
    for (int j = lane; j < d; j += 32) {
      const float xm = xr[j] - mean, gj = gr[j];
      const float v = gj * scale[j] / sd + dvar * two_n1 * xm + dmean / (float)d;
      dxr[j] = rr ? rr[j] + v : v;
      ads[j] += gj * (xm / sd);
      adb[j] += gj;
    }
  }
  __syncthreads();
  float* pb = partial + (size_t)blockIdx.x * 2 * d;
  for (int j = threadIdx.x; j < d; j += WARPS * 32) {
    float s = 0.f, t = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      s += acc[(size_t)w * 2 * d + j];
      t += acc[(size_t)w * 2 * d + d + j];
    }
    pb[j] = s;
    pb[d + j] = t;
  }
}

// d_scale / d_offset = the partials summed in block order. A block takes 32
// columns; its RED_GROUPS warps each sum every RED_GROUPS-th partial, then
// warp 0 adds the group sums in order.
__global__ void __launch_bounds__(RED_GROUPS * 32)
    ln_bwd_reduce_kernel(const float* __restrict__ partial, int nblk, int d,
                         float* __restrict__ dscale,
                         float* __restrict__ doffset) {
  __shared__ float part[RED_GROUPS][2][32];
  const int grp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f, t = 0.f;
  if (j < d) {
    for (int b = grp; b < nblk; b += RED_GROUPS) {
      s += partial[(size_t)b * 2 * d + j];
      t += partial[(size_t)b * 2 * d + d + j];
    }
  }
  part[grp][0][lane] = s;
  part[grp][1][lane] = t;
  __syncthreads();
  if (grp == 0 && j < d) {
    float ss = 0.f, tt = 0.f;
    for (int q = 0; q < RED_GROUPS; ++q) {
      ss += part[q][0][lane];
      tt += part[q][1][lane];
    }
    dscale[j] = ss;
    doffset[j] = tt;
  }
}

}  // namespace

namespace uic {

int ln_fwd(const float* x, const float* scale, const float* offset, float* y,
           int rows, int d, float eps, cudaStream_t st) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  ln_fwd_kernel<<<blocks, WARPS * 32, 0, st>>>(x, scale, offset, y, rows, d,
                                               eps);
  return (int)cudaGetLastError();
}

int ln_bwd(const float* x, const float* scale, const float* dy,
           const float* res, float* dx, float* dscale, float* doffset,
           float* partial, int rows, int d, int nblk, float eps,
           cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)WARPS * 2 * d;
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ln_bwd_kernel<<<nblk, WARPS * 32, smem, st>>>(x, scale, dy, res, dx,
                                                partial, rows, d, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_bwd_reduce_kernel<<<(d + 31) / 32, RED_GROUPS * 32, 0, st>>>(
      partial, nblk, d, dscale, doffset);
  return (int)cudaGetLastError();
}

}  // namespace uic

extern "C" {

// x, y [rows, d] f32, scale / offset [d]
int ln_train_fwd_f32(const float* x, const float* scale, const float* offset,
                     float* y, int rows, int d, float eps, void* stream) {
  return uic::ln_fwd(x, scale, offset, y, rows, d, eps, (cudaStream_t)stream);
}

// g, dx [rows, d]; partial scratch [nblk, 2, d] with nblk blocks of the
// first kernel; dscale / doffset [d]
int ln_train_bwd_f32(const float* x, const float* scale, const float* g,
                     float* dx, float* dscale, float* doffset, float* partial,
                     int rows, int d, int nblk, float eps, void* stream) {
  return uic::ln_bwd(x, scale, g, nullptr, dx, dscale, doffset, partial, rows,
                     d, nblk, eps, (cudaStream_t)stream);
}

}  // extern "C"
