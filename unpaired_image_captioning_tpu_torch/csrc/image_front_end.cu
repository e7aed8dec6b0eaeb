// Image front end, f32 out: the Hopper counterpart of the TPU kernel
// unpaired_image_captioning_tpu/ops/image.py::_front_end_kernel.
//
//   out[b, oh, ow, c] = (sum_h sum_w Rh[oh, h] Rw[ow, w] img[b, h, w, c] / 255
//                        - mean[c]) / std[c]
//
// img is uint8 [B, H, W, C], out f32 [B, Ho, Wo, C], both contiguous. Rh and
// Rw are the bilinear matrices of `_interp_matrix` (half-pixel centres,
// clamped edges). Each of their rows has at most two non-zero weights, so
// the wrapper hands the kernel each output row's and column's two taps (an
// index and a weight each, read off the same f32 matrices that the plain
// version multiplies): (h0, h1, a0, a1) per output row, (w0, w1, b0, b1)
// per output column. A matrix row with a single non-zero entry (both taps
// clamped onto one index, or a zero fraction) gives the taps (i, m) and
// (i, 0).
//
// Design. One block per output row (b, oh); its threads walk the row's
// Wo * C outputs, so consecutive threads write consecutive floats. Each
// output reads four uint8 values (rows h0 and h1 at columns w0 and w1),
// takes the H pass at both columns and then the W pass, in the order of the
// plain version's two products, and normalises with plain IEEE division (no
// fast math), so where the resize is the identity (taps (i, 1), (i, 0)) the
// result is bit-equal to (x / 255 - mean) / std computed on the host.
// There is no matrix product: the TPU kernel's two dense MXU products are
// 2 * C * (Ho * H * W + Ho * W * Wo) operations a image, about 25.5 GFLOP
// at [16, 480, 640, 3] -> 448^2, where the taps need 6 a output.
//
// What bounds it: bytes. The image is read once (14.7 MB at [16, 480, 640,
// 3]) and the f32 output written once (38.5 MB at 448^2): about 0.016 ms at
// 3.35 TB/s. The four taps of neighbouring outputs share cache lines, so
// the gathers are served from L1 and L2; the tap tables are a few KB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
front_end_kernel(const uint8_t* __restrict__ img,
                 const int* __restrict__ row_idx,     // [Ho, 2]
                 const float* __restrict__ row_w,     // [Ho, 2]
                 const int* __restrict__ col_idx,     // [Wo, 2]
                 const float* __restrict__ col_w,     // [Wo, 2]
                 const float* __restrict__ mean,      // [C]
                 const float* __restrict__ stdv,      // [C]
                 float* __restrict__ out, int H, int W, int C, int Ho,
                 int Wo) {
  const int row = blockIdx.x;                 // b * Ho + oh
  const int b = row / Ho;
  const int oh = row - b * Ho;
  const int h0 = row_idx[2 * oh], h1 = row_idx[2 * oh + 1];
  const float a0 = row_w[2 * oh], a1 = row_w[2 * oh + 1];
  const size_t pitch = (size_t)W * C;
  const uint8_t* r0 = img + ((size_t)b * H + h0) * pitch;
  const uint8_t* r1 = img + ((size_t)b * H + h1) * pitch;
  float* o = out + (size_t)row * Wo * C;
  const int n = Wo * C;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int ow = e / C;
    const int c = e - ow * C;
    const int x0 = col_idx[2 * ow] * C + c, x1 = col_idx[2 * ow + 1] * C + c;
    const float b0 = col_w[2 * ow], b1 = col_w[2 * ow + 1];
    // the H pass at the two source columns, then the W pass
    const float v0 = a0 * (float)r0[x0] + a1 * (float)r1[x0];
    const float v1 = a0 * (float)r0[x1] + a1 * (float)r1[x1];
    const float v = b0 * v0 + b1 * v1;
    o[e] = (v / 255.0f - mean[c]) / stdv[c];
  }
}

}  // namespace

extern "C" {

// img uint8 [B, H, W, C]; out f32 [B, Ho, Wo, C]; tap tables as above
int image_front_end_f32(const uint8_t* img, const int* row_idx,
                        const float* row_w, const int* col_idx,
                        const float* col_w, const float* mean,
                        const float* stdv, float* out, int B, int H, int W,
                        int C, int Ho, int Wo, void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  front_end_kernel<<<B * Ho, THREADS, 0, (cudaStream_t)stream>>>(
      img, row_idx, row_w, col_idx, col_w, mean, stdv, out, H, W, C, Ho, Wo);
  return (int)cudaGetLastError();
}

}  // extern "C"
