// Training LayerNorm (ln_train.cu) as a building block of other kernels.
#pragma once

#include <cuda_runtime.h>

namespace uic {

constexpr int LN_BWD_MAX_BLOCKS = 264;  // two blocks per SM of the H100's 132

// blocks of ln_bwd for `rows` rows; its partial scratch is [nblk, 2, d]
inline int ln_bwd_blocks(int rows) {
  const int n = (rows + 7) / 8;
  return n < 1 ? 1 : (n > LN_BWD_MAX_BLOCKS ? LN_BWD_MAX_BLOCKS : n);
}

// y = LN(x) over rows of d
int ln_fwd(const float* x, const float* scale, const float* offset, float* y,
           int rows, int d, float eps, cudaStream_t st);
// dx = res + d/dx LN(x) . dy (res may be null: no residual), and d_scale /
// d_offset summed over the rows in a fixed order; partial [nblk, 2, d]
int ln_bwd(const float* x, const float* scale, const float* dy,
           const float* res, float* dx, float* dscale, float* doffset,
           float* partial, int rows, int d, int nblk, float eps,
           cudaStream_t st);

}  // namespace uic
