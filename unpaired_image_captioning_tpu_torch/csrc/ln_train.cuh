// Training LayerNorm (ln_train.cu) as a building block of other kernels.
#pragma once

#include <cuda_runtime.h>

namespace uic {

// floats of ln_bwd's scratch for rows of width d: a partial row of d_scale
// and d_offset for each block (a block an SM at most)
long long ln_bwd_ws_floats(int d);

// y = LN(x) over rows of d
int ln_fwd(const float* x, const float* scale, const float* offset, float* y,
           int rows, int d, float eps, cudaStream_t st);
// dx = res + d/dx LN(x) . dy (res may be null: no residual; it may be dx
// itself), and d_scale / d_offset summed over the rows in a fixed order, in
// one cooperative launch; ws holds ln_bwd_ws_floats(d) floats.
int ln_bwd(const float* x, const float* scale, const float* dy,
           const float* res, float* dx, float* dscale, float* doffset,
           float* ws, int rows, int d, float eps, cudaStream_t st);

}  // namespace uic
