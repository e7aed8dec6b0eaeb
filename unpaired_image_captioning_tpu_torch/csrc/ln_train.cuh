// Training LayerNorm (ln_train.cu) as a building block of other kernels.
#pragma once

#include <cuda_runtime.h>

namespace uic {

// floats of ln_bwd's scratch for rows of width d: a partial row of d_scale
// and d_offset for each block (a block an SM at most)
long long ln_bwd_ws_floats(int d);

// The operands' types (the compute dtype): each flag names an array stored
// as bf16 (read through a converting load, written rounded to nearest
// even); LN_RND rounds y / dx to bf16 values where they stay in an f32
// array (a bf16 computation kept in f32 scratch). 0: every array f32, the
// f32 kernels.
constexpr int LN_X_BF = 1;    // x
constexpr int LN_P_BF = 2;    // scale and offset
constexpr int LN_Y_BF = 4;    // y (the backward's dx)
constexpr int LN_G_BF = 8;    // the backward's dy
constexpr int LN_R_BF = 16;   // the backward's res
constexpr int LN_RND = 32;    // y / dx rounded to bf16 values
constexpr int LN_D_BF = 64;   // d_scale and d_offset (summed in f32)

// The instances a call ran (*route where the caller asks): the f32
// kernels, the general typed instances, or the typed register-row ones
// (kernels/ln_train.py::register_instance states when).
constexpr int LN_ROUTE_F32 = 0;
constexpr int LN_ROUTE_TYPED = 1;
constexpr int LN_ROUTE_ROWS = 2;

// y = LN(x) over rows of d
int ln_fwd(const void* x, const void* scale, const void* offset, void* y,
           int rows, int d, float eps, cudaStream_t st, int fl = 0,
           int* route = nullptr);
// dx = res + d/dx LN(x) . dy (res may be null: no residual; it may be dx
// itself), and d_scale / d_offset summed over the rows in a fixed order, in
// one cooperative launch; ws holds ln_bwd_ws_floats(d) floats.
int ln_bwd(const void* x, const void* scale, const void* dy,
           const void* res, void* dx, void* dscale, void* doffset,
           float* ws, int rows, int d, float eps, cudaStream_t st,
           int fl = 0, int* route = nullptr);

}  // namespace uic
