// The pieces of the exact top-k shared by row_topk.cu and chunked_topk.cu.
//
// Order: element a beats element b iff a.v > b.v, or a.v == b.v and
// a.i < b.i (jax.lax.top_k's order: values descending, ties to the lowest
// index). A thread keeps its best KM (value, index) pairs in a register list
// sorted by that order; the sentinel (-inf, INT_MAX) fills the empty slots
// and every real element beats it. The lists are indexed with constants
// only once these functions are inlined and their loops unrolled, so they
// stay in registers.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

namespace uic {

__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

template <int KM>
__device__ __forceinline__ void list_reset(float (&lv)[KM], int (&li)[KM]) {
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    lv[j] = -CUDART_INF_F;
    li[j] = INT_MAX;
  }
}

// Puts (v, i) into the sorted list if it beats the list's last entry.
template <int KM>
__device__ __forceinline__ void list_insert(float (&lv)[KM], int (&li)[KM],
                                            float v, int i) {
  if (!beats(v, i, lv[KM - 1], li[KM - 1])) return;
  lv[KM - 1] = v;
  li[KM - 1] = i;
#pragma unroll
  for (int j = KM - 1; j > 0; --j) {
    if (beats(lv[j], li[j], lv[j - 1], li[j - 1])) {
      const float tv = lv[j]; lv[j] = lv[j - 1]; lv[j - 1] = tv;
      const int ti = li[j]; li[j] = li[j - 1]; li[j - 1] = ti;
    }
  }
}

// Drops the list's head; the sentinel enters at the back.
template <int KM>
__device__ __forceinline__ void list_pop(float (&lv)[KM], int (&li)[KM]) {
#pragma unroll
  for (int j = 0; j < KM - 1; ++j) { lv[j] = lv[j + 1]; li[j] = li[j + 1]; }
  lv[KM - 1] = -CUDART_INF_F;
  li[KM - 1] = INT_MAX;
}

// The best (bv, bi) of the warp's 32 lanes, left in every lane.
__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (beats(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
}

}  // namespace uic
