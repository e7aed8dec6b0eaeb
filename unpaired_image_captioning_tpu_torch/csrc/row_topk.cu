// Exact row-wise top-k, f32, in jax.lax.top_k order: the Hopper counterpart
// of the TPU kernels unpaired_image_captioning_tpu/ops/topk.py
// ::_lane_topk_kernel and ::_row_topk_kernel (its exact fallback).
//
//   x [R, V] f32  ->  vals [R, k] f32, idx [R, k] int64
//
// Order (topk.cuh): element a beats element b iff a.v > b.v, or a.v == b.v
// and a.i < b.i. So values come out descending and ties go to the lowest
// index; rows holding -inf return ascending indices among the -inf entries,
// as lax.top_k does. NaN never beats anything and is never selected.
//
// Design. One block per row. Each thread scans a strided slice of the row
// (coalesced: thread t reads t, t + T, ...) and keeps the best KM >= k
// (value, index) pairs of its slice in a register list sorted by the order
// above. Every element of the row's true top-k is in its own thread's list,
// because fewer than k elements of the row beat it. Then k rounds of a
// block-wide arg-best over the thread heads (warp shuffles, then one value
// per warp through shared memory) pick the winners in order; the winning
// thread pops its head. The result is exact by construction: there is no
// candidate set that can miss, so no witness and no fallback pass, unlike
// the TPU lane kernel. Sentinels are (-inf, INT_MAX), which every real
// element beats.
//
// What bounds it. The row is read once (V * 4 bytes); the selection rounds
// cost k * (5 shuffles + 2 barriers) per block and are independent of V.
// At the path's shapes (R = 150..750 rows of V = 8571..9488) the read is
// 6 to 26 MB, so the kernel is bound by the HBM read at large R and by the
// k barrier rounds at small R.

#include <cuda_runtime.h>

#include "topk.cuh"

namespace {

using uic::beats;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <int KM>
__global__ void __launch_bounds__(THREADS)
row_topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                long long* __restrict__ idx, int V, int k) {
  __shared__ float sv[WARPS];
  __shared__ int si[WARPS];

  const int row = blockIdx.x;
  const float* xr = x + (size_t)row * V;

  float lv[KM];
  int li[KM];
  uic::list_reset(lv, li);
  for (int i = threadIdx.x; i < V; i += THREADS)
    uic::list_insert(lv, li, xr[i], i);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = 0; r < k; ++r) {
    float bv = lv[0];
    int bi = li[0];
    uic::warp_best(bv, bi);
    if (lane == 0) { sv[warp] = bv; si[warp] = bi; }
    __syncthreads();
    bv = sv[0];
    bi = si[0];
#pragma unroll
    for (int wi = 1; wi < WARPS; ++wi)
      if (beats(sv[wi], si[wi], bv, bi)) { bv = sv[wi]; bi = si[wi]; }
    __syncthreads();  // every thread has read sv/si before the next round
    if (threadIdx.x == 0) {
      vals[(size_t)row * k + r] = bv;
      idx[(size_t)row * k + r] = bi;
    }
    if (li[0] == bi) uic::list_pop(lv, li);  // unique indices: one pops
  }
}

template <int KM>
void launch(const float* x, float* vals, long long* idx, int R, int V, int k,
            cudaStream_t stream) {
  row_topk_kernel<KM><<<R, THREADS, 0, stream>>>(x, vals, idx, V, k);
}

}  // namespace

// Launches the top-k of every row on `stream`; 1 <= k <= 16 and k <= V.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported k).
extern "C" int row_topk_f32(const float* x, float* vals, long long* idx,
                            int R, int V, int k, cudaStream_t stream) {
  if (k < 1 || k > 16 || k > V) return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaGetLastError();
  if (k <= 1) launch<1>(x, vals, idx, R, V, k, stream);
  else if (k <= 2) launch<2>(x, vals, idx, R, V, k, stream);
  else if (k <= 4) launch<4>(x, vals, idx, R, V, k, stream);
  else if (k <= 8) launch<8>(x, vals, idx, R, V, k, stream);
  else launch<16>(x, vals, idx, R, V, k, stream);
  return (int)cudaGetLastError();
}
