// Exact chunked row-wise top-k for 16 < k <= 64, f32, in jax.lax.top_k
// order over the clamped row: the Hopper counterpart of the TPU kernel
// unpaired_image_captioning_tpu/ops/topk.py::_chunked_topk (its candidate
// ranking runs ::_row_topk_kernel, body ::_iterative_topk_body).
//
//   x [R, V] f32  ->  vals [R, k] f32, idx [R, k] int64
//
// What it computes. Every value is first clamped to [-FLT_MAX, FLT_MAX], as
// the TPU route clamps before its one-hot gather, so a selected -inf comes
// back as -3.4028235e38. Then the top k of the clamped row: values
// descending, ties to the lowest index. NaN is outside the domain.
//
// Design. One block of 512 threads per row.
//  1. The max of every 128-wide chunk (C = ceil(V / 128) of them) into
//     shared memory: one warp a chunk, four coalesced loads a lane.
//  2. The top k chunks by (max desc, chunk id asc): each chunk counts the
//     chunks that beat it and is selected if fewer than k do. A count of the
//     selected chunks below each selected one gives the ascending order.
//     Containment (topk.py:279-289): an element of the row's top k is beaten
//     by fewer than k elements, so fewer than k chunk maxima beat its chunk.
//  3. The k * 128 candidates are read a second time (from L2) in ascending
//     chunk order, so a candidate's flat index orders like its position.
//     Each thread keeps its candidates, at most 16 (k * 128 <= 512 * 16),
//     in a register list sorted by (value desc, index asc): it holds every
//     candidate it read, so nothing can be missed.
//  4. Each warp takes its own top k from its 32 lists: k rounds of a warp
//     arg-best (shuffles only), the winning lane pops its head. The 16
//     sorted warp lists go to shared memory, and one warp merges them in k
//     more rounds, a lane per list. No block barrier sits inside a round.
//
// What bounds it. The row is read once from device memory (V * 4 bytes)
// and the candidates once more from L2. The 2k selection rounds cost a
// few shuffles each and do not depend on V. Rounds of a block-wide
// arg-best instead (two barriers each) took about 1.7 us a round on an
// H100 at k = 32 and made the kernel slower than torch.topk there.

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <math_constants.h>

#include "topk.cuh"

namespace {

using uic::beats;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 128;
constexpr int MAX_K = 64;
constexpr int KM = MAX_K * CHUNK / THREADS;  // 16: a thread's candidates
// dynamic shared memory of the chunk maxima and flags, 8 bytes a chunk:
// with the 8 KB of warp lists, within the 48 KB a block may take without
// opting in
constexpr int MAX_CHUNKS = 4096;

__device__ __forceinline__ float clamp_finite(float v) {
  return fminf(fmaxf(v, -FLT_MAX), FLT_MAX);
}

__global__ void __launch_bounds__(THREADS)
chunked_topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                    long long* __restrict__ idx, int V, int C, int k) {
  extern __shared__ float smem[];
  float* cmax = smem;                         // [C] chunk maxima
  int* sel = reinterpret_cast<int*>(cmax + C);  // [C] 1 if a top-k chunk
  __shared__ int cid[MAX_K];                  // selected chunks, ascending
  __shared__ float wv[WARPS][MAX_K];          // each warp's top k, sorted
  __shared__ int wi[WARPS][MAX_K];

  const int row = blockIdx.x;
  const float* xr = x + (size_t)row * V;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // 1. chunk maxima
  for (int c = warp; c < C; c += WARPS) {
    float m = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < CHUNK / 32; ++j) {
      const int i = c * CHUNK + j * 32 + lane;
      if (i < V) m = fmaxf(m, clamp_finite(xr[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) cmax[c] = m;
  }
  __syncthreads();

  // 2. the top k chunks, then their ascending order
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float m = cmax[c];
    int above = 0;
    for (int o = 0; o < C; ++o) above += beats(cmax[o], o, m, c);
    sel[c] = above < k;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    if (sel[c]) {
      int pos = 0;
      for (int o = 0; o < c; ++o) pos += sel[o];
      cid[pos] = c;
    }
  }
  __syncthreads();

  // 3. each thread's candidates in a sorted register list
  float lv[KM];
  int li[KM];
  uic::list_reset(lv, li);
  const int n = k * CHUNK;
  for (int p = threadIdx.x; p < n; p += THREADS) {
    const int i = cid[p / CHUNK] * CHUNK + p % CHUNK;
    if (i >= V) continue;                     // the last chunk's tail
    uic::list_insert(lv, li, clamp_finite(xr[i]), i);
  }

  // 4a. each warp's top k over its lanes' lists. A real candidate (finite
  // after the clamp) beats the (-inf, INT_MAX) sentinel, and real indices
  // are unique, so every lane ends a butterfly with the same winner; once
  // a warp's candidates run out, every lane holds the same sentinel.
  for (int r = 0; r < k; ++r) {
    float bv = lv[0];
    int bi = li[0];
    uic::warp_best(bv, bi);
    if (lane == 0) { wv[warp][r] = bv; wi[warp][r] = bi; }
    if (li[0] == bi) uic::list_pop(lv, li);  // exactly one lane pops
  }
  __syncthreads();

  // 4b. warp 0 merges the WARPS sorted lists, lane w reading list w
  if (warp == 0) {
    int head = 0;
    for (int r = 0; r < k; ++r) {
      float hv = -CUDART_INF_F;
      int hi = INT_MAX;
      if (lane < WARPS && head < k) { hv = wv[lane][head]; hi = wi[lane][head]; }
      float bv = hv;
      int bi = hi;
      uic::warp_best(bv, bi);
      if (lane == 0) {
        vals[(size_t)row * k + r] = bv;
        idx[(size_t)row * k + r] = bi;
      }
      if (hi == bi) ++head;  // the list that held the winner moves on
    }
  }
}

}  // namespace

// Launches the chunked top-k of every row on `stream`: 1 <= k <= 64, at
// least k chunks (k * 128 <= V rounded up to a chunk) and at most
// MAX_CHUNKS. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments outside that domain).
extern "C" int chunked_topk_f32(const float* x, float* vals, long long* idx,
                                int R, int V, int k, cudaStream_t stream) {
  const int C = (V + CHUNK - 1) / CHUNK;
  if (k < 1 || k > MAX_K || V < 1 || C < k || C > MAX_CHUNKS)
    return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)C * (sizeof(float) + sizeof(int));
  chunked_topk_kernel<<<R, THREADS, smem, stream>>>(x, vals, idx, V, C, k);
  return (int)cudaGetLastError();
}
