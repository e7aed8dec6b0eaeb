// Training multi-head attention (mha_train.cu) as a building block of other
// kernels: the dropout hash, and host launchers over strided q / k / v, so
// that a caller can attend over the column blocks of a packed [rows, 3d]
// projection and draw the dropout of any block-id mapping.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace uic {

// `_keep_mask` of the Pallas kernels: a splitmix32 hash of (seed, block id
// pid, element index) kept where it reaches floor(rate * 2^32)
__device__ __forceinline__ uint32_t hash_base(int seed, int pid) {
  return ((uint32_t)seed * 0x9E3779B9u) ^ ((uint32_t)pid * 0x85EBCA6Bu);
}

__device__ __forceinline__ uint32_t keep_hash(uint32_t base, uint32_t idx) {
  uint32_t x = base ^ (idx * 0x2545F491u);
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// One attention call. Row r of batch element b of q is q + (b*T + r) * lq,
// head h its columns [h*dh, (h+1)*dh); likewise k and v over S rows with
// lk / lv. The output, the upstream gradient g and the forward output o
// have row stride lo; dq / dk / dv the strides of q / k / v. mask is
// [B, mask_rows, S] (< 0: masked). The dropout of head h of element b draws
// block id b * pid_b + h (pid_b = H for the attention kernel alone, 4H at
// site 0 of the whole-layer kernels). Every pointer and row stride is a
// multiple of 16 bytes (the tiles are copied with 16-byte cp.async).
struct Attn {
  const float* q;
  const float* k;
  const float* v;
  const float* mask;
  const int* seed;   // one int32 on the card
  int lq, lk, lv, lo;
  int B, T, S, H, dh, mask_rows, pid_b;
  unsigned int thresh;
  float keep_div;
  int dropout;
};

// The compiled head-width bucket that runs dh (32, 64, 128 or 256), 0 if
// the kernels refuse dh (not a multiple of 4, or above 256).
int attn_bucket(int dh);

// Floats of a backward's scratch: the rows' g . o [B*H*T] (rounded up to
// 4), then ds / sqrt(dh) [B, H, T, S rounded up to 4].
inline size_t attn_dsum_floats(int B, int H, int T) {
  return ((size_t)B * H * T + 3) / 4 * 4;
}
inline size_t attn_bwd_scratch_floats(int B, int H, int T, int S) {
  return attn_dsum_floats(B, H, T) + (size_t)B * H * T * ((S + 3) / 4 * 4);
}

// out = attention(q, k, v) and the rows' softmax statistics;
// dh a multiple of 4 up to 256 (attn_bucket), any S
int attn_fwd(const Attn& a, float* out, float* stats, cudaStream_t st);
// dq, dk, dv for the upstream gradient g, from the forward's output o and
// statistics; scratch of attn_bwd_scratch_floats(B, H, T, S) floats
int attn_bwd(const Attn& a, const float* g, const float* o,
             const float* stats, float* dq, float* dk, float* dv,
             float* scratch, cudaStream_t st);

}  // namespace uic
