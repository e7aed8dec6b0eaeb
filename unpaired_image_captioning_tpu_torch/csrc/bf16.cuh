// Converting loads and rounding stores for operands kept as f32 or bf16.
//
// The TPU kernels read every operand in its own type, convert it to f32,
// accumulate and run their epilogues in f32, and store in the output's type
// (`.astype(out.dtype)`). The kernels here do the same: an operand that may
// be bf16 is passed as `const void*` with a flag, read through `ldf` / `ld4`
// (bf16 -> f32 is exact: the 16 bits shifted up), and a result that may be
// bf16 is written through `stf`, which rounds to nearest even
// (`__float2bfloat16_rn`; NaN stays NaN, past the bf16 range goes to inf),
// as XLA's convert does.

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace uic_bf16 {

// the f32 value of the bf16 held in the low 16 bits of u
__device__ __forceinline__ float lo(unsigned u) { return __uint_as_float(u << 16); }
// the f32 value of the bf16 held in the high 16 bits of u
__device__ __forceinline__ float hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// element i of an array stored as bf16 (BF) or f32
template <bool BF>
__device__ __forceinline__ float ldt(const void* p, size_t i) {
  if constexpr (BF)
    return lo((unsigned)reinterpret_cast<const unsigned short*>(p)[i]);
  else
    return reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float ldf(const void* p, size_t i, bool bf) {
  return bf ? ldt<true>(p, i) : ldt<false>(p, i);
}

// elements i .. i + 3 (i a multiple of 4; the array 16-byte aligned)
template <bool BF>
__device__ __forceinline__ float4 ld4t(const void* p, size_t i) {
  if constexpr (BF) {
    const uint2 v = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const unsigned short*>(p) + i);
    return make_float4(lo(v.x), hi(v.x), lo(v.y), hi(v.y));
  } else {
    return *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) +
                                            i);
  }
}

__device__ __forceinline__ float4 ld4(const void* p, size_t i, bool bf) {
  return bf ? ld4t<true>(p, i) : ld4t<false>(p, i);
}

// the same through L2 only (rows written by other blocks of the launch)
__device__ __forceinline__ float4 ld4cg(const void* p, size_t i, bool bf) {
  if (bf) {
    const uint2 v = __ldcg(reinterpret_cast<const uint2*>(
        reinterpret_cast<const unsigned short*>(p) + i));
    return make_float4(lo(v.x), hi(v.x), lo(v.y), hi(v.y));
  }
  return __ldcg(reinterpret_cast<const float4*>(
      reinterpret_cast<const float*>(p) + i));
}

__device__ __forceinline__ float ldcg(const void* p, size_t i, bool bf) {
  if (bf)
    return lo((unsigned)__ldcg(reinterpret_cast<const unsigned short*>(p) + i));
  return __ldcg(reinterpret_cast<const float*>(p) + i);
}

// v rounded to bf16 and back (the value a bf16 carry holds)
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// store v at element i, rounded to nearest even where the array is bf16
__device__ __forceinline__ void stf(void* p, size_t i, float v, bool bf) {
  if (bf)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

// the bf16 bits of v (round to nearest even), in the low 16 bits
__device__ __forceinline__ unsigned bits(float v) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// elements i .. i + 3 (i a multiple of 4; a bf16 array 8-byte aligned, an
// f32 one 16-byte aligned), rounded where the array is bf16
__device__ __forceinline__ void st4(void* p, size_t i, float4 v, bool bf) {
  if (bf) {
    *reinterpret_cast<uint2*>(reinterpret_cast<unsigned short*>(p) + i) =
        make_uint2(bits(v.x) | bits(v.y) << 16, bits(v.z) | bits(v.w) << 16);
  } else {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(p) + i) = v;
  }
}

// v rounded to bf16 and back where `rnd` (a cast point of a bf16
// computation whose value stays in an f32 buffer), else v
__device__ __forceinline__ float rnd_if(float v, bool rnd) {
  return rnd ? round_bf16(v) : v;
}

__device__ __forceinline__ float4 rnd4_if(float4 v, bool rnd) {
  return rnd ? make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                           round_bf16(v.w))
             : v;
}

// a finite v rounded to bf16 (nearest even) on the host, as a value
inline float host_round_bf16(float v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  memcpy(&v, &u, 4);
  return v;
}

}  // namespace uic_bf16
