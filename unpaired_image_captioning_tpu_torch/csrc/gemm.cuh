// What the port's f32 GEMMs share: their epilogues and the SM count.
// decode_gemm.cuh (the decoder step and the fused att -> LSTM -> att decode
// step) and train_gemm.cuh (the training layers) call an epilogue once per
// float4 of C after the whole K reduction: epi(row, col, acc4, 0), and,
// where a row of C is not made of whole float4 (an odd width), once per
// element: epi.one(row, col, acc).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace uic {

// the SM count of the current device, read once per process
inline int gemm_sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// C = acc + bias, row stride ldo
struct EpiBias {
  const float* bias;
  float* out;
  int ldo;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const float4 b4 = *reinterpret_cast<const float4*>(bias + c);
    *reinterpret_cast<float4*>(out + (size_t)r * ldo + c) =
        make_float4(acc.x + b4.x, acc.y + b4.y, acc.z + b4.z, acc.w + b4.w);
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    out[(size_t)r * ldo + c] = acc + bias[c];
  }
};

// C += acc + bias, in place
struct EpiRes {
  const float* bias;
  float* out;
  int ldo;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const float4 b4 = *reinterpret_cast<const float4*>(bias + c);
    float* o = out + (size_t)r * ldo + c;
    const float4 x4 = *reinterpret_cast<const float4*>(o);
    const float4 v =
        make_float4(acc.x + b4.x, acc.y + b4.y, acc.z + b4.z, acc.w + b4.w);
    *reinterpret_cast<float4*>(o) =
        make_float4(x4.x + v.x, x4.y + v.y, x4.z + v.z, x4.w + v.w);
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    float* o = out + (size_t)r * ldo + c;
    *o = *o + (acc + bias[c]);
  }
};

// C = relu(acc + bias)
struct EpiRelu {
  const float* bias;
  float* out;
  int ldo;
  __device__ __forceinline__ void operator()(int r, int c, float4 acc,
                                             int) const {
    const float4 b4 = *reinterpret_cast<const float4*>(bias + c);
    *reinterpret_cast<float4*>(out + (size_t)r * ldo + c) = make_float4(
        fmaxf(acc.x + b4.x, 0.0f), fmaxf(acc.y + b4.y, 0.0f),
        fmaxf(acc.z + b4.z, 0.0f), fmaxf(acc.w + b4.w, 0.0f));
  }
  __device__ __forceinline__ void one(int r, int c, float acc) const {
    out[(size_t)r * ldo + c] = fmaxf(acc + bias[c], 0.0f);
  }
};

}  // namespace uic
