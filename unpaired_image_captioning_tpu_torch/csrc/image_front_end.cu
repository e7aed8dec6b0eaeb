// Image front end, f32 or bf16 out: the Hopper counterpart of the TPU
// kernel unpaired_image_captioning_tpu/ops/image.py::_front_end_kernel.
//
//   out[b, oh, ow, c] = (sum_h sum_w Rh[oh, h] Rw[ow, w] img[b, h, w, c] / 255
//                        - mean[c]) / std[c]
//
// img is uint8 [B, H, W, C], out [B, Ho, Wo, C], both contiguous. out is
// f32, or bf16 (`out_dtype` of the TPU kernel's wrapper): every value is
// computed in f32 as below and rounded to nearest even as it is stored
// (bf16.cuh), four to an 8-byte store. Rh and
// Rw are the bilinear matrices of `_interp_matrix` (half-pixel centres,
// clamped edges). Each of their rows has at most two non-zero weights, so
// the wrapper hands the kernel each output row's and column's two taps (an
// index and a weight each, read off the same f32 matrices that the plain
// version multiplies): (h0, h1, a0, a1) per output row, (w0, w1, b0, b1)
// per output column. A matrix row with a single non-zero entry (both taps
// clamped onto one index, or a zero fraction) gives the taps (i, m) and
// (i, 0). There is no matrix product: the TPU kernel's two dense MXU
// products are 2 * C * (Ho * H * W + Ho * W * Wo) operations an image,
// about 25.5 GFLOP at [16, 480, 640, 3] -> 448^2, where the taps need 6 an
// output.
//
// What bounds it: bytes. The image is read once (14.7 MB at [16, 480, 640,
// 3]) and the f32 output written once (38.5 MB at 448^2): about 0.016 ms at
// 3.35 TB/s. What held the first design (a block an output row, a thread an
// output) back was not bytes but instructions: an integer division and six
// table loads, four byte gathers and a 4-byte store for every output.
//
// Design. A block takes FE_ROWS consecutive output rows of one image (a
// contiguous stretch of out):
//   1. it stages the column taps (byte offsets w * C and the two weights,
//      16 bytes a column), each output row's taps and the statistics in
//      shared memory, and the source rows its output rows need, each once
//      (at 480 -> 448 about ten rows for eight output rows: almost every
//      source row feeds two of them), with 16-byte loads where the rows are
//      whole 16-byte words (else 4- or 1-byte loads). The slots are found
//      without a search: the span of source rows the block's taps reach is
//      staged whole where it is at most twice the block's rows;
//   2. each thread writes four consecutive outputs with one 16-byte store.
//      With C = 3 (compiled) and rows of whole float4 (Wo a multiple of 4),
//      blocks of 384 threads (a multiple of 3) keep each thread's channel
//      phase fixed: a thread's first float4 starts at channel 4t mod 3 and
//      every later one at the same channel, 512 pixels on, so the four
//      channels and their statistics stay in registers and no division is
//      left in the loop. Any other C, or rows that are not whole float4,
//      take the general instance: the stretch's unaligned head and tail
//      element by element, the float4 body with each store's first index
//      divided out.
// Each output takes the H pass at its two source columns and then the W
// pass, in the order of the plain version's two products, and normalises
// with IEEE division (no reciprocal, no fast math), so where the resize is
// the identity (taps (i, 1), (i, 0)) the result is bit-equal to (x / 255 -
// mean) / std computed on the host. Where the column taps and two source
// rows would not fit a block's shared memory (about 10,000 pixels of 3
// channels, in and out), both are read from device memory by the same
// code.
//
// What holds it back (timed on an H100 while it was designed): with the
// arithmetic taken out, the staging and the 16-byte stores alone take most
// of the time, and the two IEEE divisions an output (a reciprocal, its
// refinement and a range check each) most of the rest. Four blocks an SM
// (40 registers a thread) beat three; persistent blocks that stage the
// next chunk while computing one, rows read straight from L1 / L2, and
// chunks of 2, 4 or 16 rows did not beat eight rows a block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

using uic_bf16::st4;
using uic_bf16::stf;

constexpr int FE_THREADS = 384;  // a multiple of 3 (the channel phase)
constexpr int FE_ROWS = 8;       // output rows a block at most
constexpr int FE_BLOCKS_PER_SM = 4;  // (40 registers a thread)
constexpr size_t FE_SMEM_MAX = 227 * 1024;

struct FeArgs {
  const uint8_t* img;
  const int* row_idx;     // [Ho, 2]
  const float* row_w;     // [Ho, 2]
  const int* col_idx;     // [Wo, 2]
  const float* col_w;     // [Wo, 2]
  const float* mean;      // [C]
  const float* stdv;      // [C]
  void* out;              // f32, or bf16 where obf
  int obf;
  int H, W, C, Ho, Wo;
  int rows;    // output rows a block
  int bpi;     // blocks an image: ceil(Ho / rows)
  int pitch;   // bytes of a source row, W * C
  int spitch;  // bytes of a staged row (pitch rounded up to 16)
  int copy;    // bytes a staging copy: 16, 4 or 1
};

// Byte offsets of the regions of a block's shared memory: the column taps
// float4 [Wo] (where staged: the two byte offsets w * C as int bits and the
// two weights), mean and std [C] each, each output row's taps float4
// [rows] (the two source rows' byte offsets, from the staged rows or from
// the image, as int bits, and the two weights), the staged source rows'
// indices int [2 rows], then the staged rows [2 rows][spitch].
struct FeSmem {
  size_t ctab, ms, rtab, slot, rows, total;
};

__host__ __device__ inline size_t fe_align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

__host__ __device__ inline FeSmem fe_smem_of(int Wo, int C, int rows,
                                             int spitch, bool staged) {
  FeSmem m;
  m.ctab = 0;
  m.ms = fe_align16(m.ctab + (staged ? 16 * (size_t)Wo : 0));
  m.rtab = fe_align16(m.ms + 8 * (size_t)C);
  m.slot = fe_align16(m.rtab + 16 * (size_t)rows);
  m.rows = fe_align16(m.slot + 4 * (size_t)(2 * rows));
  m.total = m.rows + (staged ? 2 * (size_t)rows * spitch : 0);
  return m;
}

// (float)u for a byte u, exactly, without the quarter-rate integer to
// float conversion: the float 2^23 + u, less 2^23
__device__ __forceinline__ float u8f(uint8_t u) {
  return __uint_as_float(0x4B000000u | u) - 8388608.0f;
}

// the output of rows r0 / r1 (weights a0, a1) at the column taps t (byte
// offsets of channel 0 as int bits, then the two weights), channel c
__device__ __forceinline__ float fe_value(const uint8_t* r0,
                                          const uint8_t* r1, float a0,
                                          float a1, float4 t, int c,
                                          float mean, float sd) {
  const int x0 = __float_as_int(t.x) + c, x1 = __float_as_int(t.y) + c;
  // the H pass at the two source columns, then the W pass
  const float v0 = a0 * u8f(r0[x0]) + a1 * u8f(r1[x0]);
  const float v1 = a0 * u8f(r0[x1]) + a1 * u8f(r1[x1]);
  const float v = t.z * v0 + t.w * v1;
  return (v / 255.0f - mean) / sd;
}

// CC: the channel count compiled in (3), or 0 (p.C). STAGED: the source
// rows and the column taps in shared memory, else read from device memory.
// The taps are nondecreasing along each axis (bilinear taps are), so the
// source rows of a block's output rows lie in [lo, hi], the first row's
// first tap and the last row's second: where that span is at most 2 rows
// long (a downscale by up to 2, any upscale) the span is staged and a
// tap's slot is its row - lo, else each tap gets a slot of its own.
template <int CC, bool STAGED>
__global__ void __launch_bounds__(FE_THREADS, FE_BLOCKS_PER_SM)
front_end_kernel(const __grid_constant__ FeArgs p) {
  extern __shared__ __align__(16) unsigned char fe_smem[];
  const int C = CC ? CC : p.C;
  const int Wo = p.Wo, tid = threadIdx.x;
  const int b = blockIdx.x / p.bpi;
  const int oh0 = (blockIdx.x - b * p.bpi) * p.rows;
  const int nr = min(p.rows, p.Ho - oh0);
  const FeSmem m = fe_smem_of(Wo, C, p.rows, p.spitch, STAGED);
  float4* ctab = reinterpret_cast<float4*>(fe_smem + m.ctab);
  float* mean_s = reinterpret_cast<float*>(fe_smem + m.ms);
  float* std_s = mean_s + C;
  float4* rtab = reinterpret_cast<float4*>(fe_smem + m.rtab);
  int* slot = reinterpret_cast<int*>(fe_smem + m.slot);
  const uint8_t* src = p.img + (size_t)b * p.H * p.pitch;
  const uint8_t* base = STAGED ? fe_smem + m.rows : src;
  const int2* row_idx = reinterpret_cast<const int2*>(p.row_idx);
  const int2* col_idx = reinterpret_cast<const int2*>(p.col_idx);
  const float2* col_w = reinterpret_cast<const float2*>(p.col_w);
  auto col = [&](int ow) {
    if (STAGED) return ctab[ow];
    const int2 w = col_idx[ow];
    const float2 bw = col_w[ow];
    return make_float4(__int_as_float(w.x * C), __int_as_float(w.y * C),
                       bw.x, bw.y);
  };

  // 1. the output rows' taps and the source rows to stage; the column
  // taps and the statistics
  const int lo = row_idx[oh0].x, hi = row_idx[oh0 + nr - 1].y;
  const bool span = hi - lo + 1 <= 2 * p.rows;
  const int nslots = span ? hi - lo + 1 : 2 * nr;
  if (tid < nr) {
    const int2 h = row_idx[oh0 + tid];
    const float2 a = reinterpret_cast<const float2*>(p.row_w)[oh0 + tid];
    const int s0 = span ? h.x - lo : 2 * tid, s1 = span ? h.y - lo : s0 + 1;
    rtab[tid] = make_float4(
        __int_as_float(STAGED ? s0 * p.spitch : h.x * p.pitch),
        __int_as_float(STAGED ? s1 * p.spitch : h.y * p.pitch), a.x, a.y);
    if (!span) {
      slot[s0] = h.x;
      slot[s1] = h.y;
    }
  }
  if (STAGED)
    for (int o = tid; o < Wo; o += FE_THREADS) {
      const int2 w = col_idx[o];
      const float2 bw = col_w[o];
      ctab[o] = make_float4(__int_as_float(w.x * C), __int_as_float(w.y * C),
                            bw.x, bw.y);
    }
  for (int c = tid; c < C; c += FE_THREADS) {
    mean_s[c] = p.mean[c];
    std_s[c] = p.stdv[c];
  }
  // the source rows into their slots: a span's right away, alongside the
  // loads above; single taps' once their rows are in slot[]
  auto stage = [&] {
    uint8_t* dst = fe_smem + m.rows;
    const int per = p.pitch / p.copy;   // copies a row
    for (int e = tid; e < nslots * per; e += FE_THREADS) {
      const int s = e / per, k = e - s * per;
      const uint8_t* from = src + (size_t)(span ? lo + s : slot[s]) * p.pitch;
      uint8_t* to = dst + (size_t)s * p.spitch;
      if (p.copy == 16)
        reinterpret_cast<uint4*>(to)[k] =
            reinterpret_cast<const uint4*>(from)[k];
      else if (p.copy == 4)
        reinterpret_cast<uint32_t*>(to)[k] =
            reinterpret_cast<const uint32_t*>(from)[k];
      else
        to[k] = from[k];
    }
  };
  if (STAGED && span) stage();
  __syncthreads();
  if (STAGED && !span) {
    stage();
    __syncthreads();
  }

  // 2. the block's nr rows of Wo * C outputs, a contiguous stretch of out
  const int n_row = Wo * C;
  const size_t seg0 = ((size_t)b * p.Ho + oh0) * n_row;
  const bool obf = p.obf;
  const long long L = (long long)nr * n_row;
  if (CC == 3 && n_row % 4 == 0) {
    // float4 f holds elements 4f .. 4f + 3: pixel 4f / 3 of the stretch,
    // starting at channel 4f mod 3, the same for every f of this thread
    // (the stride 4 FE_THREADS is 512 pixels), so each element's channel,
    // pixel (ow or ow + 1) and statistics stay in registers; no float4
    // crosses a row
    const int n4 = (int)(L / 4);
    const int p0 = 4 * tid / 3, c0 = 4 * tid - 3 * p0;
    int ck[4];
    bool nx[4];
    float mu[4], sd[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      nx[k] = c0 + k >= 3;
      ck[k] = nx[k] ? c0 + k - 3 : c0 + k;
      mu[k] = mean_s[ck[k]];
      sd[k] = std_s[ck[k]];
    }
    int i = p0 / Wo, ow = p0 - i * Wo;
    for (int f = tid; f < n4; f += FE_THREADS) {
      const float4 r = rtab[i];
      const uint8_t* r0 = base + __float_as_int(r.x);
      const uint8_t* r1 = base + __float_as_int(r.y);
      const float4 ta = col(ow), tb = col(min(ow + 1, Wo - 1));
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = fe_value(r0, r1, r.z, r.w, nx[k] ? tb : ta, ck[k], mu[k],
                        sd[k]);
      st4(p.out, seg0 + 4 * (size_t)f, make_float4(v[0], v[1], v[2], v[3]),
          obf);
      ow += 4 * FE_THREADS / 3;
      while (ow >= Wo) {
        ow -= Wo;
        ++i;
      }
    }
    return;
  }
  // the general instance: element e of the stretch is row e / n_row,
  // pixel (e mod n_row) / C, channel (e mod n_row) mod C
  auto value = [&](int i, int ow, int c) {
    const float4 r = rtab[i];
    return fe_value(base + __float_as_int(r.x), base + __float_as_int(r.y),
                    r.z, r.w, col(ow), c, mean_s[c], std_s[c]);
  };
  auto at = [&](long long e) {
    const int i = (int)(e / n_row), w = (int)(e - (long long)i * n_row);
    const int ow = w / C;
    return value(i, ow, w - ow * C);
  };
  const long long head = min(L, (long long)((4 - seg0 % 4) % 4));
  const long long n4 = (L - head) / 4;
  for (long long e = tid; e < head; e += FE_THREADS)
    stf(p.out, seg0 + e, at(e), obf);
  for (long long f = tid; f < n4; f += FE_THREADS) {
    const long long e = head + 4 * f;
    int i = (int)(e / n_row), w = (int)(e - (long long)i * n_row);
    int ow = w / C, c = w - ow * C;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = value(i, ow, c);
      if (++c == C) {
        c = 0;
        if (++ow == Wo) {
          ow = 0;
          ++i;
        }
      }
    }
    st4(p.out, seg0 + e, make_float4(v[0], v[1], v[2], v[3]), obf);
  }
  for (long long e = head + 4 * n4 + tid; e < L; e += FE_THREADS)
    stf(p.out, seg0 + e, at(e), obf);
}

template <typename K>
int launch(K kernel, const FeArgs& a, size_t smem, int B,
           cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B * a.bpi, FE_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img uint8 [B, H, W, C]; out [B, Ho, Wo, C], f32 (16-byte aligned) or,
// with obf, bf16 (8-byte aligned; each value rounded to nearest even as
// it is stored); tap tables as above
int image_front_end_mixed(const uint8_t* img, const int* row_idx,
                          const float* row_w, const int* col_idx,
                          const float* col_w, const float* mean,
                          const float* stdv, void* out, int B, int H, int W,
                          int C, int Ho, int Wo, int obf, void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || C <= 0 ||
      ((uintptr_t)out & (obf ? 7 : 15)))
    return (int)cudaErrorInvalidValue;
  FeArgs a{img, row_idx, row_w, col_idx, col_w, mean, stdv, out, obf,
           H, W, C, Ho, Wo, FE_ROWS, 0, W * C, 0, 1};
  a.spitch = (int)fe_align16((size_t)a.pitch);
  a.copy = a.pitch % 16 == 0 && ((uintptr_t)img & 15) == 0  ? 16
           : a.pitch % 4 == 0 && ((uintptr_t)img & 3) == 0 ? 4
                                                           : 1;
  // the most rows a block whose staged rows fit its shared memory
  while (a.rows > 1 &&
         fe_smem_of(Wo, C, a.rows, a.spitch, true).total > FE_SMEM_MAX)
    a.rows /= 2;
  const bool staged =
      fe_smem_of(Wo, C, a.rows, a.spitch, true).total <= FE_SMEM_MAX;
  if (!staged) a.rows = FE_ROWS;
  a.bpi = (Ho + a.rows - 1) / a.rows;
  const size_t smem = fe_smem_of(Wo, C, a.rows, a.spitch, staged).total;
  cudaStream_t st = (cudaStream_t)stream;
  if (!staged) return launch(front_end_kernel<0, false>, a, smem, B, st);
  if (C == 3) return launch(front_end_kernel<3, true>, a, smem, B, st);
  return launch(front_end_kernel<0, true>, a, smem, B, st);
}

}  // extern "C"
