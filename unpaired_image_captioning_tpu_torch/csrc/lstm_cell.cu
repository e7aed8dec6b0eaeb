// Fused LSTM cell, one step: the Hopper counterpart of the TPU kernel
// unpaired_image_captioning_tpu/ops/rnn.py::_fused_cell_kernel.
//
//   gates = x @ W[:D] + h @ W[D:] + b            [B, G*H], f32 accumulation
//   i, f, o = sigmoid(gates[0:H]), sigmoid(gates[H:2H]), sigmoid(gates[2H:3H])
//   g = tanh(gates[3H:4H])                        (G = 4)
//   g = max(gates[3H:4H], gates[4H:5H])           (G = 5, maxout)
//   c' = f * c + i * g,   h' = o * tanh(c')
//
// Layouts are the JAX package's: x [B, D], h and c [B, H], W [D+H, G*H] with
// the input rows first and gate order (i, f, o, g | m1, m2), b [G*H]. All
// row-major and contiguous; any B, D, H >= 1.
//
// Types. x, (w, b) and (h, c) are each f32 or bf16 (`types`: bit 0 x, bit 1
// w and b, bit 2 h and c), as the TPU kernel reads each operand in its own
// type: a bf16 operand is converted to f32 as its tile lands in shared
// memory, the products, the sums and the epilogue are the f32 FMA core
// below, unchanged, and h' and c' are stored in h's type, rounded to nearest
// even where it is bf16 (bf16.cuh); bit 3 keeps them f32 (the decode step of
// additive_attention.cu reads h' unrounded). f32 tiles come in through cp.async; a
// bf16 tile is read with plain 8-byte loads and stored converted, so it
// does not overlap the tile in flight as the f32 copies do.
//
// Design. A tile is BM = 64 batch rows by BN hidden units j with all G gate
// columns {g*H + j} of those units, so the gate pre-activations of a unit
// meet in one thread and the epilogue (sigmoid, tanh or maxout, the c/h
// update) runs there: the [B, G*H] gate matrix never reaches device memory.
// Tiles of the reduction (BK = 16 rows of k) stream into shared memory
// through a 4-stage cp.async pipeline (16-byte copies, zero-filled past the
// edges; 4-byte copies where D or H is not a multiple of 4). A tile row k
// reads x for k < D and h for k >= D, so [x | h] is never materialised.
// 128 threads, each a 4 x TN x G register tile of plain f32 FMAs (4 rows,
// TN units, all gates): one 16-byte load of [x|h] per row and four k, and
// G loads of TN floats of W per k. Two widths:
//   - narrow (small batches): TN = 2, BN = 16 units;
//   - wide (beam batches): TN = 4, BN = 32 units, twice the FMAs a load.
//
// Filling the card. At the path's small batches there are few tiles: 16 at
// the NMT encoder's [50, 512->256], 32 at the maxout cells' [50, 1024->512]
// (denseatt training and greedy decoding, and B9c). So the reduction over
// K = D+H is split across a thread-block cluster of CS <= 8 blocks
// (cudaLaunchKernelEx with the cluster attribute): each block of the cluster
// accumulates its K slice of the same tile, writes the partial tile to its
// own shared memory, and after cluster.sync() block r sums rows
// [r*BM/CS, (r+1)*BM/CS) of the tile over the cluster's partials through
// distributed shared memory, in rank order 0..CS-1, and runs the epilogue
// on them. No scratch in device memory, no atomics, the same bits every
// run. `plan()` picks the width and CS per shape; `lstm_cell_f32_plan`
// reports the choice.
//
// What bounds it. W is the large operand: 15.7 MB at D+H = 1536, G*H = 2560
// (the maxout cells), read once per row tile (from L2 after the first, since
// it fits in the 50 MB L2). Per weight byte the kernel does B/2 FLOPs; the
// card's f32 FMA rate over its HBM rate is about 20 FLOP/byte, so the weight
// stream bounds B = 50 and the f32 FMA rate bounds B = 250 and 750. At
// B = 50 the kernel is bound by latency instead (a few FMAs a k per thread
// between the pipeline's waits); the cluster multiplies the blocks in
// flight by up to 8.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace cg = cooperative_groups;
using uic_bf16::ld4;
using uic_bf16::ldf;
using uic_bf16::stf;

namespace {

constexpr int BM = 64;            // batch rows per tile
constexpr int BK = 16;            // reduction depth per pipeline stage
constexpr int STAGES = 4;         // cp.async pipeline depth
constexpr int A_LD = BK + 4;      // padded row of the [x|h] tile (16-byte rows)
constexpr int MAX_CLUSTER = 8;    // the portable cluster size
constexpr int SMS = 132;          // streaming multiprocessors of an H100
constexpr int NTHR = 128;         // threads of a block
constexpr int TX = 8, TM = 4;     // threads across the units; rows a thread

// shared memory of one tile shape: STAGES x ([x|h] tile [BM][A_LD], W tile
// [BK][G*BN] with columns g*BN + u); the partial tile [G][BM][BN] of the
// epilogue reuses it.
template <int G, int BN>
struct Tile {
  static constexpr int W_LD = G * BN;
  static constexpr int A_FLOATS = BM * A_LD;
  static constexpr int STAGE_FLOATS = A_FLOATS + BK * W_LD;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * (int)sizeof(float);
  static_assert(G * BM * BN <= STAGES * STAGE_FLOATS, "partial tile fits");
};

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// The block's place: tile (blockIdx.x / CS, blockIdx.y), K slice of the
// block's rank in its cluster (k_slice rows of k, a multiple of BK).
struct Place {
  int cs, rank, j0, r0, k_begin, k_end, n_tiles;
};

template <int BN>
__device__ __forceinline__ Place place(const cg::cluster_group& cluster,
                                       int K, int k_slice) {
  Place p;
  p.cs = (int)cluster.num_blocks();
  p.rank = (int)cluster.block_rank();
  p.j0 = (blockIdx.x / p.cs) * BN;
  p.r0 = blockIdx.y * BM;
  p.k_begin = p.rank * k_slice;
  p.k_end = min(K, p.k_begin + k_slice);
  p.n_tiles = p.k_end > p.k_begin ? (p.k_end - p.k_begin + BK - 1) / BK : 0;
  return p;
}

// Copies the [x|h] rows and the W rows [k0, k0 + BK) of the tile into a
// stage, zero past the edges. `vec`: D and H are multiples of 4 and x, h, w
// are 16-byte aligned, so the copies are 16 bytes (8 from a bf16 operand);
// else one element. f32 operands by cp.async, bf16 ones converted here.
template <int G, int BN>
__device__ __forceinline__ void load_stage(
    float* As, const void* __restrict__ x, const void* __restrict__ h,
    const void* __restrict__ w, int B, int D, int H, const Place& p,
    int k0, int vec, int types) {
  using T = Tile<G, BN>;
  const bool xb = types & 1, wb = types & 2, hb = types & 4;
  const float* xf = static_cast<const float*>(x);
  const float* hf = static_cast<const float*>(h);
  const float* wf = static_cast<const float*>(w);
  float* Ws = As + T::A_FLOATS;
  const int tid = threadIdx.x;
  for (int e = tid; e < BM * BK / 4; e += NTHR) {
    const int row = e / (BK / 4), kq = (e % (BK / 4)) * 4;
    const int r = p.r0 + row, k = k0 + kq;
    float* dst = As + row * A_LD + kq;
    if (vec) {
      // a 4-group lies wholly in x or in h: D is a multiple of 4
      const bool ok = r < B && k < p.k_end;
      const bool in_x = k < D;
      if (in_x ? xb : hb) {
        *reinterpret_cast<float4*>(dst) =
            !ok ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                : (in_x ? ld4(x, (size_t)r * D + k, true)
                        : ld4(h, (size_t)r * H + (k - D), true));
      } else {
        cp16(dst,
             !ok ? xf
                 : (in_x ? xf + (size_t)r * D + k
                         : hf + (size_t)r * H + (k - D)),
             ok);
      }
    } else {
      for (int q = 0; q < 4; ++q) {
        const int kk = k + q;
        const bool ok = r < B && kk < p.k_end;
        const bool in_x = kk < D;
        if (in_x ? xb : hb) {
          dst[q] = !ok ? 0.0f
                       : (in_x ? ldf(x, (size_t)r * D + kk, true)
                               : ldf(h, (size_t)r * H + (kk - D), true));
        } else {
          cp4(dst + q,
              !ok ? xf
                  : (in_x ? xf + (size_t)r * D + kk
                          : hf + (size_t)r * H + (kk - D)),
              ok);
        }
      }
    }
  }
  const int GH = G * H;
  for (int e = tid; e < BK * T::W_LD / 4; e += NTHR) {
    const int kk = e / (T::W_LD / 4);
    const int col = (e % (T::W_LD / 4)) * 4;   // g * BN + u
    const int g = col / BN, u = col % BN;
    const int k = k0 + kk, j = p.j0 + u;
    float* dst = Ws + kk * T::W_LD + col;
    if (vec) {
      const bool ok = k < p.k_end && j < H;
      if (wb)
        *reinterpret_cast<float4*>(dst) =
            ok ? ld4(w, (size_t)k * GH + g * H + j, true)
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      else
        cp16(dst, ok ? wf + (size_t)k * GH + g * H + j : wf, ok);
    } else {
      for (int q = 0; q < 4; ++q) {
        const bool ok = k < p.k_end && j + q < H;
        if (wb)
          dst[q] = ok ? ldf(w, (size_t)k * GH + g * H + j + q, true) : 0.0f;
        else
          cp4(dst + q, ok ? wf + (size_t)k * GH + g * H + j + q : wf, ok);
      }
    }
  }
}

// the cell's epilogue for one (row, unit) from its G pre-activations: b
// read in w's type, c in h's, h' and c' stored in h's (rounded if bf16)
template <int G>
__device__ __forceinline__ void cell_out(const float* gate, const void* b,
                                         const void* c, void* h_out,
                                         void* c_out, int H, size_t o, int j,
                                         int types) {
  const bool wb = types & 2, hb = types & 4, ob = hb && !(types & 8);
  const float ig = sigmoid_f32(gate[0] + ldf(b, j, wb));
  const float fg = sigmoid_f32(gate[1] + ldf(b, H + j, wb));
  const float og = sigmoid_f32(gate[2] + ldf(b, 2 * H + j, wb));
  float in_t;
  if (G == 5)
    in_t = fmaxf(gate[3] + ldf(b, 3 * H + j, wb),
                 gate[4] + ldf(b, 4 * H + j, wb));
  else
    in_t = tanhf(gate[3] + ldf(b, 3 * H + j, wb));
  const float cn = fg * ldf(c, o, hb) + ig * in_t;
  stf(c_out, o, cn, ob);
  stf(h_out, o, og * tanhf(cn), ob);
}

// After every block of the cluster wrote its partial tile [G][BM][BN] to
// `part`: block r sums rows [r*BM/CS, (r+1)*BM/CS) over the cluster's
// partials in rank order (distributed shared memory) and runs the epilogue.
template <int G, int BN>
__device__ __forceinline__ void cluster_epilogue(
    const cg::cluster_group& cluster, float* part, const void* b,
    const void* c, void* h_out, void* c_out, int B, int H, const Place& p,
    int types) {
  cluster.sync();
  const int rows = BM / p.cs;                 // cs in {2, 4, 8}
  for (int e = threadIdx.x; e < rows * BN; e += NTHR) {
    const int row = p.rank * rows + e / BN, u = e % BN;
    float gate[G];
#pragma unroll
    for (int g = 0; g < G; ++g) gate[g] = 0.0f;
    for (int src = 0; src < p.cs; ++src) {    // fixed order: same bits
      const float* q = cluster.map_shared_rank(part, src);
#pragma unroll
      for (int g = 0; g < G; ++g) gate[g] += q[(g * BM + row) * BN + u];
    }
    const int r = p.r0 + row, j = p.j0 + u;
    if (r < B && j < H)
      cell_out<G>(gate, b, c, h_out, c_out, H, (size_t)r * H + j, j,
                  types);
  }
  // no block leaves while another still reads its shared memory
  cluster.sync();
}

// TN consecutive floats of shared memory (8 or 16 bytes, aligned)
template <int TN>
__device__ __forceinline__ void load_units(const float* src, float* dst) {
  if constexpr (TN == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  }
}

// One tile: BN = 8 TN units, 128 threads, each a 4 x TN x G register tile
// (rows ty*4 + i, units tx*TN + u, all gates). The K loop streams tiles
// through the STAGES-deep cp.async ring while the landed one is multiplied.
// Alone (CS = 1) the block runs the epilogue from its registers; in a
// cluster, through cluster_epilogue.
template <int G, int TN>
__global__ void __launch_bounds__(NTHR)
lstm_cell_kernel(const void* __restrict__ x, const void* __restrict__ h,
                 const void* __restrict__ c, const void* __restrict__ w,
                 const void* __restrict__ b, void* __restrict__ h_out,
                 void* __restrict__ c_out, int B, int D, int H, int k_slice,
                 int vec, int types) {
  constexpr int BN = TX * TN;
  using T = Tile<G, BN>;
  static_assert(NTHR / TX * TM == BM, "the thread grid covers BM rows");
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Place p = place<BN>(cluster, D + H, k_slice);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  float acc[TM][TN][G];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int u = 0; u < TN; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) acc[i][u][g] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < p.n_tiles)
      load_stage<G, BN>(smem + s * T::STAGE_FLOATS, x, h, w, B, D, H, p,
                        p.k_begin + s * BK, vec, types);
    cp_commit();
  }
  for (int t = 0; t < p.n_tiles; ++t) {
    cp_wait<STAGES - 2>();
    // tile t has landed for every thread, and every thread is done with
    // tile t-1, whose stage the prefetch below overwrites
    __syncthreads();
    const int nt = t + STAGES - 1;
    if (nt < p.n_tiles)
      load_stage<G, BN>(smem + (nt % STAGES) * T::STAGE_FLOATS, x, h, w, B,
                        D, H, p, p.k_begin + nt * BK, vec, types);
    cp_commit();
    const float* As = smem + (t % STAGES) * T::STAGE_FLOATS;
    const float* Ws = As + T::A_FLOATS;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(As + (ty * TM + i) * A_LD + kq);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* wrow = Ws + (kq + q) * T::W_LD + tx * TN;
        float wv[G][TN];
#pragma unroll
        for (int g = 0; g < G; ++g) load_units<TN>(wrow + g * BN, wv[g]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int u = 0; u < TN; ++u)
#pragma unroll
            for (int g = 0; g < G; ++g)
              acc[i][u][g] = fmaf(a[i][q], wv[g][u], acc[i][u][g]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();   // the stages are free for the partial tile

  if (p.cs == 1) {
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      const int j = p.j0 + tx * TN + u;
      if (j >= H) continue;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = p.r0 + ty * TM + i;
        if (r >= B) continue;
        cell_out<G>(acc[i][u], b, c, h_out, c_out, H, (size_t)r * H + j, j,
                    types);
      }
    }
    return;
  }
  float* part = smem;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int u = 0; u < TN; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g)
        part[(g * BM + ty * TM + i) * BN + tx * TN + u] = acc[i][u][g];
  cluster_epilogue<G, BN>(cluster, part, b, c, h_out, c_out, B, H, p,
                          types);
}

struct Plan {
  int bn, cluster, k_slice, blocks;
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The tile width and the cluster size for a shape. The narrow tile while
// its tiles do not outnumber the SMs (B <= 256 at H = 512), with the
// cluster as large as the portable limit and 2 pipeline tiles of K a block
// allow; else the wide tile, with the cluster doubled while the grid stays
// within three blocks per SM. `cluster` false: the same tile, no cluster.
Plan plan(int B, int D, int H, bool cluster = true) {
  const int K = D + H, rows = cdiv(B, BM), k_tiles = cdiv(K, BK);
  const int bn = rows * cdiv(H, 16) <= SMS ? 16 : 32;
  const int tiles = rows * cdiv(H, bn);
  int cs = 1;
  while (cluster && cs < MAX_CLUSTER && 2 * (2 * cs) <= k_tiles &&
         (bn == 16 || tiles * 2 * cs <= 3 * SMS))
    cs *= 2;
  return Plan{bn, cs, cdiv(k_tiles, cs) * BK, tiles * cs};
}

template <typename K>
int launch(K kernel, int smem, const void* x, const void* h, const void* c,
           const void* w, const void* b, void* h_out, void* c_out, int B,
           int D, int H, int types, const Plan& p, cudaStream_t stream) {
  // the opt-in above 48 KB, on the current device
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = D % 4 == 0 && H % 4 == 0 &&
                  ((uintptr_t)x | (uintptr_t)h | (uintptr_t)w) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(H, p.bn) * p.cluster, cdiv(B, BM));
  cfg.blockDim = dim3(NTHR);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, x, h, c, w, b, h_out, c_out, B, D, H,
                         p.k_slice, vec, types);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int run(const void* x, const void* h, const void* c, const void* w,
        const void* b, void* h_out, void* c_out, int B, int D, int H, int G,
        int types, const Plan& p, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  if (p.cluster < 1 || p.cluster > MAX_CLUSTER ||
      (p.cluster & (p.cluster - 1)))
    return (int)cudaErrorInvalidValue;
  if (G == 4 && p.bn == 16)
    return launch(lstm_cell_kernel<4, 2>, Tile<4, 16>::SMEM, x, h, c, w, b,
                  h_out, c_out, B, D, H, types, p, stream);
  if (G == 5 && p.bn == 16)
    return launch(lstm_cell_kernel<5, 2>, Tile<5, 16>::SMEM, x, h, c, w, b,
                  h_out, c_out, B, D, H, types, p, stream);
  if (G == 4 && p.bn == 32)
    return launch(lstm_cell_kernel<4, 4>, Tile<4, 32>::SMEM, x, h, c, w, b,
                  h_out, c_out, B, D, H, types, p, stream);
  if (G == 5 && p.bn == 32)
    return launch(lstm_cell_kernel<5, 4>, Tile<5, 32>::SMEM, x, h, c, w, b,
                  h_out, c_out, B, D, H, types, p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches one step on `stream` with plan()'s tile and cluster, each of x,
// (w, b) and (h, c) f32 or bf16: `types` bit 0 x, bit 1 w and b, bit 2 h and
// c (h_out and c_out in h's type, or in f32 with bit 3 too); 0 is all f32.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported G), so a refused launch is seen by the caller.
extern "C" int lstm_cell_mixed(const void* x, const void* h, const void* c,
                               const void* w, const void* b, void* h_out,
                               void* c_out, int B, int D, int H, int G,
                               int types, cudaStream_t stream) {
  if (types < 0 || types > 15) return (int)cudaErrorInvalidValue;
  return run(x, h, c, w, b, h_out, c_out, B, D, H, G, types, plan(B, D, H),
             stream);
}

// The same step with plan()'s tile but no cluster (every block reduces the
// whole of K): the yardstick of the cluster split.
extern "C" int lstm_cell_f32_unclustered(const float* x, const float* h,
                                         const float* c, const float* w,
                                         const float* b, float* h_out,
                                         float* c_out, int B, int D, int H,
                                         int G, cudaStream_t stream) {
  return run(x, h, c, w, b, h_out, c_out, B, D, H, G, 0,
             plan(B, D, H, false), stream);
}

// plan()'s choice for a shape: out = {BN, cluster size, K rows a block,
// blocks in the grid}. Returns 0.
extern "C" int lstm_cell_f32_plan(int B, int D, int H, int* out) {
  const Plan p = plan(B, D, H);
  out[0] = p.bn;
  out[1] = p.cluster;
  out[2] = p.k_slice;
  out[3] = p.blocks;
  return 0;
}
