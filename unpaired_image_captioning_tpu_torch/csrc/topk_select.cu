// Exact row-wise top-k, f32, in jax.lax.top_k order: the Hopper counterpart
// of the TPU kernels unpaired_image_captioning_tpu/ops/topk.py
// ::_lane_topk_kernel with ::_row_topk_kernel (its exact fallback), entry
// row_topk_f32 (1 <= k <= 16), and ::_chunked_topk over ::_row_topk_kernel,
// entry chunked_topk_f32 (16 < k <= 64; the route clamps the row first).
//
//   x [R, V] f32  ->  vals [R, k] f32, idx [R, k] int64
//
// Order. Each value maps to an order-preserving 32-bit key: non-negatives
// get the sign bit set, negatives have every bit flipped; -0 takes +0's key
// and every NaN the largest key, so NaN ranks above +inf. Element a beats b
// iff key(a) > key(b), or the keys are equal and a's index is lower. That
// is the order of the plain version's stable descending torch.sort (equal
// values, NaN among NaN, -0 beside +0, keep index order), which
// jax.lax.top_k shares for positive NaN and for values that are not zero.
// The chunked entry ranks torch.clamp(x, -FLT_MAX, FLT_MAX): +-inf become
// +-FLT_MAX, NaN stays NaN; it returns the clamped values. Every returned
// index is an element of the row: there is no sentinel.
//
// Design: one exact select a row, one block a row.
//  1. Stage. One thread issues four TMA bulk copies (cp.async.bulk, each
//     completing on its own mbarrier) of the row's 16-byte-aligned body into
//     shared memory; threads read the scalar head and tail around it (a row
//     of V = 8571 starts 4, 8 or 12 bytes past a 16-byte boundary on three
//     rows of four). As each piece lands, a pass turns its values into keys
//     in place, so the keying of one piece overlaps the copy of the next;
//     each thread keeps the largest key it saw.
//  2. A threshold without a histogram. Each warp takes the d-th largest of
//     its 32 threads' maxima (d = ceil(k / warps): the warp's max when
//     d = 1, else a rank by shuffles); lo is the m-th largest of those,
//     m = ceil(k / d) (the least of them unless k < warps). Those m warps
//     hold d elements each at or above lo, so at least k keys of the row
//     are >= lo and the top k is among them.
//  3. Gather the keys >= lo (warp ballots, one shared atomic a warp-round
//     that finds any), at most CAP = 256 of them; on randn or logit rows
//     that is k to 3k elements.
//  4. Rank. Each gathered element counts the gathered elements that beat
//     it; its rank, if below k, is its output slot. The output is sorted by
//     construction.
//  Rows where more than CAP keys reach lo are rows of ties: all-equal rows,
//  a dead beam's -inf or -1e10 tail, rounded values. The gather also counts
//  the keys strictly above lo; fewer than k of them means lo is the k-th
//  key itself (every such row above). Otherwise a radix select over the
//  keys >= lo finds it: passes of an 8-bit digit into a shared histogram,
//  its increments aggregated over the lanes of a warp that share a digit
//  (__match_any_sync), a suffix scan in one warp picking the digit that
//  holds the k-th key; the passes start below the bits that the least and
//  largest candidate share, and stop once at most CAP keys reach the chosen
//  prefix (those are gathered, then 4). With the k-th key T known and more
//  than CAP carrying it, each thread walks a contiguous slice, counting its
//  ties and taking the keys above T (fewer than k); a block scan of the
//  counts gives each slice its offset, and the lowest-index ties fill the
//  remaining slots, so ties go to the lowest index; then 4.
//
// What bounds it. The row is read from device memory once (V * 4 bytes);
// on the common path the block then makes one more pass over shared memory
// (the gather) with no atomic per element, four barriers, and a ranking of
// at most 256 candidates. So HBM bounds it at large R, and the block's
// serial steps at small R; the launch picks the threads a row by R
// (select_rows). Rows longer than STAGE_LIMIT bytes are not staged: every
// pass reads the row from device memory (mostly L2) instead.

#include <cuda_runtime.h>
#include <cfloat>
#include <stdint.h>

namespace {

constexpr int CAP = 256;       // candidates the ranking holds
constexpr int BINS = 256;      // an 8-bit digit
constexpr int MAX_K = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t STAGE_LIMIT = 200 * 1024;   // bytes of a staged row

// the order-preserving key of a value (see the header)
__device__ __forceinline__ unsigned to_key(float v) {
  if (v != v) return 0xffffffffu;
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// the value the route ranks: the chunked route's clamp keeps NaN
template <bool CLAMP>
__device__ __forceinline__ float ranked(float v) {
  if (CLAMP && v == v) v = fminf(fmaxf(v, -FLT_MAX), FLT_MAX);
  return v;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the row's aligned body: one bulk copy, its bytes counted on the mbarrier
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  const unsigned b = smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_u32(bar))
               : "memory");
}

// an mbarrier's memory may serve another purpose (the next block's or
// kernel's shared memory) only once it is invalidated
__device__ __forceinline__ void mbar_inval(unsigned long long* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(0u)
        : "memory");
  } while (!done);
}

constexpr int STAGES = 4;   // pieces of a staged row, an mbarrier each
constexpr int BATCH = 8;    // keys a thread loads before it tests them

struct Shared {
  unsigned long long bar[STAGES];   // the staging copies' mbarriers
  unsigned hist[BINS];
  alignas(16) unsigned ck[CAP];     // gathered keys
  alignas(16) int ci[CAP];          // and their indices
  unsigned wt[32];          // a warp's threshold, then a scan's warp sums
  unsigned wmax[32];        // a warp's largest key
  int cnt;                  // elements gathered (may pass CAP)
  int above;                // elements with a key above lo
  unsigned cmin;            // the least gathered key
  int digit, d_above, eq;   // a radix pass's result
};

template <int THREADS, bool STAGED, bool CLAMP>
__global__ void __launch_bounds__(THREADS)
topk_select_kernel(const float* __restrict__ x, float* __restrict__ vals,
                   long long* __restrict__ idx, int V, int k) {
  constexpr int WARPS = THREADS / 32;
  __shared__ Shared sh;
  extern __shared__ __align__(16) unsigned dyn[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xr = x + (size_t)blockIdx.x * V;
  unsigned* keys = dyn;

  // 1. stage the row in STAGES pieces, each keyed in place as it lands;
  // each thread's largest key
  unsigned tmax = 0;   // below every real key (-inf's is 0x007fffff)
  if constexpr (STAGED) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(xr);
    const int head = min(V, (int)(((16u - (unsigned)(a & 15u)) & 15u) >> 2));
    const int n4 = (V - head) / 4;   // 16-byte runs of the body
    keys = dyn + ((4 - head) & 3);   // keys + head is 16-byte aligned
    auto piece = [&](int c) { return head + n4 * c / STAGES * 4; };
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < STAGES; ++c) mbar_init(&sh.bar[c]);
    }
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < STAGES; ++c) {
        const int p0 = piece(c), p1 = piece(c + 1);
        if (p1 > p0)
          bulk_load(keys + p0, xr + p0, (unsigned)(p1 - p0) * 4u, &sh.bar[c]);
        else
          mbar_arrive(&sh.bar[c]);
      }
    }
    // the scalar head and tail (at most 3 elements each), keyed as read
    const int tail = V - head - 4 * n4;
    if (tid < head + tail) {
      const int i = tid < head ? tid : head + 4 * n4 + (tid - head);
      const unsigned key = to_key(ranked<CLAMP>(xr[i]));
      keys[i] = key;
      tmax = key;
    }
#pragma unroll 1
    for (int c = 0; c < STAGES; ++c) {
      const int p1 = piece(c + 1);
      mbar_wait(&sh.bar[c]);
#pragma unroll 4
      for (int i = piece(c) + tid; i < p1; i += THREADS) {
        const unsigned key = to_key(ranked<CLAMP>(__uint_as_float(keys[i])));
        keys[i] = key;
        tmax = max(tmax, key);
      }
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < V; i += THREADS)
      tmax = max(tmax, to_key(ranked<CLAMP>(xr[i])));
  }
  auto key_at = [&](int i) -> unsigned {
    if constexpr (STAGED)
      return keys[i];
    else
      return to_key(ranked<CLAMP>(xr[i]));
  };

  // 2. lo: the least of the warps' d-th largest slice maxima (d = 1: the
  // warp's max)
  {
    const int d = (k + WARPS - 1) / WARPS;
    unsigned m = tmax;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(FULL, m, o));
    unsigned wt = m;
    if (d > 1) {
      int r = 0;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const unsigned o = __shfl_sync(FULL, tmax, j);
        r += (o > tmax) || (o == tmax && j < lane);
      }
      const unsigned hit = __ballot_sync(FULL, r == d - 1);
      wt = __shfl_sync(FULL, tmax, __ffs(hit) - 1);
    }
    if (lane == 0) {
      sh.wt[warp] = wt;
      sh.wmax[warp] = m;
    }
    if (tid == 0) {
      sh.cnt = 0;
      sh.above = 0;
      sh.cmin = 0xffffffffu;
    }
  }
  __syncthreads();   // every thread is past its staging waits
  if (STAGED && tid == 0) {
#pragma unroll
    for (int c = 0; c < STAGES; ++c) mbar_inval(&sh.bar[c]);
  }
  // lo: the m-th largest of the warps' thresholds, m = ceil(k / d): those
  // m warps hold m * d >= k keys at or above it (the least of all WARPS
  // when m is WARPS; a tighter lo where k < WARPS, the row max at k = 1)
  unsigned lo;
  {
    const int d = (k + WARPS - 1) / WARPS, m = (k + d - 1) / d;
    if (m == WARPS) {
      lo = sh.wt[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) lo = min(lo, sh.wt[w]);
    } else {
      const unsigned t = lane < WARPS ? sh.wt[lane] : 0u;
      int r = 0;
#pragma unroll
      for (int j = 0; j < WARPS; ++j) {
        const unsigned o = __shfl_sync(FULL, t, j);
        r += (o > t) || (o == t && j < lane);
      }
      const unsigned hit = __ballot_sync(FULL, lane < WARPS && r == m - 1);
      lo = __shfl_sync(FULL, t, __ffs(hit) - 1);
    }
  }

  // appends the elements whose key passes `keep` to (ck, ci), in no order;
  // sh.cnt counts them all, the list keeps the first CAP. Returns the least
  // key it took and the thread's count of keys above lo. Each thread loads
  // BATCH keys before it tests any: the list's stores may alias the keys
  // for all the compiler knows, so a load after a store would wait for it.
  auto gather = [&](auto keep, unsigned& least, int& over) {
    for (int base = 0; base < V; base += THREADS * BATCH) {
      unsigned kb[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = base + u * THREADS + tid;
        kb[u] = i < V ? key_at(i) : 0u;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = base + u * THREADS + tid;
        const bool p = i < V && keep(kb[u]);
        const unsigned bal = __ballot_sync(FULL, p);
        if (bal) {
          int pos = 0;
          if (lane == 0) pos = atomicAdd(&sh.cnt, __popc(bal));
          pos = __shfl_sync(FULL, pos, 0) + __popc(bal & ((1u << lane) - 1u));
          if (p) {
            if (pos < CAP) {
              sh.ck[pos] = kb[u];
              sh.ci[pos] = i;
            }
            least = min(least, kb[u]);
            over += kb[u] > lo;
          }
        }
      }
    }
  };

  // 3. the keys >= lo
  {
    unsigned least = 0xffffffffu;
    int over = 0;
    gather([&](unsigned key) { return key >= lo; }, least, over);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      least = min(least, __shfl_xor_sync(FULL, least, o));
      over += __shfl_xor_sync(FULL, over, o);
    }
    if (lane == 0) {
      atomicMin(&sh.cmin, least);
      atomicAdd(&sh.above, over);
    }
  }
  __syncthreads();
  int n = sh.cnt;

  // Past CAP: the k-th key T and the need elements carrying it that the
  // top k takes. Fewer than k keys above lo: T is lo itself.
  if (n > CAP) {
    unsigned pre = lo;
    int need = k - sh.above, eq = n;
    bool exact = need > 0;
    if (!exact) {
      // radix select of the k-th key among the keys >= lo; every such key
      // shares the bits from `hi` up with `pre`
      unsigned hi_key = sh.wmax[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) hi_key = max(hi_key, sh.wmax[w]);
      const unsigned diff = hi_key ^ sh.cmin;
      int hi = diff ? 32 - __clz(diff) : 0;
      pre = hi == 32 ? 0u : (hi_key >> hi) << hi;
      need = k;
      while (hi > 0 && (k - need) + eq > CAP) {
        const int nb = min(8, hi), shift = hi - nb;
        for (int b = tid; b < BINS; b += THREADS) sh.hist[b] = 0;
        __syncthreads();
        for (int base = 0; base < V; base += THREADS * BATCH) {
          unsigned kb[BATCH];
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
            const int i = base + u * THREADS + tid;
            kb[u] = i < V ? key_at(i) : 0u;
          }
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
            const unsigned key = kb[u];
            const bool p = base + u * THREADS + tid < V && key >= lo &&
                           (hi == 32 || (key >> hi) == (pre >> hi));
            const unsigned act = __ballot_sync(FULL, p);
            if (p) {
              const unsigned dg = (key >> shift) & ((1u << nb) - 1u);
              const unsigned peers = __match_any_sync(act, dg);
              if (lane == __ffs(peers) - 1)
                atomicAdd(&sh.hist[dg], (unsigned)__popc(peers));
            }
          }
        }
        __syncthreads();
        if (warp == 0) {
          // the digit holding the need-th largest key: lane l sums bins
          // [8l, 8l + 8), suffix sums over the lanes, then the lane that
          // crosses `need` walks its bins down
          unsigned h[8], s = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            h[j] = sh.hist[lane * 8 + j];
            s += h[j];
          }
          unsigned suf = s;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const unsigned t = __shfl_down_sync(FULL, suf, o);
            if (lane + o < 32) suf += t;
          }
          const unsigned crosses = __ballot_sync(FULL, suf >= (unsigned)need);
          if (lane == 31 - __clz(crosses)) {
            unsigned cum = suf - s;
#pragma unroll
            for (int j = 7; j >= 0; --j) {
              if (cum + h[j] >= (unsigned)need) {
                sh.digit = lane * 8 + j;
                sh.d_above = (int)cum;
                sh.eq = (int)h[j];
                break;
              }
              cum += h[j];
            }
          }
        }
        __syncthreads();
        need -= sh.d_above;
        eq = sh.eq;
        pre |= (unsigned)sh.digit << shift;
        hi = shift;
        __syncthreads();   // sh.digit / d_above / eq read before the next
      }
      exact = hi == 0 && (k - need) + eq > CAP;
    }
    __syncthreads();   // every thread has read n before the count restarts
    if (tid == 0) sh.cnt = 0;
    __syncthreads();
    if (!exact) {
      // every key >= max(lo, pre): the k - need above the prefix and the eq
      // that share it, at most CAP
      const unsigned t = max(lo, pre);
      unsigned least = 0;
      int over = 0;
      gather([&](unsigned key) { return key >= t; }, least, over);
      __syncthreads();
      n = sh.cnt;
    } else {
      // pre is the k-th key: the k - need keys above it, and the need ties
      // of lowest index, in row order through a block scan of the ties'
      // counts over contiguous slices
      const int per = (V + THREADS - 1) / THREADS;
      const int i0 = min(V, tid * per), i1 = min(V, i0 + per);
      // a key past the slice reads as 0, below every real key
      auto slice = [&](int i, unsigned (&kb)[BATCH]) {
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
          kb[u] = i + u < i1 ? key_at(i + u) : 0u;
      };
      int c = 0;
      for (int i = i0; i < i1; i += BATCH) {
        unsigned kb[BATCH];
        slice(i, kb);
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          c += kb[u] == pre;
          if (kb[u] > pre) {   // fewer than k in the row
            const int pos = atomicAdd(&sh.cnt, 1);
            sh.ck[pos] = kb[u];
            sh.ci[pos] = i + u;
          }
        }
      }
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      if (lane == 31) sh.wt[warp] = (unsigned)incl;
      __syncthreads();
      int off = incl - c;
      for (int w = 0; w < warp; ++w) off += (int)sh.wt[w];
      const int first = k - need;   // the slots after the keys above pre
      for (int i = i0; i < i1 && off < need; i += BATCH) {
        unsigned kb[BATCH];
        slice(i, kb);
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          if (kb[u] == pre && off < need) {
            sh.ck[first + off] = pre;
            sh.ci[first + off] = i + u;
            ++off;
          }
        }
      }
      __syncthreads();
      n = k;
    }
  }

  // 4. rank the n gathered elements; a rank below k is the output slot.
  // The list is read four entries a load; entries past n are (0, INT_MAX),
  // which beat nothing.
  if (tid >= n && tid < ((n + 3) & ~3)) {
    sh.ck[tid] = 0u;
    sh.ci[tid] = 0x7fffffff;
  }
  __syncthreads();
  if (tid < n) {
    const unsigned key = sh.ck[tid];
    const int i = sh.ci[tid];
    const uint4* ck4 = reinterpret_cast<const uint4*>(sh.ck);
    const int4* ci4 = reinterpret_cast<const int4*>(sh.ci);
    int r = 0;
    for (int j = 0; j < (n + 3) / 4; ++j) {
      const uint4 o = ck4[j];
      const int4 oi = ci4[j];
      r += (o.x > key) | ((o.x == key) & (oi.x < i));
      r += (o.y > key) | ((o.y == key) & (oi.y < i));
      r += (o.z > key) | ((o.z == key) & (oi.z < i));
      r += (o.w > key) | ((o.w == key) & (oi.w < i));
    }
    if (r < k) {
      const size_t out = (size_t)blockIdx.x * k + r;
      vals[out] = ranked<CLAMP>(xr[i]);
      idx[out] = i;
    }
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <int THREADS, bool STAGED, bool CLAMP>
int launch(const float* x, float* vals, long long* idx, int R, int V, int k,
           cudaStream_t st) {
  const size_t smem = STAGED ? ((size_t)V + 3) * sizeof(unsigned) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_select_kernel<THREADS, STAGED, CLAMP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  topk_select_kernel<THREADS, STAGED, CLAMP><<<R, THREADS, smem, st>>>(
      x, vals, idx, V, k);
  return (int)cudaGetLastError();
}

template <int THREADS, bool CLAMP>
int launch_staged(const float* x, float* vals, long long* idx, int R, int V,
                  int k, cudaStream_t st) {
  if (((size_t)V + 3) * sizeof(unsigned) <= STAGE_LIMIT)
    return launch<THREADS, true, CLAMP>(x, vals, idx, R, V, k, st);
  return launch<THREADS, false, CLAMP>(x, vals, idx, R, V, k, st);
}

// threads a row, by measurement on an H100 (PERF.md): 512 where the rows
// leave the card's block slots mostly empty (R <= 2 per SM: the rows of
// ties then take the slowest block's time), else 256
template <bool CLAMP>
int select_rows(const float* x, float* vals, long long* idx, int R, int V,
                int k, cudaStream_t st) {
  if (R <= 2 * num_sms())
    return launch_staged<512, CLAMP>(x, vals, idx, R, V, k, st);
  return launch_staged<256, CLAMP>(x, vals, idx, R, V, k, st);
}

int topk(const float* x, float* vals, long long* idx, int R, int V, int k,
         bool clamp, cudaStream_t st) {
  if (k < 1 || k > MAX_K || V < 1 || k > V) return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaGetLastError();
  return clamp ? select_rows<true>(x, vals, idx, R, V, k, st)
               : select_rows<false>(x, vals, idx, R, V, k, st);
}

}  // namespace

// The top-k of every row on `stream`, 1 <= k <= 16, k <= V. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a k
// outside that domain).
extern "C" int row_topk_f32(const float* x, float* vals, long long* idx,
                            int R, int V, int k, cudaStream_t stream) {
  if (k > 16) return (int)cudaErrorInvalidValue;
  return topk(x, vals, idx, R, V, k, false, stream);
}

// The top-k of every clamped row on `stream`, 1 <= k <= 64, k <= V (the
// route sends it 16 < k and 2 * k * 128 <= V).
extern "C" int chunked_topk_f32(const float* x, float* vals, long long* idx,
                                int R, int V, int k, cudaStream_t stream) {
  return topk(x, vals, idx, R, V, k, true, stream);
}
