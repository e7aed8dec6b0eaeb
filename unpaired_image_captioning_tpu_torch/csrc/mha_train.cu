// Training multi-head attention, forward and backward, for Hopper (sm_90a).
// Replaces the TPU kernels unpaired_image_captioning_tpu/ops/mha_train.py
// ::_fwd_kernel and ::_bwd_kernel (`fused_mha_train`).
//
// Per (batch b, head h), with dh = d / H and maskadd [B, 1|T, S]:
//   s    = q_h k_h^T / sqrt(dh);  s = -1e9 where maskadd < 0
//   p    = softmax(s) (f32)
//   attn = keep ? p / (1 - rate) : 0      keep: the splitmix32 hash below
//   o_h  = attn v_h
// The forward also writes each row's softmax statistics, its max m and its
// sum l of exp(s - m) ([B, H, T] each), so the backward recomputes p as
// exp(s - m) / l without a pass over whole rows. The backward:
//   D_i = g_i . o_i;  dv = attn^T g;  dp = keep ? (g v^T) / (1 - rate) : 0
//   ds = p (dp - D) / sqrt(dh), 0 where masked
//   dq = ds k;  dk = ds^T q
//
// Design. Everything is a product of 64 x 64 tiles held in shared memory
// (rows padded by 4 floats, so each is 16-byte aligned and the 16 lanes that
// read 16 different rows with one float4 load hit distinct banks), copied
// in with 16-byte cp.async. 256 threads; thread (tx, ty) = (tid % 16,
// tid / 16) owns a 4 x 4 register tile of a score tile (rows ty + 16i,
// columns tx + 16j), fed by 8 float4 loads per 64 FMAs, and 4 rows of an
// output tile (4 or 8 adjacent columns, float4 loads). A ragged tile runs
// only the 16-row groups that hold valid rows or keys, as compile-time
// extents: the last query tile of T = 196 (4 rows) costs a quarter of a
// full one.
//   - Forward: a block per (b, h, 64 queries; 32 where T <= 32) streams K
//     and V tiles, double-buffered, with an online softmax (running max and
//     sum, the output rescaled when the max grows). Masked scores are -1e9,
//     not -inf, so a fully masked row is the uniform row of the plain
//     version. The dropout is applied to the probabilities, as the plain
//     version does; the sum l is that of the undropped ones.
//   - Backward: D_i in a small pass; then a block per (b, h, 64 keys) walks
//     the query tiles, forms the S and dP tiles as products, accumulates
//     dv += attn^T g and dk += ds^T q as tile products and writes its ds
//     tiles to scratch; and a block per (b, h, 64 queries) walks those ds
//     tiles for dq += ds k. Each output element has one owner and a fixed
//     order of sums: no float atomics, the same bits on every run.
//
// Head widths. Four compiled buckets, DH = 32, 64, 128 and 256, take every
// head width dh >= 1: dh up to 256 runs in the least bucket that holds
// it. The tiles are DH wide; columns past dh are loaded as
// zeros and never stored, so they add exact zeros to q.k and change no
// written element of P.V, and the first dh columns keep their order of
// sums. Each bucket also has an instance for dh = DH alone, with those
// bounds compiled out (mha_train_impl.cuh: FULL), so the widths 32, 64 and
// 128 pay nothing for the padding: the run-time bounds cost the decoder's
// self-attention forward (T = S = 17) 3-4% on an H100 (PERF.md). At DH 256
// the tiles hold 32 rows, not 64: the forward's Q, K and V tiles (two
// stages of K and V) at 64 rows would need 340 KB of shared memory; at 32
// rows they take 167 KB. Two more cases, neither on the paths' shapes:
//   - a head width, a row stride or a pointer not on 16 bytes (dh 6 or 50,
//     d = 12 or 100) runs the bucket's ODD instance: the same tiles, filled
//     by 4-byte copies, and scalar stores;
//   - a head wider than 256 (dh 384, 512, 1024) runs in bucket 256 as
//     column chunks of 256: the scores and g.v are summed over the chunks'
//     tiles in chunk order, and each block writes one chunk of the output
//     columns (the grid holds the chunks), so each output chunk recomputes
//     the scores. A bucket 512 would need 16-row tiles (five [16][516]
//     tiles, 165 KB) and still stop at 512; the chunks take any width for
//     the cost of dh / 256 score passes.
// Types (the compute dtype). q, k / v and the output (with the backward's
// g and o) are each f32 or bf16 (mha_train.cuh: ATT_* flags). A bf16 tile
// is read by the threads through converting loads into the same f32
// shared-memory tiles (not by cp.async), and every product stays the f32
// FMA core above. On the bf16 route (ATT_RND) the kernels keep the TPU
// kernel's cast points (ops/mha_train.py:64-70, :121, :136-148 of the JAX
// package): the scores are rounded to bf16 and divided by sqrt(dh) in
// bf16, the softmax is f32, the probabilities (with their dropout) are
// rounded before P.V and before dV, ds / sqrt(dh) before dq and dk, and the
// output, dq, dk and dv round to their types. To round the normalised
// probabilities the bf16 forward runs two passes over the key tiles (the
// rows' max and sum, then P.V) where the f32 one runs one online pass;
// heads past 256 (the column-chunked kernels) round each exp(s - m) of the
// online pass instead, the same relative rounding before the
// normalisation.
// The mask, the row statistics and the ds scratch stay f32.
//
// There is no limit on the keys S: the forward streams key tiles with an
// online softmax, and the backward's ds scratch (B*H*T*S floats) is memory
// only.
//
// What bounds it on the card: at the encoder shape (B 50, T = S = 196,
// d 512, 8 heads) the forward is 3.9 GFLOP against 80 MB of q/k/v/mask/o,
// so the f32 FMA rate bounds it (59 us at 67 TFLOP/s; the bytes take
// 24 us). Products are plain f32 FMA (no TF32). The backward runs the 5
// products the function needs and moves ds through device memory once
// (61 MB at the encoder shape, most of it from L2).
//
// The kernels read q / k / v and write their gradients with row strides of
// their own and draw the dropout of block b * pid_b + h (mha_train.cuh), so
// the whole-layer kernels (layer_train.cu) attend over the column blocks of
// a packed [rows, 3d] projection with their own dropout site ids.

#include "mha_train_impl.cuh"

namespace uic {
namespace mha {
// compiled in mha_train_dh32.cu, mha_train_dh128.cu and mha_train_dh256.cu
extern template int fwd<32>(const Attn&, void*, float*, cudaStream_t);
extern template int fwd<128>(const Attn&, void*, float*, cudaStream_t);
extern template int fwd<256>(const Attn&, void*, float*, cudaStream_t);
extern template int bwd<32>(const Attn&, const void*, const void*,
                            const float*, void*, void*, void*, float*,
                            cudaStream_t);
extern template int bwd<128>(const Attn&, const void*, const void*,
                             const float*, void*, void*, void*, float*,
                             cudaStream_t);
extern template int bwd<256>(const Attn&, const void*, const void*,
                             const float*, void*, void*, void*, float*,
                             cudaStream_t);
}  // namespace mha
}  // namespace uic

namespace {

using uic::Attn;

// the attention kernel's own calls: q, k, v, out and g contiguous
// [B, T|S, H*dh], dropout block ids b*H + h, fl the ATT_* types
Attn plain_attn(const void* q, const void* k, const void* v,
                const float* mask, const int* seed, int B, int T, int S,
                int H, int dh, int mask_rows, unsigned int thresh,
                float keep_div, int dropout, int fl) {
  const int d = H * dh;
  return Attn{q, k, v, mask, seed, d, d, d, d, B, T, S, H, dh, mask_rows, H,
              thresh, keep_div, dropout, fl};
}

}  // namespace

namespace uic {

// the bucket that runs head width dh (256 for every dh above it, in column
// chunks), 0 for dh < 1
int attn_bucket(int dh) {
  if (dh < 1) return 0;
  return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
}

int attn_fwd(const Attn& a, void* out, float* stats, cudaStream_t st) {
  switch (attn_bucket(a.dh)) {
    case 32: return mha::fwd<32>(a, out, stats, st);
    case 64: return mha::fwd<64>(a, out, stats, st);
    case 128: return mha::fwd<128>(a, out, stats, st);
    case 256: return mha::fwd<256>(a, out, stats, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int attn_bwd(const Attn& a, const void* g, const void* o,
             const float* stats, void* dq, void* dk, void* dv,
             float* scratch, cudaStream_t st) {
  switch (attn_bucket(a.dh)) {
    case 32: return mha::bwd<32>(a, g, o, stats, dq, dk, dv, scratch, st);
    case 64: return mha::bwd<64>(a, g, o, stats, dq, dk, dv, scratch, st);
    case 128: return mha::bwd<128>(a, g, o, stats, dq, dk, dv, scratch, st);
    case 256: return mha::bwd<256>(a, g, o, stats, dq, dk, dv, scratch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace uic

extern "C" {

// q [B,T,H*dh], k/v [B,S,H*dh], mask [B,mask_rows,S] f32 (< 0: masked),
// seed int32 [1] on the card, out [B,T,H*dh], stats [2,B,H,T] (row max,
// row sum); any dh >= 1. fl: the ATT_* types (q, k / v and out each f32 or
// bf16; ATT_RND the bf16 cast points)
int mha_train_fwd_mixed(const void* q, const void* k, const void* v,
                        const float* mask, const int* seed, void* out,
                        float* stats, int B, int T, int S, int H, int dh,
                        int mask_rows, unsigned int thresh, float keep_div,
                        int dropout, int fl, void* stream) {
  return uic::attn_fwd(plain_attn(q, k, v, mask, seed, B, T, S, H, dh,
                                  mask_rows, thresh, keep_div, dropout, fl),
                       out, stats, (cudaStream_t)stream);
}

// Floats of mha_train_bwd_f32's scratch into *n (B*H*T*S and a little
// more: ds of every score, and g . o of every row). Returns 0.
int mha_train_bwd_ws_f32(int B, int T, int S, int H, long long* n) {
  *n = (long long)uic::attn_bwd_scratch_floats(B, H, T, S);
  return 0;
}

// g, o [B,T,H*dh] (the upstream gradient and the forward output), stats
// the forward's; dq [B,T,H*dh], dk/dv [B,S,H*dh] in q's and k's types;
// scratch of mha_train_bwd_ws_f32 floats; fl as the forward's
int mha_train_bwd_mixed(const void* q, const void* k, const void* v,
                        const float* mask, const int* seed, const void* g,
                        const void* o, const float* stats, void* dq,
                        void* dk, void* dv, float* scratch, int B, int T,
                        int S, int H, int dh, int mask_rows,
                        unsigned int thresh, float keep_div, int dropout,
                        int fl, void* stream) {
  return uic::attn_bwd(plain_attn(q, k, v, mask, seed, B, T, S, H, dh,
                                  mask_rows, thresh, keep_div, dropout, fl),
                       g, o, stats, dq, dk, dv, scratch,
                       (cudaStream_t)stream);
}

}  // extern "C"
