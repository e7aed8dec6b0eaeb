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
// head width dh that is a multiple of 4 up to 256: dh runs in the least
// bucket that holds it. The tiles are DH wide; columns past dh are loaded as
// zeros and never stored, so they add exact zeros to q.k and change no
// written element of P.V, and the first dh columns keep their order of
// sums. Each bucket also has an instance for dh = DH alone, with those
// bounds compiled out (mha_train_impl.cuh: FULL), so the widths 32, 64 and
// 128 pay nothing for the padding: the run-time bounds cost the decoder's
// self-attention forward (T = S = 17) 3-4% on an H100 (PERF.md). At DH 256
// the tiles hold 32 rows, not 64: the forward's Q, K and V tiles (two
// stages of K and V) at 64 rows would need 340 KB of shared memory; at 32
// rows they take 167 KB. There is no limit on the keys S: the forward
// streams key tiles with an online softmax, and the backward's ds scratch
// (B*H*T*S floats) is memory only.
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
extern template int fwd<32>(const Attn&, float*, float*, cudaStream_t);
extern template int fwd<128>(const Attn&, float*, float*, cudaStream_t);
extern template int fwd<256>(const Attn&, float*, float*, cudaStream_t);
extern template int bwd<32>(const Attn&, const float*, const float*,
                            const float*, float*, float*, float*, float*,
                            cudaStream_t);
extern template int bwd<128>(const Attn&, const float*, const float*,
                             const float*, float*, float*, float*, float*,
                             cudaStream_t);
extern template int bwd<256>(const Attn&, const float*, const float*,
                             const float*, float*, float*, float*, float*,
                             cudaStream_t);
}  // namespace mha
}  // namespace uic

namespace {

using uic::Attn;

// the attention kernel's own calls: q, k, v, out and g contiguous
// [B, T|S, H*dh], dropout block ids b*H + h
Attn plain_attn(const float* q, const float* k, const float* v,
                const float* mask, const int* seed, int B, int T, int S,
                int H, int dh, int mask_rows, unsigned int thresh,
                float keep_div, int dropout) {
  const int d = H * dh;
  return Attn{q, k, v, mask, seed, d, d, d, d, B, T, S, H, dh, mask_rows, H,
              thresh, keep_div, dropout};
}

}  // namespace

namespace uic {

// the bucket that runs head width dh, 0 for a width the kernels refuse
int attn_bucket(int dh) {
  if (dh < 4 || dh % 4 || dh > 256) return 0;
  return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
}

int attn_fwd(const Attn& a, float* out, float* stats, cudaStream_t st) {
  switch (attn_bucket(a.dh)) {
    case 32: return mha::fwd<32>(a, out, stats, st);
    case 64: return mha::fwd<64>(a, out, stats, st);
    case 128: return mha::fwd<128>(a, out, stats, st);
    case 256: return mha::fwd<256>(a, out, stats, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int attn_bwd(const Attn& a, const float* g, const float* o,
             const float* stats, float* dq, float* dk, float* dv,
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
// row sum); dh a multiple of 4 up to 256; 16-byte aligned
int mha_train_fwd_f32(const float* q, const float* k, const float* v,
                      const float* mask, const int* seed, float* out,
                      float* stats, int B, int T, int S, int H, int dh,
                      int mask_rows, unsigned int thresh, float keep_div,
                      int dropout, void* stream) {
  return uic::attn_fwd(plain_attn(q, k, v, mask, seed, B, T, S, H, dh,
                                  mask_rows, thresh, keep_div, dropout),
                       out, stats, (cudaStream_t)stream);
}

// Floats of mha_train_bwd_f32's scratch into *n (B*H*T*S and a little
// more: ds of every score, and g . o of every row). Returns 0.
int mha_train_bwd_ws_f32(int B, int T, int S, int H, long long* n) {
  *n = (long long)uic::attn_bwd_scratch_floats(B, H, T, S);
  return 0;
}

// g, o [B,T,H*dh] (the upstream gradient and the forward output), stats
// the forward's; dq [B,T,H*dh], dk/dv [B,S,H*dh]; scratch of
// mha_train_bwd_ws_f32 floats
int mha_train_bwd_f32(const float* q, const float* k, const float* v,
                      const float* mask, const int* seed, const float* g,
                      const float* o, const float* stats, float* dq,
                      float* dk, float* dv, float* scratch, int B, int T,
                      int S, int H, int dh, int mask_rows,
                      unsigned int thresh, float keep_div, int dropout,
                      void* stream) {
  return uic::attn_bwd(plain_attn(q, k, v, mask, seed, B, T, S, H, dh,
                                  mask_rows, thresh, keep_div, dropout),
                       g, o, stats, dq, dk, dv, scratch,
                       (cudaStream_t)stream);
}

}  // extern "C"
