// Hopper tensor-core building blocks for the bf16 instances of the LSTM
// cell (lstm_cell.cu) and the training layers' GEMM (train_gemm.cuh):
// 16-byte cp.async copies of bf16 tiles, ldmatrix loads of the operands'
// fragments, and the warp-level product
//
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
//
// which multiplies a 16 x 16 bf16 tile of A by a 16 x 8 bf16 tile of B and
// adds the exact products into f32 accumulators: what the TPU kernels'
// `jnp.dot(..., preferred_element_type=jnp.float32)` of two bf16 operands
// computes on the matrix unit.
//
// Fragments (thread t of the warp, g = t / 4, q = t % 4):
//   A (row-major 16 x 16): a[0] = A[g][2q, 2q+1], a[1] = A[g+8][2q, 2q+1],
//                          a[2] = A[g][2q+8, 2q+9], a[3] = A[g+8][2q+8, 2q+9]
//   B (16 x 8, "col"):     b[0] = B[2q, 2q+1][g], b[1] = B[2q+8, 2q+9][g]
//   C (16 x 8, f32):       c[0], c[1] = C[g][2q, 2q+1], c[2], c[3] = C[g+8][..]
// An A tile stored row-major loads with ldmatrix.x4; one stored k-major
// (A^T row-major, the weight gradient's X^T) with ldmatrix.x4.trans; a B
// tile stored row-major [k][n] (the weights W [K, N]) with .trans too, two
// 8-column tiles a call, and one stored transposed [n][k] without it;
// frag_row / frag_col and kmaj_row / kmaj_col below give the row and
// column each lane passes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace uic_mma {

// 16 bytes global -> shared, zero-filled where !ok (src must still be a
// valid address)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

// 16 bytes global -> shared of which the first `bytes` (0 to 16) are read
// and the rest zero-filled: a chunk cut by the edge of a row
__device__ __forceinline__ void cp16n(void* dst, const void* src,
                                      int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

// the bytes of an 8-element bf16 chunk at element i of a row of n: 16, or
// fewer at the row's end, 0 past it
__device__ __forceinline__ int chunk_bytes(int i, int n) {
  const int left = n - i;
  return left >= 8 ? 16 : (left > 0 ? 2 * left : 0);
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i + 7 give the rows of matrix i
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += A . B for one 16 x 8 tile, K = 16
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane l's stored row and first column of an ldmatrix.x4 over a 16 x 16
// tile. frag_row / frag_col: matrices (rows 0-7, cols 0-7), (rows 8-15,
// cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols 8-15); that is the A
// fragment of a row-major tile [m][k], and read .trans, the B fragments of
// two 8-column tiles of a row-major [k][n] tile (r[0], r[1] the first,
// r[2], r[3] the second). kmaj_row / kmaj_col: the A fragment of a k-major
// tile [k][m] read .trans.
__device__ __forceinline__ int frag_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int frag_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int kmaj_row(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int kmaj_col(int lane) {
  return ((lane >> 3) & 1) * 8;
}

}  // namespace uic_mma
