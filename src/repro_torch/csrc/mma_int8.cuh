// Int8 tensor-core building blocks for Hopper (sm_90a), shared by the
// port's CUDA kernels: the warp-level u8 x s8 -> s32 MMA, ldmatrix
// fragment loads from shared memory, and cp.async global -> shared copies
// with their commit/wait.  Each is one PTX instruction; the fragment
// layouts they imply are spelled out beside them so a kernel can place its
// operands in shared memory to match.
//
// Operand layouts of mma.m16n8k32 (PTX ISA, "Matrix fragments for
// mma.m16n8k32"), lane = 4 * g + t (g = groupID 0..7, t = 0..3):
//   A (16 x 32, row-major, u8), 4 registers of 4 bytes:
//     a[0] = A[g][4t..4t+3]      a[1] = A[g+8][4t..4t+3]
//     a[2] = A[g][16+4t..]       a[3] = A[g+8][16+4t..]
//   B (32 x 8, "col": stored as 8 rows of 32 K-contiguous bytes, s8):
//     b[0] = B[4t..4t+3][g]      b[1] = B[16+4t..16+4t+3][g]
//   C, D (16 x 8, s32):
//     c[0], c[1] = C[g][2t], C[g][2t+1]
//     c[2], c[3] = C[g+8][2t], C[g+8][2t+1]
// ldmatrix .x4 hands lane l the 32-bit word (row l / 4, word l % 4) of
// each of four 8 x 16-byte matrices, whose row addresses lanes 8j..8j+7
// give for matrix j: with K-contiguous rows that is exactly a[0..3] for
// one 16 x 32 A tile, or b[0..1] for two 8-column B tiles.
#pragma once

#include <stdint.h>

namespace mma_int8 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; with src_bytes = 0 nothing is
// read and the 16 bytes are zero-filled (rows past the matrix edge).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (u8, 16 x 32) . b (s8, 32 x 8), exact in int32.
__device__ __forceinline__ void mma_u8s8(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma_int8
