// Tile helpers of the Conformer kernels (int_attention.cu, conv_block.cu,
// ffn_ln.cu): the int8 m16n8k32 tensor-core product, 16- and 4-byte
// cp.async into shared memory with zero fill, ldmatrix fragment loads, two
// int8 values packed into a 16-bit word, and the 4 x 4 byte transpose.
#pragma once

#include <cstdint>

__device__ __forceinline__ void qasr_mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned qasr_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
// (src must still be a valid address)
__device__ __forceinline__ void qasr_cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(qasr_smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared, zero fill as qasr_cp16
__device__ __forceinline__ void qasr_cp4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(qasr_smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void qasr_cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void qasr_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 16-byte matrices; lane l gives the row address of matrix l / 8,
// row l % 8 (16-byte aligned), and receives word l % 4 of row l / 4 of each
__device__ __forceinline__ void qasr_ldsm4(int (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(qasr_smem_addr(p)));
}

// two int8 values (their low bytes) as one 16-bit word, lo first
__device__ __forceinline__ short qasr_pack2(int lo, int hi) {
  return static_cast<short>((lo & 0xff) | ((hi & 0xff) << 8));
}

// the 4 x 4 byte transpose of four words: byte j of word i -> byte i of word j
__device__ __forceinline__ void qasr_transpose4(const unsigned (&a)[4], unsigned (&o)[4]) {
  const unsigned lo01 = __byte_perm(a[0], a[1], 0x5140);
  const unsigned hi01 = __byte_perm(a[0], a[1], 0x7362);
  const unsigned lo23 = __byte_perm(a[2], a[3], 0x5140);
  const unsigned hi23 = __byte_perm(a[2], a[3], 0x7362);
  o[0] = __byte_perm(lo01, lo23, 0x5410);
  o[1] = __byte_perm(lo01, lo23, 0x7632);
  o[2] = __byte_perm(hi01, hi23, 0x5410);
  o[3] = __byte_perm(hi01, hi23, 0x7632);
}
