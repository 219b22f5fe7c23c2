// gemm_s8.cuh: the int8 GEMM mainloop that Kernel 2 (pw_gemm.cu) and
// Kernel 5 (lin_epilogue.cu) share, for Hopper (sm_90a).
//
//   acc[n, o] = sum_k a[n, k] * b[o, k],   a (N, K) int8 or uint8 and b
//   (Cout, K) int8, K-major both, int32 accumulators in registers.
//
// Shared-memory layout.  K is cut into 128-byte chunks.  A chunk of R rows
// is R x 128 bytes, laid out as TMA's SWIZZLE_128B writes it: row r's
// 16-byte granule g lies at r * 128 + 16 * (g ^ (r % 8)), from a base
// aligned to 1024 bytes (the pattern's repeat).  Rows or columns past a
// tensor's edge arrive as zeros (TMA's out-of-bounds fill), so a ragged K
// (Cin = 64), N or Cout needs no special path in the mainloop.
//
// Products.  wgmma.mma_async m64nNk32 .s32.s8.s8 (.s32.u8.s8 for a uint8
// A: Kernel 2 at W8A8's post-ReLU sites) with both operands read
// from shared memory through descriptors (128B swizzle, 1024 bytes between
// 8-row groups); a chunk is four k32 steps, each 32 bytes further along the
// row.  One consumer warpgroup owns 64 rows of the block.  Integer sums are
// exact in any order, so the tiling cannot change a bit of the result.
//
// Pipeline.  A ring of stages in shared memory, each with a "full" mbarrier
// (the producer's expect_tx, completed by the copy's bytes) and an "empty"
// one (one arrival per consumer warp).  One producer warp starts the TMA
// copies (cp.async.bulk.tensor.2d); the consumers wait on "full", multiply,
// and release the stage on "empty", so the copies of later chunks overlap
// the products of earlier ones.
//
// Epilogue.  Each consumer warpgroup stages its 64 x BN int32 accumulators
// in shared memory and reads them back a row at a time, 8 columns a thread,
// so the kernel's epilogue runs in a small rolled loop, reads its per-row
// operands (a residual) and writes its output with whole-sector vector
// accesses; where a row's pitch (Cout = 29) or the tile's edge forbids
// them, element accesses.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace gemm_s8 {

constexpr int kChunk = 128;           // bytes of K per chunk (= the swizzle's row)
constexpr int kSmemLimit = 232448;    // dynamic shared memory a block may use
constexpr int kAlign = 1024;          // the 128B swizzle repeats every 8 rows

// ---------------------------------------------------------------------------
// device side
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory's base rounded up to kAlign (the plan adds kAlign)
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of parity `parity` has completed.  Every wait is
// on the block's own producer or consumers (microseconds); one that is
// never satisfied (a pipeline fault) traps after 2^28 polls, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (++polls == (1u << 28)) __trap();
  } while (!done);
}

// TMA: the box at (c0 = column byte, c1 = row) of `map` into dst, counted on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// named barrier over `n` threads (id 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// wgmma descriptor of a K-major operand in the 128B-swizzle layout: start
// address, LBO 16 bytes (unused for swizzled K-major), SBO 1024 bytes
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(kAlign >> 4) << 32) | (1ull << 62);
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x N, int32, the warpgroup's accumulator fragment) += a (64 x 32) *
// b (N x 32)^T, both in shared memory, b s8 and a s8 or, with kU8, u8
// (W8A8's non-negative 9-bit codes: .s32.u8.s8).  QASR_WGMMA writes the
// instruction for a width N, its A type, the accumulator registers' list
// (REGS) and operands (DOPS), and the descriptors' operand numbers.
#define QASR_WGMMA(N, ATYPE, REGS, DOPS, IA, IB, IP)                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                        \
               "wgmma.mma_async.sync.aligned.m64n" N "k32.s32." ATYPE ".s8 {" REGS      \
               "}, %" IA ", %" IB ", p;\n}\n"                                          \
               : DOPS                                                                   \
               : "l"(da), "l"(db), "r"(1))
#define QASR_REGS16 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define QASR_DOPS16 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
#define QASR_REGS32 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define QASR_DOPS32 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
    "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
    "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
#define QASR_REGS64 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define QASR_DOPS64 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
    "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
    "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
    "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
    "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
    "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
    "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])

template <int N, bool kU8 = false>
struct Wgmma;

template <bool kU8>
struct Wgmma<32, kU8> {
  __device__ __forceinline__ static void mma(int (&d)[16], uint64_t da, uint64_t db) {
    if constexpr (kU8)
      QASR_WGMMA("32", "u8", QASR_REGS16, QASR_DOPS16, "16", "17", "18");
    else
      QASR_WGMMA("32", "s8", QASR_REGS16, QASR_DOPS16, "16", "17", "18");
  }
};

template <bool kU8>
struct Wgmma<64, kU8> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t da, uint64_t db) {
    if constexpr (kU8)
      QASR_WGMMA("64", "u8", QASR_REGS32, QASR_DOPS32, "32", "33", "34");
    else
      QASR_WGMMA("64", "s8", QASR_REGS32, QASR_DOPS32, "32", "33", "34");
  }
};

template <bool kU8>
struct Wgmma<128, kU8> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t da, uint64_t db) {
    if constexpr (kU8)
      QASR_WGMMA("128", "u8", QASR_REGS64, QASR_DOPS64, "64", "65", "66");
    else
      QASR_WGMMA("128", "s8", QASR_REGS64, QASR_DOPS64, "64", "65", "66");
  }
};

#undef QASR_WGMMA
#undef QASR_REGS16
#undef QASR_DOPS16
#undef QASR_REGS32
#undef QASR_DOPS32
#undef QASR_REGS64
#undef QASR_DOPS64

// acc += the warpgroup's 64 rows at `a` (s8, or u8 with kU8) times the N
// rows at `b` over one K chunk (four k32 steps); returns when the products
// are done, so the caller may release b's stage and read acc.
template <int N, bool kU8 = false>
__device__ __forceinline__ void mma_chunk(int (&acc)[N / 2], const uint8_t* a, const uint8_t* b) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
  fence_regs(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int k = 0; k < kChunk / 32; ++k) Wgmma<N, kU8>::mma(acc, da + 2 * k, db + 2 * k);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_regs(acc);
}

// Accumulator fragment of m64nNk32 for thread `lane` of warp `w` in its
// warpgroup: acc[4j + 2h + q] holds row 16w + lane/4 + 8h, column
// 8j + 2(lane%4) + q.
__device__ __forceinline__ int frag_row(int w, int lane, int h) { return 16 * w + (lane >> 2) + 8 * h; }
__device__ __forceinline__ int frag_col(int j, int lane) { return 8 * j + 2 * (lane & 3); }

// Row pitch (bytes) of a warpgroup's int32 staging tile of N columns: 32
// bytes of padding put the eight fragment rows of a half-warp's stores on
// distinct banks.
__host__ __device__ constexpr int stage_ld(int n) { return 4 * n + 32; }

// The warpgroup's accumulators (64 x N int32) into its staging tile, two
// values a store.  The epilogue then reads them back in rows, 8 columns a
// thread, in a rolled loop: an epilogue unrolled over all N/2 registers of
// a thread would be tens of KB of straight-line code per tile.
template <int N>
__device__ __forceinline__ void stage_acc(const int (&acc)[N / 2], uint8_t* stage, int w,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<int2*>(stage + frag_row(w, lane, h) * stage_ld(N) +
                               4 * frag_col(j, lane)) =
          make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// Eight staged int32 values of row r, columns 8g..8g+7.
__device__ __forceinline__ void load8(const uint8_t* stage, int ld, int r, int g, int (&a)[8]) {
  const int4* s = reinterpret_cast<const int4*>(stage + r * ld + 32 * g);
  const int4 u = s[0], v = s[1];
  a[0] = u.x, a[1] = u.y, a[2] = u.z, a[3] = u.w;
  a[4] = v.x, a[5] = v.y, a[6] = v.z, a[7] = v.w;
}

// Up to 8 consecutive int32 (nv of them) from global memory at p, 32
// bytes at once where whole and aligned; the rest 0.
__device__ __forceinline__ void gload8(const int32_t* p, int nv, int (&a)[8]) {
  if (nv == 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int4 u = reinterpret_cast<const int4*>(p)[0], v = reinterpret_cast<const int4*>(p)[1];
    a[0] = u.x, a[1] = u.y, a[2] = u.z, a[3] = u.w;
    a[4] = v.x, a[5] = v.y, a[6] = v.z, a[7] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) a[q] = q < nv ? p[q] : 0;
  }
}

// Store the low bytes of y[0..nv) at p: 8 bytes at once where whole and aligned.
__device__ __forceinline__ void store8_s8(int8_t* p, int nv, const int (&y)[8]) {
  if (nv == 8 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    unsigned lo = 0u, hi = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lo |= (static_cast<unsigned>(y[q]) & 0xffu) << (8 * q);
      hi |= (static_cast<unsigned>(y[q + 4]) & 0xffu) << (8 * q);
    }
    *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < nv) p[q] = static_cast<int8_t>(y[q]);
  }
}

// Store y[0..nv) at p: 32 bytes at once where whole and aligned.
__device__ __forceinline__ void store8_s32(int32_t* p, int nv, const int (&y)[8]) {
  if (nv == 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    reinterpret_cast<int4*>(p)[0] = make_int4(y[0], y[1], y[2], y[3]);
    reinterpret_cast<int4*>(p)[1] = make_int4(y[4], y[5], y[6], y[7]);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < nv) p[q] = y[q];
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// A row-major (rows, cols) int8 matrix as TMA boxes of box_rows x kChunk
// bytes, 128B-swizzled, zeros past its edges.  cols (the row pitch) must be
// a multiple of 16 and ptr 16-byte aligned.
inline bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunk), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace gemm_s8
