// dense_conv: a dense (non-grouped) integer 1-D conv over (B, T, Cin) as an
// implicit GEMM, int32 accumulate, with Kernel 2's input-requant prologue
// and its three epilogues.  Jasper10x5Dr's convs (K 11 to 29, stride 2 at
// the first, dilation 2 at the last block) run here.
//
// Replaces no Pallas kernel: the JAX package leaves this conv to XLA
// (qasr_tpu/models/jasper.py:332, conv_nwc's lax.conv_general_dilated with
// preferred_element_type=int32).  It was written because the port has no
// other integer dense conv: a library conv would be a yardstick, not a port.
//
//   prologue off: a = x int8, or uint8 (a non-negative 9-bit code)
//   prologue on:  a[b,t,i] = clamp(requant(mask_{t < in_len[b]}(relu?(x[b,t,i]
//                            + in_bias[i])), m1[i], e1), lo1, hi1),
//                            x int8 or int32, m1 a (Cin,) vector or (NULL)
//                            the scalar m1s
//   acc[b,t,o] = sum_k sum_i a[b, t*s + k*d - pad, i] * w[o, k, i]
//                (frames outside [0, t_in) read 0)
//   mode 0 (none):    out int32 = act(acc + bias)
//   mode 1 (requant): out int8  = clamp(requant(mask_{t < len[b]}(
//                                       act(acc + bias)), m[o], e), lo, hi)
//   mode 2 (join):    out int8  = clamp(requant(acc + bias, m[o], e)
//                                       + requant(res[b,t,o], m_r[o], e_r), lo, hi)
//   act(v) = min(relu?(v), cap[o]): ReLU, or hardtanh's clip to [0, H[o]]
//   with a ceiling (cap a (Cout,) vector or the scalar hs; INT_MAX: none);
//   the prologue's relu?() is min(relu?(), in_cap[i]) the same way.
//
// Grouped convs (groups > 1) run in dense_conv_grouped.cu.  The entry here
// takes groups == 1 only; the kernel's group fields (one group: offsets 0,
// no GroupShuffle store) are left as they were so that ungrouped launches
// run the code they ran before the grouped form moved out.
//   a clamp is [-2^(bits-1), 2^(bits-1)-1] with an int8 result, or [0, 255]
//   with a uint8 one (W8A8's 9-bit codes of a ReLU'd value, the wrapper's
//   act_clamp).  With a uint8 operand (kU8) the products are wgmma's
//   .s32.u8.s8 form.
//
// Accumulators: |acc| <= K * Cin * 255 * 127 = 7.2e8 < 2^31 at Jasper's
// widest site (K 29 x Cin 768 = 22,272, a uint8 operand, 8-bit weights).
// Integer sums are exact in any order, so no tiling changes a bit.
//
// What bounds it on an H100: the operations.  One Jasper10x5Dr forward at
// B=64 x 15 s (48,064 rows after the stride) is 325 M multiply-adds a row,
// ~31 T int8 operations, 15.8 ms at 1,979 TOP/s, against some 2 GB of
// activations in and out (0.6 ms at 3.35 TB/s).  Every block reads the
// conv's whole weight tensor from L2 (K * Cin * Cout bytes, 14.7 MB at
// K=25 768 -> 768), 128 multiply-adds a byte: ~5.5 TB/s at the big sites,
// which does not bound them (pairs of blocks sharing each weight tile by
// multicast TMA ran slower; PERF.md).
//
// Design, the Hopper "TMA ring, wgmma warpgroups" shape:
// - A block owns BM = 128 consecutive output frames of one batch element
//   and keeps their input rows plus the halo, (BM - 1) * s + (K - 1) * d +
//   1 rows of Cin bytes, resident in shared memory (fill_a): the prologue
//   requantizes each element once, any (tap x dilation) row shift is an
//   address, and no im2col exists in device memory.  Row pitches are padded
//   by 16 bytes so that eight rows fall on distinct banks.
// - The weights (Cout, K, Cin) arrive by TMA through a ring of S stages of
//   BN x 128 bytes in the 128B-swizzle layout, one box per (Cout tile, tap,
//   128-byte Cin chunk) from a 3-D tensor map over (Cin, K, Cout): its
//   out-of-bounds fill gives zeros past Cin (Cin = 64 at Jasper's first
//   conv) and past Cout.  Each stage has a "full" mbarrier (the copy's
//   bytes) and an "empty" one (one arrival per warp).  No block-wide
//   barrier inside the K loop.
// - Two consumer warpgroups own 64 frames each.  A warp reads the A
//   fragment of its 16 frames for the step's tap (halo row i * s + k * d)
//   with ldmatrix, which for 8-bit types is the layout of wgmma's register
//   A operand, and issues wgmma.mma_async m64nNk32 with B from the ring's
//   stage through a descriptor.  So a warpgroup reads B once from shared
//   memory for 64 x BN products (48 multiply-adds a byte at BN = 192,
//   with A).  One wgmma group stays in flight: the next step's
//   A fragments load into a second register set while this step's
//   products run, and a stage is released once its group has completed.
// - BN is chosen per launch from the widths the kernel is built for (128,
//   160, 192) so that Cout splits with the fewest padded columns, then the
//   fewest tiles (768 = 4 x 192, 896 = 7 x 128, 640 = 4 x 160, 512 = 4 x
//   128, 384 = 2 x 192, 256 = 2 x 128), and S is
//   as many stages as fit beside the resident rows (at least 2, at most 8);
//   kernels/dense_conv.py::plan chooses both, and the entry checks the
//   shared memory they need.
// - A block is 384 threads: two consumer warpgroups and a producer
//   warpgroup whose first thread issues the loads (its other threads help
//   fill the rows, then exit).  Twelve warps cap a thread at 168
//   registers, so a tile is at most 192 channels: 96 accumulators, two A
//   register sets and the addresses fit.  At 224 and 256 ptxas spilled and
//   serialized the wgmma (C7512), and setmaxnreg (40 / 232) did not raise
//   its allocation; eight warps with thread 0 as the producer allow 255
//   registers, but its wait in a divergent branch made ptxas serialize
//   every wgmma (C7518).  Both measured.
// - The epilogue runs from the accumulator registers (a staging tile would
//   need shared memory that the ring holds at K = 29), two adjacent
//   columns a store where Cout is even.
#include <climits>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "gemm_s8.cuh"
#include "requant.cuh"
#include "tile_s8.cuh"

namespace {

using gemm_s8::kChunk;               // bytes of Cin a K step takes (the swizzle's row)

constexpr int kBM = 128;             // output frames per block
constexpr int kConsumers = 256;      // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one thread loads)
constexpr int kMaxStages = 8;

struct DcParams {
  const void* x;
  const int32_t* bias;
  const int32_t* m;
  const int32_t* lens;
  const int32_t* res;
  const int32_t* m_r;
  void* out;
  int t_in, cin, t_out, cout, k_size, stride, pad, dil;  // cin, cout: the tensors' widths
  int mode, relu, e, e_r, lo, hi;
  int pro, x32;
  const int32_t* in_bias;
  int in_relu;
  const int32_t* in_len;
  const int32_t* m1;
  int m1s, e1, lo1, hi1;
  int nc;        // Cin chunks of kChunk bytes
  int rows_h;    // resident rows (output tile + halo)
  int pitch;     // resident row pitch, nc * kChunk + 16
  int stages;    // the weight ring's stages
  int ct_per;    // Cout tiles per grid-z slice
  int groups, cg, cog, shuffle;  // groups, Cin and Cout a group, GroupShuffle on store
  const int32_t* hcap;           // (Cout,) ceiling, or NULL -> hs
  int hs;
  const int32_t* in_hcap;        // (Cin,) prologue ceiling, or NULL -> in_hs
  int in_hs;
};

// A block's shared memory (byte offsets from the 1024-aligned base): the
// weight ring, the resident rows, the mbarriers (full[S], empty[S]).
struct DcLayout {
  int ring, a, bars, bytes;
  __host__ __device__ DcLayout(int bn, int stages, int rows, int pitch) {
    ring = 0;
    a = ring + stages * bn * kChunk;
    bars = a + rows * pitch;
    bytes = bars + 16 * stages + gemm_s8::kAlign;   // + the base's alignment slack
  }
};

// TMA: the box at (c0 = Cin byte, c1 = tap, c2 = output channel) of `map`
// into dst, counted on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(gemm_s8::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(gemm_s8::smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// d (64 x N, int32, the warpgroup's accumulator fragment; scale 0 ignores
// its old value) += a (64 x 32, this thread's register fragment: the
// m16n8k32 A fragment of the warp's 16 rows) * b (N x 32, the descriptor's
// K-major swizzled rows)^T; s8 or, with kU8, u8 A (.s32.u8.s8).
#define QASR_WGMMA_RS(N, ATYPE, REGS, DOPS, A, IB, IP)                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                        \
               "wgmma.mma_async.sync.aligned.m64n" N "k32.s32." ATYPE ".s8 {" REGS      \
               "}, {" A "}, %" IB ", p;\n}\n"                                          \
               : DOPS                                                                   \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale))
#define QASR_RS_REGS32 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define QASR_RS_DOPS32 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
    "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
    "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
#define QASR_RS_REGS64 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define QASR_RS_DOPS64 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
    "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
    "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
    "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
    "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
    "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
    "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
#define QASR_RS_REGS80 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
    "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define QASR_RS_DOPS80 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
    "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
    "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
    "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
    "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
    "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
    "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), \
    "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), \
    "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
#define QASR_RS_REGS96 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
    "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
    "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define QASR_RS_DOPS96 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
    "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
    "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
    "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
    "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
    "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
    "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), \
    "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), \
    "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), \
    "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), \
    "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])

template <int N, bool kU8>
struct WgmmaRs;

template <bool kU8>
struct WgmmaRs<64, kU8> {
  __device__ __forceinline__ static void mma(int (&d)[32], const int (&a)[4], uint64_t db,
                                             int scale) {
    if constexpr (kU8)
      QASR_WGMMA_RS("64", "u8", QASR_RS_REGS32, QASR_RS_DOPS32, "%32, %33, %34, %35", "36", "37");
    else
      QASR_WGMMA_RS("64", "s8", QASR_RS_REGS32, QASR_RS_DOPS32, "%32, %33, %34, %35", "36", "37");
  }
};

template <bool kU8>
struct WgmmaRs<128, kU8> {
  __device__ __forceinline__ static void mma(int (&d)[64], const int (&a)[4], uint64_t db,
                                             int scale) {
    if constexpr (kU8)
      QASR_WGMMA_RS("128", "u8", QASR_RS_REGS64, QASR_RS_DOPS64, "%64, %65, %66, %67", "68", "69");
    else
      QASR_WGMMA_RS("128", "s8", QASR_RS_REGS64, QASR_RS_DOPS64, "%64, %65, %66, %67", "68", "69");
  }
};

template <bool kU8>
struct WgmmaRs<160, kU8> {
  __device__ __forceinline__ static void mma(int (&d)[80], const int (&a)[4], uint64_t db,
                                             int scale) {
    if constexpr (kU8)
      QASR_WGMMA_RS("160", "u8", QASR_RS_REGS80, QASR_RS_DOPS80, "%80, %81, %82, %83", "84", "85");
    else
      QASR_WGMMA_RS("160", "s8", QASR_RS_REGS80, QASR_RS_DOPS80, "%80, %81, %82, %83", "84", "85");
  }
};

template <bool kU8>
struct WgmmaRs<192, kU8> {
  __device__ __forceinline__ static void mma(int (&d)[96], const int (&a)[4], uint64_t db,
                                             int scale) {
    if constexpr (kU8)
      QASR_WGMMA_RS("192", "u8", QASR_RS_REGS96, QASR_RS_DOPS96, "%96, %97, %98, %99", "100", "101");
    else
      QASR_WGMMA_RS("192", "s8", QASR_RS_REGS96, QASR_RS_DOPS96, "%96, %97, %98, %99", "100", "101");
  }
};

#undef QASR_RS_REGS32
#undef QASR_RS_DOPS32
#undef QASR_RS_REGS64
#undef QASR_RS_DOPS64
#undef QASR_RS_REGS80
#undef QASR_RS_DOPS80
#undef QASR_RS_REGS96
#undef QASR_RS_DOPS96
#undef QASR_WGMMA_RS

// registers an in-flight wgmma reads or writes, pinned at this point of
// the program (no instruction; the compiler may not move their uses across)
__device__ __forceinline__ void fence_frag(int (&f)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[k][i])::"memory");
}

// the warp's A fragments of one K step: four k32 steps of its 16 rows
__device__ __forceinline__ void load_a(int (&f)[4][4], const uint8_t* a) {
#pragma unroll
  for (int k = 0; k < 4; ++k) qasr_ldsm4(f[k], a + 32 * k);
}

// The block's resident rows: halo row h is input frame base + h of batch
// b, 16 channels (one granule) an item from channel c_in0 (the group's
// first); zero outside [0, t_in), past in_len with the prologue, and past
// the group's Cin.  All kThreads threads.  kExt: with hardtanh's ceiling.
template <bool kExt>
__device__ void fill_a(const DcParams& p, uint8_t* a_tile, int b, int base, int c_in0) {
  const int gpr = p.nc * (kChunk / 16);  // granules a row, Cin padded to the chunk
  const int cg = p.cg / 16;              // granules that hold channels
  const int ilen = p.in_len ? p.in_len[b] : INT_MAX;
  const size_t xrow = static_cast<size_t>(b) * p.t_in;
  for (int it = threadIdx.x; it < p.rows_h * gpr; it += kThreads) {
    const int h = it / gpr, g = it - h * gpr;
    const int t = base + h;
    uint8_t* dst = a_tile + h * p.pitch + 16 * g;
    const bool live = g < cg && t >= 0 && t < p.t_in && (!p.pro || t < ilen);
    const size_t off = (xrow + (live ? t : 0)) * p.cin + c_in0 + 16 * (live ? g : 0);
    if (!p.pro) {
      qasr_cp16(dst, static_cast<const int8_t*>(p.x) + off, live ? 16 : 0);
      continue;
    }
    int4 word = make_int4(0, 0, 0, 0);
    if (live) {
      int v[16];
      if (p.x32) {
        const int4* s = reinterpret_cast<const int4*>(static_cast<const int32_t*>(p.x) + off);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int4 q = s[k];
          v[4 * k] = q.x, v[4 * k + 1] = q.y, v[4 * k + 2] = q.z, v[4 * k + 3] = q.w;
        }
      } else {
        const int4 q = *reinterpret_cast<const int4*>(static_cast<const int8_t*>(p.x) + off);
        const int w4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = static_cast<int8_t>(w4[k / 4] >> (8 * (k % 4)));
      }
      unsigned wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int c = c_in0 + 16 * g + k;
        int z = v[k] + (p.in_bias ? p.in_bias[c] : 0);
        if (p.in_relu) z = z > 0 ? z : 0;
        if (kExt) z = min(z, p.in_hcap ? p.in_hcap[c] : p.in_hs);
        const int r = qasr_clamp(qasr_requant(z, p.m1 ? p.m1[c] : p.m1s, p.e1), p.lo1, p.hi1);
        wd[k / 4] |= (static_cast<unsigned>(r) & 0xffu) << (8 * (k % 4));
      }
      word = make_int4(static_cast<int>(wd[0]), static_cast<int>(wd[1]),
                       static_cast<int>(wd[2]), static_cast<int>(wd[3]));
    }
    *reinterpret_cast<int4*>(dst) = word;
  }
  qasr_cp_commit();
}

// the producer's next K step: (tap, chunk) in order, then the next Cout tile
__device__ __forceinline__ void next_step(const DcParams& p, int& ct, int& tap, int& c) {
  if (++c == p.nc) {
    c = 0;
    if (++tap == p.k_size) {
      tap = 0;
      ++ct;
    }
  }
}

// The epilogue of one Cout tile from a warp's accumulator registers: this
// thread holds frames t_row and t_row + 8 and, for each j < kBN / 8,
// columns o_lane + 8j and o_lane + 8j + 1 (acc[4j + 2h + q]), up to lim
// (the end of the conv group).  Channel o is stored at position pos (o's
// GroupShuffle position with `shuffle`, else o), where m, m_r and res are
// read too.  Without kExt (no shuffle, no ceiling) pos is o and no ceiling
// is read: the ungrouped kernel's code.
template <int kBN, int kMode, bool kExt>
__device__ __forceinline__ void epilogue(const DcParams& p, const int (&acc)[kBN / 2], int b,
                                         int t_row, int o_lane, int lim, int len) {
  const bool sh = kExt && p.shuffle != 0;
  // pairs of adjacent columns are 2- and 8-byte aligned
  const bool even = (p.cout & 1) == 0 && (p.cog & 1) == 0 && !sh;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int o = o_lane + 8 * j;
    if (o >= lim) break;
    const bool two = o + 1 < lim;
    int bo[2], mo[2], mro[2], co[2], pos[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool on = q == 0 || two;
      pos[q] = sh ? ((o + q) % p.cog) * p.groups + (o + q) / p.cog : o + q;
      bo[q] = on && p.bias ? p.bias[o + q] : 0;
      co[q] = !kExt ? INT_MAX : on && p.hcap ? p.hcap[o + q] : p.hs;
      mo[q] = on && kMode != 0 ? p.m[pos[q]] : 0;
      mro[q] = on && kMode == 2 ? p.m_r[pos[q]] : 0;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t_row + 8 * h;
      if (t >= p.t_out) continue;
      const size_t row = (static_cast<size_t>(b) * p.t_out + t) * p.cout;
      int y[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        int v = acc[4 * j + 2 * h + q] + bo[q];
        if constexpr (kMode == 0) {
          y[q] = min(p.relu && v < 0 ? 0 : v, co[q]);
        } else if constexpr (kMode == 1) {
          if (p.relu) v = v > 0 ? v : 0;
          v = min(v, co[q]);
          if (t >= len) v = 0;
          y[q] = qasr_clamp(qasr_requant(v, mo[q], p.e), p.lo, p.hi);
        } else {
          const int r = (q == 0 || two) ? p.res[row + pos[q]] : 0;
          y[q] = qasr_clamp(qasr_requant(v, mo[q], p.e) + qasr_requant(r, mro[q], p.e_r), p.lo,
                            p.hi);
        }
      }
      if constexpr (kMode == 0) {
        int32_t* dst = static_cast<int32_t*>(p.out) + row;
        if (two && even) {
          *reinterpret_cast<int2*>(dst + o) = make_int2(y[0], y[1]);
        } else {
          dst[pos[0]] = y[0];
          if (two) dst[pos[1]] = y[1];
        }
      } else {
        int8_t* dst = static_cast<int8_t*>(p.out) + row;
        if (two && even) {
          *reinterpret_cast<short*>(dst + o) = qasr_pack2(y[0], y[1]);
        } else {
          dst[pos[0]] = static_cast<int8_t>(y[0]);
          if (two) dst[pos[1]] = static_cast<int8_t>(y[1]);
        }
      }
    }
  }
}

// The producer thread's next weight load: its number, (Cout tile, tap,
// chunk), ring stage, and the parity of the "empty" phase it waits for.
struct Producer {
  int issued, ct, tap, c, s, ph, c_out0;   // c_out0: the group's first output channel
};

// The next K step's weight box into its ring stage by TMA, once the
// stage's last use has been released by the eight consumer warps
// (`wait`; a stage's first use has nothing to wait for).
template <int kBN>
__device__ __forceinline__ void load_w(const DcParams& p, const CUtensorMap* map, uint8_t* ring,
                                       uint64_t* full, uint64_t* empty, Producer& pr,
                                       bool wait) {
  using namespace gemm_s8;
  if (wait) mbar_wait(empty + pr.s, pr.ph ^ 1);
  mbar_expect_tx(full + pr.s, kBN * kChunk);
  tma_load_3d(ring + pr.s * (kBN * kChunk), map, full + pr.s, pr.c * kChunk, pr.tap,
              pr.c_out0 + pr.ct * kBN);
  next_step(p, pr.ct, pr.tap, pr.c);
  ++pr.issued;
  if (++pr.s == p.stages) {
    pr.s = 0;
    pr.ph ^= 1;
  }
}

// A consumer warp's pipeline position: the K step's (tap, chunk), its ring
// stage and phase, the stage whose products are still in flight (-1:
// none), and wgmma's scale-d for the step's first k32 (0 at a tile's first
// step: the products overwrite the last tile's accumulators).
struct Pipe {
  int tap, c, s, ph, pend, scale;
};

// the fixed per-thread operands of the consumer loop
struct Consumer {
  const uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  const uint8_t* a_lane;   // this lane's ldmatrix row at tap 0, chunk 0
  int tap_step;            // bytes between taps: dilation * pitch
  int lane;
};

// One K step of a consumer warp: wait for the stage, issue its products on
// `cur`, retire the previous step's group (releasing its stage and the
// `nxt` registers), and load the next step's A fragments into `nxt`
// (`more`) while these products run.
template <int kBN, bool kU8>
__device__ __forceinline__ void consume(const DcParams& p, const Consumer& cs, Pipe& q,
                                        int (&acc)[kBN / 2], int (&cur)[4][4],
                                        int (&nxt)[4][4], bool more) {
  using namespace gemm_s8;
  mbar_wait(cs.full + q.s, q.ph);
  const uint64_t db = sw128_desc(cs.ring + q.s * (kBN * kChunk));
  fence_regs(acc);
  fence_frag(cur);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int k = 0; k < kChunk / 32; ++k)
    WgmmaRs<kBN, kU8>::mma(acc, cur[k], db + 2 * k, k == 0 ? q.scale : 1);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  fence_frag(nxt);   // the previous step's A registers are free from here on
  if (q.pend >= 0 && cs.lane == 0) mbar_arrive(cs.empty + q.pend);
  q.pend = q.s;
  if (++q.s == p.stages) {
    q.s = 0;
    q.ph ^= 1;
  }
  q.scale = 1;
  if (++q.c == p.nc) {
    q.c = 0;
    if (++q.tap == p.k_size) q.tap = 0;
  }
  if (more) load_a(nxt, cs.a_lane + q.tap * cs.tap_step + q.c * kChunk);
}

// kExt: GroupShuffle's store or a hardtanh ceiling (prologue or epilogue)
template <int kBN, bool kU8, bool kExt>
__global__ void __launch_bounds__(kThreads, 1)
dense_conv_kernel(const __grid_constant__ CUtensorMap map_w, const DcParams p) {
  using namespace gemm_s8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const DcLayout L(kBN, p.stages, p.rows_h, p.pitch);
  uint8_t* ring = smem + L.ring;
  uint8_t* a_tile = smem + L.a;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + p.stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, t0 = blockIdx.x * kBM;
  const int n_ct = (p.cog + kBN - 1) / kBN;
  const int slices = (n_ct + p.ct_per - 1) / p.ct_per;
  const int grp = blockIdx.z / slices;           // the conv group
  const int c_in0 = grp * p.cg, c_out0 = grp * p.cog;
  const int ct0 = (blockIdx.z - grp * slices) * p.ct_per;
  const int ct1 = min(n_ct, ct0 + p.ct_per);
  if (ct0 >= ct1) return;
  const int n = p.k_size * p.nc;       // K steps a Cout tile
  const int steps = (ct1 - ct0) * n;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the producer thread starts the ring's first loads, then all threads
  // fill the rows
  Producer pr{0, ct0, 0, 0, 0, 0, c_out0};
  if (tid == kConsumers)
    for (int s = 0; s < min(p.stages, steps); ++s)
      load_w<kBN>(p, &map_w, ring, full, empty, pr, false);
  // one cp.async group (empty with the prologue)
  fill_a<kExt>(p, a_tile, b, t0 * p.stride - p.pad, c_in0);
  qasr_cp_wait<0>();
  __syncthreads();

  if (warp >= kConsumers / 32) {   // the producer: the rest of the ring's loads
    if (tid == kConsumers)
      while (pr.issued < steps) load_w<kBN>(p, &map_w, ring, full, empty, pr, true);
    return;
  }

  // the consumers: warpgroup wg owns frames 64 wg.. of the tile, its warp w
  // 16 of them (ldmatrix rows: a frame of the 16, a K half)
  const int wg = warp >> 2, w = warp & 3;
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_k = 16 * (lane >> 4);
  const Consumer cs{ring, full, empty,
                    a_tile + (wg * 64 + 16 * w + a_row) * p.stride * p.pitch + a_k,
                    p.dil * p.pitch, lane};
  const int t_row = t0 + wg * 64 + 16 * w + (lane >> 2);
  const int len = p.mode == 1 && p.lens ? p.lens[b] : INT_MAX;
  Pipe q{0, 0, 0, 0, -1, 0};
  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  int af0[4][4], af1[4][4];
  load_a(af0, cs.a_lane);   // every tile starts at tap 0, chunk 0, from af0
  for (int ct = ct0; ct < ct1; ++ct) {
    const bool next_tile = ct + 1 < ct1;
    q.scale = 0;
    int i = 0;
    for (; i + 2 <= n; i += 2) {
      consume<kBN, kU8>(p, cs, q, acc, af0, af1, true);
      consume<kBN, kU8>(p, cs, q, acc, af1, af0, i + 2 < n || next_tile);
    }
    if (i < n) consume<kBN, kU8>(p, cs, q, acc, af0, af1, next_tile);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(acc);
    fence_frag(af0);
    fence_frag(af1);
    if (lane == 0) mbar_arrive(empty + q.pend);
    q.pend = -1;
    if (n & 1) {   // an odd tile left the next tile's first A in af1; nothing is in flight
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) af0[k][r] = af1[k][r];
    }
    const int o_lane = c_out0 + ct * kBN + 2 * (lane & 3), lim = c_out0 + p.cog;
    if (p.mode == 0)
      epilogue<kBN, 0, kExt>(p, acc, b, t_row, o_lane, lim, len);
    else if (p.mode == 1)
      epilogue<kBN, 1, kExt>(p, acc, b, t_row, o_lane, lim, len);
    else
      epilogue<kBN, 2, kExt>(p, acc, b, t_row, o_lane, lim, len);
  }
}

template <int kBN, bool kU8, bool kExt>
cudaError_t launch(const CUtensorMap& map, const DcParams& p, dim3 grid, int smem,
                   cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dense_conv_kernel<kBN, kU8, kExt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gemm_s8::kSmemLimit);
  if (attr != cudaSuccess) return attr;
  dense_conv_kernel<kBN, kU8, kExt><<<grid, kThreads, smem, stream>>>(map, p);
  return cudaGetLastError();
}

template <int kBN>
cudaError_t launch_bn(bool u8, const CUtensorMap& map, const DcParams& p, dim3 grid, int smem,
                      cudaStream_t stream) {
  const bool ext = p.shuffle || p.hcap || p.hs != INT_MAX || p.in_hcap || p.in_hs != INT_MAX;
  if (ext)
    return u8 ? launch<kBN, true, true>(map, p, grid, smem, stream)
              : launch<kBN, false, true>(map, p, grid, smem, stream);
  return u8 ? launch<kBN, true, false>(map, p, grid, smem, stream)
            : launch<kBN, false, false>(map, p, grid, smem, stream);
}

// w (Cout, K, Cin) int8 as a 3-D tensor map over (Cin, K, Cout), boxes of
// (128 bytes, 1 tap, bn channels), 128B-swizzled, zeros past Cin and Cout.
bool make_w_map(CUtensorMap* map, const int8_t* w, int cout, int k_size, int cin, int bn) {
  const gemm_s8::EncodeTiled enc = gemm_s8::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(k_size),
                              static_cast<cuuint64_t>(cout)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cin),
                                 static_cast<cuuint64_t>(k_size) * cin};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kChunk), 1, static_cast<cuuint32_t>(bn)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(w), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// bn, stages, ct_per: the wrapper's plan (kernels/dense_conv.py::plan: the
// Cout tile, the ring's stages, the Cout tiles a grid-z slice owns); the
// entry computes the shared memory they need and refuses what does not
// fit.  u8: the operand the products read is unsigned (a uint8 x, or a
// prologue that writes uint8 codes).  groups, shuffle: the grouped form and
// GroupShuffle on store; hcap / hs, in_hcap / in_hs: hardtanh's ceilings.
extern "C" int qasr_dense_conv(const void* x, const int8_t* w, const int32_t* bias,
                               const int32_t* m, const int32_t* lens, const int32_t* res,
                               const int32_t* m_r, void* out, int batch, int t_in, int cin,
                               int t_out, int cout, int k_size, int stride, int pad, int dil,
                               int mode, int relu, int e, int e_r, int lo, int hi, int pro,
                               int x32, const int32_t* in_bias, int in_relu,
                               const int32_t* in_len, const int32_t* m1, int m1s, int e1,
                               int lo1, int hi1, int u8, int bn, int stages, int ct_per,
                               int groups, int shuffle, const int32_t* hcap, int hs,
                               const int32_t* in_hcap, int in_hs, void* stream) {
  if (groups != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int cg = cin / groups, cog = cout / groups;
  if (batch < 1 || t_out < 1 || cout < 1 || cg < 16 || cg % 16 != 0 || k_size < 1 ||
      stride < 1 || dil < 1 || mode < 0 || mode > 2 || ct_per < 1 || stages < 2 ||
      stages > kMaxStages || (!pro && x32) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DcParams p{x, bias, m, lens, res, m_r, out, t_in, cin, t_out, cout, k_size, stride, pad,
             dil, mode, relu, e, e_r, lo, hi, pro, x32, in_bias, in_relu, in_len, m1, m1s, e1,
             lo1, hi1, 0, 0, 0, stages, ct_per, groups, cg, cog, shuffle, hcap, hs, in_hcap,
             in_hs};
  p.nc = (cg + kChunk - 1) / kChunk;
  p.rows_h = (kBM - 1) * stride + (k_size - 1) * dil + 1;
  p.pitch = p.nc * kChunk + 16;
  const int smem = DcLayout(bn, stages, p.rows_h, p.pitch).bytes;
  if (smem > gemm_s8::kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map{};
  if (!make_w_map(&map, w, cout, k_size, cg, bn)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_ct = (cog + bn - 1) / bn;
  const int z = groups * ((n_ct + ct_per - 1) / ct_per);
  if (z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((t_out + kBM - 1) / kBM, batch, z);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool uu = u8 != 0;
  cudaError_t rc;
  switch (bn) {
    case 128: rc = launch_bn<128>(uu, map, p, grid, smem, st); break;
    case 160: rc = launch_bn<160>(uu, map, p, grid, smem, st); break;
    case 192: rc = launch_bn<192>(uu, map, p, grid, smem, st); break;
    default: rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}
