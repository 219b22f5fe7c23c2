// ffn_ln: one frozen Conformer FFN half-step on the int8 stream, with the
// next sublayer's i-LayerNorm as an optional tail, (N = B*T, d) int8 in,
// (N, d) int8 out and (N, d) int8 tail, in one launch.
//
// Replaces qasr_tpu/kernels/conf_module.py::fused_ffn_ln (pl.pallas_call at
// conf_module.py:206), bit for bit with the XLA composition at
// qasr_tpu/quantize/conformer_freeze.py:593-599 / 671-678:
//
//   yln  = clamp(rq(sgn * iLN(x) + b_ln, m_ln, e_ln))                 (int8)
//   a8   = clamp(rq(yln @ W1 + b1, m1, e1))                 (N, f = ff*d)
//   m8   = clamp(rq(a8 * i_sigmoid(rq(a8, grid)), prod))              (int8)
//   out  = clamp(rq(m8 @ W2 + b2, m2, e2) + rq(x, js))                (int8)
//   tail = clamp(rq(sgn_t * iLN(out) + b_t, m_t, e_t))   (when tail3 given)
//
// No length mask: like the TPU kernel and the XLA composition, rows past a
// sequence's length are computed as any other row (each row's result
// depends on that row alone).
//
// What bounds it on an H100, at the flagship shape (N = 12,000, d = 256,
// f = 1024): two GEMMs of 3.1 G multiply-adds each, 12.6 G int8 operations
// (about 6.4 us of tensor-core time), against 6 MB of stream in and out and
// 0.5 MB of weights (about 2 us at 3.35 TB/s).  The card spends its time
// on integer work on the CUDA cores instead: the requant, clamp and i-swish
// of 12.3 M l1 elements, the join of 3.1 M, two i-LNs of 3.1 M each, and
// the weight pipeline's bookkeeping (about 355 M integer-pipe
// lane-instructions a call in this design, 21 us at the ideal issue rate;
// PERF.md).  So the design cuts integer instructions per element:
//  - the per-column requants (i-LN affine, l1, l2, tail affine) run on the
//    FP64 pipe (qasr_rq_f64: one integer and two FP64 instructions) at each
//    site where the host has shown every column's |z| m < 2^(e+26) for any
//    int8 input (kernels/ffn_ln.py, with kernels/checks.py::f64_fits; the
//    flagship's sites all qualify), else as qasr_rq with the column's
//    mantissa folded into the site's constants; the choice is per site,
//    made on the host (a NULL scale row means qasr_rq);
//  - the i-swish after the l1 requant is a function of the clamped a8
//    alone, and the join's stream requant one of the int8 x: both are
//    256-entry tables built once per layer on the host from the plain
//    functions and staged in shared memory;
//  - the i-LN divides by d with an invariant divisor, takes the square root
//    in float, corrected, and divides by sigma with a float estimate
//    corrected once each way (qasr_ln_row_div);
//  - the weights come packed from the host in the order the block consumes
//    them, as tiles of 128 output rows x 64 bytes of K (8 KB, the 16-byte
//    units of row r XOR-swizzled by (r >> 1) & 3, so that ldmatrix reads
//    them without bank conflicts), one bulk copy each
//    (cp.async.bulk, completed on an mbarrier) into a ring of kStages
//    stages that a producer warp keeps full while four consumer warps
//    multiply, each 32 rows x 32 columns of the chunk (mma.sync m16n8k32
//    s8 on ldmatrix fragments: 256 bytes of shared memory read per mma);
//  - each block reads both weight matrices whole from L2 (196.6 MB a call
//    at the flagship shape): clusters of 2 and 4 CTAs sharing each tile by
//    multicast cut that 2-4x and ran slower (PERF.md), so that traffic
//    is not what bounds the kernel.
//
// Tiles: 32 rows of the flattened stream per block of 160 threads (four
// consumer warps and the producer warp).  At the flagship shape: 375
// blocks, 76,080 bytes of shared memory each (3 fit an SM: one wave);
// the (32, f) swish activation M8 stays in shared memory, so nothing but x,
// out, the tail and the weights crosses device memory.  The join writes its
// result back over x in shared memory, whence the out rows leave in 16-byte
// stores and the tail i-LN reads them.  d a multiple of 64 up to 512, f a
// multiple of 64 (within shared memory); a chunk of 64 columns (the last
// one where the width is an odd multiple of 64) leaves two warps idle.
#include <cstdint>

#include <cuda_runtime.h>

#include "conformer_int.cuh"
#include "gemm_s8.cuh"
#include "requant.cuh"
#include "tile_s8.cuh"

namespace {

constexpr int kRows = 32;                   // rows per block
constexpr int kMma = 4;                     // consumer warps: 32 rows x 32 columns each
constexpr int kThreads = 32 * (kMma + 1);   // and the producer warp
constexpr int kCols = 128;                  // output columns per chunk = weight rows per tile
constexpr int kKT = 64;                     // bytes of K per tile
constexpr int kTile = kCols * kKT;          // 8 KB
constexpr int kStages = 3;
constexpr int kMaxPer = 16;                 // d <= 512: values per lane in the i-LN

using gemm_s8::smem_u32;

__device__ __forceinline__ int clamp8(int q, int n8) { return qasr_clamp(q, -n8, n8 - 1); }

// `bytes` (a multiple of 16) from global src to shared dst, counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :
      : "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Device pointers and sizes of one call.  Weight tiles: W (nout, K) as
// chunks of kCols rows (the last may have 64), each as K / kKT tiles of
// rows x kKT bytes; tile (c, k) at byte c kCols K + k rows kKT.  ln3 /
// tail3 (3, d): sgn, b, m rows; bm1 (2, f), bm2 (2, d): b, m rows; *_mf:
// the site's m 2^-e per column (float64), or NULL for qasr_rq.  swish:
// m8 of a8 at a8 + 128; stab: rq(x, js) at x + 128.
struct Params {
  const int8_t* x;
  const int8_t* w1;
  const int8_t* w2;
  const int32_t* ln3;
  const double* ln_mf;
  const int32_t* bm1;
  const double* mf1;
  const int32_t* bm2;
  const double* mf2;
  const int32_t* tail3;
  const double* tail_mf;
  const uint8_t* swish;
  const int32_t* stab;
  int8_t* out;
  int8_t* tail_out;
  int N, d, f, e_ln, e1, e2, e_tail, n8;
};

// Byte c of row r of the x tile X (rows of d bytes, no padding): its 16-byte
// units XOR-swizzled by r & 3 (d / 16 is a multiple of 4), so that the
// join's reads and writes of eight rows at one column fall on four bank
// groups instead of one
__device__ __forceinline__ int xat(int r, int c, int d) {
  return r * d + ((((c >> 4) ^ r) & 3) | (c >> 4 & ~3)) * 16 + (c & 15);
}

// the consumers' named barrier (id 0 is __syncthreads')
__device__ __forceinline__ void mma_sync_warps() { gemm_s8::bar_sync(1, 32 * kMma); }

// rows r, r + step, ... of a 32-row tile of d bytes, 16-byte piece q: a
// consumer thread's share of a tile copy, with no division in the loop
struct RowSplit {
  int r, q, step;
};

__device__ __forceinline__ RowSplit row_split(int d) {
  const int pr = d / 16;
  RowSplit s;
  s.step = 32 * kMma / pr;
  s.r = threadIdx.x / pr;
  s.q = threadIdx.x - s.r * pr;
  if (s.r >= s.step) s.r = kRows;   // past every loop's end
  return s;
}

// The i-LN of the tile's 32 rows of X (8 a consumer warp) and the affine
// requant of ln3 into Y; kP >= d / 32 values a lane, exactly d / 32 when
// kExact (no per-value guards); the lane's columns' constants are loaded
// once for its rows
template <int kP, bool kExact, bool kF64>
__device__ void ln_tile(const int8_t* X, int8_t* Y, int ldy,
                        const int32_t* __restrict__ ln3, const double* __restrict__ mf, int e,
                        int d, int n8) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = kExact ? kP : d / 32;
  const QasrDiv dd = qasr_div_make(static_cast<unsigned>(d));
  const QasrRq site = qasr_rq_make(1, e);
  int ls[kP], lb[kP], lm[kP];
  double lf[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    const int o = k < per ? lane + 32 * k : lane;
    ls[k] = __ldg(ln3 + o);
    lb[k] = __ldg(ln3 + d + o);
    if (kF64)
      lf[k] = __ldg(mf + o);
    else
      lm[k] = __ldg(ln3 + 2 * d + o);
  }
  for (int rr = 0; rr < kRows / kMma; ++rr) {
    const int rl = warp * (kRows / kMma) + rr;
    int xv[kP], yv[kP];
#pragma unroll
    for (int k = 0; k < kP; ++k) xv[k] = k < per ? X[xat(rl, lane + 32 * k, d)] : 0;
    qasr_ln_row_div<kP>(xv, yv, per, d, dd);
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      if (k < per) {
        const int z = ls[k] * yv[k] + lb[k];
        Y[rl * ldy + lane + 32 * k] = static_cast<int8_t>(
            clamp8(kF64 ? qasr_rq_f64(z, lf[k]) : qasr_rq(z, qasr_rq_col(site, lm[k])), n8));
      }
    }
  }
}

// ln_tile compiled for d = 64, 128, 256, 512 exactly, else for the
// smallest of 8, 16 values a lane that covers d / 32; on the FP64 pipe
// when the site's scales are given
template <bool kF64>
__device__ void ln_tile_any(const int8_t* X, int8_t* Y, int ldy, const int32_t* ln3,
                            const double* mf, int e, int d, int n8) {
  switch (d) {
    case 64: return ln_tile<2, true, kF64>(X, Y, ldy, ln3, mf, e, d, n8);
    case 128: return ln_tile<4, true, kF64>(X, Y, ldy, ln3, mf, e, d, n8);
    case 256: return ln_tile<8, true, kF64>(X, Y, ldy, ln3, mf, e, d, n8);
    case 32 * kMaxPer: return ln_tile<kMaxPer, true, kF64>(X, Y, ldy, ln3, mf, e, d, n8);
    default:
      if (d < 256)
        ln_tile<8, false, kF64>(X, Y, ldy, ln3, mf, e, d, n8);
      else
        ln_tile<kMaxPer, false, kF64>(X, Y, ldy, ln3, mf, e, d, n8);
  }
}

__device__ __forceinline__ void ln_site(const int8_t* X, int8_t* Y, int ldy, const int32_t* ln3,
                                        const double* mf, int e, int d, int n8) {
  if (mf != nullptr)
    ln_tile_any<true>(X, Y, ldy, ln3, mf, e, d, n8);
  else
    ln_tile_any<false>(X, Y, ldy, ln3, mf, e, d, n8);
}

// The weight pipeline's state: the stages, their full / empty mbarriers,
// and the stage and phase parity of the next tile (the same sequence in
// the producer and in every consumer warp)
struct Ring {
  uint8_t* stage;
  uint64_t* full;
  uint64_t* empty;
  int s, phase;
  __device__ __forceinline__ void advance() {
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
};

// acc = A (32 x K, rows of lda bytes) . W[c0 : c0 + rows)^T for this warp's
// 32 x 32 part of the chunk (rows = 128, or 64 for a last half chunk, when
// warps 2-3 only wait and release).  Accumulator (mi, j, r) is row 16 mi +
// g + 8 (r >> 1), column 32 w + 8 j + 2 t4 + (r & 1) of the chunk.
__device__ __forceinline__ void gemm_chunk(const int8_t* A, int lda, int K, int rows, Ring& ring,
                                           int (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane >> 3, rr = lane & 7;
  const bool active = 32 * warp < rows;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][j][r] = 0;
  // matrix q of A: rows 8 (q & 1), bytes 16 (q >> 1); of B: weight rows 8
  // (q >> 1), bytes 16 (q & 1), the unit swizzled by the row's (rr >> 1) & 3
  const int8_t* a_row = A + (rr + 8 * (q & 1)) * lda + 16 * (q >> 1);
  const int b_off = (32 * warp + rr + 8 * (q >> 1)) * kKT;
  const int key = (rr >> 1) & 3;
  for (int k0 = 0; k0 < K; k0 += kKT, ring.advance()) {
    gemm_s8::mbar_wait(ring.full + ring.s, ring.phase);
    if (active) {
      const uint8_t* st = ring.stage + ring.s * kTile + b_off;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        int a[2][4];
        qasr_ldsm4(a[0], a_row + k0 + 32 * ks);
        qasr_ldsm4(a[1], a_row + 16 * lda + k0 + 32 * ks);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          int b[4];
          qasr_ldsm4(b, st + p * 16 * kKT + 16 * ((2 * ks + (q & 1)) ^ key));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            qasr_mma_s8(acc[mi][2 * p], a[mi], b[0], b[1]);
            qasr_mma_s8(acc[mi][2 * p + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty + ring.s);
  }
}

// l1 epilogue: bias, the column's requant, clamp, the tabulated i-swish ->
// M8 (row pitch ldm), columns o0 + [0, 32) of f
template <bool kF64>
__device__ __forceinline__ void l1_epilogue(const int (&acc)[2][4][4], int o0,
                                            const int32_t* __restrict__ bm,
                                            const double* __restrict__ mf, const QasrRq& site,
                                            int f, const uint8_t* swish, int8_t* M8, int ldm,
                                            int n8) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + 8 * j + 2 * t4;
    const int b0 = __ldg(bm + o), b1 = __ldg(bm + o + 1);
    const QasrColRq<kF64> q0(site, bm + f, mf, o), q1(site, bm + f, mf, o + 1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mi + g + 8 * h;
        const int v0 = clamp8(q0(acc[mi][j][2 * h] + b0), n8);
        const int v1 = clamp8(q1(acc[mi][j][2 * h + 1] + b1), n8);
        *reinterpret_cast<short*>(M8 + r * ldm + o) =
            qasr_pack2(swish[v0 + 128], swish[v1 + 128]);
      }
  }
}

// l2 epilogue and the stream join, in place over the x tile X, columns o0
// + [0, 32) of d
template <bool kF64>
__device__ __forceinline__ void l2_epilogue(const int (&acc)[2][4][4], int o0,
                                            const int32_t* __restrict__ bm,
                                            const double* __restrict__ mf, const QasrRq& site,
                                            int d, const int* stab, int8_t* X, int n8) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + 8 * j + 2 * t4;
    const int b0 = __ldg(bm + o), b1 = __ldg(bm + o + 1);
    const QasrColRq<kF64> q0(site, bm + d, mf, o), q1(site, bm + d, mf, o + 1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mi + g + 8 * h;
        short* xp = reinterpret_cast<short*>(X + xat(r, o, d));
        const short xs = *xp;
        *xp = qasr_pack2(
            clamp8(q0(acc[mi][j][2 * h] + b0) + stab[static_cast<int8_t>(xs & 0xff) + 128], n8),
            clamp8(q1(acc[mi][j][2 * h + 1] + b1) + stab[static_cast<int8_t>(xs >> 8) + 128], n8));
      }
  }
}

// rows [0, rows) of a tile -> dst rows of d bytes, 16 bytes a store: the x
// tile (swizzled, lds = 0) or one of row pitch lds
__device__ __forceinline__ void store_rows(const int8_t* S, int lds, int8_t* dst, int rows,
                                           int d, const RowSplit& sp) {
  for (int r = sp.r; r < rows; r += sp.step)
    *reinterpret_cast<int4*>(dst + static_cast<size_t>(r) * d + 16 * sp.q) =
        *reinterpret_cast<const int4*>(S + (lds ? r * lds + 16 * sp.q : xat(r, 16 * sp.q, d)));
}

__global__ void __launch_bounds__(kThreads, 3) ffn_ln_kernel(const Params p) {
  extern __shared__ int4 smem4[];
  const int d = p.d, f = p.f, n8 = p.n8;
  const int lda = d + 16, ldm = f + 16;   // 16 bytes of padding: ldmatrix rows on distinct banks
  uint8_t* stages = reinterpret_cast<uint8_t*>(smem4);          // kStages x kTile
  int8_t* X = reinterpret_cast<int8_t*>(stages + kStages * kTile);   // 32 x d (xat): x, then out
  int8_t* A8 = X + kRows * d;                                    // 32 x lda: yln, then the tail
  int8_t* M8 = A8 + kRows * lda;                                 // 32 x ldm: m8
  int* Stab = reinterpret_cast<int*>(M8 + kRows * ldm);          // 256 int32
  uint8_t* Swish = reinterpret_cast<uint8_t*>(Stab + 256);       // 256 bytes
  uint64_t* bars = reinterpret_cast<uint64_t*>(Swish + 256);     // full[kStages], empty[kStages]
  Ring ring{stages, bars, bars + kStages, 0, 0};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kRows;
  const int rows = p.N - n0 < kRows ? p.N - n0 : kRows;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      gemm_s8::mbar_init(ring.full + s, 1);
      gemm_s8::mbar_init(ring.empty + s, kMma);
    }
    gemm_s8::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kMma) {
    // the producer: every tile of W1 (f x d), then of W2 (d x f), into
    // the stage the consumers released kStages tiles ago
    if (lane == 0) {
      bool first = true;   // the first round of stages: nothing to wait for
      for (int gi = 0; gi < 2; ++gi) {
        const int8_t* w = gi == 0 ? p.w1 : p.w2;
        const int nout = gi == 0 ? f : d, K = gi == 0 ? d : f;
        for (int c0 = 0; c0 < nout; c0 += kCols) {
          const int rows_c = nout - c0 < kCols ? nout - c0 : kCols;
          const unsigned bytes = static_cast<unsigned>(rows_c * kKT);
          for (int k0 = 0; k0 < K; k0 += kKT, ring.advance()) {
            if (!first) gemm_s8::mbar_wait(ring.empty + ring.s, ring.phase ^ 1);
            first = first && ring.s + 1 < kStages;
            gemm_s8::mbar_expect_tx(ring.full + ring.s, bytes);
            bulk_load(ring.stage + ring.s * kTile,
                      w + static_cast<size_t>(c0) * K + static_cast<size_t>(k0) * rows_c, bytes,
                      ring.full + ring.s);
          }
        }
      }
    }
    __syncwarp();
  } else {
    // the consumers: the x tile (zero past N) and the two tables
    const RowSplit sp = row_split(d);
    for (int r = sp.r; r < kRows; r += sp.step) {
      const int n = n0 + r;
      qasr_cp16(X + xat(r, 16 * sp.q, d),
                p.x + (n < p.N ? static_cast<size_t>(n) * d + 16 * sp.q : 0), n < p.N ? 16 : 0);
    }
    if (tid < 64) qasr_cp16(Stab + 4 * tid, p.stab + 4 * tid, 16);
    if (tid < 16) qasr_cp16(Swish + 16 * tid, p.swish + 16 * tid, 16);
    qasr_cp_commit();
    qasr_cp_wait<0>();
    mma_sync_warps();
    ln_site(X, A8, lda, p.ln3, p.ln_mf, p.e_ln, d, n8);
    mma_sync_warps();

    int acc[2][4][4];
    const QasrRq s1 = qasr_rq_make(1, p.e1), s2 = qasr_rq_make(1, p.e2);
    for (int c0 = 0; c0 < f; c0 += kCols) {
      const int rows_c = f - c0 < kCols ? f - c0 : kCols;
      gemm_chunk(A8, lda, d, rows_c, ring, acc);
      if (32 * warp < rows_c) {
        if (p.mf1 != nullptr)
          l1_epilogue<true>(acc, c0 + 32 * warp, p.bm1, p.mf1, s1, f, Swish, M8, ldm, n8);
        else
          l1_epilogue<false>(acc, c0 + 32 * warp, p.bm1, p.mf1, s1, f, Swish, M8, ldm, n8);
      }
    }
    mma_sync_warps();   // M8 complete; A8 free
    for (int c0 = 0; c0 < d; c0 += kCols) {
      const int rows_c = d - c0 < kCols ? d - c0 : kCols;
      gemm_chunk(M8, ldm, f, rows_c, ring, acc);
      if (32 * warp < rows_c) {
        if (p.mf2 != nullptr)
          l2_epilogue<true>(acc, c0 + 32 * warp, p.bm2, p.mf2, s2, d, Stab, X, n8);
        else
          l2_epilogue<false>(acc, c0 + 32 * warp, p.bm2, p.mf2, s2, d, Stab, X, n8);
      }
    }
    mma_sync_warps();   // X holds the joined rows
    store_rows(X, 0, p.out + static_cast<size_t>(n0) * d, rows, d, sp);
    if (p.tail3 != nullptr) {
      ln_site(X, A8, lda, p.tail3, p.tail_mf, p.e_tail, d, n8);
      mma_sync_warps();
      store_rows(A8, lda, p.tail_out + static_cast<size_t>(n0) * d, rows, d, sp);
    }
  }
}

size_t smem_bytes(int d, int f) {
  return static_cast<size_t>(kStages) * kTile + kRows * static_cast<size_t>(2 * d + 16) +
         kRows * static_cast<size_t>(f + 16) + 4 * 256 + 256 + 2 * kStages * sizeof(uint64_t);
}

cudaError_t launch(const Params& p, cudaStream_t s) {
  const size_t smem = smem_bytes(p.d, p.f);
  const void* fn = reinterpret_cast<const void*>(ffn_ln_kernel);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  ffn_ln_kernel<<<(p.N + kRows - 1) / kRows, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// w1 / w2: the weights as the tile sequence of kernels/ffn_ln.py::pack_tiles;
// a NULL *_mf requants that site with qasr_rq, a given one with qasr_rq_f64
// (the caller has checked the site's domain, kernels/ffn_ln.py).
extern "C" int qasr_ffn_ln(const int8_t* x, const int8_t* w1, const int8_t* w2,
                           const int32_t* ln3, const double* ln_mf, const int32_t* bm1,
                           const double* mf1, const int32_t* bm2, const double* mf2,
                           const int32_t* tail3, const double* tail_mf, const uint8_t* swish,
                           const int32_t* stab, int8_t* out, int8_t* tail_out, int N, int d,
                           int f, int e_ln, int e1, int e2, int e_tail, int n8, void* stream) {
  if (N < 1 || d % 64 != 0 || d < 64 || d > 32 * kMaxPer || f % 64 != 0 || f < 64 ||
      x == nullptr || w1 == nullptr || w2 == nullptr || ln3 == nullptr || bm1 == nullptr ||
      bm2 == nullptr || swish == nullptr || stab == nullptr || out == nullptr ||
      (tail3 == nullptr) != (tail_out == nullptr) || (tail3 == nullptr && tail_mf != nullptr) ||
      smem_bytes(d, f) > static_cast<size_t>(gemm_s8::kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x,    w1,    w2,   ln3,  ln_mf,  bm1, mf1,   bm2, mf2, tail3, tail_mf, swish,
                 stab, out, tail_out, N, d,      f,   e_ln, e1,  e2,  e_tail, n8};
  return static_cast<int>(launch(p, static_cast<cudaStream_t>(stream)));
}
