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
// 0.5 MB of weights (about 2 us at 3.35 TB/s): operations bound it.  Beside
// the tensor-core work, 12.3 M integer sigmoids (a runtime division each)
// and 2 x 12,000 i-LN rows run on the CUDA cores (the sigmoids tabulated,
// below).
//
// Design: the TPU runs one grid step per utterance, which here would fill
// 32 of 132 SMs; every row's LayerNorm needs only its own d values, so a
// block takes 32 rows of the flattened stream (256 threads, 8 warps as
// 2 row groups x 4 column groups): 375 blocks at the flagship shape, three
// to an SM (68 KB of shared memory each), one wave, 24 warps to hide
// latency.  The (32, f) swish activation m8 stays in shared memory (32 KB
// at d = 256, 64 KB at d = 512), so nothing but x, out and the tail
// crosses device memory; the weights do not fit (256 KB each at d = 256)
// and stream through a 64-row x 256-byte shared buffer (from L2 after the
// first blocks), one 64-column output chunk at a time with the K loop
// inside.  The i-swish after the l1 requant is a function of the clamped
// int8 a8 alone, so each block tabulates it once over a8's 2 n8 values
// (the same device functions) and the epilogue looks it up: 256 integer
// sigmoids per block instead of 32 f.  i-LN: one warp per row
// (conformer_int.cuh).  GEMMs: mma.sync m16n8k32 s8 on operands in shared
// memory, rows padded by 4 words against bank conflicts.  The join writes
// its result back over x in shared memory, where the tail i-LN reads it.
// d a multiple of 64 up to 512, f a multiple of 64.  No cp.async, TMA or
// wgmma yet.
#include <cstdint>

#include <cuda_runtime.h>

#include "conformer_int.cuh"
#include "requant.cuh"

namespace {

constexpr int kRows = 32;         // rows per block
constexpr int kCols = 64;         // output columns per GEMM chunk
constexpr int kThreads = 256;     // 8 warps: 2 row groups x 4 column groups
constexpr int kMaxPer = 16;       // d <= 512: values per lane in the i-LN
constexpr int kKC = 256;          // bytes of K per weight stage
constexpr int kLdw = kKC / 4 + 4; // weight stage row, in words

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int clamp8(int q, int n8) { return qasr_clamp(q, -n8, n8 - 1); }

// acc = As[0:32, 0:K] . W[c0:c0+64, 0:K]^T for this warp's 16 x 16 part;
// As holds int8 rows of lda words, W (rows, K) int8 row-major in device
// memory, streamed through Ws.  Accumulator (j, r) is row 16 wr + g +
// 8 (r >> 1), column 16 wc + 8 j + 2 t4 + (r & 1) of the chunk.
__device__ __forceinline__ void gemm_chunk(const int* As, int lda, const int8_t* __restrict__ w,
                                           int K, int c0, int* Ws, int (&acc)[2][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp >> 2, wc = warp & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int q16 = (K - k0 < kKC ? K - k0 : kKC) / 16;   // 16-byte pieces per row
    __syncthreads();
    for (int idx = threadIdx.x; idx < kCols * q16; idx += kThreads) {
      const int r = idx / q16, q = idx % q16;
      reinterpret_cast<int4*>(Ws)[r * (kLdw / 4) + q] = *reinterpret_cast<const int4*>(
          w + static_cast<size_t>(c0 + r) * K + k0 + 16 * q);
    }
    __syncthreads();
    const int row = wr * 16 + g;
    for (int ks = 0; ks < 4 * q16; ks += 8) {
      const int ka = k0 / 4 + ks;
      const int a[4] = {As[row * lda + ka + t4], As[(row + 8) * lda + ka + t4],
                        As[row * lda + ka + t4 + 4], As[(row + 8) * lda + ka + t4 + 4]};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wc * 16 + j * 8 + g;
        mma_s8(acc[j], a, Ws[c * kLdw + ks + t4], Ws[c * kLdw + ks + t4 + 4]);
      }
    }
  }
}

// i-LayerNorm of the 32 rows in X (32 x d int8), one warp per row, then the
// affine requant of ln3 = (sgn, b, m) rows -> dst row r at dst + r * ld, for
// the first `rows` rows
__device__ __forceinline__ void ln_rows(const int8_t* X, int d, const int32_t* __restrict__ ln3,
                                        int e, int n8, int8_t* dst, int ld, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = d / 32;
  for (int rr = 0; rr < kRows / 8; ++rr) {
    const int rl = warp * (kRows / 8) + rr;
    if (rl >= rows) break;
    int xv[kMaxPer], yv[kMaxPer];
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) xv[k] = k < per ? X[rl * d + lane + 32 * k] : 0;
    qasr_ln_row<kMaxPer>(xv, yv, per, d);
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      if (k < per) {
        const int o = lane + 32 * k;
        dst[static_cast<size_t>(rl) * ld + o] = static_cast<int8_t>(
            clamp8(qasr_requant(ln3[o] * yv[k] + ln3[d + o], ln3[2 * d + o], e), n8));
      }
    }
  }
}

// bm1 (2, f) and bm2 (2, d): bias and mantissa rows; ln3 / tail3 (3, d):
// sgn, b, m rows.  Scalars as arguments.
__global__ void __launch_bounds__(kThreads, 3)
ffn_ln_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w1,
              const int32_t* __restrict__ bm1, const int8_t* __restrict__ w2,
              const int32_t* __restrict__ bm2, const int32_t* __restrict__ ln3,
              const int32_t* __restrict__ tail3, int8_t* __restrict__ out,
              int8_t* __restrict__ tail_out, int N, int d, int f, int e_ln, int e1,
              int grid_m, int grid_e, int prod_m, int prod_e, int e2, int js_m, int js_e,
              int e_tail, int n8) {
  extern __shared__ int4 smem4[];
  const int lda = d / 4 + 4, ldf = f / 4 + 4;
  int* Ws = reinterpret_cast<int*>(smem4);                  // 64 x kLdw words
  int* As = Ws + kCols * kLdw;                              // 32 x lda words
  int* Ms = As + kRows * lda;                               // 32 x ldf words
  int8_t* X = reinterpret_cast<int8_t*>(Ms + kRows * ldf);  // 32 x d bytes
  int8_t* Swish = X + kRows * d;                            // 256 bytes, by a8 + 128
  int8_t* A8 = reinterpret_cast<int8_t*>(As);
  int8_t* M8 = reinterpret_cast<int8_t*>(Ms);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp >> 2, wc = warp & 3;
  const int n0 = blockIdx.x * kRows;
  const int rows = N - n0 < kRows ? N - n0 : kRows;

  for (int v = threadIdx.x; v < 256; v += kThreads) {
    const int a8 = clamp8(v - 128, n8);
    const int y = a8 * qasr_i_sigmoid_grid(qasr_requant(a8, grid_m, grid_e));
    Swish[v] = static_cast<int8_t>(clamp8(qasr_requant(y, prod_m, prod_e), n8));
  }
  const int d16 = d / 16;
  for (int idx = threadIdx.x; idx < kRows * d16; idx += kThreads) {
    const int r = idx / d16, q = idx % d16;
    reinterpret_cast<int4*>(X)[idx] =
        r < rows ? *reinterpret_cast<const int4*>(x + static_cast<size_t>(n0 + r) * d + 16 * q)
                 : make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  ln_rows(X, d, ln3, e_ln, n8, A8, 4 * lda, kRows);

  // l1 GEMM -> requant -> i-swish (tabulated) -> M8, 64 columns of f per chunk
  int acc[2][4];
  for (int c = 0; c < f / kCols; ++c) {
    gemm_chunk(As, lda, w1, d, c * kCols, Ws, acc);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rl = wr * 16 + g + 8 * (r >> 1);
        const int o = c * kCols + wc * 16 + j * 8 + 2 * t4 + (r & 1);
        const int a8 = clamp8(qasr_requant(acc[j][r] + bm1[o], bm1[f + o], e1), n8);
        M8[rl * 4 * ldf + o] = Swish[a8 + 128];
      }
    }
  }

  // l2 GEMM + the stream join; the result replaces x in X
  for (int c = 0; c < d / kCols; ++c) {
    gemm_chunk(Ms, ldf, w2, f, c * kCols, Ws, acc);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rl = wr * 16 + g + 8 * (r >> 1);
        const int o = c * kCols + wc * 16 + j * 8 + 2 * t4 + (r & 1);
        const int xo = clamp8(qasr_requant(acc[j][r] + bm2[o], bm2[d + o], e2) +
                                  qasr_requant(X[rl * d + o], js_m, js_e),
                              n8);
        X[rl * d + o] = static_cast<int8_t>(xo);
        if (rl < rows) out[static_cast<size_t>(n0 + rl) * d + o] = static_cast<int8_t>(xo);
      }
    }
  }
  if (tail3 == nullptr) return;
  __syncthreads();
  ln_rows(X, d, tail3, e_tail, n8, tail_out + static_cast<size_t>(n0) * d, d, rows);
}

}  // namespace

extern "C" int qasr_ffn_ln(const int8_t* x, const int8_t* w1, const int32_t* bm1,
                           const int8_t* w2, const int32_t* bm2, const int32_t* ln3,
                           const int32_t* tail3, int8_t* out, int8_t* tail_out, int N, int d,
                           int f, int e_ln, int e1, int grid_m, int grid_e, int prod_m,
                           int prod_e, int e2, int js_m, int js_e, int e_tail, int n8,
                           void* stream) {
  if (N < 1 || d % 64 != 0 || d < 64 || d > 32 * kMaxPer || f % 64 != 0 || f < 64 ||
      (tail3 == nullptr) != (tail_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * (static_cast<size_t>(kCols) * kLdw +
                           static_cast<size_t>(kRows) * (d / 4 + 4 + f / 4 + 4)) +
                      static_cast<size_t>(kRows) * d + 256;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(ffn_ln_kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_ln_kernel<<<(N + kRows - 1) / kRows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w1, bm1, w2, bm2, ln3, tail3, out, tail_out, N, d, f, e_ln, e1, grid_m, grid_e, prod_m,
      prod_e, e2, js_m, js_e, e_tail, n8);
  return static_cast<int>(cudaGetLastError());
}
