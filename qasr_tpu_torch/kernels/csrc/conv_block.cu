// conv_block: the frozen Conformer's attention-output join plus its whole
// conv module, (B, T, d) int8 in and out, in two launches.
//
// Replaces qasr_tpu/kernels/conf_module.py::fused_conv_block (pl.pallas_call
// at conf_module.py:341), bit for bit with the XLA composition at
// qasr_tpu/quantize/conformer_freeze.py:650-659:
//
//   x1   = clamp(rq(c8 @ W_ao + b_ao) + rq(x8, j2))                 (int8)
//   yln  = clamp(rq(sgn * iLN(x1) + b_ln))                           (int8)
//   a8   = clamp(rq(yln @ W_a + b_a));  g = rq(yln @ W_g + b_g)
//   glu8 = clamp(rq(mask_{t < len}(a8 * i_sigmoid(g)), glu_prod))    (int8)
//   bn8  = clamp(rq(sgn * dw(glu8) + b_dw));  mid8 = i-swish(bn8)    (int8)
//   out  = clamp(rq(mid8 @ W_2 + b_2) + rq(x1, j3))                  (int8)
//
// What bounds it on an H100, at the flagship shape (B=32, T=375, d=256):
// 4 d x d GEMM-equivalents (att_out, the d -> 2d GLU, pw2) of 12,000 rows
// are 3.1 G int8 multiply-adds (about 3 us of tensor-core time); the
// bytes it must move are c8, x8 and out (3 x 3.1 MB) and the weights
// (about 5 us at 3.35 TB/s).  The depthwise taps (31 multiply-adds per
// output, 95 M) and the integer LN / sigmoid chains run on the CUDA cores.
//
// Design: the TPU runs one grid step per utterance, which here would fill
// 32 of 132 SMs, so the work splits in time.  Stage A takes 64 rows of the
// flattened (B*T, d) stream per 256-thread block: the att_out GEMM and
// the join (x1 goes to smem and to the output buffer), one warp per row
// for the i-LN, then the GLU GEMM over weights interleaved so that each
// thread holds an a column and its matching g column; it writes glu8.
// Stage B takes 64 frames of one utterance plus the (K-1) halo of glu8
// (zero outside [0, T)), runs the depthwise taps, BN and i-swish into
// smem, then the pw2 GEMM whose epilogue joins against x1 read back from
// the output buffer at the same element it overwrites.  GEMMs use
// mma.sync m16n8k32 s8 on operands staged whole in shared memory (rows
// padded by 4 words against bank conflicts).  glu8 is the only
// intermediate in device memory.  No cp.async or wgmma yet.
#include <cstdint>

#include <cuda_runtime.h>

#include "conformer_int.cuh"
#include "requant.cuh"

namespace {

constexpr int kRows = 64;         // rows (stage A) or frames (stage B) per block
constexpr int kThreads = 256;     // 8 warps: 4 row groups x 2 column groups
constexpr int kMaxPer = 16;       // d <= 512: values per lane in the i-LN

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int ld32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

__device__ __forceinline__ int clamp8(int q, int n8) { return qasr_clamp(q, -n8, n8 - 1); }

// 64 rows [row0, row0 + 64) of a row-major (N, d) int8 matrix -> smem words
__device__ __forceinline__ void load_rows(int* dst, const int8_t* src, int row0, int d,
                                          int lda) {
  const int dw = d / 4;
  for (int idx = threadIdx.x; idx < kRows * dw; idx += kThreads) {
    const int r = idx / dw, w = idx % dw;
    dst[r * lda + w] = ld32(src + static_cast<size_t>(row0 + r) * d + 4 * w);
  }
}

// acc = As (64 x d) . Ws^T (64 x d) for this warp's 16 x 32 part:
// accumulator (j, r) is row 16 wr + g + 8 (r >> 1), column 32 wc + 8 j + 2 t4 + (r & 1)
__device__ __forceinline__ void gemm_tile(const int* As, const int* Ws, int lda, int d,
                                          int (&acc)[4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp >> 1, wc = warp & 1;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0;
  for (int kw = 0; kw < d / 4; kw += 8) {
    const int row = wr * 16 + g;
    const int a[4] = {As[row * lda + kw + t4], As[(row + 8) * lda + kw + t4],
                      As[row * lda + kw + t4 + 4], As[(row + 8) * lda + kw + t4 + 4]};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wc * 32 + j * 8 + g;
      mma_s8(acc[j], a, Ws[c * lda + kw + t4], Ws[c * lda + kw + t4 + 4]);
    }
  }
}

// vec rows (each d int32): b_ao, m_ao, ln_sgn, ln_b, ln_m, b_a, m_a, b_g,
// m_g, dw_sgn, dw_b, dw_m, b_2, m_2.  sc: e_ao, j2_m, j2_e, e_ln, e_a, e_g,
// glu_m, glu_e, e_dw, bng_m, bng_e, bnp_m, bnp_e, e_2, j3_m, j3_e.
__global__ void __launch_bounds__(kThreads)
conv_block_stage_a(const int8_t* __restrict__ c8, const int8_t* __restrict__ x8,
                   const int32_t* __restrict__ lens, const int8_t* __restrict__ w_ao,
                   const int8_t* __restrict__ w_ag, const int32_t* __restrict__ vec,
                   const int32_t* __restrict__ sc, int8_t* __restrict__ glu8,
                   int8_t* __restrict__ x1out, int N, int T, int d, int n8) {
  extern __shared__ int smem[];
  const int lda = d / 4 + 4;
  int* As = smem;                                        // 64 x lda words
  int* Ws = As + kRows * lda;                            // 64 x lda words
  int8_t* X1 = reinterpret_cast<int8_t*>(Ws + kRows * lda);  // 64 x d bytes
  int8_t* A8 = reinterpret_cast<int8_t*>(As);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp >> 1, wc = warp & 1;
  const int n0 = blockIdx.x * kRows;
  const int dw = d / 4;

  for (int idx = tid; idx < kRows * dw; idx += kThreads) {
    const int r = idx / dw, w = idx % dw, n = n0 + r;
    As[r * lda + w] = n < N ? ld32(c8 + static_cast<size_t>(n) * d + 4 * w) : 0;
  }
  int acc[4][4];

  // att_out GEMM + stream join -> x1
  for (int c = 0; c < d / 64; ++c) {
    __syncthreads();
    load_rows(Ws, w_ao, c * 64, d, lda);
    __syncthreads();
    gemm_tile(As, Ws, lda, d, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rl = wr * 16 + g + 8 * (r >> 1);
        const int o = c * 64 + wc * 32 + j * 8 + 2 * t4 + (r & 1);
        const int n = n0 + rl;
        int x1 = 0;
        if (n < N) {
          const size_t e = static_cast<size_t>(n) * d + o;
          x1 = clamp8(qasr_requant(acc[j][r] + vec[o], vec[d + o], sc[0]) +
                          qasr_requant(x8[e], sc[1], sc[2]), n8);
          x1out[e] = static_cast<int8_t>(x1);
        }
        X1[rl * d + o] = static_cast<int8_t>(x1);
      }
    }
  }
  __syncthreads();

  // i-LayerNorm, one warp per row, then the ln_conv affine requant -> A8
  const int per = d / 32;
  for (int rr = 0; rr < kRows / 8; ++rr) {
    const int rl = warp * (kRows / 8) + rr;
    int xv[kMaxPer], yv[kMaxPer];
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) xv[k] = k < per ? X1[rl * d + lane + 32 * k] : 0;
    qasr_ln_row<kMaxPer>(xv, yv, per, d);
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      if (k < per) {
        const int o = lane + 32 * k;
        A8[rl * lda * 4 + o] = static_cast<int8_t>(
            clamp8(qasr_requant(vec[2 * d + o] * yv[k] + vec[3 * d + o], vec[4 * d + o],
                                sc[3]), n8));
      }
    }
  }

  // GLU: 32 columns of a and of g per chunk (rows interleaved by 16)
  for (int c = 0; c < d / 32; ++c) {
    __syncthreads();
    load_rows(Ws, w_ag, c * 64, d, lda);
    __syncthreads();
    gemm_tile(As, Ws, lda, d, acc);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rl = wr * 16 + g + 8 * (r >> 1);
        const int o = c * 32 + wc * 16 + j * 8 + 2 * t4 + (r & 1);
        const int n = n0 + rl;
        if (n >= N) continue;
        const int a8 = clamp8(qasr_requant(acc[j][r] + vec[5 * d + o], vec[6 * d + o],
                                           sc[4]), n8);
        const int gg = qasr_requant(acc[j + 2][r] + vec[7 * d + o], vec[8 * d + o], sc[5]);
        const int y = (n % T) < lens[n / T] ? a8 * qasr_i_sigmoid_grid(gg) : 0;
        glu8[static_cast<size_t>(n) * d + o] =
            static_cast<int8_t>(clamp8(qasr_requant(y, sc[6], sc[7]), n8));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
conv_block_stage_b(const int8_t* __restrict__ glu8, const int8_t* __restrict__ dw_w,
                   const int8_t* __restrict__ w_2, const int32_t* __restrict__ vec,
                   const int32_t* __restrict__ sc, int8_t* __restrict__ out, int T, int d,
                   int K, int pad_l, int n8) {
  extern __shared__ int smem[];
  const int lda = d / 4 + 4;
  const int halo = kRows + K - 1;
  int* As = smem;
  int* Ws = As + kRows * lda;
  int8_t* G = reinterpret_cast<int8_t*>(Ws + kRows * lda);   // halo x d
  int8_t* Wd = G + halo * d;                                 // K x d
  int8_t* A8 = reinterpret_cast<int8_t*>(As);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp >> 1, wc = warp & 1;
  const int b = blockIdx.y, t0 = blockIdx.x * kRows;
  const int dw = d / 4;
  const size_t base = static_cast<size_t>(b) * T * d;

  for (int idx = tid; idx < halo * dw; idx += kThreads) {
    const int r = idx / dw, w = idx % dw, t = t0 - pad_l + r;
    reinterpret_cast<int*>(G)[idx] =
        (t >= 0 && t < T) ? ld32(glu8 + base + static_cast<size_t>(t) * d + 4 * w) : 0;
  }
  for (int idx = tid; idx < K * dw; idx += kThreads)
    reinterpret_cast<int*>(Wd)[idx] = ld32(dw_w + 4 * idx);
  __syncthreads();

  // depthwise taps -> BN affine requant -> i-swish -> A8
  for (int idx = tid; idx < kRows * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    int acc = 0;
    for (int k = 0; k < K; ++k) acc += G[(r + k) * d + c] * Wd[k * d + c];
    const int bn = clamp8(qasr_requant(vec[9 * d + c] * acc + vec[10 * d + c],
                                       vec[11 * d + c], sc[8]), n8);
    const int y = bn * qasr_i_sigmoid_grid(qasr_requant(bn, sc[9], sc[10]));
    A8[r * lda * 4 + c] = static_cast<int8_t>(clamp8(qasr_requant(y, sc[11], sc[12]), n8));
  }

  // pw2 GEMM + stream join against x1 (held in out)
  int acc[4][4];
  for (int c = 0; c < d / 64; ++c) {
    __syncthreads();
    load_rows(Ws, w_2, c * 64, d, lda);
    __syncthreads();
    gemm_tile(As, Ws, lda, d, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + wr * 16 + g + 8 * (r >> 1);
        const int o = c * 64 + wc * 32 + j * 8 + 2 * t4 + (r & 1);
        if (t >= T) continue;
        const size_t e = base + static_cast<size_t>(t) * d + o;
        out[e] = static_cast<int8_t>(
            clamp8(qasr_requant(acc[j][r] + vec[12 * d + o], vec[13 * d + o], sc[13]) +
                       qasr_requant(out[e], sc[14], sc[15]),
                   n8));
      }
    }
  }
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int qasr_conv_block(const int8_t* c8, const int8_t* x8, const int32_t* lens,
                               const int8_t* w_ao, const int8_t* w_ag, const int8_t* dw_w,
                               const int8_t* w_2, const int32_t* vec, const int32_t* sc,
                               int8_t* glu8, int8_t* out, int B, int T, int d, int K,
                               int pad_l, int n8, void* stream) {
  if (d % 64 != 0 || d > 32 * kMaxPer || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t lda = d / 4 + 4;
  const size_t shm_a = 2 * kRows * lda * 4 + static_cast<size_t>(kRows) * d;
  const size_t shm_b = 2 * kRows * lda * 4 + static_cast<size_t>(kRows + 2 * K - 1) * d;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(conv_block_stage_a), shm_a);
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(conv_block_stage_b), shm_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int N = B * T;
  conv_block_stage_a<<<(N + kRows - 1) / kRows, kThreads, shm_a, s>>>(
      c8, x8, lens, w_ao, w_ag, vec, sc, glu8, out, N, T, d, n8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_block_stage_b<<<dim3((T + kRows - 1) / kRows, B), kThreads, shm_b, s>>>(
      glu8, dw_w, w_2, vec, sc, out, T, d, K, pad_l, n8);
  return static_cast<int>(cudaGetLastError());
}
