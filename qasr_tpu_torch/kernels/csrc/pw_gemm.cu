// pw_gemm: pointwise (1x1) int8 conv as a GEMM, int32 accumulate, with an
// optional input-requant prologue and one of three epilogues.
//
// Replaces qasr_tpu/kernels/cm_fused.py::fused_pw_cm (_pw3_call),
// fused_pw_join_cm (_pw3_join_call) and qasr_tpu/kernels/pw_matmul.py::
// requant_pointwise_matmul (_call).
//
//   prologue off: a = x int8
//   prologue on:  a[n,i] = clamp(requant(mask_{n%T < in_len[n/T]}(relu?(x[n,i]
//                          + in_bias[i])), m1[i], e1), -2^(bits1-1),
//                          2^(bits1-1)-1),   x int8 or int32, m1 a (Cin,)
//                          vector or (NULL) the scalar m1s
//   acc[n,o] = sum_i a[n,i] * wt[o,i]     x (N=B*T, Cin), wt (Cout, Cin) int8
//   mode 0 (none):    out int32 = relu?(acc + bias)
//   mode 1 (requant): out int8  = clamp(requant(mask_{n%T < len[n/T]}(
//                                       relu?(acc + bias)), m[o], e))
//   mode 2 (join):    out int8  = clamp(requant(acc + bias, m[o], e)
//                                       + requant(res[n,o], m_r[o], e_r))
//   clamp is [-2^(bits-1), 2^(bits-1)-1].
//
// What bounds it on an H100, at the slice's largest sites (N = 64*768 =
// 49152 rows, Cin = Cout = 512): 12.9 G multiply-adds against 25 MB in and
// 25 MB out (100 MB more for the int32 residual of a join).  At about 500
// operations per byte it is bound by arithmetic, so the products go to the
// tensor cores.
//
// Design (simple first): 64x64 output tiles per 128-thread block, four
// warps of 32x32; K staged through shared memory 32 bytes at a time (rows
// padded to 12 words so fragment loads hit distinct banks); products by
// mma.sync m16n8k32 s8 x s8 -> s32, exact.  The prologue requantizes each
// A tile to int8 while it is staged (an int32 input is read 16 bytes at a
// time), so only int8 reaches the fragments; every column block of a row
// repeats that work (Cout / 64 times).  The epilogue runs on the
// accumulators in registers, so the int32 sum never reaches device memory
// in the requant and join modes.  No cp.async pipelining, TMA or wgmma yet.
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int kBM = 64;          // rows (n) per block
constexpr int kBN = 64;          // columns (o) per block
constexpr int kK4 = 8;           // 32-bit words of K per stage (32 int8)
constexpr int kLd = kK4 + 4;     // padded shared-memory row, in words
constexpr int kThreads = 128;    // 4 warps, 2 x 2, each 32 x 32

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The prologue on one 4-channel word of row n: four int8 values packed.
__device__ __forceinline__ int prologue_word(const void* x, int x32, size_t n, int cin,
                                             int kq, const int32_t* in_bias, int in_relu,
                                             const int32_t* m1, int m1s, int e1, int lo1,
                                             int hi1) {
  int v[4];
  if (x32) {
    const int4 q = reinterpret_cast<const int4*>(static_cast<const int32_t*>(x) +
                                                 n * cin)[kq];
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const int w = reinterpret_cast<const int*>(static_cast<const int8_t*>(x) + n * cin)[kq];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = static_cast<int8_t>(w >> (8 * q));
  }
  int word = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = 4 * kq + q;
    int z = v[q] + (in_bias ? in_bias[c] : 0);
    if (in_relu) z = z > 0 ? z : 0;
    const int r = qasr_clamp(qasr_requant(z, m1 ? m1[c] : m1s, e1), lo1, hi1);
    word |= (r & 0xff) << (8 * q);
  }
  return word;
}

__global__ void __launch_bounds__(kThreads)
pw_gemm_kernel(const void* __restrict__ x, const int8_t* __restrict__ wt,
               const int32_t* __restrict__ bias, const int32_t* __restrict__ m,
               const int32_t* __restrict__ lens,
               const int32_t* __restrict__ res, const int32_t* __restrict__ m_r,
               void* __restrict__ out, int n_rows, int cin, int cout,
               int rows_per_batch, int mode, int relu, int e, int e_r, int lo,
               int hi, int pro, int x32, const int32_t* __restrict__ in_bias,
               int in_relu, const int32_t* __restrict__ in_len,
               const int32_t* __restrict__ m1, int m1s, int e1, int lo1, int hi1) {
  __shared__ int as[kBM][kLd];
  __shared__ int bs[kBN][kLd];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;          // mma fragment coordinates
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int n0 = blockIdx.x * kBM, o0 = blockIdx.y * kBN;
  const int cin4 = cin / 4;
  const int* x4 = static_cast<const int*>(x);
  const int* w4 = reinterpret_cast<const int*>(wt);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int kk = 0; kk < cin4; kk += kK4) {
#pragma unroll
    for (int idx = tid; idx < kBM * kK4; idx += kThreads) {
      const int r = idx / kK4, k = idx % kK4;
      const int kq = kk + k;
      const int n = n0 + r, o = o0 + r;
      int aw = 0;
      if (n < n_rows && kq < cin4) {
        if (!pro)
          aw = x4[static_cast<size_t>(n) * cin4 + kq];
        else if (in_len == nullptr || (n % rows_per_batch) < in_len[n / rows_per_batch])
          aw = prologue_word(x, x32, n, cin, kq, in_bias, in_relu, m1, m1s, e1, lo1, hi1);
      }
      as[r][k] = aw;
      bs[r][k] = (o < cout && kq < cin4) ? w4[static_cast<size_t>(o) * cin4 + kq] : 0;
    }
    __syncthreads();
    int a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm + 16 * i + g;
      a[i][0] = as[r][t];
      a[i][1] = as[r + 8][t];
      a[i][2] = as[r][t + 4];
      a[i][3] = as[r + 8][t + 4];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn + 8 * j + g;
      const int b0 = bs[c][t], b1 = bs[c][t + 4];
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b0, b1);
    }
    __syncthreads();
  }

  // accumulator (i, j, r) holds row wm + 16i + g + 8*(r >= 2),
  // column wn + 8j + 2t + (r & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wm + 16 * i + g + 8 * h;
      if (n >= n_rows) continue;
      const bool row_ok =
          lens == nullptr || (n % rows_per_batch) < lens[n / rows_per_batch];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int o = o0 + wn + 8 * j + 2 * t + q;
          if (o >= cout) continue;
          const size_t idx = static_cast<size_t>(n) * cout + o;
          int v = acc[i][j][2 * h + q] + (bias ? bias[o] : 0);
          if (mode == 2) {
            const int s = qasr_requant(v, m[o], e) + qasr_requant(res[idx], m_r[o], e_r);
            static_cast<int8_t*>(out)[idx] = static_cast<int8_t>(qasr_clamp(s, lo, hi));
            continue;
          }
          if (relu) v = v > 0 ? v : 0;
          if (mode == 0) {
            static_cast<int32_t*>(out)[idx] = v;
          } else {
            if (!row_ok) v = 0;
            static_cast<int8_t*>(out)[idx] =
                static_cast<int8_t>(qasr_clamp(qasr_requant(v, m[o], e), lo, hi));
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int qasr_pw_gemm(const void* x, const int8_t* wt,
                            const int32_t* bias, const int32_t* m,
                            const int32_t* lens, const int32_t* res,
                            const int32_t* m_r, void* out, int n_rows, int cin,
                            int cout, int rows_per_batch, int mode, int relu,
                            int e, int e_r, int lo, int hi, int pro, int x32,
                            const int32_t* in_bias, int in_relu,
                            const int32_t* in_len, const int32_t* m1, int m1s,
                            int e1, int lo1, int hi1, void* stream) {
  const dim3 grid((n_rows + kBM - 1) / kBM, (cout + kBN - 1) / kBN);
  pw_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, wt, bias, m, lens, res, m_r, out, n_rows, cin, cout, rows_per_batch,
      mode, relu, e, e_r, lo, hi, pro, x32, in_bias, in_relu, in_len, m1, m1s, e1,
      lo1, hi1);
  return static_cast<int>(cudaGetLastError());
}
