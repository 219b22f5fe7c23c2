// lin_epilogue: an int8 linear of the frozen Conformer with one of three
// integer epilogues, (N, K) int8 in, (N, D) int8 out.
//
// Replaces qasr_tpu/kernels/gemm_fused.py::fused_lin_rq, fused_lin_join and
// fused_lin_swish (pl.pallas_call at gemm_fused.py:159), bit for bit with
// the XLA compositions _lin_rq / _join_lin / _ffn_mid of
// qasr_tpu/quantize/conformer_freeze.py:
//
//   acc[n,o] = sum_k x[n,k] * wt[o,k] (+ bias[o] when given)
//   mode 0 (rq):    out = clamp(rq(acc, m[o], e))
//   mode 1 (join):  out = clamp(rq(acc, m[o], e) + rq(stream8[n,o], m2, e2))
//   mode 2 (swish): a8  = clamp(rq(acc, m[o], e))
//                   out = clamp(rq(a8 * i_sigmoid(rq(a8, m2, e2)), m3, e3))
//   clamp is [-n8, n8 - 1]; m is per channel, (m2, e2) and (m3, e3) scalars.
//
// What bounds it on an H100, at the path's sites (N = B*T = 12,000 rows):
// the (256 -> 256) projections move 6.1 MB (x, out, weights) for 0.79 G
// multiply-adds, so bytes bound them (~1.8 us at 3.35 TB/s); the pre
// projection (5120 -> 256) moves 64 MB against 15.7 G multiply-adds.  The
// int32 accumulator never reaches device memory: the epilogue runs on it in
// registers.
//
// Design (simple first, as pw_gemm.cu): 64x64 output tiles per 128-thread
// block, four warps of 32x32; K staged through shared memory 128 bytes at a
// time with 16-byte loads (rows padded to 36 words so fragment loads hit
// distinct banks); products by mma.sync m16n8k32 s8 x s8 -> s32, exact.
// K must be a multiple of 16; rows past N and columns past D are masked.
// The swish mode's chain after the clamp depends on the int8 a8 alone, so
// each block tabulates it over a8's 2 n8 values (the same device
// functions) and looks it up.  No cp.async pipelining, TMA or wgmma yet.
#include <cstdint>

#include <cuda_runtime.h>

#include "conformer_int.cuh"
#include "requant.cuh"

namespace {

constexpr int kBM = 64;          // rows (n) per block
constexpr int kBN = 64;          // columns (o) per block
constexpr int kKC = 32;          // 32-bit words of K per stage (128 int8)
constexpr int kLd = kKC + 4;     // padded shared-memory row, in words
constexpr int kThreads = 128;    // 4 warps, 2 x 2, each 32 x 32
constexpr int kRq = 0, kJoin = 1, kSwish = 2;

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
lin_epilogue_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                    const int32_t* __restrict__ bias, const int32_t* __restrict__ m,
                    const int8_t* __restrict__ stream8, int8_t* __restrict__ out, int n_rows,
                    int k, int d, int mode, int e, int m2, int e2, int m3, int e3, int n8) {
  __shared__ int4 as4[kBM * kLd / 4];
  __shared__ int4 bs4[kBN * kLd / 4];
  __shared__ int8_t swish[256];                    // swish mode: by a8 + 128
  int* as = reinterpret_cast<int*>(as4);
  int* bs = reinterpret_cast<int*>(bs4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;          // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int n0 = blockIdx.x * kBM, o0 = blockIdx.y * kBN;
  const int k4 = k / 4;                            // words per row
  if (mode == kSwish) {                            // visible after the first stage's sync
    for (int v = tid; v < 256; v += kThreads) {
      const int a8 = qasr_clamp(v - 128, -n8, n8 - 1);
      const int y = a8 * qasr_i_sigmoid_grid(qasr_requant(a8, m2, e2));
      swish[v] = static_cast<int8_t>(qasr_clamp(qasr_requant(y, m3, e3), -n8, n8 - 1));
    }
  }

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int kk = 0; kk < k4; kk += kKC) {
    for (int idx = tid; idx < kBM * (kKC / 4); idx += kThreads) {
      const int r = idx / (kKC / 4), q = idx % (kKC / 4);
      const int kw = kk + 4 * q;
      const int n = n0 + r, o = o0 + r;
      int4 va = make_int4(0, 0, 0, 0), vb = make_int4(0, 0, 0, 0);
      if (kw < k4) {
        if (n < n_rows)
          va = *reinterpret_cast<const int4*>(x + static_cast<size_t>(n) * k + 4 * kw);
        if (o < d)
          vb = *reinterpret_cast<const int4*>(wt + static_cast<size_t>(o) * k + 4 * kw);
      }
      as4[(r * kLd) / 4 + q] = va;
      bs4[(r * kLd) / 4 + q] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 8) {
      if (kk + ks < k4) {                          // uniform across the block
        int a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wm + 16 * i + g;
          a[i][0] = as[r * kLd + ks + t4];
          a[i][1] = as[(r + 8) * kLd + ks + t4];
          a[i][2] = as[r * kLd + ks + t4 + 4];
          a[i][3] = as[(r + 8) * kLd + ks + t4 + 4];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = wn + 8 * j + g;
          const int b0 = bs[c * kLd + ks + t4], b1 = bs[c * kLd + ks + t4 + 4];
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b0, b1);
        }
      }
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int o = o0 + wn + 8 * j + 2 * t4 + q;
          if (o >= d) continue;
          const size_t idx = static_cast<size_t>(n) * d + o;
          const int z = acc[i][j][2 * h + q] + (bias != nullptr ? bias[o] : 0);
          int y = qasr_clamp(qasr_requant(z, m[o], e) +
                                 (mode == kJoin ? qasr_requant(stream8[idx], m2, e2) : 0),
                             -n8, n8 - 1);
          if (mode == kSwish) y = swish[y + 128];
          out[idx] = static_cast<int8_t>(y);
        }
      }
    }
  }
}

}  // namespace

extern "C" int qasr_lin_epilogue(const int8_t* x, const int8_t* wt, const int32_t* bias,
                                 const int32_t* m, const int8_t* stream8, int8_t* out,
                                 int n_rows, int k, int d, int mode, int e, int m2, int e2,
                                 int m3, int e3, int n8, void* stream) {
  if (k % 16 != 0 || mode < kRq || mode > kSwish || (mode == kJoin && stream8 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_rows + kBM - 1) / kBM, (d + kBN - 1) / kBN);
  lin_epilogue_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, wt, bias, m, stream8, out, n_rows, k, d, mode, e, m2, e2, m3, e3, n8);
  return static_cast<int>(cudaGetLastError());
}
