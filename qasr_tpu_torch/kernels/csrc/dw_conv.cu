// dw_conv: integer depthwise 1-D conv over (B, T, C), int32 accumulate,
// with an optional input-requant prologue and an optional consumer epilogue.
//
// Replaces qasr_tpu/kernels/cm_fused.py::fused_dw_win_cm (_dw_win_call),
// fused_dw_win_tm (_dw_tm_call), fused_dw_cm (_dw_call), fused_dw_win_i32
// (_dw_win_i32_call), qasr_tpu/kernels/depthwise.py::depthwise_conv_int_pallas
// (_dw_call, and _dw_pad_call under QASR_DW_INKERNEL_PAD) and
// depthwise_fused_requant (_dw_fused_call).
//
//   prologue off: xq = x (int8)
//   prologue on:  xq[b,t,c] = clamp(requant(mask_{t<in_len[b]}(relu?(x[b,t,c]
//                             + in_bias[c])), m1[c], e1), -2^(bits1-1),
//                             2^(bits1-1)-1),   x int8 or int32, m1 a (C,)
//                             vector or (NULL) the scalar m1s
//   y[b,t,c] = sum_k xq[b, t*s + k*d - pad, c] * w[k,c]    (zero padding)
//   epilogue off: out int32 = relu?(y + bias)
//   epilogue on:  out int8  = clamp(requant(mask_{t<len[b]}(relu?(y + bias)),
//                                           m[c], e), -2^(bits-1), 2^(bits-1)-1)
//
// The prologue is applied to every loaded row, halo rows included, while
// the conv's zero padding (rows before frame 0 and from t_in on) stays 0:
// the requant of a materialized producer output happens here, in shared
// memory, instead of in a separate pass over device memory.
//
// What bounds it on an H100, at the slice's largest site (B=64, T=768,
// C=512, K=75): it moves 25 MB in and 25 MB out (about 15 us of HBM time
// at 3.35 TB/s) but performs 1.9 G multiply-adds, each needing a
// shared-memory load of one int8 input tap.  It is bound by the issue rate
// of those loads and integer multiply-adds, not by bytes.
//
// Design: channels on threadIdx.x (64 per block), so every global load and
// store is coalesced along C; each block stages its 64-frame output tile
// plus the conv halo (zero-filled at the sequence edges, which is the conv
// padding) and the K x 64 taps in shared memory, reads HBM once, and keeps
// 16 output accumulators per thread in registers, looping taps outermost so
// each tap weight is loaded once per thread.  An int32 input moves 4x the
// bytes of an int8 one and each staged element costs one 64-bit product
// of the prologue's requant; halo rows are requantized once per block that
// loads them.  The TPU kernel's banded-MXU
// form (a matmul against a Toeplitz band) answered the TPU's lack of a fast
// integer vector MAC and is not carried over.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int kCB = 64;              // channels per block
constexpr int kTY = 4;               // thread rows per block
constexpr int kTT = 64;              // output frames per block
constexpr int kPer = kTT / kTY;      // output frames per thread

__global__ void __launch_bounds__(kCB * kTY)
dw_conv_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
               const int32_t* __restrict__ bias, const int32_t* __restrict__ m,
               const int32_t* __restrict__ out_len, void* __restrict__ out,
               int t_in, int c_total, int t_out, int k_size, int stride,
               int pad, int dil, int relu, int epi, int e, int lo, int hi,
               int pro, int x32, const int32_t* __restrict__ in_bias, int in_relu,
               const int32_t* __restrict__ in_len, const int32_t* __restrict__ m1,
               int m1s, int e1, int lo1, int hi1) {
  extern __shared__ int8_t smem[];
  const int rows = (kTT - 1) * stride + dil * (k_size - 1) + 1;
  int8_t* xs = smem;                 // rows x kCB input frames
  int8_t* ws = smem + rows * kCB;    // k_size x kCB taps

  const int b = blockIdx.z;
  const int c = blockIdx.y * kCB + threadIdx.x;
  const int t0 = blockIdx.x * kTT;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const bool c_ok = c < c_total;
  const int in0 = t0 * stride - pad;
  const size_t xoff = static_cast<size_t>(b) * t_in * c_total;
  const int8_t* xb = static_cast<const int8_t*>(x) + xoff;
  const int32_t* xw = static_cast<const int32_t*>(x) + xoff;

  if (!pro) {
    for (int r = ty; r < rows; r += kTY) {
      const int t = in0 + r;
      xs[r * kCB + tx] = (c_ok && t >= 0 && t < t_in)
                             ? xb[static_cast<size_t>(t) * c_total + c]
                             : static_cast<int8_t>(0);
    }
  } else {
    const int ib = (c_ok && in_bias) ? in_bias[c] : 0;
    const int m1c = (c_ok && m1) ? m1[c] : m1s;
    const int ilen = in_len ? in_len[b] : INT_MAX;
    for (int r = ty; r < rows; r += kTY) {
      const int t = in0 + r;
      int q = 0;   // the conv's zero padding stays 0
      if (c_ok && t >= 0 && t < t_in) {
        const size_t o = static_cast<size_t>(t) * c_total + c;
        int v = (x32 ? xw[o] : static_cast<int>(xb[o])) + ib;
        if (in_relu) v = v > 0 ? v : 0;
        if (t >= ilen) v = 0;
        q = qasr_clamp(qasr_requant(v, m1c, e1), lo1, hi1);
      }
      xs[r * kCB + tx] = static_cast<int8_t>(q);
    }
  }
  for (int k = ty; k < k_size; k += kTY) {
    ws[k * kCB + tx] =
        c_ok ? w[static_cast<size_t>(k) * c_total + c] : static_cast<int8_t>(0);
  }
  __syncthreads();
  if (!c_ok) return;

  int acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0;
  const int row_step = kTY * stride * kCB;
  for (int k = 0; k < k_size; ++k) {
    const int wk = ws[k * kCB + tx];
    const int8_t* xr = xs + (ty * stride + k * dil) * kCB + tx;
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] += static_cast<int>(xr[j * row_step]) * wk;
  }

  const int bc = bias ? bias[c] : 0;
  const int mc = epi ? m[c] : 0;
  const int len = out_len ? out_len[b] : INT_MAX;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int t = t0 + ty + j * kTY;
    if (t >= t_out) break;
    int v = acc[j] + bc;
    if (relu) v = v > 0 ? v : 0;
    const size_t o = (static_cast<size_t>(b) * t_out + t) * c_total + c;
    if (epi) {
      if (t >= len) v = 0;
      static_cast<int8_t*>(out)[o] =
          static_cast<int8_t>(qasr_clamp(qasr_requant(v, mc, e), lo, hi));
    } else {
      static_cast<int32_t*>(out)[o] = v;
    }
  }
}

}  // namespace

extern "C" int qasr_dw_conv(const void* x, const int8_t* w,
                            const int32_t* bias, const int32_t* m,
                            const int32_t* out_len, void* out, int batch,
                            int t_in, int c_total, int t_out, int k_size,
                            int stride, int pad, int dil, int relu, int epi,
                            int e, int lo, int hi, int pro, int x32,
                            const int32_t* in_bias, int in_relu,
                            const int32_t* in_len, const int32_t* m1, int m1s,
                            int e1, int lo1, int hi1, void* stream) {
  const int rows = (kTT - 1) * stride + dil * (k_size - 1) + 1;
  const size_t shm = static_cast<size_t>(rows + k_size) * kCB;
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dw_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shm));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((t_out + kTT - 1) / kTT, (c_total + kCB - 1) / kCB, batch);
  const dim3 block(kCB, kTY);
  dw_conv_kernel<<<grid, block, shm, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, m, out_len, out, t_in, c_total, t_out, k_size, stride, pad,
      dil, relu, epi, e, lo, hi, pro, x32, in_bias, in_relu, in_len, m1, m1s,
      e1, lo1, hi1);
  return static_cast<int>(cudaGetLastError());
}
