// Elementwise and row-wise launches of the integer device functions in
// conformer_int.cuh, so that each can be held against its plain torch
// version over its whole domain on the card (not on the serving path).
#include <cstdint>

#include <cuda_runtime.h>

#include "conformer_int.cuh"

namespace {

// op 0: i_exp(a); 1: i_sigmoid_grid(a); 2: isqrt(a); 3: floor_div(a, b);
// 4: qasr_i_sigmoid_tab over the kSigTab-byte table at b; 5: qasr_div(a, b)
// with the divisor's constants made per element; 6: qasr_isqrt_f(a);
// 7: qasr_i_exp_pre(-a) (i_exp(a) >> 4 from the table)
__global__ void int_fn_check_kernel(int op, const int32_t* __restrict__ a,
                                    const int32_t* __restrict__ b, int32_t* __restrict__ out,
                                    int n) {
  __shared__ int exp_tab[kExpTab];
  for (int r = threadIdx.x; r < kExpTab; r += blockDim.x) exp_tab[r] = qasr_exp_quad(r);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  switch (op) {
    case 0: out[i] = qasr_i_exp(a[i]); break;
    case 1: out[i] = qasr_i_sigmoid_grid(a[i]); break;
    case 2: out[i] = qasr_isqrt(a[i]); break;
    case 4: out[i] = qasr_i_sigmoid_tab(reinterpret_cast<const uint8_t*>(b), a[i]); break;
    case 5:
      out[i] = static_cast<int>(qasr_div(static_cast<unsigned>(a[i]),
                                         qasr_div_make(static_cast<unsigned>(b[i]))));
      break;
    case 6: out[i] = qasr_isqrt_f(a[i]); break;
    case 7: out[i] = qasr_i_exp_pre(-a[i], exp_tab); break;
    default: out[i] = qasr_floor_div(a[i], b[i]); break;
  }
}

constexpr int kMaxPer = 16;

// i_layernorm_core of each row of x (rows, d), one warp per row, by
// qasr_ln_row or (div) qasr_ln_row_div
__global__ void ln_check_kernel(const int8_t* __restrict__ x, int32_t* __restrict__ out,
                                int rows, int d, int div) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31, per = d / 32;
  if (row >= rows) return;
  int xv[kMaxPer], yv[kMaxPer];
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k)
    xv[k] = k < per ? x[static_cast<size_t>(row) * d + lane + 32 * k] : 0;
  if (div)
    qasr_ln_row_div<kMaxPer>(xv, yv, per, d, qasr_div_make(static_cast<unsigned>(d)));
  else
    qasr_ln_row<kMaxPer>(xv, yv, per, d);
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k)
    if (k < per) out[static_cast<size_t>(row) * d + lane + 32 * k] = yv[k];
}

}  // namespace

extern "C" int qasr_int_fn_check(int op, const int32_t* a, const int32_t* b, int32_t* out,
                                 int n, void* stream) {
  if (n > 0) {
    int_fn_check_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        op, a, b, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qasr_ln_check(const int8_t* x, int32_t* out, int rows, int d, int div,
                             void* stream) {
  if (d % 32 != 0 || d > 32 * kMaxPer) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    ln_check_kernel<<<(rows + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        x, out, rows, d, div);
  }
  return static_cast<int>(cudaGetLastError());
}
