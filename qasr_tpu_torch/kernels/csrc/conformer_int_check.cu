// Elementwise and row-wise launches of the integer device functions in
// conformer_int.cuh, so that each can be held against its plain torch
// version over its whole domain on the card (not on the serving path).
#include <cstdint>

#include <cuda_runtime.h>

#include "conformer_int.cuh"

namespace {

// op 0: i_exp(a); 1: i_sigmoid_grid(a); 2: isqrt(a); 3: floor_div(a, b)
__global__ void int_fn_check_kernel(int op, const int32_t* __restrict__ a,
                                    const int32_t* __restrict__ b, int32_t* __restrict__ out,
                                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  switch (op) {
    case 0: out[i] = qasr_i_exp(a[i]); break;
    case 1: out[i] = qasr_i_sigmoid_grid(a[i]); break;
    case 2: out[i] = qasr_isqrt(a[i]); break;
    default: out[i] = qasr_floor_div(a[i], b[i]); break;
  }
}

constexpr int kMaxPer = 16;

// i_layernorm_core of each row of x (rows, d), one warp per row
__global__ void ln_check_kernel(const int8_t* __restrict__ x, int32_t* __restrict__ out,
                                int rows, int d) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31, per = d / 32;
  if (row >= rows) return;
  int xv[kMaxPer], yv[kMaxPer];
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k)
    xv[k] = k < per ? x[static_cast<size_t>(row) * d + lane + 32 * k] : 0;
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

extern "C" int qasr_ln_check(const int8_t* x, int32_t* out, int rows, int d, void* stream) {
  if (d % 32 != 0 || d > 32 * kMaxPer) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    ln_check_kernel<<<(rows + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        x, out, rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}
