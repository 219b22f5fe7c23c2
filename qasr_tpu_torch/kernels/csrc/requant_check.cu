// Elementwise launch of the shared requant device functions (qasr_requant,
// with fast = 1 qasr_rq_make + qasr_rq, with fast = 2 qasr_rq_f64 on its
// domain), so that each can be held
// against the plain torch requant on the card (not on the serving path),
// plus the error-string helper the Python wrappers report with.
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

__global__ void requant_check_kernel(const int32_t* __restrict__ z,
                                     const int32_t* __restrict__ m,
                                     const int32_t* __restrict__ e,
                                     int32_t* __restrict__ out, int n, int fast) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (fast == 2)
    out[i] = qasr_rq_f64(z[i], qasr_rq_f64_scale(m[i], e[i]));
  else
    out[i] = fast ? qasr_rq(z[i], qasr_rq_make(m[i], e[i])) : qasr_requant(z[i], m[i], e[i]);
}

}  // namespace

extern "C" int qasr_requant_check(const int32_t* z, const int32_t* m,
                                  const int32_t* e, int32_t* out, int n, int fast,
                                  void* stream) {
  if (n > 0) {
    requant_check_kernel<<<(n + 255) / 256, 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(z, m, e, out, n, fast);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qasr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
