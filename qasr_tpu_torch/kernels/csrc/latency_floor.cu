// The latency floor of a launch: an empty kernel on a given grid, block,
// cluster and dynamic shared memory.  chip_smoke.py times it beside the
// cache forms of Kernels 3 and 4 on their own launch shapes; a measurement
// launch, on no serving path, replacing no TPU kernel.
#include <cuda_runtime.h>

#include "cluster.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

// grid (gx, gy, gz) of `threads`-thread blocks in clusters of `cluster`
// along x (gx a multiple of it), `smem` bytes of dynamic shared memory each
extern "C" int qasr_empty_launch(int gx, int gy, int gz, int threads, int cluster, int smem,
                                 void* stream) {
  if (gx < 1 || gy < 1 || gz < 1 || threads < 1 || cluster < 1 || gx % cluster != 0 ||
      smem < 0 || smem > gemm_s8::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(empty_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t lc = qasr_cluster_launch_config(gx, threads, cluster, smem, stream, &attr);
  lc.gridDim = dim3(gx, gy, gz);
  err = cudaLaunchKernelEx(&lc, empty_kernel);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
