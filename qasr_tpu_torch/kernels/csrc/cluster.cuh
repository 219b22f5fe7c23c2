// Thread-block cluster helpers shared by Kernel 9's rnnt_greedy
// (rnnt_decoder.cu) and Kernel 4's cache form (conv_block_cached.cu): the
// cluster barrier's arrive and wait, a bulk copy from global memory into
// the CTA's shared memory counted on an mbarrier, a store into another
// CTA's shared memory counted on its mbarrier, and the launch
// configuration of a 1-D grid of clusters for cudaLaunchKernelEx.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "gemm_s8.cuh"

// barrier.cluster in two halves: every thread of every CTA of the cluster
// arrives, then waits for the phase; release / acquire order the shared
// memory writes (local and distributed) made before the arrive against the
// reads after the wait.  A thread alternates arrive and wait.
__device__ __forceinline__ void qasr_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

// an arrive that orders no memory operation (an mbarrier's init has its
// own release fence, gemm_s8::fence_barrier_init)
__device__ __forceinline__ void qasr_cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void qasr_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void qasr_cluster_sync() {
  qasr_cluster_arrive();
  qasr_cluster_wait();
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into this CTA's shared memory, completing that many bytes of the
// transaction count of `bar` (the caller has set it with expect_tx)
__device__ __forceinline__ void qasr_bulk_load(void* dst, const void* src, unsigned bytes,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :
      : "r"(gemm_s8::smem_u32(dst)), "l"(src), "r"(bytes), "r"(gemm_s8::smem_u32(bar))
      : "memory");
}

// The address, in CTA `rank`'s shared memory, of this CTA's shared-memory
// address `a` (both 32-bit shared::cluster / shared::cta addresses)
__device__ __forceinline__ uint32_t qasr_mapa(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// 16 bytes into another CTA's shared memory at `remote` (qasr_mapa),
// completing 16 bytes of the transaction count of its mbarrier at
// `remote_bar`; the receiver waits on that mbarrier, and no cluster
// barrier or fence orders the store
__device__ __forceinline__ void qasr_st_async16(uint32_t remote, const int4& v,
                                                uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(remote), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(remote_bar)
      : "memory");
}

// The launch of `blocks` CTAs of `threads` threads in clusters of `cluster`
// CTAs along x, with `smem` bytes of dynamic shared memory each; `attr`
// holds the cluster attribute and must outlive the launch call.
inline cudaLaunchConfig_t qasr_cluster_launch_config(int blocks, int threads, int cluster,
                                                     int smem, void* stream,
                                                     cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}
