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
// projection (4864 -> 256) moves 61 MB against 15 G multiply-adds.  The
// int32 accumulator never reaches device memory.
//
// Design (gemm_s8.cuh's mainloop): 64 x 128 output tiles, one consumer
// warpgroup and one producer warp per block (376 blocks at N = 12,000 and
// D = 256, three or four resident on each of the 132 SMs); x and the
// weights both stream by TMA through a ring of up to 3 stages of 128 bytes
// of K (38 chunks at K = 4,864), rows past N and columns past D zero-filled
// on load and masked on store; products by wgmma m64n128k32 s8 x s8 -> s32,
// exact.  K must be a multiple of 16 (the TMA row pitch).  The swish mode's
// chain after the clamp depends on the int8 a8 alone, so each block
// tabulates it over a8's 2 n8 values (the same device functions) and looks
// it up.  The int32 accumulators are staged in shared memory (the drained
// ring) and the epilogue reads them back 8 columns a thread in a rolled
// loop, with 8-byte reads of stream8 and 8-byte stores of the output.  The
// epilogue's dyadic requants (a 64-bit product each) are most of the
// instructions; several resident blocks keep them in flight.  The wrapper's
// kernels/lin_epilogue.py::plan computes the same tiles and shared memory.
#include <cstdint>

#include <cuda_runtime.h>

#include "conformer_int.cuh"
#include "gemm_s8.cuh"
#include "requant.cuh"

namespace {

using gemm_s8::kChunk;

constexpr int kBM = 64;            // rows (n) per block: one consumer warpgroup
constexpr int kBN = 128;           // columns (o) per block
constexpr int kMaxStages = 3;
constexpr int kThreads = 128 + 32;  // the consumer warpgroup and the producer warp
constexpr int kRq = 0, kJoin = 1, kSwish = 2;

struct LinParams {
  const int32_t* bias;
  const int32_t* m;
  const int8_t* stream8;
  int8_t* out;
  int n_rows, k, d, mode, e, m2, e2, m3, e3, n8;
  int nk, stages;
};

// A block's shared memory from the 1024-aligned base: the ring (each stage
// a 64-row x chunk, then a 128-row weight chunk), which the int32 staging
// tile reuses once the products are done, the swish table, the mbarriers
// (full[S], empty[S]).
struct LinLayout {
  int ring, stage_bytes, ld, swish, bars, bytes;
  __host__ __device__ explicit LinLayout(int stages) {
    stage_bytes = (kBM + kBN) * kChunk;
    ring = 0;
    ld = gemm_s8::stage_ld(kBN);
    const int ring_bytes = stages * stage_bytes, staging = kBM * ld;
    swish = ring + (ring_bytes > staging ? ring_bytes : staging);
    bars = swish + 256;
    bytes = bars + 8 * 2 * stages + gemm_s8::kAlign;  // + the base's alignment slack
  }
};

__global__ void __launch_bounds__(kThreads, 3)
lin_epilogue_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w, const LinParams p) {
  using namespace gemm_s8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const LinLayout L(p.stages);
  uint8_t* ring = smem + L.ring;
  uint8_t* stage = ring;  // after the mainloop
  int8_t* swish = reinterpret_cast<int8_t*>(smem + L.swish);  // swish mode: by a8 + 128
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + p.stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBM, o0 = blockIdx.y * kBN;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if (lane == 0) {
      for (int kc = 0; kc < p.nk; ++kc) {
        const int s = kc % p.stages;
        uint8_t* st = ring + s * L.stage_bytes;
        mbar_wait(empty + s, ((kc / p.stages) & 1) ^ 1);
        mbar_expect_tx(full + s, L.stage_bytes);
        tma_load_2d(st, &map_x, full + s, kc * kChunk, n0);
        tma_load_2d(st + kBM * kChunk, &map_w, full + s, kc * kChunk, o0);
      }
    }
    return;
  }

  // the consumer warpgroup
  if (p.mode == kSwish) {
    for (int v = tid; v < 256; v += 128) {
      const int a8 = qasr_clamp(v - 128, -p.n8, p.n8 - 1);
      const int y = a8 * qasr_i_sigmoid_grid(qasr_requant(a8, p.m2, p.e2));
      swish[v] = static_cast<int8_t>(qasr_clamp(qasr_requant(y, p.m3, p.e3), -p.n8, p.n8 - 1));
    }
  }
  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  for (int kc = 0; kc < p.nk; ++kc) {
    const int s = kc % p.stages;
    const uint8_t* st = ring + s * L.stage_bytes;
    mbar_wait(full + s, (kc / p.stages) & 1);
    mma_chunk<kBN>(acc, st, st + kBM * kChunk);
    if (lane == 0) mbar_arrive(empty + s);
  }
  bar_sync(1, 128);  // every warp's products are done: the ring is free for staging
  stage_acc<kBN>(acc, stage, warp, lane);
  bar_sync(1, 128);  // the staging tile and the swish table are complete

  // rows r of the tile, 8 columns (group g) a thread, per-column operands once
  constexpr int kG = kBN / 8, kStep = 128 / kG;
  const int g = tid % kG, o = o0 + 8 * g, nv = min(8, p.d - o);
  const int rows = min(kBM, p.n_rows - n0);
  if (nv <= 0) return;
  int bq[8], mq[8];
  gload8(p.bias ? p.bias + o : nullptr, p.bias ? nv : 0, bq);
  gload8(p.m + o, nv, mq);
  int a[8], y[8];
#pragma unroll 1
  for (int r = tid / kG; r < rows; r += kStep) {
    const size_t idx = static_cast<size_t>(n0 + r) * p.d + o;
    int sv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (p.mode == kJoin) {
      const int8_t* sp = p.stream8 + idx;
      if (nv == 8 && (reinterpret_cast<uintptr_t>(sp) & 7) == 0) {
        const uint2 u = *reinterpret_cast<const uint2*>(sp);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sv[q] = static_cast<int8_t>(u.x >> (8 * q));
          sv[q + 4] = static_cast<int8_t>(u.y >> (8 * q));
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) sv[q] = q < nv ? sp[q] : 0;
      }
    }
    load8(stage, L.ld, r, g, a);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      y[q] = qasr_clamp(qasr_requant(a[q] + bq[q], mq[q], p.e) +
                            (p.mode == kJoin ? qasr_requant(sv[q], p.m2, p.e2) : 0),
                        -p.n8, p.n8 - 1);
      if (p.mode == kSwish) y[q] = swish[y[q] + 128];
    }
    store8_s8(p.out + idx, nv, y);
  }
}

}  // namespace

extern "C" int qasr_lin_epilogue(const int8_t* x, const int8_t* wt, const int32_t* bias,
                                 const int32_t* m, const int8_t* stream8, int8_t* out,
                                 int n_rows, int k, int d, int mode, int e, int m2, int e2,
                                 int m3, int e3, int n8, void* stream) {
  // the tile plan (kernels/lin_epilogue.py::plan computes the same)
  const int nk = (k + kChunk - 1) / kChunk;
  const int stages = nk < kMaxStages ? nk : kMaxStages;
  const int smem = LinLayout(stages).bytes;
  if (n_rows < 1 || d < 1 || k < 16 || k % 16 != 0 || mode < kRq || mode > kSwish ||
      (mode == kJoin && stream8 == nullptr) || smem > gemm_s8::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      lin_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gemm_s8::kSmemLimit);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap mx{}, mw{};
  if (!gemm_s8::make_map(&mx, x, n_rows, k, kBM) || !gemm_s8::make_map(&mw, wt, d, k, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const LinParams p{bias, m, stream8, out, n_rows, k, d, mode, e, m2, e2, m3, e3, n8, nk, stages};
  const dim3 grid((n_rows + kBM - 1) / kBM, (d + kBN - 1) / kBN);
  lin_epilogue_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(mx, mw, p);
  return static_cast<int>(cudaGetLastError());
}
