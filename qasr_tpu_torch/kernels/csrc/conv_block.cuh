// Tile helpers of Kernel 4 (conv_block.cu: the offline form and the cache
// form's staged plan; conv_block_cached.cu: the cache form's cluster
// kernel): the 32-row tile, the 64-column weight chunk, the int8 clamp and
// the tile's m16n8k32 product from ldmatrix fragments.
#pragma once

#include <cstdint>

#include "requant.cuh"
#include "tile_s8.cuh"

namespace {

constexpr int kRows = 32;         // rows (stage A, the cluster form) or frames (stage B) per tile
constexpr int kChunk = 64;        // weight rows (output columns) per chunk
constexpr int kMaxPer = 16;       // d <= 512: values per lane in the i-LN

__device__ __forceinline__ int clamp8(int q, int n8) { return qasr_clamp(q, -n8, n8 - 1); }

// acc = As (32 x d) . Ws^T (64 x d) for warp `warp`'s 16 x 32 part (warps 0-3):
// accumulator (j, r) is row 16 wr + g + 8 (r >> 1), column 32 wc + 8 j + 2 t4 + (r & 1)
__device__ __forceinline__ void gemm_tile(const int* As, const int* Ws, int lda, int d,
                                          int (&acc)[4][4], int warp = threadIdx.x >> 5) {
  const int lane = threadIdx.x & 31;
  const int wr = warp >> 1, wc = warp & 1, q = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0;
  // matrix q of A: rows 8 (q & 1), bytes 16 (q >> 1); of B: columns 8 (q >> 1), bytes 16 (q & 1)
  const int* a_row = As + (wr * 16 + rr + 8 * (q & 1)) * lda + 4 * (q >> 1);
  const int* b_row = Ws + (wc * 32 + rr + 8 * (q >> 1)) * lda + 4 * (q & 1);
  for (int kw = 0; kw < d / 4; kw += 8) {
    int a[4];
    qasr_ldsm4(a, a_row + kw);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      int b[4];
      qasr_ldsm4(b, b_row + p * 16 * lda + kw);
      qasr_mma_s8(acc[2 * p], a, b[0], b[1]);
      qasr_mma_s8(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace
