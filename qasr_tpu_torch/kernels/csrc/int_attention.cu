// int_attention: integer relative-position attention core of the frozen
// Conformer, (B, T, h, d_k) int8 in, (B, T, h * d_k) int8 context out.
//
// Replaces qasr_tpu/kernels/int_attention.py::fused_int_attention
// (pl.pallas_call at int_attention.py:170).  Per query row i and key j:
//
//   ac  = qu[i] . k[j]                       bd = qv[i] . pos[T-1+i-j]
//   qg  = requant(ac, ac_m, ac_e) + requant(bd, bd_m, bd_e)      (S_IN grid)
//   masked (i or j >= len, or outside [-right, left]) -> -(1 << 30)
//   a8  = i-softmax over j (integer max, i_exp, >> 4, rounding division)
//   out = clamp(requant(sum_j a8 * v[j], ctx_m, ctx_e), -n, n - 1)
//
// What bounds it on an H100, at the flagship shape (B=32, h=4, T=375,
// d_k=64): it must read 4 x 3.1 MB of q/k/v plus the pos table and write
// 3.1 MB (about 5 us of HBM time at 3.35 TB/s), and do 3 products of
// 32 x 4 x 375 x 375 x 64 multiply-adds (about 3.5 G int8 operations,
// under 2 us of tensor-core time); the integer softmax's elementwise work
// (about 20 integer operations per score, 18 M scores) is the largest
// part of the arithmetic and runs on the CUDA cores.
//
// Design (simple first): one 256-thread block per (batch, head, 32-query
// tile).  Keys come in chunks of 64: content scores by mma.sync m16n8k32
// s8 against the K chunk, and the Toeplitz diagonal of qv . pos as a
// 32 x 96 product against the 95 pos rows the chunk needs (pos row
// T-1+i-j lands at window column (i - i0) - (j - j0) + 63), gathered in
// shared memory (chunk_scores).  Two forms share that step:
//   resident (T up to about 1,300 frames): the tile's full int32 score
//     rows live in shared memory, so the (T, T) scores never reach device
//     memory; one warp per row then runs the integer softmax, and the int8
//     probabilities multiply the V chunks (transposed into shared memory)
//     on the tensor cores;
//   streaming (any T): three passes over the key chunks, each recomputing
//     the chunk's scores on the tensor cores: pass 1 takes the row maxima,
//     pass 2 sums i_exp of the shifted scores, pass 3 forms the int8
//     probabilities with the same rounding division and multiplies them
//     into V.  Shared memory no longer grows with T; the price is three
//     score products instead of one and i_exp twice.
// The wrapper picks the resident form whenever its rows fit.  Both compute
// the canonical integer softmax of ops/integer_softmax.py: masked scores
// are -2^30 before the row max, a fully masked row has denominator 1.  The
// epilogue requants and writes straight into the (B, T, h * d_k) layout.
// No cp.async pipelining, no wgmma yet.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "conformer_int.cuh"
#include "requant.cuh"

namespace {

constexpr int kTQ = 32;           // query rows per block
constexpr int kKC = 64;           // keys per chunk
constexpr int kPW = kTQ + kKC;    // pos rows per chunk window (95 used)
constexpr int kThreads = 256;     // 8 warps
constexpr int kVtw = kKC / 4 + 4; // transposed V chunk row, in words
constexpr int kBdw = kPW + 1;     // bd row of the chunk, in words
constexpr int kScw = kKC + 4;     // one chunk's score row (streaming), in words
constexpr int kPcw = kKC / 4 + 4; // one chunk's int8 probability row, in words

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int ld32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

// A fragment (16 x 32 int8, row-major) from a word-addressed smem tile
__device__ __forceinline__ void load_a(int (&a)[4], const int* s, int ld, int row, int kw,
                                       int t4) {
  a[0] = s[row * ld + kw + t4];
  a[1] = s[(row + 8) * ld + kw + t4];
  a[2] = s[row * ld + kw + t4 + 4];
  a[3] = s[(row + 8) * ld + kw + t4 + 4];
}

// Masked grid scores of query tile i0 against key chunk j0, written to
// dst[il * ld + col0 + jl] for il < 32, jl < 64.  Qu/Qv hold the tile, Ks
// the chunk's keys, Ps its pos window; the caller synchronises before
// (loads) and after (readers of dst).
template <int kDKP>
__device__ __forceinline__ void chunk_scores(const int* Qu, const int* Qv, const int* Ks,
                                             const int* Ps, int* BD, int* dst, int ld,
                                             int col0, int i0, int j0, int len, int left,
                                             int right, int ac_m, int ac_e, int bd_m,
                                             int bd_e) {
  constexpr int kDkw = kDKP / 4 + 4;
  constexpr int kKs = kDKP / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;   // 2 x 4 warps
  int acc[2][4] = {}, accb[3][4] = {};
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
    int a[4];
    load_a(a, Qu, kDkw, wr * 16 + g, ks * 8, t4);
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      const int c = wc * 16 + jt * 8 + g;
      mma_s8(acc[jt], a, Ks[c * kDkw + ks * 8 + t4], Ks[c * kDkw + ks * 8 + t4 + 4]);
    }
    load_a(a, Qv, kDkw, wr * 16 + g, ks * 8, t4);
#pragma unroll
    for (int jt = 0; jt < 3; ++jt) {
      const int c = wc * 24 + jt * 8 + g;
      mma_s8(accb[jt], a, Ps[c * kDkw + ks * 8 + t4], Ps[c * kDkw + ks * 8 + t4 + 4]);
    }
  }
  // accumulator (jt, r): row 16 wr + g + 8 (r >> 1), column 8 jt + 2 t4 + (r & 1)
#pragma unroll
  for (int jt = 0; jt < 3; ++jt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      BD[(wr * 16 + g + 8 * (r >> 1)) * kBdw + wc * 24 + jt * 8 + 2 * t4 + (r & 1)] =
          accb[jt][r];
  __syncthreads();
#pragma unroll
  for (int jt = 0; jt < 2; ++jt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = wr * 16 + g + 8 * (r >> 1);
      const int jl = wc * 16 + jt * 8 + 2 * t4 + (r & 1);
      const int i = i0 + il, j = j0 + jl;
      const bool masked = i >= len || j >= len || (left >= 0 && i - j > left) ||
                          (right >= 0 && j - i > right);
      const int bd = BD[il * kBdw + il - jl + kKC - 1];
      dst[il * ld + col0 + jl] = masked ? kMasked
                                        : qasr_requant(acc[jt][r], ac_m, ac_e) +
                                              qasr_requant(bd, bd_m, bd_e);
    }
  }
}

// The query tile's qu / qv rows into shared memory (zero past T and d_k).
template <int kDKP>
__device__ __forceinline__ void load_queries(int* Qu, int* Qv, const int8_t* qu,
                                             const int8_t* qv, size_t off, size_t rs,
                                             int i0, int T, int dk4) {
  constexpr int kDkw = kDKP / 4 + 4;
  for (int idx = threadIdx.x; idx < kTQ * (kDKP / 4); idx += kThreads) {
    const int r = idx / (kDKP / 4), w = idx % (kDKP / 4), i = i0 + r;
    const bool ok = i < T && w < dk4;
    Qu[r * kDkw + w] = ok ? ld32(qu + off + i * rs + 4 * w) : 0;
    Qv[r * kDkw + w] = ok ? ld32(qv + off + i * rs + 4 * w) : 0;
  }
}

// Key chunk j0 and its 96-row pos window into shared memory.
template <int kDKP>
__device__ __forceinline__ void load_keys(int* Ks, int* Ps, const int8_t* k,
                                          const int8_t* pos_h, size_t off, size_t rs,
                                          int i0, int j0, int T, int dk4) {
  constexpr int kDkw = kDKP / 4 + 4;
  for (int idx = threadIdx.x; idx < kKC * (kDKP / 4); idx += kThreads) {
    const int r = idx / (kDKP / 4), w = idx % (kDKP / 4), j = j0 + r;
    Ks[r * kDkw + w] = (j < T && w < dk4) ? ld32(k + off + j * rs + 4 * w) : 0;
  }
  const int pbase = T - 1 + i0 - j0 - (kKC - 1);
  for (int idx = threadIdx.x; idx < kPW * (kDKP / 4); idx += kThreads) {
    const int r = idx / (kDKP / 4), w = idx % (kDKP / 4), p = pbase + r;
    Ps[r * kDkw + w] =
        (p >= 0 && p < 2 * T - 1 && w < dk4) ? ld32(pos_h + p * rs + 4 * w) : 0;
  }
}

// V chunk j0, transposed to (d, key) int8 rows of kVtw words.
template <int kDKP>
__device__ __forceinline__ void load_values_t(int* Vt, const int8_t* v, size_t off,
                                              size_t rs, int j0, int T, int dk4) {
  int8_t* vt8 = reinterpret_cast<int8_t*>(Vt);
  for (int idx = threadIdx.x; idx < kKC * (kDKP / 4); idx += kThreads) {
    const int r = idx / (kDKP / 4), w = idx % (kDKP / 4), j = j0 + r;
    const int val = (j < T && w < dk4) ? ld32(v + off + j * rs + 4 * w) : 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      vt8[(4 * w + q) * (kVtw * 4) + r] = static_cast<int8_t>(val >> (8 * q));
  }
}

// accc += P (32 x 64 int8, rows of ldp words from word column pc0) x V chunk
template <int kDKP>
__device__ __forceinline__ void prob_times_v(int (&accc)[kDKP / 32][4], const int* P,
                                             int ldp, int pc0, const int* Vt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp >> 2, wc = warp & 3;
#pragma unroll
  for (int ks = 0; ks < kKC / 32; ++ks) {
    int a[4];
    load_a(a, P, ldp, wr * 16 + g, pc0 + ks * 8, t4);
#pragma unroll
    for (int nt = 0; nt < kDKP / 32; ++nt) {
      const int c = wc * (kDKP / 4) + nt * 8 + g;
      mma_s8(accc[nt], a, Vt[c * kVtw + ks * 8 + t4], Vt[c * kVtw + ks * 8 + t4 + 4]);
    }
  }
}

// out = clamp(requant(accc, ctx_m, ctx_e)) into the (B, T, h * d_k) layout
template <int kDKP>
__device__ __forceinline__ void store_context(const int (&accc)[kDKP / 32][4], int8_t* out,
                                              size_t off, size_t rs, int i0, int T, int DK,
                                              int ctx_m, int ctx_e, int n8) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp >> 2, wc = warp & 3;
#pragma unroll
  for (int nt = 0; nt < kDKP / 32; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + wr * 16 + g + 8 * (r >> 1);
      const int dd = wc * (kDKP / 4) + nt * 8 + 2 * t4 + (r & 1);
      if (i < T && dd < DK)
        out[off + i * rs + dd] =
            static_cast<int8_t>(qasr_clamp(qasr_requant(accc[nt][r], ctx_m, ctx_e), -n8,
                                           n8 - 1));
    }
  }
}

template <int kDKP>
__global__ void __launch_bounds__(kThreads)
int_attention_kernel(const int8_t* __restrict__ qu, const int8_t* __restrict__ qv,
                     const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                     const int8_t* __restrict__ pos, const int32_t* __restrict__ lens,
                     int8_t* __restrict__ out, int T, int H, int DK, int Tp, int ac_m,
                     int ac_e, int bd_m, int bd_e, int ctx_m, int ctx_e, int left,
                     int right, int n8) {
  constexpr int kDkw = kDKP / 4 + 4;       // padded q/k/pos row, in words
  extern __shared__ int smem[];
  const int sld = Tp + 8, paw = Tp / 4 + 4;
  int* Qu = smem;
  int* Qv = Qu + kTQ * kDkw;
  int* Ks = Qv + kTQ * kDkw;
  int* Ps = Ks + kKC * kDkw;
  int* Vt = Ps + kPW * kDkw;
  int* BD = Vt + kDKP * kVtw;
  int* S = BD + kTQ * kBdw;
  int* Pa = S + kTQ * sld;

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kTQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lens[b];
  const int dk4 = DK / 4;
  const size_t rs = static_cast<size_t>(H) * DK;   // bytes per time step
  const size_t off = static_cast<size_t>(b) * T * rs + static_cast<size_t>(h) * DK;
  const int8_t* pos_h = pos + static_cast<size_t>(h) * DK;

  load_queries<kDKP>(Qu, Qv, qu, qv, off, rs, i0, T, dk4);
  // ---- scores, one chunk of 64 keys at a time --------------------------
  for (int j0 = 0; j0 < Tp; j0 += kKC) {
    load_keys<kDKP>(Ks, Ps, k, pos_h, off, rs, i0, j0, T, dk4);
    __syncthreads();
    chunk_scores<kDKP>(Qu, Qv, Ks, Ps, BD, S, sld, j0, i0, j0, len, left, right, ac_m,
                       ac_e, bd_m, bd_e);
    __syncthreads();
  }

  // ---- integer softmax, one warp per row --------------------------------
  for (int rr = 0; rr < kTQ / 8; ++rr) {
    const int il = warp * (kTQ / 8) + rr;
    int* srow = S + il * sld;
    int m = INT_MIN;
    for (int j = lane; j < T; j += 32) m = max(m, srow[j]);
    m = qasr_warp_max(m);
    int sum = 0;
    for (int j = lane; j < T; j += 32) {
      const int s = srow[j];
      const int q = max(s - m, -kNIn);
      const int e = s == kMasked ? 0 : (qasr_i_exp(q) >> kPreshift);
      srow[j] = e;
      sum += e;
    }
    const int den = max(qasr_warp_sum(sum), 1);
    int8_t* prow = reinterpret_cast<int8_t*>(Pa + il * paw);
    for (int j = lane; j < Tp; j += 32)
      prow[j] = static_cast<int8_t>(j < T ? (srow[j] * n8 + (den >> 1)) / den : 0);
  }

  // ---- context: probabilities x V, chunk by chunk -------------------------
  int accc[kDKP / 32][4] = {};
  for (int j0 = 0; j0 < Tp; j0 += kKC) {
    __syncthreads();
    load_values_t<kDKP>(Vt, v, off, rs, j0, T, dk4);
    __syncthreads();
    prob_times_v<kDKP>(accc, Pa, paw, j0 / 4, Vt);
  }
  store_context<kDKP>(accc, out, off, rs, i0, T, DK, ctx_m, ctx_e, n8);
}

// The streaming form: three passes over the key chunks (see the note at
// the top); shared memory independent of T.
template <int kDKP>
__global__ void __launch_bounds__(kThreads)
int_attention_stream_kernel(const int8_t* __restrict__ qu, const int8_t* __restrict__ qv,
                            const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                            const int8_t* __restrict__ pos,
                            const int32_t* __restrict__ lens, int8_t* __restrict__ out,
                            int T, int H, int DK, int Tp, int ac_m, int ac_e, int bd_m,
                            int bd_e, int ctx_m, int ctx_e, int left, int right, int n8) {
  constexpr int kDkw = kDKP / 4 + 4;
  extern __shared__ int smem[];
  int* Qu = smem;
  int* Qv = Qu + kTQ * kDkw;
  int* Ks = Qv + kTQ * kDkw;
  int* Ps = Ks + kKC * kDkw;
  int* Vt = Ps + kPW * kDkw;
  int* BD = Vt + kDKP * kVtw;
  int* Sc = BD + kTQ * kBdw;       // the chunk's scores
  int* Pc = Sc + kTQ * kScw;       // the chunk's int8 probabilities
  int* rmax = Pc + kTQ * kPcw;     // per row: max over all keys
  int* rden = rmax + kTQ;          // per row: sum of i_exp >> 4

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kTQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lens[b];
  const int dk4 = DK / 4;
  const size_t rs = static_cast<size_t>(H) * DK;
  const size_t off = static_cast<size_t>(b) * T * rs + static_cast<size_t>(h) * DK;
  const int8_t* pos_h = pos + static_cast<size_t>(h) * DK;

  load_queries<kDKP>(Qu, Qv, qu, qv, off, rs, i0, T, dk4);
  if (tid < kTQ) {
    rmax[tid] = INT_MIN;
    rden[tid] = 0;
  }
  int accc[kDKP / 32][4] = {};
  for (int pass = 0; pass < 3; ++pass) {
    for (int j0 = 0; j0 < Tp; j0 += kKC) {
      __syncthreads();   // the last chunk's readers are done with every buffer
      load_keys<kDKP>(Ks, Ps, k, pos_h, off, rs, i0, j0, T, dk4);
      if (pass == 2) load_values_t<kDKP>(Vt, v, off, rs, j0, T, dk4);
      __syncthreads();
      chunk_scores<kDKP>(Qu, Qv, Ks, Ps, BD, Sc, kScw, 0, i0, j0, len, left, right, ac_m,
                         ac_e, bd_m, bd_e);
      __syncthreads();
      for (int rr = 0; rr < kTQ / 8; ++rr) {
        const int il = warp * (kTQ / 8) + rr;
        const int* srow = Sc + il * kScw;
        if (pass == 0) {
          int m = INT_MIN;
          for (int jl = lane; jl < kKC; jl += 32)
            if (j0 + jl < T) m = max(m, srow[jl]);
          m = qasr_warp_max(m);
          if (lane == 0) rmax[il] = max(rmax[il], m);
          continue;
        }
        const int m = rmax[il];
        const int den = pass == 2 ? max(rden[il], 1) : 1;   // final after pass 1
        int sum = 0;
        int8_t* prow = reinterpret_cast<int8_t*>(Pc + il * kPcw);
        for (int jl = lane; jl < kKC; jl += 32) {
          int e = 0;
          if (j0 + jl < T) {
            const int s = srow[jl];
            e = s == kMasked ? 0 : (qasr_i_exp(max(s - m, -kNIn)) >> kPreshift);
          }
          if (pass == 1)
            sum += e;
          else
            prow[jl] = static_cast<int8_t>(j0 + jl < T ? (e * n8 + (den >> 1)) / den : 0);
        }
        if (pass == 1) {
          sum = qasr_warp_sum(sum);
          if (lane == 0) rden[il] += sum;
        }
      }
      if (pass == 2) {
        __syncthreads();
        prob_times_v<kDKP>(accc, Pc, kPcw, 0, Vt);
      }
    }
  }
  store_context<kDKP>(accc, out, off, rs, i0, T, DK, ctx_m, ctx_e, n8);
}

template <int kDKP>
int launch(const int8_t* qu, const int8_t* qv, const int8_t* k, const int8_t* v,
           const int8_t* pos, const int32_t* lens, int8_t* out, int B, int T, int H,
           int DK, int ac_m, int ac_e, int bd_m, int bd_e, int ctx_m, int ctx_e, int left,
           int right, int n8, int streaming, cudaStream_t stream) {
  const int Tp = (T + kKC - 1) / kKC * kKC;
  size_t words = static_cast<size_t>(2 * kTQ + kKC + kPW) * (kDKP / 4 + 4) +
                 static_cast<size_t>(kDKP) * kVtw + kTQ * kBdw;
  words += streaming ? kTQ * (kScw + kPcw + 2)
                     : static_cast<size_t>(kTQ) * (Tp + 8) +
                           static_cast<size_t>(kTQ) * (Tp / 4 + 4);
  const size_t shm = 4 * words;
  auto* kernel = streaming ? int_attention_stream_kernel<kDKP> : int_attention_kernel<kDKP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shm));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTQ - 1) / kTQ, H, B);
  kernel<<<grid, kThreads, shm, stream>>>(qu, qv, k, v, pos, lens, out, T, H, DK, Tp, ac_m,
                                          ac_e, bd_m, bd_e, ctx_m, ctx_e, left, right, n8);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qasr_int_attention(const int8_t* qu, const int8_t* qv, const int8_t* k,
                                  const int8_t* v, const int8_t* pos, const int32_t* lens,
                                  int8_t* out, int B, int T, int H, int DK, int ac_m,
                                  int ac_e, int bd_m, int bd_e, int ctx_m, int ctx_e,
                                  int left, int right, int n8, int streaming,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((DK + 31) / 32) {
    case 1:
      return launch<32>(qu, qv, k, v, pos, lens, out, B, T, H, DK, ac_m, ac_e, bd_m, bd_e,
                        ctx_m, ctx_e, left, right, n8, streaming, s);
    case 2:
      return launch<64>(qu, qv, k, v, pos, lens, out, B, T, H, DK, ac_m, ac_e, bd_m, bd_e,
                        ctx_m, ctx_e, left, right, n8, streaming, s);
    case 3:
      return launch<96>(qu, qv, k, v, pos, lens, out, B, T, H, DK, ac_m, ac_e, bd_m, bd_e,
                        ctx_m, ctx_e, left, right, n8, streaming, s);
    case 4:
      return launch<128>(qu, qv, k, v, pos, lens, out, B, T, H, DK, ac_m, ac_e, bd_m,
                         bd_e, ctx_m, ctx_e, left, right, n8, streaming, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
