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
// tile).  The tile's full score rows live in shared memory as int32, so
// the (T, T) scores never reach device memory.  Keys come in chunks of
// 64: content scores by mma.sync m16n8k32 s8 against the K chunk, and the
// Toeplitz diagonal of qv . pos as a 32 x 96 product against the 95 pos
// rows the chunk needs (pos row T-1+i-j lands at window column
// (i - i0) - (j - j0) + 63), gathered in shared memory.  One warp per row
// then runs the integer softmax; the int8 probabilities multiply the V
// chunks (transposed into shared memory) on the tensor cores; the epilogue
// requants and writes straight into the (B, T, h * d_k) layout.  No
// cp.async pipelining, no wgmma, no online softmax yet; T is bounded by
// the score rows' shared memory (about 1,300 frames).
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

template <int kDKP>
__global__ void __launch_bounds__(kThreads)
int_attention_kernel(const int8_t* __restrict__ qu, const int8_t* __restrict__ qv,
                     const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                     const int8_t* __restrict__ pos, const int32_t* __restrict__ lens,
                     int8_t* __restrict__ out, int T, int H, int DK, int Tp, int ac_m,
                     int ac_e, int bd_m, int bd_e, int ctx_m, int ctx_e, int left,
                     int right, int n8) {
  constexpr int kDkw = kDKP / 4 + 4;       // padded q/k/pos row, in words
  constexpr int kKs = kDKP / 32;           // k-steps of a d_k product
  constexpr int kNt = kDKP / 32;           // 8-column tiles per warp (context)
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
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;   // 2 x 4 warps
  const int len = lens[b];
  const int dk4 = DK / 4;
  const size_t rs = static_cast<size_t>(H) * DK;   // bytes per time step
  const size_t off = static_cast<size_t>(b) * T * rs + static_cast<size_t>(h) * DK;
  const int8_t* pos_h = pos + static_cast<size_t>(h) * DK;

  for (int idx = tid; idx < kTQ * (kDKP / 4); idx += kThreads) {
    const int r = idx / (kDKP / 4), w = idx % (kDKP / 4), i = i0 + r;
    const bool ok = i < T && w < dk4;
    Qu[r * kDkw + w] = ok ? ld32(qu + off + i * rs + 4 * w) : 0;
    Qv[r * kDkw + w] = ok ? ld32(qv + off + i * rs + 4 * w) : 0;
  }

  // ---- scores, one chunk of 64 keys at a time --------------------------
  for (int j0 = 0; j0 < Tp; j0 += kKC) {
    for (int idx = tid; idx < kKC * (kDKP / 4); idx += kThreads) {
      const int r = idx / (kDKP / 4), w = idx % (kDKP / 4), j = j0 + r;
      Ks[r * kDkw + w] = (j < T && w < dk4) ? ld32(k + off + j * rs + 4 * w) : 0;
    }
    const int pbase = T - 1 + i0 - j0 - (kKC - 1);
    for (int idx = tid; idx < kPW * (kDKP / 4); idx += kThreads) {
      const int r = idx / (kDKP / 4), w = idx % (kDKP / 4), p = pbase + r;
      Ps[r * kDkw + w] =
          (p >= 0 && p < 2 * T - 1 && w < dk4) ? ld32(pos_h + p * rs + 4 * w) : 0;
    }
    __syncthreads();

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
        S[il * sld + j] = masked ? kMasked
                                 : qasr_requant(acc[jt][r], ac_m, ac_e) +
                                       qasr_requant(bd, bd_m, bd_e);
      }
    }
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
  int accc[kNt][4] = {};
  int8_t* vt8 = reinterpret_cast<int8_t*>(Vt);
  for (int j0 = 0; j0 < Tp; j0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kKC * (kDKP / 4); idx += kThreads) {
      const int r = idx / (kDKP / 4), w = idx % (kDKP / 4), j = j0 + r;
      const int val = (j < T && w < dk4) ? ld32(v + off + j * rs + 4 * w) : 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        vt8[(4 * w + q) * (kVtw * 4) + r] = static_cast<int8_t>(val >> (8 * q));
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKC / 32; ++ks) {
      int a[4];
      load_a(a, Pa, paw, wr * 16 + g, j0 / 4 + ks * 8, t4);
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int c = wc * (kDKP / 4) + nt * 8 + g;
        mma_s8(accc[nt], a, Vt[c * kVtw + ks * 8 + t4], Vt[c * kVtw + ks * 8 + t4 + 4]);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
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
int launch(const int8_t* qu, const int8_t* qv, const int8_t* k, const int8_t* v,
           const int8_t* pos, const int32_t* lens, int8_t* out, int B, int T, int H,
           int DK, int ac_m, int ac_e, int bd_m, int bd_e, int ctx_m, int ctx_e, int left,
           int right, int n8, cudaStream_t stream) {
  const int Tp = (T + kKC - 1) / kKC * kKC;
  const size_t words = static_cast<size_t>(2 * kTQ + kKC + kPW) * (kDKP / 4 + 4) +
                       static_cast<size_t>(kDKP) * kVtw + kTQ * kBdw +
                       static_cast<size_t>(kTQ) * (Tp + 8) +
                       static_cast<size_t>(kTQ) * (Tp / 4 + 4);
  const size_t shm = 4 * words;
  cudaError_t err = cudaFuncSetAttribute(int_attention_kernel<kDKP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shm));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTQ - 1) / kTQ, H, B);
  int_attention_kernel<kDKP><<<grid, kThreads, shm, stream>>>(
      qu, qv, k, v, pos, lens, out, T, H, DK, Tp, ac_m, ac_e, bd_m, bd_e, ctx_m, ctx_e,
      left, right, n8);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qasr_int_attention(const int8_t* qu, const int8_t* qv, const int8_t* k,
                                  const int8_t* v, const int8_t* pos, const int32_t* lens,
                                  int8_t* out, int B, int T, int H, int DK, int ac_m,
                                  int ac_e, int bd_m, int bd_e, int ctx_m, int ctx_e,
                                  int left, int right, int n8, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((DK + 31) / 32) {
    case 1:
      return launch<32>(qu, qv, k, v, pos, lens, out, B, T, H, DK, ac_m, ac_e, bd_m, bd_e,
                        ctx_m, ctx_e, left, right, n8, s);
    case 2:
      return launch<64>(qu, qv, k, v, pos, lens, out, B, T, H, DK, ac_m, ac_e, bd_m, bd_e,
                        ctx_m, ctx_e, left, right, n8, s);
    case 3:
      return launch<96>(qu, qv, k, v, pos, lens, out, B, T, H, DK, ac_m, ac_e, bd_m, bd_e,
                        ctx_m, ctx_e, left, right, n8, s);
    case 4:
      return launch<128>(qu, qv, k, v, pos, lens, out, B, T, H, DK, ac_m, ac_e, bd_m,
                         bd_e, ctx_m, ctx_e, left, right, n8, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
