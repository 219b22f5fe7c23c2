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
// under 2 us of tensor-core time).  What the card spends is integer work
// on the CUDA cores, per score (18 M of them): two requants, the mask, the
// row max, i_exp, the row sum and the rounding division.  The design cuts
// that work:
//  - both score requants are folded once a block: on the FP64 pipe
//    (qasr_rq_f64: an fma that rounds half to even) when every int8 dot
//    product's requant stays in its domain, as the flagship's grids do,
//    else qasr_rq;
//  - the mask is tested only in chunks that cross len, T or the [-right,
//    left] band (score_epilogue<.., true, ..>); a full-context run masks
//    only the last key chunk of each row and the last query tile;
//  - the row max is gathered as the scores are written (a shuffle over the
//    4 lanes of a row, then a shared-memory atomicMax a row), so the
//    resident form has no separate max pass; the integer i_exp still needs
//    the true max before any exponent, so max -> (exp, sum) -> divide stays
//    (online rescaling is not exact here);
//  - i_exp >> 4 is a lookup in a 568-entry table of its quadratic and a
//    shift (qasr_i_exp_pre), the table made once a block;
//  - the division by the row sum is a multiply-high and two shifts: one
//    Granlund-Montgomery divisor a row (qasr_div, conformer_int.cuh; lane r
//    of a warp makes row r's, so one 64-bit division serves the warp's
//    rows), exact because the numerator e * n + den / 2 < 2^31 (e <=
//    i_exp(0) >> 4 = 116,970, n <= 127, den < 2^31 while the int32 row sum
//    holds);
//  - K chunks and pos windows come in by cp.async (16 bytes when d_k is a
//    multiple of 16, else 4) into a double buffer, so chunk j+1 loads while
//    chunk j multiplies; V chunks are loaded into registers one chunk ahead
//    and transposed with byte_perm on 4 x 4 byte blocks.
//
// Blocks: one 256-thread block (8 warps) per (batch, head, kTQ-query tile).
// Keys come in chunks of 64: content scores by mma.sync m16n8k32 s8
// against the K chunk, and the Toeplitz diagonal of qv . pos as a kTQ x
// (kTQ + 64) product against the pos rows the chunk needs (pos row
// T-1+i-j lands at window column (i - i0) - (j - j0) + 63).  Two forms:
//   resident (T up to 1,152 frames at d_k 64): the tile's full int32
//     score rows live in shared memory; one warp per row then runs the
//     softmax, and the int8 probabilities multiply the V chunks;
//   streaming (any T): three passes over the key chunks, each recomputing
//     the chunk's scores: pass 1 gathers the row maxima, pass 2 sums i_exp
//     of the shifted scores, pass 3 forms the probabilities and multiplies
//     them into V.  Shared memory does not grow with T.
// kTQ is 32: 8 warps as 2 row x 4 column groups, 106 KB at T=375, so 2
// blocks an SM, and the streaming form held to 128 registers for 2 as
// well.  64 query rows a block (4 x 2 warps) let the same chunk loads serve
// twice the queries, but the score rows then take 200 KB, 1 block an SM,
// and the kernel ran slower (PERF.md, Kernel 3).
//
// The cache form (int_attention_cached_kernel) serves the stream step of a
// causal Conformer (att_context (L, 0)), which the JAX package runs as an
// XLA composition over [cache || new] (qasr_tpu/quantize/conformer_freeze.py:
// 803-824): n new queries, keys and values the L cached rows then the n
// new ones, the (L + 1)-row pos table of relative offsets 0..L.  Query i
// sees slot j at r = L + i - j in [0, L] (pos row r), masked where the
// slot holds no frame yet (j < L - seen); the slot j = L + i never is.
// The work is small (at L = 70, n = 4: 71 scores a query row, 4 rows an
// utterance and head), so what bounds it is latency: one block a (batch,
// head, 16 queries) with a warp a query (min(n, 16) warps) issues every
// staging copy at once as cp.async (the queries, the pos rows, the L + 16
// key rows its queries reach and the i_exp table, built once on the host;
// then the value rows, a second group); rows are padded to a multiple of
// 16 bytes plus 16, so a quarter warp's 16-byte reads of 8 rows hit
// distinct banks.  A warp takes a query row: a lane its scores (dp4a over
// 16-byte words), then the row's integer softmax (warp max, i_exp from
// the table, warp sum, rounding division) into int8 probabilities, while
// the values land; then the context: a lane a dim, dp4a of 4
// probabilities against 4 slots of V transposed in shared memory (a word
// realigned by the row's offset with a funnel shift).  The new caches
// (the last L rows of [cache || new]) are written from the staged rows by
// the tiles that staged them.  A block a batch with a warp a (head, query)
// would stage 256-byte rows; not built.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "conformer_int.cuh"
#include "requant.cuh"
#include "tile_s8.cuh"

namespace {

constexpr int kKC = 64;           // keys per chunk
constexpr int kThreads = 256;     // 8 warps
constexpr int kVtw = kKC / 4 + 4; // transposed V chunk row, in words
constexpr int kScw = kKC + 4;     // one chunk's score row (streaming), in words
constexpr int kPcw = kKC / 4 + 4; // one chunk's int8 probability row, in words

constexpr int kTQ = 32;             // query rows per block
constexpr int kCG = 8 / (kTQ / 16); // column groups of warps
constexpr int kPW = kTQ + kKC;      // pos rows per window (kPW - 1 used)
constexpr int kBdw = kPW + 1;       // bd row of the chunk, in words
constexpr int kNA = kKC / kCG / 8;  // content n-tiles a warp
constexpr int kNB = kPW / kCG / 8;  // bd n-tiles a warp

// A fragment (16 x 32 int8, row-major) from a word-addressed smem tile
__device__ __forceinline__ void load_a(int (&a)[4], const int* s, int ld, int row, int kw,
                                       int t4) {
  a[0] = s[row * ld + kw + t4];
  a[1] = s[(row + 8) * ld + kw + t4];
  a[2] = s[row * ld + kw + t4 + 4];
  a[3] = s[(row + 8) * ld + kw + t4 + 4];
}

// rows r0 + r (r < nrows) of a (rows, rs bytes) int8 table -> smem rows of
// kDKP / 4 + 4 words, by cp.async; rows outside [0, hi) and words from dk4
// on are zero-filled.  v16: 16-byte copies (d_k a multiple of 16).
template <int kDKP>
__device__ __forceinline__ void stage_rows(int* dst, const int8_t* src, size_t rs, int r0,
                                           int nrows, int hi, int dk4, bool v16) {
  constexpr int kDkw = kDKP / 4 + 4;
  // thread t copies piece t % kP of rows t / kP, t / kP + kThreads / kP, ...
  if (v16) {
    constexpr int kP = kDKP / 16;
    const int pc = threadIdx.x % kP;
    if (threadIdx.x >= kThreads / kP * kP) return;
    const bool wok = 4 * pc < dk4;
    for (int r = threadIdx.x / kP; r < nrows; r += kThreads / kP) {
      const int row = r0 + r;
      const bool ok = wok && row >= 0 && row < hi;
      qasr_cp16(dst + r * kDkw + 4 * pc, ok ? src + row * rs + 16 * pc : src, ok ? 16 : 0);
    }
  } else {
    constexpr int kW = kDKP / 4;
    const int w = threadIdx.x % kW;
    if (threadIdx.x >= kThreads / kW * kW) return;
    const bool wok = w < dk4;
    for (int r = threadIdx.x / kW; r < nrows; r += kThreads / kW) {
      const int row = r0 + r;
      const bool ok = wok && row >= 0 && row < hi;
      qasr_cp4(dst + r * kDkw + w, ok ? src + row * rs + 4 * w : src, ok ? 4 : 0);
    }
  }
}

// key chunk j0 and its pos window, into one buffer of each (the caller commits)
template <int kDKP>
__device__ __forceinline__ void stage_chunk(int* Ks, int* Ps, const int8_t* k,
                                            const int8_t* pos_h, size_t rs, int i0, int j0,
                                            int T, int dk4, bool v16) {
  stage_rows<kDKP>(Ks, k, rs, j0, kKC, T, dk4, v16);
  stage_rows<kDKP>(Ps, pos_h, rs, T - 1 + i0 - j0 - (kKC - 1), kPW, 2 * T - 1, dk4,
                   v16);
}

// the two score requants, folded once a block; f64 when both fit
// qasr_rq_f64's domain for every |z| <= d_k 2^14 (int8 dot products)
struct ScoreRq {
  QasrRq ac, bd;
  double f_ac, f_bd;
  bool f64;
};

__device__ __forceinline__ bool fits_f64(long long zmax, int m, int e) {
  return e >= 1 && e <= 62 && m >= 0 && (e + 26 >= 63 || zmax * m < (1ll << (e + 26)));
}

__device__ __forceinline__ ScoreRq score_rq(int ac_m, int ac_e, int bd_m, int bd_e, int dkp) {
  ScoreRq r;
  r.ac = qasr_rq_make(ac_m, ac_e);
  r.bd = qasr_rq_make(bd_m, bd_e);
  r.f_ac = qasr_rq_f64_scale(ac_m, ac_e);
  r.f_bd = qasr_rq_f64_scale(bd_m, bd_e);
  const long long zmax = static_cast<long long>(dkp) << 14;
  r.f64 = fits_f64(zmax, ac_m, ac_e) && fits_f64(zmax, bd_m, bd_e);
  return r;
}

// the epilogue of chunk_scores: grid scores (masked where kMask) to dst,
// and each row's maximum gathered into rmax (when not null)
template <bool kMask, bool kF64>
__device__ __forceinline__ void score_epilogue(const int (&acc)[kNA][4],
                                               const int* BD, int* dst, int ld, int col0,
                                               int i0, int j0, int len, int left, int right,
                                               const ScoreRq& rq, int* rmax) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp / kCG, wc = warp % kCG;
  int mx[2] = {INT_MIN, INT_MIN};
#pragma unroll
  for (int jt = 0; jt < kNA; ++jt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = wr * 16 + g + 8 * (r >> 1);
      const int jl = wc * (kKC / kCG) + jt * 8 + 2 * t4 + (r & 1);
      const int bd = BD[il * kBdw + il - jl + kKC - 1];
      int s = kF64 ? qasr_rq_f64(acc[jt][r], rq.f_ac) + qasr_rq_f64(bd, rq.f_bd)
                   : qasr_rq(acc[jt][r], rq.ac) + qasr_rq(bd, rq.bd);
      if (kMask) {
        const int i = i0 + il, j = j0 + jl;
        if (i >= len || j >= len || (left >= 0 && i - j > left) || (right >= 0 && j - i > right))
          s = kMasked;
      }
      dst[il * ld + col0 + jl] = s;
      mx[r >> 1] = max(mx[r >> 1], s);
    }
  }
  if (rmax != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = max(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t4 == 0) atomicMax(rmax + wr * 16 + g + 8 * h, v);
    }
  }
}

// Grid scores of query tile i0 against key chunk j0, written to
// dst[il * ld + col0 + jl] for il < kTQ, jl < 64.  Qu/Qv hold the tile, Ks
// the chunk's keys, Ps its pos window; the caller synchronises before
// (loads) and after (readers of dst and rmax).  (A bd block per warp, the
// 16 + 16 - 1 window columns its own scores read, spares the barrier
// below but multiplies a third more: measured slower at 32 query rows.)
template <int kDKP>
__device__ __forceinline__ void chunk_scores(const int* Qu, const int* Qv, const int* Ks,
                                             const int* Ps, int* BD, int* dst, int ld,
                                             int col0, int i0, int j0, int len, int left,
                                             int right, const ScoreRq& rq, int* rmax) {
  constexpr int kDkw = kDKP / 4 + 4;
  constexpr int kKs = kDKP / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp / kCG, wc = warp % kCG;
  int acc[kNA][4] = {}, accb[kNB][4] = {};
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
    int a[4];
    load_a(a, Qu, kDkw, wr * 16 + g, ks * 8, t4);
#pragma unroll
    for (int jt = 0; jt < kNA; ++jt) {
      const int c = wc * (kKC / kCG) + jt * 8 + g;
      qasr_mma_s8(acc[jt], a, Ks[c * kDkw + ks * 8 + t4], Ks[c * kDkw + ks * 8 + t4 + 4]);
    }
    load_a(a, Qv, kDkw, wr * 16 + g, ks * 8, t4);
#pragma unroll
    for (int jt = 0; jt < kNB; ++jt) {
      const int c = wc * (kPW / kCG) + jt * 8 + g;
      qasr_mma_s8(accb[jt], a, Ps[c * kDkw + ks * 8 + t4], Ps[c * kDkw + ks * 8 + t4 + 4]);
    }
  }
  // accumulator (jt, r): row 16 wr + g + 8 (r >> 1), column 8 jt + 2 t4 + (r & 1)
#pragma unroll
  for (int jt = 0; jt < kNB; ++jt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      BD[(wr * 16 + g + 8 * (r >> 1)) * kBdw + wc * (kPW / kCG) + jt * 8 + 2 * t4 +
         (r & 1)] = accb[jt][r];
  __syncthreads();
  const bool clean = j0 + kKC <= len && i0 + kTQ <= len &&
                     (left < 0 || i0 + kTQ - 1 - j0 <= left) &&
                     (right < 0 || j0 + kKC - 1 - i0 <= right);
  if (rq.f64) {
    if (clean)
      score_epilogue<false, true>(acc, BD, dst, ld, col0, i0, j0, len, left, right, rq, rmax);
    else
      score_epilogue<true, true>(acc, BD, dst, ld, col0, i0, j0, len, left, right, rq, rmax);
  } else {
    if (clean)
      score_epilogue<false, false>(acc, BD, dst, ld, col0, i0, j0, len, left, right, rq,
                                        rmax);
    else
      score_epilogue<true, false>(acc, BD, dst, ld, col0, i0, j0, len, left, right, rq,
                                       rmax);
  }
}

// V chunk j0 as 4 x 4 byte blocks (4 keys x 4 dims), one or two a thread,
// held in registers between the load and the transposed store
template <int kDKP>
struct VBlocks {
  static constexpr int kN = (16 * (kDKP / 4) + kThreads - 1) / kThreads;
  unsigned a[kN][4];
};

// block idx -> (key quad kq, word w): a warp reads 8 rows x 16 bytes and
// its stores fall on distinct banks but for pairs
__device__ __forceinline__ void vblock_at(int idx, int& kq, int& w) {
  const int hi = idx >> 5;
  kq = ((idx >> 2) & 7) + 8 * (hi & 1);
  w = (idx & 3) + 4 * (hi >> 1);
}

template <int kDKP>
__device__ __forceinline__ void load_v(VBlocks<kDKP>& vb, const int8_t* v, size_t rs, int j0,
                                       int T, int dk4) {
#pragma unroll
  for (int n = 0; n < VBlocks<kDKP>::kN; ++n) {
    const int idx = threadIdx.x + n * kThreads;
    if (idx >= 16 * (kDKP / 4)) break;
    int kq, w;
    vblock_at(idx, kq, w);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int j = j0 + 4 * kq + rr;
      vb.a[n][rr] = (j < T && w < dk4)
                        ? *reinterpret_cast<const unsigned*>(v + j * rs + 4 * w)
                        : 0u;
    }
  }
}

// the blocks transposed into Vt: (d, key) int8 rows of kVtw words
template <int kDKP>
__device__ __forceinline__ void store_v(const VBlocks<kDKP>& vb, int* Vt) {
#pragma unroll
  for (int n = 0; n < VBlocks<kDKP>::kN; ++n) {
    const int idx = threadIdx.x + n * kThreads;
    if (idx >= 16 * (kDKP / 4)) break;
    int kq, w;
    vblock_at(idx, kq, w);
    unsigned o[4];
    qasr_transpose4(vb.a[n], o);
#pragma unroll
    for (int q = 0; q < 4; ++q) Vt[(4 * w + q) * kVtw + kq] = static_cast<int>(o[q]);
  }
}

template <int kDKP>
struct Ctx {
  static constexpr int kNV = kDKP / kCG / 8;  // context n-tiles a warp
};

// accc += P (kTQ x 64 int8, rows of ldp words from word column pc0) x V chunk
template <int kDKP>
__device__ __forceinline__ void prob_times_v(int (&accc)[Ctx<kDKP>::kNV][4], const int* P,
                                             int ldp, int pc0, const int* Vt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp / kCG, wc = warp % kCG;
#pragma unroll
  for (int ks = 0; ks < kKC / 32; ++ks) {
    int a[4];
    load_a(a, P, ldp, wr * 16 + g, pc0 + ks * 8, t4);
#pragma unroll
    for (int nt = 0; nt < Ctx<kDKP>::kNV; ++nt) {
      const int c = wc * (kDKP / kCG) + nt * 8 + g;
      qasr_mma_s8(accc[nt], a, Vt[c * kVtw + ks * 8 + t4], Vt[c * kVtw + ks * 8 + t4 + 4]);
    }
  }
}

// out = clamp(requant(accc, ctx)) into the (B, T, h * d_k) layout
template <int kDKP>
__device__ __forceinline__ void store_context(const int (&accc)[Ctx<kDKP>::kNV][4],
                                              int8_t* out, size_t rs, int i0, int T, int DK,
                                              const QasrRq& rq_ctx, int n8) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp / kCG, wc = warp % kCG;
#pragma unroll
  for (int nt = 0; nt < Ctx<kDKP>::kNV; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + wr * 16 + g + 8 * (r >> 1);
      const int dd = wc * (kDKP / kCG) + nt * 8 + 2 * t4 + (r & 1);
      if (i < T && dd < DK)
        out[i * rs + dd] =
            static_cast<int8_t>(qasr_clamp(qasr_rq(accc[nt][r], rq_ctx), -n8, n8 - 1));
    }
  }
}

// the softmax numerator of a score s against its row's max m: i_exp >> 4
// from the table of its quadratic (Et, qasr_i_exp_pre), 0 where masked
__device__ __forceinline__ int row_exp(int s, int m, const int* Et) {
  const int e = qasr_i_exp_pre(min(m - s, kNIn), Et);
  return s == kMasked ? 0 : e;
}

template <int kDKP>
__global__ void __launch_bounds__(kThreads, 2)
int_attention_kernel(const int8_t* __restrict__ qu, const int8_t* __restrict__ qv,
                     const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                     const int8_t* __restrict__ pos, const int32_t* __restrict__ lens,
                     int8_t* __restrict__ out, int T, int H, int DK, int Tp, int ac_m,
                     int ac_e, int bd_m, int bd_e, int ctx_m, int ctx_e, int left,
                     int right, int n8) {
  constexpr int kDkw = kDKP / 4 + 4;       // padded q/k/pos row, in words
  extern __shared__ int4 smem4[];
  const int sld = Tp + 8, paw = Tp / 4 + 4;
  int* Qu = reinterpret_cast<int*>(smem4);
  int* Qv = Qu + kTQ * kDkw;
  int* Ks = Qv + kTQ * kDkw;               // 2 buffers of kKC rows
  int* Ps = Ks + 2 * kKC * kDkw;           // 2 buffers of kPW rows
  int* Vt = Ks;                            // 2 buffers of kDKP rows, once the scores are done
  int* BD = Ps + 2 * kPW * kDkw;
  int* S = BD + kTQ * kBdw;
  int* Pa = S + kTQ * sld;
  int* rmax = Pa + kTQ * paw;
  int* Et = rmax + kTQ;                    // i_exp's quadratic, kExpTab words

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kTQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lens[b], T);   // the plain version reads len > T as T
  const int dk4 = DK / 4;
  const bool v16 = DK % 16 == 0;
  const size_t rs = static_cast<size_t>(H) * DK;   // bytes per time step
  const size_t off = static_cast<size_t>(b) * T * rs + static_cast<size_t>(h) * DK;
  const int8_t* pos_h = pos + static_cast<size_t>(h) * DK;
  const ScoreRq rq = score_rq(ac_m, ac_e, bd_m, bd_e, kDKP);
  const int nch = Tp / kKC;

  if (tid < kTQ) rmax[tid] = INT_MIN;
  for (int r = tid; r < kExpTab; r += kThreads) Et[r] = qasr_exp_quad(r);
  stage_rows<kDKP>(Qu, qu + off, rs, i0, kTQ, T, dk4, v16);
  stage_rows<kDKP>(Qv, qv + off, rs, i0, kTQ, T, dk4, v16);
  stage_chunk<kDKP>(Ks, Ps, k + off, pos_h, rs, i0, 0, T, dk4, v16);
  qasr_cp_commit();
  // ---- scores and row maxima, one chunk of 64 keys at a time -------------
  for (int ci = 0; ci < nch; ++ci) {
    qasr_cp_wait<0>();
    __syncthreads();   // chunk ci landed; every warp is done with chunk ci - 1
    if (ci + 1 < nch) {
      const int nb = (ci + 1) & 1;
      stage_chunk<kDKP>(Ks + nb * kKC * kDkw, Ps + nb * kPW * kDkw, k + off, pos_h, rs,
                             i0, (ci + 1) * kKC, T, dk4, v16);
      qasr_cp_commit();
    }
    const int cb = ci & 1;
    chunk_scores<kDKP>(Qu, Qv, Ks + cb * kKC * kDkw, Ps + cb * kPW * kDkw, BD, S, sld,
                            ci * kKC, i0, ci * kKC, len, left, right, rq, rmax);
  }
  VBlocks<kDKP> vb;
  load_v<kDKP>(vb, v + off, rs, 0, T, dk4);
  __syncthreads();

  // ---- integer softmax, a warp's kTQ / 8 rows at a time: exponents and
  // row sums, then the rows' divisors made at once (lane r makes row r's)
  constexpr int kRW = kTQ / 8;
  int dens[kRW];
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    int* srow = S + (warp * kRW + rr) * sld;
    const int m = rmax[warp * kRW + rr];
    int sum = 0;
    for (int j = lane; j < Tp; j += 32) {   // keys from T on are masked: e = 0
      const int e = row_exp(srow[j], m, Et);
      srow[j] = e;
      sum += e;
    }
    dens[rr] = max(qasr_warp_sum(sum), 1);
  }
  int mine = dens[0];
#pragma unroll
  for (int rr = 1; rr < kRW; ++rr) mine = lane == rr ? dens[rr] : mine;
  const QasrDiv dmine = qasr_div_make(static_cast<unsigned>(mine));
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    const int il = warp * kRW + rr;
    QasrDiv dv;
    dv.m = __shfl_sync(0xffffffffu, dmine.m, rr);
    dv.s1 = __shfl_sync(0xffffffffu, dmine.s1, rr);
    dv.s2 = __shfl_sync(0xffffffffu, dmine.s2, rr);
    const int* srow = S + il * sld;
    const int half = dens[rr] >> 1;
    int8_t* prow = reinterpret_cast<int8_t*>(Pa + il * paw);
    for (int j = lane; j < Tp; j += 32)
      prow[j] = static_cast<int8_t>(qasr_div(static_cast<unsigned>(srow[j] * n8 + half), dv));
  }
  store_v<kDKP>(vb, Vt);
  __syncthreads();

  // ---- context: probabilities x V, chunk by chunk, V one chunk ahead ------
  int accc[Ctx<kDKP>::kNV][4] = {};
  for (int ci = 0; ci < nch; ++ci) {
    if (ci + 1 < nch) load_v<kDKP>(vb, v + off, rs, (ci + 1) * kKC, T, dk4);
    prob_times_v<kDKP>(accc, Pa, paw, ci * (kKC / 4), Vt + (ci & 1) * kDKP * kVtw);
    if (ci + 1 < nch) store_v<kDKP>(vb, Vt + ((ci + 1) & 1) * kDKP * kVtw);
    __syncthreads();
  }
  store_context<kDKP>(accc, out + off, rs, i0, T, DK, qasr_rq_make(ctx_m, ctx_e), n8);
}

// The streaming form: three passes over the key chunks (see the note at
// the top); shared memory independent of T.
template <int kDKP>
__global__ void __launch_bounds__(kThreads, 2)
int_attention_stream_kernel(const int8_t* __restrict__ qu, const int8_t* __restrict__ qv,
                            const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                            const int8_t* __restrict__ pos,
                            const int32_t* __restrict__ lens, int8_t* __restrict__ out,
                            int T, int H, int DK, int Tp, int ac_m, int ac_e, int bd_m,
                            int bd_e, int ctx_m, int ctx_e, int left, int right, int n8) {
  constexpr int kDkw = kDKP / 4 + 4;
  extern __shared__ int4 smem4[];
  int* Qu = reinterpret_cast<int*>(smem4);
  int* Qv = Qu + kTQ * kDkw;
  int* Ks = Qv + kTQ * kDkw;       // 2 buffers
  int* Ps = Ks + 2 * kKC * kDkw;   // 2 buffers
  int* Vt = Ps + 2 * kPW * kDkw;
  int* BD = Vt + kDKP * kVtw;
  int* Sc = BD + kTQ * kBdw;   // the chunk's scores
  int* Pc = Sc + kTQ * kScw;       // the chunk's int8 probabilities
  int* rmax = Pc + kTQ * kPcw;     // per row: max over all keys
  int* rden = rmax + kTQ;          // per row: sum of i_exp >> 4
  int* rdiv = rden + kTQ;          // per row: the divisor's (m, s1, s2)
  int* Et = rdiv + 3 * kTQ;        // i_exp's quadratic, kExpTab words

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kTQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lens[b], T);   // the plain version reads len > T as T
  const int dk4 = DK / 4;
  const bool v16 = DK % 16 == 0;
  const size_t rs = static_cast<size_t>(H) * DK;
  const size_t off = static_cast<size_t>(b) * T * rs + static_cast<size_t>(h) * DK;
  const int8_t* pos_h = pos + static_cast<size_t>(h) * DK;
  const ScoreRq rq = score_rq(ac_m, ac_e, bd_m, bd_e, kDKP);
  const int nch = Tp / kKC;

  stage_rows<kDKP>(Qu, qu + off, rs, i0, kTQ, T, dk4, v16);
  stage_rows<kDKP>(Qv, qv + off, rs, i0, kTQ, T, dk4, v16);
  if (tid < kTQ) {
    rmax[tid] = INT_MIN;
    rden[tid] = 0;
  }
  for (int r = tid; r < kExpTab; r += kThreads) Et[r] = qasr_exp_quad(r);
  int accc[Ctx<kDKP>::kNV][4] = {};
  VBlocks<kDKP> vb;
  for (int pass = 0; pass < 3; ++pass) {
    __syncthreads();   // the last pass's readers are done with every buffer
    if (pass == 2 && tid < kTQ) {
      const QasrDiv dv = qasr_div_make(static_cast<unsigned>(max(rden[tid], 1)));
      rdiv[3 * tid] = static_cast<int>(dv.m);
      rdiv[3 * tid + 1] = dv.s1;
      rdiv[3 * tid + 2] = dv.s2;
    }
    stage_chunk<kDKP>(Ks, Ps, k + off, pos_h, rs, i0, 0, T, dk4, v16);
    qasr_cp_commit();
    for (int ci = 0; ci < nch; ++ci) {
      const int j0 = ci * kKC;
      qasr_cp_wait<0>();
      __syncthreads();   // chunk ci landed; every warp is done with chunk ci - 1
      if (ci + 1 < nch) {
        const int nb = (ci + 1) & 1;
        stage_chunk<kDKP>(Ks + nb * kKC * kDkw, Ps + nb * kPW * kDkw, k + off, pos_h,
                               rs, i0, j0 + kKC, T, dk4, v16);
        qasr_cp_commit();
      }
      if (pass == 2) load_v<kDKP>(vb, v + off, rs, j0, T, dk4);
      const int cb = ci & 1;
      chunk_scores<kDKP>(Qu, Qv, Ks + cb * kKC * kDkw, Ps + cb * kPW * kDkw, BD, Sc,
                              kScw, 0, i0, j0, len, left, right, rq,
                              pass == 0 ? rmax : nullptr);
      if (pass == 0) continue;
      __syncthreads();
      for (int rr = 0; rr < kTQ / 8; ++rr) {
        const int il = warp * (kTQ / 8) + rr;
        const int* srow = Sc + il * kScw;
        const int m = rmax[il];
        if (pass == 1) {
          int sum = 0;
          for (int jl = lane; jl < kKC; jl += 32) sum += row_exp(srow[jl], m, Et);
          sum = qasr_warp_sum(sum);
          if (lane == 0) rden[il] += sum;
          continue;
        }
        const int den = max(rden[il], 1);
        QasrDiv dv;
        dv.m = static_cast<unsigned>(rdiv[3 * il]);
        dv.s1 = rdiv[3 * il + 1];
        dv.s2 = rdiv[3 * il + 2];
        int8_t* prow = reinterpret_cast<int8_t*>(Pc + il * kPcw);
        for (int jl = lane; jl < kKC; jl += 32)
          prow[jl] = static_cast<int8_t>(
              qasr_div(static_cast<unsigned>(row_exp(srow[jl], m, Et) * n8 + (den >> 1)), dv));
      }
      if (pass == 2) {
        store_v<kDKP>(vb, Vt);
        __syncthreads();
        prob_times_v<kDKP>(accc, Pc, kPcw, 0, Vt);
      }
    }
  }
  store_context<kDKP>(accc, out + off, rs, i0, T, DK, qasr_rq_make(ctx_m, ctx_e), n8);
}

// ---- the cache form ------------------------------------------------------

constexpr int kTQC = 16;                 // queries a block
constexpr int kMaxWarpsC = kTQC;         // warps a block: a query row each at a time

// A staged row of d_k bytes: d_k rounded up to 16, plus 16, so that the
// 16-byte reads of 8 consecutive rows by a quarter warp fall on distinct
// banks; the bytes from d_k to the rounded size are zeros.
__host__ __device__ inline int cached_row_bytes(int DK) { return (DK + 15) / 16 * 16 + 16; }

// V transposed: a row of the window's slots for each of the d_k dims, 4
// slots a word, an odd word count (a warp's dims on 32 banks) with a word
// to spare past the window
__host__ __device__ inline int cached_vt_words(int L) { return ((kTQC + L + 3) / 4 + 1) | 1; }

// a query row's int8 probabilities: the L + 1 slots rounded up to 4, zeros past L
__host__ __device__ inline int cached_p8_bytes(int L) { return (L + 1 + 3) / 4 * 4; }

// The dynamic shared memory of a block of the cache form, in bytes from
// the base: Qu, Qv (kTQC rows), the K and V window (kTQC + L rows), the
// pos rows (L + 1), the i_exp table, V transposed, each warp's L + 1
// scores and exponents, and each query row's int8 probabilities
// (kernels/int_attention.py::cached_smem_bytes states the same).
struct CachedAttLayout {
  int qu, qv, ks, vs, ps, et, vt, sc, pr, p8, bytes;
};

__host__ __device__ inline CachedAttLayout cached_att_layout(int DK, int L, int warps) {
  const int rp = cached_row_bytes(DK);
  CachedAttLayout l;
  l.qu = 0;
  l.qv = l.qu + kTQC * rp;
  l.ks = l.qv + kTQC * rp;
  l.vs = l.ks + (kTQC + L) * rp;
  l.ps = l.vs + (kTQC + L) * rp;
  l.et = l.ps + (L + 1) * rp;
  l.vt = l.et + kExpTab * 4;
  l.sc = l.vt + (rp - 16) * cached_vt_words(L) * 4;
  l.pr = l.sc + warps * (L + 1) * 4;
  l.p8 = l.pr + warps * (L + 1) * 4;
  l.bytes = l.p8 + kTQC * cached_p8_bytes(L);
  return l;
}

// piece k of a row: 16 bytes where d_k is a multiple of 16; else 4 bytes,
// zero-filled from d_k on (the row's padded size)
__device__ __forceinline__ void cp_row_piece(int8_t* dst, const int8_t* src, int k, int DK,
                                             bool v16) {
  if (v16) {
    qasr_cp16(dst + 16 * k, src + 16 * k, 16);
  } else {
    const bool ok = 4 * k < DK;
    qasr_cp4(dst + 4 * k, ok ? src + 4 * k : src, ok ? 4 : 0);
  }
}

// One block a (batch, head, kTQC queries), a warp a query row at a time
// (see the note at the top).  Every staging copy is issued at once as
// cp.async and waited for once: the queries, the [cache || new] key and
// value rows the tile's queries reach, the pos rows and the i_exp table
// (exp_tab, built once on the host: kernels/int_attention.py::exp_table).
// The block that owns a slot of the new caches writes it from the staged
// rows (the first tile the slots before L; tile t the new frames' slots
// L + 16 t ..).
// kNV: 16-byte words of a staged row at most (1, 2, 4 or 8; the row's
// own count nv may be smaller, DK rounded up to 16 over 16)
template <int kNV>
__global__ void __launch_bounds__(32 * kMaxWarpsC)
int_attention_cached_kernel(const int8_t* __restrict__ qu, const int8_t* __restrict__ qv,
                            const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                            const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
                            const int8_t* __restrict__ pos, const int32_t* __restrict__ exp_tab,
                            int8_t* __restrict__ out, int8_t* __restrict__ kc_new,
                            int8_t* __restrict__ vc_new, int n, int L, int H, int DK, int seen,
                            int ac_m, int ac_e, int bd_m, int bd_e, int ctx_m, int ctx_e,
                            int n8) {
  extern __shared__ __align__(16) uint8_t smem_c[];
  const int nw = blockDim.x >> 5, nt = blockDim.x;
  const CachedAttLayout lay = cached_att_layout(DK, L, nw);
  const int rp = cached_row_bytes(DK), dkp = rp - 16, nv = dkp / 16;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kTQC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = min(kTQC, n - i0), nwin = nq + L;
  const size_t rs = static_cast<size_t>(H) * DK, hoff = static_cast<size_t>(h) * DK;
  const bool v16 = DK % 16 == 0;
  int8_t* Qu = reinterpret_cast<int8_t*>(smem_c + lay.qu);
  int8_t* Qv = reinterpret_cast<int8_t*>(smem_c + lay.qv);
  int8_t* Ks = reinterpret_cast<int8_t*>(smem_c + lay.ks);   // slots i0 .. i0 + nq + L - 1
  int8_t* Vs = reinterpret_cast<int8_t*>(smem_c + lay.vs);
  int8_t* Ps = reinterpret_cast<int8_t*>(smem_c + lay.ps);   // pos rows 0..L
  int* Et = reinterpret_cast<int*>(smem_c + lay.et);         // i_exp's quadratic
  int* Vt = reinterpret_cast<int*>(smem_c + lay.vt);         // V transposed
  int* Sc = reinterpret_cast<int*>(smem_c + lay.sc);         // a warp's L + 1 scores
  int* Pr = reinterpret_cast<int*>(smem_c + lay.pr);         // ... exponents
  int8_t* P8 = reinterpret_cast<int8_t*>(smem_c + lay.p8);   // a row's int8 probabilities

  // the staged rows in two lists, a thread copying one piece of a row and
  // stepping over the rows: Qu, Qv (nq each), the pos rows (L + 1), the K
  // window (nwin) and the i_exp table in one cp.async group; the V window
  // (nwin) in a second, which the scores do not wait for
  {
    const int pcs = v16 ? DK / 16 : dkp / 4, kk = tid % pcs, step = nt / pcs;
    const bool copies = tid < step * pcs;
    const int2 win = make_int2(2 * nq + L + 1, 2 * nq + L + 1 + nwin);
    for (int vr = tid / pcs; vr < win.y && copies; vr += step) {
      int8_t* dst;
      const int8_t* src;
      if (vr < 2 * nq) {
        const bool isv = vr >= nq;
        const int r = isv ? vr - nq : vr;
        dst = (isv ? Qv : Qu) + r * rp;
        src = (isv ? qv : qu) + (static_cast<size_t>(b) * n + i0 + r) * rs + hoff;
      } else if (vr < win.x) {
        const int r = vr - 2 * nq;
        dst = Ps + r * rp;
        src = pos + r * rs + hoff;
      } else {
        const int r = vr - win.x, j = i0 + r;
        dst = Ks + r * rp;
        src = j < L ? kc + (static_cast<size_t>(b) * L + j) * rs + hoff
                    : k + (static_cast<size_t>(b) * n + j - L) * rs + hoff;
      }
      cp_row_piece(dst, src, kk, DK, v16);
    }
    for (int idx = tid; idx < kExpTab / 4; idx += nt)
      qasr_cp16(Et + 4 * idx, exp_tab + 4 * idx, 16);
    qasr_cp_commit();
    for (int r = tid / pcs; r < nwin && copies; r += step) {
      const int j = i0 + r;
      cp_row_piece(Vs + r * rp,
                   j < L ? vc + (static_cast<size_t>(b) * L + j) * rs + hoff
                         : v + (static_cast<size_t>(b) * n + j - L) * rs + hoff,
                   kk, DK, v16);
    }
    qasr_cp_commit();
  }
  qasr_cp_wait<1>();
  __syncthreads();

  // the scores and the softmax of each query row: a warp a row, a lane its
  // slots; the row's int8 probabilities kept for the context
  const ScoreRq rq = score_rq(ac_m, ac_e, bd_m, bd_e, DK);
  const int np4 = cached_p8_bytes(L) / 4;  // probability words of a row
  int* S = Sc + warp * (L + 1);
  int* P = Pr + warp * (L + 1);
  for (int il = warp; il < nq; il += nw) {
    const int i = i0 + il;
    int4 qa[kNV], qb[kNV];
#pragma unroll
    for (int w = 0; w < kNV; ++w) {
      qa[w] = w < nv ? reinterpret_cast<const int4*>(Qu + il * rp)[w] : make_int4(0, 0, 0, 0);
      qb[w] = w < nv ? reinterpret_cast<const int4*>(Qv + il * rp)[w] : make_int4(0, 0, 0, 0);
    }
    // slot j = i + c sits at relative offset r = L - c: pos row L - c
    int m = INT_MIN;
    for (int c = lane; c <= L; c += 32) {
      const int4* kr = reinterpret_cast<const int4*>(Ks + (il + c) * rp);
      const int4* pr = reinterpret_cast<const int4*>(Ps + (L - c) * rp);
      int ac = 0, bd = 0;
#pragma unroll
      for (int w = 0; w < kNV; ++w) {
        if (w < nv) {
          const int4 y = kr[w], yb = pr[w];
          ac = __dp4a(qa[w].x, y.x, ac);
          ac = __dp4a(qa[w].y, y.y, ac);
          ac = __dp4a(qa[w].z, y.z, ac);
          ac = __dp4a(qa[w].w, y.w, ac);
          bd = __dp4a(qb[w].x, yb.x, bd);
          bd = __dp4a(qb[w].y, yb.y, bd);
          bd = __dp4a(qb[w].z, yb.z, bd);
          bd = __dp4a(qb[w].w, yb.w, bd);
        }
      }
      int sc = rq.f64 ? qasr_rq_f64(ac, rq.f_ac) + qasr_rq_f64(bd, rq.f_bd)
                      : qasr_rq(ac, rq.ac) + qasr_rq(bd, rq.bd);
      if (i + c < L - seen) sc = kMasked;
      S[c] = sc;
      m = max(m, sc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    int sum = 0;
    for (int c = lane; c <= L; c += 32) {
      const int e = row_exp(S[c], m, Et);
      P[c] = e;
      sum += e;
    }
    const unsigned den = static_cast<unsigned>(max(qasr_warp_sum(sum), 1));
    int8_t* pb = P8 + il * 4 * np4;
    for (int c = lane; c < 4 * np4; c += 32)
      pb[c] = c <= L ? static_cast<int8_t>((static_cast<unsigned>(P[c] * n8) + (den >> 1)) / den)
                     : 0;
    __syncwarp();   // the row's scores and exponents are read before the next row's
  }
  qasr_cp_wait<0>();
  __syncthreads();

  // the new caches: row r is slot n + r of [cache || new], written by the
  // tile that staged it (16 or 4 bytes a thread)
  {
    const int lo = blockIdx.x == 0 ? 0 : L + i0 - n;   // the rows this tile owns: [lo, hi)
    const int hi = min(L, L + i0 + kTQC - n);
    const int r0 = max(lo, 0), rows = max(hi - r0, 0);
    const int ps = v16 ? 16 : 4, pr = DK / ps, kk = tid % pr, step = nt / pr;
    for (int vr = tid / pr; vr < 2 * rows && tid < step * pr; vr += step) {
      const bool isv = vr >= rows;
      const int r = r0 + (isv ? vr - rows : vr);
      const int8_t* src = (isv ? Vs : Ks) + (n + r - i0) * rp + ps * kk;
      int8_t* dst =
          (isv ? vc_new : kc_new) + (static_cast<size_t>(b) * L + r) * rs + hoff + ps * kk;
      if (v16)
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      else
        *reinterpret_cast<int*>(dst) = *reinterpret_cast<const int*>(src);
    }
  }

  // V transposed into Vt: 4 x 4 byte blocks (4 slots x 4 dims) of the
  // window, slot quads past it read whatever follows Vs (their bytes only
  // ever meet zero probabilities)
  const int vtw = cached_vt_words(L);
  {
    const int dq4 = dkp / 4, dq = tid % dq4, step = nt / dq4;
    for (int sq = tid / dq4; sq < (nwin + 3) / 4 && tid < step * dq4; sq += step) {
      unsigned a[4], o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const unsigned*>(Vs + (4 * sq + i) * rp + 4 * dq);
      qasr_transpose4(a, o);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) Vt[(4 * dq + kq) * vtw + sq] = static_cast<int>(o[kq]);
    }
  }
  __syncthreads();

  // the context of each query row: a warp a row, a lane two dims (dd, dd
  // + 32)
  const QasrRq rq_ctx = qasr_rq_make(ctx_m, ctx_e);
  for (int il = warp; il < nq; il += nw) {
    const int i = i0 + il;
    const int* Pw = reinterpret_cast<const int*>(P8 + il * 4 * np4);
    // the row's probabilities 4 a word against V's slots il + 4 w .. (Vt's
    // words realigned by il mod 4 bytes)
    const int sh = 8 * (il & 3);
    for (int dd = lane; dd < DK; dd += 64) {
      const bool two = dd + 32 < DK;
      const int* v0 = Vt + dd * vtw + (il >> 2);
      const int* v1 = two ? v0 + 32 * vtw : v0;
      int a0 = 0, a1 = 0, lo0 = v0[0], lo1 = v1[0];
#pragma unroll 2
      for (int w = 0; w < np4; ++w) {
        const int pw = Pw[w], hi0 = v0[w + 1], hi1 = v1[w + 1];
        a0 = __dp4a(pw, static_cast<int>(__funnelshift_r(lo0, hi0, sh)), a0);
        a1 = __dp4a(pw, static_cast<int>(__funnelshift_r(lo1, hi1, sh)), a1);
        lo0 = hi0;
        lo1 = hi1;
      }
      int8_t* orow = out + (static_cast<size_t>(b) * n + i) * rs + hoff;
      orow[dd] = static_cast<int8_t>(qasr_clamp(qasr_rq(a0, rq_ctx), -n8, n8 - 1));
      if (two) orow[dd + 32] = static_cast<int8_t>(qasr_clamp(qasr_rq(a1, rq_ctx), -n8, n8 - 1));
    }
  }
}

template <int kNV>
cudaError_t launch_cached(const dim3& grid, int threads, size_t shm, cudaStream_t s,
                          const int8_t* qu, const int8_t* qv, const int8_t* k, const int8_t* v,
                          const int8_t* kc, const int8_t* vc, const int8_t* pos,
                          const int32_t* exp_tab, int8_t* out, int8_t* kc_new, int8_t* vc_new,
                          int n, int L, int H, int DK, int seen, int ac_m, int ac_e, int bd_m,
                          int bd_e, int ctx_m, int ctx_e, int n8) {
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(int_attention_cached_kernel<kNV>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(shm));
    if (err != cudaSuccess) return err;
  }
  int_attention_cached_kernel<kNV><<<grid, threads, shm, s>>>(
      qu, qv, k, v, kc, vc, pos, exp_tab, out, kc_new, vc_new, n, L, H, DK, seen, ac_m, ac_e,
      bd_m, bd_e, ctx_m, ctx_e, n8);
  return cudaGetLastError();
}

template <int kDKP>
int launch(const int8_t* qu, const int8_t* qv, const int8_t* k, const int8_t* v,
           const int8_t* pos, const int32_t* lens, int8_t* out, int B, int T, int H,
           int DK, int ac_m, int ac_e, int bd_m, int bd_e, int ctx_m, int ctx_e, int left,
           int right, int n8, int streaming, cudaStream_t stream) {
  const int Tp = (T + kKC - 1) / kKC * kKC;
  // kernels/int_attention.py::smem_bytes states the same layout
  size_t words = static_cast<size_t>(2 * kTQ + 2 * kKC + 2 * kPW) * (kDKP / 4 + 4) +
                 kTQ * kBdw;
  words += streaming ? static_cast<size_t>(kDKP) * kVtw + kTQ * (kScw + kPcw + 5) + kExpTab
                     : static_cast<size_t>(kTQ) * (Tp + 8) +
                           static_cast<size_t>(kTQ) * (Tp / 4 + 4) + kTQ + kExpTab;
  const size_t shm = 4 * words;
  auto* kernel = streaming ? int_attention_stream_kernel<kDKP>
                           : int_attention_kernel<kDKP>;
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
                                  int left, int right, int n8, int streaming, void* stream) {
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
      return launch<128>(qu, qv, k, v, pos, lens, out, B, T, H, DK, ac_m, ac_e, bd_m, bd_e,
                         ctx_m, ctx_e, left, right, n8, streaming, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The cache form: qu, qv, k, v (B, n, H, DK) int8 of the new frames, kc,
// vc (B, L, H, DK) the cached ones, pos (L + 1, H, DK) the pos rows of
// offsets 0..L, exp_tab the kExpTab-entry i_exp table (kernels/
// int_attention.py::exp_table), seen (<= L: the frames consumed before,
// capped) -> out (B, n, H * DK) int8 and the new caches kc_new, vc_new (B,
// L, H, DK).  DK a multiple of 4 up to 128, L >= 1 (kernels/
// int_attention.py::int_attention_cached checks both and the shared
// memory).  A block has min(n, 16) warps.
extern "C" int qasr_int_attention_cached(const int8_t* qu, const int8_t* qv, const int8_t* k,
                                         const int8_t* v, const int8_t* kc, const int8_t* vc,
                                         const int8_t* pos, const int32_t* exp_tab, int8_t* out,
                                         int8_t* kc_new, int8_t* vc_new, int B, int n, int L,
                                         int H, int DK, int seen, int ac_m, int ac_e, int bd_m,
                                         int bd_e, int ctx_m, int ctx_e, int n8, void* stream) {
  if (DK % 4 != 0 || DK < 4 || DK > 128 || L < 1 || n < 1 || B < 1 || exp_tab == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = n < kMaxWarpsC ? n : kMaxWarpsC;
  const size_t shm = static_cast<size_t>(cached_att_layout(DK, L, warps).bytes);
  const dim3 grid((n + kTQC - 1) / kTQC, H, B);
  const int nv = (cached_row_bytes(DK) - 16) / 16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* fn = nv <= 1 ? launch_cached<1> : nv <= 2 ? launch_cached<2>
           : nv <= 4 ? launch_cached<4> : launch_cached<8>;
  return static_cast<int>(fn(grid, 32 * warps, shm, s, qu, qv, k, v, kc, vc, pos, exp_tab, out,
                             kc_new, vc_new, n, L, H, DK, seen, ac_m, ac_e, bd_m, bd_e, ctx_m,
                             ctx_e, n8));
}
