// conv_block: the frozen Conformer's attention-output join plus its whole
// conv module, (B, T, d) int8 in and out, in two launches.
//
// Replaces qasr_tpu/kernels/conf_module.py::fused_conv_block (pl.pallas_call
// at conf_module.py:341), bit for bit with the XLA composition at
// qasr_tpu/quantize/conformer_freeze.py:650-659:
//
//   x1   = clamp(rq(c8 @ W_ao + b_ao) + rq(x8, j2))                 (int8)
//   yln  = clamp(rq(sgn * iLN(x1) + b_ln))                           (int8)
//   a8   = clamp(rq(yln @ W_a + b_a));  g = rq(yln @ W_g + b_g)
//   glu8 = clamp(rq(mask_{t < len}(a8 * i_sigmoid(g)), glu_prod))    (int8)
//   bn8  = clamp(rq(sgn * dw(glu8) + b_dw));  mid8 = i-swish(bn8)    (int8)
//   out  = clamp(rq(mid8 @ W_2 + b_2) + rq(x1, j3))                  (int8)
//
// What bounds it on an H100, at the flagship shape (B=32, T=375, d=256):
// 4 d x d GEMM-equivalents (att_out, the d -> 2d GLU, pw2) of 12,000 rows
// are 3.1 G int8 multiply-adds (about 3 us of tensor-core time); the
// bytes it must move are c8, x8 and out (3 x 3.1 MB) and the weights
// (about 3 us at 3.35 TB/s).  What the card actually spends is integer
// work on the CUDA cores: the nine requants, the i-LN, the sigmoid and
// swish, and the 31 depthwise taps of each of the 3.1 M elements.  So the
// design cuts integer instructions per element:
//  - the per-column requants (att_out, ln affine, GLU a and g, BN, pw2) and
//    glu_prod run on the FP64 pipe (qasr_rq_f64: one integer and two FP64
//    instructions) when the host has shown every column's |z| m < 2^(e+26)
//    for any int8 input (kernels/conv_block.py::_f64_scales; the
//    flagship's 16 layers all qualify), else as qasr_rq with the column's
//    mantissa folded into the site's constants; the stream requants (j2,
//    j3) of an int8 are 256-entry tables made once a block;
//  - the GLU gate's i_sigmoid is a lookup in a 4,544-byte table staged in
//    shared memory (qasr_i_sigmoid_tab: the function is odd about 64 and
//    saturates from q = 4541; a float-reciprocal division with a
//    correction step ran slower, PERF.md); the i-swish after the BN is
//    one lookup in a 256-byte table per layer, indexed by bn8 + 128 (the
//    chain bn8 -> mid8 has static requants, so it is a function of bn8
//    alone).  Both tables
//    are built on the host from the plain functions (kernels/conv_block.py);
//  - the i-LN divides by d with an invariant divisor and by sigma with a
//    float estimate corrected once each way, and takes the square root in
//    float, corrected (qasr_ln_row_div), in place of per-element integer
//    divisions and a 16-step digit loop;
//  - the depthwise is time-packed __dp4a as Kernel 1 (dw_conv.cu): glu8 is
//    staged channel-major, four frames a word (4-channel loads transposed
//    with byte_perm), the taps come packed four a word from the host
//    (P[g] = w[4g..4g+3], a zero word first), and a thread makes 16 outputs
//    of one channel with 16 dp4a per tap group, the taps shifted by j bytes
//    with funnel shifts and the window words renamed in rotation.
// The GEMMs run mma.sync m16n8k32 s8 from fragments loaded with ldmatrix;
// their 64-column weight chunks come in with 16-byte cp.async into a
// double buffer, so chunk c+1 loads while chunk c multiplies.  The c8 and
// x8 tiles (stage A) and the x1 tile (stage B) come in by cp.async too, so
// no epilogue waits on a global load.
//
// Tiles: 32 rows (stage A, of the flattened (B*T, d) stream) or 32 frames
// of one utterance (stage B) per 128-thread block (4 warps: 2 row groups x
// 2 column groups of a 32 x 64 output chunk).  At the flagship shape that
// is 375 blocks in stage A (66 KB of shared memory, 3 fit an SM) and 12 x
// 32 = 384 in stage B (73 KB, 3 fit): both stages are one wave of 2.8-2.9
// blocks per SM on the 132 SMs, where 64-row tiles gave 188 / 192 blocks
// and 1 or 2 per SM.  Stage B's halo is K - 1 frames per 32 (94% staged
// overhead), cheap next to the taps.  glu8 is the only intermediate in
// device memory; stage B's epilogue joins against x1 read back from the
// output buffer, whose elements it then overwrites.
//
// The cache form (the stream step of a causal Conformer, the JAX package's
// XLA composition at conformer_freeze.py:825-835) is one cluster launch,
// conv_block_cached.cu, while an utterance's new frames fit its 32-row
// tile.  Past that its C entry runs the two stages here over the n new
// frames of each utterance (T = n; kernels conv_block_cached_stage_{a,b},
// so that a trace keeps them apart): stage A with no length mask (lens
// NULL: every fed frame is valid), stage B's depthwise over [cache (K - 1
// rows) || glu8 (n rows)] with padding (0, 0), so its halo reads the cached
// GLU rows where the offline form reads zeros; the first time tile of each
// utterance also writes the new cache, the last K - 1 rows of [cache ||
// glu8].
#include <cstdint>

#include <cuda_runtime.h>

#include "conformer_int.cuh"
#include "conv_block.cuh"
#include "requant.cuh"
#include "tile_s8.cuh"

namespace {

constexpr int kThreads = 128;     // 4 warps: 2 row groups x 2 column groups
constexpr int kPer = 16;          // depthwise outputs per task: 4 quads of 4

// a thread's share of copying rows of d bytes in 16-byte pieces: piece q
// of rows r, r + step, ... (threads from step * (d / 16) on copy none), so
// that the copy loops carry no division
struct RowSplit {
  int r, q, step;
};

__device__ __forceinline__ RowSplit row_split(int d) {
  const int pr = d / 16;
  RowSplit s;
  s.step = kThreads / pr;
  s.r = threadIdx.x / pr;
  s.q = threadIdx.x - s.r * pr;
  if (s.r >= s.step) s.r = kRows + kChunk;   // past every loop's end
  return s;
}

// weight rows [row0, row0 + 64) of a row-major (rows, d) int8 matrix ->
// smem rows of lda words, 16 bytes a cp.async (the caller commits)
__device__ __forceinline__ void load_chunk(int* dst, const int8_t* w, int row0, int d,
                                           int lda, const RowSplit& sp) {
  for (int r = sp.r; r < kChunk; r += sp.step)
    qasr_cp16(dst + r * lda + 4 * sp.q, w + static_cast<size_t>(row0 + r) * d + 16 * sp.q, 16);
}

// The i-LN of the tile's x1 rows (kRows / 4 a warp) and the ln_conv affine
// requant into A8; kP >= d / 32 values a lane (the lane's columns' affine
// constants are loaded once for its rows)
template <int kP, bool kF64>
__device__ __forceinline__ void ln_rows(const int8_t* X1, int8_t* A8, int lda,
                                        const int32_t* __restrict__ vec,
                                        const double* __restrict__ mf, int d,
                                        const QasrRq& s_ln, int n8) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = d / 32;
  const QasrDiv dd = qasr_div_make(static_cast<unsigned>(d));
  int ls[kP], lb[kP], lm[kP];
  double lf[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    const int o = lane + 32 * k;
    ls[k] = k < per ? __ldg(vec + 2 * d + o) : 0;
    lb[k] = k < per ? __ldg(vec + 3 * d + o) : 0;
    if (kF64)
      lf[k] = k < per ? __ldg(mf + 5 * d + o) : 0.0;
    else
      lm[k] = k < per ? __ldg(vec + 4 * d + o) : 0;
  }
  for (int rr = 0; rr < kRows / 4; ++rr) {
    const int rl = warp * (kRows / 4) + rr;
    int xv[kP], yv[kP];
#pragma unroll
    for (int k = 0; k < kP; ++k) xv[k] = k < per ? X1[rl * d + lane + 32 * k] : 0;
    qasr_ln_row_div<kP>(xv, yv, per, d, dd);
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      if (k < per) {
        const int z = ls[k] * yv[k] + lb[k];
        A8[rl * lda * 4 + lane + 32 * k] = static_cast<int8_t>(
            clamp8(kF64 ? qasr_rq_f64(z, lf[k]) : qasr_rq(z, qasr_rq_col(s_ln, lm[k])), n8));
      }
    }
  }
}

// vec rows (each d int32): b_ao, m_ao, ln_sgn, ln_b, ln_m, b_a, m_a, b_g,
// m_g, dw_sgn, dw_b, dw_m, b_2, m_2.  sc: e_ao, j2_m, j2_e, e_ln, e_a, e_g,
// glu_m, glu_e, e_dw, bng_m, bng_e, bnp_m, bnp_e, e_2, j3_m, j3_e.  mf rows
// (kF64, each d doubles m 2^-e): att_out, GLU a, GLU g, BN, pw2, ln affine.
#define QASR_STAGE_A_PARAMS                                                              \
  (const int8_t* __restrict__ c8, const int8_t* __restrict__ x8,                         \
   const int32_t* __restrict__ lens, const int8_t* __restrict__ w_ao,                    \
   const int8_t* __restrict__ w_ag, const int32_t* __restrict__ vec,                     \
   const int32_t* __restrict__ sc, const double* __restrict__ mf,                        \
   const uint8_t* __restrict__ sig_tab, int8_t* __restrict__ glu8,                       \
   int8_t* __restrict__ x1out, int N, int T, int d, int n8)
#define QASR_STAGE_A_ARGS (c8, x8, lens, w_ao, w_ag, vec, sc, mf, sig_tab, glu8, x1out, N, T, d, n8)
template <bool kF64>
__device__ __forceinline__ void stage_a QASR_STAGE_A_PARAMS {
  extern __shared__ int4 smem4[];
  const int lda = d / 4 + 4;
  int* As = reinterpret_cast<int*>(smem4);                    // 32 x lda words
  int* Ws = As + kRows * lda;                                 // 2 x 64 x lda words
  int8_t* X1 = reinterpret_cast<int8_t*>(Ws + 2 * kChunk * lda);  // 32 x d bytes
  int8_t* X8 = X1 + kRows * d;                                // 32 x d bytes: the x8 tile
  int* T2 = reinterpret_cast<int*>(X8 + kRows * d);           // rq(x8, j2) at x8 + 128
  uint8_t* Sig = reinterpret_cast<uint8_t*>(T2 + 256);        // kSigTab bytes
  int8_t* A8 = reinterpret_cast<int8_t*>(As);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp >> 1, wc = warp & 1;
  const int n0 = blockIdx.x * kRows;
  const int nc_ao = d / 64, nc = nc_ao + d / 32;

  // group 0: the c8 and x8 tiles (zero past N), the sigmoid table, weight chunk 0
  const RowSplit sp = row_split(d);
  for (int r = sp.r; r < kRows; r += sp.step) {
    const int n = n0 + r;
    const size_t e = n < N ? static_cast<size_t>(n) * d + 16 * sp.q : 0;
    qasr_cp16(As + r * lda + 4 * sp.q, c8 + e, n < N ? 16 : 0);
    qasr_cp16(X8 + r * d + 16 * sp.q, x8 + e, n < N ? 16 : 0);
  }
  for (int idx = tid; idx < kSigTab / 16; idx += kThreads)
    qasr_cp16(Sig + 16 * idx, sig_tab + 16 * idx, 16);
  load_chunk(Ws, w_ao, 0, d, lda, sp);
  qasr_cp_commit();

  const QasrRq rq_j2 = qasr_rq_make(sc[1], sc[2]), rq_glu = qasr_rq_make(sc[6], sc[7]);
  for (int v = tid; v < 256; v += kThreads) T2[v] = qasr_rq(v - 128, rq_j2);
  const QasrRq s_ao = qasr_rq_make(1, sc[0]), s_ln = qasr_rq_make(1, sc[3]);
  const QasrRq s_a = qasr_rq_make(1, sc[4]), s_g = qasr_rq_make(1, sc[5]);
  const double f_glu = kF64 ? qasr_rq_f64_scale(sc[6], sc[7]) : 0.0;
  // this thread's two rows: in range, and inside their utterance's length
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + wr * 16 + g + 8 * h;
    live[h] = n < N && (lens == nullptr || (n % T) < lens[n / T]);
  }

  int acc[4][4];
  for (int c = 0; c < nc; ++c) {
    qasr_cp_wait<0>();
    __syncthreads();   // chunk c landed; every warp is done with chunk c - 1's buffer
    if (c + 1 < nc) {
      const bool ao = c + 1 < nc_ao;
      load_chunk(Ws + ((c + 1) & 1) * kChunk * lda, ao ? w_ao : w_ag,
                 (ao ? c + 1 : c + 1 - nc_ao) * kChunk, d, lda, sp);
      qasr_cp_commit();
    }
    if (c == nc_ao) {
      // i-LayerNorm of x1, one warp per row, then the ln_conv affine
      // requant -> A8 (over the c8 tile, no longer read); compiled for the
      // smallest of 2, 4, 8, 16 values a lane that covers d / 32
      const int per = d / 32;
      if (per <= 2)
        ln_rows<2, kF64>(X1, A8, lda, vec, mf, d, s_ln, n8);
      else if (per <= 4)
        ln_rows<4, kF64>(X1, A8, lda, vec, mf, d, s_ln, n8);
      else if (per <= 8)
        ln_rows<8, kF64>(X1, A8, lda, vec, mf, d, s_ln, n8);
      else
        ln_rows<kMaxPer, kF64>(X1, A8, lda, vec, mf, d, s_ln, n8);
      __syncthreads();
    }
    gemm_tile(As, Ws + (c & 1) * kChunk * lda, lda, d, acc);
    if (c < nc_ao) {
      // att_out + stream join -> x1 (to the output buffer and to X1)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = c * 64 + wc * 32 + j * 8 + 2 * t4;
        const int b0 = __ldg(vec + o), b1 = __ldg(vec + o + 1);
        const QasrColRq<kF64> q0(s_ao, vec + d, mf, o), q1(s_ao, vec + d, mf, o + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = wr * 16 + g + 8 * h, n = n0 + rl;
          int v0 = 0, v1 = 0;
          if (n < N) {
            const short xs = *reinterpret_cast<const short*>(X8 + rl * d + o);
            v0 = clamp8(q0(acc[j][2 * h] + b0) + T2[static_cast<int8_t>(xs & 0xff) + 128], n8);
            v1 = clamp8(q1(acc[j][2 * h + 1] + b1) + T2[static_cast<int8_t>(xs >> 8) + 128], n8);
            *reinterpret_cast<short*>(x1out + static_cast<size_t>(n) * d + o) =
                qasr_pack2(v0, v1);
          }
          *reinterpret_cast<short*>(X1 + rl * d + o) = qasr_pack2(v0, v1);
        }
      }
    } else {
      // GLU: accumulators j < 2 hold a columns, j + 2 the matching g columns
      const int cg = c - nc_ao;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = cg * 32 + wc * 16 + j * 8 + 2 * t4;
        const int ba[2] = {__ldg(vec + 5 * d + o), __ldg(vec + 5 * d + o + 1)};
        const int bg[2] = {__ldg(vec + 7 * d + o), __ldg(vec + 7 * d + o + 1)};
        const QasrColRq<kF64> qa[2] = {QasrColRq<kF64>(s_a, vec + 6 * d, mf + d, o),
                                       QasrColRq<kF64>(s_a, vec + 6 * d, mf + d, o + 1)};
        const QasrColRq<kF64> qg[2] = {QasrColRq<kF64>(s_g, vec + 8 * d, mf + 2 * d, o),
                                       QasrColRq<kF64>(s_g, vec + 8 * d, mf + 2 * d, o + 1)};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + wr * 16 + g + 8 * h;
          if (n >= N) continue;
          int v[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int a8 = clamp8(qa[u](acc[j][2 * h + u] + ba[u]), n8);
            const int gg = qg[u](acc[j + 2][2 * h + u] + bg[u]);
            const int y = live[h] ? a8 * qasr_i_sigmoid_tab(Sig, gg) : 0;
            v[u] = clamp8(kF64 ? qasr_rq_f64(y, f_glu) : qasr_rq(y, rq_glu), n8);
          }
          *reinterpret_cast<short*>(glu8 + static_cast<size_t>(n) * d + o) =
              qasr_pack2(v[0], v[1]);
        }
      }
    }
  }
}

// 16 outputs of one channel: acc[4a + j] += window word (a + g) . taps of
// group g shifted by j bytes, for one tap group g (P = P[g], pl = P[g - 1])
__device__ __forceinline__ void dw_group(int (&acc)[kPer], int x0, int x1, int x2, int x3,
                                         int pl, int p) {
  const int w1 = __funnelshift_l(pl, p, 8), w2 = __funnelshift_l(pl, p, 16),
            w3 = __funnelshift_l(pl, p, 24);
  const int win[4] = {x0, x1, x2, x3};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    acc[4 * a] = __dp4a(win[a], p, acc[4 * a]);
    acc[4 * a + 1] = __dp4a(win[a], w1, acc[4 * a + 1]);
    acc[4 * a + 2] = __dp4a(win[a], w2, acc[4 * a + 2]);
    acc[4 * a + 3] = __dp4a(win[a], w3, acc[4 * a + 3]);
  }
}

// dw_p: (d, ngp) int32, word 0 of each channel 0 and word 1 + g the taps
// 4g..4g+3 of group g < ng (kernels/conv_block.py::pack_taps); swish_tab:
// mid8 of bn8 at bn8 + 128.  The depthwise reads frame s of [cache (kc
// rows) || glu8 (T rows)] (zero outside it) at s = t - pad_l + tap; kc = 0
// is the offline form.  With a cache, blockIdx.x 0 writes new_cache, the
// last kc rows of [cache || glu8].
#define QASR_STAGE_B_PARAMS                                                              \
  (const int8_t* __restrict__ glu8, const int32_t* __restrict__ dw_p,                    \
   const int8_t* __restrict__ w_2, const int32_t* __restrict__ vec,                      \
   const int32_t* __restrict__ sc, const double* __restrict__ mf,                        \
   const uint8_t* __restrict__ swish_tab, int8_t* __restrict__ out,                      \
   const int8_t* __restrict__ cache, int8_t* __restrict__ new_cache, int T, int d,       \
   int ng, int ngp, int pad_l, int kc, int n8)
#define QASR_STAGE_B_ARGS \
  (glu8, dw_p, w_2, vec, sc, mf, swish_tab, out, cache, new_cache, T, d, ng, ngp, pad_l, kc, n8)
template <bool kF64>
__device__ __forceinline__ void stage_b QASR_STAGE_B_PARAMS {
  extern __shared__ int4 smem4[];
  const int lda = d / 4 + 4;
  const int nw = kRows / 4 + ng - 1;          // staged words per channel
  const int pitch = nw | 1;                   // odd: a warp's channels on distinct banks
  int* As = reinterpret_cast<int*>(smem4);    // 32 x lda words: mid8
  int* Ws = As + kRows * lda;                 // 2 x 64 x lda words
  int* Pw = Ws + 2 * kChunk * lda;            // d x ngp words: packed taps
  int* Gw = Pw + d * ngp;                     // d x pitch words (+ 8 spare): glu8, 4 frames a word
  uint8_t* Sw = reinterpret_cast<uint8_t*>(Gw + d * pitch + 8);  // 256 bytes
  int8_t* A8 = reinterpret_cast<int8_t*>(As);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp >> 1, wc = warp & 1;
  const int b = blockIdx.y, t0 = blockIdx.x * kRows;
  const size_t base = static_cast<size_t>(b) * T * d;
  const size_t cbase = static_cast<size_t>(b) * kc * d;

  if (kc > 0 && blockIdx.x == 0) {
    // the new cache: row r is frame T + r of [cache || glu8], 16 bytes a copy
    for (int idx = tid; idx < kc * (d / 16); idx += kThreads) {
      const int r = idx / (d / 16), q = idx - r * (d / 16), f = T + r;
      const int8_t* src = f < kc ? cache + cbase + static_cast<size_t>(f) * d
                                 : glu8 + base + static_cast<size_t>(f - kc) * d;
      *reinterpret_cast<int4*>(new_cache + cbase + static_cast<size_t>(r) * d + 16 * q) =
          *reinterpret_cast<const int4*>(src + 16 * q);
    }
  }

  // group 0: the taps, the swish table and pw2's weight chunk 0
  for (int idx = tid; idx < d * ngp / 4; idx += kThreads) qasr_cp16(Pw + 4 * idx, dw_p + 4 * idx, 16);
  if (tid < 16) qasr_cp16(Sw + 16 * tid, swish_tab + 16 * tid, 16);
  const RowSplit sp = row_split(d);
  load_chunk(Ws, w_2, 0, d, lda, sp);
  qasr_cp_commit();

  // frames t0 - pad_l + 4 w + i of [cache || glu8] (zero outside [0, kc +
  // T)), channel-major: each item is 4 channels x 4 frames, transposed with
  // byte_perm; a warp covers 8 channel groups x 4 words, on 32 banks
  {
    const int groups = d / 4;
#pragma unroll 4
    for (int idx = tid; idx < groups * nw; idx += kThreads) {
      const int cgl = idx & 7, rest = idx >> 3;
      const int w = rest % nw, cg = (rest / nw) * 8 + cgl;
      unsigned a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 - pad_l + 4 * w + i;
        a[i] = 0u;
        if (t >= 0 && t < kc + T) {
          const int8_t* src = t < kc ? cache + cbase + static_cast<size_t>(t) * d
                                     : glu8 + base + static_cast<size_t>(t - kc) * d;
          a[i] = *reinterpret_cast<const unsigned*>(src + 4 * cg);
        }
      }
      unsigned o[4];
      qasr_transpose4(a, o);
#pragma unroll
      for (int k = 0; k < 4; ++k) Gw[(4 * cg + k) * pitch + w] = static_cast<int>(o[k]);
    }
  }
  qasr_cp_wait<0>();
  __syncthreads();

  // depthwise taps -> BN affine requant -> i-swish table -> A8; a task is
  // 16 consecutive frames of one channel
  {
    const QasrRq s_dw = qasr_rq_make(1, sc[8]);
    for (int task = tid; task < (kRows / kPer) * d; task += kThreads) {
      const int c = task % d, fg = task / d;
      const int* xr = Gw + c * pitch + 4 * fg;
      const int* pr = Pw + c * ngp;
      int acc[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) acc[u] = 0;
      int x0 = xr[0], x1 = xr[1], x2 = xr[2], x3 = xr[3];
      int pl = pr[0];
      // groups in fours, the window's registers renamed in rotation; the
      // words read past the last group are never used
      for (int gi = 0; gi < ng; gi += 4) {
        int p = pr[gi + 1];
        dw_group(acc, x0, x1, x2, x3, pl, p);
        pl = p;
        x0 = xr[gi + 4];
        if (gi + 1 >= ng) break;
        p = pr[gi + 2];
        dw_group(acc, x1, x2, x3, x0, pl, p);
        pl = p;
        x1 = xr[gi + 5];
        if (gi + 2 >= ng) break;
        p = pr[gi + 3];
        dw_group(acc, x2, x3, x0, x1, pl, p);
        pl = p;
        x2 = xr[gi + 6];
        if (gi + 3 >= ng) break;
        p = pr[gi + 4];
        dw_group(acc, x3, x0, x1, x2, pl, p);
        pl = p;
        x3 = xr[gi + 7];
      }
      const int sgn = __ldg(vec + 9 * d + c), bias = __ldg(vec + 10 * d + c);
      const QasrColRq<kF64> q(s_dw, vec + 11 * d, mf + 3 * d, c);
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int bn = clamp8(q(sgn * acc[u] + bias), n8);
        A8[(kPer * fg + u) * lda * 4 + c] = static_cast<int8_t>(Sw[bn + 128]);
      }
    }
  }

  // pw2 GEMM + stream join against x1, held in out: the tile's x1 rows come
  // into the taps' space (free once every task is done) with rq(x1, j3)
  // tabulated beside them
  __syncthreads();
  int8_t* X1s = reinterpret_cast<int8_t*>(Pw);               // 32 x d bytes
  int* T3 = reinterpret_cast<int*>(X1s + kRows * d);         // rq(x1, j3) at x1 + 128
  for (int r = sp.r; r < kRows; r += sp.step) {
    const int t = t0 + r;
    qasr_cp16(X1s + r * d + 16 * sp.q,
              out + (t < T ? base + static_cast<size_t>(t) * d + 16 * sp.q : 0), t < T ? 16 : 0);
  }
  qasr_cp_commit();
  const QasrRq rq_j3 = qasr_rq_make(sc[14], sc[15]), s_2 = qasr_rq_make(1, sc[13]);
  for (int v = tid; v < 256; v += kThreads) T3[v] = qasr_rq(v - 128, rq_j3);
  const int nc = d / 64;
  int acc[4][4];
  for (int c = 0; c < nc; ++c) {
    qasr_cp_wait<0>();
    __syncthreads();   // chunk c (and, at c = 0, x1 and T3) complete; chunk c - 1's buffer free
    if (c + 1 < nc) {
      load_chunk(Ws + ((c + 1) & 1) * kChunk * lda, w_2, (c + 1) * kChunk, d, lda, sp);
      qasr_cp_commit();
    }
    gemm_tile(As, Ws + (c & 1) * kChunk * lda, lda, d, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = c * 64 + wc * 32 + j * 8 + 2 * t4;
      const int b0 = __ldg(vec + 12 * d + o), b1 = __ldg(vec + 12 * d + o + 1);
      const QasrColRq<kF64> q0(s_2, vec + 13 * d, mf + 4 * d, o),
          q1(s_2, vec + 13 * d, mf + 4 * d, o + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wr * 16 + g + 8 * h, t = t0 + rl;
        if (t >= T) continue;
        const short xs = *reinterpret_cast<const short*>(X1s + rl * d + o);
        *reinterpret_cast<short*>(out + base + static_cast<size_t>(t) * d + o) =
            qasr_pack2(
                clamp8(q0(acc[j][2 * h] + b0) + T3[static_cast<int8_t>(xs & 0xff) + 128], n8),
                clamp8(q1(acc[j][2 * h + 1] + b1) + T3[static_cast<int8_t>(xs >> 8) + 128], n8));
      }
    }
  }
}

// Each stage under two kernel names, the offline form's and the cache
// form's staged plan (conv_block_cached_stage_*), so that a trace holding
// both paths keeps their device times apart; the code is one.
#define QASR_STAGE_KERNEL(kernel, body, params, args) \
  template <bool kF64>                                \
  __global__ void __launch_bounds__(kThreads, 3) kernel params { body<kF64> args; }
QASR_STAGE_KERNEL(conv_block_stage_a, stage_a, QASR_STAGE_A_PARAMS, QASR_STAGE_A_ARGS)
QASR_STAGE_KERNEL(conv_block_cached_stage_a, stage_a, QASR_STAGE_A_PARAMS, QASR_STAGE_A_ARGS)
QASR_STAGE_KERNEL(conv_block_stage_b, stage_b, QASR_STAGE_B_PARAMS, QASR_STAGE_B_ARGS)
QASR_STAGE_KERNEL(conv_block_cached_stage_b, stage_b, QASR_STAGE_B_PARAMS, QASR_STAGE_B_ARGS)

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <bool kF64>
int launch(const int8_t* c8, const int8_t* x8, const int32_t* lens, const int8_t* w_ao,
           const int8_t* w_ag, const int32_t* dw_p, const int8_t* w_2, const int32_t* vec,
           const int32_t* sc, const double* mf, const uint8_t* sig_tab,
           const uint8_t* swish_tab, int8_t* glu8, int8_t* out, const int8_t* cache,
           int8_t* new_cache, int B, int T, int d, int K, int pad_l, int kc, int n8,
           cudaStream_t s) {
  const int ng = (K + 2) / 4 + 1, ngp = (ng + 1) | 1;
  const size_t lda = d / 4 + 4;
  const size_t pitch = (kRows / 4 + ng - 1) | 1;
  const size_t shm_a = 4 * ((kRows + 2 * kChunk) * lda + 256) +
                       2 * static_cast<size_t>(kRows) * d + kSigTab;
  const size_t shm_b =
      4 * ((kRows + 2 * kChunk) * lda + static_cast<size_t>(d) * (ngp + pitch) + 8) + 256;
  const auto stage_a_k = kc > 0 ? conv_block_cached_stage_a<kF64> : conv_block_stage_a<kF64>;
  const auto stage_b_k = kc > 0 ? conv_block_cached_stage_b<kF64> : conv_block_stage_b<kF64>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(stage_a_k), shm_a);
  if (err == cudaSuccess) err = allow_smem(reinterpret_cast<const void*>(stage_b_k), shm_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int N = B * T;
  stage_a_k<<<(N + kRows - 1) / kRows, kThreads, shm_a, s>>>(
      c8, x8, lens, w_ao, w_ag, vec, sc, mf, sig_tab, glu8, out, N, T, d, n8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stage_b_k<<<dim3((T + kRows - 1) / kRows, B), kThreads, shm_b, s>>>(
      glu8, dw_p, w_2, vec, sc, mf, swish_tab, out, cache, new_cache, T, d, ng, ngp, pad_l, kc,
      n8);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ng = (K + 2) / 4 + 1 tap groups (the last output of a quad reaches tap
// 4 (ng - 1) + 3 - 3), ngp = (ng + 1) | 1 words per channel in dw_p.  mf
// NULL requants every per-column site and glu_prod with qasr_rq; otherwise
// with qasr_rq_f64 (the caller has checked each column's domain,
// kernels/conv_block.py::_f64_scales).  sig_tab: the kSigTab-byte GLU
// sigmoid table (kernels/conv_block.py::sigmoid_table).  The cache form's
// staged plan (qasr_conv_block_cached, conv_block_cached.cu): lens NULL,
// pad_l 0, kc = K - 1, cache (B, kc, d) and new_cache (B, kc, d) int8; the
// offline form: cache and new_cache NULL, kc 0.
extern "C" int qasr_conv_block(const int8_t* c8, const int8_t* x8, const int32_t* lens,
                               const int8_t* w_ao, const int8_t* w_ag, const int32_t* dw_p,
                               const int8_t* w_2, const int32_t* vec, const int32_t* sc,
                               const double* mf, const uint8_t* sig_tab,
                               const uint8_t* swish_tab, int8_t* glu8, int8_t* out,
                               const int8_t* cache, int8_t* new_cache, int B, int T, int d,
                               int K, int pad_l, int kc, int n8, void* stream) {
  if (d % 64 != 0 || d > 32 * kMaxPer || K < 1 || sig_tab == nullptr || swish_tab == nullptr ||
      kc < 0 || (kc > 0 && (cache == nullptr || new_cache == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* fn = mf ? launch<true> : launch<false>;
  return fn(c8, x8, lens, w_ao, w_ag, dw_p, w_2, vec, sc, mf, sig_tab, swish_tab, glu8, out,
            cache, new_cache, B, T, d, K, pad_l, kc, n8, s);
}
