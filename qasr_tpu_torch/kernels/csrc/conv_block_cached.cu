// conv_block_cached: Kernel 4's cache form, the frozen Conformer's
// attention-output join plus its whole conv module over the n new frames
// of a stream step, with the depthwise's K - 1 cached GLU rows.
//
// Replaces qasr_tpu/kernels/conf_module.py::fused_conv_block (pl.pallas_call
// at conf_module.py:341; the offline form is conv_block.cu) where the JAX
// package runs the stream step as an XLA composition over [cache || new]
// (qasr_tpu/quantize/conformer_freeze.py:825-835), bit for bit with it:
// the arithmetic of conv_block.cu's note without the length mask.
//
// A stream step has n new frames of each utterance, no length mask (every
// fed frame is valid), and the depthwise over [cache (K - 1 rows) || glu8
// (n rows)] with padding (0, 0), writing the new cache, the last K - 1
// rows of [cache || glu8].  A step has B n rows (4 to 512 at the served
// shapes), far too few for the offline tiling, so it has a kernel of its
// own, conv_block_cached_kernel, one launch a call.  What bounds it on an
// H100 is latency: at B=32, n=4 it must move 0.3 MB of weights and 0.1 MB
// of activations (0.1 us) for 35 M multiply-adds, so the design cuts
// dependent steps and spreads them:
//  - a thread-block cluster of C = d / 64 CTAs takes a tile of 32 rows:
//    the n rows of U = floor(32 / n) whole utterances (fewer where shared
//    memory is short); the grid is one cluster a tile;
//  - CTA q owns output columns [64 q, 64 q + 64) of att_out and pw2, and
//    the same 64 GLU and depthwise channels, so glu8 never leaves its CTA;
//    its slice of the layer (weight rows padded for ldmatrix, its columns
//    of the vectors and scales, its taps, the tables; kernels/
//    conv_block.py::cached_blob) comes in by cp.async.bulk in three parts,
//    each on an mbarrier waited for where it is first read;
//  - 256 threads: warps 0-3 stage c8 and x8 and run att_out while warps
//    4-7 stage the cache columns and build the depthwise windows;
//  - (a) att_out and the j2 join give its x1 columns, pushed into every
//    CTA's x1 tile; (b) the i-LN and the ln affine requant of its share of
//    the tile's rows, a warp a row, pushed into every CTA's yln tile (every
//    row in every CTA measured slower: the i-LN is some 25 integer and
//    FP64 instructions an element); (c) the GLU of its channels (its two
//    64-row chunks on the two warp groups at once) -> glu8 in shared
//    memory; (d) the time-packed dp4a depthwise of its channels over
//    [cache || glu8] of each utterance, BN and the i-swish table -> its
//    mid8 columns, pushed into every CTA; (e) pw2 of its columns (8 warps
//    of 16 x 16) and the j3 join against its x1 columns -> out;
//  - a push is st.async into the peer's shared memory, counted on the
//    peer's mbarrier, which the peer armed with the bytes it expects and
//    waits on: one barrier.cluster in all ("every CTA has started", waited
//    for only before the first push), where barrier.cluster rounds after
//    each push, with the GPU-scope fence of their release, measured ~2x
//    slower; the new cache's global stores are issued while an exchange
//    waits.
// The products stay mma.sync m16n8k32 from ldmatrix (gemm_tile): a tile
// has 32 rows, and wgmma's 64-row tile would waste half of it or more.
// Past 32 new frames an utterance no longer fits a tile; there the C entry
// runs the offline form's two stages over the n frames (conv_block.cu:
// kernels conv_block_cached_stage_{a,b}) and reports which form ran.
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "conformer_int.cuh"
#include "conv_block.cuh"
#include "requant.cuh"
#include "tile_s8.cuh"

// the offline form's entry (conv_block.cu), which runs the staged plan
extern "C" int qasr_conv_block(const int8_t* c8, const int8_t* x8, const int32_t* lens,
                               const int8_t* w_ao, const int8_t* w_ag, const int32_t* dw_p,
                               const int8_t* w_2, const int32_t* vec, const int32_t* sc,
                               const double* mf, const uint8_t* sig_tab,
                               const uint8_t* swish_tab, int8_t* glu8, int8_t* out,
                               const int8_t* cache, int8_t* new_cache, int B, int T, int d,
                               int K, int pad_l, int kc, int n8, void* stream);

namespace {

namespace cg = cooperative_groups;

constexpr int kCh = kChunk;            // columns / channels a CTA owns
constexpr int kThreadsC = 256;         // 8 warps; warps 0-3 run the GEMMs (gemm_tile)
constexpr int kWarpsC = kThreadsC / 32;
constexpr int kLoadPiece = 1 << 15;    // bytes a cp.async.bulk

// A CTA's slice of the layer, host-packed (kernels/conv_block.py::
// cached_blob) and copied into shared memory by bulk copies in three parts,
// each on an mbarrier of its own and waited for where it is first read:
// (A) its w_ao rows (padded to d + 16 bytes), its columns of the 14 int32
// vectors and of the five per-column FP64 scales, the 16 scalars; (B) the
// ln affine's sgn / b / m and FP64 scale whole, its w_ag rows, the GLU
// sigmoid table; (C) its w_2 rows and its packed taps.  Every epilogue
// reads shared memory.
struct BlobLayout {
  int ao, vc, mfc, sc, b, lnv, lnf, ag, sig, c, w2, pw, bytes;
};

__host__ __device__ inline BlobLayout blob_layout(int d, int ngp) {
  BlobLayout l;
  l.ao = 0;
  l.vc = l.ao + kCh * (d + 16);
  l.mfc = l.vc + 14 * kCh * 4;
  l.sc = l.mfc + 5 * kCh * 8;
  l.b = l.sc + 16 * 4;
  l.lnv = l.b;
  l.lnf = l.lnv + 3 * d * 4;
  l.ag = l.lnf + d * 8;
  l.sig = l.ag + 2 * kCh * (d + 16);
  l.c = l.sig + kSigTab;
  l.w2 = l.c;
  l.pw = l.w2 + kCh * (d + 16);
  l.bytes = l.pw + kCh * ngp * 4;
  return l;
}

struct CachedArgs {
  const int8_t* c8;
  const int8_t* x8;
  const int8_t* blob;       // C blobs of blob_layout(d, ngp).bytes
  const uint8_t* swish_tab;
  const int8_t* cache;      // (B, K - 1, d)
  int8_t* out;              // (B, n, d)
  int8_t* new_cache;        // (B, K - 1, d)
  int B, n, d, K, ng, ngp, U, nwu, pitch, n8;
  unsigned div_m;           // qasr_div_make(d), made on the host
  int div_s1, div_s2;
};

// The dynamic shared memory of the cluster form, in bytes from the base:
// the mbarriers, the blob, c8 (then yln) and mid8 tiles, the x1 tile, its
// x8 and glu8 columns, the j2 / j3 tables, the swish table, the
// time-packed depthwise windows and its cache columns.
struct CachedLayout {
  int blob, as, ms, x1, x8, g8, t2, t3, sw, gw, cr, bytes;
};

__host__ __device__ inline CachedLayout cached_layout(int d, int ngp, int U, int pitch,
                                                      int kc) {
  const int lda4 = d + 16;   // a padded row, in bytes
  CachedLayout l;
  int o = 48;                // the six mbarriers first
  l.blob = o;
  o += blob_layout(d, ngp).bytes;
  l.as = o;
  o += kRows * lda4;
  l.ms = o;
  o += kRows * lda4;
  l.x1 = o;
  o += kRows * d;
  l.x8 = o;
  o += kRows * kCh;
  l.g8 = o;
  o += kRows * kCh;
  l.t2 = o;
  o += 256 * 4;
  l.t3 = o;
  o += 256 * 4;
  l.sw = o;
  o += 256;
  l.gw = o;
  o += (kCh * pitch + 8) * 4;
  l.cr = o;
  o += U * kc * kCh;
  l.bytes = o;
  return l;
}

// acc = As (32 x d) . Ws^T (64 x d) for this warp's 16 x 16 part (8 warps:
// 2 row groups x 4 column groups): accumulator (j, r) is row 16 (w >> 2) +
// g + 8 (r >> 1), column 16 (w & 3) + 8 j + 2 t4 + (r & 1)
__device__ __forceinline__ void gemm_tile16(const int* As, const int* Ws, int lda, int d,
                                            int (&acc)[2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3, q = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0;
  // matrix q of A: rows 8 (q & 1), bytes 16 (q >> 1); of B: columns 8 (q >> 1), bytes 16 (q & 1)
  const int* a_row = As + (wr * 16 + rr + 8 * (q & 1)) * lda + 4 * (q >> 1);
  const int* b_row = Ws + (wc * 16 + rr + 8 * (q >> 1)) * lda + 4 * (q & 1);
  for (int kw = 0; kw < d / 4; kw += 8) {
    int a[4], b[4];
    qasr_ldsm4(a, a_row + kw);
    qasr_ldsm4(b, b_row + kw);
    qasr_mma_s8(acc[0], a, b[0], b[1]);
    qasr_mma_s8(acc[1], a, b[2], b[3]);
  }
}

// QasrColRq from shared memory: a column's mantissa m or (kF64) its m 2^-e
template <bool kF64>
struct ColRq {
  QasrRq q;
  double f;
  __device__ __forceinline__ ColRq(const QasrRq& site, int m, double mf) {
    if (kF64)
      f = mf;
    else
      q = qasr_rq_col(site, m);
  }
  __device__ __forceinline__ int operator()(int z) const {
    return kF64 ? qasr_rq_f64(z, f) : qasr_rq(z, q);
  }
};

// The i-LN of x1 rows [lo, hi) and the ln affine requant into A8, a warp
// a row (rows lo + w, lo + w + 8, ...); lnv: ln_sgn, ln_b, ln_m (each d
// int32), lnf: the affine's m 2^-e, dd: qasr_div_make(d)
template <int kP, bool kF64>
__device__ __forceinline__ void ln_rows_cached(const int8_t* X1, int8_t* A8, int lda,
                                               const int* lnv, const double* lnf, int d,
                                               const QasrDiv& dd, const QasrRq& s_ln, int n8,
                                               int lo, int hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = d / 32;
  for (int row = lo + warp; row < hi; row += kWarpsC) {
    int xv[kP], yv[kP];
#pragma unroll
    for (int k = 0; k < kP; ++k) xv[k] = k < per ? X1[row * d + lane + 32 * k] : 0;
    qasr_ln_row_div<kP>(xv, yv, per, d, dd);
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      if (k < per) {
        const int o = lane + 32 * k;
        const int z = lnv[o] * yv[k] + lnv[d + o];
        A8[row * lda * 4 + o] = static_cast<int8_t>(clamp8(
            kF64 ? qasr_rq_f64(z, lnf[o]) : qasr_rq(z, qasr_rq_col(s_ln, lnv[2 * d + o])), n8));
      }
    }
  }
}

// One tile of the stream: see the note at the top ("The cache form").
// kNQ: output quads (4 frames) a depthwise task, 1 (n <= 4) or 4.
template <bool kF64, int kNQ>
__global__ void __launch_bounds__(kThreadsC, 1) conv_block_cached_kernel(const CachedArgs p) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int d = p.d, n = p.n, kc = p.K - 1, lda = d / 4 + 4;
  const int C = d / kCh, rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / C, c0 = rank * kCh;
  const int b0 = tile * p.U, nu = min(p.U, p.B - b0), nrows = nu * n;
  const size_t row0 = static_cast<size_t>(b0) * n;
  const CachedLayout L = cached_layout(d, p.ngp, p.U, p.pitch, kc);
  const BlobLayout BL = blob_layout(d, p.ngp);
  // the blob's parts A, B, C; the x1, yln and mid8 pushed in by the peers
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint8_t* blob = smem + L.blob;
  const int* Wao = reinterpret_cast<const int*>(blob + BL.ao);
  const int* Wag = reinterpret_cast<const int*>(blob + BL.ag);
  const int* W2 = reinterpret_cast<const int*>(blob + BL.w2);
  const int* Vc = reinterpret_cast<const int*>(blob + BL.vc);      // 14 x 64: own columns
  const int* Lnv = reinterpret_cast<const int*>(blob + BL.lnv);    // 3 x d
  const double* Mfc = reinterpret_cast<const double*>(blob + BL.mfc);   // 5 x 64
  const double* Lnf = reinterpret_cast<const double*>(blob + BL.lnf);   // d
  const int* Pw = reinterpret_cast<const int*>(blob + BL.pw);      // 64 x ngp
  const uint8_t* Sig = blob + BL.sig;
  const int* Sc = reinterpret_cast<const int*>(blob + BL.sc);      // 16 scalars
  int* As = reinterpret_cast<int*>(smem + L.as);
  int* Ms = reinterpret_cast<int*>(smem + L.ms);
  int8_t* A8 = reinterpret_cast<int8_t*>(As);
  int8_t* M8 = reinterpret_cast<int8_t*>(Ms);
  int8_t* X1 = reinterpret_cast<int8_t*>(smem + L.x1);
  int8_t* X8 = reinterpret_cast<int8_t*>(smem + L.x8);
  int8_t* G8 = reinterpret_cast<int8_t*>(smem + L.g8);
  int* T2 = reinterpret_cast<int*>(smem + L.t2);
  int* T3 = reinterpret_cast<int*>(smem + L.t3);
  uint8_t* Sw = smem + L.sw;
  int* Gw = reinterpret_cast<int*>(smem + L.gw);
  int8_t* Cr = reinterpret_cast<int8_t*>(smem + L.cr);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wq = warp & 3, wr = wq >> 1, wc = wq & 1;
  const int ht = tid & 127;   // the thread in its half (warps 0-3, 4-7)
  const int8_t* cache_b = p.cache + static_cast<size_t>(b0) * kc * d;
  int8_t* ncache_b = p.new_cache + static_cast<size_t>(b0) * kc * d;
  const int nwu = p.nwu, pitch = p.pitch;

  // six mbarriers, the three exchanges' armed with the bytes the peers will
  // push (the CTA's share of the i-LN's rows is [lo, hi)); then round 0,
  // every CTA of the cluster started with its mbarriers initialized (the
  // fence releases the inits; a peer's bytes may land before the arming,
  // and the phase completes only once the arrival is in too)
  const int share = (nrows + C - 1) / C;
  const int lo = min(rank * share, nrows), hi = min(lo + share, nrows), mine = hi - lo;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) gemm_s8::mbar_init(bar + i, 1);
    gemm_s8::fence_barrier_init();
    const uint32_t cols = static_cast<uint32_t>((C - 1) * nrows * kCh);
    gemm_s8::mbar_expect_tx(bar + 3, cols);
    gemm_s8::mbar_expect_tx(bar + 4, static_cast<uint32_t>((nrows - mine) * d));
    gemm_s8::mbar_expect_tx(bar + 5, cols);
  }
  __syncthreads();
  qasr_cluster_arrive_relaxed();
  // the blob's three parts by bulk copies, each on its mbarrier
  if (tid == 0) {
    const int8_t* src = p.blob + static_cast<size_t>(rank) * BL.bytes;
    const int part[4] = {0, BL.b, BL.c, BL.bytes};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      gemm_s8::mbar_expect_tx(bar + i, static_cast<uint32_t>(part[i + 1] - part[i]));
      for (int o = part[i]; o < part[i + 1]; o += kLoadPiece)
        qasr_bulk_load(blob + o, src + o, min(kLoadPiece, part[i + 1] - o), bar + i);
    }
  }
  if (warp < 4) {
    // warps 0-3: the c8 tile (zero past the tile's rows) and its x8 columns
    // by cp.async, the j2 and j3 tables, then (a) att_out of the CTA's
    // columns + the j2 join -> x1 columns
    const int pr = d / 16, step = 128 / pr, q = ht % pr;
    for (int r = ht / pr; r < kRows; r += step) {
      const bool ok = r < nrows;
      qasr_cp16(As + r * lda + 4 * q, p.c8 + (ok ? (row0 + r) * d + 16 * q : 0), ok ? 16 : 0);
    }
    for (int idx = ht; idx < nrows * (kCh / 16); idx += 128) {
      const int r = idx >> 2, qq = idx & 3;
      qasr_cp16(X8 + r * kCh + 16 * qq, p.x8 + (row0 + r) * d + c0 + 16 * qq, 16);
    }
    qasr_cp_commit();
    gemm_s8::mbar_wait(bar, 0);   // part A
    const QasrRq rq_j2 = qasr_rq_make(Sc[1], Sc[2]), rq_j3 = qasr_rq_make(Sc[14], Sc[15]);
    for (int v = ht; v < 256; v += 128) {
      T2[v] = qasr_rq(v - 128, rq_j2);
      T3[v] = qasr_rq(v - 128, rq_j3);
    }
    qasr_cp_wait<0>();
    gemm_s8::bar_sync(1, 128);
    int acc[4][4];
    gemm_tile(As, Wao, lda, d, acc, wq);
    const QasrRq s_ao = qasr_rq_make(1, Sc[0]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ol = wc * 32 + j * 8 + 2 * t4, o = c0 + ol;
      const int bb0 = Vc[ol], bb1 = Vc[ol + 1];
      const ColRq<kF64> q0(s_ao, Vc[kCh + ol], Mfc[ol]), q1(s_ao, Vc[kCh + ol + 1], Mfc[ol + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wr * 16 + g + 8 * h;
        const short xs = *reinterpret_cast<const short*>(X8 + rl * kCh + ol);
        const int v0 =
            clamp8(q0(acc[j][2 * h] + bb0) + T2[static_cast<int8_t>(xs & 0xff) + 128], p.n8);
        const int v1 =
            clamp8(q1(acc[j][2 * h + 1] + bb1) + T2[static_cast<int8_t>(xs >> 8) + 128], p.n8);
        *reinterpret_cast<short*>(X1 + rl * d + o) = qasr_pack2(v0, v1);
      }
    }
  } else {
    // warps 4-7: its cache columns and the swish table by cp.async, then the
    // depthwise windows' cache frames: word w of utterance u holds frames
    // 4w..4w+3 of [cache || glu8] of the CTA's channel, 0 where the frame
    // is not a cache frame (the glu8 frames are or-ed in at (d))
    for (int idx = ht; idx < nu * kc * (kCh / 16); idx += 128) {
      const int r = idx >> 2, q = idx & 3;   // row r of the tile's (nu x kc) cache rows
      qasr_cp16(Cr + r * kCh + 16 * q, cache_b + static_cast<size_t>(r) * d + c0 + 16 * q, 16);
    }
    if (ht < 16) qasr_cp16(Sw + 16 * ht, p.swish_tab + 16 * ht, 16);
    qasr_cp_commit();
    qasr_cp_wait<0>();
    gemm_s8::bar_sync(2, 128);
    for (int idx = ht; idx < (kCh / 4) * nu * nwu; idx += 128) {
      const int cq = idx & 15, rest = idx >> 4, u = rest / nwu, w = rest - u * nwu;
      unsigned a[4], o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = 4 * w + i;
        a[i] = f < kc ? *reinterpret_cast<const unsigned*>(Cr + (u * kc + f) * kCh + 4 * cq)
                      : 0u;
      }
      qasr_transpose4(a, o);
#pragma unroll
      for (int k = 0; k < 4; ++k) Gw[(4 * cq + k) * pitch + u * nwu + w] = static_cast<int>(o[k]);
    }
  }
  __syncthreads();
  qasr_cluster_wait();   // round 0
  // each exchange: 16 bytes a st.async into the peer, counted on its mbarrier
  auto push = [&](const int8_t* at, int to, uint64_t* b) {
    const uint32_t a = gemm_s8::smem_u32(at);
    qasr_st_async16(qasr_mapa(a, to), *reinterpret_cast<const int4*>(at),
                    qasr_mapa(gemm_s8::smem_u32(b), to));
  };
  for (int idx = tid; idx < (C - 1) * nrows * (kCh / 16); idx += kThreadsC) {
    const int q = idx & 3, rest = idx >> 2, r = rest % nrows, to = (rank + 1 + rest / nrows) % C;
    push(X1 + r * d + c0 + 16 * q, to, bar + 3);
  }
  // while the peers' x1 comes in: the new cache's first rows, the cache
  // frames from n on (global stores)
  for (int idx = tid; idx < nu * max(kc - n, 0) * (kCh / 16); idx += kThreadsC) {
    const int q = idx & 3, rest = idx >> 2, u = rest / (kc - n), r = rest - u * (kc - n);
    *reinterpret_cast<int4*>(ncache_b + (static_cast<size_t>(u) * kc + r) * d + c0 + 16 * q) =
        *reinterpret_cast<const int4*>(Cr + (u * kc + n + r) * kCh + 16 * q);
  }
  gemm_s8::mbar_wait(bar + 3, 0);   // every CTA's x1 columns are in the x1 tile

  // (b) the i-LN and the ln affine requant of the CTA's share of the rows
  // -> A8 (over c8), pushed into every CTA's A8
  gemm_s8::mbar_wait(bar + 1, 0);   // part B
  {
    const QasrRq s_ln = qasr_rq_make(1, Sc[3]);
    QasrDiv dd;
    dd.m = p.div_m;
    dd.s1 = p.div_s1;
    dd.s2 = p.div_s2;
    const int per = d / 32;
    if (per <= 2)
      ln_rows_cached<2, kF64>(X1, A8, lda, Lnv, Lnf, d, dd, s_ln, p.n8, lo, hi);
    else if (per <= 4)
      ln_rows_cached<4, kF64>(X1, A8, lda, Lnv, Lnf, d, dd, s_ln, p.n8, lo, hi);
    else if (per <= 8)
      ln_rows_cached<8, kF64>(X1, A8, lda, Lnv, Lnf, d, dd, s_ln, p.n8, lo, hi);
    else
      ln_rows_cached<kMaxPer, kF64>(X1, A8, lda, Lnv, Lnf, d, dd, s_ln, p.n8, lo, hi);
    __syncthreads();
    const int pcs = d / 16;
    for (int idx = tid; idx < (C - 1) * mine * pcs; idx += kThreadsC) {
      const int q = idx % pcs, rest = idx / pcs, r = lo + rest % mine;
      push(A8 + r * lda * 4 + 16 * q, (rank + 1 + rest / mine) % C, bar + 4);
    }
  }
  gemm_s8::mbar_wait(bar + 4, 0);   // every CTA's yln rows are in A8

  // (c) the GLU of the CTA's 64 channels: w_ag's two 64-row chunks (16
  // a-rows then the matching 16 g-rows, twice), one a warp group at once
  // -> glu8 columns in G8
  {
    const int hc = warp >> 2;
    const QasrRq s_a = qasr_rq_make(1, Sc[4]), s_g = qasr_rq_make(1, Sc[5]);
    const QasrRq rq_glu = qasr_rq_make(Sc[6], Sc[7]);
    const double f_glu = kF64 ? qasr_rq_f64_scale(Sc[6], Sc[7]) : 0.0;
    int acc[4][4];
    gemm_tile(As, Wag + hc * kCh * lda, lda, d, acc, wq);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ol = hc * 32 + wc * 16 + j * 8 + 2 * t4;
      const int ba[2] = {Vc[5 * kCh + ol], Vc[5 * kCh + ol + 1]};
      const int bg[2] = {Vc[7 * kCh + ol], Vc[7 * kCh + ol + 1]};
      const ColRq<kF64> qa[2] = {ColRq<kF64>(s_a, Vc[6 * kCh + ol], Mfc[kCh + ol]),
                                 ColRq<kF64>(s_a, Vc[6 * kCh + ol + 1], Mfc[kCh + ol + 1])};
      const ColRq<kF64> qg[2] = {ColRq<kF64>(s_g, Vc[8 * kCh + ol], Mfc[2 * kCh + ol]),
                                 ColRq<kF64>(s_g, Vc[8 * kCh + ol + 1], Mfc[2 * kCh + ol + 1])};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wr * 16 + g + 8 * h;
        int v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int a8 = clamp8(qa[u](acc[j][2 * h + u] + ba[u]), p.n8);
          const int gg = qg[u](acc[j + 2][2 * h + u] + bg[u]);
          const int y = a8 * qasr_i_sigmoid_tab(Sig, gg);
          v[u] = clamp8(kF64 ? qasr_rq_f64(y, f_glu) : qasr_rq(y, rq_glu), p.n8);
        }
        *reinterpret_cast<short*>(G8 + rl * kCh + ol) = qasr_pack2(v[0], v[1]);
      }
    }
  }
  __syncthreads();

  // (d) the glu8 frames into the windows (words from kc / 4 on), then the
  // depthwise tasks: 4 kNQ consecutive new frames of one channel of one
  // utterance each
  {
    const int wb = kc >> 2, nw2 = nwu - wb;
    for (int idx = tid; idx < (kCh / 4) * nu * nw2; idx += kThreadsC) {
      const int cq = idx & 15, rest = idx >> 4, u = rest / nw2, w = wb + rest - u * nw2;
      unsigned a[4], o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = 4 * w + i - kc;
        a[i] = f >= 0 && f < n
                   ? *reinterpret_cast<const unsigned*>(G8 + (u * n + f) * kCh + 4 * cq)
                   : 0u;
      }
      qasr_transpose4(a, o);
#pragma unroll
      for (int k = 0; k < 4; ++k) Gw[(4 * cq + k) * pitch + u * nwu + w] |= static_cast<int>(o[k]);
    }
  }
  gemm_s8::mbar_wait(bar + 2, 0);   // part C
  __syncthreads();
  {
    const QasrRq s_dw = qasr_rq_make(1, Sc[8]);
    const int nqg = ((n + 3) / 4 + kNQ - 1) / kNQ;   // tasks an utterance and channel
    for (int task = tid; task < kCh * nu * nqg; task += kThreadsC) {
      const int c = task & (kCh - 1), rest = task >> 6, u = rest / nqg, qg = rest - u * nqg;
      const int* xr = Gw + c * pitch + u * nwu + qg * kNQ;
      const int* pr = Pw + c * p.ngp;
      int accd[4 * kNQ];
#pragma unroll
      for (int k = 0; k < 4 * kNQ; ++k) accd[k] = 0;
      int pl = pr[0];
#pragma unroll 3
      for (int gi = 0; gi < p.ng; ++gi) {
        const int pp = pr[gi + 1];
        const int w1 = __funnelshift_l(pl, pp, 8), w2 = __funnelshift_l(pl, pp, 16),
                  w3 = __funnelshift_l(pl, pp, 24);
#pragma unroll
        for (int a = 0; a < kNQ; ++a) {
          const int x = xr[a + gi];
          accd[4 * a] = __dp4a(x, pp, accd[4 * a]);
          accd[4 * a + 1] = __dp4a(x, w1, accd[4 * a + 1]);
          accd[4 * a + 2] = __dp4a(x, w2, accd[4 * a + 2]);
          accd[4 * a + 3] = __dp4a(x, w3, accd[4 * a + 3]);
        }
        pl = pp;
      }
      const int sgn = Vc[9 * kCh + c], bias = Vc[10 * kCh + c];
      const ColRq<kF64> q(s_dw, Vc[11 * kCh + c], Mfc[3 * kCh + c]);
#pragma unroll
      for (int k = 0; k < 4 * kNQ; ++k) {
        const int t = 4 * kNQ * qg + k;
        if (t < n) {
          const int bn = clamp8(q(sgn * accd[k] + bias), p.n8);
          M8[(u * n + t) * lda * 4 + c0 + c] = static_cast<int8_t>(Sw[bn + 128]);
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < (C - 1) * nrows * (kCh / 16); idx += kThreadsC) {
    const int q = idx & 3, rest = idx >> 2, r = rest % nrows, to = (rank + 1 + rest / nrows) % C;
    push(M8 + r * lda * 4 + c0 + 16 * q, to, bar + 5);
  }
  {   // while the peers' mid8 comes in: the new cache's glu8 rows
    const int ng_rows = min(n, kc);   // new-cache rows that come from glu8
    for (int idx = tid; idx < nu * ng_rows * (kCh / 16); idx += kThreadsC) {
      const int q = idx & 3, rest = idx >> 2, u = rest / ng_rows, i = rest - u * ng_rows;
      *reinterpret_cast<int4*>(ncache_b + (static_cast<size_t>(u) * kc + kc - ng_rows + i) * d +
                               c0 + 16 * q) =
          *reinterpret_cast<const int4*>(G8 + (u * n + n - ng_rows + i) * kCh + 16 * q);
    }
  }
  gemm_s8::mbar_wait(bar + 5, 0);   // every CTA's mid8 columns are in the mid8 tile

  // (e) pw2 of the CTA's columns + the j3 join against x1 -> out
  int acc[2][4];
  gemm_tile16(Ms, W2, lda, d, acc);
  const QasrRq s_2 = qasr_rq_make(1, Sc[13]);
  const int wr8 = warp >> 2, wc8 = warp & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ol = wc8 * 16 + j * 8 + 2 * t4, o = c0 + ol;
    const int bb0 = Vc[12 * kCh + ol], bb1 = Vc[12 * kCh + ol + 1];
    const ColRq<kF64> q0(s_2, Vc[13 * kCh + ol], Mfc[4 * kCh + ol]),
        q1(s_2, Vc[13 * kCh + ol + 1], Mfc[4 * kCh + ol + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wr8 * 16 + g + 8 * h;
      if (rl >= nrows) continue;
      const short xs = *reinterpret_cast<const short*>(X1 + rl * d + o);
      *reinterpret_cast<short*>(p.out + (row0 + rl) * d + o) = qasr_pack2(
          clamp8(q0(acc[j][2 * h] + bb0) + T3[static_cast<int8_t>(xs & 0xff) + 128], p.n8),
          clamp8(q1(acc[j][2 * h + 1] + bb1) + T3[static_cast<int8_t>(xs >> 8) + 128], p.n8));
    }
  }
}

// the largest dynamic shared memory for a cluster-form instantiation, set
// once a device (the plan checks each launch's size against it)
cudaError_t allow_cluster_smem(const void* fn) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, bool> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, fn);
  if (done.count(key)) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             gemm_s8::kSmemLimit);
  if (err == cudaSuccess) done[key] = true;
  return err;
}

template <bool kF64, int kNQ>
cudaError_t launch_cached(const CachedArgs& a, int clusters, int C, int smem, cudaStream_t s) {
  cudaError_t err =
      allow_cluster_smem(reinterpret_cast<const void*>(conv_block_cached_kernel<kF64, kNQ>));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t lc = qasr_cluster_launch_config(clusters * C, kThreadsC, C, smem, s,
                                                           &attr);
  err = cudaLaunchKernelEx(&lc, conv_block_cached_kernel<kF64, kNQ>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kF64>
cudaError_t launch_cached_nq(const CachedArgs& a, int nq, int clusters, int C, int smem,
                             cudaStream_t s) {
  return nq == 1 ? launch_cached<kF64, 1>(a, clusters, C, smem, s)
                 : launch_cached<kF64, 4>(a, clusters, C, smem, s);
}

}  // namespace

// The cache form: c8, x8 (B, n, d) int8 of the n new frames, cache (B, K -
// 1, d) the last K - 1 GLU rows -> out (B, n, d) and new_cache (B, K - 1,
// d).  The C entry picks the plan.  The cluster form (one launch) where an
// utterance's n rows fit a 32-row tile: U utterances a tile, the most up
// to 32 / n whose shared memory fits, a cluster of d / 64 CTAs a tile;
// blob holds each CTA's slice of the layer (kernels/conv_block.py::
// cached_blob, blob_layout here), and mf only says whether the per-column
// sites requant on the FP64 pipe.  Else the staged form: the offline
// form's two stages over the n frames (w_ao, w_ag, dw_p, w_2, vec, sc,
// mf, sig_tab and the scratch glu8 (B, n, d) are read only there).
// cfg (host, 4 ints) receives the plan: (1 for the cluster form, 0 for the
// staged one; utterances a tile; clusters; dynamic shared memory bytes a
// CTA), the last three 0 for the staged form.
extern "C" int qasr_conv_block_cached(const int8_t* c8, const int8_t* x8, const int8_t* blob,
                                      const int8_t* w_ao, const int8_t* w_ag,
                                      const int32_t* dw_p, const int8_t* w_2,
                                      const int32_t* vec, const int32_t* sc, const double* mf,
                                      const uint8_t* sig_tab, const uint8_t* swish_tab,
                                      const int8_t* cache, int8_t* new_cache, int8_t* glu8,
                                      int8_t* out, int B, int n, int d, int K, int n8, int* cfg,
                                      void* stream) {
  if (d % kCh != 0 || d > 32 * kMaxPer || K < 2 || n < 1 || B < 1 || cfg == nullptr ||
      blob == nullptr || sig_tab == nullptr || swish_tab == nullptr || cache == nullptr ||
      new_cache == nullptr || glu8 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kc = K - 1, ng = (K + 2) / 4 + 1, ngp = (ng + 1) | 1, C = d / kCh;
  // depthwise tasks of one quad of new frames (n <= 4) or of four
  const int nq4 = (n + 3) / 4, nq = nq4 == 1 ? 1 : 4, nqg = (nq4 + nq - 1) / nq;
  const int nwu = nqg * nq + ng - 1;   // window words an utterance and channel
  int U = n <= kRows ? kRows / n : 0, pitch = 0, smem = 0;
  for (; U >= 1; --U) {
    pitch = (U * nwu) | 1;
    smem = cached_layout(d, ngp, U, pitch, kc).bytes;
    if (smem <= gemm_s8::kSmemLimit) break;
  }
  cfg[0] = U >= 1;
  cfg[1] = U >= 1 ? U : 0;
  cfg[2] = U >= 1 ? (B + U - 1) / U : 0;
  cfg[3] = U >= 1 ? smem : 0;
  if (U < 1)
    return qasr_conv_block(c8, x8, nullptr, w_ao, w_ag, dw_p, w_2, vec, sc, mf, sig_tab,
                           swish_tab, glu8, out, cache, new_cache, B, n, d, K, 0, kc, n8, stream);
  // qasr_div_make(d) on the host: l = ceil(log2 d), m = 2^32 (2^l - d) / d + 1
  int l = 0;
  while ((1u << l) < static_cast<unsigned>(d)) ++l;
  const unsigned dm =
      static_cast<unsigned>((((1ull << l) - static_cast<unsigned>(d)) << 32) / d + 1ull);
  const CachedArgs a = {c8, x8, blob, swish_tab, cache, out, new_cache, B, n, d, K, ng, ngp, U,
                        nwu, pitch, n8, dm, l < 1 ? l : 1, l > 1 ? l - 1 : 0};
  const cudaError_t err = mf ? launch_cached_nq<true>(a, nq, cfg[2], C, smem, s)
                             : launch_cached_nq<false>(a, nq, cfg[2], C, smem, s);
  return static_cast<int>(err);
}
