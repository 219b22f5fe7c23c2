// pw_gemm_grouped: Kernel 2's grouped form, a grouped pointwise (1x1) int8
// conv with GroupShuffle built into its column tiles, the input-requant
// prologue and the none / requant / join epilogues of pw_gemm.cu (whose
// comment states the function; kernels/pw_gemm.py::pw_gemm_plain is the
// plain version).
//
// Replaces no Pallas kernel: the JAX package computes the grouped pointwise
// convs of QuartzNet-style blocks with XLA's grouped_conv1d
// (qasr_tpu/ops/grouped_conv.py:45, from qasr_tpu/models/jasper.py:390-392)
// and GroupShuffle as a reshape (:415).  Ungrouped launches keep pw_gemm.cu.
//
// What bounds it on an H100: bytes, and the integer issue of its requants.
// At QuartzNet15x5-g4's 512 -> 512 in 4 groups (N = 64 x 768 = 49,152
// rows) 25 MB in and 25 MB out (15 us at 3.35 TB/s) against 6.4 G int8
// operations (3 us at 1,979 TOP/s), and 25 M output requants: at qasr_rq's
// ~14 integer instructions that is ~24 us of the SMs' 64 integer lanes, so
// the requants run as qasr_rq_f64 where the host proved their domain
// (grouped.cuh).
//
// Design:
// - A persistent grid (about one block an SM; grid y splits the column
//   tiles into slices only where their weights would not fit).  A block
//   keeps every weight of its slice resident in shared memory for its life:
//   the host packs them once per weight tensor
//   (kernels/pw_gemm.py::pack_grouped) into the 128B-swizzle image the
//   wgmma descriptors read, one column tile after another, and a bulk copy
//   brings them in.
// - Two warpgroup pairs walk the block's row tiles of 64 rows in turns
//   (pair q the block's tiles q, q + 2, ...); each tile's whole Cin
//   arrives by TMA (128B swizzle, 128-byte boxes) into a ring of an even
//   number of stages, stage s serving pair s % 2 and refilled by it once
//   its products of the stage's last tile are done, so a tile's rows are
//   read once for all groups while the other pair's products and epilogue
//   run.  (With an odd ring a pair could wait on a stage's phase one ahead
//   of its last load, which the parity wait takes as done.)  No producer
//   warp: four warpgroups get 128 registers a thread, three warpgroups'
//   worth of threads 168, where the epilogue spilled.  Where the prologue
//   is on, or Cin/G is not a multiple of 32, the pair fills its stage
//   itself, 16 channels a thread at a time, each element requantized once,
//   every group's channels at a 32-byte-aligned offset (Cin/G rounded up to
//   32, the pad zero).
// - A column tile is GroupShuffle's order (grouped.cuh).  Each warpgroup of
//   the pair makes half its products (half its groups, or at one group a
//   tile half its columns): Cin/G / 32 wgmma m64nNk32 steps a group, A
//   from the group's channels of the resident rows, B from its packed
//   weights.  No step multiplies zero padding where Cin/G is a multiple of
//   32, and no group reads another's channels.
// - The pair stages the tile's accumulators in shared memory in its stored
//   order and each warpgroup runs half the epilogue from there
//   (grouped.cuh's staged epilogue: a rolled loop over rows, each thread
//   four consecutive positions, their constants from a table the block
//   builds at its start).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "gemm_s8.cuh"
#include "grouped.cuh"
#include "requant.cuh"

namespace {

using gemm_s8::kChunk;
using grouped::kBN;

constexpr int kBM = 64;                   // rows a row tile
constexpr int kPairs = 2;                 // warpgroup pairs, a row tile each at a time
constexpr int kThreads = 256 * kPairs;    // no producer warp: 128 registers a thread
constexpr int kMaxStages = 4;             // the A ring's deepest (even: stage s serves pair s % 2)
constexpr int kPiece = 16384;             // bytes a weight bulk copy
constexpr int kStLd = 4 * kBN + 16;       // staging row pitch (bytes): a column tile's int32

struct PgParams {
  grouped::Epi epi;
  grouped::Pro pro;
  const void* x;
  const int8_t* wp;       // packed weights (pack_grouped)
  const int32_t* lens;    // the requant epilogue's row mask (by n / rows_per_batch), or NULL
  int n_rows, cin, rows_per_batch, pro_on;
  int cg, cgp;            // Cin/G and Cin/G rounded up to 32 (a group's bytes in A and B)
  int nka;                // 128-byte chunks of the A tile (G * cgp rounded up)
  int nkb;                // 128-byte chunks of a group's packed weights
  int a_tma;              // A by TMA (prologue off, cg % 32 == 0)
  int stages, row_tiles;
  int n_tiles, njt;       // column tiles (G / kGc group chunks x njt) and column tiles a chunk
  int t_per;              // column tiles a slice (grid y)
};

// A block's shared memory (byte offsets from the 1024-aligned base): the
// slice's weights, the A ring, the pairs' staging tiles, the per-position
// constants, the row flags and the mbarriers (w_full, full[S], empty[S]).
struct PgLayout {
  int w, ring, stage, table, keep, bars, bytes;
  __host__ __device__ PgLayout(int t_per, int nkb, int stages, int nka, int cout) {
    w = 0;
    ring = w + t_per * kBN * nkb * kChunk;
    stage = ring + stages * nka * kBM * kChunk;
    table = stage + kPairs * kBM * kStLd;
    keep = table + 16 * cout;
    bars = keep + kPairs * kBM;
    bytes = bars + 8 * (2 * stages + 1) + gemm_s8::kAlign;
  }
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :
      : "r"(gemm_s8::smem_u32(dst)), "l"(src), "r"(bytes), "r"(gemm_s8::smem_u32(bar))
      : "memory");
}

// A row tile's A (64 rows from n0) by the pair's 256 threads (t): group g's
// channels to bytes g * cgp.. of each row, 16 a granule, through the
// prologue where it is on; rows past N or in_len, and each group's pad,
// zero.  The 128B-swizzle layout of gemm_s8.cuh.
__device__ void fill_a(const PgParams& p, uint8_t* a, int n0, int t, const QasrRq& site1,
                       double sc1) {
  const int per = p.nka * (kChunk / 16);   // granules a row
  const int gg = p.cgp / 16, live = p.cg / 16;
  for (int it = t; it < kBM * per; it += 256) {
    const int r = it / per, kp = it - r * per;
    const int n = n0 + r, grp = kp / gg, i = kp - grp * gg;
    int4 word = make_int4(0, 0, 0, 0);
    bool ok = n < p.n_rows && grp < p.epi.groups && i < live;
    if (ok && p.pro_on && p.pro.in_len)
      ok = n % p.rows_per_batch < __ldg(p.pro.in_len + n / p.rows_per_batch);
    if (ok) {
      const int c = grp * p.cg + 16 * i;
      word = grouped::granule(p.pro, p.pro_on, p.x, static_cast<size_t>(n) * p.cin + c, c, site1,
                              sc1);
    }
    *reinterpret_cast<int4*>(a + (kp >> 3) * (kBM * kChunk) + r * kChunk +
                             (((kp & 7) ^ (r & 7)) << 4)) = word;
  }
}

// A warpgroup's half of a column tile: groups kGh (half the tile's kGc) or,
// at kGc = 1, half its columns; its wgmma width and accumulators
template <int kGc>
struct Half {
  static constexpr int kNJ = kBN / kGc;               // a group's columns in the tile
  static constexpr int kGh = kGc >= 2 ? kGc / 2 : 1;  // groups a warpgroup takes
  static constexpr int kNW = kGc >= 2 ? kNJ : kNJ / 2;  // columns a group's wgmma takes
};

// This warpgroup's half (`role`) of a column tile's products: acc[ih] =
// A's group (gc kGc + i) channels times the tile's packed weights of that
// group (w: the tile's image, group i's chunk c at (i nkb + c) kNJ 128
// bytes, column c0 at 128 c0 more), i = role kGh + ih (kGc >= 2), or group
// 0's columns 64 role .. (kGc = 1).
template <int kGc, bool kU8>
__device__ __forceinline__ void products(const PgParams& p,
                                         int (&acc)[Half<kGc>::kGh][Half<kGc>::kNW / 2],
                                         const uint8_t* a, const uint8_t* w, int gc, int role) {
  using namespace gemm_s8;
  using H = Half<kGc>;
  const int steps = p.cgp / 32, c0 = kGc >= 2 ? 0 : role * H::kNW;
  grouped::fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int ih = 0; ih < H::kGh; ++ih) {
    const int i = kGc >= 2 ? role * H::kGh + ih : 0;
    const int kb0 = (gc * kGc + i) * p.cgp;
    for (int s = 0; s < steps; ++s) {
      const int kb = kb0 + 32 * s, kw = 32 * s;
      const uint64_t da = sw128_desc(a + (kb >> 7) * (kBM * kChunk)) + ((kb & 127) >> 4);
      const uint64_t db =
          sw128_desc(w + (i * p.nkb + (kw >> 7)) * (H::kNJ * kChunk) + c0 * kChunk) +
          ((kw & 127) >> 4);
      grouped::Mma<H::kNW, kU8>::ss(acc[ih], da, db, s > 0);   // the first step overwrites
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  grouped::fence_acc(acc);
}

// This warpgroup's half of a column tile's accumulators into the pair's
// staging tile (64 rows x 128 int32) in the tile's stored order: position
// lp holds column c of the tile's group i, lp = c kGc + i with GroupShuffle
// over exactly kGc groups (`run`: a column's kGh groups of this half side
// by side), else lp = i nj + c.
template <int kGc>
__device__ __forceinline__ void stage_half(
    const int (&acc)[Half<kGc>::kGh][Half<kGc>::kNW / 2], uint8_t* st, int w, int lane,
    bool run, int role) {
  using namespace gemm_s8;
  using H = Half<kGc>;
  const int c0 = kGc >= 2 ? 0 : role * H::kNW, i0 = kGc >= 2 ? role * H::kGh : 0;
#pragma unroll
  for (int jj = 0; jj < H::kNW / 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int32_t* row = reinterpret_cast<int32_t*>(st + frag_row(w, lane, h) * kStLd);
      const int c = c0 + frag_col(jj, lane);
      if (run) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          int v[H::kGh];
#pragma unroll
          for (int ih = 0; ih < H::kGh; ++ih) v[ih] = acc[ih][4 * jj + 2 * h + q];
          grouped::store_run<H::kGh>(row + (c + q) * kGc + i0, v);
        }
      } else {
#pragma unroll
        for (int ih = 0; ih < H::kGh; ++ih) {
          const int v[2] = {acc[ih][4 * jj + 2 * h], acc[ih][4 * jj + 2 * h + 1]};
          grouped::store_run<2>(row + (i0 + ih) * H::kNJ + c, v);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// the staged epilogue: a column tile's accumulators in shared memory (int32,
// in its stored order), read back by a rolled loop over rows (an epilogue
// unrolled over the registers was ~19,500 straight-line instructions,
// fetched anew each column tile)
// ---------------------------------------------------------------------------

// The per-position constants of the staged epilogue, by n threads (t): for
// stored position P, (bias, ceiling) of its conv channel and (m, m_r) of P.
__device__ void fill_table(const grouped::Epi& e, int4* table, int t, int n) {
  for (int pos = t; pos < e.cout; pos += n) {
    const int o = e.shuffle ? (pos % e.groups) * e.cog + pos / e.groups : pos;
    table[pos] = make_int4(e.bias ? __ldg(e.bias + o) : 0, e.hcap ? __ldg(e.hcap + o) : e.hs,
                           e.mode != 0 ? __ldg(e.m + pos) : 0,
                           e.mode == 2 ? __ldg(e.m_r + pos) : 0);
  }
}

// One round of the epilogue of a staged column tile of kBN positions: the
// tile's positions 64 r .. 64 r + 63, by 128 threads (t), rolled over rows.
// A tile position lp holds column c of the tile's group i: lp = c kGc + i
// with GroupShuffle over exactly kGc groups (`run`), else lp = i nj + c;
// position lp of staged row `row` is int32 (lp - lp_base) at st + row * ld.
// Thread t takes positions 64 r + 4 (t % 16) .. + 3 (their constants read
// once from `table`) in rows t / 16 + 8 k; output row row0 + row, rows
// below `rows`; keep[row]: not masked (the requant mode).  The row loop is
// kept lean (it issues most of the kernel's instructions): the four values
// go out in one store where they are consecutive in the output and
// aligned, decided once a round, the rows' flags are read once, and the
// output advances by a pointer.  (Eight positions a thread spilled at 128
// registers and ran slower.)
template <int kGc, int kBN, int kMode, bool kF64>
__device__ void round_epilogue(const grouped::Epi& e, const uint8_t* st, int ld, int lp_base,
                               const int4* table, const uint8_t* keep, long long row0, int rows,
                               int gc, int jt, int r, int t, const QasrRq& site,
                               const QasrRq& site_r, double sc, double sc_r) {
  constexpr int kNJ = kBN / kGc;
  constexpr int kEsz = kMode == 0 ? 4 : 1;   // output bytes a value
  const bool run = e.shuffle && e.groups == kGc;
  const int lp0 = 64 * r + 4 * (t & 15), r0 = t >> 4;
  const int cout = e.cout, lo = e.lo, hi = e.hi;
  const int floor0 = e.relu ? 0 : INT_MIN;    // ReLU as a max
  int pos[4], bo[4], co[4];
  grouped::ColM<kF64> mq[4], mr[4];
  bool on[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int lp = lp0 + k;
    const int i = run ? lp % kGc : lp / kNJ, c = run ? lp / kGc : lp % kNJ;
    const int j = jt * kNJ + c, gi = gc * kGc + i;
    on[k] = j < e.cog;
    pos[k] = e.shuffle ? j * e.groups + gi : gi * e.cog + j;
    const int4 cst = on[k] ? table[pos[k]] : make_int4(0, 0, 0, 0);
    bo[k] = cst.x;
    co[k] = cst.y;
    if (kMode != 0) mq[k].set(site, sc, cst.z);
    if (kMode == 2) mr[k].set(site_r, sc_r, cst.w);
  }
  unsigned kept = 0u;   // bit q: row r0 + 8 q is kept
#pragma unroll
  for (int q = 0; q < kBM / 8; ++q)
    kept |= (r0 + 8 * q < rows && keep[r0 + 8 * q] != 0 ? 1u : 0u) << q;
  // one store of the four values where consecutive and aligned in every row
  // (rows 8 apart: 8 Cout values, a multiple of the four's bytes)
  char* out = static_cast<char*>(e.out) + ((row0 + r0) * cout + pos[0]) * kEsz;
  const int32_t* res = kMode == 2 ? e.res + (row0 + r0) * cout : nullptr;
  const bool vec = on[3] && (run || !e.shuffle) &&
                   reinterpret_cast<uintptr_t>(out) % (4 * kEsz) == 0 &&
                   (kMode != 2 || reinterpret_cast<uintptr_t>(res + pos[0]) % 16 == 0);
  const long long step = 8LL * cout;             // values between this thread's rows
  const uint8_t* sa = st + r0 * ld + 4 * (lp0 - lp_base);
#pragma unroll 4
  for (int q = 0; q < kBM / 8; ++q) {
    if (r0 + 8 * q >= rows) break;
    const int4 a4 = *reinterpret_cast<const int4*>(sa + q * 8 * ld);
    const int a[4] = {a4.x, a4.y, a4.z, a4.w};
    int rv[4] = {0, 0, 0, 0};
    if (kMode == 2) {
      const int32_t* rp = res + q * step;
      if (vec) {
        const int4 u = __ldg(reinterpret_cast<const int4*>(rp + pos[0]));
        rv[0] = u.x, rv[1] = u.y, rv[2] = u.z, rv[3] = u.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) rv[k] = on[k] ? __ldg(rp + pos[k]) : 0;
      }
    }
    const bool kk = (kept >> q) & 1u;
    int y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = a[k] + bo[k];
      if constexpr (kMode == 0) {
        y[k] = min(max(v, floor0), co[k]);
      } else if constexpr (kMode == 1) {
        const int u = kk ? min(max(v, floor0), co[k]) : 0;
        y[k] = min(max(mq[k](site, u), lo), hi);
      } else {
        y[k] = min(max(mq[k](site, v) + mr[k](site_r, rv[k]), lo), hi);
      }
    }
    char* o = out + q * step * kEsz;
    if (vec) {
      if constexpr (kMode == 0)
        *reinterpret_cast<int4*>(o) = make_int4(y[0], y[1], y[2], y[3]);
      else
        *reinterpret_cast<unsigned*>(o) = __byte_perm(__byte_perm(y[0], y[1], 0x0040),
                                                      __byte_perm(y[2], y[3], 0x0040), 0x5410);
    } else {
      char* row = o - static_cast<long long>(pos[0]) * kEsz;   // the row's start
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!on[k]) continue;
        if constexpr (kMode == 0)
          reinterpret_cast<int32_t*>(row)[pos[k]] = y[k];
        else
          reinterpret_cast<int8_t*>(row)[pos[k]] = static_cast<int8_t>(y[k]);
      }
    }
  }
}

// round_epilogue in the site's mode, on the FP64 pipe where the host proved
// it (the join only where both its requants were proven: f64)
template <int kGc, int kBN>
__device__ __forceinline__ void staged_epilogue(const grouped::Epi& e, const uint8_t* st, int ld,
                                                int lp_base, const int4* table,
                                                const uint8_t* keep, long long row0, int rows,
                                                int gc, int jt, int r, int t, const QasrRq& site,
                                                const QasrRq& site_r, double sc, double sc_r) {
#define QASR_G_EPI(M, F)                                                                      \
  round_epilogue<kGc, kBN, M, F>(e, st, ld, lp_base, table, keep, row0, rows, gc, jt, r, t, \
                                 site, site_r, sc, sc_r)
  if (e.mode == 0)
    QASR_G_EPI(0, false);
  else if (e.mode == 1 && e.f64)
    QASR_G_EPI(1, true);
  else if (e.mode == 1)
    QASR_G_EPI(1, false);
  else if (e.f64)
    QASR_G_EPI(2, true);
  else
    QASR_G_EPI(2, false);
#undef QASR_G_EPI
}

// The block's k-th row tile's A into ring stage k % stages by TMA (k past
// the block's tiles: nothing)
__device__ __forceinline__ void load_a(const PgParams& p, const CUtensorMap* map, uint8_t* ring,
                                       uint64_t* full, int k) {
  using namespace gemm_s8;
  const int tile = blockIdx.x + k * gridDim.x;
  if (tile >= p.row_tiles) return;
  const int s = k % p.stages, abytes = p.nka * kBM * kChunk;
  mbar_expect_tx(full + s, abytes);
  for (int c = 0; c < p.nka; ++c)
    tma_load_2d(ring + s * abytes + c * (kBM * kChunk), map, full + s, c * kChunk, tile * kBM);
}

template <int kGc, bool kU8>
__global__ void __launch_bounds__(kThreads, 1)
pw_gemm_grouped_kernel(const __grid_constant__ CUtensorMap map_x, const PgParams p) {
  using namespace gemm_s8;
  using H = Half<kGc>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const PgLayout L(p.t_per, p.nkb, p.stages, p.nka, p.epi.cout);
  const int tb = kBN * p.nkb * kChunk;
  const int t0 = blockIdx.y * p.t_per, t1 = min(p.n_tiles, t0 + p.t_per);
  const int abytes = p.nka * kBM * kChunk;
  uint8_t* wts = smem + L.w;                    // the slice's weights, resident
  uint8_t* ring = smem + L.ring;                // the A stages
  const int4* table = reinterpret_cast<const int4*>(smem + L.table);
  uint64_t* w_full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* full = w_full + 1;
  uint64_t* empty = full + p.stages;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);   // warp-uniform for the compiler
  const int pair = wg >> 1, role = wg & 1, w = (tid >> 5) & 3, t = tid & 127, pt = tid & 255;
  if (tid == 0) {
    mbar_init(w_full, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);   // the pair's warps
    }
    fence_barrier_init();
  }
  fill_table(p.epi, reinterpret_cast<int4*>(smem + L.table), tid, kThreads);
  __syncthreads();
  if (tid == 0) {   // the weights, and the first stages' A by TMA
    const int wbytes = (t1 - t0) * tb;
    mbar_expect_tx(w_full, wbytes);
    for (int off = 0; off < wbytes; off += kPiece)
      bulk_load(wts + off, p.wp + static_cast<size_t>(t0) * tb + off, min(kPiece, wbytes - off),
                w_full);
    if (p.a_tma)
      for (int k = 0; k < p.stages; ++k) load_a(p, &map_x, ring, full, k);
  }

  // pair takes the block's row tiles pair, pair + 2, ..; of each column tile
  // its warpgroups make half the products each and run half the epilogue
  uint8_t* st = smem + L.stage + pair * (kBM * kStLd);
  uint8_t* keep = smem + L.keep + pair * kBM;
  const QasrRq site = qasr_rq_make(1, p.epi.e), site_r = qasr_rq_make(1, p.epi.e_r);
  const QasrRq site1 = qasr_rq_make(1, p.pro.e1);
  const double sc = scalbn(1.0, -p.epi.e), sc_r = scalbn(1.0, -p.epi.e_r);
  const double sc1 = scalbn(1.0, -p.pro.e1);
  const bool run = p.epi.shuffle && p.epi.groups == kGc;
  mbar_wait(w_full, 0);
  for (int k = pair;; k += kPairs) {
    const int tile = blockIdx.x + k * gridDim.x;
    if (tile >= p.row_tiles) break;
    const int s = k % p.stages, u = k / p.stages, n0 = tile * kBM;
    uint8_t* a = ring + s * abytes;
    if (p.a_tma) {
      mbar_wait(full + s, u & 1);
    } else {   // the stage's last products are done
      if (u > 0) mbar_wait(empty + s, (u - 1) & 1);
      fill_a(p, a, n0, pt, site1, sc1);
      fence_proxy_async();
    }
    if (pt < kBM) {   // each row's flag, once a tile
      const int n = n0 + pt;
      keep[pt] = n < p.n_rows && (p.lens == nullptr ||
                                  n % p.rows_per_batch < __ldg(p.lens + n / p.rows_per_batch));
    }
    bar_sync(1 + pair, 256);
    for (int tt = t0; tt < t1; ++tt) {
      const int gc = tt / p.njt, jt = tt - gc * p.njt;
      const bool last = tt + 1 == t1;   // A is free after these products
      {
        int acc[H::kGh][H::kNW / 2];
        products<kGc, kU8>(p, acc, a, wts + (tt - t0) * tb, gc, role);
        if (last && !p.a_tma && lane == 0) mbar_arrive(empty + s);
        stage_half<kGc>(acc, st, w, lane, run, role);
      }
      bar_sync(1 + pair, 256);
      // every warp's products of this row tile are done: its stage takes the
      // block's tile k + stages (the pair's own next but stages / 2)
      if (last && p.a_tma && pt == 0) load_a(p, &map_x, ring, full, k + p.stages);
      staged_epilogue<kGc, kBN>(p.epi, st, kStLd, 0, table, keep, n0, min(kBM, p.n_rows - n0),
                                gc, jt, role, t, site, site_r, sc, sc_r);
      bar_sync(1 + pair, 256);   // the staging tile is free
    }
  }
}

template <int kGc, bool kU8>
cudaError_t launch(const CUtensorMap& mx, const PgParams& p, dim3 grid, int smem,
                   cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      pw_gemm_grouped_kernel<kGc, kU8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gemm_s8::kSmemLimit);
  if (attr != cudaSuccess) return attr;
  pw_gemm_grouped_kernel<kGc, kU8><<<grid, kThreads, smem, stream>>>(mx, p);
  return cudaGetLastError();
}

template <bool kU8>
cudaError_t launch_gc(int kgc, const CUtensorMap& mx, const PgParams& p, dim3 grid, int smem,
                      cudaStream_t stream) {
  switch (kgc) {
    case 1: return launch<1, kU8>(mx, p, grid, smem, stream);
    case 2: return launch<2, kU8>(mx, p, grid, smem, stream);
    case 4: return launch<4, kU8>(mx, p, grid, smem, stream);
    case 8: return launch<8, kU8>(mx, p, grid, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The plan's numbers come from the wrapper (kernels/pw_gemm.py::
// grouped_plan: kgc the groups a column tile takes, t_per the column tiles
// a slice, stages the A ring's, grid_x the row walkers); the entry derives
// the rest, checks them and the shared memory, and refuses what does not
// fit.  wp: the weights packed by pack_grouped for (groups, kgc).  f64 /
// f64_1: the epilogue's (the join's both) / the prologue's requants proven
// for the FP64 pipe.
extern "C" int qasr_pw_gemm_grouped(const void* x, const int8_t* wp, const int32_t* bias,
                                    const int32_t* m, const int32_t* lens, const int32_t* res,
                                    const int32_t* m_r, void* out, int n_rows, int cin, int cout,
                                    int rows_per_batch, int mode, int relu, int e, int e_r,
                                    int lo, int hi, int pro, int x32, const int32_t* in_bias,
                                    int in_relu, const int32_t* in_len, const int32_t* m1,
                                    int m1s, int e1, int lo1, int hi1, int u8, int groups,
                                    int shuffle, const int32_t* hcap, int hs,
                                    const int32_t* in_hcap, int in_hs, int kgc, int t_per,
                                    int stages, int grid_x, int f64, int f64_1, void* stream) {
  if (groups < 2 || cin % groups != 0 || cout % groups != 0 || kgc < 1 || groups % kgc != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cg = cin / groups, cog = cout / groups;
  const int cgp = (cg + 31) / 32 * 32, nkb = (cgp + kChunk - 1) / kChunk;
  const int nka = (groups * cgp + kChunk - 1) / kChunk;
  const int njt = (cog + kBN / kgc - 1) / (kBN / kgc), n_tiles = groups / kgc * njt;
  const int row_tiles = (n_rows + kBM - 1) / kBM;
  const long long smem = t_per > 0 && t_per <= n_tiles && stages <= kMaxStages
                             ? PgLayout(t_per, nkb, stages, nka, cout).bytes : LLONG_MAX;
  if (n_rows < 1 || cg < 16 || cg % 16 != 0 || mode < 0 || mode > 2 || (!pro && x32) ||
      t_per < 1 || stages < 2 || stages > kMaxStages || stages % 2 != 0 || grid_x < 1 ||
      smem > gemm_s8::kSmemLimit || (n_tiles + t_per - 1) / t_per > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool a_tma = !pro && cg % 32 == 0;
  CUtensorMap mx{};
  if (a_tma && !gemm_s8::make_map(&mx, x, n_rows, cin, kBM))
    return static_cast<int>(cudaErrorInvalidValue);
  PgParams p{};
  p.epi = grouped::Epi{bias, m, res, m_r, out, hcap, hs, cout, cog, groups, shuffle, mode, relu,
                       e, e_r, lo, hi, f64};
  p.pro = grouped::Pro{in_bias, in_relu, in_len, m1, m1s, e1, lo1, hi1, in_hcap, in_hs, x32, f64_1};
  p.x = x;
  p.wp = wp;
  p.lens = mode == 1 ? lens : nullptr;
  p.n_rows = n_rows;
  p.cin = cin;
  p.rows_per_batch = rows_per_batch;
  p.pro_on = pro;
  p.cg = cg;
  p.cgp = cgp;
  p.nka = nka;
  p.nkb = nkb;
  p.a_tma = a_tma;
  p.stages = stages;
  p.row_tiles = row_tiles;
  p.n_tiles = n_tiles;
  p.njt = njt;
  p.t_per = t_per;
  const dim3 grid(grid_x < row_tiles ? grid_x : row_tiles, (n_tiles + t_per - 1) / t_per);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = u8 ? launch_gc<true>(kgc, mx, p, grid, static_cast<int>(smem), st)
                            : launch_gc<false>(kgc, mx, p, grid, static_cast<int>(smem), st);
  return static_cast<int>(rc);
}
