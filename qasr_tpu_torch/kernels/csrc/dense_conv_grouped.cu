// dense_conv_grouped: Kernel 8's grouped form, a grouped integer 1-D conv
// over (B, T, Cin) as an implicit GEMM with GroupShuffle built into its
// column tiles, the input-requant prologue and the none / requant / join
// epilogues of dense_conv.cu (whose comment states the function;
// kernels/dense_conv.py::dense_conv_plain is the plain version), w (Cout,
// K, Cin/G).
//
// Replaces no Pallas kernel: the JAX package leaves grouped convs to XLA's
// grouped integer conv (qasr_tpu/ops/grouped_conv.py, inside conv_nwc,
// qasr_tpu/models/jasper.py:332).  Ungrouped launches keep dense_conv.cu.
//
// What bounds it on an H100: the operations.  The Jasper-width grouped
// block's conv (C 768, K 25, 4 groups) at B=64 x 15 s is 49,152 rows x 25 x
// 192 x 768 multiply-adds, 0.18 ms at 1,979 TOP/s, against ~75 MB of
// activations (0.02 ms at 3.35 TB/s).  Every block reads the whole weight
// tensor from L2 (K Cin/G Cout bytes, 3.7 MB there): 128 multiply-adds a
// byte, as the dense kernel.  A wgmma of width N reads its 64 x 32 A bytes
// and N x 32 B bytes from shared memory, 96 + 2,048 / N bytes a clock at the
// tensor cores' rate: the widest tile the registers hold (192 positions, N
// = 48 a group at 4 groups) keeps that near the 128 bytes a clock shared
// memory gives.
//
// Design (dense_conv.cu's shape, its Cout tiles replaced by column tiles in
// GroupShuffle's order, A read from shared memory):
// - A block owns 128 output frames of one batch element and keeps their
//   input rows and halo, (128 - 1) s + (K - 1) d + 1 rows of the full Cin,
//   resident (each element through the prologue once) in wgmma's canonical
//   K-major layout without swizzle: 16-byte column chunks of consecutive
//   rows, so that any (tap x dilation) row shift is a descriptor's start
//   address (the rows of a stride's phases apart); an odd count of rows a
//   chunk keeps the fill's stores off one bank, and three zero chunks past
//   Cin take a K step's overrun.
// - Its column tiles (grid z splits them into slices where the blocks
//   would leave SMs idle) are GroupShuffle's (grouped.cuh): kGc groups x
//   192 / kGc columns.  A K step is one tap and 64 bytes of each group's
//   channels.  The host packs the weights once per weight tensor
//   (kernels/dense_conv.py::pack_grouped) into one contiguous 12 KB image a
//   step, each group's 192 / kGc rows x 64 bytes in the 64B swizzle that
//   the wgmma descriptors read, zero past Cin/G and Cout/G, so that one
//   bulk copy a step (a producer thread, an mbarrier ring) feeds it: a TMA
//   box a group (48 rows of 64 bytes) moved half the bytes a clock that
//   the dense kernel's 128-byte rows do.  A group width that is not a
//   multiple of 64 reads the next group's channels, or the zero chunks,
//   times those zero weights; with Cin/G a multiple of 64 (the block's 192)
//   no step multiplies padding.
// - Two consumer warpgroups own 64 frames each and issue, for each group
//   of a step, two wgmma m64nNk32 (N = 192 / kGc), both operands from
//   shared memory; one step's wgmma group stays in flight while the next
//   is issued.  A producer warpgroup's first thread keeps the ring full.
//   (Three warpgroups get 168 registers a thread, where the register
//   epilogue spills some; feeding the ring from a consumer thread instead,
//   for 255 registers, made one warpgroup wait on the other each step or
//   made ptxas wait for wgmma mid-step (C7517), both slower.)
// - The epilogue runs from the accumulator registers and stores each row's
//   2 G shuffled positions of a column pair at once; staging it in shared
//   memory cut the ring to 4 stages and ran slower.
#include <climits>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "gemm_s8.cuh"
#include "grouped.cuh"
#include "requant.cuh"
#include "tile_s8.cuh"

namespace dcg {

constexpr int kBN = 192;                    // positions a column tile covers
constexpr int kKS = 64;                     // bytes of a group's Cin a K step takes
constexpr int kStage = kBN * kKS;           // a ring stage: the tile's packed K step
constexpr int kBM = 128;                    // output frames per block
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one thread loads)
constexpr int kMaxStages = 8;
constexpr int kPad16 = 3;                   // zero 16-byte chunks past Cin: a K step's overrun

struct DgParams {
  grouped::Epi epi;
  grouped::Pro pro;
  const void* x;
  const int8_t* wp;      // packed weights (pack_grouped): a kStage image a K step
  const int32_t* lens;   // the requant epilogue's frame mask, or NULL
  int t_in, cin, t_out, k_size, stride, pad, dil;
  int pro_on, cg, cog;
  int nks;       // K steps a tap: Cin/G over 64 bytes, rounded up
  int rows_h;    // resident rows (output tile + halo)
  int nk16;      // 16-byte chunks of a resident row: Cin / 16 + kPad16
  int rpp;       // rows a phase's chunk holds (odd)
  int stages;    // the weight ring's
  int t_per;     // column tiles a grid-z slice
  int n_tiles, njt;
};

}  // namespace dcg

namespace {

using namespace dcg;

// A block's shared memory (byte offsets from the 1024-aligned base): the
// weight ring, the resident rows (stride phases of nk16 chunks of rpp rows
// x 16 bytes) and the mbarriers (full[S], empty[S]).
struct DgLayout {
  int ring, a, bars, bytes;
  __host__ __device__ DgLayout(int stages, int stride, int nk16, int rpp) {
    ring = 0;
    a = ring + stages * kStage;
    bars = a + stride * nk16 * rpp * 16;
    bytes = bars + 16 * stages + gemm_s8::kAlign;
  }
};

// `bytes` (a multiple of 16) from global src to shared dst, counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :
      : "r"(gemm_s8::smem_u32(dst)), "l"(src), "r"(bytes), "r"(gemm_s8::smem_u32(bar))
      : "memory");
}

// The block's resident rows: halo row h (input frame base + h of batch b),
// chunk c16 (channels 16 c16 ..) at phase h % stride, chunk c16, row h /
// stride; zero outside [0, t_in), past in_len with the prologue, and past
// Cin.  All kThreads threads.
__device__ void fill_a(const DgParams& p, uint8_t* a_tile, int b, int base, const QasrRq& site1,
                       double sc1) {
  const int live = p.cin / 16, phase = p.nk16 * p.rpp * 16;
  const int ilen = p.pro_on && p.pro.in_len ? __ldg(p.pro.in_len + b) : INT_MAX;
  const size_t xrow = static_cast<size_t>(b) * p.t_in;
  for (int it = threadIdx.x; it < p.rows_h * p.nk16; it += kThreads) {
    const int h = it / p.nk16, g = it - h * p.nk16;
    const int t = base + h;
    uint8_t* dst = a_tile + (h % p.stride) * phase + g * (p.rpp * 16) + (h / p.stride) * 16;
    const bool on = g < live && t >= 0 && t < p.t_in && t < ilen;
    const size_t off = (xrow + (on ? t : 0)) * p.cin + 16 * (on ? g : 0);
    if (!p.pro_on) {
      qasr_cp16(dst, static_cast<const int8_t*>(p.x) + off, on ? 16 : 0);
      continue;
    }
    *reinterpret_cast<int4*>(dst) =
        on ? grouped::granule(p.pro, true, p.x, off, 16 * g, site1, sc1) : make_int4(0, 0, 0, 0);
  }
  qasr_cp_commit();
}

// wgmma descriptor of the resident rows from `p` (K-major, no swizzle: 8
// rows x 16 bytes a core matrix; the next 16 bytes of K rpp rows further,
// the next 8 rows 128 bytes further)
__device__ __forceinline__ uint64_t rows_desc(const void* ptr, int rpp) {
  return static_cast<uint64_t>((gemm_s8::smem_u32(ptr) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(rpp) << 16) | (static_cast<uint64_t>(128 >> 4) << 32);
}

// ---------------------------------------------------------------------------
// the epilogue from the accumulator registers (the shared memory holds the
// halo rows and the weight ring; staging there cost more ring than it saved)
// ---------------------------------------------------------------------------

// One column tile's epilogue from a warp's accumulator registers.  acc[i]
// is group gc0 + i's m64nNk32 fragment (N = kNJ): this thread holds rows
// r_h = 16 w + lane / 4 + 8 h (h = 0, 1) and columns j0 + 8 jj + 2 (lane %
// 4) + q (q = 0, 1) in acc[i][4 jj + 2 h + q].  row[h] is r_h's output
// offset (its row index times Cout), or -1 past the output's rows; keep[h]
// false zeroes r_h in the requant mode (a masked frame).  Columns j >= Cout/G
// (a ragged last tile) are not stored.  With GroupShuffle over exactly kGc
// groups a column pair's 2 kGc positions are consecutive: (j + q) G + i.
template <int kGc, int kNJ, int kMode, bool kF64>
__device__ __forceinline__ void epilogue(const grouped::Epi& p, const int (&acc)[kGc][kNJ / 2],
                                         int gc0, int j0, int lane, const long long (&row)[2],
                                         const bool (&keep)[2], const QasrRq& site,
                                         const QasrRq& site_r, double sc, double sc_r) {
  const bool run = p.shuffle && p.groups == kGc;
#pragma unroll
  for (int jj = 0; jj < kNJ / 8; ++jj) {
    const int j = j0 + 8 * jj + 2 * (lane & 3);
    if (j >= p.cog) break;
    const bool two = j + 1 < p.cog;
    int pos[2][kGc], bo[2][kGc], co[2][kGc];
    grouped::ColM<kF64> mq[2][kGc], mr[2][kGc];
#pragma unroll
    for (int i = 0; i < kGc; ++i) {
      const int o = (gc0 + i) * p.cog + j;
      int b2[2] = {0, 0}, c2[2] = {p.hs, p.hs};
      if (two) {
        if (p.bias) grouped::load_run<2>(p.bias + o, b2);
        if (p.hcap) grouped::load_run<2>(p.hcap + o, c2);
      } else {
        if (p.bias) b2[0] = __ldg(p.bias + o);
        if (p.hcap) c2[0] = __ldg(p.hcap + o);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        pos[q][i] = p.shuffle ? (j + q) * p.groups + gc0 + i : o + q;
        bo[q][i] = b2[q];
        co[q][i] = c2[q];
      }
    }
    if (kMode != 0) {
      int mv[2 * kGc], mrv[2 * kGc];
      if (run && two) {
        grouped::load_run<2 * kGc>(p.m + pos[0][0], mv);
        if (kMode == 2) grouped::load_run<2 * kGc>(p.m_r + pos[0][0], mrv);
      } else {
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < kGc; ++i) {
            const bool on = q == 0 || two;
            mv[q * kGc + i] = on ? __ldg(p.m + pos[q][i]) : 0;
            if (kMode == 2) mrv[q * kGc + i] = on ? __ldg(p.m_r + pos[q][i]) : 0;
          }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int i = 0; i < kGc; ++i) {
          mq[q][i].set(site, sc, mv[q * kGc + i]);
          if (kMode == 2) mr[q][i].set(site_r, sc_r, mrv[q * kGc + i]);
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] < 0) continue;
      int rv[2 * kGc];
      if (kMode == 2) {
        if (run && two) {
          grouped::load_run<2 * kGc>(p.res + row[h] + pos[0][0], rv);
        } else {
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int i = 0; i < kGc; ++i)
              rv[q * kGc + i] = (q == 0 || two) ? __ldg(p.res + row[h] + pos[q][i]) : 0;
        }
      }
      int y[2 * kGc];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int i = 0; i < kGc; ++i) {
          int v = acc[i][4 * jj + 2 * h + q] + bo[q][i];
          int& out = y[q * kGc + i];
          if constexpr (kMode == 0) {
            out = min(p.relu && v < 0 ? 0 : v, co[q][i]);
          } else if constexpr (kMode == 1) {
            if (p.relu) v = v > 0 ? v : 0;
            v = min(v, co[q][i]);
            if (!keep[h]) v = 0;
            out = qasr_clamp(mq[q][i](site, v), p.lo, p.hi);
          } else {
            out = qasr_clamp(mq[q][i](site, v) + mr[q][i](site_r, rv[q * kGc + i]), p.lo, p.hi);
          }
        }
      if constexpr (kMode == 0) {
        int32_t* dst = static_cast<int32_t*>(p.out) + row[h];
        if (run && two) {
          grouped::store_run<2 * kGc>(dst + pos[0][0], y);
        } else {
#pragma unroll
          for (int i = 0; i < kGc; ++i) {
            if (!p.shuffle && two) {
              const int y2[2] = {y[i], y[kGc + i]};
              grouped::store_run<2>(dst + pos[0][i], y2);
            } else {
              dst[pos[0][i]] = y[i];
              if (two) dst[pos[1][i]] = y[kGc + i];
            }
          }
        }
      } else {
        int8_t* dst = static_cast<int8_t*>(p.out) + row[h];
        if (run && two) {
          grouped::store_run<2 * kGc>(dst + pos[0][0], y);
        } else {
#pragma unroll
          for (int i = 0; i < kGc; ++i) {
            if (!p.shuffle && two) {
              const int y2[2] = {y[i], y[kGc + i]};
              grouped::store_run<2>(dst + pos[0][i], y2);
            } else {
              dst[pos[0][i]] = static_cast<int8_t>(y[i]);
              if (two) dst[pos[1][i]] = static_cast<int8_t>(y[kGc + i]);
            }
          }
        }
      }
    }
  }
}

// The register epilogue in the site's mode, on the FP64 pipe where the host
// proved it (the join only where both its requants were proven: f64).
template <int kGc, int kNJ>
__device__ __forceinline__ void epilogue_any(const grouped::Epi& p,
                                             const int (&acc)[kGc][kNJ / 2], int gc0, int j0,
                                             int lane, const long long (&row)[2],
                                             const bool (&keep)[2], const QasrRq& site,
                                             const QasrRq& site_r, double sc, double sc_r) {
  if (p.mode == 0)
    epilogue<kGc, kNJ, 0, false>(p, acc, gc0, j0, lane, row, keep, site, site_r, sc, sc_r);
  else if (p.mode == 1 && p.f64)
    epilogue<kGc, kNJ, 1, true>(p, acc, gc0, j0, lane, row, keep, site, site_r, sc, sc_r);
  else if (p.mode == 1)
    epilogue<kGc, kNJ, 1, false>(p, acc, gc0, j0, lane, row, keep, site, site_r, sc, sc_r);
  else if (p.f64)
    epilogue<kGc, kNJ, 2, true>(p, acc, gc0, j0, lane, row, keep, site, site_r, sc, sc_r);
  else
    epilogue<kGc, kNJ, 2, false>(p, acc, gc0, j0, lane, row, keep, site, site_r, sc, sc_r);
}

// The producer thread's next weight load: its number, (tile, tap, K step),
// ring stage and phase.
struct Producer {
  int issued, tile, tap, c, s, ph;
};

// The next K step's packed weights into its ring stage by one bulk copy,
// once the stage's last use has been released by the eight consumer warps
// (`wait`).
__device__ __forceinline__ void load_w(const DgParams& p, uint8_t* ring, uint64_t* full,
                                       uint64_t* empty, Producer& pr, bool wait) {
  using namespace gemm_s8;
  if (wait) mbar_wait(empty + pr.s, pr.ph ^ 1);
  mbar_expect_tx(full + pr.s, kStage);
  bulk_load(ring + pr.s * kStage,
            p.wp + ((static_cast<size_t>(pr.tile) * p.k_size + pr.tap) * p.nks + pr.c) * kStage,
            kStage, full + pr.s);
  if (++pr.c == p.nks) {
    pr.c = 0;
    if (++pr.tap == p.k_size) {
      pr.tap = 0;
      ++pr.tile;
    }
  }
  ++pr.issued;
  if (++pr.s == p.stages) {
    pr.s = 0;
    pr.ph ^= 1;
  }
}

// A consumer warp's ring position: its stage and phase, the stage whose
// products are still in flight (-1: none), and wgmma's scale-d for a
// group's first product of a tile (0: overwrite).
struct Pipe {
  int s, ph, pend, scale;
};

// One K step of a consumer warpgroup: wait for the stage, issue each
// group's two k32 products (A from the resident rows at descriptor `da`,
// the group's channels cg bytes apart), and retire the previous step's
// group, releasing its stage.
template <int kGc, bool kU8>
__device__ __forceinline__ void consume(const DgParams& p, const uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, int lane, Pipe& q,
                                        int (&acc)[kGc][kBN / kGc / 2], uint64_t da) {
  using namespace gemm_s8;
  constexpr int kNJ = kBN / kGc;
  mbar_wait(full + q.s, q.ph);
  const uint8_t* stage = ring + q.s * kStage;
  grouped::fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int i = 0; i < kGc; ++i) {
    const uint64_t db = grouped::sw64_desc(stage + i * (kNJ * kKS));
    const uint64_t dai = da + ((i * p.cg * p.rpp) >> 4);
#pragma unroll
    for (int k = 0; k < kKS / 32; ++k)
      grouped::Mma<kNJ, kU8>::ss(acc[i], dai + ((32 * k * p.rpp) >> 4), db + 2 * k,
                                 k == 0 ? q.scale : 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  if (q.pend >= 0 && lane == 0) mbar_arrive(empty + q.pend);
  q.pend = q.s;
  if (++q.s == p.stages) {
    q.s = 0;
    q.ph ^= 1;
  }
  q.scale = 1;
}

template <int kGc, bool kU8>
__global__ void __launch_bounds__(kThreads, 1)
dense_conv_grouped_kernel(const DgParams p) {
  using namespace gemm_s8;
  constexpr int kNJ = kBN / kGc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const DgLayout L(p.stages, p.stride, p.nk16, p.rpp);
  uint8_t* ring = smem + L.ring;
  uint8_t* a_tile = smem + L.a;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + p.stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, t0 = blockIdx.x * kBM;
  const int ct0 = blockIdx.z * p.t_per, ct1 = min(p.n_tiles, ct0 + p.t_per);
  if (ct0 >= ct1) return;
  const int n = p.k_size * p.nks;   // K steps a tile
  const int steps = (ct1 - ct0) * n;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the producer thread starts the ring's first loads, then all threads fill
  // the rows
  Producer pr{0, ct0, 0, 0, 0, 0};
  if (tid == kConsumers)
    for (int s = 0; s < min(p.stages, steps); ++s) load_w(p, ring, full, empty, pr, false);
  const QasrRq site1 = qasr_rq_make(1, p.pro.e1);
  fill_a(p, a_tile, b, t0 * p.stride - p.pad, site1, scalbn(1.0, -p.pro.e1));
  qasr_cp_wait<0>();
  fence_proxy_async();   // the rows, written by the generic proxy, read by wgmma
  __syncthreads();

  if (warp >= kConsumers / 32) {   // the producer: the rest of the ring's loads
    if (tid == kConsumers)
      while (pr.issued < steps) load_w(p, ring, full, empty, pr, true);
    return;
  }

  // the consumers: warpgroup wg owns frames 64 wg.. of the tile, its warp w
  // rows 16 w.. of the fragments
  const int wg = warp >> 2, w = warp & 3;
  const int phase = p.nk16 * p.rpp * 16;
  const uint64_t da0 = rows_desc(a_tile + wg * 64 * 16, p.rpp);
  const QasrRq site = qasr_rq_make(1, p.epi.e), site_r = qasr_rq_make(1, p.epi.e_r);
  const double sc = scalbn(1.0, -p.epi.e), sc_r = scalbn(1.0, -p.epi.e_r);
  const int len = p.lens ? __ldg(p.lens + b) : INT_MAX;
  long long row[2];
  bool keep[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + wg * 64 + 16 * w + (lane >> 2) + 8 * h;
    row[h] = t < p.t_out ? (static_cast<long long>(b) * p.t_out + t) * p.epi.cout : -1;
    keep[h] = t < len;
  }
  Pipe q{0, 0, -1, 0};
  int acc[kGc][kNJ / 2] = {};
  for (int ct = ct0; ct < ct1; ++ct) {
    const int gc = ct / p.njt, jt = ct - gc * p.njt;
    // the tile's first group's channels, at tap 0
    const uint64_t dg = da0 + ((gc * kGc * p.cg * p.rpp) >> 4);
    q.scale = 0;
    for (int tap = 0; tap < p.k_size; ++tap) {
      const int sh = tap * p.dil;   // the tap's row shift: a phase, rows within it
      const int ph = p.stride == 1 ? 0 : sh % p.stride, r = p.stride == 1 ? sh : sh / p.stride;
      const uint64_t dt = dg + ((ph * phase + r * 16) >> 4);
      for (int c = 0; c < p.nks; ++c)
        consume<kGc, kU8>(p, ring, full, empty, lane, q, acc, dt + ((c * kKS * p.rpp) >> 4));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    grouped::fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + q.pend);
    q.pend = -1;
    epilogue_any<kGc, kNJ>(p.epi, acc, gc * kGc, jt * kNJ, lane, row, keep, site, site_r, sc,
                           sc_r);
  }
}

template <int kGc, bool kU8>
cudaError_t launch(const DgParams& p, dim3 grid, int smem, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dense_conv_grouped_kernel<kGc, kU8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gemm_s8::kSmemLimit);
  if (attr != cudaSuccess) return attr;
  dense_conv_grouped_kernel<kGc, kU8><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kU8>
cudaError_t launch_gc(int kgc, const DgParams& p, dim3 grid, int smem, cudaStream_t stream) {
  switch (kgc) {
    case 1: return launch<1, kU8>(p, grid, smem, stream);
    case 2: return launch<2, kU8>(p, grid, smem, stream);
    case 4: return launch<4, kU8>(p, grid, smem, stream);
    case 8: return launch<8, kU8>(p, grid, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#ifdef QASR_DCG_U8
// The uint8-operand instantiations, compiled by dense_conv_grouped_u8.cu (a
// separate nvcc process of the build: the two halves compile in parallel).
cudaError_t dcg_launch_u8(int kgc, const dcg::DgParams& p, dim3 grid, int smem,
                          cudaStream_t stream) {
  return launch_gc<true>(kgc, p, grid, smem, stream);
}
#else
cudaError_t dcg_launch_u8(int kgc, const dcg::DgParams& p, dim3 grid, int smem,
                          cudaStream_t stream);

// kgc, stages, t_per: the wrapper's plan (kernels/dense_conv.py::
// grouped_plan: the groups a column tile takes, the ring's stages, the
// column tiles a grid-z slice owns); the entry derives the rest, computes
// the shared memory and refuses what does not fit.  wp: the weights packed
// by pack_grouped for (groups, kgc).  f64 / f64_1: the
// epilogue's (the join's both) / the prologue's requants proven for the
// FP64 pipe.
extern "C" int qasr_dense_conv_grouped(
    const void* x, const int8_t* wp, const int32_t* bias, const int32_t* m, const int32_t* lens,
    const int32_t* res, const int32_t* m_r, void* out, int batch, int t_in, int cin, int t_out,
    int cout, int k_size, int stride, int pad, int dil, int mode, int relu, int e, int e_r,
    int lo, int hi, int pro, int x32, const int32_t* in_bias, int in_relu, const int32_t* in_len,
    const int32_t* m1, int m1s, int e1, int lo1, int hi1, int u8, int groups, int shuffle,
    const int32_t* hcap, int hs, const int32_t* in_hcap, int in_hs, int kgc, int stages,
    int t_per, int f64, int f64_1, void* stream) {
  if (groups < 2 || cin % groups != 0 || cout % groups != 0 || kgc < 1 || groups % kgc != 0 ||
      (kgc != 1 && kgc != 2 && kgc != 4 && kgc != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cg = cin / groups, cog = cout / groups, nj = kBN / kgc;
  const int rows_h = (kBM - 1) * stride + (k_size - 1) * dil + 1;
  const int nk16 = cin / 16 + kPad16, rpp = (rows_h + stride - 1) / stride | 1;
  const int njt = (cog + nj - 1) / nj, n_tiles = groups / kgc * njt;
  const long long smem = stages <= kMaxStages && nk16 * rpp < (1 << 20)
                             ? DgLayout(stages, stride, nk16, rpp).bytes : LLONG_MAX;
  const int z = (n_tiles + t_per - 1) / t_per;
  if (batch < 1 || t_out < 1 || cg < 16 || cg % 16 != 0 || k_size < 1 || stride < 1 || dil < 1 ||
      mode < 0 || mode > 2 || t_per < 1 || stages < 2 || stages > kMaxStages || (!pro && x32) ||
      smem > gemm_s8::kSmemLimit || z > 65535 || batch > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DgParams p{};
  p.epi = grouped::Epi{bias, m, res, m_r, out, hcap, hs, cout, cog, groups, shuffle, mode, relu,
                       e, e_r, lo, hi, f64};
  p.pro = grouped::Pro{in_bias, in_relu, in_len, m1, m1s, e1, lo1, hi1, in_hcap, in_hs, x32, f64_1};
  p.x = x;
  p.wp = wp;
  p.lens = mode == 1 ? lens : nullptr;
  p.t_in = t_in;
  p.cin = cin;
  p.t_out = t_out;
  p.k_size = k_size;
  p.stride = stride;
  p.pad = pad;
  p.dil = dil;
  p.pro_on = pro;
  p.cg = cg;
  p.cog = cog;
  p.nks = (cg + kKS - 1) / kKS;
  p.rows_h = rows_h;
  p.nk16 = nk16;
  p.rpp = rpp;
  p.stages = stages;
  p.t_per = t_per;
  p.n_tiles = n_tiles;
  p.njt = njt;
  const dim3 grid((t_out + kBM - 1) / kBM, batch, z);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = u8 ? dcg_launch_u8(kgc, p, grid, static_cast<int>(smem), st)
                            : launch_gc<false>(kgc, p, grid, static_cast<int>(smem), st);
  return static_cast<int>(rc);
}
#endif
