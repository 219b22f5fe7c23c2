// pw_gemm: pointwise (1x1) int8 conv as a GEMM, int32 accumulate, with an
// optional input-requant prologue and one of three epilogues.
//
// Replaces qasr_tpu/kernels/cm_fused.py::fused_pw_cm (_pw3_call),
// fused_pw_join_cm (_pw3_join_call) and qasr_tpu/kernels/pw_matmul.py::
// requant_pointwise_matmul (_call).
//
//   prologue off: a = x int8, or uint8 (a non-negative 9-bit code)
//   prologue on:  a[n,i] = clamp(requant(mask_{n%T < in_len[n/T]}(relu?(x[n,i]
//                          + in_bias[i])), m1[i], e1), lo1, hi1),
//                          x int8 or int32, m1 a (Cin,) vector or (NULL)
//                          the scalar m1s
//   acc[n,o] = sum_i a[n,i] * wt[o,i]     x (N=B*T, Cin), wt (Cout, Cin) int8
//   mode 0 (none):    out int32 = act(acc + bias)
//   mode 1 (requant): out int8  = clamp(requant(mask_{n%T < len[n/T]}(
//                                       act(acc + bias)), m[o], e), lo, hi)
//   mode 2 (join):    out int8  = clamp(requant(acc + bias, m[o], e)
//                                       + requant(res[n,o], m_r[o], e_r), lo, hi)
//   act(v) = min(relu?(v), cap[o]): ReLU, or with a ceiling hardtanh's clip
//   to [0, H[o]] (cap a (Cout,) vector, or the scalar hs; INT_MAX: none);
//   the prologue's relu?() is min(relu?(), in_cap[i]) the same way.
//
// Grouped convs (groups > 1) run in pw_gemm_grouped.cu.  The entry here
// takes groups == 1 only; the kernel's group fields (one group: offsets 0,
// no GroupShuffle store) are left as they were so that ungrouped launches
// run the code they ran before the grouped form moved out.
//   a clamp is [-2^(bits-1), 2^(bits-1)-1] with an int8 result, or [0,
//   255] with a uint8 one: W8A8's 9-bit codes of a ReLU'd value, whose
//   clamp [-256, 255] reads [0, 255] (the wrapper's act_clamp), stored in
//   the same bytes.  With a uint8 A (kU8) the products are wgmma's
//   .s32.u8.s8 form.
//
// What bounds it on an H100, at the slice's largest sites (N = 64*768 =
// 49152 rows): at 512 -> 512, 12.9 G multiply-adds (13 us at 1,979 TOP/s)
// against 25 MB in and 25 MB out (15 us at 3.35 TB/s), plus 100 MB of int32
// residual for a join; at C3 (512 -> 1024, int32 input) 100 MB in and 201 MB
// out; the decoder (1024 -> 29) reads 201 MB of int32.  Bytes bound every
// site, and the dyadic requant (a 64-bit product per element) of the
// prologue and epilogue is the largest share of the instructions.
//
// Design (gemm_s8.cuh's mainloop): a block owns 64 rows (one consumer
// warpgroup and a producer warp) and keeps their whole A tile (64 x Cin
// int8, 128B-swizzled chunks of 128 bytes of K) resident in shared memory
// while it walks every BN-column tile of Cout; only the weights stream, by
// TMA, through a ring of 2 stages, so A is read from device memory once.
// Prologue off, A arrives by TMA too.  Prologue on, the consumer threads
// read the rows with 16-byte loads (int8 or int32), apply in-bias, ReLU,
// the length mask and the requant once per element, and write int8 into the
// swizzled tile (then fence.proxy.async for wgmma).  Each row's length
// masks are computed once per block.  After each column tile the int32
// accumulators go to a staging tile in shared memory and the epilogue reads
// them back 8 columns a thread in a rolled loop, with the per-column
// vectors loaded once, the join's int32 residual read and the output
// written 32 (int32) or 8 (int8) bytes a thread.  The requants of the
// prologue and epilogue (a 64-bit product each, ~35 instructions) are most
// of the instructions; a block's 69 KB of shared memory at Cin = 512 lets
// three blocks share an SM, so one block's requants overlap another's
// products and loads.  (Issuing the next tile's products before this
// tile's epilogue instead made ptxas serialize every wgmma, C7520: the
// accumulators in flight across the epilogue's per-thread loop.)  BN = 32
// for Cout <= 32 (the decoder's 29), else 64 (the wrapper's
// kernels/pw_gemm.py::plan computes the same).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "gemm_s8.cuh"
#include "requant.cuh"

namespace {

using gemm_s8::kChunk;

constexpr int kStages = 2;           // the weight ring
constexpr int kBM = 64;              // rows per block: one consumer warpgroup
constexpr int kThreads = 128 + 32;   // the consumer warpgroup and the producer warp

struct PwParams {
  const void* x;
  const int32_t* bias;
  const int32_t* m;
  const int32_t* lens;
  const int32_t* res;
  const int32_t* m_r;
  void* out;
  int n_rows, cin, cout, rows_per_batch, mode, relu, e, e_r, lo, hi;
  int pro, x32;
  const int32_t* in_bias;
  int in_relu;
  const int32_t* in_len;
  const int32_t* m1;
  int m1s, e1, lo1, hi1;
  int nk;  // K chunks (Cin / groups rounded up to kChunk)
  int groups, cg, cog, shuffle;  // groups, Cin and Cout a group, GroupShuffle on store
  const int32_t* hcap;           // (Cout,) ceiling, or NULL -> hs
  int hs;
  const int32_t* in_hcap;        // (Cin,) prologue ceiling, or NULL -> in_hs
  int in_hs;
};

// A block's shared memory (byte offsets from the 1024-aligned base): the
// resident A tile, the weight ring, the int32 staging tile, the mbarriers
// (full[S], empty[S], a_full) and the row masks (prologue, epilogue).
struct PwLayout {
  int a, ring, stage, ld, bars, mask, bytes;
  __host__ __device__ PwLayout(int bn, int nk) {
    a = 0;
    ring = a + kBM * kChunk * nk;
    stage = ring + kStages * bn * kChunk;
    ld = gemm_s8::stage_ld(bn);
    bars = stage + kBM * ld;
    mask = bars + 8 * (2 * kStages + 1);
    bytes = mask + 2 * kBM + gemm_s8::kAlign;  // + the base's alignment slack
  }
};

// The prologue on channels c0..c0+15 of one row (v): 16 int8 values packed;
// kExt: with hardtanh's ceiling.
template <bool kExt>
__device__ __forceinline__ int4 prologue16(const int (&v)[16], int c0, const PwParams& p) {
  int b0[8], b1[8], m0[8], m1[8], h0[8], h1[8];
  const int nb = p.in_bias ? 8 : 0;
  gemm_s8::gload8(p.in_bias + c0, nb, b0);
  gemm_s8::gload8(p.in_bias + c0 + 8, nb, b1);
  if (kExt && p.in_hcap) {
    gemm_s8::gload8(p.in_hcap + c0, 8, h0);
    gemm_s8::gload8(p.in_hcap + c0 + 8, 8, h1);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) h0[q] = h1[q] = p.in_hs;
  }
  if (p.m1) {
    gemm_s8::gload8(p.m1 + c0, 8, m0);
    gemm_s8::gload8(p.m1 + c0 + 8, 8, m1);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) m0[q] = m1[q] = p.m1s;
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    int z = v[q] + (q < 8 ? b0[q] : b1[q - 8]);
    if (p.in_relu) z = z > 0 ? z : 0;
    if (kExt) z = min(z, q < 8 ? h0[q] : h1[q - 8]);
    const int r = qasr_clamp(qasr_requant(z, q < 8 ? m0[q] : m1[q - 8], p.e1), p.lo1, p.hi1);
    w[q / 4] |= (static_cast<unsigned>(r) & 0xffu) << (8 * (q % 4));
  }
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]), static_cast<int>(w[2]),
                   static_cast<int>(w[3]));
}

// The raw input of granule i (16 channels of one of the block's rows, from
// channel c_in0, the group's first), or false where it is past the group's
// Cin or its row is masked.
__device__ __forceinline__ bool prologue_load(const PwParams& p, int n0, const uint8_t* row_ok,
                                              int g_row, int i, int c_in0, int4 (&raw)[4]) {
  const int r = i / g_row, c0 = (i - r * g_row) * 16;
  if (i >= kBM * g_row || c0 >= p.cg || !row_ok[r]) return false;
  const size_t off = static_cast<size_t>(n0 + r) * p.cin + c_in0 + c0;
  if (p.x32) {
    const int4* s = reinterpret_cast<const int4*>(static_cast<const int32_t*>(p.x) + off);
#pragma unroll
    for (int k = 0; k < 4; ++k) raw[k] = s[k];
  } else {
    raw[0] = *reinterpret_cast<const int4*>(static_cast<const int8_t*>(p.x) + off);
  }
  return true;
}

// The block's A tile through the prologue, by its 128 consumer threads
// (t), each 16-byte granule of K once, the next granule's load in flight
// while this one is requantized.
template <bool kExt>
__device__ __forceinline__ void prologue_fill(const PwParams& p, uint8_t* a_tile, int n0,
                                              const uint8_t* row_ok, int c_in0, int t) {
  constexpr int kN = 128;
  const int g_row = p.nk * (kChunk / 16);  // granules per row, K padded to the chunk
  int4 cur[4], nxt[4];
  bool live = prologue_load(p, n0, row_ok, g_row, t, c_in0, cur);
#pragma unroll 1
  for (int i = t; i < kBM * g_row; i += kN) {
    const bool live_next = prologue_load(p, n0, row_ok, g_row, i + kN, c_in0, nxt);
    int4 word = make_int4(0, 0, 0, 0);
    if (live) {
      int v[16];
      if (p.x32) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[4 * k] = cur[k].x, v[4 * k + 1] = cur[k].y;
          v[4 * k + 2] = cur[k].z, v[4 * k + 3] = cur[k].w;
        }
      } else {
        const int w4[4] = {cur[0].x, cur[0].y, cur[0].z, cur[0].w};
#pragma unroll
        for (int q = 0; q < 16; ++q) v[q] = static_cast<int8_t>(w4[q / 4] >> (8 * (q % 4)));
      }
      word = prologue16<kExt>(v, c_in0 + (i % g_row) * 16, p);
    }
    const int row = i / g_row, g = i % g_row;
    const int chunk = g / (kChunk / 16), gg = g % (kChunk / 16);
    *reinterpret_cast<int4*>(a_tile + chunk * kBM * kChunk + row * kChunk +
                             ((gg ^ (row & 7)) << 4)) = word;
#pragma unroll
    for (int k = 0; k < 4; ++k) cur[k] = nxt[k];
    live = live_next;
  }
}

// One column tile's epilogue on the warpgroup's staged accumulators: rows r
// of the tile, 8 columns (group g) a thread, per-column operands loaded
// once.  o0 is the tile's first channel, lim the end of its conv group.
// kCap: hardtanh's ceiling after the ReLU (cap a (Cout,) vector or the
// scalar hs), the kernel's kExt form; without it, no ceiling is read.
template <int kBN, bool kCap>
__device__ __forceinline__ void epilogue(const PwParams& p, const uint8_t* stage,
                                         const uint8_t* epi_ok, int n_base, int rows, int o0,
                                         int lim, int t) {
  using namespace gemm_s8;
  constexpr int kG = kBN / 8, kStep = 128 / kG, kLd = stage_ld(kBN);
  const int g = t % kG, o = o0 + 8 * g;
  const int nv = min(8, lim - o);
  if (nv <= 0) return;
  int bq[8], mq[8], mrq[8], cq[8];
  gload8(p.bias ? p.bias + o : nullptr, p.bias ? nv : 0, bq);
  gload8(p.mode != 0 ? p.m + o : nullptr, p.mode != 0 ? nv : 0, mq);
  gload8(p.mode == 2 ? p.m_r + o : nullptr, p.mode == 2 ? nv : 0, mrq);
  if constexpr (kCap) {
    if (p.hcap) {
      gload8(p.hcap + o, nv, cq);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) cq[q] = p.hs;
    }
  }
  int a[8], y[8];
#pragma unroll 1
  for (int r = t / kG; r < rows; r += kStep) {
    const size_t idx = static_cast<size_t>(n_base + r) * p.cout + o;
    if (p.mode == 2) {
      int rv[8];
      gload8(p.res + idx, nv, rv);
      load8(stage, kLd, r, g, a);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        y[q] = qasr_clamp(qasr_requant(a[q] + bq[q], mq[q], p.e) +
                              qasr_requant(rv[q], mrq[q], p.e_r),
                          p.lo, p.hi);
      store8_s8(static_cast<int8_t*>(p.out) + idx, nv, y);
    } else if (p.mode == 1) {
      load8(stage, kLd, r, g, a);
      const bool ok = epi_ok[r];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        int v = a[q] + bq[q];
        if (p.relu) v = v > 0 ? v : 0;
        if constexpr (kCap) v = min(v, cq[q]);
        if (!ok) v = 0;
        y[q] = qasr_clamp(qasr_requant(v, mq[q], p.e), p.lo, p.hi);
      }
      store8_s8(static_cast<int8_t*>(p.out) + idx, nv, y);
    } else {
      load8(stage, kLd, r, g, a);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int v = a[q] + bq[q];
        y[q] = p.relu && v < 0 ? 0 : v;
        if constexpr (kCap) y[q] = min(y[q], cq[q]);
      }
      store8_s32(static_cast<int32_t*>(p.out) + idx, nv, y);
    }
  }
}

// The epilogue with GroupShuffle's store: channel o goes to position (o %
// Cout/g) * g + o / (Cout/g), where m, m_r and res are read too (bias and
// the ceiling in the conv's order).  One column a thread: a warp's 32 lanes
// take consecutive channels of a row, whose positions lie g apart, so a
// store instruction touches 4 sectors of int8 codes (16 of int32) where 8
// columns a thread would touch 32; the per-column operands are loaded once.
template <int kBN>
__device__ __forceinline__ void epilogue_shuffled(const PwParams& p, const uint8_t* stage,
                                                  const uint8_t* epi_ok, int n_base, int rows,
                                                  int o0, int lim, int t) {
  constexpr int kStep = 128 / kBN, kLd = gemm_s8::stage_ld(kBN);
  const int c = t % kBN, o = o0 + c;
  if (o >= lim) return;
  const int pos = (o % p.cog) * p.groups + o / p.cog;
  const int b = p.bias ? p.bias[o] : 0;
  const int cap = p.hcap ? p.hcap[o] : p.hs;
  const int m = p.mode != 0 ? p.m[pos] : 0;
  const int m_r = p.mode == 2 ? p.m_r[pos] : 0;
#pragma unroll 4
  for (int r = t / kBN; r < rows; r += kStep) {
    const size_t at = static_cast<size_t>(n_base + r) * p.cout + pos;
    const int v = reinterpret_cast<const int*>(stage + r * kLd)[c] + b;
    if (p.mode == 2) {
      static_cast<int8_t*>(p.out)[at] = static_cast<int8_t>(qasr_clamp(
          qasr_requant(v, m, p.e) + qasr_requant(p.res[at], m_r, p.e_r), p.lo, p.hi));
    } else if (p.mode == 1) {
      const int u = epi_ok[r] ? min(p.relu && v < 0 ? 0 : v, cap) : 0;
      static_cast<int8_t*>(p.out)[at] =
          static_cast<int8_t>(qasr_clamp(qasr_requant(u, m, p.e), p.lo, p.hi));
    } else {
      static_cast<int32_t*>(p.out)[at] = min(p.relu && v < 0 ? 0 : v, cap);
    }
  }
}

// kExt: the grouped conv's GroupShuffle store or a hardtanh ceiling (in the
// prologue or the epilogue); without them the kernel is the ungrouped one's
// code (a grouped conv without either takes it too).
template <int kBN, bool kU8, bool kExt>
__global__ void __launch_bounds__(kThreads, 2)
pw_gemm_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
               const PwParams p) {
  using namespace gemm_s8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const PwLayout L(kBN, p.nk);
  uint8_t* a_tile = smem + L.a;
  uint8_t* ring = smem + L.ring;
  uint8_t* stage = smem + L.stage;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kStages;
  uint64_t* a_full = empty + kStages;
  uint8_t* row_ok = smem + L.mask;         // the prologue's input mask, by block row
  uint8_t* epi_ok = row_ok + kBM;          // the requant epilogue's output mask
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // groups fastest: a row tile's groups run side by side, so the sectors a
  // shuffled store interleaves are completed together in L2
  const int grp = blockIdx.x % p.groups;        // the conv group
  const int n0 = (blockIdx.x / p.groups) * kBM;
  const int c_in0 = grp * p.cg, c_out0 = grp * p.cog;
  const int n_ct = (p.cog + kBN - 1) / kBN;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);
    }
    mbar_init(a_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp: A (prologue off), then the weights
    if (lane == 0) {
      if (!p.pro) {
        mbar_expect_tx(a_full, kBM * kChunk * p.nk);
        for (int kc = 0; kc < p.nk; ++kc)
          tma_load_2d(a_tile + kc * kBM * kChunk, &map_x, a_full, c_in0 + kc * kChunk, n0);
      }
      for (int step = 0; step < n_ct * p.nk; ++step) {
        const int s = step % kStages;
        mbar_wait(empty + s, ((step / kStages) & 1) ^ 1);
        mbar_expect_tx(full + s, kBN * kChunk);
        tma_load_2d(ring + s * kBN * kChunk, &map_w, full + s, (step % p.nk) * kChunk,
                    c_out0 + (step / p.nk) * kBN);
      }
    }
    return;
  }

  // the consumer warpgroup
  if (tid < kBM) {  // each row's masks, once per block
    const int n = n0 + tid, b = n / p.rows_per_batch, f = n % p.rows_per_batch;
    row_ok[tid] = n < p.n_rows && (p.in_len == nullptr || f < p.in_len[b]);
    epi_ok[tid] = p.lens == nullptr || (n < p.n_rows && f < p.lens[b]);
  }
  bar_sync(1, 128);
  if (p.pro) {
    prologue_fill<kExt>(p, a_tile, n0, row_ok, c_in0, tid);
    fence_proxy_async();
    bar_sync(1, 128);
  } else {
    mbar_wait(a_full, 0);
  }

  const int rows = min(kBM, p.n_rows - n0);
  int step = 0;
  for (int ct = 0; ct < n_ct; ++ct) {
    int acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
    for (int kc = 0; kc < p.nk; ++kc, ++step) {
      const int s = step % kStages;
      mbar_wait(full + s, (step / kStages) & 1);
      mma_chunk<kBN, kU8>(acc, a_tile + kc * kBM * kChunk, ring + s * kBN * kChunk);
      if (lane == 0) mbar_arrive(empty + s);
    }
    stage_acc<kBN>(acc, stage, warp, lane);
    bar_sync(1, 128);
    const int o0 = c_out0 + ct * kBN, lim = c_out0 + p.cog;
    if (kExt && p.shuffle)
      epilogue_shuffled<kBN>(p, stage, epi_ok, n0, rows, o0, lim, tid);
    else
      epilogue<kBN, kExt>(p, stage, epi_ok, n0, rows, o0, lim, tid);
    bar_sync(1, 128);  // the staging tile is free for the next column tile
  }
}

template <int kBN, bool kU8, bool kExt>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mw, const PwParams& p, int smem,
                   cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      pw_gemm_kernel<kBN, kU8, kExt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gemm_s8::kSmemLimit);
  if (attr != cudaSuccess) return attr;
  const int tiles = (p.n_rows + kBM - 1) / kBM;
  pw_gemm_kernel<kBN, kU8, kExt><<<tiles * p.groups, kThreads, smem, stream>>>(mx, mw, p);
  return cudaGetLastError();
}

template <int kBN, bool kU8>
cudaError_t launch_ext(bool ext, const CUtensorMap& mx, const CUtensorMap& mw, const PwParams& p,
                       int smem, cudaStream_t stream) {
  return ext ? launch<kBN, kU8, true>(mx, mw, p, smem, stream)
             : launch<kBN, kU8, false>(mx, mw, p, smem, stream);
}

}  // namespace

extern "C" int qasr_pw_gemm(const void* x, const int8_t* wt,
                            const int32_t* bias, const int32_t* m,
                            const int32_t* lens, const int32_t* res,
                            const int32_t* m_r, void* out, int n_rows, int cin,
                            int cout, int rows_per_batch, int mode, int relu,
                            int e, int e_r, int lo, int hi, int pro, int x32,
                            const int32_t* in_bias, int in_relu,
                            const int32_t* in_len, const int32_t* m1, int m1s,
                            int e1, int lo1, int hi1, int u8, int groups, int shuffle,
                            const int32_t* hcap, int hs, const int32_t* in_hcap, int in_hs,
                            void* stream) {
  if (groups != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int cg = cin / groups, cog = cout / groups;
  // the tile plan (kernels/pw_gemm.py::plan computes the same)
  const int bn = cog <= 32 ? 32 : 64;
  const int nk = (cg + kChunk - 1) / kChunk;
  const int smem = PwLayout(bn, nk).bytes;
  if (n_rows < 1 || cg < 16 || cg % 16 != 0 || cout < 1 || mode < 0 || mode > 2 ||
      smem > gemm_s8::kSmemLimit || (!pro && x32) ||
      static_cast<long long>((n_rows + kBM - 1) / kBM) * groups > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx{}, mw{};
  if ((!pro && !gemm_s8::make_map(&mx, x, n_rows, cin, kBM)) ||
      !gemm_s8::make_map(&mw, wt, cout, cg, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  const PwParams p{x, bias, m, lens, res, m_r, out, n_rows, cin, cout, rows_per_batch, mode,
                   relu, e, e_r, lo, hi, pro, x32, in_bias, in_relu, in_len, m1, m1s, e1, lo1,
                   hi1, nk, groups, cg, cog, shuffle, hcap, hs, in_hcap, in_hs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // u8: A is unsigned (a uint8 x, or a prologue that writes uint8 codes)
  const bool ext = shuffle || hcap || hs != INT_MAX || in_hcap || in_hs != INT_MAX;
  const cudaError_t rc =
      bn == 32 ? (u8 ? launch_ext<32, true> : launch_ext<32, false>)(ext, mx, mw, p, smem, st)
               : (u8 ? launch_ext<64, true> : launch_ext<64, false>)(ext, mx, mw, p, smem, st);
  return static_cast<int>(rc);
}
