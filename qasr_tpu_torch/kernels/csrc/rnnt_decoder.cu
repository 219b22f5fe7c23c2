// Kernel 9: the frozen transducer decoder.  rnnt_greedy_kernel (the serving
// path, below the step kernels) runs a whole greedy decode of a batch of
// frames in one launch; the step kernels, an integer LSTM layer
// (rnnt_pred_step_kernel) and the integer joint with its argmax
// (rnnt_joint_kernel), stay for the host loop that it replaced.
//
// Replaces no Pallas kernel: the JAX package runs the step as two jitted
// XLA closures, qasr_tpu/quantize/rnnt_freeze.py::pred_step_frozen
// (:157-196) and joint_logits_frozen (:199-217), whose greedy loop
// (:251-278) also gathers the argmax on the host and keeps the old state in
// the rows that did not emit (:272-275).  Here a layer is one launch and the
// joint one launch, bit for bit with the plain versions of
// quantize/rnnt_freeze.py:
//
//   pred step (a layer; x = embed[tok] for layer 0, else the layer below's
//   new h8):
//     acc_i = x . wi[:, c], acc_h = h8 . wh[:, c] for gate column c
//     g1 = clip(rq(acc_i, mi[c], ei) + rq(acc_h, mh[c], eh) + b_grid[c], +-N_IN)
//     g2 = the same with mi2 / mh2 / b2_grid (the g gate only: tanh(x) =
//          2 sigmoid(2x) - 1 on the doubled grid)
//     c' = clip(round(f c / 2^7) + i tanh(g), +-2^23)   (f, i, o: i-sigmoid)
//     h' = clip(rq(o tanh(clip(rq(c', m_c2, e_c2), +-N_IN)), m_h, e_h), +-127)
//     rows whose emit flag is 0 keep h8 and c
//   joint (a row):
//     enc8 = clip(round(enc / S_enc), +-n8)   (IEEE float32 division, ties to
//            even: the declared float -> int boundary)
//     x8 = clip(rq(enc8 . wenc, m_f, e_f) + rq(h8 . wpred, m_g, e_g) + b_j, 0, n8)
//     logits = rq(x8 . wout, m_o, e_o) + b_out;  id = the first max column
//
// What bounds it on an H100: nothing but the launch.  A step at H = 320 and
// B = 32 reads 0.8 MB of LSTM weights once (0.25 us at 3.35 TB/s) for 6.6
// M multiply-adds; the joint at J = 320, V+1 = 29 reads 0.2 MB.  So the
// design is the simple one: a warp a (row, gate column) in the pred step
// and a block a row in the joint, the weights K-contiguous (the wrapper
// repacks them once) and read a 4-byte word a lane, coalesced, from L2 for
// every row; __dp4a products, warp sums by __reduce_add_sync, the requants
// by requant.cuh's qasr_requant and the sigmoid by conformer_int.cuh's
// qasr_i_sigmoid_grid.  The joint keeps enc8, h8 and the hidden x8 of its
// row in shared memory; its argmax is a per-warp best (columns visited in
// increasing order, strict >) reduced over the warps with ties to the
// lower column, as numpy's argmax on the host.  Every row, column and
// K length must be a multiple of 4 bytes (the wrapper checks).
#include <climits>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <tuple>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "conformer_int.cuh"
#include "gemm_s8.cuh"
#include "requant.cuh"

namespace {

constexpr int kPredWarps = 8;      // gate columns j per pred-step block
constexpr int kJointWarps = 16;    // warps of a joint block (one row)
constexpr int kCClip = 1 << 23;    // the cell state's clip

struct PredParams {
  const int32_t* tok;
  const int8_t* embed;
  const int8_t* x8;
  const int8_t* h8;
  const int32_t* c;
  const int8_t* wt_i;
  const int8_t* wt_h;
  const int32_t *mi, *mh, *mi2, *mh2, *b_grid, *b2_grid;
  const int32_t* emit;
  int8_t* h_out;
  int32_t* c_out;
  int batch, hid, din, n_embed;
  int ei, eh, ei2, eh2, m_c2, e_c2, m_h, e_h;
};

// sum over k of x[k] w[k] for a K-contiguous weight row, a word a lane
__device__ __forceinline__ int warp_dot(const int* __restrict__ x, const int* __restrict__ w,
                                        int words, int lane) {
  int acc = 0;
  for (int k = lane; k < words; k += 32) acc = __dp4a(x[k], __ldg(w + k), acc);
  return acc;
}

__global__ void __launch_bounds__(kPredWarps * 32)
rnnt_pred_step_kernel(const PredParams p) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kPredWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (j >= p.hid) return;
  const int8_t* x;
  if (p.x8 == nullptr) {
    const int t = __ldg(p.tok + b);
    if (t < 0 || t >= p.n_embed) __trap();   // a token outside the embedding
    x = p.embed + static_cast<long long>(t) * p.din;
  } else {
    x = p.x8 + static_cast<long long>(b) * p.din;
  }
  const int* xw = reinterpret_cast<const int*>(x);
  const int* hw = reinterpret_cast<const int*>(p.h8 + static_cast<long long>(b) * p.hid);
  const int wi_words = p.din / 4, wh_words = p.hid / 4;
  int acc_i[4], acc_h[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int col = g * p.hid + j;
    acc_i[g] = __reduce_add_sync(0xffffffffu, warp_dot(
        xw, reinterpret_cast<const int*>(p.wt_i + static_cast<long long>(col) * p.din),
        wi_words, lane));
    acc_h[g] = __reduce_add_sync(0xffffffffu, warp_dot(
        hw, reinterpret_cast<const int*>(p.wt_h + static_cast<long long>(col) * p.hid),
        wh_words, lane));
  }
  if (lane != 0) return;
  int s[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int col = g * p.hid + j;
    const int g1 = qasr_requant(acc_i[g], __ldg(p.mi + col), p.ei) +
                   qasr_requant(acc_h[g], __ldg(p.mh + col), p.eh) + __ldg(p.b_grid + col);
    s[g] = qasr_i_sigmoid_grid(qasr_clamp(g1, -kNIn, kNIn));
  }
  const int cg = 2 * p.hid + j;
  const int g2 = qasr_requant(acc_i[2], __ldg(p.mi2 + cg), p.ei2) +
                 qasr_requant(acc_h[2], __ldg(p.mh2 + cg), p.eh2) + __ldg(p.b2_grid + cg);
  const int tg = 2 * qasr_i_sigmoid_grid(qasr_clamp(g2, -kNIn, kNIn)) - (1 << kKSig);
  const long long idx = static_cast<long long>(b) * p.hid + j;
  const int c_prev = p.c[idx];
  const int c2 = qasr_clamp(((s[1] * c_prev + (1 << (kKSig - 1))) >> kKSig) + s[0] * tg,
                            -kCClip, kCClip);
  const int q2c = qasr_clamp(qasr_requant(c2, p.m_c2, p.e_c2), -kNIn, kNIn);
  const int h_fp = s[3] * (2 * qasr_i_sigmoid_grid(q2c) - (1 << kKSig));
  const int h_new = qasr_clamp(qasr_requant(h_fp, p.m_h, p.e_h), -127, 127);
  const bool keep = p.emit == nullptr || p.emit[b] != 0;
  p.h_out[idx] = keep ? static_cast<int8_t>(h_new) : p.h8[idx];
  p.c_out[idx] = keep ? c2 : c_prev;
}

struct JointParams {
  const float* enc;
  const int8_t* h8;
  const int8_t *wt_enc, *wt_pred, *wt_out;
  const int32_t *m_f, *m_g, *m_o, *b_j, *b_out;
  int32_t* logits;
  int32_t* ids;
  long long enc_stride;
  int de, hp, jh, vout, e_f, e_g, e_o, n8;
  float s_enc;
};

__global__ void __launch_bounds__(kJointWarps * 32)
rnnt_joint_kernel(const JointParams p) {
  extern __shared__ int smem[];
  int* enc8 = smem;                 // de bytes
  int* hrow = enc8 + p.de / 4;      // hp bytes
  int* x8 = hrow + p.hp / 4;        // jh bytes
  __shared__ int best_v[kJointWarps], best_i[kJointWarps];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int8_t* e8 = reinterpret_cast<int8_t*>(enc8);
  const float* er = p.enc + b * p.enc_stride;
  for (int k = threadIdx.x; k < p.de; k += blockDim.x) {
    float q = rintf(__fdiv_rn(er[k], p.s_enc));
    q = fminf(fmaxf(q, static_cast<float>(-p.n8)), static_cast<float>(p.n8));
    e8[k] = static_cast<int8_t>(static_cast<int>(q));
  }
  const int* hsrc = reinterpret_cast<const int*>(p.h8 + static_cast<long long>(b) * p.hp);
  for (int k = threadIdx.x; k < p.hp / 4; k += blockDim.x) hrow[k] = hsrc[k];
  __syncthreads();
  int8_t* xs = reinterpret_cast<int8_t*>(x8);
  for (int k = warp; k < p.jh; k += kJointWarps) {
    const int af = __reduce_add_sync(0xffffffffu, warp_dot(
        enc8, reinterpret_cast<const int*>(p.wt_enc + static_cast<long long>(k) * p.de),
        p.de / 4, lane));
    const int ag = __reduce_add_sync(0xffffffffu, warp_dot(
        hrow, reinterpret_cast<const int*>(p.wt_pred + static_cast<long long>(k) * p.hp),
        p.hp / 4, lane));
    if (lane == 0) {
      const int x = qasr_requant(af, __ldg(p.m_f + k), p.e_f) +
                    qasr_requant(ag, __ldg(p.m_g + k), p.e_g) + __ldg(p.b_j + k);
      xs[k] = static_cast<int8_t>(qasr_clamp(x, 0, p.n8));
    }
  }
  __syncthreads();
  int bv = INT_MIN, bi = INT_MAX;
  for (int v = warp; v < p.vout; v += kJointWarps) {
    const int acc = __reduce_add_sync(0xffffffffu, warp_dot(
        x8, reinterpret_cast<const int*>(p.wt_out + static_cast<long long>(v) * p.jh),
        p.jh / 4, lane));
    const int out = qasr_requant(acc, __ldg(p.m_o + v), p.e_o) + __ldg(p.b_out + v);
    if (lane == 0) p.logits[static_cast<long long>(b) * p.vout + v] = out;
    if (out > bv) {   // columns in increasing order: the first max stays
      bv = out;
      bi = v;
    }
  }
  if (lane == 0) {
    best_v[warp] = bv;
    best_i[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kJointWarps; ++w)
      if (best_v[w] > bv || (best_v[w] == bv && best_i[w] < bi)) {
        bv = best_v[w];
        bi = best_i[w];
      }
    p.ids[b] = bi;
  }
}

}  // namespace

extern "C" int qasr_rnnt_pred_step(const int32_t* tok, const int8_t* embed, const int8_t* x8,
                                   const int8_t* h8, const int32_t* c, const int8_t* wt_i,
                                   const int8_t* wt_h, const int32_t* mi, const int32_t* mh,
                                   const int32_t* mi2, const int32_t* mh2,
                                   const int32_t* b_grid, const int32_t* b2_grid,
                                   const int32_t* emit, int8_t* h_out, int32_t* c_out,
                                   int batch, int hid, int din, int n_embed, int ei, int eh,
                                   int ei2, int eh2, int m_c2, int e_c2, int m_h, int e_h,
                                   void* stream) {
  if (batch < 1 || hid < 4 || hid % 4 || din < 4 || din % 4 || batch > 65535 ||
      (x8 == nullptr && (tok == nullptr || embed == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const PredParams p{tok, embed, x8, h8, c, wt_i, wt_h, mi, mh, mi2, mh2, b_grid, b2_grid,
                     emit, h_out, c_out, batch, hid, din, n_embed,
                     ei, eh, ei2, eh2, m_c2, e_c2, m_h, e_h};
  const dim3 grid((hid + kPredWarps - 1) / kPredWarps, batch);
  rnnt_pred_step_kernel<<<grid, kPredWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qasr_rnnt_joint(const float* enc, long long enc_stride, const int8_t* h8,
                               const int8_t* wt_enc, const int8_t* wt_pred,
                               const int8_t* wt_out, const int32_t* m_f, const int32_t* m_g,
                               const int32_t* m_o, const int32_t* b_j, const int32_t* b_out,
                               int32_t* logits, int32_t* ids, int batch, int de, int hp,
                               int jh, int vout, float s_enc, int e_f, int e_g, int e_o,
                               int n8, void* stream) {
  if (batch < 1 || vout < 1 || de < 4 || de % 4 || hp < 4 || hp % 4 || jh < 4 || jh % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = de + hp + jh;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const JointParams p{enc, h8, wt_enc, wt_pred, wt_out, m_f, m_g, m_o, b_j, b_out, logits,
                      ids, enc_stride, de, hp, jh, vout, e_f, e_g, e_o, n8, s_enc};
  rnnt_joint_kernel<<<batch, kJointWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// rnnt_greedy_kernel: the whole greedy decode of (B, T, De) frames in one
// launch.
//
// Replaces the former host loop (a joint launch, a copy of the B ids to
// the host, a host-to-card copy of tokens and flags and a pred launch a
// layer, every symbol step), which the JAX package runs as the jitted
// closures above driven from numpy (qasr_tpu/quantize/rnnt_freeze.py:
// 251-278).  That loop is batched, but its rows are independent: a row that
// gives a blank keeps its state, so its next joint at the frame gives the
// same blank, and an inactive row never emits.  So row r's ids and final
// carry are those of a loop of its own: at each of its frames, joint ->
// argmax -> stop at a blank or after max_symbols_per_step emissions, else
// a pred step with the token (joint steps a frame: emits + [emits < cap]).
// Two integer terms are hoisted without changing a bit: the joint's
// encoder term f_j = rq(enc8 . wenc, m_f, e_f) is computed once a frame,
// when the row enters it, and its prediction term g_j = rq(h8 . wpred, m_g,
// e_g) once an emission.
//
// What bounds it on an H100: the latency of a dependent step.  The bytes
// are tiny (B T De float32 frames; 12.3 MB at B = 32 x 375 frames, ~4 us at
// 3.35 TB/s) and a step is a few GEMVs at M = the cluster's rows (1-2), so
// wgmma's M = 64 tile would waste almost all of its rows: the products are
// __dp4a from shared memory, four 4-byte words a lane (16-byte loads), and
// the decode is a chain of ~max_row_steps steps, each two dependent
// exchanges between SMs when the row emits (logits, then the new h8) and
// one when it gives a blank.  Within a CTA every dot product runs on a
// group of 8 lanes (a hidden unit's eight gate sums, a joint column),
// reduced by shuffles inside the group, so a step's 40 units and 40
// columns a row take one round of the block's 64 groups and the cell's
// eight requants run side by side in the group's lanes.
//
// Design.  One thread-block cluster of C CTAs (8 at the serving shape)
// holds every weight of the decoder, split by output column: CTA q owns
// hidden units [q U0, (q+1) U0) of every LSTM layer (their four gate rows
// of wt_i and wt_h with the per-column constants), joint columns [q JC0,
// (q+1) JC0) of wt_enc and wt_pred, and the same K slice of every wt_out
// row.  The host packs each CTA's slice into one contiguous blob (rows
// K-contiguous, padded to 16 bytes; kernels/rnnt_decoder.py::greedy_layout,
// which also computes every offset passed in `a`), and the resident form
// copies it into shared memory once a launch by cp.async.bulk on an
// mbarrier.  Shapes whose blob does not fit (H = 640, L = 2: 0.8 MB a CTA)
// run the streamed form, the same code reading the blob from global memory
// (L2) every step (template parameter kRes, chosen by the C entry from its
// shared-memory plan, not a fallback).  Rows are dealt out in groups of R
// to the clusters, and the grid is sized to one wave of clusters by
// cudaOccupancyMaxActiveClusters.  Clusters never wait on each other (no
// grid barrier, no cooperative launch).  Rows of a group step together,
// each with its own frame pointer.  A step:
//   A. each CTA: x8 = clip(f_j + g_j + b_j, 0, n8) over its J slice and the
//      partial out products over that slice for every logit, pushed into
//      every CTA's shared memory (distributed shared memory);
//   -- barrier.cluster --
//   B. each CTA sums the C partials, requantizes, adds the bias and takes
//      the argmax (ties to the lower column, as numpy's), and makes the
//      same emit / frame decisions as every other CTA; the first CTA writes
//      the id;
//   C. for emitting rows, layer by layer: each CTA's units (the __dp4a
//      gate products over [x | h8], the i-sigmoid / i-tanh cell from the
//      table that Kernel 4's GLU gate reads (in the blob, equal to
//      qasr_i_sigmoid_grid on the cell's whole domain), c kept in the
//      CTA), the new h8 bytes pushed into every CTA's copy of the row's
//      h8 (double-buffered by the row's emission parity) -- barrier.cluster
//      --; then g_j over the CTA's J slice from the new top h8.  Rows
//      entering a frame quantize it (the IEEE __fdiv_rn of the frame,
//      prefetched a frame ahead by cp.async) and compute their f_j slice;
//      that local work sits between the first layer's barrier arrive and
//      wait.
// Every CTA holds the same row state, so all take the same branches and
// barriers.  The step count a group can take is bounded (T cap + 1); past
// it the kernel traps instead of spinning.
// ---------------------------------------------------------------------------

namespace greedy {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;        // rows a cluster steps together (<= kWarps)
constexpr int kMaxLayers = 4;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kLoadChunk = 1 << 15;
constexpr int kCClip = 1 << 23;

// The integer arguments, in the order of kernels/rnnt_decoder.py::GREEDY_ARGS.
enum Arg : int {
  kBatch, kT, kDe, kHid, kLayers, kJ, kV, kNEmbed, kCap, kBlank, kN8, kEncSB, kEncST,
  kEF, kEG, kEO, kMC2, kEC2, kMH, kEH, kCluster, kUnits, kJSlice, kBlobBytes,
  kOffEmbed, kOffWenc, kOffWpred, kOffWout, kOffMf, kOffMg, kOffBj, kOffMo, kOffBo, kOffSig,
  kOffLayer,                              // + 8 l + LayerOff
  kExpLayer = kOffLayer + 8 * kMaxLayers,  // + 4 l + LayerExp
  kNumArgs = kExpLayer + 4 * kMaxLayers
};
enum LayerOff : int { kWi, kWh, kMi, kMh, kBg, kMi2, kMh2, kB2 };
enum LayerExp : int { kEi, kEh, kEi2, kEh2 };

__host__ __device__ constexpr int rup16(int n) { return (n + 15) & ~15; }

// A row's decode state; every CTA of the cluster holds the same copy.
struct alignas(16) Row {
  int b, t, len, emits, nsym, steps, tok, epar, emit, enter, active, pad;
};

// Byte offsets of the per-row state in shared memory (after the blob in the
// resident form).
struct StateLayout {
  int h, vec, xs, fj, gj, c, ebuf, part, rows, bar, bytes;
};

__host__ __device__ inline StateLayout state_layout(const int* a, int rows) {
  const int hp = rup16(a[kHid]), dep = rup16(a[kDe]), jcp = rup16(a[kJSlice]);
  StateLayout s;
  int o = 0;
  s.h = o;     // rows x L x 2 parities x hp: the row's full h8 of each layer
  o += rows * a[kLayers] * 2 * hp;
  s.vec = o;   // rows x max(hp, dep): the entering frame's enc8 (g8 at start)
  o += rows * (hp > dep ? hp : dep);
  s.xs = o;    // rows x jcp: x8 over the CTA's J slice
  o += rows * jcp;
  s.fj = o;    // rows x JC0 int32
  o += rup16(rows * a[kJSlice] * 4);
  s.gj = o;
  o += rup16(rows * a[kJSlice] * 4);
  s.c = o;     // rows x L x U0 int32: the cell state of the CTA's units
  o += rup16(rows * a[kLayers] * a[kUnits] * 4);
  s.ebuf = o;  // rows x 2 x De float32: the current and the next frame
  o += rows * 2 * rup16(a[kDe] * 4);
  s.part = o;  // 2 step parities x rows x C x V int32: the partial logits
  o += rup16(2 * rows * a[kCluster] * a[kV] * 4);
  s.rows = o;
  o += rows * static_cast<int>(sizeof(Row));
  s.bar = o;
  o += 16;
  s.bytes = o;
  return s;
}

struct GreedyParams {
  const float* enc;
  const int32_t* lens;
  const int8_t* g8_in;
  const int8_t* h8_in;
  const int32_t* c_in;
  int8_t* g8_out;
  int8_t* h8_out;
  int32_t* c_out;
  int32_t* out;        // (B, 2 + T cap): symbols, joint steps, ids, -1 after them
  const int8_t* blob;  // C blobs of a[kBlobBytes] bytes
  float s_enc;
  int rows, groups;
  int a[kNumArgs];
};

__device__ __forceinline__ int dp4a4(const int4 x, const int4 w, int acc) {
  acc = __dp4a(x.x, w.x, acc);
  acc = __dp4a(x.y, w.y, acc);
  acc = __dp4a(x.z, w.z, acc);
  return __dp4a(x.w, w.w, acc);
}

template <bool kRes>
__device__ __forceinline__ int4 ldw(const int4* p) {
  if constexpr (kRes) {
    return *p;
  } else {
    return __ldg(p);
  }
}

template <bool kRes>
__device__ __forceinline__ int ldi(const int* p) {
  if constexpr (kRes) {
    return *p;
  } else {
    return __ldg(p);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(gemm_s8::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The dot products of a step run on groups of 8 lanes, 4 a warp, kSlots in
// the block: group slot w * 4 + g takes tasks slot, slot + kSlots, ...; a
// group's lanes split K, and the sums are reduced inside the group.
constexpr int kGroup = 8, kGroupsPerWarp = 4, kSlots = kWarps * kGroupsPerWarp;

// the sum of v over the lane's group of 8, in every lane of the group
__device__ __forceinline__ int group_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

// eight sums over the lane's group of 8 at once: returns, in group lane i,
// the group's sum of v[i] (each step hands half the values to the partner)
__device__ __forceinline__ int group_sums8(int (&v)[8], int gl) {
#pragma unroll
  for (int half = 4; half >= 1; half >>= 1) {
    const bool up = (gl & half) != 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const int send = up ? v[j] : v[j + half];
      const int keep = up ? v[j + half] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, half);
    }
  }
  return v[0];
}

template <bool kRes>
__global__ void __launch_bounds__(kThreads, 1) rnnt_greedy_kernel(const GreedyParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int* a = p.a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lg = lane / kGroup, gl = lane % kGroup;   // the lane's group, its lane in it
  const int C = a[kCluster], rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / C, n_cl = gridDim.x / C;
  const int B = a[kBatch], T = a[kT], De = a[kDe], H = a[kHid], L = a[kLayers], J = a[kJ];
  const int V = a[kV], cap = a[kCap], blank = a[kBlank], n8 = a[kN8];
  const int U0 = a[kUnits], JC0 = a[kJSlice];
  const int hp = rup16(H), dep = rup16(De), jcp = rup16(JC0);
  const int h16 = hp / 16, de16 = dep / 16, jc16 = jcp / 16, de4 = De / 4;
  const int u_lo = rank * U0, nu = max(0, min(H - u_lo, U0));
  const int k_lo = rank * JC0, nk = max(0, min(J - k_lo, JC0));
  const int R = p.rows;
  const int vec_len = hp > dep ? hp : dep, eb_len = rup16(De * 4) / 4;
  const long long row_out = 2 + static_cast<long long>(T) * cap;
  const StateLayout sl = state_layout(a, R);
  const int blob_bytes = a[kBlobBytes];
  const int8_t* blob = kRes ? reinterpret_cast<const int8_t*>(smem)
                            : p.blob + static_cast<long long>(rank) * blob_bytes;
  uint8_t* st = smem + (kRes ? blob_bytes : 0);
  int8_t* hbuf = reinterpret_cast<int8_t*>(st + sl.h);
  int8_t* vec = reinterpret_cast<int8_t*>(st + sl.vec);
  int8_t* xs = reinterpret_cast<int8_t*>(st + sl.xs);
  int* fj = reinterpret_cast<int*>(st + sl.fj);
  int* gj = reinterpret_cast<int*>(st + sl.gj);
  int* cst = reinterpret_cast<int*>(st + sl.c);
  float* ebuf = reinterpret_cast<float*>(st + sl.ebuf);
  int* part = reinterpret_cast<int*>(st + sl.part);
  Row* rs = reinterpret_cast<Row*>(st + sl.rows);
  uint64_t* bar = reinterpret_cast<uint64_t*>(st + sl.bar);
  auto hrow = [&](int r, int l, int par) { return hbuf + ((r * L + l) * 2 + par) * hp; };
  auto i32 = [&](int off) { return reinterpret_cast<const int*>(blob + off); };
  auto w16 = [&](int off) { return reinterpret_cast<const int4*>(blob + off); };
  const int4* embed = w16(a[kOffEmbed]);
  const int4* wenc = w16(a[kOffWenc]);
  const int4* wpred = w16(a[kOffWpred]);
  const int4* wout = w16(a[kOffWout]);
  const int *mf = i32(a[kOffMf]), *mg = i32(a[kOffMg]), *bj = i32(a[kOffBj]);
  const int *mo = i32(a[kOffMo]), *bo = i32(a[kOffBo]);
  const uint8_t* sig = reinterpret_cast<const uint8_t*>(blob + a[kOffSig]);
  const long long sb = a[kEncSB], stt = a[kEncST];
  const int e_f = a[kEF], e_g = a[kEG], e_o = a[kEO];
  const int m_c2 = a[kMC2], e_c2 = a[kEC2], m_h = a[kMH], e_h = a[kEH];

  if (kRes) {   // the blob into shared memory, once a launch
    if (tid == 0) {
      gemm_s8::mbar_init(bar, 1);
      gemm_s8::fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
      gemm_s8::mbar_expect_tx(bar, static_cast<uint32_t>(blob_bytes));
      const int8_t* src = p.blob + static_cast<long long>(rank) * blob_bytes;
      for (int o = 0; o < blob_bytes; o += kLoadChunk)
        qasr_bulk_load(smem + o, src + o, min(kLoadChunk, blob_bytes - o), bar);
    }
  }
  bool weights_ready = !kRes;

  // f_j of the rows entering a frame: wait for the frame's prefetch,
  // quantize it into vec, prefetch the next frame, then the J slice's dots
  auto frame_entry = [&](int nr, const long long b0) {
    cp_async_wait_all();
    __syncthreads();
    for (int i = tid; i < nr * dep; i += kThreads) {
      const int r = i / dep, k = i - r * dep;
      if (!rs[r].enter) continue;
      int q = 0;
      if (k < De) {
        const float x = ebuf[(r * 2 + (rs[r].t & 1)) * eb_len + k];
        float f = rintf(__fdiv_rn(x, p.s_enc));
        f = fminf(fmaxf(f, static_cast<float>(-n8)), static_cast<float>(n8));
        q = static_cast<int>(f);
      }
      vec[r * vec_len + k] = static_cast<int8_t>(q);
    }
    __syncthreads();
    for (int i = tid; i < nr * de4; i += kThreads) {
      const int r = i / de4, k = i - r * de4;
      const int t1 = rs[r].t + 1;
      if (!rs[r].enter || t1 >= rs[r].len) continue;
      cp_async16(ebuf + (r * 2 + (t1 & 1)) * eb_len + 4 * k,
                 p.enc + (b0 + r) * sb + t1 * stt + 4 * k);
    }
    cp_async_commit();
    // f_j, and x8 with the row's current g_j: a (row, joint column) a group
    for (int base = warp * kGroupsPerWarp; base < nr * nk; base += kSlots) {
      const int task = base + lg, r = task / nk, k = task - r * nk;
      const bool on = task < nr * nk && rs[r].enter;
      int acc = 0;
      if (on) {
        const int4* x4 = reinterpret_cast<const int4*>(vec + r * vec_len);
        const int4* w4 = wenc + k * de16;
        for (int i = gl; i < de16; i += kGroup) acc = dp4a4(x4[i], ldw<kRes>(w4 + i), acc);
      }
      acc = group_sum(acc);
      if (on && gl == 0) {
        const int f = qasr_requant(acc, ldi<kRes>(mf + k), e_f);
        fj[r * JC0 + k] = f;
        xs[r * jcp + k] = static_cast<int8_t>(
            qasr_clamp(f + gj[r * JC0 + k] + ldi<kRes>(bj + k), 0, n8));
      }
    }
  };

  // g_j over the J slice from g8 rows (from_vec: the carry's g8 in vec) or
  // from the emitting rows' new top h8
  auto pred_term = [&](int nr, bool from_vec) {
    for (int base = warp * kGroupsPerWarp; base < nr * nk; base += kSlots) {
      const int task = base + lg, r = task / nk, k = task - r * nk;
      const bool on = task < nr * nk && (from_vec || rs[r].emit);
      int acc = 0;
      if (on) {
        const int4* x4 = reinterpret_cast<const int4*>(
            from_vec ? vec + r * vec_len : hrow(r, L - 1, rs[r].epar ^ 1));
        const int4* w4 = wpred + k * h16;
        for (int i = gl; i < h16; i += kGroup) acc = dp4a4(x4[i], ldw<kRes>(w4 + i), acc);
      }
      acc = group_sum(acc);
      if (on && gl == 0) {
        const int g = qasr_requant(acc, ldi<kRes>(mg + k), e_g);
        gj[r * JC0 + k] = g;
        xs[r * jcp + k] = static_cast<int8_t>(
            qasr_clamp(fj[r * JC0 + k] + g + ldi<kRes>(bj + k), 0, n8));
      }
    }
  };

  for (int grp = cid; grp < p.groups; grp += n_cl) {
    const long long b0 = static_cast<long long>(grp) * R;
    const int nr = static_cast<int>(min(static_cast<long long>(R), B - b0));
    __syncthreads();   // the last group's outputs are written
    if (tid < R) {
      Row w{};
      if (tid < nr) {
        w.b = static_cast<int>(b0) + tid;
        w.len = min(max(p.lens[w.b], 0), T);
        w.active = w.len > 0;
        w.enter = w.active;
      }
      rs[tid] = w;
    }
    for (int i = tid; i < R * L * 2 * hp; i += kThreads) {
      const int k = i % hp, par = (i / hp) & 1, l = (i / (2 * hp)) % L, r = i / (2 * hp * L);
      int v = 0;
      if (par == 0 && r < nr && k < H) v = p.h8_in[(static_cast<long long>(l) * B + b0 + r) * H + k];
      hbuf[i] = static_cast<int8_t>(v);
    }
    for (int i = tid; i < R * L * U0; i += kThreads) {
      const int u = i % U0, l = (i / U0) % L, r = i / (U0 * L);
      cst[i] = (r < nr && u < nu)
                   ? p.c_in[(static_cast<long long>(l) * B + b0 + r) * H + u_lo + u] : 0;
    }
    for (int i = tid; i < R * vec_len; i += kThreads) {
      const int r = i / vec_len, k = i - r * vec_len;
      vec[i] = (r < nr && k < H) ? p.g8_in[(b0 + r) * H + k] : 0;
    }
    for (int i = tid; i < R * jcp; i += kThreads) xs[i] = 0;
    for (int i = tid; i < nr * de4; i += kThreads) {   // every row's first frame
      const int r = i / de4, k = i - r * de4;
      if (p.lens[b0 + r] > 0) cp_async16(ebuf + (r * 2) * eb_len + 4 * k, p.enc + (b0 + r) * sb + 4 * k);
    }
    cp_async_commit();
    __syncthreads();
    if (!weights_ready) {
      gemm_s8::mbar_wait(bar, 0);
      weights_ready = true;
    }
    pred_term(nr, true);
    __syncthreads();   // vec is read; it now takes the first frames
    frame_entry(nr, b0);
    __syncthreads();
    qasr_cluster_sync();    // every CTA's state is in place before any push

    const int max_steps = T * cap + 1;
    for (int sc = 0;; ++sc) {
      if (sc > max_steps) __trap();   // a bound no decode reaches
      const int par = sc & 1;
      // A: the partial logits over the J slice's x8 (kept current by the
      // frame entries and the g_j updates), a thread a (row, logit, CTA it
      // pushes to) where the block has the threads, else a (row, logit)
      const int fan = nr * V * C <= kThreads ? C : 1;
      for (int i = tid; i < nr * V * fan; i += kThreads) {
        const int q0 = i % fan, rv = i / fan, r = rv / V, v = rv - r * V;
        if (!rs[r].active) continue;
        const int4* x4 = reinterpret_cast<const int4*>(xs + r * jcp);
        const int4* w4 = wout + v * jc16;
        int s = 0;
        for (int m = 0; m < jc16; ++m) s = dp4a4(x4[m], ldw<kRes>(w4 + m), s);
        int* dst = part + ((par * R + r) * C + rank) * V + v;
        for (int q = q0; q < C; q += fan) *cluster.map_shared_rank(dst, q) = s;
      }
      qasr_cluster_sync();
      // B: the logits, the argmax and the row's decisions (a warp a row)
      if (warp < nr) {
        Row& w = rs[warp];
        if (w.active) {
          int bv = INT_MIN, bi = INT_MAX;
          const int* pp = part + (par * R + warp) * C * V;
          for (int v = lane; v < V; v += 32) {
            int acc = 0;
            for (int q = 0; q < C; ++q) acc += pp[q * V + v];
            const int logit = qasr_requant(acc, ldi<kRes>(mo + v), e_o) + ldi<kRes>(bo + v);
            if (logit > bv) {   // columns in increasing order: the first max stays
              bv = logit;
              bi = v;
            }
          }
          // the warp's best: the largest logit, then the lowest column that
          // holds it (each lane's best is its first maximum)
          const int best = __reduce_max_sync(0xffffffffu, bv);
          bi = static_cast<int>(__reduce_min_sync(
              0xffffffffu, static_cast<unsigned>(bv == best ? bi : INT_MAX)));
          if (lane == 0) {   // the row's state in registers, written back at once
            Row v = w;
            bool adv = true;
            v.steps += 1;
            v.emit = bi != blank;
            if (v.emit) {
              v.tok = bi;
              v.epar = v.nsym & 1;
              if (rank == 0) p.out[v.b * row_out + 2 + v.nsym] = bi;
              v.nsym += 1;
              v.emits += 1;
              adv = v.emits >= cap;
            }
            v.enter = 0;
            if (adv) {
              v.emits = 0;
              v.t += 1;
              v.active = v.t < v.len;
              v.enter = v.active;
            }
            w = v;
          }
        } else if (lane == 0) {
          w.emit = 0;
          w.enter = 0;
        }
      }
      __syncthreads();
      bool any_emit = false, any_enter = false, any_active = false;
      for (int r = 0; r < nr; ++r) {
        any_emit |= rs[r].emit != 0;
        any_enter |= rs[r].enter != 0;
        any_active |= rs[r].active != 0;
      }
      // C: the pred step of the emitting rows, layer by layer
      if (any_emit) {
        for (int l = 0; l < L; ++l) {
          const int* lo = a + kOffLayer + 8 * l;
          const int4* wi = w16(lo[kWi]);
          const int4* wh = w16(lo[kWh]);
          const int *mi = i32(lo[kMi]), *mh = i32(lo[kMh]), *bg = i32(lo[kBg]);
          const int *mi2 = i32(lo[kMi2]), *mh2 = i32(lo[kMh2]), *b2 = i32(lo[kB2]);
          const int ei = a[kExpLayer + 4 * l + kEi], eh = a[kExpLayer + 4 * l + kEh];
          const int ei2 = a[kExpLayer + 4 * l + kEi2], eh2 = a[kExpLayer + 4 * l + kEh2];
          // a (row, unit) a group of 8 lanes: the lanes split K for the
          // eight gate sums (x . wi and h8 . wh for gates i f g o), lane j
          // ends with sum j and requantizes it (the g gate on the doubled
          // grid); lanes 0-3 add their gate's two halves and take its
          // sigmoid, lane 0 steps the cell, and lane q pushes the new h8
          // byte to CTA q
          for (int base = warp * kGroupsPerWarp; base < nr * nu; base += kSlots) {
            const int task = base + lg, r = task / nu, u = task - r * nu;
            const bool on = task < nr * nu && rs[r].emit;
            int acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
            if (on) {
              const int ep = rs[r].epar;
              const int4* x4 = l == 0 ? embed + rs[r].tok * h16
                                      : reinterpret_cast<const int4*>(hrow(r, l - 1, ep ^ 1));
              const int4* h4 = reinterpret_cast<const int4*>(hrow(r, l, ep));
              const int4* wiu = wi + 4 * u * h16;
              const int4* whu = wh + 4 * u * h16;
              for (int i = gl; i < h16; i += kGroup) {
                const int4 xv = l == 0 ? ldw<kRes>(x4 + i) : x4[i];
                const int4 hv = h4[i];
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                  acc[g] = dp4a4(xv, ldw<kRes>(wiu + g * h16 + i), acc[g]);
                  acc[4 + g] = dp4a4(hv, ldw<kRes>(whu + g * h16 + i), acc[4 + g]);
                }
              }
            }
            const int sum = group_sums8(acc, gl);
            const int g = gl & 3;
            const bool hid = gl >= 4;
            int rq = 0;
            if (on) {
              const int col = 4 * u + g;
              const int m = g == 2 ? ldi<kRes>((hid ? mh2 : mi2) + u)
                                   : ldi<kRes>((hid ? mh : mi) + col);
              rq = qasr_requant(sum, m, g == 2 ? (hid ? eh2 : ei2) : (hid ? eh : ei));
            }
            rq += __shfl_xor_sync(0xffffffffu, rq, 4);   // lanes 0-3: a gate's two halves
            int sgl = 0;
            if (on && !hid) {
              const int pre = rq + (g == 2 ? ldi<kRes>(b2 + u) : ldi<kRes>(bg + 4 * u + g));
              sgl = qasr_i_sigmoid_tab(sig, qasr_clamp(pre, -kNIn, kNIn));
              if (g == 2) sgl = 2 * sgl - (1 << kKSig);   // tanh on the doubled grid
            }
            const int lane0 = lane & ~(kGroup - 1);
            const int s_f = __shfl_sync(0xffffffffu, sgl, lane0 + 1);
            const int tg = __shfl_sync(0xffffffffu, sgl, lane0 + 2);
            const int s_o = __shfl_sync(0xffffffffu, sgl, lane0 + 3);
            int h_new = 0;
            if (on && gl == 0) {
              int* cp = cst + (r * L + l) * U0 + u;
              const int c2 = qasr_clamp(
                  ((s_f * *cp + (1 << (kKSig - 1))) >> kKSig) + sgl * tg, -kCClip, kCClip);
              const int q2c = qasr_clamp(qasr_requant(c2, m_c2, e_c2), -kNIn, kNIn);
              const int h_fp = s_o * (2 * qasr_i_sigmoid_tab(sig, q2c) - (1 << kKSig));
              h_new = qasr_clamp(qasr_requant(h_fp, m_h, e_h), -127, 127);
              *cp = c2;
            }
            h_new = __shfl_sync(0xffffffffu, h_new, lane0);
            if (on && gl < C)
              *cluster.map_shared_rank(hrow(r, l, rs[r].epar ^ 1) + u_lo + u, gl) =
                  static_cast<int8_t>(h_new);
          }
          qasr_cluster_arrive();
          if (l == 0 && any_enter) {
            frame_entry(nr, b0);
            __syncthreads();   // its f_j and x8 are written before g_j reads them
          }
          qasr_cluster_wait();
        }
        pred_term(nr, false);
      } else if (any_enter) {
        frame_entry(nr, b0);
      }
      __syncthreads();
      if (!any_active) break;
    }

    // the group's outputs: each CTA its units' h8 and c; the first CTA g8,
    // the counts; the id tails -1 (split over the CTAs)
    for (int i = tid; i < nr * L * nu; i += kThreads) {
      const int u = i % nu, l = (i / nu) % L, r = i / (nu * L);
      const long long o = (static_cast<long long>(l) * B + b0 + r) * H + u_lo + u;
      p.h8_out[o] = hrow(r, l, rs[r].nsym & 1)[u_lo + u];
      p.c_out[o] = cst[(r * L + l) * U0 + u];
    }
    if (rank == 0) {
      for (int i = tid; i < nr * H; i += kThreads) {
        const int r = i / H, k = i - r * H;
        p.g8_out[(b0 + r) * H + k] =
            rs[r].nsym ? hrow(r, L - 1, rs[r].nsym & 1)[k] : p.g8_in[(b0 + r) * H + k];
      }
      if (tid < nr) {
        p.out[(b0 + tid) * row_out] = rs[tid].nsym;
        p.out[(b0 + tid) * row_out + 1] = rs[tid].steps;
      }
    }
    for (int r = 0; r < nr; ++r)
      for (long long i = 2 + rs[r].nsym + rank * kThreads + tid; i < row_out; i += C * kThreads)
        p.out[(b0 + r) * row_out + i] = -1;
  }
  qasr_cluster_sync();   // no CTA leaves while another may still read its memory
}

// Dependent rounds of one cluster barrier, each after every CTA has pushed
// a word into every CTA's shared memory (exchange != 0) and read what the
// others pushed: the latency floor of a decode step's exchange.
__global__ void __launch_bounds__(kThreads, 1) cluster_exchange_kernel(int iters, int exchange,
                                                                      int* out) {
  __shared__ int buf[2][kMaxCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = static_cast<int>(cluster.num_blocks());
  int acc = 0;
  for (int i = 0; i < iters; ++i) {
    if (exchange && threadIdx.x < n)
      *cluster.map_shared_rank(&buf[i & 1][rank], static_cast<int>(threadIdx.x)) = acc + i;
    qasr_cluster_sync();
    if (exchange) acc += buf[i & 1][threadIdx.x % n];
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
  qasr_cluster_sync();
}

// The clusters of `cluster` CTAs of the form that can be resident at once
// with `smem` bytes of dynamic shared memory each (cached a device).
int max_clusters(bool res, int cluster, int smem, cudaError_t* err) {
  static std::mutex mu;
  static std::map<std::tuple<int, bool, int, int>, int> cache;
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, res, cluster, smem);
  const auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  const void* fn = res ? reinterpret_cast<const void*>(rnnt_greedy_kernel<true>)
                       : reinterpret_cast<const void*>(rnnt_greedy_kernel<false>);
  *err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              gemm_s8::kSmemLimit);
  if (*err != cudaSuccess) return 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      qasr_cluster_launch_config(cluster, kThreads, cluster, smem, nullptr, &attr);
  int n = 0;
  *err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  if (*err != cudaSuccess) return 0;
  cache[key] = n;
  return n;
}

}  // namespace greedy

// The greedy decode of (B, T, De) float32 frames (enc, strides a[kEncSB],
// a[kEncST] floats, unit stride along De) with lengths `lens` (B, int32) on
// the device, from the carry (g8_in (B, H), h8_in (L, B, H), c_in (L, B,
// H)) into (g8_out, h8_out, c_out) (which may alias the inputs) and out (B,
// 2 + T cap): per row its symbols, its joint steps, its ids and -1 after
// them.  blob: the C CTAs' packed weights (kernels/rnnt_decoder.py::
// greedy_blob); a: the kNumArgs integer arguments.  The form is resident
// where the blob and one row's state fit in shared memory, else streamed;
// the rows a cluster steps together are the fewest that cover the batch in
// one wave of clusters (at most kMaxRows, as shared memory allows).  cfg
// (host, 4 ints) receives the plan: (resident, rows a cluster, clusters,
// dynamic shared memory bytes).
extern "C" int qasr_rnnt_greedy(const float* enc, const int32_t* lens, const int8_t* g8_in,
                                const int8_t* h8_in, const int32_t* c_in, int8_t* g8_out,
                                int8_t* h8_out, int32_t* c_out, int32_t* out,
                                const int8_t* blob, const int* args, int n_args, float s_enc,
                                int* cfg, void* stream) {
  using namespace greedy;
  if (n_args != kNumArgs || args == nullptr || cfg == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  GreedyParams p = {};
  std::memcpy(p.a, args, sizeof(p.a));
  const int* a = p.a;
  const int C = a[kCluster];
  if (a[kBatch] < 1 || a[kT] < 1 || a[kDe] < 4 || a[kDe] % 4 || a[kHid] < 4 || a[kHid] % 4 ||
      a[kLayers] < 1 || a[kLayers] > kMaxLayers || a[kJ] < 4 || a[kV] < 1 ||
      a[kNEmbed] < a[kV] || a[kCap] < 1 || a[kBlank] < 0 || a[kBlank] >= a[kV] || C < 1 ||
      C > kMaxCluster || a[kUnits] * C < a[kHid] || a[kJSlice] % 4 ||
      a[kJSlice] * C < a[kJ] || a[kBlobBytes] % 16 || a[kEncSB] % 4 || a[kEncST] % 4 ||
      static_cast<long long>(a[kT]) * a[kCap] + 2 > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blob_bytes = a[kBlobBytes];
  const bool res = blob_bytes + state_layout(a, 1).bytes <= gemm_s8::kSmemLimit;
  int rows = 0, maxc = 0, smem = 0;
  cudaError_t err = cudaSuccess;
  for (int r = 1; r <= kMaxRows; ++r) {
    const int s = (res ? blob_bytes : 0) + state_layout(a, r).bytes;
    if (s > gemm_s8::kSmemLimit) break;
    const int m = max_clusters(res, C, s, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (m < 1) break;
    rows = r;
    maxc = m;
    smem = s;
    if (static_cast<long long>(m) * r >= a[kBatch]) break;
  }
  if (rows == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  p.enc = enc;
  p.lens = lens;
  p.g8_in = g8_in;
  p.h8_in = h8_in;
  p.c_in = c_in;
  p.g8_out = g8_out;
  p.h8_out = h8_out;
  p.c_out = c_out;
  p.out = out;
  p.blob = blob;
  p.s_enc = s_enc;
  p.rows = rows;
  p.groups = (a[kBatch] + rows - 1) / rows;
  const int clusters = p.groups < maxc ? p.groups : maxc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t lc =
      qasr_cluster_launch_config(clusters * C, kThreads, C, smem, stream, &attr);
  err = res ? cudaLaunchKernelEx(&lc, rnnt_greedy_kernel<true>, p)
            : cudaLaunchKernelEx(&lc, rnnt_greedy_kernel<false>, p);
  cfg[0] = res;
  cfg[1] = rows;
  cfg[2] = clusters;
  cfg[3] = smem;
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// `iters` rounds of cluster_exchange_kernel on `clusters` clusters of
// `cluster` CTAs (kThreads threads each); out (clusters x cluster ints).
extern "C" int qasr_cluster_exchange(int iters, int cluster, int exchange, int clusters,
                                     int* out, void* stream) {
  using namespace greedy;
  if (iters < 0 || cluster < 1 || cluster > kMaxCluster || clusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t lc =
      qasr_cluster_launch_config(clusters * cluster, kThreads, cluster, 0, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&lc, cluster_exchange_kernel, iters, exchange, out);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
