// Kernel 9: the frozen transducer decoder's symbol step, an integer LSTM
// layer (rnnt_pred_step_kernel) and the integer joint with its argmax
// (rnnt_joint_kernel).
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

#include <cuda_runtime.h>

#include "conformer_int.cuh"
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
