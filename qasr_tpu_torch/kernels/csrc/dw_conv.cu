// dw_conv: integer depthwise 1-D conv over (B, T, C), int32 accumulate,
// with an optional input-requant prologue and an optional consumer epilogue.
//
// Replaces qasr_tpu/kernels/cm_fused.py::fused_dw_win_cm (_dw_win_call),
// fused_dw_win_tm (_dw_tm_call), fused_dw_cm (_dw_call), fused_dw_win_i32
// (_dw_win_i32_call), qasr_tpu/kernels/depthwise.py::depthwise_conv_int_pallas
// (_dw_call, and _dw_pad_call under QASR_DW_INKERNEL_PAD) and
// depthwise_fused_requant (_dw_fused_call).
//
//   prologue off: xq = x (int8, or uint8: a non-negative 9-bit code)
//   prologue on:  xq[b,t,c] = clamp(requant(mask_{t<in_len[b]}(relu?(x[b,t,c]
//                             + in_bias[c])), m1[c], e1[c]), lo1, hi1),
//                             x int8 or int32
//   y[b,t,c] = sum_k xq[b, t*s + k*d - pad, c] * w[k,c]    (zero padding)
//   epilogue off: out int32 = relu?(y + bias)
//   epilogue on:  out int8  = clamp(requant(mask_{t<len[b]}(relu?(y + bias)),
//                                           m[c], e[c]), lo, hi)
//   relu?(v) reads min(relu?(v), cap[c]) with a ceiling: hardtanh's clip to
//   [0, H[c]] (cap a (C,) vector or the scalar hs; INT_MAX: none), and the
//   prologue's relu?() min(relu?(), in_cap[c]) the same way.
//
// Each clamp is [-2^(bits-1), 2^(bits-1)-1] with an int8 result, or [0,
// 255] with a uint8 one: W8A8's 9-bit codes of a post-ReLU value (the
// wrapper's act_clamp), whose clamp [-256, 255] reads [0, 255] there.  The
// staged operand xq is then unsigned, and the products take the mixed-sign
// dp4a (kU8: PTX dp4a.u32.s32, u8 activations against s8 taps).
//
// Each of m, e, m1, e1 is a (C,) device vector or, when its pointer is NULL,
// the scalar passed by value; an exponent below 1 counts as 1 and one above
// 62 gives 0 (requant.cuh), as in the requant kernel and the JAX
// dyadic_requant.  The prologue is applied to every staged row, halo rows
// included, while the conv's zero padding (rows before frame 0 and from
// t_in on) stays 0: the requant of a materialized producer output happens
// here, in shared memory, instead of in a separate pass over device memory.
//
// What bounds it on an H100, at the slice's largest site (B=64, T=768,
// C=512, K=75): 25 MB in and 25 MB out, 0.01504 ms at 3.35 TB/s, against
// 1.89 G multiply-adds.  As __dp4a (four int8 products a lane) those are
// 0.47 G instructions, ~0.028 ms if IDP4A issues at the IMAD rate (64 lanes
// a clock on each of the 132 SMs, 1.98 GHz boost), so the integer pipe and
// not the bytes is the floor.  The requants of the prologue and epilogue
// (~13 integer instructions each with qasr_rq) are about as many
// instructions again where they are on.  Tensor cores do not fit: each
// channel is its own product with N = 1 (a banded Toeplitz matrix per
// channel would multiply mostly zeros), so the int8 MMA peak is no bound.
//
// Design: time-packed __dp4a.  A block owns 32 channels (threadIdx.x, so
// every global access is coalesced along C) and one time tile of TT = 16 *
// NT outputs (NT = blockDim.y thread rows, <= 16; the wrapper's
// kernels/dw_conv.py::plan picks NT so the tiles of a plane are even, TT up
// to 256).  Dilation d: outputs t = q + d*u of one phase q form a stride-s
// conv over the input frames q*s - pad + d*i, so the grid's x axis walks
// (phase, tile) pairs and each block stages only its phase's frames: the
// halo is K - 1 frames of that phase, not d*(K - 1) (C2, K=87 d=2: 280
// staged frames for 192 outputs, 1.46x; K=75 d=1: 1.30x at TT=256).  Stride
// s: the staged frames split into s sub-planes r (frames base + r*d +
// s*d*j), and sub-plane r meets the taps w[r + s*k'], contiguous in j; the
// C1 site (s=2, K=33) runs on the same path with two sub-planes of 17 taps.
//
// Staging writes each sub-plane channel-major with four consecutive frames
// of one channel packed into one 32-bit word (the row pitch odd, so a
// warp's 32 channels fall on 32 banks).  Where C is a multiple of 4, a
// thread loads 4 channels x 4 frames (4-byte int8 or 16-byte int32 loads),
// applies the prologue's requant to each element once, and transposes the
// 4 x 4 bytes with byte_perm; otherwise one channel a thread.  The taps of
// sub-plane r are packed the same way (P[g] = w_r[4g..4g+3]), then staged
// as four copies shifted by j = 0..3 bytes, Wj[g] = w_r[4g + i - j] for byte
// i, each a funnel shift of P[g - 1] and P[g] (ceil(K/s) padded to 4G, one
// more group for the shift), one int4 per (g, channel).
//
// A thread then owns one channel and 16 consecutive outputs u = 4a + j (a
// in 4 quads), and for each tap group g issues 16 x __dp4a(X[a + g], Wj[g])
// (s8 . s8, or u8 . s8 for uint8 codes): the window of output 4a + j at
// group g is exactly word a + g against taps shifted by j, so no byte
// shuffles are needed.  The 4
// input words slide in registers, renamed in rotation over 4 groups at a
// time (one shared-memory load a group, no moves), and the 4 shifted taps
// come in one 16-byte load: 16 dp4a and 2 loads for 64 multiply-adds.  The
// accumulators stay in registers to the epilogue, which folds its channel's
// mantissa and exponent into qasr_rq's constants once.  Three 512-thread
// blocks share an SM (__launch_bounds__ 40 registers; ptxas spills ~100
// bytes, in the staging), which measured ~10% faster than two blocks
// without spills at the per_channel sites.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int kCB = 32;     // channels per block (threadIdx.x)
constexpr int kMaxNT = 16;  // thread rows per block (the plan's NT <= 16)
constexpr int kPer = 16;    // output frames per thread: 4 quads of 4

// byte i of a packed word (unsigned, so that byte 3 shifts into the top bit)
__device__ __forceinline__ unsigned pack_byte(unsigned word, int v, int i) {
  return word | (static_cast<unsigned>(v & 0xff) << (8 * i));
}

// c + the four byte products of x and w: s8 . s8, or (kU8) u8 . s8 with
// x's bytes unsigned (PTX dp4a.u32.s32)
template <bool kU8>
__device__ __forceinline__ int dp4(int x, int w, int c) {
  if constexpr (kU8) {
    int d;
    asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(w), "r"(c));
    return d;
  } else {
    return __dp4a(x, w, c);
  }
}

// one tap group: output quad a (window word xa) against the 4 shifted taps
template <bool kU8>
__device__ __forceinline__ void dp4a_group(int (&acc)[kPer], int x0, int x1, int x2, int x3,
                                           const int4 wt) {
  const int win[4] = {x0, x1, x2, x3};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    acc[4 * a] = dp4<kU8>(win[a], wt.x, acc[4 * a]);
    acc[4 * a + 1] = dp4<kU8>(win[a], wt.y, acc[4 * a + 1]);
    acc[4 * a + 2] = dp4<kU8>(win[a], wt.z, acc[4 * a + 2]);
    acc[4 * a + 3] = dp4<kU8>(win[a], wt.w, acc[4 * a + 3]);
  }
}

// kExt: a hardtanh ceiling in the prologue or the epilogue
template <bool kU8, bool kExt>
__global__ void __launch_bounds__(kCB * kMaxNT, 3)
dw_conv_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
               const int32_t* __restrict__ bias, const int32_t* __restrict__ m, int ms,
               const int32_t* __restrict__ ev, int es, const int32_t* __restrict__ out_len,
               void* __restrict__ out, int t_in, int c_total, int t_out, int k_size,
               int stride, int pad, int dil, int relu, int epi, int lo, int hi, int pro,
               int x32, const int32_t* __restrict__ in_bias, int in_relu,
               const int32_t* __restrict__ in_len, const int32_t* __restrict__ m1, int m1s,
               const int32_t* __restrict__ e1v, int e1s, int lo1, int hi1, int groups,
               int tiles, int vec, const int32_t* __restrict__ hcap, int hs,
               const int32_t* __restrict__ in_hcap, int in_hs) {
  extern __shared__ int4 smem4[];
  const int nt = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int wp = 4 * nt + groups;         // staged words per sub-plane and channel
  const int pitch = (wp + 1) | 1;         // odd, and one spare word for the last slide
  const int ng = groups + 1;              // tap groups, one more for the shifts
  int4* ws = smem4;                       // [stride][ng][kCB] shifted taps
  int* ps = reinterpret_cast<int*>(smem4 + stride * ng * kCB);  // [stride][ng + 1][kCB]
  int* xs = ps + stride * (ng + 1) * kCB;                         // [stride][kCB][pitch]

  const int b = blockIdx.z;
  const int c = blockIdx.y * kCB + tx;
  const bool c_ok = c < c_total;
  const int q = blockIdx.x / tiles;       // the output phase t % dil
  const int u0 = (blockIdx.x - q * tiles) * (kPer * nt);
  // sub-plane r, word n, byte i holds input frame base + r*dil + step*(4n + i)
  const int base = (q + dil * u0) * stride - pad;
  const int step = dil * stride;
  const int ilen = in_len ? in_len[b] : INT_MAX;
  const size_t xrow = static_cast<size_t>(b) * t_in * c_total;  // batch b's frame 0

  if (vec) {
    // four channels a thread: (channel group cg, word n) items, each four
    // 4-byte (int8) or 16-byte (int32) loads of 4 channels x 4 frames,
    // requantized if the prologue is on, then transposed with byte_perm so
    // that each channel's 4 frames become one word; a warp's 8 groups x 4
    // words land on 32 banks
    const int lin = ty * kCB + tx;
    const int cg = lin & 7, slot = lin >> 3;
    const int cs = blockIdx.y * kCB + 4 * cg;
    const bool g_ok = cs < c_total;   // C % 4 == 0: all four channels or none
    const int8_t* xb = static_cast<const int8_t*>(x) + xrow + cs;
    const int32_t* xw = static_cast<const int32_t*>(x) + xrow + cs;
    for (int r = 0; r < stride; ++r) {
#pragma unroll 1
      for (int n = slot; n < wp; n += 4 * nt) {
        // the prologue's per-channel constants are folded per item (a
        // thread stages one or two), so that they do not hold registers
        // through the mainloop
        QasrRq rq[4];
        int ib[4], ih[4];
        if (pro) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int ck = g_ok ? cs + k : 0;
            ib[k] = in_bias ? in_bias[ck] : 0;
            ih[k] = kExt && in_hcap ? in_hcap[ck] : in_hs;
            rq[k] = qasr_rq_make(m1 ? m1[ck] : m1s, qasr_exponent(e1v, e1s, ck));
          }
        }
        unsigned a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = base + r * dil + step * (4 * n + i);
          a[i] = 0;   // the conv's zero padding, and masked frames (requant(0) = 0)
          if (!g_ok || t < 0 || t >= t_in || (pro && t >= ilen)) continue;
          const size_t o = static_cast<size_t>(t) * c_total;
          if (!pro) {
            a[i] = *reinterpret_cast<const unsigned*>(xb + o);
            continue;
          }
          int v[4];
          if (x32) {
            const int4 q = *reinterpret_cast<const int4*>(xw + o);
            v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
          } else {
            const unsigned q = *reinterpret_cast<const unsigned*>(xb + o);
#pragma unroll
            for (int k = 0; k < 4; ++k) v[k] = static_cast<int8_t>(q >> (8 * k));
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            int u = v[k] + ib[k];
            if (in_relu) u = u > 0 ? u : 0;
            if (kExt) u = min(u, ih[k]);
            a[i] = pack_byte(a[i], qasr_clamp(qasr_rq(u, rq[k]), lo1, hi1), k);
          }
        }
        const unsigned lo01 = __byte_perm(a[0], a[1], 0x5140);
        const unsigned hi01 = __byte_perm(a[0], a[1], 0x7362);
        const unsigned lo23 = __byte_perm(a[2], a[3], 0x5140);
        const unsigned hi23 = __byte_perm(a[2], a[3], 0x7362);
        int* row = xs + (r * kCB + 4 * cg) * pitch + n;
        row[0] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
        row[pitch] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
        row[2 * pitch] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
        row[3 * pitch] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
      }
    }
  } else {
    // one channel a thread (C not a multiple of 4, or x off a 16-byte
    // boundary): byte or word loads, packed four frames a word
    const int ib = (pro && c_ok && in_bias) ? in_bias[c] : 0;
    const int ih = (kExt && pro && c_ok && in_hcap) ? in_hcap[c] : in_hs;
    const QasrRq rq = qasr_rq_make(m1 ? m1[c_ok ? c : 0] : m1s,
                                   qasr_exponent(e1v, e1s, c_ok ? c : 0));
    const int8_t* xb = static_cast<const int8_t*>(x) + xrow + c;
    const int32_t* xw = static_cast<const int32_t*>(x) + xrow + c;
    for (int r = 0; r < stride; ++r) {
      for (int n = ty; n < wp; n += nt) {
        unsigned word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = base + r * dil + step * (4 * n + i);
          if (!c_ok || t < 0 || t >= t_in || (pro && t >= ilen)) continue;
          const size_t o = static_cast<size_t>(t) * c_total;
          if (!pro) {
            word = pack_byte(word, xb[o], i);
            continue;
          }
          int u = (x32 ? xw[o] : static_cast<int>(xb[o])) + ib;
          if (in_relu) u = u > 0 ? u : 0;
          if (kExt) u = min(u, ih);
          word = pack_byte(word, qasr_clamp(qasr_rq(u, rq), lo1, hi1), i);
        }
        xs[(r * kCB + tx) * pitch + n] = static_cast<int>(word);
      }
    }
  }
  // taps, phase 1: P_r[g] = w[r + s*(4g + i)] for byte i, packed (zero
  // outside the taps); P_r[-1] = 0 sits at index 0
  if (vec) {
    const int lin = ty * kCB + tx;
    const int cg = lin & 7;
    const int cs = blockIdx.y * kCB + 4 * cg;
    for (int it = lin >> 3; it < stride * ng; it += 4 * nt) {
      const int r = it / ng, g = it - r * ng;
      unsigned a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = r + stride * (4 * g + i);
        a[i] = cs < c_total && k < k_size
                   ? *reinterpret_cast<const unsigned*>(w + static_cast<size_t>(k) * c_total + cs)
                   : 0u;
      }
      const unsigned lo01 = __byte_perm(a[0], a[1], 0x5140);
      const unsigned hi01 = __byte_perm(a[0], a[1], 0x7362);
      const unsigned lo23 = __byte_perm(a[2], a[3], 0x5140);
      const unsigned hi23 = __byte_perm(a[2], a[3], 0x7362);
      int* pw = ps + (r * (ng + 1) + g + 1) * kCB + 4 * cg;
      pw[0] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
      pw[1] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
      pw[2] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
      pw[3] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
    }
  } else {
    for (int it = ty; it < stride * ng; it += nt) {
      const int r = it / ng, g = it - r * ng;
      unsigned word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = r + stride * (4 * g + i);
        if (c_ok && k < k_size) word = pack_byte(word, w[static_cast<size_t>(k) * c_total + c], i);
      }
      ps[(r * (ng + 1) + g + 1) * kCB + tx] = static_cast<int>(word);
    }
  }
  for (int r = ty; r < stride; r += nt) ps[r * (ng + 1) * kCB + tx] = 0;
  __syncthreads();
  // phase 2: the copy shifted by j bytes, Wj[g] byte i = w_r[4g + i - j],
  // is P[g] funnel-shifted in from P[g - 1]
  for (int it = ty; it < stride * ng; it += nt) {
    const int r = it / ng, g = it - r * ng;
    const unsigned lo = static_cast<unsigned>(ps[(r * (ng + 1) + g) * kCB + tx]);
    const unsigned hi = static_cast<unsigned>(ps[(r * (ng + 1) + g + 1) * kCB + tx]);
    ws[(r * ng + g) * kCB + tx] =
        make_int4(static_cast<int>(hi), static_cast<int>(__funnelshift_r(lo, hi, 24)),
                  static_cast<int>(__funnelshift_r(lo, hi, 16)),
                  static_cast<int>(__funnelshift_r(lo, hi, 8)));
  }
  __syncthreads();
  if (!c_ok) return;

  int acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0;
  for (int r = 0; r < stride; ++r) {
    const int* xr = xs + (r * kCB + tx) * pitch + 4 * ty;
    const int4* wr = ws + r * ng * kCB + tx;
    int x0 = xr[0], x1 = xr[1], x2 = xr[2], x3 = xr[3];
    // four groups a turn with the window's registers renamed in rotation
    // (the word a group has used takes the next one), so nothing is moved
    int g = 0;
    for (; g + 4 <= ng; g += 4) {
      dp4a_group<kU8>(acc, x0, x1, x2, x3, wr[g * kCB]);
      x0 = xr[g + 4];
      dp4a_group<kU8>(acc, x1, x2, x3, x0, wr[(g + 1) * kCB]);
      x1 = xr[g + 5];
      dp4a_group<kU8>(acc, x2, x3, x0, x1, wr[(g + 2) * kCB]);
      x2 = xr[g + 6];
      dp4a_group<kU8>(acc, x3, x0, x1, x2, wr[(g + 3) * kCB]);
      x3 = xr[g + 7];   // at the last group one word past the plane: unused
    }
    for (; g < ng; ++g) {
      dp4a_group<kU8>(acc, x0, x1, x2, x3, wr[g * kCB]);
      x0 = x1;
      x1 = x2;
      x2 = x3;
      x3 = xr[g + 4];
    }
  }

  const int bc = bias ? bias[c] : 0;
  const int hc = kExt && hcap ? hcap[c] : hs;
  const QasrRq rq = qasr_rq_make(epi ? (m ? m[c] : ms) : 0, epi ? qasr_exponent(ev, es, c) : 1);
  const int len = out_len ? out_len[b] : INT_MAX;
  const int t0 = q + dil * (u0 + kPer * ty);
  // output j sits dil * C elements after output j - 1
  const size_t o0 = (static_cast<size_t>(b) * t_out + t0) * c_total + c;
  int8_t* out8 = static_cast<int8_t*>(out) + o0;
  int32_t* out32 = static_cast<int32_t*>(out) + o0;
  const int dc = dil * c_total;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int t = t0 + dil * j;
    if (t >= t_out) break;
    int v = acc[j] + bc;
    if (relu) v = v > 0 ? v : 0;
    if (kExt) v = min(v, hc);
    if (epi) {
      if (t >= len) v = 0;
      *out8 = static_cast<int8_t>(qasr_clamp(qasr_rq(v, rq), lo, hi));
      out8 += dc;
    } else {
      *out32 = v;
      out32 += dc;
    }
  }
}

}  // namespace

template <bool kU8, bool kExt>
cudaError_t launch(dim3 grid, dim3 block, size_t shm, cudaStream_t stream, const void* x,
                   const int8_t* w, const int32_t* bias, const int32_t* m, int ms,
                   const int32_t* ev, int es, const int32_t* out_len, void* out, int t_in,
                   int c_total, int t_out, int k_size, int stride, int pad, int dil, int relu,
                   int epi, int lo, int hi, int pro, int x32, const int32_t* in_bias,
                   int in_relu, const int32_t* in_len, const int32_t* m1, int m1s,
                   const int32_t* e1v, int e1s, int lo1, int hi1, int groups, int tiles,
                   int vec, const int32_t* hcap, int hs, const int32_t* in_hcap, int in_hs) {
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dw_conv_kernel<kU8, kExt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shm));
    if (err != cudaSuccess) return err;
  }
  dw_conv_kernel<kU8, kExt><<<grid, block, shm, stream>>>(
      x, w, bias, m, ms, ev, es, out_len, out, t_in, c_total, t_out, k_size, stride, pad, dil,
      relu, epi, lo, hi, pro, x32, in_bias, in_relu, in_len, m1, m1s, e1v, e1s, lo1, hi1,
      groups, tiles, vec, hcap, hs, in_hcap, in_hs);
  return cudaGetLastError();
}

// nt, groups, tiles: the wrapper's plan (thread rows, tap groups of 4 per
// sub-plane, time tiles per output phase); shared memory follows from them.
// u8: the staged operand is unsigned (a uint8 x, or a prologue that writes
// uint8 codes).  hcap / hs, in_hcap / in_hs: hardtanh's ceilings.
extern "C" int qasr_dw_conv(const void* x, const int8_t* w, const int32_t* bias,
                            const int32_t* m, int ms, const int32_t* ev, int es,
                            const int32_t* out_len, void* out, int batch, int t_in,
                            int c_total, int t_out, int k_size, int stride, int pad, int dil,
                            int relu, int epi, int lo, int hi, int pro, int x32,
                            const int32_t* in_bias, int in_relu, const int32_t* in_len,
                            const int32_t* m1, int m1s, const int32_t* e1v, int e1s, int lo1,
                            int hi1, int nt, int groups, int tiles, int u8, const int32_t* hcap,
                            int hs, const int32_t* in_hcap, int in_hs, void* stream) {
  if (nt < 1 || nt > kMaxNT || groups < 1 || tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int phases = dil < t_out ? dil : t_out;
  // staging four channels a thread needs whole 4-channel words and, for
  // the 16-byte int32 loads, a 16-byte aligned x (and a 4-byte aligned w)
  const int vec = c_total % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                  && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const int pitch = (4 * nt + groups + 1) | 1;
  const size_t shm = 16ull * stride * (groups + 1) * kCB + 4ull * stride * (groups + 2) * kCB
                     + 4ull * stride * kCB * pitch;
  const dim3 grid(phases * tiles, (c_total + kCB - 1) / kCB, batch);
  const dim3 block(kCB, nt);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ext = hcap || hs != INT_MAX || in_hcap || in_hs != INT_MAX;
  const auto run = u8 ? (ext ? launch<true, true> : launch<true, false>)
                       : (ext ? launch<false, true> : launch<false, false>);
  const cudaError_t rc = run(grid, block, shm, st, x, w, bias, m, ms, ev, es, out_len, out, t_in,
                             c_total, t_out, k_size, stride, pad, dil, relu, epi, lo, hi, pro,
                             x32, in_bias, in_relu, in_len, m1, m1s, e1v, e1s, lo1, hi1, groups,
                             tiles, vec, hcap, hs, in_hcap, in_hs);
  return static_cast<int>(rc);
}
