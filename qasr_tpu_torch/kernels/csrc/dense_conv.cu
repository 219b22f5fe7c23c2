// dense_conv: a dense (non-grouped) integer 1-D conv over (B, T, Cin) as an
// implicit GEMM, int32 accumulate, with Kernel 2's input-requant prologue
// and its three epilogues.  Jasper10x5Dr's convs (K 11 to 29, stride 2 at
// the first, dilation 2 at the last block) run here.
//
// Replaces no Pallas kernel: the JAX package leaves this conv to XLA
// (qasr_tpu/models/jasper.py:332, conv_nwc's lax.conv_general_dilated with
// preferred_element_type=int32).  It was written because the port has no
// other integer dense conv: a library conv would be a yardstick, not a port.
//
//   prologue off: a = x int8, or uint8 (a non-negative 9-bit code)
//   prologue on:  a[b,t,i] = clamp(requant(mask_{t < in_len[b]}(relu?(x[b,t,i]
//                            + in_bias[i])), m1[i], e1), lo1, hi1),
//                            x int8 or int32, m1 a (Cin,) vector or (NULL)
//                            the scalar m1s
//   acc[b,t,o] = sum_k sum_i a[b, t*s + k*d - pad, i] * w[o, k, i]
//                (frames outside [0, t_in) read 0)
//   mode 0 (none):    out int32 = relu?(acc + bias)
//   mode 1 (requant): out int8  = clamp(requant(mask_{t < len[b]}(
//                                       relu?(acc + bias)), m[o], e), lo, hi)
//   mode 2 (join):    out int8  = clamp(requant(acc + bias, m[o], e)
//                                       + requant(res[b,t,o], m_r[o], e_r), lo, hi)
//   a clamp is [-2^(bits-1), 2^(bits-1)-1] with an int8 result, or [0, 255]
//   with a uint8 one (W8A8's 9-bit codes of a ReLU'd value, the wrapper's
//   act_clamp).  With a uint8 operand (kU8) the products are mma.sync's
//   .u8.s8 form.
//
// Accumulators: |acc| <= K * Cin * 255 * 127 = 7.2e8 < 2^31 at Jasper's
// widest site (K 29 x Cin 768 = 22,272, a uint8 operand, 8-bit weights).
//
// What bounds it on an H100: the operations.  One Jasper10x5Dr forward at
// B=64 x 15 s (48,064 rows after the stride) is 325 M multiply-adds a row,
// ~31 T int8 operations, 15.8 ms at 1,979 TOP/s, against some 2 GB of
// activations in and out (0.6 ms at 3.35 TB/s).
//
// Design (simple and right first): a block owns BM = 128 consecutive output
// frames of one batch element and keeps their input rows plus the halo,
// (BM - 1) * s + (K - 1) * d + 1 rows of Cin bytes, resident in shared
// memory: the prologue requantizes each element once, and no im2col exists
// in device memory.  The block then walks its share of Cout in tiles of BN
// = 128 (grid z splits Cout where the batch leaves the card short of
// blocks); for each tile the K loop runs over (tap, 128-byte Cin chunk),
// the weights (Cout, K, Cin) streaming through a 4-stage cp.async ring.  Eight
// warps (2 x 4) each own a 64 x 32 tile of m16n8k32 mma.sync products whose
// A fragments ldmatrix reads straight from the shifted window of the
// resident tile (row i of tap k is halo row i*s + k*d: any row offset, which
// a swizzled wgmma layout would not take).  Row pitches are padded by 16
// bytes so that eight rows fall on distinct banks.  The epilogue runs from
// the accumulator registers.  Its plan is kernels/dense_conv.py::plan.
// A step is bound by its barrier and its integer overhead more than by the
// L2 (a deeper ring did not help): hence K steps of 128 bytes (64 products
// a warp between barriers), and the (tile, tap, chunk) counters and the
// ldmatrix offsets kept in registers instead of divisions a step.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"
#include "tile_s8.cuh"

namespace {

constexpr int kBM = 128;      // output frames per block
constexpr int kBN = 128;      // output channels per Cout tile
constexpr int kKC = 128;      // bytes of Cin per K step
constexpr int kWP = kKC + 16; // weight tile row pitch (bytes)
constexpr int kStages = 4;    // the weight ring
constexpr int kThreads = 256; // 8 warps: 2 along the frames x 4 along Cout

struct DcParams {
  const void* x;
  const int8_t* w;        // (Cout, K, Cin)
  const int32_t* bias;
  const int32_t* m;
  const int32_t* lens;
  const int32_t* res;
  const int32_t* m_r;
  void* out;
  int t_in, cin, t_out, cout, k_size, stride, pad, dil;
  int mode, relu, e, e_r, lo, hi;
  int pro, x32;
  const int32_t* in_bias;
  int in_relu;
  const int32_t* in_len;
  const int32_t* m1;
  int m1s, e1, lo1, hi1;
  int nc;        // Cin chunks of kKC bytes
  int rows_h;    // resident rows (output tile + halo)
  int pitch;     // resident row pitch, nc * kKC + 16
  int ct_per;    // Cout tiles per grid-z slice
};

// the A operand m16n8k32 with a s8 or (kU8) u8, b s8
template <bool kU8>
__device__ __forceinline__ void mma(int (&c)[4], const int (&a)[4], int b0, int b1) {
  if constexpr (kU8)
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    qasr_mma_s8(c, a, b0, b1);
}

// The block's resident rows: halo row h is input frame base + h of batch
// b, 16 channels (one granule) an item; zero outside [0, t_in), past
// in_len with the prologue, and past Cin.
__device__ void fill_a(const DcParams& p, uint8_t* a_tile, int b, int base) {
  const int gpr = p.nc * (kKC / 16);     // granules a row, Cin padded to the chunk
  const int cg = p.cin / 16;             // granules that hold channels
  const int ilen = p.in_len ? p.in_len[b] : INT_MAX;
  const size_t xrow = static_cast<size_t>(b) * p.t_in;
  for (int it = threadIdx.x; it < p.rows_h * gpr; it += kThreads) {
    const int h = it / gpr, g = it - h * gpr;
    const int t = base + h;
    uint8_t* dst = a_tile + h * p.pitch + 16 * g;
    const bool live = g < cg && t >= 0 && t < p.t_in && (!p.pro || t < ilen);
    const size_t off = (xrow + (live ? t : 0)) * p.cin + 16 * (live ? g : 0);
    if (!p.pro) {
      qasr_cp16(dst, static_cast<const int8_t*>(p.x) + off, live ? 16 : 0);
      continue;
    }
    int4 word = make_int4(0, 0, 0, 0);
    if (live) {
      int v[16];
      if (p.x32) {
        const int4* s = reinterpret_cast<const int4*>(static_cast<const int32_t*>(p.x) + off);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int4 q = s[k];
          v[4 * k] = q.x, v[4 * k + 1] = q.y, v[4 * k + 2] = q.z, v[4 * k + 3] = q.w;
        }
      } else {
        const int4 q = *reinterpret_cast<const int4*>(static_cast<const int8_t*>(p.x) + off);
        const int w4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = static_cast<int8_t>(w4[k / 4] >> (8 * (k % 4)));
      }
      unsigned wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int c = 16 * g + k;
        int z = v[k] + (p.in_bias ? p.in_bias[c] : 0);
        if (p.in_relu) z = z > 0 ? z : 0;
        const int r = qasr_clamp(qasr_requant(z, p.m1 ? p.m1[c] : p.m1s, p.e1), p.lo1, p.hi1);
        wd[k / 4] |= (static_cast<unsigned>(r) & 0xffu) << (8 * (k % 4));
      }
      word = make_int4(static_cast<int>(wd[0]), static_cast<int>(wd[1]),
                       static_cast<int>(wd[2]), static_cast<int>(wd[3]));
    }
    *reinterpret_cast<int4*>(dst) = word;
  }
  qasr_cp_commit();
}

// The K step (tap, c) of Cout tile `ct`: the weights w[ct*BN + n, tap,
// c*KC + j] (n < BN, j < KC) into a ring slot, zero past Cout and past Cin.
__device__ __forceinline__ void load_w(const DcParams& p, uint8_t* slot, int ct, int tap,
                                       int c) {
  const size_t krow = static_cast<size_t>(p.k_size) * p.cin;
  const int8_t* w0 = p.w + static_cast<size_t>(tap) * p.cin + c * kKC;
#pragma unroll
  for (int k = 0; k < kBN * (kKC / 16) / kThreads; ++k) {
    const int it = threadIdx.x + k * kThreads;
    const int n = it / (kKC / 16), g = it % (kKC / 16);
    const int o = ct * kBN + n;
    const bool live = o < p.cout && c * kKC + 16 * g < p.cin;
    qasr_cp16(slot + n * kWP + 16 * g, live ? w0 + o * krow + 16 * g : p.w, live ? 16 : 0);
  }
}

// the next K step: (tap, chunk) in order, then the next Cout tile
__device__ __forceinline__ void next_step(const DcParams& p, int& ct, int& tap, int& c) {
  if (++c == p.nc) {
    c = 0;
    if (++tap == p.k_size) {
      tap = 0;
      ++ct;
    }
  }
}

template <bool kU8>
__global__ void __launch_bounds__(kThreads, 1) dense_conv_kernel(const DcParams p) {
  extern __shared__ int4 smem4[];
  uint8_t* a_tile = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* ring = a_tile + p.rows_h * p.pitch;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;   // the warp's 64 frames x 32 channels
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kBM;
  const int n_ct = (p.cout + kBN - 1) / kBN;
  const int ct0 = blockIdx.z * p.ct_per;
  const int ct1 = min(n_ct, ct0 + p.ct_per);
  if (ct0 >= ct1) return;
  const int steps = (ct1 - ct0) * p.k_size * p.nc;

  fill_a(p, a_tile, b, t0 * p.stride - p.pad);   // one cp.async group (empty with the prologue)
  int pf_ct = ct0, pf_tap = 0, pf_c = 0;        // the next K step to prefetch
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      load_w(p, ring + s * kBN * kWP, pf_ct, pf_tap, pf_c);
      next_step(p, pf_ct, pf_tap, pf_c);
    }
    qasr_cp_commit();
  }

  // ldmatrix lane offsets, fixed for the block: A rows (a frame of a
  // 16-row tile at halo row frame * stride, a K half), B rows (a channel
  // of a 16-column pair, a K half)
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_k = 16 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_k = 16 * ((lane >> 3) & 1);
  int a_off[4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) a_off[mt] = (wm * 64 + 16 * mt + a_row) * p.stride * p.pitch + a_k;
  const int b_off = (wn * 32 + b_row) * kWP + b_k;
  int acc[4][4][4];
  int ct = ct0, tap = 0, c = 0;                 // this K step
  for (int step = 0; step < steps; ++step) {
    if (tap == 0 && c == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;
    }
    qasr_cp_wait<kStages - 2>();
    __syncthreads();   // this step's slot has landed; the slot refilled below is free
    if (step + kStages - 1 < steps) {
      load_w(p, ring + ((step + kStages - 1) % kStages) * kBN * kWP, pf_ct, pf_tap, pf_c);
      next_step(p, pf_ct, pf_tap, pf_c);
    }
    qasr_cp_commit();
    const uint8_t* slot = ring + (step % kStages) * kBN * kWP + b_off;
    const uint8_t* a_step = a_tile + tap * p.dil * p.pitch + c * kKC;
    const int k32s = min(kKC / 32, (p.cin - c * kKC) / 32 + ((p.cin - c * kKC) % 32 != 0));
#pragma unroll
    for (int k32 = 0; k32 < kKC / 32; ++k32) {
      if (k32 >= k32s) break;   // past Cin: zeros (Cin = 64 at Jasper's first conv)
      int af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) qasr_ldsm4(af[mt], a_step + a_off[mt] + 32 * k32);
      int bf[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np) qasr_ldsm4(bf[np], slot + 16 * np * kWP + 32 * k32);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma<kU8>(acc[mt][nt], af[mt], bf[nt >> 1][2 * (nt & 1)], bf[nt >> 1][2 * (nt & 1) + 1]);
    }
    const bool last = tap == p.k_size - 1 && c == p.nc - 1;
    const int ct_now = ct;
    next_step(p, ct, tap, c);
    if (!last) continue;

    // the epilogue of Cout tile ct_now, from the registers: thread holds
    // rows wm*64 + 16*mt + lane/4 (+8) and columns wn*32 + 8*nt +
    // 2*(lane%4) (+1)
    const int len = p.lens ? p.lens[b] : INT_MAX;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int o = ct_now * kBN + wn * 32 + 8 * nt + 2 * (lane & 3) + q;
        if (o >= p.cout) continue;
        const int bo = p.bias ? p.bias[o] : 0;
        const int mo = p.mode ? p.m[o] : 0;
        const int mro = p.mode == 2 ? p.m_r[o] : 0;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + wm * 64 + 16 * mt + (lane >> 2) + 8 * h;
            if (t >= p.t_out) continue;
            const size_t idx = (static_cast<size_t>(b) * p.t_out + t) * p.cout + o;
            int v = acc[mt][nt][2 * h + q] + bo;
            if (p.mode == 0) {
              static_cast<int32_t*>(p.out)[idx] = p.relu && v < 0 ? 0 : v;
            } else if (p.mode == 1) {
              if (p.relu) v = v > 0 ? v : 0;
              if (t >= len) v = 0;
              static_cast<int8_t*>(p.out)[idx] =
                  static_cast<int8_t>(qasr_clamp(qasr_requant(v, mo, p.e), p.lo, p.hi));
            } else {
              const int r = qasr_requant(v, mo, p.e) + qasr_requant(p.res[idx], mro, p.e_r);
              static_cast<int8_t*>(p.out)[idx] = static_cast<int8_t>(qasr_clamp(r, p.lo, p.hi));
            }
          }
        }
      }
    }
  }
  qasr_cp_wait<0>();
}

template <bool kU8>
cudaError_t launch(const DcParams& p, dim3 grid, size_t smem, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      dense_conv_kernel<kU8>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  dense_conv_kernel<kU8><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// ct_per: Cout tiles a grid-z slice owns (the wrapper's plan, which also
// computes the same shared memory); u8: the operand the products read is
// unsigned (a uint8 x, or a prologue that writes uint8 codes).
extern "C" int qasr_dense_conv(const void* x, const int8_t* w, const int32_t* bias,
                               const int32_t* m, const int32_t* lens, const int32_t* res,
                               const int32_t* m_r, void* out, int batch, int t_in, int cin,
                               int t_out, int cout, int k_size, int stride, int pad, int dil,
                               int mode, int relu, int e, int e_r, int lo, int hi, int pro,
                               int x32, const int32_t* in_bias, int in_relu,
                               const int32_t* in_len, const int32_t* m1, int m1s, int e1,
                               int lo1, int hi1, int u8, int ct_per, void* stream) {
  if (batch < 1 || t_out < 1 || cout < 1 || cin < 16 || cin % 16 != 0 || k_size < 1 ||
      stride < 1 || dil < 1 || mode < 0 || mode > 2 || ct_per < 1 || (!pro && x32) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DcParams p{x, w, bias, m, lens, res, m_r, out, t_in, cin, t_out, cout, k_size, stride, pad,
             dil, mode, relu, e, e_r, lo, hi, pro, x32, in_bias, in_relu, in_len, m1, m1s, e1,
             lo1, hi1, 0, 0, 0, ct_per};
  p.nc = (cin + kKC - 1) / kKC;
  p.rows_h = (kBM - 1) * stride + (k_size - 1) * dil + 1;
  p.pitch = p.nc * kKC + 16;
  const size_t smem = static_cast<size_t>(p.rows_h) * p.pitch + kStages * kBN * kWP;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const int n_ct = (cout + kBN - 1) / kBN;
  const dim3 grid((t_out + kBM - 1) / kBM, batch, (n_ct + ct_per - 1) / ct_per);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(u8 ? launch<true>(p, grid, smem, st) : launch<false>(p, grid, smem, st));
}
