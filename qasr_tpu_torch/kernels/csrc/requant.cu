// requant: elementwise dyadic requantization of a (B, T, C) activation,
// with per-channel (vector) or scalar mantissas and exponents, an optional
// ReLU and length mask on the input, and an optional residual join.
//
// Replaces qasr_tpu/kernels/requant.py::requant_pallas (pl.pallas_call at
// requant.py:65 and :74).  For row n = b * T + t and channel c:
//
//   v   = mask_{t < lens[b]}(min(relu?(z[n, c]), cap[c]))
//   s   = requant(v, m[c], e[c]) [+ requant(mask(id[n, c]), m_r[c], e_r[c])]
//   out = clamp(s, lo, hi)
//
// cap is hardtanh's ceiling (the producer's clip to [0, H[c]] before this
// requant, the JAX FrozenExec's order): a (C,) vector, or the scalar hs
// when its pointer is NULL (INT_MAX: no ceiling).
// z is int8, int32 or uint8 (a non-negative 9-bit code).  The output is
// int8 with [lo, hi] = [-2^(bits-1), 2^(bits-1) - 1] when bits <= 8; uint8
// with [0, 255] for a 9-bit requant of a non-negative value (ReLU on, or a
// uint8 z, and no identity: the clamp [-256, 255] reads [0, 255] there),
// the same low-byte store; int32 for any other (the wrapper's out_dtype).
// A signed 9-bit code v in [-256, 255] (W8A8's asymmetric sites after selu
// or swish) is written as two uint8 planes, v = u - 256 s: the low byte u
// = v & 255 by the same low-byte store into out, and the sign s = (v < 0)
// into out_s (NULL for every other output), so that the uint8 forms of
// Kernels 1, 2 and 8 multiply each plane and conv(W, v) = conv(W, u) -
// 256 conv(W, s) (kernels/checks.py::act_dtype).
//
// with requant the shared device function of requant.cuh (exponents below
// 1 count as 1, above 62 give 0, as the plain torch version and the JAX
// dyadic_requant clamp them).  Each of m, e, m_r, e_r is a (C,) device
// vector or, when its pointer is NULL, the scalar passed by value.
//
// What bounds it on an H100: the bytes.  At a per_channel QuartzNet site
// (B=64, T=768, C=512) it reads 100 MB of int32 and writes 25 MB of int8,
// 0.0376 ms at 3.35 TB/s (0.0676 ms for a join, which reads a second 100
// MB); the requant is some 20-35 integer instructions per element (one
// 64-bit product), below the card's integer rate at that byte count.
//
// Design: a (row tile, channel vector, batch) grid.  A thread owns V = 4
// consecutive channels (the element path, V = 1, where C is not a multiple
// of 4 or a tensor does not start on a 16-byte boundary), folds their m, e,
// m_r and e_r into the hoisted requant constants of requant.cuh (qasr_rq)
// once, and takes 4 rows of its tile (blockDim.y apart): their loads are
// issued together, then per row 4 requants of ~15 instructions and one
// 16-byte (int32) or 4-byte (int8) store; per row and warp that is 128
// contiguous channels, 512 bytes of int32 input.  The batch
// index comes from the grid, so the length mask is one compare per row with
// no division per element, and a masked row is written 0 without being
// read.  (16 channels a thread, one 16-byte int8 store, held 16 x 4
// requant operands in registers: 229 of them, one block per SM, and the
// join ran slower than the one-element-a-thread kernel it replaced.)  The
// launcher's plan is kernels/requant.py::plan.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

struct Side {
  const void* z;      // int8, int32 or uint8 (B*T, C)
  int zt;             // z's type: 0 int8, 1 int32, 2 uint8
  const int32_t* m;   // (C,) or NULL -> ms
  const int32_t* e;   // (C,) or NULL -> es
  int ms, es;
};

// the V values at element idx of z (idx a multiple of V; V = 4 needs a
// 16-byte aligned z, which the launcher checks, and C a multiple of 4)
template <int V>
__device__ __forceinline__ void load_vals(const Side& s, size_t idx, int (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = s.zt == 1 ? __ldg(static_cast<const int32_t*>(s.z) + idx)
         : s.zt == 2 ? static_cast<int>(__ldg(static_cast<const uint8_t*>(s.z) + idx))
                     : static_cast<int>(__ldg(static_cast<const int8_t*>(s.z) + idx));
  } else if (s.zt == 1) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(static_cast<const int32_t*>(s.z) + idx));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const unsigned q = __ldg(reinterpret_cast<const unsigned*>(
        static_cast<const int8_t*>(s.z) + idx));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = s.zt == 2 ? static_cast<int>((q >> (8 * i)) & 0xffu) : static_cast<int8_t>(q >> (8 * i));
  }
}

template <int V>
__device__ __forceinline__ void store_vals(void* out, uint8_t* out_s, int out32, size_t idx,
                                           const int (&s)[V]) {
  if constexpr (V == 1) {
    if (out32)
      static_cast<int32_t*>(out)[idx] = s[0];
    else
      static_cast<int8_t*>(out)[idx] = static_cast<int8_t>(s[0]);
    if (out_s) out_s[idx] = s[0] < 0 ? 1 : 0;
  } else if (out32) {
    *reinterpret_cast<int4*>(static_cast<int32_t*>(out) + idx) = make_int4(s[0], s[1], s[2], s[3]);
  } else {
    unsigned w = 0, ws = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w |= static_cast<unsigned>(s[i] & 0xff) << (8 * i);
      ws |= (s[i] < 0 ? 1u : 0u) << (8 * i);
    }
    *reinterpret_cast<unsigned*>(static_cast<int8_t*>(out) + idx) = w;
    if (out_s) *reinterpret_cast<unsigned*>(out_s + idx) = ws;
  }
}

constexpr int kRows = 4;   // rows a thread walks, their loads issued together

// kCap: hardtanh's ceiling after the ReLU
template <int V, bool R, bool kCap>
__global__ void requant_kernel(Side a, Side r, const int32_t* __restrict__ lens,
                               void* __restrict__ out, uint8_t* __restrict__ out_s, int out32,
                               int T, int C, int relu,
                               const int32_t* __restrict__ hcap, int hs, int lo, int hi) {
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c0 >= C) return;
  const int b = blockIdx.z;
  const int len = lens ? __ldg(lens + b) : INT_MAX;
  QasrRq ra[V], rr[V];
  int cap[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    cap[i] = kCap && hcap ? __ldg(hcap + c0 + i) : hs;
    ra[i] = qasr_rq_make(a.m ? __ldg(a.m + c0 + i) : a.ms, qasr_exponent(a.e, a.es, c0 + i));
    if constexpr (R) rr[i] = qasr_rq_make(r.m ? __ldg(r.m + c0 + i) : r.ms, qasr_exponent(r.e, r.es, c0 + i));
  }
  const int t0 = blockIdx.x * kRows * blockDim.y + threadIdx.y;
  const size_t row0 = (static_cast<size_t>(b) * T + t0) * C + c0;
  const size_t step = static_cast<size_t>(blockDim.y) * C;
  int va[kRows][V], vr[kRows][V];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int t = t0 + k * static_cast<int>(blockDim.y);
    if (t < T && t < len) {   // a masked row is not read
      load_vals<V>(a, row0 + k * step, va[k]);
      if constexpr (R) load_vals<V>(r, row0 + k * step, vr[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int t = t0 + k * static_cast<int>(blockDim.y);
    if (t >= T) break;
    int s[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = 0;   // masked: requant(0) = 0, inside the clamp
    if (t < len) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int v = relu && va[k][i] < 0 ? 0 : va[k][i];
        s[i] = qasr_rq(kCap ? min(v, cap[i]) : v, ra[i]);
        if constexpr (R) s[i] += qasr_rq(vr[k][i], rr[i]);
        s[i] = qasr_clamp(s[i], lo, hi);
      }
    }
    store_vals<V>(out, out_s, out32, row0 + k * step, s);
  }
}

template <int V>
int launch(const Side& a, const Side& r, int has_r, const int32_t* lens, void* out,
           uint8_t* out_s, int out32,
           int batch, int T, int C, int relu, const int32_t* hcap, int hs, int lo, int hi,
           cudaStream_t stream) {
  const int vecs = (C + V - 1) / V;
  const int tx = vecs < 32 ? vecs : 32;
  const int ty = 256 / tx;
  const int rows = kRows * ty;
  const dim3 grid((T + rows - 1) / rows, (vecs + tx - 1) / tx, batch);
  const bool cap = hcap || hs != INT_MAX;
  const auto kernel = has_r ? (cap ? requant_kernel<V, true, true> : requant_kernel<V, true, false>)
                            : (cap ? requant_kernel<V, false, true> : requant_kernel<V, false, false>);
  kernel<<<grid, dim3(tx, ty), 0, stream>>>(a, r, lens, out, out_s, out32, T, C, relu, hcap, hs,
                                            lo, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qasr_requant_rows(const void* z, int zt, const int32_t* m, const int32_t* e,
                                 int ms, int es, const void* id, int id32,
                                 const int32_t* m_r, const int32_t* e_r, int ms_r, int es_r,
                                 const int32_t* lens, void* out, uint8_t* out_s, int out32,
                                 int n_rows, int C,
                                 int rows_per_batch, int relu, const int32_t* hcap, int hs,
                                 int lo, int hi, void* stream) {
  const Side a{z, zt, m, e, ms, es};
  const Side r{id, id32, m_r, e_r, ms_r, es_r};
  if (n_rows == 0 || C == 0) return 0;
  const int batch = n_rows / rows_per_batch;
  const int has_r = id != nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the wrapper's plan: 4 channels a thread, else the element path (C not
  // a multiple of 4, or a tensor that starts off a 16-byte boundary, such as
  // a view)
  const uintptr_t align = reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(id)
                          | reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(out_s);
  if (C % 4 != 0 || align % 16 != 0)
    return launch<1>(a, r, has_r, lens, out, out_s, out32, batch, rows_per_batch, C, relu, hcap,
                     hs, lo, hi, s);
  return launch<4>(a, r, has_r, lens, out, out_s, out32, batch, rows_per_batch, C, relu, hcap, hs,
                   lo, hi, s);
}
