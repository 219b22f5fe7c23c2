// requant: elementwise dyadic requantization of a (B, T, C) activation,
// with per-channel (vector) or scalar mantissas and exponents, an optional
// ReLU and length mask on the input, and an optional residual join.
//
// Replaces qasr_tpu/kernels/requant.py::requant_pallas (pl.pallas_call at
// requant.py:65 and :74).  For row n = b * T + t and channel c:
//
//   v   = mask_{t < lens[b]}(relu?(z[n, c]))
//   s   = requant(v, m[c], e[c]) [+ requant(mask(id[n, c]), m_r[c], e_r[c])]
//   out = clamp(s, -2^(bits-1), 2^(bits-1) - 1)      int8 when bits <= 8
//
// with requant the shared device function of requant.cuh (exponents below
// 1 count as 1, above 62 give 0, as the plain torch version and the JAX
// dyadic_requant clamp them).  Each of m, e, m_r, e_r is a (C,) device
// vector or, when its pointer is NULL, the scalar passed by value.
//
// What bounds it on an H100: the bytes.  At a per_channel QuartzNet site
// (B=64, T=768, C=512) it reads 100 MB of int32 and writes 25 MB of int8,
// about 37 us of HBM time at 3.35 TB/s; the requant is some 20 integer
// operations per element (one 64-bit product), far below the card's
// integer rate at that byte count.
//
// Design (simple first): one thread per element in a grid-stride loop
// (neighbouring threads on neighbouring channels, so every access is
// coalesced), 32-bit indices (the wrapper keeps B * T * C below 2^31), the
// per-channel vectors read through the read-only cache.
#include <cstdint>

#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

struct Side {
  const void* z;      // int8 or int32 (B*T, C)
  int z32;            // 1: z is int32
  const int32_t* m;   // (C,) or NULL -> ms
  const int32_t* e;   // (C,) or NULL -> es
  int ms, es;
};

__device__ __forceinline__ int load_val(const Side& s, int idx) {
  return s.z32 ? __ldg(static_cast<const int32_t*>(s.z) + idx)
               : static_cast<int>(__ldg(static_cast<const int8_t*>(s.z) + idx));
}

__device__ __forceinline__ int side_requant(const Side& s, int v, int c) {
  const int m = s.m ? __ldg(s.m + c) : s.ms;
  int e = s.e ? __ldg(s.e + c) : s.es;
  e = e < 1 ? 1 : e;
  return qasr_requant(v, m, e);
}

__global__ void requant_kernel(Side a, Side r, int has_r, const int32_t* __restrict__ lens,
                               void* __restrict__ out, int out32, int total, int C,
                               int rows_per_batch, int relu, int lo, int hi) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int n = i / C;
    const int c = i - n * C;
    const bool keep = lens == nullptr ||
                      (n % rows_per_batch) < __ldg(lens + n / rows_per_batch);
    int s = 0;
    if (keep) {
      int v = load_val(a, i);
      if (relu) v = v > 0 ? v : 0;
      s = side_requant(a, v, c);
      if (has_r) s += side_requant(r, load_val(r, i), c);
    }
    s = qasr_clamp(s, lo, hi);
    if (out32)
      static_cast<int32_t*>(out)[i] = s;
    else
      static_cast<int8_t*>(out)[i] = static_cast<int8_t>(s);
  }
}

}  // namespace

extern "C" int qasr_requant_rows(const void* z, int z32, const int32_t* m, const int32_t* e,
                                 int ms, int es, const void* id, int id32,
                                 const int32_t* m_r, const int32_t* e_r, int ms_r, int es_r,
                                 const int32_t* lens, void* out, int out32, int n_rows, int C,
                                 int rows_per_batch, int relu, int lo, int hi, void* stream) {
  const Side a{z, z32, m, e, ms, es};
  const Side r{id, id32, m_r, e_r, ms_r, es_r};
  const int total = n_rows * C;   // the wrapper keeps it below 2^31
  if (total == 0) return 0;
  const int threads = 256;
  const int want = (total + threads - 1) / threads;
  const int blocks = want < 132 * 32 ? want : 132 * 32;
  requant_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, r, id != nullptr, lens, out, out32, total, C, rows_per_batch, relu, lo, hi);
  return static_cast<int>(cudaGetLastError());
}
