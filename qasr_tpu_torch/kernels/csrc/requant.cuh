// Exact dyadic requantization, shared by every kernel of the port.
//
// Computes what qasr_tpu/ops/quant_prims.py::dyadic_requant{,_static,
// _static16} compute on their contract domain (|z| < 2^29, m < 2^31,
// e >= 1):
//
//     sign(z) * min(round_half_even(|z| * m / 2^e), 2^26),   0 when e > 62
//
// The TPU evaluates the 61-bit product with two 32-bit limbs; Hopper has
// 64-bit integer multiplies, so it is one product and one shift here.  The
// 2^26 saturation keeps the sum of two results (a residual join) in int32.
#pragma once

#include <cstdint>

__device__ __forceinline__ int qasr_requant(long long z, int m, int e) {
  if (e > 62) return 0;
  const unsigned long long za =
      static_cast<unsigned long long>(z < 0 ? -z : z);
  const unsigned long long p = za * static_cast<unsigned long long>(
                                        static_cast<unsigned int>(m));
  unsigned long long fl = p >> e;
  const unsigned long long rem = p & ((1ull << e) - 1ull);
  const unsigned long long half = 1ull << (e - 1);
  fl += (rem > half || (rem == half && (fl & 1ull))) ? 1ull : 0ull;
  const int r = fl < (1ull << 26) ? static_cast<int>(fl) : (1 << 26);
  return z < 0 ? -r : r;
}

// qasr_requant for a channel whose (m, e) a thread applies many times (the
// per-channel requants of Kernels 1 and 7): qasr_rq_make folds m and e
// into constants once, and qasr_rq is then a 32 x 32 -> 64-bit product, a
// 64-bit add, two 64-bit shifts and a compare, with no rounding compare
// chain.  For e in [1, 62], |z| <= 2^31 and m < 2^31, round_half_even(p /
// 2^e) = (p + 2^(e-1) - 1 + bit_e(p)) >> e with p = |z| * m < 2^62 (the
// sum stays below 2^63), and the result saturates at 2^26 exactly when the
// sum is at least 2^(e+26).  e > 62 becomes m = 0 (every result 0), e < 1
// counts as 1.  Equal to qasr_requant(z, m, max(e, 1)) on every such input;
// the card check (kernels/requant.py::requant_device(fast=True)) holds both
// to the plain requant over a boundary grid and 2 x 2^20 random triples.
struct QasrRq {
  unsigned m;
  unsigned e;
  unsigned long long hm1;    // 2^(e-1) - 1
  unsigned long long sat;    // 2^(e+26): at or above it the result saturates
};

__device__ __forceinline__ QasrRq qasr_rq_make(int m, int e) {
  e = e < 1 ? 1 : e;
  QasrRq r;
  r.m = e > 62 ? 0u : static_cast<unsigned>(m);
  e = e > 62 ? 62 : e;
  r.e = static_cast<unsigned>(e);
  r.hm1 = (1ull << (e - 1)) - 1ull;
  r.sat = e + 26 < 64 ? (1ull << (e + 26)) : ~0ull;
  return r;
}

__device__ __forceinline__ int qasr_rq(int z, const QasrRq& r) {
  const unsigned za = z < 0 ? 0u - static_cast<unsigned>(z) : static_cast<unsigned>(z);
  const unsigned long long p = static_cast<unsigned long long>(za) * r.m;
  const unsigned long long sum = p + r.hm1 + (static_cast<unsigned>(p >> r.e) & 1u);
  const int q = sum >= r.sat ? (1 << 26) : static_cast<int>(sum >> r.e);
  return z < 0 ? -q : q;
}

// qasr_requant(z, m, e) on the FP64 pipe, for a site whose |z| * m stays
// below 2^(e + 26) (no saturation), e <= 62: M = m 2^-e is exact as a
// double, and the fma adds 1.5 * 2^52 to the exact product z * M with one
// rounding, to the nearest integer, ties to even (the sum lies in [2^52,
// 2^53), where the unit is 1, and 1.5 * 2^52 is even); the low word of the
// sum is that integer's two's complement.  z becomes a double by the
// same trick (2^52 + 2^31 + z, built from its bits).  One integer and two
// FP64 instructions in place of qasr_rq's ~14 integer ones.
__device__ __forceinline__ double qasr_rq_f64_scale(int m, int e) {
  return scalbn(static_cast<double>(m), -e);
}

__device__ __forceinline__ int qasr_rq_f64(int z, double M) {
  const double zd = __hiloint2double(0x43300000, z ^ static_cast<int>(0x80000000u)) -
                    4503601774854144.0;   // 2^52 + 2^31
  return __double2loint(fma(zd, M, 6755399441055744.0));   // 1.5 * 2^52
}

// qasr_rq_make(m, e) for a site whose exponent e is shared by every column:
// `site` = qasr_rq_make(1, e) folds e once; m < 2^31
__device__ __forceinline__ QasrRq qasr_rq_col(const QasrRq& site, int m) {
  QasrRq r = site;
  r.m = site.m ? static_cast<unsigned>(m) : 0u;
  return r;
}

// The requant of one column o of a per-column site (Kernels 4 and 6):
// qasr_rq with the column's mantissa m[o] folded into the site's constants,
// or (kF64, where the host has proven the site's domain) qasr_rq_f64 with
// the column's m 2^-e from mf[o]
template <bool kF64>
struct QasrColRq {
  QasrRq q;
  double f;
  __device__ __forceinline__ QasrColRq(const QasrRq& site, const int32_t* m, const double* mf,
                                       int o) {
    if (kF64)
      f = __ldg(mf + o);
    else
      q = qasr_rq_col(site, __ldg(m + o));
  }
  __device__ __forceinline__ int operator()(int z) const {
    return kF64 ? qasr_rq_f64(z, f) : qasr_rq(z, q);
  }
};

// The exponent of channel c: read from the (C,) vector ev or, when ev is
// NULL, the scalar es.  One below 1 counts as 1, as dyadic_requant clamps
// it (above 62 qasr_requant gives 0).
__device__ __forceinline__ int qasr_exponent(const int32_t* __restrict__ ev, int es, int c) {
  const int e = ev ? __ldg(ev + c) : es;
  return e < 1 ? 1 : e;
}

__device__ __forceinline__ int qasr_clamp(int q, int lo, int hi) {
  return q < lo ? lo : (q > hi ? hi : q);
}
