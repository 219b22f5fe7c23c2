// Integer glue of the frozen Conformer as device functions, shared by
// int_attention.cu and conv_block.cu.
//
// The canonical integer forms of qasr_tpu/ops/integer_softmax.py (i_exp,
// the i-softmax constants), ops/integer_sigmoid.py (i_sigmoid_grid) and
// ops/integer_layernorm.py (i_layernorm_core), with the floor semantics of
// jnp.floor_divide: C's '/' truncates toward zero, so every division whose
// numerator can be negative goes through qasr_floor_div.  The square root
// is computed digit by digit in integers (exact floor(sqrt(n))).
#pragma once

#include <cstdint>

constexpr int kNIn = 16383;              // score grid: S_IN = 20 / 16383
constexpr int kQLn2 = -568;              // floor(-ln2 / S_IN)
constexpr int kQB = 1108;                // floor(1.353 / S_IN)
constexpr int kQC = 643866;              // floor(0.344 / (0.3585 S_IN^2))
constexpr int kPreshift = 4;             // i-softmax sum headroom
constexpr int kKSig = 7;                 // sigmoid fraction bits
constexpr int kE0 = kQB * kQB + kQC;     // i_exp(0)
constexpr int kMasked = -(1 << 30);      // masked score before the row max
constexpr int kLnK = 10;                 // i-LN output fraction bits
constexpr int kLnSB = 6;                 // i-LN sigma fraction bits

// floor(n / d) for d != 0 (a negative d flips both signs)
__device__ __forceinline__ int qasr_floor_div(int n, int d) {
  if (d < 0) {
    n = -n;
    d = -d;
  }
  const int q = n / d;
  return (q * d != n && n < 0) ? q - 1 : q;
}

// exp(q * S_IN) up to a common scale, q in [-kNIn, 0]
__device__ __forceinline__ int qasr_i_exp(int q) {
  const int z = qasr_floor_div(q, kQLn2);   // in [0, 28]
  const int p = q - z * kQLn2;              // in (kQLn2, 0]
  const int ql = (p + kQB) * (p + kQB) + kQC;
  return ql >> (z < 30 ? z : 30);
}

// sigmoid fraction in [0, 2^kKSig] of a value on the S_IN grid
__device__ __forceinline__ int qasr_i_sigmoid_grid(int q) {
  q = q < -kNIn ? -kNIn : (q > kNIn ? kNIn : q);
  const int e = qasr_i_exp(q < 0 ? q : -q);
  const int den = e + kE0;
  const int s_neg = qasr_floor_div((e << kKSig) + (den >> 1), den);
  return q >= 0 ? (1 << kKSig) - s_neg : s_neg;
}

// i_sigmoid_grid from a table of its values at q in [0, kSigTab): it is odd
// about 64 (f(q) + f(-q) = 2^kKSig on its whole domain) and equals 2^kKSig
// from q = 4541 on, so |q| clamped below kSigTab indexes the table
// (kernels/conv_block.py::sigmoid_table builds it from the plain function;
// the CPU tests hold it to the JAX package over the whole domain).
constexpr int kSigTab = 4544;

__device__ __forceinline__ int qasr_i_sigmoid_tab(const uint8_t* tab, int q) {
  const int a = q < 0 ? -q : q;
  const int s = tab[a < kSigTab ? a : kSigTab - 1];
  return q >= 0 ? s : (1 << kKSig) - s;
}

// floor(n / d) for 0 <= n < 2^32 and 1 <= d < 2^31 by an invariant divisor
// (Granlund and Montgomery 1994, fig. 4.1, N = 32): with l = ceil(log2 d),
// m = floor(2^32 (2^l - d) / d) + 1 and t = mulhi(m, n), the quotient is
// (t + ((n - t) >> min(l, 1))) >> max(l - 1, 0), exact on that whole range.
// qasr_div_make is one 64-bit division, made once per divisor.
struct QasrDiv {
  unsigned m;
  int s1, s2;
};

__device__ __forceinline__ QasrDiv qasr_div_make(unsigned d) {
  const int l = d > 1u ? 32 - __clz(d - 1u) : 0;
  QasrDiv r;
  r.m = static_cast<unsigned>((((1ull << l) - d) << 32) / d + 1ull);
  r.s1 = l < 1 ? l : 1;
  r.s2 = l > 1 ? l - 1 : 0;
  return r;
}

__device__ __forceinline__ unsigned qasr_div(unsigned n, const QasrDiv& r) {
  const unsigned t = __umulhi(r.m, n);
  return (t + ((n - t) >> r.s1)) >> r.s2;
}

// i_exp(-a) >> kPreshift for a in [0, kNIn] from a table of the quadratic
// at r = a mod 568: i_exp(q) = ((r' + Q_B)^2 + Q_C) >> z with z = a / 568
// and r' = -r, so the table holds qasr_exp_quad(r) for r in [0, kExpTab)
// (the table is below 2^21, so a shift past 20 gives 0 as the reference)
constexpr int kExpTab = -kQLn2;

__device__ __forceinline__ int qasr_exp_quad(int r) { return (kQB - r) * (kQB - r) + kQC; }

__device__ __forceinline__ int qasr_i_exp_pre(int a, const int* tab) {
  const int z = static_cast<int>(static_cast<unsigned>(a) / static_cast<unsigned>(kExpTab));
  const int s = z + kPreshift;
  return tab[a - kExpTab * z] >> (s < 31 ? s : 31);
}

// floor(sqrt(n)) for 0 <= n < 2^30 from the float square root, which is
// within 0.005 of sqrt(n) there, and one correction step each way
__device__ __forceinline__ int qasr_isqrt_f(int n) {
  if (n <= 0) return 0;
  int r = static_cast<int>(sqrtf(static_cast<float>(n)));
  r -= r * r > n ? 1 : 0;
  r += (r + 1) * (r + 1) <= n ? 1 : 0;
  return r;
}

// floor(sqrt(n)) for n >= 0 (0 for n <= 0), binary digit by digit
__device__ __forceinline__ int qasr_isqrt(int n) {
  if (n <= 0) return 0;
  unsigned rem = static_cast<unsigned>(n), res = 0u, bit = 1u << 30;
  while (bit > rem) bit >>= 2;
  while (bit != 0u) {
    if (rem >= res + bit) {
      rem -= res + bit;
      res = (res >> 1) + bit;
    } else {
      res >>= 1;
    }
    bit >>= 2;
  }
  return static_cast<int>(res);
}

__device__ __forceinline__ int qasr_warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// i_layernorm_core of one row of d int8 values, by one warp: lane l holds
// columns l, l + 32, ... (kPer = d / 32 of them, d <= 32 * kMaxPer) in x
// and receives (x - mu) / sigma at 2^-kLnK in y.
// qasr_ln_row with its divisions by d as invariant-divisor divisions (dd =
// qasr_div_make(d), made by the caller), the square root as qasr_isqrt_f,
// and the division by sigma as a float estimate corrected once each way:
// for an int8 row (d <= 512) the quotient |(x - mu) 2^16 / sigma| is below
// 2^21 (sigma >= 64 unless var = 0, and then |x - mu| <= 22), so the
// rounded-down float product is within 1 of the floor
template <int kMaxPer>
__device__ __forceinline__ void qasr_ln_row_div(const int (&x)[kMaxPer], int (&y)[kMaxPer],
                                                int per, int d, const QasrDiv& dd) {
  int s = 0;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k)
    if (k < per) s += x[k];
  s = qasr_warp_sum(s);
  const int mu = s >= 0 ? static_cast<int>(qasr_div(static_cast<unsigned>(s + d / 2), dd))
                        : -static_cast<int>(qasr_div(static_cast<unsigned>(-s + d / 2), dd));
  int s2 = 0;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k)
    if (k < per) s2 += (x[k] - mu) * (x[k] - mu);
  s2 = qasr_warp_sum(s2);
  const int var = static_cast<int>(qasr_div(static_cast<unsigned>(s2), dd));
  int sigma = qasr_isqrt_f(var << (2 * kLnSB));
  sigma = sigma > 1 ? sigma : 1;
  const float rcp = __frcp_rn(static_cast<float>(sigma));
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    if (k < per) {
      const int v = (x[k] - mu) * (1 << (kLnK + kLnSB));
      int q = __float2int_rd(static_cast<float>(v) * rcp);
      const int r = v - q * sigma;
      q += (r >= sigma ? 1 : 0) - (r < 0 ? 1 : 0);
      y[k] = q;
    }
  }
}

template <int kMaxPer>
__device__ __forceinline__ void qasr_ln_row(const int (&x)[kMaxPer], int (&y)[kMaxPer],
                                            int per, int d) {
  int s = 0;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k)
    if (k < per) s += x[k];
  s = qasr_warp_sum(s);
  // rounded mean, half away from zero on the magnitude
  const int mu = s >= 0 ? (s + d / 2) / d : -((-s + d / 2) / d);
  int s2 = 0;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k)
    if (k < per) s2 += (x[k] - mu) * (x[k] - mu);
  s2 = qasr_warp_sum(s2);
  const int var = s2 / d;                      // s2 >= 0
  int sigma = qasr_isqrt(var << (2 * kLnSB));
  sigma = sigma > 1 ? sigma : 1;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k)
    if (k < per) y[k] = qasr_floor_div((x[k] - mu) * (1 << (kLnK + kLnSB)), sigma);
}
