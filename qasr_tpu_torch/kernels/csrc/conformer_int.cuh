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

__device__ __forceinline__ int qasr_warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// i_layernorm_core of one row of d int8 values, by one warp: lane l holds
// columns l, l + 32, ... (kPer = d / 32 of them, d <= 32 * kMaxPer) in x
// and receives (x - mu) / sigma at 2^-kLnK in y.
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
