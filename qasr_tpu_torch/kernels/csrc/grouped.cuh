// grouped.cuh: what the grouped forms of Kernel 2 (pw_gemm_grouped.cu) and
// Kernel 8 (dense_conv_grouped.cu) share: the column tile in GroupShuffle's
// order, the input-requant prologue on 16 channels, and the wgmma shapes
// they issue.
//
// The tile.  A grouped conv's group g (of G) multiplies its own Cin/G input
// channels by its own Cout/G x Cin/G weights.  GroupShuffle stores its
// output channel j of group g at position j * G + g.  A column tile covers
// kGc groups (G itself for G = 2, 4 or 8; the largest of 8, 4, 2 and 1 that
// divides G otherwise) times kBN / kGc columns j of each, as a wgmma of
// width kBN / kGc a group (or half of one), each with its group's A and B.
// With shuffle and kGc = G each column's G groups lie side by side: a run
// of consecutive output positions, which the epilogues store at once.
// Bias and the ceiling are in the conv's channel order, m, m_r and res in
// the stored order.
//
// Requants.  Every requant runs as qasr_rq with the site's exponent folded
// once and the column's m folded per column, or, where the host proved the
// site's domain (kernels/checks.py::f64_site: |z| m < 2^(e + 26) for every
// int32 z and m < 2^31 at e >= 36, or for the z the shapes allow), as
// qasr_rq_f64 on the FP64 pipe with the column's m 2^-e.
#pragma once

#include <climits>
#include <cstdint>

#include "gemm_s8.cuh"
#include "requant.cuh"

namespace grouped {

constexpr int kBN = 128;   // positions a column tile covers (kGc groups x kBN / kGc columns)

// The epilogue's operands (both kernels).  bias and hcap are in the conv's
// channel order; m, m_r, res and the output in the stored order (shuffled
// or not).  f64 / f64_r: the requant / the residual's requant proven for
// the FP64 pipe.
struct Epi {
  const int32_t* bias;
  const int32_t* m;
  const int32_t* res;
  const int32_t* m_r;
  void* out;
  const int32_t* hcap;   // (Cout,) ceiling, or NULL -> hs (INT_MAX: none)
  int hs;
  int cout, cog, groups, shuffle, mode, relu, e, e_r, lo, hi, f64;
};

// The prologue's operands (both kernels): a[i] = clamp(requant(min(relu?(x[i]
// + in_bias[i]), in_cap[i]), m1[i], e1), lo1, hi1), rows past in_len zero.
struct Pro {
  const int32_t* in_bias;
  int in_relu;
  const int32_t* in_len;
  const int32_t* m1;     // (Cin,) or NULL -> m1s
  int m1s, e1, lo1, hi1;
  const int32_t* in_hcap;
  int in_hs;
  int x32, f64;
};

// ---------------------------------------------------------------------------
// requants
// ---------------------------------------------------------------------------

// A column's requant constant: m 2^-e (kF64) or m itself (qasr_rq with the
// site's folded exponent; e > 62 folds to m = 0, every result 0).
template <bool kF64>
struct ColM;

template <>
struct ColM<false> {
  unsigned m;
  __device__ __forceinline__ void set(const QasrRq& site, double, int mm) {
    m = site.m ? static_cast<unsigned>(mm) : 0u;
  }
  __device__ __forceinline__ int operator()(const QasrRq& site, int z) const {
    QasrRq r = site;
    r.m = m;
    return qasr_rq(z, r);
  }
};

template <>
struct ColM<true> {
  double f;
  __device__ __forceinline__ void set(const QasrRq&, double sc, int mm) {
    f = static_cast<double>(mm) * sc;
  }
  __device__ __forceinline__ int operator()(const QasrRq&, int z) const {
    return qasr_rq_f64(z, f);
  }
};

// ---------------------------------------------------------------------------
// runs of consecutive values: vector accesses where aligned
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void load_run(const int32_t* p, int (&v)[N]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (N % 4 == 0 && (a & 15) == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const int4 u = __ldg(reinterpret_cast<const int4*>(p) + i);
      v[4 * i] = u.x, v[4 * i + 1] = u.y, v[4 * i + 2] = u.z, v[4 * i + 3] = u.w;
    }
  } else if (N % 2 == 0 && (a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int2 u = __ldg(reinterpret_cast<const int2*>(p) + i);
      v[2 * i] = u.x, v[2 * i + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __ldg(p + i);
  }
}

template <int N>
__device__ __forceinline__ void store_run(int32_t* p, const int (&y)[N]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (N % 4 == 0 && (a & 15) == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<int4*>(p)[i] =
          make_int4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
  } else if (N % 2 == 0 && (a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      reinterpret_cast<int2*>(p)[i] = make_int2(y[2 * i], y[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = y[i];
  }
}

// the low bytes of y, packed, at p (N of 2, 4, 8, 16 in one store where aligned)
template <int N>
__device__ __forceinline__ void store_run(int8_t* p, const int (&y)[N]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if constexpr (N % 4 == 0) {
    if ((a & (N - 1)) == 0) {
      unsigned w[N / 4];
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
        w[i] = __byte_perm(__byte_perm(y[4 * i], y[4 * i + 1], 0x0040),
                           __byte_perm(y[4 * i + 2], y[4 * i + 3], 0x0040), 0x5410);
      if constexpr (N == 16) {
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
      } else if constexpr (N == 8) {
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
      } else {
        *reinterpret_cast<unsigned*>(p) = w[0];
      }
      return;
    }
  } else if constexpr (N == 2) {
    if ((a & 1) == 0) {
      *reinterpret_cast<unsigned short*>(p) =
          static_cast<unsigned short>((y[0] & 0xff) | ((y[1] & 0xff) << 8));
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = static_cast<int8_t>(y[i]);
}

// ---------------------------------------------------------------------------
// the prologue
// ---------------------------------------------------------------------------

// The 16 raw inputs of one granule (int8, or int32 with x32) at x + off
__device__ __forceinline__ void load_raw16(const void* x, size_t off, int x32, int (&v)[16]) {
  if (x32) {
    const int4* s = reinterpret_cast<const int4*>(static_cast<const int32_t*>(x) + off);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int4 q = s[k];
      v[4 * k] = q.x, v[4 * k + 1] = q.y, v[4 * k + 2] = q.z, v[4 * k + 3] = q.w;
    }
  } else {
    const int4 q = *reinterpret_cast<const int4*>(static_cast<const int8_t*>(x) + off);
    const int w4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = static_cast<int8_t>(w4[k / 4] >> (8 * (k % 4)));
  }
}

// Channels c0..c0+15 of one row (v) through the prologue: 16 codes packed.
// site1 = qasr_rq_make(1, e1), sc1 = 2^-e1.
template <bool kF64>
__device__ __forceinline__ int4 prologue16(const Pro& p, const int (&v)[16], int c0,
                                           const QasrRq& site1, double sc1) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int c = c0 + k;
    int z = v[k] + (p.in_bias ? __ldg(p.in_bias + c) : 0);
    if (p.in_relu) z = z > 0 ? z : 0;
    z = min(z, p.in_hcap ? __ldg(p.in_hcap + c) : p.in_hs);
    ColM<kF64> cm;
    cm.set(site1, sc1, p.m1 ? __ldg(p.m1 + c) : p.m1s);
    const int r = qasr_clamp(cm(site1, z), p.lo1, p.hi1);
    w[k / 4] |= (static_cast<unsigned>(r) & 0xffu) << (8 * (k % 4));
  }
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]), static_cast<int>(w[2]),
                   static_cast<int>(w[3]));
}

// One granule of raw input (16 channels from c0 of the row at x + row_off)
// as the codes the GEMM reads: through the prologue (pro), else as it is.
__device__ __forceinline__ int4 granule(const Pro& p, bool pro, const void* x, size_t off, int c0,
                                        const QasrRq& site1, double sc1) {
  if (!pro) return *reinterpret_cast<const int4*>(static_cast<const int8_t*>(x) + off);
  int v[16];
  load_raw16(x, off, p.x32, v);
  return p.f64 ? prologue16<true>(p, v, c0, site1, sc1) : prologue16<false>(p, v, c0, site1, sc1);
}

// ---------------------------------------------------------------------------
// wgmma: m64nNk32, int32 += (s8 or u8) x s8, both operands from shared
// memory through descriptors; scale 0 overwrites d.  N = 16 / 32 / 64
// (Kernel 2 grouped: a warpgroup's half of a 128-position tile), 24 / 48 /
// 96 / 192 (Kernel 8 grouped: a group's columns of a 192-position tile).
// ---------------------------------------------------------------------------

template <int N, bool kU8>
struct Mma;

#define QASR_G_SS(N, ATYPE, REGS, DOPS, IA, IB, IP)                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n" N "k32.s32." ATYPE ".s8 {" REGS         \
               "}, %" IA ", %" IB ", p;\n}\n"                                             \
               : DOPS                                                                      \
               : "l"(da), "l"(db), "r"(scale))

#define QASR_G_REGS8 \
    "%0, %1, %2, %3, %4, %5, %6, %7"
#define QASR_G_DOPS8 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
template <bool kU8>
struct Mma<16, kU8> {
  __device__ __forceinline__ static void ss(int (&d)[8], uint64_t da, uint64_t db, int scale) {
    if constexpr (kU8)
      QASR_G_SS("16", "u8", QASR_G_REGS8, QASR_G_DOPS8, "8", "9", "10");
    else
      QASR_G_SS("16", "s8", QASR_G_REGS8, QASR_G_DOPS8, "8", "9", "10");
  }
};
#undef QASR_G_REGS8
#undef QASR_G_DOPS8

#define QASR_G_REGS12 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
#define QASR_G_DOPS12 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
template <bool kU8>
struct Mma<24, kU8> {
  __device__ __forceinline__ static void ss(int (&d)[12], uint64_t da, uint64_t db, int scale) {
    if constexpr (kU8)
      QASR_G_SS("24", "u8", QASR_G_REGS12, QASR_G_DOPS12, "12", "13", "14");
    else
      QASR_G_SS("24", "s8", QASR_G_REGS12, QASR_G_DOPS12, "12", "13", "14");
  }
};
#undef QASR_G_REGS12
#undef QASR_G_DOPS12

#define QASR_G_REGS16 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define QASR_G_DOPS16 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
template <bool kU8>
struct Mma<32, kU8> {
  __device__ __forceinline__ static void ss(int (&d)[16], uint64_t da, uint64_t db, int scale) {
    if constexpr (kU8)
      QASR_G_SS("32", "u8", QASR_G_REGS16, QASR_G_DOPS16, "16", "17", "18");
    else
      QASR_G_SS("32", "s8", QASR_G_REGS16, QASR_G_DOPS16, "16", "17", "18");
  }
};
#undef QASR_G_REGS16
#undef QASR_G_DOPS16

#define QASR_G_REGS24 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23"
#define QASR_G_DOPS24 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
    "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
template <bool kU8>
struct Mma<48, kU8> {
  __device__ __forceinline__ static void ss(int (&d)[24], uint64_t da, uint64_t db, int scale) {
    if constexpr (kU8)
      QASR_G_SS("48", "u8", QASR_G_REGS24, QASR_G_DOPS24, "24", "25", "26");
    else
      QASR_G_SS("48", "s8", QASR_G_REGS24, QASR_G_DOPS24, "24", "25", "26");
  }
};
#undef QASR_G_REGS24
#undef QASR_G_DOPS24

#define QASR_G_REGS32 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define QASR_G_DOPS32 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
    "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
    "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
template <bool kU8>
struct Mma<64, kU8> {
  __device__ __forceinline__ static void ss(int (&d)[32], uint64_t da, uint64_t db, int scale) {
    if constexpr (kU8)
      QASR_G_SS("64", "u8", QASR_G_REGS32, QASR_G_DOPS32, "32", "33", "34");
    else
      QASR_G_SS("64", "s8", QASR_G_REGS32, QASR_G_DOPS32, "32", "33", "34");
  }
};
#undef QASR_G_REGS32
#undef QASR_G_DOPS32

#define QASR_G_REGS48 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define QASR_G_DOPS48 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
    "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
    "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
    "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
    "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
template <bool kU8>
struct Mma<96, kU8> {
  __device__ __forceinline__ static void ss(int (&d)[48], uint64_t da, uint64_t db, int scale) {
    if constexpr (kU8)
      QASR_G_SS("96", "u8", QASR_G_REGS48, QASR_G_DOPS48, "48", "49", "50");
    else
      QASR_G_SS("96", "s8", QASR_G_REGS48, QASR_G_DOPS48, "48", "49", "50");
  }
};
#undef QASR_G_REGS48
#undef QASR_G_DOPS48

#define QASR_G_REGS96 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
    "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
    "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define QASR_G_DOPS96 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
    "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
    "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
    "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
    "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
    "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
    "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), \
    "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), \
    "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), \
    "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), \
    "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
template <bool kU8>
struct Mma<192, kU8> {
  __device__ __forceinline__ static void ss(int (&d)[96], uint64_t da, uint64_t db, int scale) {
    if constexpr (kU8)
      QASR_G_SS("192", "u8", QASR_G_REGS96, QASR_G_DOPS96, "96", "97", "98");
    else
      QASR_G_SS("192", "s8", QASR_G_REGS96, QASR_G_DOPS96, "96", "97", "98");
  }
};
#undef QASR_G_REGS96
#undef QASR_G_DOPS96

#undef QASR_G_SS

// wgmma descriptor of a K-major operand in the 64B-swizzle layout (rows of
// 64 bytes, granule u of row r at u ^ ((r >> 1) % 4)): start address, LBO
// 16 bytes (unused for swizzled K-major), SBO 8 rows = 512 bytes
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
  return static_cast<uint64_t>((gemm_s8::smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

template <int G, int R>
__device__ __forceinline__ void fence_acc(int (&d)[G][R]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[g][i])::"memory");
}

}  // namespace grouped
