// Kernel 10: the RNN-Transducer loss and its gradient over the (T, U+1)
// lattice, for training (kernels/rnnt_loss.py wraps it in two autograd
// Functions: one from the joint's logits, one from the lattice's
// log-probs).
//
// Replaces no Pallas kernel: the JAX package computes the loss as a
// lax.scan over the lattice's anti-diagonals of the joint's log-softmax
// (qasr_tpu/models/rnnt_model.py:227-228, qasr_tpu/models/rnnt.py:156-216,
// rnnt_loss_wavefront) and its gradient by autodiff.
//
// What bounds it: the dependency chain, one barrier round a diagonal
// (T_b + U_b of them), and around it the bytes of the logits, read once
// and their gradient written once (B T (U+1) (V+1) floats each way).
// Design, the logits' path in three launches:
//  (a) rnnt_lse_kernel, one pass over the lattice's cells (G lanes a cell,
//      a power of two <= 32 from V+1): each in-lattice cell's V+1 logits
//      read once for their log-sum-exp (max, then the sum of expf in
//      double; kept as lse (B, T, U+1) double), the blank's and the next
//      label's log-probs written DIAGONAL-MAJOR as doubles, (B, T+U, U+1)
//      with cell (t, u) at row t + u, column u: a whole anti-diagonal is
//      one contiguous row.  Cells past the lengths are not read.
//  (b) rnnt_lattice_kernel, alpha and beta side by side: block 2b walks
//      utterance b's diagonals forward (alpha), block 2b + 1 backward
//      (beta), so the chain is T_b + U_b rounds, not twice that; beta's
//      blocks run only when a gradient is wanted.  A thread a column u
//      (u, u + blockDim, ... past 1,024); alpha's diagonal d needs the
//      log-probs of row d - 1, beta's those of row d: the next kStages - 1
//      rows come into a shared-memory ring by 8-byte cp.async while the
//      current diagonal is computed, so no round waits on device memory;
//      one __syncthreads a round.  The recursions run in double (the
//      occupancies exp(alpha + lp + beta - ll) are formed from values of
//      magnitude ~|ll|).  Alpha goes out to (B, T, U+1) and beta as the
//      two occupancy exponents' tails hb = blank + beta[t+1, u] and
//      he = emit + beta[t, u+1] (-inf where the move leaves the lattice;
//      hb = blank at the terminal cell (T_b - 1, U_b)), in stores that
//      nothing waits on.
//  (c) rnnt_grad_kernel, one pass over the cells writing the logits'
//      gradient directly (a block a run of cells, its elements streamed
//      contiguously), no log-softmax tensor, gather or scatter:
//        occ_b = exp(alpha + hb - ll), occ_e = exp(alpha + he - ll)
//        d nll / d z_k = g (softmax_k (occ_b + occ_e) - occ_b [k = blank]
//                           - occ_e [k = y_{u+1}])
//      and zeros at every cell with t >= T_b or u > U_b (no zeroing pass).
// The log-probs' path: rnnt_diag_kernel writes the given blank / emit
// log-probs into the diagonal-major rows, the same lattice kernel runs, and
// rnnt_occ_kernel writes -g occ_b and -g occ_e.  rnnt_round_floor_kernel is
// the lattice's latency floor: the same block shape, barrier and double
// log-add-exp on registers, no memory traffic (a measurement launch).
// log-add-exp returns -inf for two -inf operands.  Lengths are clamped to
// T_b in [1, T] and U_b in [0, U], as the plain version does; a label id
// is clamped to [0, V] (memory safety; the plain version's gather raises).
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kStages = 4;          // the lattice kernel's ring of staged rows
constexpr int kMaxThreads = 1024;
constexpr int kCellThreads = 256;   // the cell passes' block
constexpr int kGradCells = 64;      // cells a block of the gradient pass
constexpr int kBatch = 8;           // logits a lane loads at once in the cell pass
constexpr int kStamps = 6;          // clock64 stamps a round (see rnnt_lattice_kernel)

// log(e^a + e^b) = m + log1p(e^-x), m = max(a, b), x = |a - b|, in double
// with no branch and no library call (the lattice's rounds wait on it, and
// lanes whose x fall in different ranges of the library's exp / log1p
// would run each range's path in turn): x clamped to 40 (log1p(e^-40) =
// 4e-18, below half an ulp of any |m| >= 0.04); e^-x = 2^-n e^-q, q = x -
// n ln 2 in [-ln2/2, ln2/2] (Cody-Waite), e^-q by its Taylor polynomial to
// degree 13 (error < 5e-18), 2^-n from the exponent bits; log1p(y) =
// 2 atanh(s), s = y / (2 + y) in (0, 1/3] (an approximate reciprocal and
// two Newton steps), atanh's series to s^33 (error < 2e-18).  Within 4.5e-16
// of log1p(exp(-x)) over [0, 40]; -inf for two -inf operands.
__device__ __forceinline__ double lae(double a, double b) {
  const double m = fmax(a, b);
  const double x = fmin(fabs(a - b), 40.0);   // fmin(NaN, 40) = 40: both -inf
  const double shift = 6755399441055744.0;    // 1.5 * 2^52: rounds to an integer
  const double k = fma(x, 1.4426950408889634, shift);
  const int n = __double2loint(k);
  const double nd = k - shift;
  double q = fma(nd, -6.93147180369123816490e-01, x);
  q = fma(nd, -1.90821492927058770002e-10, q);
  const double t = -q, t2 = t * t, t4 = t2 * t2, t8 = t4 * t4;
  const double p01 = fma(t, 1.0, 1.0), p23 = fma(t, 1.0 / 6, 0.5);
  const double p45 = fma(t, 1.0 / 120, 1.0 / 24), p67 = fma(t, 1.0 / 5040, 1.0 / 720);
  const double p89 = fma(t, 1.0 / 362880, 1.0 / 40320);
  const double pab = fma(t, 1.0 / 39916800, 1.0 / 3628800);
  const double pcd = fma(t, 1.0 / 6227020800.0, 1.0 / 479001600);
  const double p07 = fma(fma(p67, t2, p45), t4, fma(p23, t2, p01));
  const double p8d = fma(pcd, t4, fma(pab, t2, p89));
  const double y = fma(p8d, t8, p07) * __hiloint2double((1023 - n) << 20, 0);
  const double d = 2.0 + y;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
  r = fma(r, fma(-d, r, 1.0), r);
  r = fma(r, fma(-d, r, 1.0), r);
  const double s = y * r, w = s * s, w2 = w * w, w4 = w2 * w2, w8 = w4 * w4;
  const double q01 = fma(w, 1.0 / 3, 1.0), q23 = fma(w, 1.0 / 7, 1.0 / 5);
  const double q45 = fma(w, 1.0 / 11, 1.0 / 9), q67 = fma(w, 1.0 / 15, 1.0 / 13);
  const double q89 = fma(w, 1.0 / 19, 1.0 / 17), qab = fma(w, 1.0 / 23, 1.0 / 21);
  const double qcd = fma(w, 1.0 / 27, 1.0 / 25), qef = fma(w, 1.0 / 31, 1.0 / 29);
  const double q07 = fma(fma(q67, w2, q45), w4, fma(q23, w2, q01));
  const double q8f = fma(fma(qef, w2, qcd), w4, fma(qab, w2, q89));
  const double at = fma(w8 * w8, 1.0 / 33, fma(q8f, w8, q07));
  return m == -INFINITY ? -INFINITY : fma(2.0 * s, at, m);
}

__device__ __forceinline__ void lattice(const int* il, const int* tl, int b, int T, int U,
                                        int& tb, int& ub) {
  tb = min(max(il[b], 1), T);
  ub = min(max(tl[b], 0), U);
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A cell of the (B, T, U+1) lattice from a flat index, and whether it lies
// inside its utterance's clamped lengths.
struct Cell {
  int b, t, u;
  bool in;
};

__device__ __forceinline__ Cell cell_of(long long c, const int* il, const int* tl, int T,
                                        int U) {
  Cell x;
  x.u = static_cast<int>(c % (U + 1));
  const long long bt = c / (U + 1);
  x.t = static_cast<int>(bt % T);
  x.b = static_cast<int>(bt / T);
  int tb, ub;
  lattice(il, tl, x.b, T, U, tb, ub);
  x.in = x.t < tb && x.u <= ub;
  return x;
}

__device__ __forceinline__ size_t diag_at(const Cell& x, int T, int U) {
  return (static_cast<size_t>(x.b) * (T + U) + x.t + x.u) * (U + 1) + x.u;
}

// (a) G lanes a cell (G a power of two, a cell's lanes adjacent): every
// lane of the warp takes part in the shuffles, so none returns early
__global__ void rnnt_lse_kernel(const float* __restrict__ logits,
                                const int* __restrict__ targets, const int* __restrict__ il,
                                const int* __restrict__ tl, double* __restrict__ lse,
                                double* __restrict__ blank_d, double* __restrict__ emit_d,
                                long long cells, int T, int U, int V1, int blank_id, int G) {
  const long long c = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int j = threadIdx.x & (G - 1);
  Cell x{0, 0, 0, false};
  if (c < cells) x = cell_of(c, il, tl, T, U);
  const float* z = logits + c * V1;
  // kBatch loads in flight a lane, then their max; the sum re-reads them
  // (from L1)
  float m = -INFINITY;
  if (x.in)
    for (int k0 = j; k0 < V1; k0 += kBatch * G) {
      float v[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) v[r] = k0 + r * G < V1 ? __ldg(z + k0 + r * G) : m;
#pragma unroll
      for (int r = 0; r < kBatch; ++r) m = fmaxf(m, v[r]);
    }
  for (int o = G >> 1; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  double s = 0.0;
  if (x.in)
    for (int k0 = j; k0 < V1; k0 += kBatch * G) {
      float v[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r)
        v[r] = k0 + r * G < V1 ? __ldg(z + k0 + r * G) : -INFINITY;
#pragma unroll
      for (int r = 0; r < kBatch; ++r) s += static_cast<double>(expf(v[r] - m));
    }
  for (int o = G >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (!x.in || j != 0) return;
  const double l = static_cast<double>(m) + log(s);
  lse[c] = l;
  const size_t at = diag_at(x, T, U);
  blank_d[at] = static_cast<double>(__ldg(z + blank_id)) - l;
  if (x.u < U) {
    const int y = min(max(targets[static_cast<size_t>(x.b) * U + x.u], 0), V1 - 1);
    emit_d[at] = static_cast<double>(__ldg(z + y)) - l;
  }
}

// (a') the given log-probs into the diagonal-major rows, a thread a cell
__global__ void rnnt_diag_kernel(const float* __restrict__ blank_lp,
                                 const float* __restrict__ emit_lp, const int* __restrict__ il,
                                 const int* __restrict__ tl, double* __restrict__ blank_d,
                                 double* __restrict__ emit_d, long long cells, int T, int U) {
  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  const Cell x = cell_of(c, il, tl, T, U);
  if (!x.in) return;
  const size_t at = diag_at(x, T, U);
  blank_d[at] = static_cast<double>(blank_lp[c]);
  if (x.u < U)
    emit_d[at] = static_cast<double>(
        emit_lp[(static_cast<size_t>(x.b) * T + x.t) * U + x.u]);
}

// a clock64 stamp taken once `v` is computed (the empty asm needs it)
__device__ __forceinline__ void stamp_after(double v, long long* at) {
  asm volatile("" ::"d"(v) : "memory");
  *at = clock64();
}

// row `row` of an utterance's diagonal-major log-probs, columns 0..ub, into
// ring slot `slot` (blank then emit, U + 1 doubles each); the caller commits
__device__ __forceinline__ void stage_row(double* ring, const double* bd, const double* ed,
                                          int row, int slot, int ub, int U1) {
  double* sb = ring + static_cast<size_t>(slot) * 2 * U1;
  double* se = sb + U1;
  const size_t off = static_cast<size_t>(row) * U1;
  for (int u = threadIdx.x; u <= ub; u += blockDim.x) {
    cp_async8(sb + u, bd + off + u);
    cp_async8(se + u, ed + off + u);
  }
}

// (b) grid B (alpha alone) or 2B (two_sided: alpha in even blocks, beta in
// odd ones).  Shared memory: two diagonals of U + 1 doubles, then the ring
// of kStages x 2 rows.  With `stamps`, thread 0 of block x writes kStamps
// clock64 values a round at stamps[(x * (T + U) + round) * kStamps]: before
// the ring wait, after it, after the barrier, after the next row's copies
// are issued, once its cell's value is computed, after the round's stores.
__global__ void __launch_bounds__(kMaxThreads)
    rnnt_lattice_kernel(const double* __restrict__ blank_d, const double* __restrict__ emit_d,
                        const int* __restrict__ il, const int* __restrict__ tl,
                        double* __restrict__ alpha, double* __restrict__ hb,
                        double* __restrict__ he, double* __restrict__ ll,
                        float* __restrict__ nll, long long* __restrict__ stamps, int T, int U,
                        int two_sided) {
  extern __shared__ double smem[];
  const int U1 = U + 1;
  const int b = two_sided ? blockIdx.x >> 1 : blockIdx.x;
  const bool beta = two_sided && (blockIdx.x & 1);
  int tb, ub;
  lattice(il, tl, b, T, U, tb, ub);
  const int last = tb - 1 + ub;
  const size_t rows = static_cast<size_t>(b) * (T + U) * U1;
  const double* bd = blank_d + rows;
  const double* ed = emit_d + rows;
  const size_t nat = static_cast<size_t>(b) * T * U1;
  double* prev = smem;
  double* cur = smem + U1;
  double* ring = smem + 2 * U1;
  long long* st = stamps == nullptr || threadIdx.x != 0
                      ? nullptr
                      : stamps + static_cast<size_t>(blockIdx.x) * (T + U) * kStamps;
  if (!beta) {
    // alpha[d] from alpha[d - 1] and row d - 1 (rows 0 .. last - 1)
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < last) stage_row(ring, bd, ed, s, s, ub, U1);
      cp_commit();
    }
    for (int u = threadIdx.x; u <= ub; u += blockDim.x) prev[u] = u == 0 ? 0.0 : -INFINITY;
    if (threadIdx.x == 0) alpha[nat] = 0.0;
    for (int d = 1; d <= last; ++d) {
      if (st) st[(d - 1) * kStamps] = clock64();
      cp_wait<kStages - 2>();
      if (st) st[(d - 1) * kStamps + 1] = clock64();
      __syncthreads();
      if (st) st[(d - 1) * kStamps + 2] = clock64();
      const int row = d + kStages - 2;   // into the slot row d - 2 left
      if (row < last) stage_row(ring, bd, ed, row, row % kStages, ub, U1);
      cp_commit();
      if (st) st[(d - 1) * kStamps + 3] = clock64();
      const double* sb = ring + static_cast<size_t>((d - 1) % kStages) * 2 * U1;
      const double* se = sb + U1;
      const int lo = max(0, d - (tb - 1)), hi = min(d, ub);
      for (int u = threadIdx.x; u <= ub; u += blockDim.x) {
        const bool on = u >= lo && u <= hi;
        double v = -INFINITY;
        if (on) {
          const double h = u < d ? prev[u] + sb[u] : -INFINITY;             // t >= 1
          const double e = u >= 1 ? prev[u - 1] + se[u - 1] : -INFINITY;
          v = lae(h, e);
        }
        if (st) stamp_after(v, st + (d - 1) * kStamps + 4);
        if (on) alpha[nat + static_cast<size_t>(d - u) * U1 + u] = v;
        cur[u] = v;
      }
      if (st) st[(d - 1) * kStamps + 5] = clock64();
      double* s = prev;
      prev = cur;
      cur = s;
    }
    cp_wait<0>();
    __syncthreads();
    if (threadIdx.x == 0) {
      const double l = prev[ub] + bd[static_cast<size_t>(last) * U1 + ub];
      ll[b] = l;
      nll[b] = static_cast<float>(-l);
    }
    return;
  }
  // beta[d] from beta[d + 1] and row d, d = last .. 0 (round i = last - d)
  for (int s = 0; s < kStages - 1; ++s) {
    if (s <= last) stage_row(ring, bd, ed, last - s, s, ub, U1);
    cp_commit();
  }
  for (int u = threadIdx.x; u <= ub; u += blockDim.x) prev[u] = -INFINITY;
  for (int i = 0; i <= last; ++i) {
    const int d = last - i;
    if (st) st[i * kStamps] = clock64();
    cp_wait<kStages - 2>();
    if (st) st[i * kStamps + 1] = clock64();
    __syncthreads();
    if (st) st[i * kStamps + 2] = clock64();
    const int s = i + kStages - 1;       // into the slot round i - 1 left
    if (s <= last) stage_row(ring, bd, ed, last - s, s % kStages, ub, U1);
    cp_commit();
    if (st) st[i * kStamps + 3] = clock64();
    const double* sb = ring + static_cast<size_t>(i % kStages) * 2 * U1;
    const double* se = sb + U1;
    const int lo = max(0, d - (tb - 1)), hi = min(d, ub);
    for (int u = threadIdx.x; u <= ub; u += blockDim.x) {
      const bool on = u >= lo && u <= hi;
      const int t = d - u;
      double v = -INFINITY, h = -INFINITY, e = -INFINITY;
      if (on) {
        if (t == tb - 1 && u == ub) {
          h = sb[u];
          v = h;
        } else {
          h = t < tb - 1 ? sb[u] + prev[u] : -INFINITY;
          e = u < ub ? se[u] + prev[u + 1] : -INFINITY;
          v = lae(h, e);
        }
      }
      if (st) stamp_after(v, st + i * kStamps + 4);
      if (on) {
        const size_t at = nat + static_cast<size_t>(t) * U1 + u;
        hb[at] = h;
        he[at] = e;
      }
      cur[u] = v;
    }
    if (st) st[i * kStamps + 5] = clock64();
    double* sw = prev;
    prev = cur;
    cur = sw;
  }
  cp_wait<0>();
}

// (c) a block a chunk of kGradCells cells: first a thread a cell puts its
// g occ_b, g occ_e, lse and label into shared memory (lse = +inf past the
// lengths, so every element there is 0), then the block streams over the
// chunk's (V+1)-element rows as one contiguous run, 4-byte loads and
// stores of consecutive elements by consecutive threads; every element of
// the (B, T, U+1, V+1) gradient is written once
__global__ void rnnt_grad_kernel(const float* __restrict__ logits,
                                 const int* __restrict__ targets, const int* __restrict__ il,
                                 const int* __restrict__ tl, const double* __restrict__ lse,
                                 const double* __restrict__ alpha, const double* __restrict__ hb,
                                 const double* __restrict__ he, const double* __restrict__ ll,
                                 const float* __restrict__ grad_nll, float* __restrict__ grad,
                                 long long cells, int T, int U, int V1, int blank_id,
                                 float inv_v1) {
  __shared__ double s_gb[kGradCells], s_ge[kGradCells], s_lse[kGradCells];
  __shared__ int s_y[kGradCells];
  const long long c0 = static_cast<long long>(blockIdx.x) * kGradCells;
  const int nc = static_cast<int>(min(static_cast<long long>(kGradCells), cells - c0));
  if (threadIdx.x < nc) {
    const long long c = c0 + threadIdx.x;
    const Cell x = cell_of(c, il, tl, T, U);
    double gb = 0.0, ge = 0.0, s = INFINITY;
    int y = -1;
    if (x.in) {
      const double g = static_cast<double>(grad_nll[x.b]), l = ll[x.b], a = alpha[c];
      gb = g * exp(a + hb[c] - l);   // hb = -inf: no blank move
      ge = g * exp(a + he[c] - l);   // he = -inf at u = U_b
      s = lse[c];
      if (x.u < U) y = min(max(targets[static_cast<size_t>(x.b) * U + x.u], 0), V1 - 1);
    }
    s_gb[threadIdx.x] = gb;
    s_ge[threadIdx.x] = ge;
    s_lse[threadIdx.x] = s;
    s_y[threadIdx.x] = y;
  }
  __syncthreads();
  const float* z = logits + c0 * V1;
  float* gz = grad + c0 * V1;
  const int ne = nc * V1;
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    int i = static_cast<int>((static_cast<float>(e) + 0.5f) * inv_v1);
    int k = e - i * V1;
    if (k < 0) {
      --i;
      k += V1;
    } else if (k >= V1) {
      ++i;
      k -= V1;
    }
    const double p = static_cast<double>(
        expf(static_cast<float>(static_cast<double>(__ldg(z + e)) - s_lse[i])));
    double v = (s_gb[i] + s_ge[i]) * p;
    if (k == blank_id) v -= s_gb[i];
    if (k == s_y[i]) v -= s_ge[i];
    gz[e] = static_cast<float>(v);
  }
}

// (c') the log-probs' gradients, a thread a cell
__global__ void rnnt_occ_kernel(const int* __restrict__ il, const int* __restrict__ tl,
                                const double* __restrict__ alpha, const double* __restrict__ hb,
                                const double* __restrict__ he, const double* __restrict__ ll,
                                const float* __restrict__ grad_nll, float* __restrict__ gblank,
                                float* __restrict__ gemit, long long cells, int T, int U) {
  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  const Cell x = cell_of(c, il, tl, T, U);
  double gb = 0.0, ge = 0.0;
  if (x.in) {
    const double g = static_cast<double>(grad_nll[x.b]), l = ll[x.b], a = alpha[c];
    gb = -g * exp(a + hb[c] - l);
    ge = -g * exp(a + he[c] - l);
  }
  gblank[c] = static_cast<float>(gb);
  if (x.u < U) gemit[(static_cast<size_t>(x.b) * T + x.t) * U + x.u] = static_cast<float>(ge);
}

// the lattice's latency floor: `rounds` rounds of a __syncthreads and one
// double log-add-exp on registers a thread; the store never happens (the
// chain stays live)
__global__ void rnnt_round_floor_kernel(double* __restrict__ out, int rounds) {
  double v = -1.0 - 1e-3 * threadIdx.x, w = -2.0 + 1e-3 * blockIdx.x;
  for (int i = 0; i < rounds; ++i) {
    __syncthreads();
    const double n = lae(v - 0.5, w - 0.25);
    w = v;
    v = n;
  }
  if (v == 1.0) out[blockIdx.x] = v;
}

int threads_for(int U) {
  const int n = ((U + 1 + 31) / 32) * 32;
  return n < kMaxThreads ? n : kMaxThreads;
}

// lanes a cell in (a): one batch of loads a lane where a warp is enough
int cell_group(int V1) {
  int g = 1;
  while (g < 32 && g * kBatch < V1) g <<= 1;
  return g;
}

int cell_blocks(long long threads, unsigned& blocks) {
  const long long n = (threads + kCellThreads - 1) / kCellThreads;
  if (n < 1 || n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  blocks = static_cast<unsigned>(n);
  return 0;
}

size_t lattice_smem(int U) {
  return (2 + 2 * kStages) * static_cast<size_t>(U + 1) * sizeof(double);
}

}  // namespace

// (a): lse (B, T, U+1) double; blank_d, emit_d (B, T+U, U+1) double
// (diagonal-major) of logits (B, T, U+1, V1) float32 and targets (B, U)
// int32
extern "C" int qasr_rnnt_lse(const float* logits, const int* targets, const int* il,
                             const int* tl, double* lse, double* blank_d, double* emit_d,
                             int B, int T, int U, int V1, int blank_id, void* stream) {
  if (B < 1 || T < 1 || U < 0 || V1 < 1 || blank_id < 0 || blank_id >= V1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = cell_group(V1);
  const long long cells = static_cast<long long>(B) * T * (U + 1);
  unsigned blocks;
  if (int rc = cell_blocks(cells * G, blocks)) return rc;
  rnnt_lse_kernel<<<blocks, kCellThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, targets, il, tl, lse, blank_d, emit_d, cells, T, U, V1, blank_id, G);
  return static_cast<int>(cudaGetLastError());
}

// (a'): blank_d, emit_d of blank_lp (B, T, U+1) and emit_lp (B, T, U) float32
extern "C" int qasr_rnnt_diag(const float* blank_lp, const float* emit_lp, const int* il,
                              const int* tl, double* blank_d, double* emit_d, int B, int T,
                              int U, void* stream) {
  if (B < 1 || T < 1 || U < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = static_cast<long long>(B) * T * (U + 1);
  unsigned blocks;
  if (int rc = cell_blocks(cells, blocks)) return rc;
  rnnt_diag_kernel<<<blocks, kCellThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      blank_lp, emit_lp, il, tl, blank_d, emit_d, cells, T, U);
  return static_cast<int>(cudaGetLastError());
}

// (b): nll (B,) float32, ll (B,) double and alpha (B, T, U+1) double; with
// two_sided also hb, he (B, T, U+1) double; stamps (grid x (T+U) x kStamps
// int64) or NULL
extern "C" int qasr_rnnt_lattice(const double* blank_d, const double* emit_d, const int* il,
                                 const int* tl, double* alpha, double* hb, double* he,
                                 double* ll, float* nll, long long* stamps, int B, int T, int U,
                                 int two_sided, void* stream) {
  if (B < 1 || T < 1 || U < 0 || (two_sided && (hb == nullptr || he == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lattice_smem(U);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        rnnt_lattice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  rnnt_lattice_kernel<<<two_sided ? 2 * B : B, threads_for(U), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      blank_d, emit_d, il, tl, alpha, hb, he, ll, nll, stamps, T, U, two_sided);
  return static_cast<int>(cudaGetLastError());
}

// (c): grad (B, T, U+1, V1) float32 of grad_nll (B,)
extern "C" int qasr_rnnt_grad(const float* logits, const int* targets, const int* il,
                              const int* tl, const double* lse, const double* alpha,
                              const double* hb, const double* he, const double* ll,
                              const float* grad_nll, float* grad, int B, int T, int U, int V1,
                              int blank_id, void* stream) {
  if (B < 1 || T < 1 || U < 0 || V1 < 1 || blank_id < 0 || blank_id >= V1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = static_cast<long long>(B) * T * (U + 1);
  const long long blocks = (cells + kGradCells - 1) / kGradCells;
  if (blocks > 0x7fffffffLL || static_cast<long long>(V1) * kGradCells > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  rnnt_grad_kernel<<<static_cast<unsigned>(blocks), kCellThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      logits, targets, il, tl, lse, alpha, hb, he, ll, grad_nll, grad, cells, T, U, V1,
      blank_id, 1.0f / static_cast<float>(V1));
  return static_cast<int>(cudaGetLastError());
}

// (c'): grad_blank (B, T, U+1) and grad_emit (B, T, U) float32 of grad_nll
extern "C" int qasr_rnnt_occ(const int* il, const int* tl, const double* alpha,
                             const double* hb, const double* he, const double* ll,
                             const float* grad_nll, float* gblank, float* gemit, int B, int T,
                             int U, void* stream) {
  if (B < 1 || T < 1 || U < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = static_cast<long long>(B) * T * (U + 1);
  unsigned blocks;
  if (int rc = cell_blocks(cells, blocks)) return rc;
  rnnt_occ_kernel<<<blocks, kCellThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      il, tl, alpha, hb, he, ll, grad_nll, gblank, gemit, cells, T, U);
  return static_cast<int>(cudaGetLastError());
}

// the latency floor: `blocks` blocks of `threads` threads, `rounds` rounds
extern "C" int qasr_rnnt_round_floor(int blocks, int threads, int rounds, double* out,
                                     void* stream) {
  if (blocks < 1 || threads < 1 || threads > kMaxThreads || rounds < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  rnnt_round_floor_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out,
                                                                                      rounds);
  return static_cast<int>(cudaGetLastError());
}
