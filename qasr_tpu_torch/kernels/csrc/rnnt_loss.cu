// Kernel 10: the RNN-Transducer loss and its gradient over the (T, U+1)
// lattice, for training (kernels/rnnt_loss.py wraps it in an autograd
// Function).
//
// Replaces no Pallas kernel: the JAX package computes the loss as a
// lax.scan over the lattice's anti-diagonals (qasr_tpu/models/rnnt.py:156-216,
// rnnt_loss_wavefront) and its gradient by autodiff; in plain torch that is
// ~T+U dependent steps of a few launches each, forward and again backward.
//
// What bounds it: the dependency chain, 2 (T_b + U_b) barrier rounds an
// utterance (forward and backward), each waiting on a few reads from
// device memory; the bytes (the two inputs, the gradients, alpha) are a
// few MB.  Design: one block an utterance; alpha, then beta, by
// anti-diagonals with two diagonals of U+1 values in shared memory and the
// threads over u (a thread takes u, u + blockDim, ... past 1,024); the
// recursions run in double (inputs and outputs float32), so the
// occupancy gradients exp(alpha + lp + beta - ll), formed from values of
// magnitude ~|ll|, stay as accurate as the float32 inputs.  The forward
// writes alpha (double) and ll for the backward, which zeroes the
// utterance's gradients and writes every lattice cell's:
//   d nll / d blank[t, u] = -exp(alpha[t,u] + blank[t,u] + beta[t+1,u] - ll)
//   d nll / d emit[t, u]  = -exp(alpha[t,u] + emit[t,u] + beta[t,u+1] - ll)
// with beta past the terminal cell (T_b - 1, U_b) taken as 0 and every cell
// with t >= T_b or u > U_b (or u >= U_b for emit) zero.  log-add-exp returns
// -inf for two -inf operands.  Lengths are clamped to T_b in [1, T] and U_b
// in [0, U], as the plain version does.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ double lae(double a, double b) {
  const double m = fmax(a, b);
  if (m == -INFINITY) return -INFINITY;
  return m + log1p(exp(-fabs(a - b)));
}

__device__ __forceinline__ void lattice(const int* il, const int* tl, int b, int T, int U,
                                        int& tb, int& ub) {
  tb = min(max(il[b], 1), T);
  ub = min(max(tl[b], 0), U);
}

__global__ void rnnt_alpha_kernel(const float* __restrict__ blank,
                                  const float* __restrict__ emit,
                                  const int* __restrict__ il, const int* __restrict__ tl,
                                  double* __restrict__ alpha, double* __restrict__ ll,
                                  float* __restrict__ nll, int T, int U) {
  extern __shared__ double diag[];  // two diagonals of U + 1 values
  const int b = blockIdx.x;
  const int U1 = U + 1;
  int tb, ub;
  lattice(il, tl, b, T, U, tb, ub);
  const float* bl = blank + static_cast<size_t>(b) * T * U1;
  const float* em = emit + static_cast<size_t>(b) * T * U;
  double* al = alpha + static_cast<size_t>(b) * T * U1;
  double* prev = diag;
  double* cur = diag + U1;
  for (int u = threadIdx.x; u <= ub; u += blockDim.x) prev[u] = u == 0 ? 0.0 : -INFINITY;
  if (threadIdx.x == 0) al[0] = 0.0;
  __syncthreads();
  const int last = tb - 1 + ub;
  for (int d = 1; d <= last; ++d) {
    const int lo = max(0, d - (tb - 1)), hi = min(d, ub);
    for (int u = threadIdx.x; u <= ub; u += blockDim.x) {
      double v = -INFINITY;
      if (u >= lo && u <= hi) {
        const int t = d - u;
        const double h = t >= 1 ? prev[u] + static_cast<double>(bl[(t - 1) * U1 + u])
                                : -INFINITY;
        const double e = u >= 1 ? prev[u - 1] + static_cast<double>(em[t * U + u - 1])
                                : -INFINITY;
        v = lae(h, e);
        al[t * U1 + u] = v;
      }
      cur[u] = v;
    }
    __syncthreads();
    double* s = prev;
    prev = cur;
    cur = s;
  }
  if (threadIdx.x == 0) {
    const double l = prev[ub] + static_cast<double>(bl[(tb - 1) * U1 + ub]);
    ll[b] = l;
    nll[b] = static_cast<float>(-l);
  }
}

__global__ void rnnt_beta_grad_kernel(const float* __restrict__ blank,
                                      const float* __restrict__ emit,
                                      const int* __restrict__ il, const int* __restrict__ tl,
                                      const double* __restrict__ alpha,
                                      const double* __restrict__ ll,
                                      const float* __restrict__ grad_nll,
                                      float* __restrict__ gblank, float* __restrict__ gemit,
                                      int T, int U) {
  extern __shared__ double diag[];  // beta on diagonals d + 1 and d
  const int b = blockIdx.x;
  const int U1 = U + 1;
  int tb, ub;
  lattice(il, tl, b, T, U, tb, ub);
  const size_t row = static_cast<size_t>(b) * T;
  const float* bl = blank + row * U1;
  const float* em = emit + row * U;
  const double* al = alpha + row * U1;
  float* gb = gblank + row * U1;
  float* ge = gemit + row * U;
  for (int i = threadIdx.x; i < T * U1; i += blockDim.x) gb[i] = 0.0f;
  for (int i = threadIdx.x; i < T * U; i += blockDim.x) ge[i] = 0.0f;
  __syncthreads();
  const double g = static_cast<double>(grad_nll[b]);
  const double l = ll[b];
  double* next = diag;
  double* cur = diag + U1;
  for (int d = tb - 1 + ub; d >= 0; --d) {
    const int lo = max(0, d - (tb - 1)), hi = min(d, ub);
    for (int u = threadIdx.x; u <= ub; u += blockDim.x) {
      double v = -INFINITY;
      if (u >= lo && u <= hi) {
        const int t = d - u;
        const double a = al[t * U1 + u];
        const double bk = static_cast<double>(bl[t * U1 + u]);
        double gbv = 0.0, gev = 0.0;
        if (t == tb - 1 && u == ub) {
          v = bk;
          gbv = -exp(a + bk - l) * g;
        } else {
          const double h = t + 1 <= tb - 1 ? bk + next[u] : -INFINITY;
          const double e = u + 1 <= ub ? static_cast<double>(em[t * U + u]) + next[u + 1]
                                       : -INFINITY;
          v = lae(h, e);
          if (h > -INFINITY) gbv = -exp(a + h - l) * g;
          if (e > -INFINITY) gev = -exp(a + e - l) * g;
        }
        gb[t * U1 + u] = static_cast<float>(gbv);
        if (u < ub) ge[t * U + u] = static_cast<float>(gev);
      }
      cur[u] = v;
    }
    __syncthreads();
    double* s = next;
    next = cur;
    cur = s;
  }
}

int threads_for(int U) {
  const int n = ((U + 1 + 31) / 32) * 32;
  return n < kMaxThreads ? n : kMaxThreads;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// nll (B,) float32 and, for the backward, alpha (B, T, U+1) double and ll
// (B,) double, of blank (B, T, U+1) and emit (B, T, U) float32 log-probs.
extern "C" int qasr_rnnt_loss_fwd(const float* blank, const float* emit, const int* il,
                                  const int* tl, double* alpha, double* ll, float* nll,
                                  int B, int T, int U, void* stream) {
  if (B < 1 || T < 1 || U < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(U + 1) * sizeof(double);
  const cudaError_t attr = allow_smem(rnnt_alpha_kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  rnnt_alpha_kernel<<<B, threads_for(U), smem, static_cast<cudaStream_t>(stream)>>>(
      blank, emit, il, tl, alpha, ll, nll, T, U);
  return static_cast<int>(cudaGetLastError());
}

// grad_blank (B, T, U+1) and grad_emit (B, T, U) float32 of grad_nll (B,).
extern "C" int qasr_rnnt_loss_bwd(const float* blank, const float* emit, const int* il,
                                  const int* tl, const double* alpha, const double* ll,
                                  const float* grad_nll, float* gblank, float* gemit,
                                  int B, int T, int U, void* stream) {
  if (B < 1 || T < 1 || U < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(U + 1) * sizeof(double);
  const cudaError_t attr = allow_smem(rnnt_beta_grad_kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  rnnt_beta_grad_kernel<<<B, threads_for(U), smem, static_cast<cudaStream_t>(stream)>>>(
      blank, emit, il, tl, alpha, ll, grad_nll, gblank, gemit, T, U);
  return static_cast<int>(cudaGetLastError());
}
