// B8b: the NNGP prior quadratics eta_h' iW(alpha) eta_h, over the alpha
// grid or at each factor's own alpha, with the location move's ones-forms.
//
// Replaces the NNGP branches of hmsc_tpu/mcmc/spatial.py:
//   eta_quad_grid      v[c,f,g] = sum_i (eta[c,i,f] - sum_k A[g,i,k] eta[c,nn[i,k],f])^2 / D[g,i]
//                      for every grid point g (update_alpha's G = 101 grid);
//   eta_quad_at        the same at g = alpha[c, f] (the scale interweave);
//   eta_ones_forms_at  (1' iW 1, 1' iW eta) at g = alpha[c, f], i.e.
//                      (sum_i r1_i^2, sum_i r1_i re_i) with
//                      r1_i = (1 - sum_k A[g,i,k]) / sqrt(D[g,i]) and
//                      re_i = (eta_i - sum_k A[g,i,k] eta_nn) / sqrt(D[g,i])
//                      (the location interweave).
// The at-alpha mode writes all three per column: out[c, f, :] = (q, q1, s).
//
// What bounds it on the H100: in grid mode, bytes: the coefficient grid,
// G np k floats (4 MB at config 3b's np 1000, k 10), is read once; the
// C nf np eta values are gathered k times per grid point from on-chip
// memory.  In at-alpha mode, launch latency (C nf columns of np units).
// Design:
//   - grid mode: one block per grid point g walks the units; each thread
//     loads coef[g,i,:] and D[g,i] once and applies them to a chunk of 8
//     eta columns (chain x factor), so the grid is read once per chunk, and
//     once in all for C nf <= 8 (config 3a/3b: 4 chains x 2 factors);
//   - eta is staged in shared memory when it fits (C np nf floats: 32 KB
//     at config 3b, 160 KB at np 5000; up to 226 KB of it) and read
//     from global memory (L2) when it does not;
//   - every sum is taken in a fixed order: per thread over its units, then
//     a warp-shuffle tree, then the warps' partials in warp order; no
//     atomics, so repeated runs give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;          // eta columns a grid-mode pass carries
// dynamic shared memory for staged eta: the H100's 227 KB a block, less
// 1 KB for the static scratch
constexpr int kSmemMax = 226 * 1024;

// Fixed-order block sum of one value per thread; thread 0 gets the total.
__device__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch may still be read by the previous sum
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) t += scratch[w];
  return t;
}

template <bool kStaged>
__global__ void nngp_quad_grid_kernel(const float* __restrict__ eta,
                                      const int* __restrict__ nn,
                                      const float* __restrict__ coef,
                                      const float* __restrict__ D,
                                      float* __restrict__ out, int C, int np,
                                      int nf, int k, int G) {
  extern __shared__ float staged[];
  __shared__ float scratch[kWarps];
  const int g = blockIdx.x;
  const long long n_eta = static_cast<long long>(C) * np * nf;
  const float* E = eta;
  if (kStaged) {
    for (long long t = threadIdx.x; t < n_eta; t += kThreads)
      staged[t] = eta[t];
    __syncthreads();
    E = staged;
  }
  const int ncol = C * nf;
  const float* Ag = coef + static_cast<long long>(g) * np * k;
  const float* Dg = D + static_cast<long long>(g) * np;
  for (int col0 = 0; col0 < ncol; col0 += kCols) {
    float acc[kCols];
    long long base[kCols];  // offset of column col0 + q's chain block + f
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      acc[q] = 0.0f;
      const int col = min(col0 + q, ncol - 1);
      base[q] = static_cast<long long>(col / nf) * np * nf + col % nf;
    }
    for (int i = threadIdx.x; i < np; i += kThreads) {
      float pred[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) pred[q] = 0.0f;
      const float* Ai = Ag + static_cast<long long>(i) * k;
      const int* nb = nn + static_cast<long long>(i) * k;
      for (int kk = 0; kk < k; ++kk) {
        const float a = Ai[kk];
        const long long off = static_cast<long long>(nb[kk]) * nf;
#pragma unroll
        for (int q = 0; q < kCols; ++q) pred[q] += a * E[base[q] + off];
      }
      const float d = Dg[i];
      const long long own = static_cast<long long>(i) * nf;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const float res = E[base[q] + own] - pred[q];
        acc[q] += res * res / d;
      }
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const float t = block_sum(acc[q], scratch);
      const int col = col0 + q;
      if (threadIdx.x == 0 && col < ncol)
        out[static_cast<long long>(col) * G + g] = t;
    }
  }
}

__global__ void nngp_quad_at_kernel(const float* __restrict__ eta,
                                    const int* __restrict__ nn,
                                    const float* __restrict__ coef,
                                    const float* __restrict__ D,
                                    const int* __restrict__ alpha,
                                    float* __restrict__ out, int np, int nf,
                                    int k) {
  __shared__ float scratch[kWarps];
  const int col = blockIdx.x;  // c * nf + f
  const int c = col / nf, f = col % nf;
  const long long a = alpha[col];
  const float* Aa = coef + a * np * k;
  const float* Da = D + a * np;
  const float* E = eta + static_cast<long long>(c) * np * nf + f;
  float q = 0.0f, q1 = 0.0f, s = 0.0f;
  for (int i = threadIdx.x; i < np; i += kThreads) {
    const float* Ai = Aa + static_cast<long long>(i) * k;
    const int* nb = nn + static_cast<long long>(i) * k;
    float pred = 0.0f, csum = 0.0f;
    for (int kk = 0; kk < k; ++kk) {
      pred += Ai[kk] * E[static_cast<long long>(nb[kk]) * nf];
      csum += Ai[kk];
    }
    const float d = Da[i];
    const float res = E[static_cast<long long>(i) * nf] - pred;
    q += res * res / d;
    const float sq = sqrtf(d);
    const float r1 = (1.0f - csum) / sq;
    const float re = res / sq;
    q1 += r1 * r1;
    s += r1 * re;
  }
  q = block_sum(q, scratch);
  q1 = block_sum(q1, scratch);
  s = block_sum(s, scratch);
  if (threadIdx.x == 0) {
    out[3 * col] = q;
    out[3 * col + 1] = q1;
    out[3 * col + 2] = s;
  }
}

}  // namespace

extern "C" int hmsc_nngp_quad_grid(const float* eta, const int* nn,
                                   const float* coef, const float* D,
                                   float* out, int C, int np, int nf, int k,
                                   int G, void* stream) {
  const long long bytes = 4LL * C * np * nf;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bytes <= kSmemMax) {
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          nngp_quad_grid_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (e != cudaSuccess) return static_cast<int>(e);
      attr_set = true;
    }
    nngp_quad_grid_kernel<true><<<G, kThreads, bytes, st>>>(
        eta, nn, coef, D, out, C, np, nf, k, G);
  } else {
    nngp_quad_grid_kernel<false><<<G, kThreads, 0, st>>>(
        eta, nn, coef, D, out, C, np, nf, k, G);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hmsc_nngp_quad_at(const float* eta, const int* nn,
                                 const float* coef, const float* D,
                                 const int* alpha, float* out, int C, int np,
                                 int nf, int k, void* stream) {
  nngp_quad_at_kernel<<<C * nf, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      eta, nn, coef, D, alpha, out, np, nf, k);
  return static_cast<int>(cudaGetLastError());
}
