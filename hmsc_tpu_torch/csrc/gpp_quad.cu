// B8d-3: the GPP (predictive-process) prior quadratics eta_h' iW eta_h, over
// the alpha grid or at each factor's own alpha, with the location move's
// ones-forms.
//
// Replaces the GPP branches of hmsc_tpu/mcmc/spatial.py:
//   eta_quad_grid (:426-437)   for every grid point g and column (c, h):
//       v = sum_u idDg[g,u] eta^2 - Et' iFg[g] Et,  Et = sum_u eta_u idDW12g[g,u,:]
//       or q_full = eta' eta where alphapw[g, 0] == 0 (W = I);
//   eta_quad_at (:463-478) and eta_ones_forms_at (:519-540) at g = alpha[c,h]:
//       q  = t1 - Ee' iF Ee,          (eta' eta at alpha 0)
//       q1 = sum_u idD - E1' iF E1,   (np at alpha 0)
//       s  = sum_u idD eta - E1' iF Ee (1' eta at alpha 0),
//       E1 = sum_u idDW12g[g,u,:], Ee = Et; written as out[c, h, :] = (q, q1, s).
//
// Numerics: iF = F^-1 is ill-conditioned at large alpha (cond(F) reaches
// 2.6e7 on config 3c's grid), and Et' iF Et is a sum of terms up to 1e7
// times larger than itself; summed in float32, or with iF rounded to
// float32, it is off by up to its own size there (the JAX package's float32
// form is), and the alpha sampler then jumps to the grid's top.  So iFg is
// held in float64 on the device, and the knot sums Et, the quadratic and
// the unit sums are accumulated in double; so is the (G, np, nK) grid
// idDW12g, whose float32 rounding moves the ones-form 1' iW 1 by ~2e-5 of
// itself at the grid's top (mcmc/structs.py · _F64_FIELDS); eta and idDg
// stay float32.  The result is rounded to float32 once, at the end.
//
// What bounds it on the H100: in grid mode, bytes: the float64 grid
// idDW12g (80.8 MB at config 3c: G 101, np 1000, nK 100) is the block's
// dominant byte stream and is read ONCE for all chains and factors; iFg
// (8.1 MB) and idDg (0.4 MB) once too.  In at-alpha mode, one grid slice
// per (chain, factor): launch latency and the slices' 800 KB each.
// Design:
//   - grid mode: one block per grid point; the block's warps take units u =
//     warp, warp + 8, ...; each lane holds one knot of each of 2 chunks of
//     32 (64 knots a pass), so a warp reads 2 x 32 consecutive doubles of one
//     unit's row of the grid for one read of the unit's eta values, and
//     every thread carries up to 8 (chain, factor) columns; the warps'
//     partial knot sums Et are then added in warp order and written to a
//     float64 scratch buffer the block reads back for Et' iF Et;
//   - at-alpha mode: one block per (chain, factor) at its alpha, the same
//     layout for E1 and Ee together;
//   - every sum is taken in a fixed order (per thread over its units or
//     entries, a warp-shuffle tree, then the warps in order); no atomics,
//     so two runs give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;    // (chain, factor) columns a grid-mode pass carries
constexpr int kChunks = 2;  // 32-knot chunks a pass carries

// Fixed-order block sum of one value per thread; thread 0 gets the total.
__device__ double block_sum(double v, double* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch may still be read by the previous sum
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) t += scratch[w];
  return t;
}

// eta[c, u, f] of column col = c nf + f
__device__ __forceinline__ long long eta_at(int col, int u, int np, int nf) {
  return (static_cast<long long>(col / nf) * np + u) * nf + col % nf;
}

__global__ void gpp_quad_grid_kernel(const float* __restrict__ eta,
                                     const float* __restrict__ idDg,
                                     const double* __restrict__ W,
                                     const double* __restrict__ iFg,
                                     const float* __restrict__ alphapw,
                                     double* Et, float* __restrict__ out,
                                     int C, int np, int nf, int nK, int G) {
  __shared__ double scratch[kWarps];
  __shared__ double part[kWarps][kChunks][kCols][32];
  const int g = blockIdx.x;
  const int ncol = C * nf;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (alphapw[2 * g] == 0.0f) {  // W = I: eta' eta
    for (int col = 0; col < ncol; ++col) {
      double q = 0.0;
      for (int u = threadIdx.x; u < np; u += kThreads) {
        const double e = eta[eta_at(col, u, np, nf)];
        q += e * e;
      }
      q = block_sum(q, scratch);
      if (threadIdx.x == 0)
        out[static_cast<long long>(col) * G + g] = static_cast<float>(q);
    }
    return;
  }
  const double* Wg = W + static_cast<long long>(g) * np * nK;
  const float* dg = idDg + static_cast<long long>(g) * np;
  const double* iF = iFg + static_cast<long long>(g) * nK * nK;
  double* Etg = Et + static_cast<long long>(g) * ncol * nK;
  for (int col0 = 0; col0 < ncol; col0 += kCols) {
    const int nc = min(kCols, ncol - col0);
    long long base[kCols];  // eta[c, 0, f] of column col0 + q
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      base[q] = eta_at(min(col0 + q, ncol - 1), 0, np, nf);
    // t1 = sum_u idD eta^2 per column
    double t1[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) t1[q] = 0.0;
    for (int u = threadIdx.x; u < np; u += kThreads) {
      const double d = dg[u];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const double e = eta[base[q] + static_cast<long long>(u) * nf];
        t1[q] += d * (e * e);
      }
    }
    // Et[col][m] = sum_u eta[col,u] W[g,u,m], kChunks x 32 knots a pass
    for (int m0 = 0; m0 < nK; m0 += 32 * kChunks) {
      double acc[kChunks][kCols];
#pragma unroll
      for (int k = 0; k < kChunks; ++k)
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[k][q] = 0.0;
#pragma unroll 2
      for (int u = warp; u < np; u += kWarps) {
        double e[kCols];
#pragma unroll
        for (int q = 0; q < kCols; ++q)
          e[q] = eta[base[q] + static_cast<long long>(u) * nf];
        const double* Wu = Wg + static_cast<long long>(u) * nK;
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          const int m = m0 + 32 * k + lane;
          const double w = m < nK ? Wu[m] : 0.0;
#pragma unroll
          for (int q = 0; q < kCols; ++q) acc[k][q] += e[q] * w;
        }
      }
#pragma unroll
      for (int k = 0; k < kChunks; ++k)
#pragma unroll
        for (int q = 0; q < kCols; ++q) part[warp][k][q][lane] = acc[k][q];
      __syncthreads();
      // (chunk, column, knot lane): the warps' partials in warp order
      for (int o = threadIdx.x; o < kChunks * kCols * 32; o += kThreads) {
        const int k = o / (kCols * 32), q = (o / 32) % kCols, l = o % 32;
        const int m = m0 + 32 * k + l;
        if (q < nc && m < nK) {
          double t = 0.0;
          for (int w = 0; w < kWarps; ++w) t += part[w][k][q][l];
          Etg[static_cast<long long>(col0 + q) * nK + m] = t;
        }
      }
      __syncthreads();
    }
    // t2 = Et' iF Et per column, over the nK^2 entries of iF
    double t2[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) t2[q] = 0.0;
    const long long nK2 = static_cast<long long>(nK) * nK;
    for (long long e = threadIdx.x; e < nK2; e += kThreads) {
      const int m = static_cast<int>(e / nK), k = static_cast<int>(e % nK);
      const double f = iF[e];
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        if (q < nc) {
          const double* Ec = Etg + static_cast<long long>(col0 + q) * nK;
          t2[q] += Ec[m] * f * Ec[k];
        }
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const double a = block_sum(t1[q], scratch);
      const double b = block_sum(t2[q], scratch);
      if (threadIdx.x == 0 && q < nc)
        out[static_cast<long long>(col0 + q) * G + g] =
            static_cast<float>(a - b);
    }
    __syncthreads();  // Etg of this chunk is read no more
  }
}

__global__ void gpp_quad_at_kernel(const float* __restrict__ eta,
                                   const float* __restrict__ idDg,
                                   const double* __restrict__ W,
                                   const double* __restrict__ iFg,
                                   const float* __restrict__ alphapw,
                                   const int* __restrict__ alpha, double* Es,
                                   float* __restrict__ out, int np, int nf,
                                   int nK) {
  __shared__ double scratch[kWarps];
  __shared__ double part[kWarps][kChunks][2][32];
  const int col = blockIdx.x;  // c * nf + f
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long a = alpha[col];
  const float* E = eta + eta_at(col, 0, np, nf);
  if (alphapw[2 * a] == 0.0f) {  // W = I: (eta' eta, np, 1' eta)
    double q = 0.0, s = 0.0;
    for (int u = threadIdx.x; u < np; u += kThreads) {
      const double e = E[static_cast<long long>(u) * nf];
      q += e * e;
      s += e;
    }
    q = block_sum(q, scratch);
    s = block_sum(s, scratch);
    if (threadIdx.x == 0) {
      out[3 * col] = static_cast<float>(q);
      out[3 * col + 1] = static_cast<float>(np);
      out[3 * col + 2] = static_cast<float>(s);
    }
    return;
  }
  const double* Wa = W + a * np * nK;
  const float* da = idDg + a * np;
  const double* iF = iFg + a * nK * nK;
  double* E1 = Es + static_cast<long long>(col) * 2 * nK;
  double* Ee = E1 + nK;
  double t1 = 0.0, td = 0.0, te = 0.0;
  for (int u = threadIdx.x; u < np; u += kThreads) {
    const double d = da[u];
    const double e = E[static_cast<long long>(u) * nf];
    t1 += d * (e * e);
    td += d;
    te += d * e;
  }
  for (int m0 = 0; m0 < nK; m0 += 32 * kChunks) {
    double a1[kChunks], ae[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) a1[k] = ae[k] = 0.0;
#pragma unroll 2
    for (int u = warp; u < np; u += kWarps) {
      const double e = E[static_cast<long long>(u) * nf];
      const double* Wu = Wa + static_cast<long long>(u) * nK;
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int m = m0 + 32 * k + lane;
        const double w = m < nK ? Wu[m] : 0.0;
        a1[k] += w;
        ae[k] += e * w;
      }
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      part[warp][k][0][lane] = a1[k];
      part[warp][k][1][lane] = ae[k];
    }
    __syncthreads();
    // (chunk, form, knot lane): the warps' partials in warp order
    for (int o = threadIdx.x; o < kChunks * 2 * 32; o += kThreads) {
      const int k = o / 64, which = (o / 32) % 2, l = o % 32;
      const int m = m0 + 32 * k + l;
      if (m < nK) {
        double t = 0.0;
        for (int w = 0; w < kWarps; ++w) t += part[w][k][which][l];
        (which == 0 ? E1 : Ee)[m] = t;
      }
    }
    __syncthreads();
  }
  double qq = 0.0, q11 = 0.0, q1e = 0.0;
  const long long nK2 = static_cast<long long>(nK) * nK;
  for (long long e = threadIdx.x; e < nK2; e += kThreads) {
    const int m = static_cast<int>(e / nK), k = static_cast<int>(e % nK);
    const double f = iF[e];
    qq += Ee[m] * f * Ee[k];
    q11 += E1[m] * f * E1[k];
    q1e += E1[m] * f * Ee[k];
  }
  t1 = block_sum(t1, scratch);
  td = block_sum(td, scratch);
  te = block_sum(te, scratch);
  qq = block_sum(qq, scratch);
  q11 = block_sum(q11, scratch);
  q1e = block_sum(q1e, scratch);
  if (threadIdx.x == 0) {
    out[3 * col] = static_cast<float>(t1 - qq);
    out[3 * col + 1] = static_cast<float>(td - q11);
    out[3 * col + 2] = static_cast<float>(te - q1e);
  }
}

}  // namespace

extern "C" int hmsc_gpp_quad_grid(const float* eta, const float* idDg,
                                  const double* idDW12g, const double* iFg,
                                  const float* alphapw, double* scratch,
                                  float* out, int C, int np, int nf, int nK,
                                  int G, void* stream) {
  if (C * nf == 0 || G == 0) return 0;
  gpp_quad_grid_kernel<<<G, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      eta, idDg, idDW12g, iFg, alphapw, scratch, out, C, np, nf, nK, G);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hmsc_gpp_quad_at(const float* eta, const float* idDg,
                                const double* idDW12g, const double* iFg,
                                const float* alphapw, const int* alpha,
                                double* scratch, float* out, int C, int np,
                                int nf, int nK, void* stream) {
  if (C * nf == 0) return 0;
  gpp_quad_at_kernel<<<C * nf, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      eta, idDg, idDW12g, iFg, alphapw, alpha, scratch, out, np, nf, nK);
  return static_cast<int>(cudaGetLastError());
}
