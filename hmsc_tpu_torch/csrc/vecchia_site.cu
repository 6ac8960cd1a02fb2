// B8e: the site-local Vecchia apply, one rank's partial of the NNGP
// factor's applications on a site mesh (the sampler's CG Eta draw when the
// level's units are split over the ranks).
//
// Replaces hmsc_tpu/mcmc/spatial.py · vecchia_ops_site, what it computes on
// one rank before its psum.  The rank holds the rows [off, off + np_l) of
// the level: their neighbour lists nn (np_l, k) with GLOBAL unit indices,
// the coefficient grid A (G, np_l, k) and the variances D (G, np_l), and
// its block of the per-unit likelihood gram LiSL (C, np_l, nf, nf).  With a
// = alpha[c, f] and sq_i = sqrt(D[a, i]):
//
//   riw_t form   t_i = u_i / sq_i                   (u: the rank's rows)
//   pmv form     t_i = (x[off+i] - sum_k A[a,i,k] x[nn[i,k]]) / sq_i / sq_i
//                                                   (x: the full iterate)
//   both         out[c,j,f] = -sum_{(i,k): nn[i,k] = j} A[a,i,k] t_i
//                             + (j = off + i ? t_i + sum_g LiSL[c,i,f,g]
//                                x[c,j,g] (pmv form) : 0)
//
// a full-width (C, np, nf) partial: summed over the ranks it is
// RiW' u, or P x = RiW'(RiW x) + LiSL x, as vecchia_ops (B8a) gives them.
// The sum is taken in the order of the JAX code: the scattered products,
// then the rank's own rows' t (+ LiSL x).
//
// What bounds it on the H100: launch latency, as B8a.  At config 3b's level
// on 2 ranks (C 4, np 1000, nf 2, k 10) the two launches read ~0.3 MB and
// write the 32 KB partial.  Design, built on B8a's apply kernels
// (vecchia_apply.cu · vecchia_fwd_kernel, vecchia_adj_kernel):
//   - the first launch covers the rank's rows only, a thread a (chain, row,
//     factor), reading the grid at alpha in place and the iterate at the
//     global neighbours, and writes t (C, np_l, nf);
//   - the second writes every global row j, a thread a (chain, row,
//     factor), from the rank's LOCAL reverse-neighbour CSR ("which of my
//     rows list unit j, at which slot", built once on the host with the
//     pads left out), in ascending position order, with no atomics: reruns
//     give the same bits, and ranks that hold the same data agree bit for
//     bit; a row that no local row lists and that is not the rank's own is
//     written as zero.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void vecchia_site_t_kernel(const float* __restrict__ x,
                                      const float* __restrict__ u,
                                      const int* __restrict__ nn,
                                      const float* __restrict__ coef,
                                      const float* __restrict__ D,
                                      const int* __restrict__ alpha,
                                      float* __restrict__ t, int C, int np,
                                      int np_l, int off, int nf, int k) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= static_cast<long long>(C) * np_l * nf) return;
  const int f = static_cast<int>(idx % nf);
  const long long ci = idx / nf;
  const int i = static_cast<int>(ci % np_l);
  const int c = static_cast<int>(ci / np_l);
  const long long a = alpha[c * nf + f];
  const float sq = sqrtf(D[a * np_l + i]);
  if (x == nullptr) {                 // riw_t form: the rank's rows of u
    t[idx] = u[idx] / sq;
    return;
  }
  const float* A = coef + (a * np_l + i) * k;
  const int* nb = nn + static_cast<long long>(i) * k;
  const float* xc = x + static_cast<long long>(c) * np * nf;
  float red = 0.0f;
  for (int kk = 0; kk < k; ++kk)
    red += A[kk] * xc[static_cast<long long>(nb[kk]) * nf + f];
  const float r = (xc[static_cast<long long>(off + i) * nf + f] - red) / sq;
  t[idx] = r / sq;
}

__global__ void vecchia_site_adj_kernel(const float* __restrict__ t,
                                        const int* __restrict__ rev_ptr,
                                        const int* __restrict__ rev_pos,
                                        const float* __restrict__ coef,
                                        const int* __restrict__ alpha,
                                        const float* __restrict__ LiSL,
                                        const float* __restrict__ x,
                                        float* __restrict__ out, int C,
                                        int np, int np_l, int off, int nf,
                                        int k) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= static_cast<long long>(C) * np * nf) return;
  const int f = static_cast<int>(idx % nf);
  const long long cj = idx / nf;
  const int j = static_cast<int>(cj % np);
  const int c = static_cast<int>(cj / np);
  const long long a = alpha[c * nf + f];
  const float* A = coef + a * np_l * k;
  const float* tc = t + static_cast<long long>(c) * np_l * nf;
  float acc = 0.0f;
  const int e1 = rev_ptr[j + 1];
  for (int e = rev_ptr[j]; e < e1; ++e) {
    const int pos = rev_pos[e];       // i * k + slot, i a local row
    acc += -(A[pos] * tc[static_cast<long long>(pos / k) * nf + f]);
  }
  const int il = j - off;
  if (il >= 0 && il < np_l) {
    float own = tc[static_cast<long long>(il) * nf + f];
    if (LiSL != nullptr) {
      // LiSL[c, il, f, :] . x[c, j, :]
      const float* Lr = LiSL + ((static_cast<long long>(c) * np_l + il) * nf +
                                f) * nf;
      const float* xr = x + cj * nf;
      float lik = 0.0f;
      for (int g = 0; g < nf; ++g) lik += Lr[g] * xr[g];
      own = own + lik;
    }
    acc = acc + own;
  }
  out[idx] = acc;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// One rank's partial (C, np, nf) of RiW' u (x null, u (C, np_l, nf), LiSL
// null) or of P x (x (C, np, nf), u null, LiSL (C, np_l, nf, nf)): two
// launches, t (C, np_l, nf) the scratch between them.
extern "C" int hmsc_vecchia_site(const float* x, const float* u,
                                 const int* nn, const float* coef,
                                 const float* D, const int* alpha,
                                 const int* rev_ptr, const int* rev_pos,
                                 const float* LiSL, float* t, float* out,
                                 int C, int np, int np_l, int off, int nf,
                                 int k, void* stream) {
  if (C < 0 || np < 1 || np_l < 1 || off < 0 || off + np_l > np || nf < 1 ||
      k < 1 || (x == nullptr) == (u == nullptr) ||
      (LiSL != nullptr && x == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_l = static_cast<long long>(C) * np_l * nf;
  vecchia_site_t_kernel<<<blocks_for(n_l), kThreads, 0, s>>>(
      x, u, nn, coef, D, alpha, t, C, np, np_l, off, nf, k);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(C) * np * nf;
  vecchia_site_adj_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      t, rev_ptr, rev_pos, coef, alpha, LiSL, x, out, C, np, np_l, off, nf,
      k);
  return static_cast<int>(cudaGetLastError());
}
