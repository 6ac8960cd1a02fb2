// B8a: apply the NNGP (Vecchia) factor RiW and its transpose, matrix-free.
//
// Replaces hmsc_tpu/mcmc/spatial.py · vecchia_ops (riw_t, pmv), the
// gathers + einsum + segment_sum that the JAX package's matrix-free CG Eta
// draw (vecchia_cg_draw, _eta_nngp_cg) applies once or twice per CG
// iteration.  With A the neighbour coefficients and D the conditional
// variances at each factor's alpha (grid point a = alpha[c, f]):
//
//   forward    r[c,i,f] = (x[c,i,f] - sum_k A[a,i,k] x[c,nn[i,k],f]) / sqrt(D[a,i])
//              (divided once more by sqrt(D) when `twice`: the t that the
//              transpose of pmv consumes)
//   transpose  out[c,j,f] = t[c,j,f] - sum_{(i,k): nn[i,k] = j} A[a,i,k] t[c,i,f]
//              with t = u / sqrt(D) (or u itself when the caller passes t),
//              plus sum_g LiSL[c,j,f,g] x[c,j,g] when LiSL is given: then
//              forward(twice) + transpose is P x = RiW'(RiW x) + LiSL x.
//
// What bounds it on the H100: launch latency.  At config 3b (4 chains,
// np 1000, nf 2, k 10) an apply reads ~0.4 MB (the coefficient slices at
// the chains' alphas, the iterate, the neighbour lists), a tenth of a
// microsecond of device memory time, so a launch costs more than its work.
// Design, for that and for repeatable results:
//   - one thread per (chain, unit, factor), reading the coefficient grid at
//     alpha[c, f] in place: the gathered (C, nf, np, k) copy the JAX code
//     forms is never made;
//   - the transpose is a GATHER over a reverse-neighbour CSR built once on
//     the host ("which rows list unit j, at which slot"), so every output
//     has one owner and a fixed order of summation, with no atomicAdd: two
//     runs give the same bits, and the card checks can be repeated;
//   - the CSR leaves out the pads (index 0, coefficient 0) of the short
//     neighbour lists; kept, they would give unit 0 some np k / 2 entries,
//     one thread's serial loop.  The forward keeps them, as the JAX code
//     does (they add exact zeros);
//   - at the alpha = 0 grid point every coefficient is 0 and D is 1, so
//     both directions return their input exactly (iW = I);
//   - the likelihood term of pmv is added in the same pass as the
//     transpose, so P x costs two launches.

#include <cuda_runtime.h>

namespace {

__global__ void vecchia_fwd_kernel(const float* __restrict__ x,
                                   const int* __restrict__ nn,
                                   const float* __restrict__ coef,
                                   const float* __restrict__ D,
                                   const int* __restrict__ alpha,
                                   float* __restrict__ out, int C, int np,
                                   int nf, int k, int twice) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= static_cast<long long>(C) * np * nf) return;
  const int f = static_cast<int>(idx % nf);
  const long long ci = idx / nf;
  const int i = static_cast<int>(ci % np);
  const int c = static_cast<int>(ci / np);
  const long long a = alpha[c * nf + f];
  const float* A = coef + (a * np + i) * k;
  const int* nb = nn + static_cast<long long>(i) * k;
  const float* xc = x + static_cast<long long>(c) * np * nf;
  float red = 0.0f;
  for (int kk = 0; kk < k; ++kk)
    red += A[kk] * xc[static_cast<long long>(nb[kk]) * nf + f];
  const float sq = sqrtf(D[a * np + i]);
  float r = (x[idx] - red) / sq;
  if (twice) r = r / sq;
  out[idx] = r;
}

__global__ void vecchia_adj_kernel(const float* __restrict__ u,
                                   const int* __restrict__ rev_ptr,
                                   const int* __restrict__ rev_pos,
                                   const float* __restrict__ coef,
                                   const float* __restrict__ D,
                                   const int* __restrict__ alpha,
                                   const float* __restrict__ LiSL,
                                   const float* __restrict__ x,
                                   float* __restrict__ out, int C, int np,
                                   int nf, int k, int divide) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= static_cast<long long>(C) * np * nf) return;
  const int f = static_cast<int>(idx % nf);
  const long long cj = idx / nf;
  const int j = static_cast<int>(cj % np);
  const int c = static_cast<int>(cj / np);
  const long long a = alpha[c * nf + f];
  const float* Da = D + a * np;
  const float* A = coef + a * np * k;
  const float* uc = u + static_cast<long long>(c) * np * nf;
  float tj = uc[static_cast<long long>(j) * nf + f];
  if (divide) tj = tj / sqrtf(Da[j]);
  float acc = 0.0f;
  const int e1 = rev_ptr[j + 1];
  for (int e = rev_ptr[j]; e < e1; ++e) {
    const int pos = rev_pos[e];  // i * k + slot
    const int i = pos / k;
    float ti = uc[static_cast<long long>(i) * nf + f];
    if (divide) ti = ti / sqrtf(Da[i]);
    acc += -(A[pos] * ti);
  }
  float o = tj + acc;
  if (LiSL != nullptr) {
    const float* Lr = LiSL + idx * nf;   // LiSL[c, j, f, :]
    const float* xr = x + cj * nf;       // x[c, j, :]
    float lik = 0.0f;
    for (int g = 0; g < nf; ++g) lik += Lr[g] * xr[g];
    o = o + lik;
  }
  out[idx] = o;
}

constexpr int kThreads = 256;

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int hmsc_vecchia_fwd(const float* x, const int* nn,
                                const float* coef, const float* D,
                                const int* alpha, float* out, int C, int np,
                                int nf, int k, int twice, void* stream) {
  const long long n = static_cast<long long>(C) * np * nf;
  vecchia_fwd_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, nn, coef, D, alpha, out, C, np, nf, k, twice);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hmsc_vecchia_adj(const float* u, const int* rev_ptr,
                                const int* rev_pos, const float* coef,
                                const float* D, const int* alpha,
                                const float* LiSL, const float* x, float* out,
                                int C, int np, int nf, int k, int divide,
                                void* stream) {
  const long long n = static_cast<long long>(C) * np * nf;
  vecchia_adj_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      u, rev_ptr, rev_pos, coef, D, alpha, LiSL, x, out, C, np, nf, k,
      divide);
  return static_cast<int>(cudaGetLastError());
}
