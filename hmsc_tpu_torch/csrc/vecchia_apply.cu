// B8a: apply the NNGP (Vecchia) factor RiW and its transpose, matrix-free,
// one apply a launch (the card checks and the plain path) or a whole
// conjugate-gradient Eta draw a launch (the sampler's path; see the second
// half of this file).
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

#include <cooperative_groups.h>
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

// ---------------------------------------------------------------------------
// The whole CG draw in one launch.
//
// Replaces the rest of hmsc_tpu/mcmc/spatial.py · _eta_nngp_cg (:290-350)
// and vecchia_cg_draw (:134-148): b = F + RiW' eps1 + b_like, then
// jax.scipy.sparse.linalg.cg on P x = b from x0 (tol relative to |b|, atol
// 0, maxiter), then the true relative residual |P x - b| / max(|b|, 1e-30),
// per chain.  The JAX package runs the loop on the device in a while_loop
// under vmap, so a chain that has converged is frozen until the others
// have; here each chain stops at its own count (the same iterates), and no
// host reads the convergence.
//
// What bounds it on the H100: latency.  At config 3b (4 chains, np 1000,
// nf 2, k 10) a chain's vectors are 8 KB each and all it reads in an
// iteration (the coefficients and variances at its alphas, the neighbour
// lists and the reverse CSR, ~0.2 MB a chain) stays in L1 or L2, so an
// iteration is a chain of dependent gathers and two dot products.  Design:
//   - one thread-block cluster a chain, of G = 1 to 8 CTAs of up to 256
//     threads (ops/spatial.py · cg_geometry, from np); each CTA owns a
//     contiguous range of units, a thread a unit with all its factors, so
//     a unit's neighbour list and reverse-CSR entries are read once for its
//     nf factors, and each list's loads issue together (unrolled) before
//     the gathers that need them;
//   - p and t, which the applies gather, are whole in every CTA's shared
//     memory: each CTA writes its units' new values into every copy
//     through distributed shared memory, so all gathers are local (remote
//     gathers measured slower than L2); x, r, Ap and b are the CTA's
//     slices; shapes that do not fit keep them in a global scratch
//     instead, read through L2 (.cg loads); the rest of the SM's 256 KB is
//     L1 for the grids;
//   - dot products reduce in a fixed order: a butterfly in the warp, the
//     warps' partials by a butterfly in warp 0, the CTAs in rank order
//     after a cluster barrier, so every CTA holds the same bits and reruns
//     are bit-identical;
//   - the coefficient grid is read in place at each factor's alpha (and,
//     with the lists and LiSL, through the read-only path), the
//     reverse-neighbour CSR leaves out the pads, alpha 0 is the identity,
//     exactly as the single applies above.
// Four barriers an iteration (after the forward, in each dot product,
// after p's update); for G = 1 they are CTA barriers.
// ---------------------------------------------------------------------------

namespace {

namespace cgk = cooperative_groups;

constexpr int kCgThreads = 256;
constexpr int kCgScratch = 128;    // floats: warp partials, CTA partials
// list entries whose loads issue together: 16 coefficients' worth
template <int NFM>
__host__ __device__ constexpr int unroll_for() {
  return NFM >= 16 ? 1 : 16 / NFM;
}

struct CgArgs {
  const int* nn;
  const float* coef;
  const float* D;
  const int* alpha;
  const int* rev_ptr;
  const int* rev_pos;
  const float* LiSL;     // (C, np, nf, nf)
  const float* F;        // (C, np, nf)
  const float* eps1;
  const float* b_like;
  const float* x0;
  float* x;              // (C, np, nf) out
  float* res;            // (C,) out
  int* iters;            // (C,) out
  float* work;           // (C, 6, np nf) where the slices do not fit, or null
  int np, nf, k, G, units, maxiter;
  float tol2;
  double inv_k;          // 1 / k, to find a reverse entry's unit
};

template <bool kGlobal, int NFM>
__global__ void __launch_bounds__(kCgThreads, 1)
vecchia_cg_kernel(const CgArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int G = a.G, nf = a.nf, np = a.np, k = a.k;
  const int rank = G > 1 ? static_cast<int>(cgk::this_cluster().block_rank())
                         : 0;
  const int c = blockIdx.x / G;
  const int u0 = rank * a.units;
  const int nu = max(0, min(np, u0 + a.units) - u0);
  const long long E = static_cast<long long>(np) * nf;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nth = blockDim.x, nwarps = nth >> 5;
  float* red_w = sm;                 // [2][32 warps]
  float* red_c = sm + 64;            // [2 slots][2]
  // p and t, which the applies gather, whole (np, nf) in every CTA of the
  // cluster (each CTA writes its units' values into all copies), or one
  // copy in the global scratch; x, r, Ap and b, the CTA's own units only
  const long long cap = static_cast<long long>(a.units) * nf;
  float* base = kGlobal ? a.work + static_cast<long long>(c) * 6 * E
                        : sm + kCgScratch;
  float* pf = base;
  float* tf = base + E;
  float* x = kGlobal ? base + 2 * E + u0 * nf : base + 2 * E;
  const long long own_stride = kGlobal ? E : cap;
  float* r = x + own_stride;
  float* ap = x + 2 * own_stride;
  float* b = x + 3 * own_stride;
  const float* LiSL = a.LiSL + static_cast<long long>(c) * E * nf;
  const long long cE = static_cast<long long>(c) * E + u0 * nf;
  // each factor's coefficient and variance slices at its alpha
  const float* Af[NFM];
  const float* Df[NFM];
#pragma unroll
  for (int f = 0; f < NFM; ++f) {
    const long long af = f < nf ? __ldg(a.alpha + c * nf + f) : 0;
    Af[f] = a.coef + af * np * k;
    Df[f] = a.D + af * np;
  }

  auto sync = [&]() {
    if (G > 1) cgk::this_cluster().sync();
    else __syncthreads();
  };
  auto ld = [&](const float* v, int i) -> float {
    if constexpr (kGlobal) return __ldcg(v + i);
    else return v[i];
  };
  // element i of a whole vector, into every copy
  auto put = [&](float* v, int i, float val) {
    if (kGlobal || G == 1) {
      v[i] = val;
    } else {
      for (int q = 0; q < G; ++q)
        cgk::this_cluster().map_shared_rank(v, q)[i] = val;
    }
  };
  // the sum of each thread's v0 (and v1) over the cluster, in a fixed order
  int slot = 0;
  auto reduce = [&](float v0, float v1) -> float2 {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, o);
      v1 += __shfl_xor_sync(0xffffffffu, v1, o);
    }
    if (lane == 0) {
      red_w[warp] = v0;
      red_w[32 + warp] = v1;
    }
    __syncthreads();
    if (warp == 0) {
      float w0 = lane < nwarps ? red_w[lane] : 0.0f;
      float w1 = lane < nwarps ? red_w[32 + lane] : 0.0f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        w0 += __shfl_xor_sync(0xffffffffu, w0, o);
        w1 += __shfl_xor_sync(0xffffffffu, w1, o);
      }
      if (lane == 0) {
        red_c[slot * 2] = w0;
        red_c[slot * 2 + 1] = w1;
      }
    }
    sync();
    float o0 = 0.0f, o1 = 0.0f;
    for (int q = 0; q < G; ++q) {
      const float* rc = red_c;
      if (G > 1) rc = cgk::this_cluster().map_shared_rank(red_c, q);
      o0 += rc[slot * 2];
      o1 += rc[slot * 2 + 1];
    }
    slot ^= 1;
    return make_float2(o0, o1);
  };
  constexpr int kUnroll = unroll_for<NFM>();
  // RiW v scaled twice by sqrt(D) (the t of P v) at unit i, each factor
  // into out[f]
  auto forward = [&](const float* v, int i, float (&out)[NFM]) {
    const int* nb = a.nn + static_cast<long long>(i) * k;
    const int row = i * k;
    float red[NFM];
#pragma unroll
    for (int f = 0; f < NFM; ++f) red[f] = 0.0f;
    for (int k0 = 0; k0 < k; k0 += kUnroll) {
      int j[kUnroll];
      float A[kUnroll][NFM];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const bool ok = k0 + q < k;
        j[q] = ok ? __ldg(nb + k0 + q) : 0;
#pragma unroll
        for (int f = 0; f < NFM; ++f)
          A[q][f] = (ok && f < nf) ? __ldg(Af[f] + row + k0 + q) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (k0 + q >= k) break;
#pragma unroll
        for (int f = 0; f < NFM; ++f)
          if (f < nf) red[f] += A[q][f] * ld(v, j[q] * nf + f);
      }
    }
#pragma unroll
    for (int f = 0; f < NFM; ++f) {
      if (f >= nf) break;
      const float sq = sqrtf(__ldg(Df[f] + i));
      const float rr = (ld(v, i * nf + f) - red[f]) / sq;
      out[f] = rr / sq;
    }
  };
  // RiW' tv at unit jn, plus LiSL v (over the unit's factors) when lik,
  // each factor into out[f]
  auto adjoint = [&](const float* tv, const float* v, bool lik, int jn,
                     float (&out)[NFM]) {
    float acc[NFM];
#pragma unroll
    for (int f = 0; f < NFM; ++f) acc[f] = 0.0f;
    const int q0 = __ldg(a.rev_ptr + jn), q1 = __ldg(a.rev_ptr + jn + 1);
    for (int qb = q0; qb < q1; qb += kUnroll) {
      int i[kUnroll];
      float A[kUnroll][NFM];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const bool ok = qb + q < q1;
        const int pos = ok ? __ldg(a.rev_pos + qb + q) : 0;  // i k + slot
        int u = static_cast<int>(pos * a.inv_k);      // pos / k, then exact
        u += (pos - u * k >= k) - (pos - u * k < 0);
        i[q] = u;
#pragma unroll
        for (int f = 0; f < NFM; ++f)
          A[q][f] = (ok && f < nf) ? __ldg(Af[f] + pos) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (qb + q >= q1) break;
#pragma unroll
        for (int f = 0; f < NFM; ++f)
          if (f < nf) acc[f] += -(A[q][f] * ld(tv, i[q] * nf + f));
      }
    }
#pragma unroll
    for (int f = 0; f < NFM; ++f) {
      if (f >= nf) break;
      float o = ld(tv, jn * nf + f) + acc[f];
      if (lik) {
        const float* Lr = LiSL + (static_cast<long long>(jn) * nf + f) * nf;
        float l = 0.0f;
#pragma unroll
        for (int g = 0; g < NFM; ++g)
          if (g < nf) l += __ldg(Lr + g) * ld(v, jn * nf + g);
        o = o + l;
      }
      out[f] = o;
    }
  };

  float o[NFM];
  // t = eps1 / sqrt(D) (for RiW' eps1); x = p = x0
  for (int lu = tid; lu < nu; lu += nth) {
    const int i = u0 + lu;
#pragma unroll
    for (int f = 0; f < NFM; ++f) {
      if (f >= nf) break;
      const int e = lu * nf + f;
      const int gi = i * nf + f;
      put(tf, gi, a.eps1[cE + e] / sqrtf(__ldg(Df[f] + i)));
      x[e] = a.x0[cE + e];
      put(pf, gi, a.x0[cE + e]);
    }
  }
  sync();
  // b = F + RiW' eps1 + b_like
  for (int lu = tid; lu < nu; lu += nth) {
    adjoint(tf, nullptr, false, u0 + lu, o);
#pragma unroll
    for (int f = 0; f < NFM; ++f) {
      if (f >= nf) break;
      const int e = lu * nf + f;
      b[e] = a.F[cE + e] + o[f] + a.b_like[cE + e];
    }
  }
  sync();
  // the applies' t of P v for v = the whole vector pf, into every tf
  auto forward_all = [&]() {
    for (int lu = tid; lu < nu; lu += nth) {
      forward(pf, u0 + lu, o);
#pragma unroll
      for (int f = 0; f < NFM; ++f)
        if (f < nf) put(tf, (u0 + lu) * nf + f, o[f]);
    }
    sync();
  };
  forward_all();
  // r = b - P x0, p = r
  float rr = 0.0f, bb = 0.0f;
  for (int lu = tid; lu < nu; lu += nth) {
    adjoint(tf, pf, true, u0 + lu, o);
#pragma unroll
    for (int f = 0; f < NFM; ++f) {
      if (f >= nf) break;
      const int e = lu * nf + f;
      const float be = ld(b, e);
      const float re = be - o[f];
      r[e] = re;
      put(pf, (u0 + lu) * nf + f, re);
      rr += re * re;
      bb += be * be;
    }
  }
  const float2 g0 = reduce(rr, bb);
  float gamma = g0.x;
  const float atol2 = a.tol2 * g0.y;
  int it = 0;
  while (gamma > atol2 && it < a.maxiter) {
    forward_all();
    float pap = 0.0f;
    for (int lu = tid; lu < nu; lu += nth) {
      adjoint(tf, pf, true, u0 + lu, o);
#pragma unroll
      for (int f = 0; f < NFM; ++f) {
        if (f >= nf) break;
        const int e = lu * nf + f;
        ap[e] = o[f];
        pap += ld(pf, u0 * nf + e) * o[f];
      }
    }
    const float alpha = gamma / reduce(pap, 0.0f).x;
    float rn = 0.0f;
    for (int e = tid; e < nu * nf; e += nth) {
      const float pe = ld(pf, u0 * nf + e);
      x[e] = ld(x, e) + alpha * pe;
      const float re = ld(r, e) - alpha * ld(ap, e);
      r[e] = re;
      rn += re * re;
    }
    const float gnew = reduce(rn, 0.0f).x;
    const float beta = gnew / gamma;
    for (int e = tid; e < nu * nf; e += nth) {
      const int gi = u0 * nf + e;
      put(pf, gi, ld(r, e) + beta * ld(pf, gi));
    }
    gamma = gnew;
    ++it;
    sync();
  }
  // the true residual |P x - b| / max(|b|, 1e-30), with pf = x
  for (int e = tid; e < nu * nf; e += nth)
    put(pf, u0 * nf + e, ld(x, e));
  sync();
  forward_all();
  float dd = 0.0f;
  for (int lu = tid; lu < nu; lu += nth) {
    adjoint(tf, pf, true, u0 + lu, o);
#pragma unroll
    for (int f = 0; f < NFM; ++f) {
      if (f >= nf) break;
      const float d = o[f] - ld(b, lu * nf + f);
      dd += d * d;
    }
  }
  const float res2 = reduce(dd, 0.0f).x;
  for (int e = tid; e < nu * nf; e += nth) a.x[cE + e] = ld(x, e);
  if (rank == 0 && tid == 0) {
    a.res[c] = sqrtf(res2) / fmaxf(sqrtf(g0.y), 1e-30f);
    a.iters[c] = it;
  }
  sync();            // no CTA leaves while a peer may read its memory
}

template <bool kGlobal>
cudaError_t cg_kernel_for(int nf, void (**kernel)(const CgArgs)) {
  switch (nf <= 2 ? 2 : nf <= 4 ? 4 : nf <= 8 ? 8 : nf <= 16 ? 16 : 0) {
    case 2: *kernel = vecchia_cg_kernel<kGlobal, 2>; return cudaSuccess;
    case 4: *kernel = vecchia_cg_kernel<kGlobal, 4>; return cudaSuccess;
    case 8: *kernel = vecchia_cg_kernel<kGlobal, 8>; return cudaSuccess;
    case 16: *kernel = vecchia_cg_kernel<kGlobal, 16>; return cudaSuccess;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One CG Eta draw for C chains (see above): a cluster of G CTAs of
// `threads` threads a chain, `units` units a CTA, nf <= 16; `work` null
// keeps the vectors in shared memory (smem bytes a CTA), else (C, 6, np nf)
// floats of global scratch.
extern "C" int hmsc_vecchia_cg(const int* nn, const float* coef,
                               const float* D, const int* alpha,
                               const int* rev_ptr, const int* rev_pos,
                               const float* LiSL, const float* F,
                               const float* eps1, const float* b_like,
                               const float* x0, float* x, float* res,
                               int* iters, float* work, int C, int np, int nf,
                               int k, int G, int units, int threads,
                               int maxiter, float tol2, int smem,
                               void* stream) {
  if (G < 1 || G > 8 || units < 1 || static_cast<long long>(G) * units < np
      || maxiter < 0 || nf > 16 || k < 1 || threads < 32 ||
      threads > kCgThreads || threads % 32 != 0 ||
      static_cast<long long>(np) * nf * nf >= (1LL << 31) ||
      static_cast<long long>(np) * k >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || np == 0 || nf == 0) return 0;
  CgArgs a{nn, coef, D, alpha, rev_ptr, rev_pos, LiSL, F, eps1, b_like, x0,
           x, res, iters, work, np, nf, k, G, units, maxiter, tol2, 1.0 / k};
  void (*kernel)(const CgArgs) = nullptr;
  cudaError_t e = work != nullptr ? cg_kernel_for<true>(nf, &kernel)
                                  : cg_kernel_for<false>(nf, &kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the least shared memory that holds the slices: the rest is L1
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxL1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C) * G);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
