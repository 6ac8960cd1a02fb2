// B3, shrinkage form: a level's whole multiplicative-gamma shrinkage update
// (psi and delta) in one launch.
//
// Replaces hmsc_tpu/mcmc/updaters.py · update_lambda_priors for one level,
// with the Gamma draws of hmsc_tpu/ops/rand.py · standard_gamma inside
// (csrc/gamma.cuh, shared with the element form):
//
//   lam2  = (Lambda mask)^2, delta0 = mask ? Delta : 1, tau0 = cumprod delta0
//   Psi   = Ga(nu/2 + 1/2) / (nu/2 + lam2 tau0 / 2)           (C, nf, ns, ncr)
//   Msum  = sum_s Psi lam2                                      (C, nf, ncr)
//   for h = 0 .. nf-1 (delta updated in place, tau recomputed each step):
//     tail = sum_{f >= h} cumprod(delta)_f Msum_f mask_f
//     bd   = (h ? b2 : b1) + tail / 2 / delta_h
//     delta_h = mask_h ? Ga(ad_h) / bd : 1,
//     ad_0 = a1 + ns nf_act / 2,  ad_h = a2 + ns n_geq(h) / 2.
//
// The shapes of delta's draws depend on the mask alone, so all nf of them
// are drawn up front, in parallel; only the division by bd is sequential:
// nf steps of scalar arithmetic a (chain, column).  Every unit draw uses
// the Philox counter the element form (csrc/standard_gamma.cu) would give
// it: psi element i of the (C, nf, ns, ncr) array at the launch's first
// offset, delta element (c, h, col) of the (C, nf, ncr) array of shapes at
// its second, so the element form at the same (seed, offset) gives the same
// unit draws and the plain update fed with them the same Psi and Delta.
//
// What bounds it on the H100: the draws (~180 operations each, one
// Marsaglia-Tsang round at the shapes the sampler gives) and latency; the
// bytes (Lambda in, Psi out) are ~0.26 MB at the headline's C 4, nf 8, ns
// 1000.  It replaces ~1 + 14 nf small launches a level (the psi draw, and a
// delta draw plus ~14 tensor ops a factor, in a host loop).  Design
// (ops/rand.py · shrinkage_geometry chooses the shapes):
//   - a thread-block cluster of S <= 16 blocks of T <= 512 threads a
//     chain, so each lane draws one or two psi: at the headline's shape
//     64 SMs draw 500 each (8 blocks of 1024 threads, 32 SMs drawing 1000
//     each, took 0.0090 ms against 0.0078, scripts/shrinkage_sweep.py).
//     Above 8 blocks a cluster size is one the H100 allows but does not
//     promise: the wrapper takes the largest S that
//     cudaOccupancyMaxActiveClusters reports as schedulable
//     (hmsc_shrinkage_clusters).  The pieces (P, plen) are those of 16
//     blocks whatever S, so every S gives the same bits;
//   - a (factor, column) row of ns species is cut into P pieces of plen
//     species, and each warp of the cluster takes (row, piece) items in
//     turn, its lanes over the piece's species (Lambda and Psi read and
//     written in 128-byte runs at ncr 1); a warp sums its lanes' Psi lam2
//     by a fixed xor-shuffle tree and writes the piece's sum into block
//     0's shared memory (taking a lane's first unit draw before the block
//     has staged the mask and tau0, which it does not need, took 0.00794
//     ms against 0.00759 in one call);
//   - after one cluster barrier, block 0 draws delta's nf ncr unit gammas
//     (a thread each) while its last warps sum each row's pieces (a warp a
//     row: a lane's pieces in order, then the shuffle tree), forms each
//     step's tail sum over the factors not yet drawn (those are still
//     delta0, so the tail is the product of the deltas drawn times a sum
//     of delta0 alone, a thread a step, in parallel) and runs the chain, a
//     thread a column: nf steps of a few scalar operations.  The plain
//     form's nf^2 loads on one thread took ~0.0036 ms at nf 8.
// Every sum is taken in a fixed order (a lane over its species or pieces,
// the shuffle trees, the factors in order), with no atomics, so reruns give
// the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gamma.cuh"

namespace {

namespace cgk = cooperative_groups;

struct ShrinkArgs {
  const float* Lambda;            // (C, nf, ns, ncr)
  const float* mask;              // (C, nf), 1 active
  const float* Delta;             // (C, nf, ncr)
  const float* nu;                // (ncr,) each
  const float* a1;
  const float* b1;
  const float* a2;
  const float* b2;
  float* Psi;                     // (C, nf, ns, ncr)
  float* Delta_out;               // (C, nf, ncr)
  int nf, ns, ncr, S, P, plen;
  uint2 key;
  unsigned off_psi, off_delta;
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(512)
shrinkage_gamma_kernel(const ShrinkArgs a) {
  extern __shared__ float sm[];
  const int nf = a.nf, ns = a.ns, ncr = a.ncr, S = a.S, P = a.P;
  const int R = nf * ncr;                        // rows: (factor, column)
  float* mk = sm;                                // nf: the chain's mask
  float* d0 = mk + nf;                           // R: delta0
  float* tau0 = d0 + R;                          // R: cumprod of delta0
  float* gd = tau0 + R;                          // R unit draws of delta
  float* msum = gd + R;                          // R
  float* qs = msum + R;                          // R: the tails' sums q_h
  float* part = qs + R;                          // R P piece sums (block 0)
  const int rank = S > 1 ? static_cast<int>(cgk::this_cluster().block_rank())
                         : 0;
  if (S > 1) cluster_arrive_relaxed();
  const int c = blockIdx.x / S;
  const int T = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int wpb = T >> 5;
  const int items = R * P;
  const float* mask = a.mask + static_cast<long long>(c) * nf;
  for (int f = threadIdx.x; f < nf; f += T) mk[f] = __ldg(mask + f);
  for (int t = threadIdx.x; t < R; t += T)
    d0[t] = __ldg(mask + t / ncr) > 0.0f
                ? __ldg(a.Delta + static_cast<long long>(c) * R + t)
                : 1.0f;
  __syncthreads();
  for (int t = threadIdx.x; t < R; t += T) {
    const int h = t / ncr, col = t - h * ncr;
    float p = 1.0f;
    for (int f = 0; f <= h; ++f) p = __fmul_rn(p, d0[f * ncr + col]);
    tau0[t] = p;
  }
  __syncthreads();
  if (S > 1) cluster_wait();
  float* part0 = S > 1 ? cgk::this_cluster().map_shared_rank(part, 0) : part;
  for (int it = rank * wpb + (threadIdx.x >> 5); it < items; it += S * wpb) {
    const int row = it / P, piece = it - row * P;
    const int f = row / ncr, col = row - f * ncr;
    const float m = mk[f], tf = tau0[row];
    const float hnu = 0.5f * a.nu[col];
    const float shape = __fadd_rn(hnu, 0.5f);
    const long long base =
        (static_cast<long long>(c) * nf + f) * ns * ncr + col;
    const int s1 = min(ns, (piece + 1) * a.plen);
    float acc = 0.0f;
    for (int s = piece * a.plen + lane; s < s1; s += 32) {
      const long long i = base + static_cast<long long>(s) * ncr;
      const float lm = __fmul_rn(__ldg(a.Lambda + i), m);
      const float lam2 = __fmul_rn(lm, lm);
      const float b = __fadd_rn(hnu, __fmul_rn(0.5f * lam2, tf));
      const float psi =
          hmsc::standard_gamma_draw(shape, i, a.key, a.off_psi) / b;
      a.Psi[i] = psi;
      acc = __fadd_rn(acc, __fmul_rn(psi, lam2));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    if (lane == 0) part0[it] = acc;
  }
  if (S > 1) cgk::this_cluster().sync();
  else __syncthreads();
  if (rank != 0) return;
  // delta's unit draws (their shapes depend on the mask alone), a thread
  // each, while the last warps sum each row's pieces (a lane's pieces in
  // order, then the xor-shuffle tree)
  for (int t = threadIdx.x; t < R; t += T) {
    const int h = t / ncr, col = t - h * ncr;
    float nact = 0.0f, ngeq = 0.0f;
    for (int f = 0; f < nf; ++f) {
      nact += mk[f];
      if (f >= h) ngeq += mk[f];
    }
    const float half_ns = 0.5f * static_cast<float>(ns);
    const float ad = h == 0 ? __fadd_rn(a.a1[col], __fmul_rn(half_ns, nact))
                            : __fadd_rn(a.a2[col], __fmul_rn(half_ns, ngeq));
    gd[t] = hmsc::standard_gamma_draw(
        ad, static_cast<long long>(c) * R + t, a.key, a.off_delta);
  }
  for (int r = wpb - 1 - (threadIdx.x >> 5); r < R; r += wpb) {
    float s = 0.0f;
    for (int p = lane; p < P; p += 32) s = __fadd_rn(s, part[r * P + p]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) msum[r] = s;
  }
  __syncthreads();
  // at step h of the chain the deltas from h on are still delta0, so
  // tau_f = pre_h prod_{g=h..f} delta0_g with pre_h the product of the h
  // deltas drawn, and tail_h = pre_h q_h: q_h = sum_{f >= h} prod_{g=h..f}
  // delta0_g Msum_f mask_f, in order, a thread a (factor, column)
  for (int t = threadIdx.x; t < R; t += T) {
    const int h = t / ncr, col = t - h * ncr;
    float p = 1.0f, q = 0.0f;
    for (int f = h; f < nf; ++f) {
      p = __fmul_rn(p, d0[f * ncr + col]);
      q = __fadd_rn(q, __fmul_rn(__fmul_rn(p, msum[f * ncr + col]), mk[f]));
    }
    qs[t] = q;
  }
  __syncthreads();
  // the chain over the factors, a thread a column
  for (int col = threadIdx.x; col < ncr; col += T) {
    float pre = 1.0f;
    float* out = a.Delta_out + static_cast<long long>(c) * R;
    for (int h = 0; h < nf; ++h) {
      const int t = h * ncr + col;
      const float b0 = h == 0 ? a.b1[col] : a.b2[col];
      const float tail = __fmul_rn(pre, qs[t]);
      const float bd = __fadd_rn(b0, __fdiv_rn(0.5f * tail, d0[t]));
      const float d = mk[h] > 0.0f ? __fdiv_rn(gd[t], bd) : 1.0f;
      out[t] = d;
      pre = __fmul_rn(pre, d);
    }
  }
}

}  // namespace

// How many clusters of S blocks of T threads with `smem` bytes of dynamic
// shared memory the card can hold at once (cudaOccupancyMaxActiveClusters;
// 0: a cluster of that size cannot be scheduled), into *count.
extern "C" int hmsc_shrinkage_clusters(int S, int T, int smem, int* count) {
  *count = 0;
  if (S < 1 || S > 16 || T < 32 || T > 512 || smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        shrinkage_gamma_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        shrinkage_gamma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(S));
  cfg.blockDim = dim3(static_cast<unsigned>(T));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(count, shrinkage_gamma_kernel, &cfg));
}

// One launch for C chains: a cluster of S blocks of T threads a chain,
// nf + R (P + 5) floats of dynamic shared memory, R = nf ncr.
extern "C" int hmsc_shrinkage_gamma(const float* Lambda, const float* mask,
                                    const float* Delta, const float* nu,
                                    const float* a1, const float* b1,
                                    const float* a2, const float* b2,
                                    float* Psi, float* Delta_out, int C,
                                    int nf, int ns, int ncr, int S, int T,
                                    int P, int plen, unsigned long long seed,
                                    unsigned off_psi, unsigned off_delta,
                                    void* stream) {
  if (S < 1 || S > 16 || T < 32 || T > 512 || T % 32 != 0 || P < 1 ||
      plen < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        shrinkage_gamma_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ShrinkArgs a{Lambda, mask, Delta, nu, a1, b1, a2, b2, Psi, Delta_out,
               nf, ns, ncr, S, P, plen, hmsc::seed_key(seed), off_psi,
               off_delta};
  const size_t smem =
      sizeof(float) * (nf + static_cast<size_t>(nf) * ncr * (P + 5));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        shrinkage_gamma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C) * S);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, shrinkage_gamma_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
