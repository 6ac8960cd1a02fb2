// Pieces shared by the serving kernels B9a (csrc/serve_predict.cu) and B9b
// (csrc/serve_conditional.cu): the posterior draws' load type, the table of
// random levels, the running moments over draws and their fixed-order
// combination across draw chunks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hmsc {

// Draws are staged as float32 or bfloat16; a load widens to float32 in
// registers (exact), as the JAX kernels upcast at entry.
__device__ __forceinline__ float load_draw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_draw(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

constexpr int kMaxLevels = 8;

// Each random level's loadings Lambda_r (n, nf_r, ns) and factors Eta_r (n,
// np_r, nf_r) (the last row all zero: the mean-field new unit), with the
// level's offset into a query row's concatenated factors.
struct LevelTable {
  const void* lam[kMaxLevels];
  const void* eta[kMaxLevels];
  int nf[kMaxLevels];
  int np[kMaxLevels];
  int off[kMaxLevels];
  int nr;
  int nf_total;
};

inline LevelTable make_level_table(const unsigned long long* lam,
                                   const unsigned long long* eta,
                                   const int* nf, const int* np, int nr) {
  LevelTable t{};
  t.nr = nr;
  int off = 0;
  for (int r = 0; r < nr; ++r) {
    t.lam[r] = reinterpret_cast<const void*>(lam[r]);
    t.eta[r] = reinterpret_cast<const void*>(eta[r]);
    t.nf[r] = nf[r];
    t.np[r] = np[r];
    t.off[r] = off;
    off += nf[r];
  }
  t.nf_total = off;
  return t;
}

// Welford's running mean and sum of squared deviations, one value at a
// time; inv_count is 1 / (the values taken so far, this one included),
// computed once for every cell that shares the count.
__device__ __forceinline__ void welford(float y, float inv_count,
                                        float& mean, float& m2) {
  const float delta = y - mean;
  mean += delta * inv_count;
  m2 += delta * (y - mean);
}

namespace {  // internal linkage: each including source has its own copy

// The chunks' partial (mean, m2) over draws, (S, cells) each, with chunk s
// holding min(D, n - s D) draws, combined in chunk order by Chan et al.'s
// pairwise formula: the mean and the population sd (ddof 0, as jnp.std)
// per cell.  No atomics, so two runs are bit-identical.
__global__ void combine_moments_kernel(const float* __restrict__ pmean,
                                       const float* __restrict__ pm2,
                                       float* __restrict__ mean_out,
                                       float* __restrict__ sd_out,
                                       long long cells, int n, int D, int S) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= cells) return;
  float mean = pmean[i], m2 = pm2[i];
  float count = static_cast<float>(min(D, n));
  // eight chunks' loads in flight at a time, combined one by one
  constexpr int kBatch = 8;
  for (int s0 = 1; s0 < S; s0 += kBatch) {
    float mb[kBatch], qb[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const bool ok = s0 + q < S;
      mb[q] = ok ? pmean[(s0 + q) * cells + i] : 0.0f;
      qb[q] = ok ? pm2[(s0 + q) * cells + i] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int s = s0 + q;
      if (s >= S) break;
      const float nb = static_cast<float>(min(D, n - s * D));
      const float tot = count + nb;
      const float delta = mb[q] - mean;
      mean += delta * (nb / tot);
      m2 += qb[q] + delta * delta * (count * nb / tot);
      count = tot;
    }
  }
  mean_out[i] = mean;
  sd_out[i] = sqrtf(fmaxf(m2, 0.0f) / static_cast<float>(n));
}

inline cudaError_t launch_combine(const float* pmean, const float* pm2,
                                  float* mean, float* sd, long long cells,
                                  int n, int D, int S, cudaStream_t st) {
  if (cells == 0) return cudaSuccess;
  const int threads = 256;
  combine_moments_kernel<<<static_cast<unsigned>((cells + threads - 1) /
                                                 threads),
                           threads, 0, st>>>(pmean, pm2, mean, sd, cells, n,
                                             D, S);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hmsc
