// B7: the draw of the probit-DA intercept interweave, one two-sided
// truncated normal per (chain, species).
//
// Replaces hmsc_tpu/ops/rand.py · truncated_normal (:25-81) as called by
// hmsc_tpu/mcmc/updaters.py · interweave_da_intercept (:906-937), which the
// JAX package wrote as whole-array reductions and one elementwise draw.
// For each chain c and probit species j, with b0 = Beta[c, ii, j] and the
// residual R = Z - b0 held fixed:
//   1. the truncation interval lo = max_{Y=1, observed} (-R),
//      hi = min_{Y=0, observed} (-R) over the ny rows (-inf / +inf when a
//      column has no observed 1 / 0; missing cells impose no bound);
//   2. the prior conditional mean b0 - u_prior / v00 and std v00^(-1/2);
//   3. the JAX op's two-sided truncated normal step by step: the reflection
//      of left-tail intervals into the right one, the clip of b at +-1e30
//      in the orientation test, the survival probability clipped to
//      [1e-30, 1 - 2^-24] before the inverse CDF, the exponential tail
//      (Robert 1995) truncated to the interval past 9 sigma, and the clip of
//      the result to the interval;
//   4. a uniform on [1e-38, 1) from Philox (philox.cuh), or an injected one;
// then t is written for Beta[c, ii, j] and every row gets Z = R + t.  A
// non-probit column keeps b0 and its Z.  A NaN in the column's inputs gives
// a NaN draw, as the JAX op's arithmetic does.
//
// What bounds it on the H100: memory.  Z is read twice (the interval, the
// shift) and written once, Y (and the mask) read once: at the 1000 x 1000
// headline with 4 chains about 52 MB, 0.016 ms at 3.35 TB/s; the draws
// are 4000 and cost nothing beside it.  Design: a block takes 32 species of
// one chain and 16 row groups (512 threads); a warp reads 32 consecutive
// species of one row, so every load of Z, Y and the mask is coalesced
// across species (not down a column); the row groups' extrema meet in
// shared memory (max and min are exact, so the result does not depend on
// the order), one thread a species draws, and the whole block writes the
// shifted Z of its species.

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kSpecies = 32;
constexpr int kGroups = 16;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// NaN-propagating max / min (fmaxf / fminf would drop a NaN)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_f() : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_f() : fminf(a, b);
}

// The JAX op truncated_normal on [lo, hi] at (mean, sd) with uniform u.
__device__ float truncated_normal(float lo, float hi, float mean, float sd,
                                  float u) {
  const float a = (lo - mean) / sd;
  const float b = (hi - mean) / sd;
  bool right = (a + fminf(fmaxf(b, -1e30f), 1e30f)) > 0.0f;
  if (isinf(b)) right = a > 0.0f;
  if (isinf(a)) right = b > 0.0f;
  const float a2 = right ? a : -b;
  const float b2 = right ? b : -a;
  const float sa = normcdff(-a2), sb = normcdff(-b2);
  // the product and the sum rounded apart, as the JAX op and the plain
  // version compute them (a fused multiply-add rounds s to 1 more often)
  const float s = __fadd_rn(sb, __fmul_rn(u, sa - sb));
  const float x_r = -normcdfinvf(fminf(fmaxf(s, 1e-30f), 0.99999994f));
  const float span = fmaxf(b2 - a2, 0.0f);
  const float lam = fmaxf(a2, 1.0f);
  const float x_far = a2 - log1pf(-u * (1.0f - expf(-lam * span))) / lam;
  float x = (a2 > 9.0f) ? x_far : x_r;
  x = fminf(fmaxf(x, a2), b2);  // clipped-quantile edges
  x = right ? x : -x;
  return mean + sd * x;
}

__global__ void truncnorm_da_kernel(
    const float* __restrict__ Z, const float* __restrict__ Y,
    const float* __restrict__ mask, const int* __restrict__ fam,
    const float* __restrict__ Beta, const float* __restrict__ u_prior,
    const float* __restrict__ v00, const float* __restrict__ U,
    float* __restrict__ t_out, float* __restrict__ Z_out, int ny, int ns,
    int nc, int ii, uint2 key, unsigned offset) {
  __shared__ float lo_s[kGroups][kSpecies];
  __shared__ float hi_s[kGroups][kSpecies];
  __shared__ float t_s[kSpecies];
  const int lane = threadIdx.x % kSpecies, grp = threadIdx.x / kSpecies;
  const int j = blockIdx.x * kSpecies + lane;
  const int c = blockIdx.y;
  const bool valid = j < ns;
  const bool probit = valid && fam[j] == 2;
  const float b0 =
      valid ? Beta[(static_cast<long long>(c) * nc + ii) * ns + j] : 0.0f;
  const float* Zc = Z + static_cast<long long>(c) * ny * ns;
  float lo = -inf_f(), hi = inf_f();
  if (probit) {
    for (int i = grp; i < ny; i += kGroups) {
      const long long cell = static_cast<long long>(i) * ns + j;
      const float negR = -(Zc[cell] - b0);
      const bool obs = mask == nullptr || mask[cell] > 0.0f;
      const bool one = Y[cell] > 0.5f;
      if (obs && one) lo = nan_max(lo, negR);
      if (obs && !one) hi = nan_min(hi, negR);
    }
  }
  lo_s[grp][lane] = lo;
  hi_s[grp][lane] = hi;
  __syncthreads();
  if (grp == 0) {
    for (int q = 1; q < kGroups; ++q) {
      lo = nan_max(lo, lo_s[q][lane]);
      hi = nan_min(hi, hi_s[q][lane]);
    }
    float t = b0;
    if (probit) {
      const long long cj = static_cast<long long>(c) * ns + j;
      float u;
      if (U != nullptr) {
        u = U[cj];
      } else {
        const uint4 bits = hmsc::philox4x32_10(
            make_uint4(static_cast<unsigned>(cj),
                       static_cast<unsigned>(cj >> 32), offset, 0u),
            key);
        u = hmsc::uniform01(bits.x);
      }
      const float v = v00[c];
      const float mean = b0 - u_prior[cj] / v;
      const float sd = rsqrtf(v);
      t = truncated_normal(lo, hi, mean, sd, u);
      if (isnan(lo) || isnan(hi) || isnan(mean) || isnan(sd))
        t = nan_f();
    }
    t_s[lane] = t;
    if (valid) t_out[static_cast<long long>(c) * ns + j] = t;
  }
  __syncthreads();
  if (!valid) return;
  const float t = t_s[lane];
  float* Zo = Z_out + static_cast<long long>(c) * ny * ns;
  for (int i = grp; i < ny; i += kGroups) {
    const long long cell = static_cast<long long>(i) * ns + j;
    const float z = Zc[cell];
    Zo[cell] = probit ? (z - b0) + t : z;
  }
}

}  // namespace

extern "C" int hmsc_truncnorm_da(const float* Z, const float* Y,
                                 const float* mask, const int* fam,
                                 const float* Beta, const float* u_prior,
                                 const float* v00, const float* U,
                                 float* t_out, float* Z_out, int C, int ny,
                                 int ns, int nc, int ii,
                                 unsigned long long seed, unsigned offset,
                                 void* stream) {
  if (C == 0 || ns == 0) return 0;
  const dim3 grid((ns + kSpecies - 1) / kSpecies, C);
  truncnorm_da_kernel<<<grid, kSpecies * kGroups, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      Z, Y, mask, fam, Beta, u_prior, v00, U, t_out, Z_out, ny, ns, nc, ii,
      hmsc::seed_key(seed), offset);
  return static_cast<int>(cudaGetLastError());
}
