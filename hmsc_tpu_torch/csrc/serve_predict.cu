// B9a: the fused marginal prediction of the serving engine and of offline
// predict(): linear predictor, link, back-scaling, and the moments over the
// posterior draws (or the draws themselves).
//
// Replaces hmsc_tpu/serve/kernels.py · make_predict_kernel with
// _apply_link_expected / _apply_link_sampled (:109-183), and the shared
// linear_predictor (:52-105) on offline predict's path, which the JAX
// package wrote as einsums over a materialised (n, B, ns) block.  For query
// rows b, species j and draws n:
//
//   L = X[b] . Beta[n, :, j] + sum_r Eta_r[n, uidx[r, b], :] . Lambda_r[n, :, j]
//   expected: ndtr(L) (probit), exp(L + sigma / 2) (Poisson), L (normal)
//   sampled:  Z = L + sqrt(sigma) eps;  Z > 0 (probit), a Poisson draw at
//             exp(min(Z, 30)) (Poisson), Z (normal)
//   y = out * ys[j] + ym[j]
//
// then either the mean and population sd of y over the draws (ddof 0, as
// jnp.std), or y itself for every draw (the (n, B, ns) block B9c and
// offline predict read), or both.
//
// What bounds it on the H100: at the headline (800 draws, nc 2, nf 8, 1000
// species) every query reads all the draws' Beta and Lambda, ~32 MB, and
// does 2 (nc + nf) B ns n multiply-adds: at B 64, ~1 GFLOP against 34 MB,
// so operations (0.015 ms) over bytes (0.010 ms).  Design: a block of 128
// threads over species, each thread holding RB query rows (template), so
// one coalesced load of Beta[n, c, j] or Lambda[n, f, j] feeds RB
// multiply-adds; the block's query rows of Eta are staged in shared memory
// eight draws at a time (one load each, broadcast to every thread); the
// draws are split into S chunks over the grid's z so that small queries
// still fill the card, each chunk keeping Welford moments per thread, and a
// second kernel combines the chunks in order (serve_common.cuh): no
// atomics, two runs are bit-identical.  Draws load as float32 or bfloat16
// (template) and widen in registers.  Sampled mode draws from Philox
// (philox.cuh) keyed by the cell (draw, row, species); the Poisson draw is
// Knuth's product of uniforms below a rate of 10 and Hormann's transformed
// rejection (PTRS, in double) above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "serve_common.cuh"

namespace {

constexpr int kThreads = 128;   // species per block
constexpr int kSub = 8;         // draws whose Eta rows are staged at once
constexpr int kMaxRows = 8;     // query rows per thread (RB <= this)
constexpr int kMaxNc = 64;
constexpr int kMaxNf = 64;      // factors over all levels

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ double uniform_double(unsigned bits) {
  return (static_cast<double>(bits) + 0.5) * 2.3283064365386963e-10;
}

// A Poisson draw at rate lam.  `first` supplies two uniforms (z, w); more
// come from Philox at the cell's counter with rounds 1, 2, ... in ctr.w.
__device__ float poisson_draw(float lam, uint4 ctr, uint2 key, uint4 first) {
  if (isnan(lam)) return nan_f();
  if (!(lam > 0.0f)) return 0.0f;
  unsigned pool[4] = {first.z, first.w, 0u, 0u};
  int avail = 2, taken = 0;
  unsigned round = 1;
  auto next = [&]() -> unsigned {
    if (taken == avail) {
      ctr.w = round++;
      const uint4 b = hmsc::philox4x32_10(ctr, key);
      pool[0] = b.x; pool[1] = b.y; pool[2] = b.z; pool[3] = b.w;
      avail = 4;
      taken = 0;
    }
    return pool[taken++];
  };
  if (lam < 10.0f) {
    // Knuth: the number of uniforms whose running product stays above
    // exp(-lam), less one
    const float floor_p = expf(-lam);
    float p = 1.0f;
    for (int k = 0; k < 1000; ++k) {
      p *= hmsc::uniform01(next());
      if (p <= floor_p) return static_cast<float>(k);
    }
    return nan_f();
  }
  // PTRS (Hormann 1993), as numpy's random_poisson_ptrs
  const double L = lam;
  const double slam = sqrt(L), loglam = log(L);
  const double b = 0.931 + 2.53 * slam;
  const double a = -0.059 + 0.02483 * b;
  const double invalpha = 1.1239 + 1.1328 / (b - 3.4);
  const double vr = 0.9277 - 3.6224 / (b - 2.0);
  for (int it = 0; it < 1000; ++it) {
    const double U = uniform_double(next()) - 0.5;
    const double V = uniform_double(next());
    const double us = 0.5 - fabs(U);
    const double k = floor((2.0 * a / us + b) * U + L + 0.43);
    if (us >= 0.07 && V <= vr) return static_cast<float>(k);
    if (k < 0.0 || (us < 0.013 && V > us)) continue;
    if (log(V) + log(invalpha) - log(a / (us * us) + b) <=
        -L + k * loglam - lgamma(k + 1.0))
      return static_cast<float>(k);
  }
  return nan_f();
}

template <typename T, int RB>
__global__ void __launch_bounds__(kThreads)
serve_predict_kernel(const float* __restrict__ X, const int* __restrict__ uidx,
                     const T* __restrict__ Beta, const T* __restrict__ sigma,
                     hmsc::LevelTable lv, const int* __restrict__ fam,
                     const float* __restrict__ ym,
                     const float* __restrict__ ys, float* __restrict__ draws,
                     float* __restrict__ pmean, float* __restrict__ pm2,
                     int n, int B, int ns, int nc, int D, int expected,
                     uint2 key, unsigned offset) {
  __shared__ float x_s[kMaxRows * kMaxNc];
  __shared__ int u_s[hmsc::kMaxLevels * kMaxRows];
  __shared__ float eta_s[kSub * kMaxRows * kMaxNf];
  const int tid = threadIdx.x;
  const int j = blockIdx.x * kThreads + tid;
  const int b0 = blockIdx.y * RB;
  const int rows = min(RB, B - b0);
  const int d0 = blockIdx.z * D;
  const int d1 = min(n, d0 + D);
  const int nft = lv.nf_total;
  for (int i = tid; i < RB * nc; i += kThreads) {
    const int b = i / nc;
    x_s[i] = b < rows ? X[(b0 + b) * nc + (i - b * nc)] : 0.0f;
  }
  for (int i = tid; i < lv.nr * RB; i += kThreads) {
    const int r = i / RB, b = i - r * RB;
    u_s[i] = b < rows ? uidx[r * B + b0 + b] : lv.np[r] - 1;
  }
  const bool valid = j < ns;
  const int fj = valid ? fam[j] : 0;
  const float ymj = valid ? ym[j] : 0.0f, ysj = valid ? ys[j] : 0.0f;
  float mean[RB], m2[RB];
#pragma unroll
  for (int b = 0; b < RB; ++b) mean[b] = m2[b] = 0.0f;
  int count = 0;
  __syncthreads();
  for (int s0 = d0; s0 < d1; s0 += kSub) {
    const int nsub = min(kSub, d1 - s0);
    for (int i = tid; i < nsub * RB * nft; i += kThreads) {
      const int d = i / (RB * nft);
      const int rem = i - d * RB * nft;
      const int b = rem / nft, f = rem - b * nft;
      int r = 0;
      while (r + 1 < lv.nr && f >= lv.off[r + 1]) ++r;
      const T* eta = static_cast<const T*>(lv.eta[r]);
      const long long row = static_cast<long long>(s0 + d) * lv.np[r] +
                            u_s[r * RB + b];
      eta_s[i] = hmsc::load_draw(eta + row * lv.nf[r] + (f - lv.off[r]));
    }
    __syncthreads();
    if (valid) {
      for (int d = 0; d < nsub; ++d) {
        const int nn = s0 + d;
        float L[RB];
#pragma unroll
        for (int b = 0; b < RB; ++b) L[b] = 0.0f;
        // unrolled by 4: four loads in flight, not one per latency
#pragma unroll 4
        for (int c = 0; c < nc; ++c) {
          const float beta = hmsc::load_draw(
              Beta + (static_cast<long long>(nn) * nc + c) * ns + j);
#pragma unroll
          for (int b = 0; b < RB; ++b) L[b] = fmaf(x_s[b * nc + c], beta, L[b]);
        }
        const float* e_d = eta_s + d * RB * nft;
        for (int r = 0; r < lv.nr; ++r) {
          const T* lam = static_cast<const T*>(lv.lam[r]);
          const int nf = lv.nf[r], off = lv.off[r];
#pragma unroll 4
          for (int f = 0; f < nf; ++f) {
            const float l = hmsc::load_draw(
                lam + (static_cast<long long>(nn) * nf + f) * ns + j);
#pragma unroll
            for (int b = 0; b < RB; ++b)
              L[b] = fmaf(e_d[b * nft + off + f], l, L[b]);
          }
        }
        const float sig =
            hmsc::load_draw(sigma + static_cast<long long>(nn) * ns + j);
        const float inv_count = 1.0f / static_cast<float>(++count);
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          if (b >= rows) break;
          float out = L[b];
          const long long cell =
              (static_cast<long long>(nn) * B + b0 + b) * ns + j;
          if (expected) {
            if (fj == 2) out = normcdff(L[b]);
            else if (fj == 3) out = expf(L[b] + sig / 2.0f);
          } else {
            const uint4 ctr = make_uint4(static_cast<unsigned>(cell),
                                         static_cast<unsigned>(cell >> 32),
                                         offset, 0u);
            const uint4 bits = hmsc::philox4x32_10(ctr, key);
            const float z = L[b] + sqrtf(sig) * hmsc::box_muller(bits.x, bits.y);
            if (fj == 2) out = z > 0.0f ? 1.0f : 0.0f;
            else if (fj == 3) out = poisson_draw(expf(fminf(z, 30.0f)), ctr,
                                                 key, bits);
            else out = z;
          }
          const float y = out * ysj + ymj;
          if (draws != nullptr) draws[cell] = y;
          hmsc::welford(y, inv_count, mean[b], m2[b]);
        }
      }
    }
    __syncthreads();
  }
  if (valid && pmean != nullptr) {
    for (int b = 0; b < rows; ++b) {
      const long long i =
          (static_cast<long long>(blockIdx.z) * B + b0 + b) * ns + j;
      pmean[i] = mean[b];
      pm2[i] = m2[b];
    }
  }
}

template <typename T, int RB>
cudaError_t launch(const float* X, const int* uidx, const void* Beta,
                   const void* sigma, const hmsc::LevelTable& lv,
                   const int* fam, const float* ym, const float* ys,
                   float* draws, float* pmean, float* pm2, int n, int B,
                   int ns, int nc, int D, int S, int expected, uint2 key,
                   unsigned offset, cudaStream_t st) {
  const dim3 grid((ns + kThreads - 1) / kThreads, (B + RB - 1) / RB, S);
  serve_predict_kernel<T, RB><<<grid, kThreads, 0, st>>>(
      X, uidx, static_cast<const T*>(Beta), static_cast<const T*>(sigma), lv,
      fam, ym, ys, draws, pmean, pm2, n, B, ns, nc, D, expected, key, offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(int rb, const float* X, const int* uidx,
                        const void* Beta, const void* sigma,
                        const hmsc::LevelTable& lv, const int* fam,
                        const float* ym, const float* ys, float* draws,
                        float* pmean, float* pm2, int n, int B, int ns,
                        int nc, int D, int S, int expected, uint2 key,
                        unsigned offset, cudaStream_t st) {
  switch (rb) {
    case 1: return launch<T, 1>(X, uidx, Beta, sigma, lv, fam, ym, ys, draws,
                                pmean, pm2, n, B, ns, nc, D, S, expected, key,
                                offset, st);
    case 2: return launch<T, 2>(X, uidx, Beta, sigma, lv, fam, ym, ys, draws,
                                pmean, pm2, n, B, ns, nc, D, S, expected, key,
                                offset, st);
    case 4: return launch<T, 4>(X, uidx, Beta, sigma, lv, fam, ym, ys, draws,
                                pmean, pm2, n, B, ns, nc, D, S, expected, key,
                                offset, st);
    case 8: return launch<T, 8>(X, uidx, Beta, sigma, lv, fam, ym, ys, draws,
                                pmean, pm2, n, B, ns, nc, D, S, expected, key,
                                offset, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Rows per thread rb (1, 2, 4 or 8), the draws split into S chunks of D;
// pmean / pm2 (S, B, ns) scratch and mean / sd (B, ns) for the moments, or
// all four null; draws (n, B, ns) or null.  bf16 != 0: the draws are
// bfloat16.  lam / eta: host arrays of nr device pointers.
extern "C" int hmsc_serve_predict(
    const float* X, const int* uidx, const void* Beta, const void* sigma,
    const unsigned long long* lam, const unsigned long long* eta,
    const int* nf, const int* np, int nr, const int* fam, const float* ym,
    const float* ys, float* draws, float* pmean, float* pm2, float* mean,
    float* sd, int n, int B, int ns, int nc, int rb, int D, int S, int bf16,
    int expected, unsigned long long seed, unsigned offset, void* stream) {
  if (nr > hmsc::kMaxLevels || nc > kMaxNc || rb > kMaxRows || D < 1 ||
      S < 1 || (S - 1) * D >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  const hmsc::LevelTable lv = hmsc::make_level_table(lam, eta, nf, np, nr);
  if (lv.nf_total > kMaxNf) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || ns == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2 key = hmsc::seed_key(seed);
  cudaError_t err =
      bf16 ? launch_rows<__nv_bfloat16>(rb, X, uidx, Beta, sigma, lv, fam, ym,
                                        ys, draws, pmean, pm2, n, B, ns, nc,
                                        D, S, expected, key, offset, st)
           : launch_rows<float>(rb, X, uidx, Beta, sigma, lv, fam, ym, ys,
                                draws, pmean, pm2, n, B, ns, nc, D, S,
                                expected, key, offset, st);
  if (err != cudaSuccess || mean == nullptr) return static_cast<int>(err);
  return static_cast<int>(hmsc::launch_combine(
      pmean, pm2, mean, sd, static_cast<long long>(B) * ns, n, D, S, st));
}
