// B9b: conditional prediction, the per-draw Gibbs refinement of each query
// row's latent factors against its observed cells.
//
// Replaces hmsc_tpu/serve/kernels.py · _cond_one_draw /
// make_conditional_kernel (:255-368), which the JAX package wrote as a
// lax.scan vmapped over draws.  For each draw n and query row b (its own
// unit in every level, factors starting from its gathered posterior rows,
// zeros for a new unit):
//
//   LFix = X[b] . Beta[n];  isig = 1 / sigma[n]
//   per level r: U = sum_j lam_f lam_g isig_j mask_j,  P = U + I = L L'
//   z0 = z_given_yc(LFix + sum_r rows_r . Lambda_r)
//   mcmc_step times: for each level r in turn,
//       S = z - LFix - sum_{q != r} rows_q . Lambda_q
//       F = (S isig mask) Lambda_r',  rows_r = cho_solve(L, F) + L'^-1 eps
//     then z = z_given_yc(LFix + sum_r rows_r . Lambda_r)
//   E = LFix + sum_r rows_r . Lambda_r;  link (ndtr on probit columns when
//   expected; Z = E + sqrt(sigma) eps, Z > 0 on probit columns when
//   sampled);  y = out * ys + ym
//
// with z_given_yc(E) = E + std eps (std = isig^-1/2), Yc on observed normal
// cells and B1's one-sided truncated normal (truncnorm.cuh, the same device
// code) on observed probit cells; then the mean and population sd of y
// over the draws.  No jitter on P, as in the JAX kernel.  Unobserved cells
// carry weight 0 in U and F, and F is the only reader of z, so the kernel
// skips them in those passes and draws no z for them (the JAX kernel
// draws E + std eps there, multiplied by 0).
//
// What bounds it on the H100: operations and barriers.  Per (draw, row) it
// makes (1 + nr (1 + mcmc_step) + mcmc_step + 1) passes over the species,
// each reading a draw's Lambda (L2-resident: every row reads the same
// draws), with nf (nf + 1) / 2 + nf mcmc_step block reductions.  Design:
// one block of 256 threads per (query row, chunk of draws), threads over
// species; a thread owns species tid, tid + 256, ... in every pass, so its
// z, LFix, isig and running moments stay in shared memory without
// barriers; the grams and F reduce over warps by shuffles and over the
// block in warp order (fixed, so two runs are bit-identical); warp 0 runs
// the nf <= 16 Cholesky and the triangular solves, a row a lane, with
// shuffles; a second kernel
// combines the chunks' moments in order (serve_common.cuh).  Random numbers
// come from Philox keyed by (species or factor, draw x row, refresh), or
// from injected tensors, so the kernel can be compared with its plain
// version on identical inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "serve_common.cuh"
#include "truncnorm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNc = 64;
constexpr unsigned kTagRows = 0x10000u;
constexpr unsigned kTagOut = 0x20000u;

struct Noise {           // injected draws, or all null for Philox
  const float* eps_z;    // (n, steps + 1, B, ns)
  const float* u_z;      // (n, steps + 1, B, ns)
  const float* eps_rows; // (n, steps, B, nf_total)
  const float* eps_out;  // (n, B, ns), sampled mode
};

// Sum each thread's vals[0..K) over the block: shuffles within a warp,
// then warps in order; the totals land in dest[0..K).
template <int KMAX>
__device__ __forceinline__ void block_sum(float (&vals)[KMAX], int K,
                                          float* red, float* dest) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    float v = vals[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp * KMAX + k] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += red[w * KMAX + threadIdx.x];
    dest[threadIdx.x] = t;
  }
  __syncthreads();
}

// Warp 0: the Cholesky factor L of P = U + I (U's lower triangle packed
// row by row in `packed`) into Lc (NFM x NFM, row-major), right-looking,
// lane i holding row i; no jitter, NaN on an indefinite P.
template <int NFM>
__device__ __forceinline__ void warp_cholesky(const float* packed, int nf,
                                              float* Lc) {
  const int lane = threadIdx.x & 31;
  float a[NFM];
#pragma unroll
  for (int g = 0; g < NFM; ++g)
    a[g] = (lane < nf && g <= lane)
               ? packed[lane * (lane + 1) / 2 + g] + (g == lane ? 1.0f : 0.0f)
               : 0.0f;
#pragma unroll
  for (int k = 0; k < NFM; ++k) {
    if (k >= nf) break;
    const float lkk = sqrtf(__shfl_sync(0xffffffffu, a[k], k));
    if (lane == k) a[k] = lkk;
    else if (lane > k) a[k] = a[k] / lkk;
#pragma unroll
    for (int g = k + 1; g < NFM; ++g) {      // the trailing rows' update
      const float lgk = __shfl_sync(0xffffffffu, a[k], g);
      if (g < nf && lane >= g) a[g] -= a[k] * lgk;
    }
  }
  if (lane < nf) {
#pragma unroll
    for (int g = 0; g < NFM; ++g) Lc[lane * NFM + g] = g <= lane ? a[g] : 0.0f;
  }
}

// Warp 0: lane f < nf returns row f of cho_solve(L, F) + L'^-1 eps, from
// its F_f and eps_f: the forward, then both backward substitutions, one
// unknown a step, finished by its lane and broadcast.
template <int NFM>
__device__ __forceinline__ float warp_solve(const float* Lc, int nf, float F,
                                            float eps) {
  const int lane = threadIdx.x & 31;
  float y = F;
#pragma unroll
  for (int k = 0; k < NFM; ++k) {            // L y = F
    if (k >= nf) break;
    if (lane == k) y = y / Lc[k * NFM + k];
    const float yk = __shfl_sync(0xffffffffu, y, k);
    if (lane > k && lane < nf) y -= Lc[lane * NFM + k] * yk;
  }
  float v = eps;
#pragma unroll
  for (int k = NFM - 1; k >= 0; --k) {       // L' x = y, L' v = eps
    if (k >= nf) continue;
    if (lane == k) {
      y = y / Lc[k * NFM + k];
      v = v / Lc[k * NFM + k];
    }
    const float xk = __shfl_sync(0xffffffffu, y, k);
    const float vk = __shfl_sync(0xffffffffu, v, k);
    if (lane < k) {
      const float l = Lc[k * NFM + lane];
      y -= l * xk;
      v -= l * vk;
    }
  }
  return y + v;
}

template <typename T, int NFM>
__global__ void __launch_bounds__(kThreads)
serve_conditional_kernel(const float* __restrict__ X,
                         const int* __restrict__ uidx,
                         const float* __restrict__ Yc,
                         const float* __restrict__ mask,
                         const T* __restrict__ Beta,
                         const T* __restrict__ sigma, hmsc::LevelTable lv,
                         const int* __restrict__ fam,
                         const float* __restrict__ ym,
                         const float* __restrict__ ys, Noise noise,
                         float* __restrict__ pmean, float* __restrict__ pm2,
                         int n, int B, int ns, int nc, int steps, int D,
                         int expected, uint2 key, unsigned offset) {
  constexpr int KG = NFM * (NFM + 1) / 2;
  extern __shared__ float dyn[];
  float* z_s = dyn;
  float* lfix_s = dyn + ns;
  float* isig_s = dyn + 2 * ns;
  float* mean_s = dyn + 3 * ns;
  float* m2_s = dyn + 4 * ns;
  __shared__ float x_s[kMaxNc];
  __shared__ float rows_s[hmsc::kMaxLevels * NFM];
  __shared__ float chol_s[hmsc::kMaxLevels * NFM * NFM];
  __shared__ float red_s[kWarps * KG];
  __shared__ float vec_s[KG];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int d0 = blockIdx.y * D;
  const int d1 = min(n, d0 + D);
  const int nft = lv.nf_total;
  const float* yc_b = Yc + static_cast<long long>(b) * ns;
  const float* mk_b = mask + static_cast<long long>(b) * ns;
  for (int c = tid; c < nc; c += kThreads) x_s[c] = X[b * nc + c];
  for (int j = tid; j < ns; j += kThreads) mean_s[j] = m2_s[j] = 0.0f;
  __syncthreads();

  int count = 0;
  for (int nn = d0; nn < d1; ++nn) {
    const unsigned row_id = static_cast<unsigned>(nn) * B + b;
    // the linear predictor's loading part at the current rows, species j
    auto loading = [&](int j, int skip) -> float {
      float acc = 0.0f;
      for (int r = 0; r < lv.nr; ++r) {
        if (r == skip) continue;
        const T* lam = static_cast<const T*>(lv.lam[r]);
        const int nf = lv.nf[r];
        float part = 0.0f;
        // unrolled to NFM: the loads issue together, not one per latency
#pragma unroll
        for (int f = 0; f < NFM; ++f)
          if (f < nf)
            part = fmaf(rows_s[r * NFM + f],
                        hmsc::load_draw(lam + (static_cast<long long>(nn) *
                                                   nf + f) * ns + j),
                        part);
        acc += part;
      }
      return acc;
    };
    // z | Yc at E = LFix + the loadings: refresh t (0 the initial draw,
    // 1.. after each step); an observed normal cell is Yc, a probit one
    // B1's truncated normal, an unobserved one not drawn (0).
    auto z_draw = [&](int j, int t) -> float {
      if (!(mk_b[j] > 0.0f)) return 0.0f;
      const int fj = fam[j];
      if (fj == 1) return yc_b[j];
      const float E = lfix_s[j] + loading(j, -1);
      const float sd = 1.0f / sqrtf(isig_s[j]);
      const long long i =
          ((static_cast<long long>(nn) * (steps + 1) + t) * B + b) * ns + j;
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (noise.eps_z == nullptr)
        bits = hmsc::philox4x32_10(
            make_uint4(static_cast<unsigned>(j), row_id, offset,
                       static_cast<unsigned>(t)), key);
      if (fj == 2) {
        const float u = noise.u_z != nullptr ? noise.u_z[i]
                                             : hmsc::uniform01(bits.z);
        return hmsc::probit_z_draw(E, sd, yc_b[j] > 0.5f, u);
      }
      const float eps = noise.eps_z != nullptr
                            ? noise.eps_z[i]
                            : hmsc::box_muller(bits.x, bits.y);
      return E + sd * eps;
    };

    for (int j = tid; j < ns; j += kThreads) {
      float lf = 0.0f;
#pragma unroll 4
      for (int c = 0; c < nc; ++c)
        lf = fmaf(x_s[c],
                  hmsc::load_draw(Beta + (static_cast<long long>(nn) * nc +
                                          c) * ns + j),
                  lf);
      lfix_s[j] = lf;
      isig_s[j] = 1.0f / hmsc::load_draw(sigma +
                                         static_cast<long long>(nn) * ns + j);
    }
    for (int i = tid; i < nft; i += kThreads) {
      int r = 0;
      while (r + 1 < lv.nr && i >= lv.off[r + 1]) ++r;
      const int f = i - lv.off[r];
      const T* eta = static_cast<const T*>(lv.eta[r]);
      const long long row =
          static_cast<long long>(nn) * lv.np[r] + uidx[r * B + b];
      rows_s[r * NFM + f] = hmsc::load_draw(eta + row * lv.nf[r] + f);
    }
    __syncthreads();

    // step-invariant: each level's P = U + I and its Cholesky factor
    for (int r = 0; r < lv.nr; ++r) {
      const int nf = lv.nf[r];
      const T* lam = static_cast<const T*>(lv.lam[r]);
      float acc[KG];
#pragma unroll
      for (int k = 0; k < KG; ++k) acc[k] = 0.0f;
      for (int j = tid; j < ns; j += kThreads) {
        if (!(mk_b[j] > 0.0f)) continue;        // weight 0
        const float w = isig_s[j] * mk_b[j];
        float l[NFM];
#pragma unroll
        for (int f = 0; f < NFM; ++f)
          l[f] = f < nf ? hmsc::load_draw(lam + (static_cast<long long>(nn) *
                                                     nf + f) * ns + j)
                        : 0.0f;
        int k = 0;
#pragma unroll
        for (int f = 0; f < NFM; ++f)
#pragma unroll
          for (int g = 0; g <= f; ++g) acc[k++] += l[f] * l[g] * w;
      }
      block_sum<KG>(acc, KG, red_s, vec_s);
      if (tid < 32) warp_cholesky<NFM>(vec_s, nf, chol_s + r * NFM * NFM);
      __syncthreads();
    }

    for (int j = tid; j < ns; j += kThreads)
      z_s[j] = z_draw(j, 0);

    for (int s = 0; s < steps; ++s) {
      for (int r = 0; r < lv.nr; ++r) {
        const int nf = lv.nf[r];
        const T* lam = static_cast<const T*>(lv.lam[r]);
        float acc[NFM];
#pragma unroll
        for (int f = 0; f < NFM; ++f) acc[f] = 0.0f;
        for (int j = tid; j < ns; j += kThreads) {
          if (!(mk_b[j] > 0.0f)) continue;      // weight 0
          const float S = z_s[j] - lfix_s[j] - loading(j, r);
          const float w = S * isig_s[j] * mk_b[j];
#pragma unroll
          for (int f = 0; f < NFM; ++f)
            if (f < nf)
              acc[f] = fmaf(w, hmsc::load_draw(lam + (static_cast<long long>(
                                                   nn) * nf + f) * ns + j),
                            acc[f]);
        }
        block_sum<NFM>(acc, nf, red_s, vec_s);
        if (tid < 32) {
          const int g = lv.off[r] + tid;
          float eps = 0.0f;
          if (tid < nf) {
            if (noise.eps_rows != nullptr) {
              eps = noise.eps_rows[((static_cast<long long>(nn) * steps + s)
                                    * B + b) * nft + g];
            } else {
              const uint4 bits = hmsc::philox4x32_10(
                  make_uint4(static_cast<unsigned>(g), row_id, offset,
                             kTagRows + static_cast<unsigned>(s)), key);
              eps = hmsc::box_muller(bits.x, bits.y);
            }
          }
          const float row = warp_solve<NFM>(chol_s + r * NFM * NFM, nf,
                                            tid < nf ? vec_s[tid] : 0.0f,
                                            eps);
          if (tid < nf) rows_s[r * NFM + tid] = row;
        }
        __syncthreads();
      }
      for (int j = tid; j < ns; j += kThreads)
        z_s[j] = z_draw(j, s + 1);
    }

    const float inv_count = 1.0f / static_cast<float>(++count);
    for (int j = tid; j < ns; j += kThreads) {
      const float E = lfix_s[j] + loading(j, -1);
      const int fj = fam[j];
      float out = E;
      if (expected) {
        if (fj == 2) out = normcdff(E);
      } else {
        float eps;
        if (noise.eps_out != nullptr) {
          eps = noise.eps_out[(static_cast<long long>(nn) * B + b) * ns + j];
        } else {
          const uint4 bits = hmsc::philox4x32_10(
              make_uint4(static_cast<unsigned>(j), row_id, offset, kTagOut),
              key);
          eps = hmsc::box_muller(bits.x, bits.y);
        }
        const float sig =
            hmsc::load_draw(sigma + static_cast<long long>(nn) * ns + j);
        const float zz = E + sqrtf(sig) * eps;
        out = (fj == 2) ? (zz > 0.0f ? 1.0f : 0.0f) : zz;
      }
      hmsc::welford(out * ys[j] + ym[j], inv_count, mean_s[j], m2_s[j]);
    }
    __syncthreads();
  }
  for (int j = tid; j < ns; j += kThreads) {
    const long long i = (static_cast<long long>(blockIdx.y) * B + b) * ns + j;
    pmean[i] = mean_s[j];
    pm2[i] = m2_s[j];
  }
}

template <typename T, int NFM>
cudaError_t launch(const float* X, const int* uidx, const float* Yc,
                   const float* mask, const void* Beta, const void* sigma,
                   const hmsc::LevelTable& lv, const int* fam,
                   const float* ym, const float* ys, const Noise& noise,
                   float* pmean, float* pm2, int n, int B, int ns, int nc,
                   int steps, int D, int S, int expected, uint2 key,
                   unsigned offset, cudaStream_t st) {
  const int smem = 5 * ns * static_cast<int>(sizeof(float));
  auto kernel = serve_conditional_kernel<T, NFM>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(B, S), kThreads, smem, st>>>(
      X, uidx, Yc, mask, static_cast<const T*>(Beta),
      static_cast<const T*>(sigma), lv, fam, ym, ys, noise, pmean, pm2, n, B,
      ns, nc, steps, D, expected, key, offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_nf(int nfm, const float* X, const int* uidx,
                      const float* Yc, const float* mask, const void* Beta,
                      const void* sigma, const hmsc::LevelTable& lv,
                      const int* fam, const float* ym, const float* ys,
                      const Noise& noise, float* pmean, float* pm2, int n,
                      int B, int ns, int nc, int steps, int D, int S,
                      int expected, uint2 key, unsigned offset,
                      cudaStream_t st) {
  switch (nfm) {
    case 4: return launch<T, 4>(X, uidx, Yc, mask, Beta, sigma, lv, fam, ym,
                                ys, noise, pmean, pm2, n, B, ns, nc, steps, D,
                                S, expected, key, offset, st);
    case 8: return launch<T, 8>(X, uidx, Yc, mask, Beta, sigma, lv, fam, ym,
                                ys, noise, pmean, pm2, n, B, ns, nc, steps, D,
                                S, expected, key, offset, st);
    case 16: return launch<T, 16>(X, uidx, Yc, mask, Beta, sigma, lv, fam, ym,
                                  ys, noise, pmean, pm2, n, B, ns, nc, steps,
                                  D, S, expected, key, offset, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// nfm: 4, 8 or 16, at least every level's nf; the draws split into S
// chunks of D (grid (B, S)); pmean / pm2 (S, B, ns) scratch; mean / sd
// (B, ns).  The four noise tensors are all given (eps_out may be null in
// expected mode) or all null.  lam / eta: host arrays of nr device
// pointers.
extern "C" int hmsc_serve_conditional(
    const float* X, const int* uidx, const float* Yc, const float* mask,
    const void* Beta, const void* sigma, const unsigned long long* lam,
    const unsigned long long* eta, const int* nf, const int* np, int nr,
    const int* fam, const float* ym, const float* ys, const float* eps_z,
    const float* u_z, const float* eps_rows, const float* eps_out,
    float* pmean, float* pm2, float* mean, float* sd, int n, int B, int ns,
    int nc, int steps, int nfm, int D, int S, int bf16, int expected,
    unsigned long long seed, unsigned offset, void* stream) {
  if (nr > hmsc::kMaxLevels || nc > kMaxNc || D < 1 || S < 1 ||
      (S - 1) * D >= n || steps < 0 ||
      5LL * ns * static_cast<long long>(sizeof(float)) > 200 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int r = 0; r < nr; ++r)
    if (nf[r] > nfm) return static_cast<int>(cudaErrorInvalidValue);
  const hmsc::LevelTable lv = hmsc::make_level_table(lam, eta, nf, np, nr);
  if (B == 0 || ns == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2 key = hmsc::seed_key(seed);
  const Noise noise{eps_z, u_z, eps_rows, eps_out};
  cudaError_t err =
      bf16 ? launch_nf<__nv_bfloat16>(nfm, X, uidx, Yc, mask, Beta, sigma, lv,
                                      fam, ym, ys, noise, pmean, pm2, n, B,
                                      ns, nc, steps, D, S, expected, key,
                                      offset, st)
           : launch_nf<float>(nfm, X, uidx, Yc, mask, Beta, sigma, lv, fam,
                              ym, ys, noise, pmean, pm2, n, B, ns, nc, steps,
                              D, S, expected, key, offset, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hmsc::launch_combine(
      pmean, pm2, mean, sd, static_cast<long long>(B) * ns, n, D, S, st));
}
