// The first version of kernel B5, kept as a yardstick: chip_smoke.py and
// scripts/select_z_sweep.py build it on the card (with -I
// hmsc_tpu_torch/csrc for philox.cuh) and time it beside the shipped B5
// (hmsc_tpu_torch/csrc/poisson_z.cu).  It is not part of the package and no
// path runs it.
//
// B5: the (lognormal-)Poisson latent-response update, one cell per thread.
//
// Replaces hmsc_tpu/ops/rand.py · _pg_moments / polya_gamma and the Poisson
// branch of hmsc_tpu/mcmc/updaters.py · update_z, which the JAX package
// wrote as whole-array ops shaped for the TPU's vector units.  Poisson is
// the r -> inf limit of a negative binomial with r = 1000 (reference
// updateZ.R:68): per cell of a Poisson column
//
//   w  ~ PG(Y + r, Zprev - log r)      moment-matched normal, floored at 1e-38
//   s2 = 1 / (iSigma + w)
//   mu = s2 ((Y - r) / 2 + iSigma (E - log r)) + log r
//   Z  = mu + sqrt(s2) eps2,           Zprev where Z is not finite.
//
// The PG mean is the JAX op's, including its series branch for |z| / 2 <
// 1e-3; the variance is its Taylor series below |z| / 2 = 0.5, where the
// JAX op's closed form cancels (ops/rand.py · _pg_moments says why).
// Cells of other columns get Zprev back unchanged.
//
// What bounds it on the H100: memory.  Per cell it reads Zprev and E and
// writes Z (Y once per site x species), against a Philox call, two
// Box-Muller normals, one tanhf and a few divisions: at 4 chains x 1000 x
// 1000 about 52 MB, 16 us at 3.35 TB/s.  Design: a grid of (species block,
// row, chain), one thread per cell, so a warp's loads and stores are 32
// consecutive species and the chain, row and species indices come from the
// grid with no integer division; rows past the grid's y extent are walked
// by a stride loop.  eps1 and eps2 come from one Philox call keyed by the
// cell's flat index, or from two injected tensors, so the kernel can be
// compared with its plain version on identical inputs.

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr float kNbR = 1000.0f;
constexpr float kLogNbR = 6.9077552789821368f;   // log(1000)

__global__ void poisson_z_kernel(const float* __restrict__ Y,
                                 const float* __restrict__ Zprev,
                                 const float* __restrict__ E,
                                 const float* __restrict__ iSigma,
                                 const int* __restrict__ fam,
                                 const float* __restrict__ eps_pg,
                                 const float* __restrict__ eps_z,
                                 float* __restrict__ Z, int ny, int ns,
                                 uint2 key, unsigned offset) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ns) return;
  const int c = blockIdx.z;
  const bool poisson = fam[j] == 3;
  const float prec = iSigma[static_cast<long long>(c) * ns + j];
  const long long chain0 = static_cast<long long>(c) * ny * ns;
  for (int i = blockIdx.y; i < ny; i += gridDim.y) {
    const long long cell = static_cast<long long>(i) * ns + j;
    const long long idx = chain0 + cell;
    const float zprev = Zprev[idx];
    if (!poisson) {
      Z[idx] = zprev;
      continue;
    }
    float e1, e2;
    if (eps_pg != nullptr) {
      e1 = eps_pg[idx];
      e2 = eps_z[idx];
    } else {
      const uint4 b = hmsc::philox4x32_10(
          make_uint4(static_cast<unsigned>(idx),
                     static_cast<unsigned>(idx >> 32), offset, 0u),
          key);
      e1 = hmsc::box_muller(b.x, b.y);
      e2 = hmsc::box_muller(b.z, b.w);
    }
    const float y = Y[cell];
    const float e = E[idx];
    // PG(h, z) moments from its cumulant generating function
    const float h = y + kNbR;
    const float u = 0.5f * fabsf(zprev - kLogNbR);
    const bool small = u < 1e-3f;
    const float us = small ? 1.0f : u;       // safe denominator
    const float t = tanhf(us);
    const float sech2 = 1.0f - t * t;
    const float mean = small ? h / 4.0f * (1.0f - u * u / 3.0f)
                             : h * t / (4.0f * us);
    float var;
    if (u < 0.5f) {                         // Taylor series in u^2
      const float x = u * u;
      float p = 929569.0f / 729729000.0f;
      p = p * x - 5461.0f / 2027025.0f;
      p = p * x + 691.0f / 124740.0f;
      p = p * x - 31.0f / 2835.0f;
      p = p * x + 17.0f / 840.0f;
      p = p * x - 1.0f / 30.0f;
      p = p * x + 1.0f / 24.0f;
      var = h * p;
    } else {
      var = h * (t - us * sech2) / (16.0f * (us * us * us));
    }
    const float w = fmaxf(mean + sqrtf(var) * e1, 1e-38f);
    const float s2 = 1.0f / (prec + w);
    const float mu = s2 * ((y - kNbR) / 2.0f + prec * (e - kLogNbR)) + kLogNbR;
    const float z = mu + sqrtf(s2) * e2;
    Z[idx] = isfinite(z) ? z : zprev;       // the reference's NaN guard
  }
}

}  // namespace

extern "C" int hmsc_poisson_z(const float* Y, const float* Zprev,
                              const float* E, const float* iSigma,
                              const int* fam, const float* eps_pg,
                              const float* eps_z, float* Z, int C, int ny,
                              int ns, unsigned long long seed,
                              unsigned offset, void* stream) {
  const int threads = 128;
  const dim3 grid(static_cast<unsigned>((ns + threads - 1) / threads),
                  static_cast<unsigned>(ny < 65535 ? ny : 65535),
                  static_cast<unsigned>(C));
  poisson_z_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      Y, Zprev, E, iSigma, fam, eps_pg, eps_z, Z, ny, ns,
      hmsc::seed_key(seed), offset);
  return static_cast<int>(cudaGetLastError());
}
