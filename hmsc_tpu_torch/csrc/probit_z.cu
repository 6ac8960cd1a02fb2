// B1: the probit latent-response update, one truncated normal per cell.
//
// Replaces hmsc_tpu/ops/rand.py · truncated_normal_onesided (called from
// hmsc_tpu/mcmc/updaters.py · update_z, probit branch), which the JAX
// package wrote as whole-array ops shaped for the TPU's vector units.
//
// What bounds it on the H100: memory.  Per cell it reads the linear
// predictor E and Y and writes Z, 12 bytes, against one normcdff, one
// normcdfinvf and one log1pf; at 4 chains x 1000 x 1000 that is 48 MB a
// sweep, about 14 us at 3.35 TB/s.  Design: one thread per four cells, so
// one Philox call feeds four uniforms; thread g takes cells g, g + G,
// g + 2G and g + 3G (G = ceil(n/4) threads in all), so each of its four
// loads and stores is to consecutive floats across a warp.  The arithmetic
// is the JAX op's formula step by step, including its f32 guards
// (truncnorm.cuh, which B9b shares).  An optional
// tensor of uniforms replaces the in-kernel draw, so the kernel can be
// compared with its plain version on identical inputs.

#include <cuda_runtime.h>

#include "philox.cuh"
#include "truncnorm.cuh"

namespace {

__global__ void probit_z_kernel(const float* __restrict__ E,
                                const float* __restrict__ sd,
                                const float* __restrict__ Y,
                                const float* __restrict__ U,
                                float* __restrict__ Z, long long n,
                                long long cells, int ns, uint2 key,
                                unsigned offset) {
  const long long g = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long groups = (n + 3) / 4;
  if (g >= groups) return;
  float u4[4];
  if (U == nullptr) {
    const uint4 b = hmsc::philox4x32_10(
        make_uint4(static_cast<unsigned>(g), static_cast<unsigned>(g >> 32),
                   offset, 0u),
        key);
    u4[0] = hmsc::uniform01(b.x);
    u4[1] = hmsc::uniform01(b.y);
    u4[2] = hmsc::uniform01(b.z);
    u4[3] = hmsc::uniform01(b.w);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = g + k * groups;
    if (i >= n) break;
    const long long c = i / cells;
    const long long cell = i - c * cells;
    const float u = (U == nullptr) ? u4[k] : U[i];
    const float e = E[i];
    const float s = sd[c * ns + cell % ns];
    Z[i] = hmsc::probit_z_draw(e, s, Y[cell] > 0.5f, u);
  }
}

}  // namespace

extern "C" int hmsc_probit_z(const float* E, const float* sd, const float* Y,
                             const float* U, float* Z, long long n,
                             long long cells, int ns,
                             unsigned long long seed, unsigned offset,
                             void* stream) {
  const int threads = 256;
  const long long groups = (n + 3) / 4;
  const unsigned blocks =
      static_cast<unsigned>((groups + threads - 1) / threads);
  probit_z_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      E, sd, Y, U, Z, n, cells, ns, hmsc::seed_key(seed), offset);
  return static_cast<int>(cudaGetLastError());
}
