// B3, element form: Gamma(a, 1) draws, one per element.
//
// Replaces hmsc_tpu/ops/rand.py · standard_gamma; the draw itself
// (Marsaglia-Tsang rejection run to the first acceptance, the a < 1 boost)
// is csrc/gamma.cuh, which the shrinkage form (csrc/shrinkage_gamma.cu)
// shares.  The sampler's multiplicative-gamma shrinkage block, whose draws
// were most of this kernel's launches, is the shrinkage form's since it was
// added; the element form serves GammaV's Wishart diagonal, the residual
// precisions and the Nf move.
//
// What bounds it on the H100: launch latency.  Its largest call on the main
// paths is the Wishart's nc draws or the residual precisions' ns; at 32000
// shapes (the shrinkage block's psi) it takes ~2 us.  One thread per
// element, no shared memory.

#include <cuda_runtime.h>

#include "gamma.cuh"

namespace {

__global__ void standard_gamma_kernel(const float* __restrict__ a,
                                      float* __restrict__ out, long long n,
                                      uint2 key, unsigned offset) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  out[i] = hmsc::standard_gamma_draw(a[i], i, key, offset);
}

}  // namespace

extern "C" int hmsc_standard_gamma(const float* a, float* out, long long n,
                                   unsigned long long seed, unsigned offset,
                                   void* stream) {
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  standard_gamma_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      a, out, n, hmsc::seed_key(seed), offset);
  return static_cast<int>(cudaGetLastError());
}
