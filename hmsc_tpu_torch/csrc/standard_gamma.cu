// B3: Gamma(a, 1) draws, one per element.
//
// Replaces hmsc_tpu/ops/rand.py · standard_gamma.  The JAX op vectorises
// Marsaglia-Tsang (2000) rejection as 8 up-front candidate batches with the
// first accepted candidate selected per element, because the TPU has no
// cheap per-element loop.  A GPU thread has one, so this kernel runs the
// rejection loop itself: each round draws one normal (Box-Muller) and one
// uniform from the thread's Philox counter and stops at the first
// acceptance.  Shapes a < 1 use the boost Ga(a) = Ga(a+1) U^(1/a), as the
// JAX op does.  The loop is capped at 64 rounds (acceptance is >= 0.95 a
// round, so the cap is never met at a finite shape); an element that never
// accepts (a NaN or non-positive shape) gets the mode d, the JAX op's
// fallback, and a NaN shape stays NaN.
//
// What bounds it on the H100: launch latency.  The main path draws at most
// 4 x 8 x 1000 shapes a call (LambdaPriors' psi), 128 KB in and out; the
// delta draws are 4 elements.  One thread per element, no shared memory.

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kMaxRounds = 64;

__global__ void standard_gamma_kernel(const float* __restrict__ a,
                                      float* __restrict__ out, long long n,
                                      uint2 key, unsigned offset) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const float ai = a[i];
  const unsigned lo = static_cast<unsigned>(i);
  const unsigned hi = static_cast<unsigned>(i >> 32);
  const bool boost = ai < 1.0f;
  // fmaxf would turn a NaN shape into 1: keep NaN, as jnp.maximum does
  const float a_eff = boost ? ai + 1.0f : (ai >= 1.0f || ai != ai ? ai : 1.0f);
  const float d = a_eff - 1.0f / 3.0f;
  const float c = 1.0f / sqrtf(9.0f * d);
  float draw = d;  // the mode: the JAX op's value when no candidate accepts
  for (int r = 0; r < kMaxRounds; ++r) {
    const uint4 b = hmsc::philox4x32_10(
        make_uint4(lo, hi, offset, static_cast<unsigned>(r)), key);
    const float x = hmsc::box_muller(b.x, b.y);
    float v = 1.0f + c * x;
    v = v * v * v;
    const float u = hmsc::uniform01(b.z);
    if (v > 0.0f &&
        logf(u) < 0.5f * x * x + d * (1.0f - v + logf(v))) {
      draw = d * v;
      break;
    }
  }
  if (boost) {
    const uint4 b = hmsc::philox4x32_10(make_uint4(lo, hi, offset, 0xFFFFFFFFu),
                                        key);
    draw = draw * powf(hmsc::uniform01(b.x), 1.0f / ai);
  }
  out[i] = draw;
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
