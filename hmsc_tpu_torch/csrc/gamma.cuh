// The Gamma(a, 1) draw of the port's kernels, shared by B3's element form
// (csrc/standard_gamma.cu) and its shrinkage form
// (csrc/shrinkage_gamma.cu), so both draw the same law from one piece of
// code and the same Philox counter gives the same bits in either.
//
// It replaces hmsc_tpu/ops/rand.py · standard_gamma.  The JAX op vectorises
// Marsaglia-Tsang (2000) rejection as 8 up-front candidate batches with the
// first accepted candidate selected per element, because the TPU has no
// cheap per-element loop.  A GPU thread has one, so the draw runs the
// rejection loop itself: each round draws one normal (Box-Muller) and one
// uniform from the element's Philox counter (element index, launch offset,
// round) and stops at the first acceptance.  Shapes a < 1 use the boost
// Ga(a) = Ga(a+1) U^(1/a), as the JAX op does, from the counter's round
// 0xFFFFFFFF.  The loop is capped at 64 rounds (acceptance is >= 0.95 a
// round, so the cap is never met at a finite shape); an element that never
// accepts (a NaN or non-positive shape) gets the mode d, the JAX op's
// fallback, and a NaN shape stays NaN.
#pragma once

#include "philox.cuh"

namespace hmsc {

constexpr int kGammaMaxRounds = 64;

// Gamma(a, 1) for element `i` of a launch keyed by (key, offset).
__device__ __forceinline__ float standard_gamma_draw(float a, long long i,
                                                     uint2 key,
                                                     unsigned offset) {
  const unsigned lo = static_cast<unsigned>(i);
  const unsigned hi = static_cast<unsigned>(i >> 32);
  const bool boost = a < 1.0f;
  // fmaxf would turn a NaN shape into 1: keep NaN, as jnp.maximum does
  const float a_eff = boost ? a + 1.0f : (a >= 1.0f || a != a ? a : 1.0f);
  const float d = a_eff - 1.0f / 3.0f;
  const float c = 1.0f / sqrtf(9.0f * d);
  float draw = d;  // the mode: the JAX op's value when no candidate accepts
  for (int r = 0; r < kGammaMaxRounds; ++r) {
    const uint4 b =
        philox4x32_10(make_uint4(lo, hi, offset, static_cast<unsigned>(r)),
                      key);
    const float x = box_muller(b.x, b.y);
    float v = 1.0f + c * x;
    v = v * v * v;
    const float u = uniform01(b.z);
    if (v > 0.0f && logf(u) < 0.5f * x * x + d * (1.0f - v + logf(v))) {
      draw = d * v;
      break;
    }
  }
  if (boost) {
    const uint4 b = philox4x32_10(make_uint4(lo, hi, offset, 0xFFFFFFFFu),
                                  key);
    draw = draw * powf(uniform01(b.x), 1.0f / a);
  }
  return draw;
}

}  // namespace hmsc
