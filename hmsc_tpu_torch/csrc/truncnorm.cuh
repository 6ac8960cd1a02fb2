// The one-sided truncated normal draw of the probit latent response, shared
// by B1 (csrc/probit_z.cu, the sampler's Z update) and B9b
// (csrc/serve_conditional.cu, the conditional prediction's Z refresh), so
// both run the same device math.
//
// It is hmsc_tpu/ops/rand.py · truncated_normal_onesided at bound 0, step by
// step, with its float32 guards: the survival probability is clipped to
// [1e-30, 1 - 2^-24] before the inverse CDF (normcdfinvf(1) is +inf), and
// past 9 sigma the exponential tail t - log1p(-u) / max(t, 1) (Robert 1995)
// replaces the quantile.
#pragma once

namespace hmsc {

// X > t for a standard normal X, from the uniform u on [1e-38, 1).  Each
// cell computes only the branch it takes (the two are selected by t, so
// the values are those of computing both and selecting).
__device__ __forceinline__ float truncnorm_std_above(float t, float u) {
  float x;
  if (t > 9.0f) {
    x = t - log1pf(-u) / fmaxf(t, 1.0f);    // the far tail
  } else {
    const float sa = normcdff(-t);          // P(W > t)
    const float p = fminf(fmaxf(u * sa, 1e-30f), 0.99999994f);
    x = -normcdfinvf(p);
  }
  return fmaxf(x, t);                       // clipped-quantile edge
}

// Z ~ N(e, s^2) truncated to Z > 0 where `lower`, to Z < 0 elsewhere.
__device__ __forceinline__ float probit_z_draw(float e, float s, bool lower,
                                               float u) {
  float t = (0.0f - e) / s;                 // standardised bound
  t = lower ? t : -t;                       // reflect into X > t
  float x = truncnorm_std_above(t, u);
  x = lower ? x : -x;
  return e + s * x;
}

}  // namespace hmsc
