// The one-sided truncated normal draw of the probit latent response, shared
// by B1 (csrc/probit_z.cu, the sampler's Z update) and B9b
// (csrc/serve_conditional.cu, the conditional prediction's Z refresh), so
// both run the same device math.
//
// It is hmsc_tpu/ops/rand.py · truncated_normal_onesided at bound 0, step by
// step, with its float32 guards: the survival probability is clipped to
// [1e-30, 1 - 2^-24] before the inverse CDF, and past 9 sigma the
// exponential tail t - log1p(-u) / t (Robert 1995) replaces the quantile
// (computed only where taken).  Phi and Phi^-1 take fewer instructions than
// normcdff / normcdfinvf: P(W > t) = erfc(|t| / sqrt 2) / 2 from the
// Numerical Recipes exp-times-polynomial form (fractional error < 1.2e-7;
// ~1e-5 in float32 near t = 9), and Phi^-1 from Wichura's AS 241 single
// precision rationals (PPND7; ~2e-6 absolute in float32), central and tail
// evaluated with one reciprocal; both on the fast exp2 / log2 / reciprocal
// units in their flush-to-zero forms (their arguments are never
// subnormal).  Measured on an H100: B1's E-reading kernel's SASS fell from
// ~220 to ~165 static instructions a cell against normcdff / normcdfinvf,
// and its time by ~28% (scripts/probit_z_sweep.py).  Against the plain
// versions B1's draws agree within ~1e-5 of sd (chip_smoke.py gates 1e-4),
// and B9b's moments within its 1e-5 gate.
#pragma once

namespace hmsc {

// The approximate, flush-to-zero forms of exp2, log2, 1/sqrt and 1/x (their
// arguments here are never subnormal; each saves the subnormal fix-ups of
// the library forms).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_ftz(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_ftz(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P(W > t) for a standard normal W: erfc(|t| / sqrt 2) / 2 (Numerical
// Recipes' erfcc), reflected for t < 0.
__device__ __forceinline__ float upper_prob(float t) {
  const float z = fabsf(t) * 0.70710678118654752f;
  const float r = rcp_ftz(fmaf(0.5f, z, 1.0f));
  float p = fmaf(r, 0.17087277f, -0.82215223f);
  p = fmaf(r, p, 1.48851587f);
  p = fmaf(r, p, -1.13520398f);
  p = fmaf(r, p, 0.27886807f);
  p = fmaf(r, p, -0.18628806f);
  p = fmaf(r, p, 0.09678418f);
  p = fmaf(r, p, 0.37409196f);
  p = fmaf(r, p, 1.00002368f);
  p = fmaf(r, p, -1.26551223f);
  const float h = 0.5f * r * ex2_ftz(1.4426950408889634f * fmaf(-z, z, p));
  return t > 0.0f ? h : 1.0f - h;
}

// -Phi^-1(p) for p in [1e-30, 1 - 2^-24]: Wichura's AS 241 (PPND7, about
// 1e-7 relative), a rational in 0.180625 - (p - 1/2)^2 for |p - 1/2| <=
// 0.425, else one in sqrt(-log min(p, 1 - p)) - 1.6 up to 5 and - 5 past
// it; one division.
__device__ __forceinline__ float neg_ndtri(float p) {
  const float q = p - 0.5f;
  const float r = fmaf(-q, q, 0.180625f);
  float na = fmaf(5.9109374720e+01f, r, 1.5929113202e+02f);
  na = fmaf(na, r, 5.0434271938e+01f);
  na = fmaf(na, r, 3.3871327179e+00f);
  float nb = fmaf(6.7187563600e+01f, r, 7.8757757664e+01f);
  nb = fmaf(nb, r, 1.7895169469e+01f);
  nb = fmaf(nb, r, 1.0f);
  const float w = -0.69314718055994531f * lg2_ftz(fminf(p, 1.0f - p));
  float v = w * rsqrt_ftz(w);                    // sqrt(-log min(p, 1 - p))
  float nc, nd;
  if (v <= 5.0f) {
    v -= 1.6f;
    nc = fmaf(1.7023821103e-01f, v, 1.3067284816e+00f);
    nc = fmaf(nc, v, 2.7568153900e+00f);
    nc = fmaf(nc, v, 1.4234372777e+00f);
    nd = fmaf(1.2021132975e-01f, v, 7.3700164250e-01f);
  } else {
    v -= 5.0f;
    nc = fmaf(1.7337203997e-02f, v, 4.2868294337e-01f);
    nc = fmaf(nc, v, 3.0812263860e+00f);
    nc = fmaf(nc, v, 6.6579051150e+00f);
    nd = fmaf(1.2258202635e-02f, v, 2.4197894225e-01f);
  }
  nd = fmaf(nd, v, 1.0f);
  const bool central = fabsf(q) <= 0.425f;
  // Phi^-1 is q na / nb centrally and sign(q) nc / nd in the tails
  const float num = central ? -q * na : (q < 0.0f ? nc : -nc);
  return num * rcp_ftz(central ? nb : nd);
}

// Z ~ N(e, s^2) truncated to Z > 0 where `lower`, Z < 0 elsewhere, from
// the uniform u on [1e-38, 1); `is` is 1 / s.
__device__ __forceinline__ float probit_z_draw(float e, float s, float is,
                                               bool lower, float u) {
  float t = -e * is;                          // standardised bound
  t = lower ? t : -t;                         // reflect into X > t
  float x;
  if (t > 9.0f) {
    x = t - log1pf(-u) / t;                   // the far tail
  } else {
    const float p = fminf(fmaxf(u * upper_prob(t), 1e-30f), 0.99999994f);
    x = neg_ndtri(p);
  }
  x = fmaxf(x, t);                            // clipped-quantile edge
  return fmaf(s, lower ? x : -x, e);
}

// The same with 1 / s formed here (B9b: a column's s serves one cell).
__device__ __forceinline__ float probit_z_draw(float e, float s, bool lower,
                                               float u) {
  return probit_z_draw(e, s, 1.0f / s, lower, u);
}

}  // namespace hmsc
