// The first version of kernel B2 (one system a thread), kept as a
// yardstick: chip_smoke.py and scripts/mvn_prec_sweep.py build it on the
// card and time it beside the shipped B2
// (hmsc_tpu_torch/csrc/mvn_prec_small.cu, a group of P lanes a system).
// It is not part of the package and no path runs it.
//
// B2: a batch of draws x ~ N(P^{-1} rhs, P^{-1}) from small SPD precisions.
//
// Replaces hmsc_tpu/ops/linalg.py · sample_mvn_prec_batched (P <= 16), the
// unrolled Cholesky that the JAX package laid out with the batch as the
// TPU's vector dimension.  Callers on the main path: the joint
// Beta/Lambda draw (one P = nc + nf system per species) and the Eta draw
// (one P = nf system per unit).
//
// What bounds it on the H100: launch latency.  At the headline the batch
// is 4 chains x 1000 systems of P = 8 or 10, about 2 MB of input, which
// the card reads in under a microsecond; the ~P^3/6 flops per system are
// negligible.  Design: one system per thread, the factor held in a
// register array sized by the template parameter P (instantiated for every
// P = 1..16), so nothing goes through shared or local memory.  The order
// of operations is the JAX op's: relative jitter (1e-6/P) x trace on the
// diagonal, column-by-column Cholesky, forward solve L y = rhs, back solve
// L' x = y + eps.  sqrtf of a negative pivot is NaN and propagates to the
// whole row of the result, which is what divergence containment relies on
// (hmsc_tpu/ops/linalg.py:95).

#include <cuda_runtime.h>

namespace {

template <int P>
__global__ void mvn_prec_small_kernel(const float* __restrict__ prec,
                                      const float* __restrict__ rhs,
                                      const float* __restrict__ eps,
                                      float* __restrict__ out, long long batch,
                                      float jitter_over_p) {
  const long long b = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (b >= batch) return;
  const float* A = prec + b * P * P;
  float L[P * (P + 1) / 2];  // lower triangle, row-major: (i, j) -> i(i+1)/2+j
  float inv[P];
  float scale = A[0];
#pragma unroll
  for (int j = 1; j < P; ++j) scale = scale + A[j * P + j];
  const float bump = jitter_over_p * scale;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float s = A[j * P + j] + bump;
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j * (j + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
    const float d = sqrtf(s);  // NaN if indefinite, like the JAX op
    inv[j] = 1.0f / d;
    L[j * (j + 1) / 2 + j] = d;
#pragma unroll
    for (int i = j + 1; i < P; ++i) {
      float s2 = A[i * P + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s2 = s2 - L[i * (i + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
      L[i * (i + 1) / 2 + j] = s2 * inv[j];
    }
  }
  const float* r = rhs + b * P;
  const float* e = eps + b * P;
  float y[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float s = r[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i * (i + 1) / 2 + k] * y[k];
    y[i] = s * inv[i];
  }
  float x[P];
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    float s = y[i] + e[i];
#pragma unroll
    for (int k = i + 1; k < P; ++k) s = s - L[k * (k + 1) / 2 + i] * x[k];
    x[i] = s * inv[i];
  }
  float* o = out + b * P;
#pragma unroll
  for (int i = 0; i < P; ++i) o[i] = x[i];
}

template <int P>
int launch(const float* prec, const float* rhs, const float* eps, float* out,
           long long batch, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks =
      static_cast<unsigned>((batch + threads - 1) / threads);
  // (1e-6 / P) in double, then rounded: the JAX op's Python-float factor
  const float jitter_over_p = static_cast<float>(1e-6 / P);
  mvn_prec_small_kernel<P><<<blocks, threads, 0, stream>>>(
      prec, rhs, eps, out, batch, jitter_over_p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hmsc_mvn_prec_small(const float* prec, const float* rhs,
                                   const float* eps, float* out,
                                   long long batch, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return launch<1>(prec, rhs, eps, out, batch, s);
    case 2: return launch<2>(prec, rhs, eps, out, batch, s);
    case 3: return launch<3>(prec, rhs, eps, out, batch, s);
    case 4: return launch<4>(prec, rhs, eps, out, batch, s);
    case 5: return launch<5>(prec, rhs, eps, out, batch, s);
    case 6: return launch<6>(prec, rhs, eps, out, batch, s);
    case 7: return launch<7>(prec, rhs, eps, out, batch, s);
    case 8: return launch<8>(prec, rhs, eps, out, batch, s);
    case 9: return launch<9>(prec, rhs, eps, out, batch, s);
    case 10: return launch<10>(prec, rhs, eps, out, batch, s);
    case 11: return launch<11>(prec, rhs, eps, out, batch, s);
    case 12: return launch<12>(prec, rhs, eps, out, batch, s);
    case 13: return launch<13>(prec, rhs, eps, out, batch, s);
    case 14: return launch<14>(prec, rhs, eps, out, batch, s);
    case 15: return launch<15>(prec, rhs, eps, out, batch, s);
    case 16: return launch<16>(prec, rhs, eps, out, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
