// B8d-1: the per-unit Woodbury blocks of the GPP (predictive-process) Eta
// draw.
//
// Replaces the per-unit part of hmsc_tpu/mcmc/spatial.py · gpp_factor
// (:164-185) with _eta_gpp's alpha-0 override (:374-377), which the JAX
// package wrote as batched whole-array ops.  For each chain c and unit u:
//   A   = LiSL[c,u] + diag(idD),  idD[h] = idDg[alpha[c,h], u], or 1 where
//         alphapw[alpha[c,h], 0] == 0 (W = I at alpha 0);
//   L   = chol(A + 1e-6 mean(diag A) I)     (chol_spd's relative jitter);
//   iA  = L^-T L^-1;
//   LiA = chol(iA)                          (no jitter, as the JAX package's
//                                            plain cholesky of iA).
// Both outputs are (C, np, nf, nf); LiA's upper triangle is 0.  A block
// whose factorisation meets a pivot that is not positive comes out NaN in
// full (iA and LiA for the first factorisation, LiA for the second), as
// chol_spd's NaN and the JAX cholesky's do, so that divergence containment
// sees it.
//
// What bounds it on the H100: launch latency.  At config 3c (4 chains,
// 1000 units, nf 2) it reads 64 KB of LiSL and 8 KB of idD and writes
// 128 KB, under 0.1 us at 3.35 TB/s; the ~nf^3 operations per unit are
// negligible.  Design: one system per thread, held in registers as packed
// lower triangles sized by the template parameter nf (1..16, as B2), the
// idD slice read in place from the grid by each factor's alpha index.

#include <cuda_runtime.h>

namespace {

template <int P>
__global__ void gpp_unit_kernel(const float* __restrict__ LiSL,
                                const float* __restrict__ idDg,
                                const float* __restrict__ alphapw,
                                const int* __restrict__ alpha,
                                float* __restrict__ iA,
                                float* __restrict__ LiA, int C, int np) {
  const long long b = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;  // c * np + u
  if (b >= static_cast<long long>(C) * np) return;
  const int c = static_cast<int>(b / np);
  const int u = static_cast<int>(b - static_cast<long long>(c) * np);
  const float* A = LiSL + b * P * P;
  float* oA = iA + b * P * P;
  float* oL = LiA + b * P * P;
  const float nan = __int_as_float(0x7fc00000);

  // lower triangle of A + diag(idD), packed row-major: (i, j) -> i(i+1)/2+j
  float L[P * (P + 1) / 2];
  float scale = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) L[i * (i + 1) / 2 + j] = A[i * P + j];
    const int a = alpha[c * P + i];
    const float d = (alphapw[2 * a] == 0.0f)
                        ? 1.0f
                        : idDg[static_cast<long long>(a) * np + u];
    L[i * (i + 1) / 2 + i] += d;
    scale += L[i * (i + 1) / 2 + i];
  }
  const float bump = 1e-6f * (scale / P);  // chol_spd: 1e-6 x mean diagonal

  // Cholesky in place, column by column
  bool bad = false;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float s = L[j * (j + 1) / 2 + j] + bump;
#pragma unroll
    for (int k = 0; k < j; ++k)
      s -= L[j * (j + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
    bad = bad || !(s > 0.0f);
    const float d = sqrtf(s);
    L[j * (j + 1) / 2 + j] = d;
#pragma unroll
    for (int i = j + 1; i < P; ++i) {
      float s2 = L[i * (i + 1) / 2 + j];
#pragma unroll
      for (int k = 0; k < j; ++k)
        s2 -= L[i * (i + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
      L[i * (i + 1) / 2 + j] = s2 / d;
    }
  }
  if (bad) {
#pragma unroll
    for (int e = 0; e < P * P; ++e) {
      oA[e] = nan;
      oL[e] = nan;
    }
    return;
  }

  // Li = L^-1 (lower), column by column
  float Li[P * (P + 1) / 2];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    Li[j * (j + 1) / 2 + j] = 1.0f / L[j * (j + 1) / 2 + j];
#pragma unroll
    for (int i = j + 1; i < P; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int k = j; k < i; ++k)
        s += L[i * (i + 1) / 2 + k] * Li[k * (k + 1) / 2 + j];
      Li[i * (i + 1) / 2 + j] = -s / L[i * (i + 1) / 2 + i];
    }
  }

  // iA = Li' Li (symmetric): iA[i][j] = sum_{k >= i} Li[k][i] Li[k][j], j <= i;
  // written in full, kept packed in L for the second factorisation
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = i; k < P; ++k)
        s += Li[k * (k + 1) / 2 + i] * Li[k * (k + 1) / 2 + j];
      L[i * (i + 1) / 2 + j] = s;
      oA[i * P + j] = s;
      oA[j * P + i] = s;
    }
  }

  // LiA = chol(iA), no jitter
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float s = L[j * (j + 1) / 2 + j];
#pragma unroll
    for (int k = 0; k < j; ++k)
      s -= L[j * (j + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
    bad = bad || !(s > 0.0f);
    const float d = sqrtf(s);
    L[j * (j + 1) / 2 + j] = d;
#pragma unroll
    for (int i = j + 1; i < P; ++i) {
      float s2 = L[i * (i + 1) / 2 + j];
#pragma unroll
      for (int k = 0; k < j; ++k)
        s2 -= L[i * (i + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
      L[i * (i + 1) / 2 + j] = s2 / d;
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < P; ++j)
      oL[i * P + j] = bad ? nan : (j <= i ? L[i * (i + 1) / 2 + j] : 0.0f);
}

template <int P>
int launch(const float* LiSL, const float* idDg, const float* alphapw,
           const int* alpha, float* iA, float* LiA, int C, int np,
           cudaStream_t stream) {
  const int threads = 128;
  const long long n = static_cast<long long>(C) * np;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  gpp_unit_kernel<P><<<blocks, threads, 0, stream>>>(LiSL, idDg, alphapw,
                                                     alpha, iA, LiA, C, np);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hmsc_gpp_unit(const float* LiSL, const float* idDg,
                             const float* alphapw, const int* alpha,
                             float* iA, float* LiA, int C, int np, int nf,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(C) * np == 0) return 0;
  switch (nf) {
    case 1: return launch<1>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 2: return launch<2>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 3: return launch<3>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 4: return launch<4>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 5: return launch<5>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 6: return launch<6>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 7: return launch<7>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 8: return launch<8>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 9: return launch<9>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 10: return launch<10>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 11: return launch<11>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 12: return launch<12>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 13: return launch<13>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 14: return launch<14>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 15: return launch<15>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    case 16: return launch<16>(LiSL, idDg, alphapw, alpha, iA, LiA, C, np, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
