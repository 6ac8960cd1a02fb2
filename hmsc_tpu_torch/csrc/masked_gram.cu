// B6: masked grams and right-hand sides, a weighted sum of outer products.
//
// Replaces the masked contractions of hmsc_tpu/mcmc/updaters.py that the
// JAX package runs when Y has missing values (einsums XLA lays out for the
// TPU's matrix unit):
//
//   per species, _per_species_design_gram / _beta_lambda_joint
//     G[c,j] = sum_i m_ij x_ci x_ci',  R[c,j] = sum_i m_ij Z_cij x_ci
//   per row of a level, _masked_level_gram
//     G[c,i] = sum_j m_ij iSigma_cj l_cj l_cj',
//     R[c,i] = sum_j m_ij iSigma_cj S_cij l_cj
//
// One interface covers both:
//
//   G[c,o] = sum_k w[o,k] a[c,k] v[c,k] v[c,k]'          (C, O, P, P)
//   R[c,o] = sum_k w[o,k] a[c,k] s[c,o,k] v[c,k]         (C, O, P)
//
// with v (C, K, P), w (O, K), a (C, K) (absent: 1) and s (C, O, K) each
// given by its strides, so the per-species form (o = species, k = row) and
// the per-row form (o = row, k = species) read the same tensors in place.
//
// What bounds it on the H100: operations.  At the 1000 x 1000 headline with
// 4 chains it is 2 C O K (P(P+1)/2 + P) ~ 5e8 flops against ~22 MB moved.
// Design: the two contractions are matrix products over k, with the
// columns of G's upper triangle (p <= q, built on the fly from a staged
// tile of v) and of R as the output columns; so a block is one chain's
// tile of 64 outputs x 64 columns, 256 threads each holding a 4 x 4
// register tile, stepping through k in tiles of 16 staged in shared
// memory.  A block's columns are either gram pairs or right-hand-side
// entries, so it stages one weight tile: w a for the gram, w a s for the
// right-hand side.  The reduction over k never leaves the block, nothing
// of size O x K x P is formed, and the symmetric half is written twice.

#include <cuda_runtime.h>

namespace {

constexpr int BO = 64;   // outputs per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // reduction tile
constexpr int TY = 16;   // thread rows; each thread holds BO/TY outputs
constexpr int TX = 16;   // thread columns; each thread holds BN/TX columns

struct Args {
  const float* v; long long v_sc, v_sk, v_sp;
  const float* w; long long w_so, w_sk;
  const float* a; long long a_sc, a_sk;
  const float* s; long long s_sc, s_so, s_sk;
  float* G; float* R;
  int O, K, P, n_pair, gram_tiles;
};

__global__ void __launch_bounds__(TY * TX) masked_gram_kernel(Args A) {
  extern __shared__ float Vs[];            // [BK][P] tile of v
  __shared__ float As[BK][BO];             // weight tile
  __shared__ float Bs[BK][BN];             // column tile
  __shared__ int colp[BN], colq[BN];

  const int c = blockIdx.z;
  const int o0 = blockIdx.y * BO;
  const bool rhs = static_cast<int>(blockIdx.x) >= A.gram_tiles;
  const int n0 = (rhs ? static_cast<int>(blockIdx.x) - A.gram_tiles
                      : static_cast<int>(blockIdx.x)) * BN;
  const int n_cols = rhs ? A.P : A.n_pair;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int nthreads = TY * TX;

  if (tid < BN) {                         // column -> (p, q) of the triangle
    int n = n0 + tid, p = 0;
    if (rhs) {
      p = n;
    } else {
      while (p < A.P && n >= A.P - p) {
        n -= A.P - p;
        ++p;
      }
    }
    colp[tid] = p;
    colq[tid] = rhs ? 0 : p + n;
  }
  __syncthreads();

  const float* v = A.v + c * A.v_sc;
  const float* s = A.s + c * A.s_sc;
  const float* a = A.a == nullptr ? nullptr : A.a + c * A.a_sc;
  const bool o_fast = A.w_so == 1;        // which index is contiguous
  const bool p_fast = A.v_sp == 1;

  float acc[BO / TY][BN / TX];
#pragma unroll
  for (int i = 0; i < BO / TY; ++i)
#pragma unroll
    for (int j = 0; j < BN / TX; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < A.K; k0 += BK) {
    // weight tile: w a (gram) or w a s (right-hand side), zero off the edge
    for (int idx = tid; idx < BK * BO; idx += nthreads) {
      const int ol = o_fast ? idx % BO : idx / BK;
      const int kk = o_fast ? idx / BO : idx % BK;
      const int o = o0 + ol, k = k0 + kk;
      float x = 0.0f;
      if (o < A.O && k < A.K) {
        x = A.w[o * A.w_so + k * A.w_sk];
        if (a != nullptr) x *= a[k * A.a_sk];
        if (rhs) x *= s[o * A.s_so + k * A.s_sk];
      }
      As[kk][ol] = x;
    }
    // v tile
    for (int idx = tid; idx < BK * A.P; idx += nthreads) {
      const int p = p_fast ? idx % A.P : idx / BK;
      const int kk = p_fast ? idx / A.P : idx % BK;
      const int k = k0 + kk;
      Vs[kk * A.P + p] = k < A.K ? v[k * A.v_sk + p * A.v_sp] : 0.0f;
    }
    __syncthreads();
    // column tile: v_p v_q (gram) or v_p (right-hand side)
    for (int idx = tid; idx < BK * BN; idx += nthreads) {
      const int kk = idx / BN, nl = idx % BN;
      float x = 0.0f;
      if (n0 + nl < n_cols) {
        x = Vs[kk * A.P + colp[nl]];
        if (!rhs) x *= Vs[kk * A.P + colq[nl]];
      }
      Bs[kk][nl] = x;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ar[BO / TY], br[BN / TX];
#pragma unroll
      for (int i = 0; i < BO / TY; ++i) ar[i] = As[kk][threadIdx.y + TY * i];
#pragma unroll
      for (int j = 0; j < BN / TX; ++j) br[j] = Bs[kk][threadIdx.x + TX * j];
#pragma unroll
      for (int i = 0; i < BO / TY; ++i)
#pragma unroll
        for (int j = 0; j < BN / TX; ++j) acc[i][j] += ar[i] * br[j];
    }
    __syncthreads();
  }

  const long long P = A.P;
#pragma unroll
  for (int i = 0; i < BO / TY; ++i) {
    const int o = o0 + threadIdx.y + TY * i;
    if (o >= A.O) continue;
    const long long out = static_cast<long long>(c) * A.O + o;
#pragma unroll
    for (int j = 0; j < BN / TX; ++j) {
      const int nl = threadIdx.x + TX * j;
      if (n0 + nl >= n_cols) continue;
      const int p = colp[nl], q = colq[nl];
      if (rhs) {
        A.R[out * P + p] = acc[i][j];
      } else {
        A.G[(out * P + p) * P + q] = acc[i][j];
        if (p != q) A.G[(out * P + q) * P + p] = acc[i][j];
      }
    }
  }
}

}  // namespace

extern "C" int hmsc_masked_gram(const float* v, long long v_sc,
                                long long v_sk, long long v_sp,
                                const float* w, long long w_so,
                                long long w_sk, const float* a,
                                long long a_sc, long long a_sk,
                                const float* s, long long s_sc,
                                long long s_so, long long s_sk, float* G,
                                float* R, int C, int O, int K, int P,
                                void* stream) {
  Args A{v, v_sc, v_sk, v_sp, w, w_so, w_sk, a, a_sc, a_sk,
         s, s_sc, s_so, s_sk, G, R, O, K, P, P * (P + 1) / 2, 0};
  A.gram_tiles = (A.n_pair + BN - 1) / BN;
  const int rhs_tiles = (P + BN - 1) / BN;
  const dim3 grid(static_cast<unsigned>(A.gram_tiles + rhs_tiles),
                  static_cast<unsigned>((O + BO - 1) / BO),
                  static_cast<unsigned>(C));
  const size_t smem = sizeof(float) * BK * static_cast<size_t>(P);
  masked_gram_kernel<<<grid, dim3(TX, TY), smem,
                       static_cast<cudaStream_t>(stream)>>>(A);
  return static_cast<int>(cudaGetLastError());
}
