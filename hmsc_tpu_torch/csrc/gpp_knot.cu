// B8d-2: the knot-space correction of the GPP (predictive-process) Eta draw.
//
// Replaces hmsc_tpu/mcmc/spatial.py · gpp_factor's
//   H = blockdiag_h(F_h) - M' iA M                      (:178-183)
// i.e. for each chain c, with n = nf nK, rows (h, m) = h nK + m and
// columns (g, k) = g nK + k:
//   H[c, (h,m), (g,k)] = [h == g] Fg[alpha[c,h], m, k]
//                        - sum_u M1[c,h,u,m] iA[c,u,h,g] M1[c,g,u,k],
// where M1[c,h] = idDW12g[alpha[c,h]] read in place by index, and zero for
// a factor at alpha 0 (_eta_gpp's override, :374-377).  H is written in
// full, (C, n, n), in double.
//
// Precision: at a large alpha H's condition number reaches ~2e7 (config
// 3c), so a float32 H (entries up to ~4e-6 of its largest off) and its
// float32 Cholesky put the Eta draw ~8% of its standard deviation off at the
// grid's top.  The products and the sums are therefore taken in double
// from the float32 inputs (exact conversions), and H is returned in double
// for a float64 Cholesky and knot-space solves (mcmc/spatial.py).
//
// What bounds it on the H100: it is a weighted gram, M' diag(iA_hg) M over
// np units for each of the nf^2 factor pairs: n (n + 1) np operations a
// chain for its lower triangle (160 MFLOP at config 3c: C 4, np 1000, nK
// 100, nf 2, 0.0024 ms at 67 TFLOP/s) against ~3 MB of grid slices (0.001
// ms).  B6, a gram of the same shape of work, lost to its plain einsum
// because one resident block per SM left its k loop latency-bound; so this
// kernel tiles the output in 32 x 32 tiles (2 x 2 entries a thread) AND
// splits the unit range over S blocks, so config 3c runs 7 x 7 tiles x 7
// splits x 4 chains = 1372 blocks.  Each block finds its tile rows' and
// columns' grid offsets once, then stages 32 units at a time of their M1
// values and of iA in shared memory (as float32; widened in registers).
//
// Determinism: every partial sums its units in ascending order, and a
// second pass adds the S partials in split order (S depends on np only),
// then F on the diagonal blocks; no atomics, so two runs give the same
// bits.  A call is two launches: the partials, then their sum.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;              // output tile, 2 x 2 entries a thread
constexpr int kHalf = kTile / 2;
constexpr int kUnits = 32;             // units staged per step
constexpr int kThreads = kHalf * kHalf;
constexpr int kMaxNf = 16;             // iA staged as kUnits x nf^2 floats

__global__ void gpp_knot_partial_kernel(const float* __restrict__ iA,
                                        const float* __restrict__ W,
                                        const float* __restrict__ alphapw,
                                        const int* __restrict__ alpha,
                                        double* __restrict__ partial, int np,
                                        int nf, int nK, int S) {
  __shared__ float Mr[kTile][kUnits + 1];
  __shared__ float Mc[kTile][kUnits + 1];
  __shared__ float As[kUnits * kMaxNf * kMaxNf];
  // per tile row / column: the offset of M1[c, h, 0, m] in the grid (at
  // the factor's alpha), -1 where M1 is zero (alpha 0) or past the edge,
  // and its factor h
  __shared__ long long base[2][kTile];
  __shared__ int fac[2][kTile];
  const int n = nf * nK;
  const int tiles = (n + kTile - 1) / kTile;
  const int row0 = (blockIdx.x / tiles) * kTile;
  const int col0 = (blockIdx.x % tiles) * kTile;
  const int s = blockIdx.y, c = blockIdx.z;
  if (threadIdx.x < 2 * kTile) {
    const int side = threadIdx.x / kTile, k = threadIdx.x % kTile;
    const int rc = (side == 0 ? row0 : col0) + k;
    long long b = -1;
    int h = 0;
    if (rc < n) {
      h = rc / nK;
      const int a = alpha[c * nf + h];
      if (alphapw[2 * a] != 0.0f)
        b = static_cast<long long>(a) * np * nK + (rc - h * nK);
    }
    base[side][k] = b;
    fac[side][k] = h;
  }
  __syncthreads();
  // this thread's 2 x 2 outputs: rows ty, ty + 16, columns tx, tx + 16
  const int ty = threadIdx.x / kHalf, tx = threadIdx.x % kHalf;
  const int chunk = (np + S - 1) / S;
  const int u_lo = s * chunk;
  const int u_hi = min(np, u_lo + chunk);
  const int nf2 = nf * nf;
  int hg[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      hg[i][j] = fac[0][ty + i * kHalf] * nf + fac[1][tx + j * kHalf];
  double acc[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
  for (int u0 = u_lo; u0 < u_hi; u0 += kUnits) {
    const int nu = min(kUnits, u_hi - u0);
    for (int e = threadIdx.x; e < kTile * kUnits; e += kThreads) {
      const int rr = e % kTile, uu = e / kTile;
      const long long off = static_cast<long long>(u0 + uu) * nK;
      const long long br = base[0][rr], bc = base[1][rr];
      Mr[rr][uu] = (uu < nu && br >= 0) ? W[br + off] : 0.0f;
      Mc[rr][uu] = (uu < nu && bc >= 0) ? W[bc + off] : 0.0f;
    }
    const float* iAc = iA + (static_cast<long long>(c) * np + u0) * nf2;
    for (int e = threadIdx.x; e < nu * nf2; e += kThreads) As[e] = iAc[e];
    __syncthreads();
    for (int uu = 0; uu < nu; ++uu) {
      const double a[2] = {Mr[ty][uu], Mr[ty + kHalf][uu]};
      const double b[2] = {Mc[tx][uu], Mc[tx + kHalf][uu]};
      const float* Au = As + uu * nf2;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          acc[i][j] = fma(a[i] * static_cast<double>(Au[hg[i][j]]), b[j],
                          acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row0 + ty + i * kHalf, q = col0 + tx + j * kHalf;
      if (r < n && q < n)
        partial[((static_cast<long long>(c) * S + s) * n + r) * n + q] =
            acc[i][j];
    }
}

__global__ void gpp_knot_sum_kernel(const double* __restrict__ partial,
                                    const float* __restrict__ Fg,
                                    const int* __restrict__ alpha,
                                    double* __restrict__ H, int C, int nf,
                                    int nK, int S) {
  const long long n = static_cast<long long>(nf) * nK;
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (e >= C * n * n) return;
  const long long c = e / (n * n);
  const long long rq = e - c * n * n;
  const int r = static_cast<int>(rq / n), q = static_cast<int>(rq % n);
  double sum = 0.0;
  for (int s = 0; s < S; ++s) sum += partial[(c * S + s) * n * n + rq];
  double out = -sum;
  const int h = r / nK, g = q / nK;
  if (h == g) {
    const long long a = alpha[c * nf + h];
    out += Fg[(a * nK + (r - h * nK)) * nK + (q - g * nK)];
  }
  H[e] = out;
}

}  // namespace

extern "C" int hmsc_gpp_knot(const float* iA, const float* idDW12g,
                             const float* Fg, const float* alphapw,
                             const int* alpha, double* partial, double* H,
                             int C, int np, int nf, int nK, int S,
                             void* stream) {
  if (nf > kMaxNf || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = nf * nK;
  if (C == 0 || n == 0) return 0;
  const int tiles = (n + kTile - 1) / kTile;
  gpp_knot_partial_kernel<<<dim3(tiles * tiles, S, C), kThreads, 0, st>>>(
      iA, idDW12g, alphapw, alpha, partial, np, nf, nK, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(C) * n * n;
  const int threads = 256;
  gpp_knot_sum_kernel<<<static_cast<unsigned>((total + threads - 1) /
                                              threads),
                        threads, 0, st>>>(partial, Fg, alpha, H, C, nf, nK,
                                          S);
  return static_cast<int>(cudaGetLastError());
}
