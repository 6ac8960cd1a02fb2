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
// grid's top, and F rounded to float32 on the host a further 4.6% of it
// (mcmc/structs.py · _F64_FIELDS).  So the grids idDW12g and Fg are float64
// on the device, the products and sums are taken in double, and H is
// returned in double for a float64 Cholesky and knot-space solves
// (mcmc/spatial.py).
//
// What bounds it on the H100: it is a weighted gram, M_h' diag(iA_hg) M_g
// over np units for each factor pair: n (n + 1) np operations a chain for
// H's lower triangle (160 MFLOP at config 3c: C 4, np 1000, nK 100, nf 2;
// 0.0024 ms at 67 TFLOP/s, the FP64 tensor cores' rate) against ~7 MB of
// grid slices (0.002 ms).  The first design (32 x 32 output tiles, 2 x 2
// float64 FMAs a thread, three float-to-double conversions for every four
// FMAs, all of H) took 0.127 ms, 2.75x one float32 einsum.  This design:
//   - computes the lower triangle only, organised by factor pair (h >= g):
//     a block owns one pair's nK x nK block (up to 128 x 104 entries; a
//     larger nK takes bands), so the row scale iA[u,h,g] is one number a
//     unit; in a diagonal pair only the 8 x 8 tiles on or below the
//     diagonal are computed;
//   - splits the unit range over blocks (ops/spatial.py · _knot_splits, a
//     function of the shape alone: ~one block an SM, 132 at config 3c);
//   - stages each unit range's M1 rows of both factors in shared memory
//     once, in double, 16 units a step, double-buffered with cp.async so
//     the next units' loads are in flight while the products run; the row
//     side is scaled by iA[u,h,g] (one double multiply a fragment);
//   - runs the products on the FP64 tensor cores: mma.sync m8n8k4 f64 with
//     double accumulators, each warp a strip of 2 x 13 tiles of 8 x 8 (16
//     rows x 104 columns), so one A fragment serves 13 products and the
//     fragments' shared loads are conflict-free (row stride 4 mod 16).
//
// Determinism: every partial sums its units in ascending order, and a
// second pass adds the S partials in split order (S depends on the shape
// only), negates, adds F on the diagonal blocks and writes each lower
// entry to both of its places, so H is exactly symmetric; no atomics, so
// two runs give the same bits.  A call is two launches.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStrip = 2;                       // 8-row tiles a warp carries
constexpr int kColTiles = 13;                   // 8-column tiles a warp carries
constexpr int kBandRows = kWarps * kStrip * 8;  // 128 rows a block
constexpr int kBandCols = kColTiles * 8;        // 104 columns a block
constexpr int kUnits = 16;                      // units a stage (4 k-steps)
constexpr int kLdR = 132;                       // >= kBandRows, 4 mod 16
constexpr int kLdC = 116;                       // >= kBandCols, 4 mod 16
constexpr size_t kSmem = sizeof(double) * 2 * kUnits * (kLdR + kLdC) +
                         sizeof(float) * 2 * kUnits;

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 8 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0));
}

// D = A B + D for an 8 x 4 row-major A (one element a lane: row lane / 4,
// column lane % 4), a 4 x 8 column-major B (row lane % 4, column lane /
// 4) and an 8 x 8 D (row lane / 4, columns 2 (lane % 4) + 0, 1).
__device__ __forceinline__ void mma_f64(double* d, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// the factor pair (h, g), h >= g, of pair index h (h + 1) / 2 + g
__device__ __forceinline__ void pair_of(int pair, int* h, int* g) {
  int r = 0;
  while ((r + 1) * (r + 2) / 2 <= pair) ++r;
  *h = r;
  *g = pair - r * (r + 1) / 2;
}

// One (pair, band, unit split, chain) block: the partial sums
// sum_u M1[h,u,m] iA[u,h,g] M1[g,u,k] over the split's units for the
// band's rows m and columns k, into partial[c, s, pair, m, k].
__global__ void __launch_bounds__(kThreads, 1)
    gpp_knot_partial_kernel(const float* __restrict__ iA,
                            const double* __restrict__ W,
                            const float* __restrict__ alphapw,
                            const int* __restrict__ alpha,
                            double* __restrict__ partial, int np, int nf,
                            int nK, int S, int chunk, int rbands,
                            int cbands) {
  extern __shared__ __align__(16) double sm[];
  double* Rs = sm;                               // [2][kUnits][kLdR]
  double* Cs = Rs + 2 * kUnits * kLdR;           // [2][kUnits][kLdC]
  float* Is = reinterpret_cast<float*>(Cs + 2 * kUnits * kLdC);  // [2][kUnits]
  const int bands = rbands * cbands;
  const int pair = blockIdx.x / bands;
  const int row0 = (blockIdx.x % bands) / cbands * kBandRows;
  const int col0 = (blockIdx.x % cbands) * kBandCols;
  const int s = blockIdx.y, c = blockIdx.z;
  int h, g;
  pair_of(pair, &h, &g);
  const bool diag = h == g;
  const int nr = min(kBandRows, nK - row0), nc = min(kBandCols, nK - col0);
  // a diagonal pair's band wholly above the diagonal is never read
  if (diag && col0 > row0 + nr - 1) return;
  const int ah = alpha[c * nf + h], ag = alpha[c * nf + g];
  const bool zh = alphapw[2 * ah] == 0.0f, zg = alphapw[2 * ag] == 0.0f;
  const double* Mh = W + static_cast<long long>(ah) * np * nK + row0;
  const double* Mg = W + static_cast<long long>(ag) * np * nK + col0;
  const float* iAc = iA + (static_cast<long long>(c) * np * nf + h) * nf + g;
  const int u_lo = s * chunk, u_hi = min(np, u_lo + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // units u0 .. u0 + kUnits - 1 into buffer buf, zero past the edges and
  // for a factor at alpha 0
  auto load = [&](int buf, int u0) {
    double* R = Rs + buf * kUnits * kLdR;
    double* Cb = Cs + buf * kUnits * kLdC;
    for (int e = tid; e < kUnits * kBandRows; e += kThreads) {
      const int uu = e / kBandRows, m = e % kBandRows, u = u0 + uu;
      const bool ok = !zh && u < u_hi && m < nr;
      cp_async(R + uu * kLdR + m,
               ok ? Mh + static_cast<long long>(u) * nK + m : W, 8, ok);
    }
    for (int e = tid; e < kUnits * kBandCols; e += kThreads) {
      const int uu = e / kBandCols, k = e % kBandCols, u = u0 + uu;
      const bool ok = !zg && u < u_hi && k < nc;
      cp_async(Cb + uu * kLdC + k,
               ok ? Mg + static_cast<long long>(u) * nK + k : W, 8, ok);
    }
    for (int uu = tid; uu < kUnits; uu += kThreads) {
      const int u = u0 + uu;
      const bool ok = u < u_hi;
      cp_async(Is + buf * kUnits + uu,
               ok ? iAc + static_cast<long long>(u) * nf * nf : iA, 4, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // this warp's strip: band row tiles rt0, rt0 + 1; its real column tiles
  const int rt0 = warp * kStrip;
  const int n_rt = (nr + 7) / 8, n_ct = (nc + 7) / 8;
  const bool busy = rt0 < n_rt;
  const int grt = row0 / 8 + rt0, gct = col0 / 8;  // global tile indices
  double acc[kStrip][kColTiles][2];
#pragma unroll
  for (int i = 0; i < kStrip; ++i)
#pragma unroll
    for (int j = 0; j < kColTiles; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

  const int steps = u_hi > u_lo ? (u_hi - u_lo + kUnits - 1) / kUnits : 0;
  if (steps > 0) load(0, u_lo);
  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // stage it has landed, and every warp is done with stage it - 1's
    // buffer, which the next load overwrites
    __syncthreads();
    if (it + 1 < steps) load(buf ^ 1, u_lo + (it + 1) * kUnits);
    if (!busy) continue;
    const double* R = Rs + buf * kUnits * kLdR;
    const double* Cb = Cs + buf * kUnits * kLdC;
    const float* Iu = Is + buf * kUnits;
#pragma unroll
    for (int k4 = 0; k4 < kUnits / 4; ++k4) {
      const int uu = 4 * k4 + (lane & 3);
      const double ia = static_cast<double>(Iu[uu]);
      double a[kStrip];
#pragma unroll
      for (int i = 0; i < kStrip; ++i)
        a[i] = R[uu * kLdR + (rt0 + i) * 8 + (lane >> 2)] * ia;
#pragma unroll
      for (int j = 0; j < kColTiles; ++j) {
        if (j >= n_ct) break;
        const double b = Cb[uu * kLdC + j * 8 + (lane >> 2)];
#pragma unroll
        for (int i = 0; i < kStrip; ++i)
          if (rt0 + i < n_rt && (!diag || gct + j <= grt + i))
            mma_f64(acc[i][j], a[i], b);
      }
    }
  }
  if (!busy) return;
  const int npairs = nf * (nf + 1) / 2;
  double* out = partial +
                ((static_cast<long long>(c) * S + s) * npairs + pair) * nK *
                    nK;
#pragma unroll
  for (int i = 0; i < kStrip; ++i) {
    const int m = row0 + (rt0 + i) * 8 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kColTiles; ++j) {
      if (j >= n_ct) break;
      if (diag && gct + j > grt + i) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = col0 + j * 8 + 2 * (lane & 3) + e;
        if (m < row0 + nr && k < col0 + nc)
          out[static_cast<long long>(m) * nK + k] = acc[i][j][e];
      }
    }
  }
}

// One thread an entry (m, k) of a pair's block (m >= k on a diagonal
// pair): the S partials added in split order, negated, F added on a
// diagonal pair (read at the lower position), written to H at (h nK + m,
// g nK + k) and at its mirror.
__global__ void gpp_knot_sum_kernel(const double* __restrict__ partial,
                                    const double* __restrict__ Fg,
                                    const int* __restrict__ alpha,
                                    double* __restrict__ H, int C, int nf,
                                    int nK, int S) {
  const int npairs = nf * (nf + 1) / 2;
  const long long blk = static_cast<long long>(nK) * nK;
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (e >= C * npairs * blk) return;
  const int k = static_cast<int>(e % nK);
  const int m = static_cast<int>((e / nK) % nK);
  const int pair = static_cast<int>((e / blk) % npairs);
  const long long c = e / (blk * npairs);
  int h, g;
  pair_of(pair, &h, &g);
  if (h == g && k > m) return;
  const double* p = partial + (c * S * npairs + pair) * blk + m * nK + k;
  double sum = 0.0;
  for (int s = 0; s < S; ++s) sum += p[s * npairs * blk];
  double out = -sum;
  if (h == g) out += Fg[(alpha[c * nf + h] * blk) + m * nK + k];
  const long long n = static_cast<long long>(nf) * nK;
  const long long r = static_cast<long long>(h) * nK + m;
  const long long q = static_cast<long long>(g) * nK + k;
  H[(c * n + r) * n + q] = out;
  H[(c * n + q) * n + r] = out;
}

}  // namespace

extern "C" int hmsc_gpp_knot(const float* iA, const double* idDW12g,
                             const double* Fg, const float* alphapw,
                             const int* alpha, double* partial, double* H,
                             int C, int np, int nf, int nK, int S,
                             int chunk, void* stream) {
  if (S < 1 || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 0 || nf * nK == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      gpp_knot_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rbands = (nK + kBandRows - 1) / kBandRows;
  const int cbands = (nK + kBandCols - 1) / kBandCols;
  const int npairs = nf * (nf + 1) / 2;
  gpp_knot_partial_kernel<<<dim3(npairs * rbands * cbands, S, C), kThreads,
                            kSmem, st>>>(iA, idDW12g, alphapw, alpha,
                                         partial, np, nf, nK, S, chunk,
                                         rbands, cbands);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(C) * npairs * nK * nK;
  const int threads = 256;
  gpp_knot_sum_kernel<<<static_cast<unsigned>((total + threads - 1) /
                                              threads),
                        threads, 0, st>>>(partial, Fg, alpha, H, C, nf, nK,
                                          S);
  return static_cast<int>(cudaGetLastError());
}
