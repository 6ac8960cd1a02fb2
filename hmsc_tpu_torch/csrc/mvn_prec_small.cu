// B2: a batch of draws x ~ N(P^{-1} rhs, P^{-1}) from small SPD precisions
// (P <= 16), a group of P lanes a system, with the sampler's precision
// assembly formed in the kernel.
//
// Replaces hmsc_tpu/ops/linalg.py · sample_mvn_prec_batched (P <= 16), the
// unrolled Cholesky that the JAX package laid out with the batch as the
// TPU's vector dimension, and the assembly in front of it:
//   - element form: prec and rhs as given (the JAX op's own signature);
//   - identity form (the unstructured Eta draw, hmsc_tpu/mcmc/updaters.py ·
//     update_eta_nonspatial): prec_b = I + s_b G, with G one nf x nf gram a
//     chain (lambda iSigma lambda') and s_b the unit's row count, or with
//     missing values G the unit's own gram and s_b = 1; rhs_b = F_b;
//   - BetaLambda form (update_beta_lambda): prec_b = D_b + iSigma_j G, with
//     G the chain's gram XE'XE (or species j's masked gram, kernel B6) and
//     D_b = blkdiag(iV, diag(psi tau)_j); rhs_b = D_b mu0_b + iSigma_j
//     rhs_lik_b, mu0_b = [Gamma Tr'_j; 0].
// eps is passed in, or drawn from Philox in the kernel (element b P + i of
// the (batch, P) array at the launch's offset, one Box-Muller draw each).
//
// What bounds it on the H100: latency.  At the headline the batch is 4
// chains x 1000 systems of P = 8 or 10; the shared-gram forms read ~0.1
// MB, the element form ~1.8 MB, and the ~P^3/6 operations a system are
// negligible.  The first version ran one system a thread (4000 threads,
// one warp on each of 32 SMs, each thread a ~P^3/6-step dependent chain,
// and a warp's loads touching 32 cache lines): 0.00515 ms, against a byte
// bound of 0.00062 (scripts/older/mvn_prec_small.cu).  Design
// (scripts/mvn_prec_sweep.py times each part):
//   - a system a group of P lanes, floor(32 / P) systems a warp, blocks of
//     4 warps, lane i owning row i of the matrix in registers (arrays sized
//     by the template parameter P, so no index is dynamic);
//   - a lane's own loads (right-hand side, eps, scale, iV's row, prior,
//     Gamma, Tr) issued first, then the block's per-system matrices, all
//     in flight together (a batch of registers a thread) and stored to
//     shared memory in 128-byte runs (rows padded to an odd stride); a
//     chain's shared gram read directly (cached, one per chain);
//   - the assembly in registers: D_b + s_b G row by row, the BetaLambda
//     prior mean (iV Gamma Tr'_j) by shuffles over the lanes of the iV
//     block;
//   - a right-looking Cholesky: column j's pivot and each L_kj broadcast
//     by __shfl_sync, each lane scaling and updating its own row, so every
//     entry gets the JAX op's updates in its order (s - L_ik L_jk in k
//     order, the jitter (1e-6 / P) x the trace summed in index order added
//     first); the pivot's reciprocal one correctly rounded rsqrt (1 / sqrtf
//     rounded twice, as the JAX op has it, took 0.0017 ms more); the
//     forward solve L y = rhs folded into the columns (each y_i's updates
//     in k order); the back solve L' x = y + eps in the JAX op's order too,
//     from L's columns (the rows written to shared memory, a lane reading
//     its column back).
// sqrtf of a negative pivot is NaN and reaches the whole row of the result,
// which divergence containment relies on (hmsc_tpu/ops/linalg.py:95).
// Every sum has a fixed order; reruns give the same bits.

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

// blocks of 4 warps: at the headline's 4000 systems of P 10, 334 blocks
// spread the warps more evenly over the 132 SMs than 167 blocks of 8
// (BetaLambda 0.00401 ms against 0.00444, scripts/mvn_prec_sweep.py)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Form { kElement = 0, kIdentity = 1, kBetaLambda = 2 };

struct MvnArgs {
  const float* G;        // element: (batch, P, P); else (C, 1 or nsys, P, P)
  int g_shared;          // 1: one G a chain (stride 0 over its systems)
  const float* scale;    // s_b, or null for 1: (C, nsys) or (nsys,)
  int scale_chain;       // 1: scale is (C, nsys)
  const float* rhs;      // (batch, P): rhs, F, or rhs_lik
  const float* iV;       // BetaLambda: (C, nc, nc)
  const float* prior;    // BetaLambda: (C, P - nc, nsys)
  const float* Gamma;    // BetaLambda: (C, nc, nt)
  const float* Tr;       // BetaLambda: (nsys, nt)
  int nc, nt;
  const float* eps;      // (batch, P) or null: Philox
  float* out;            // (batch, P)
  long long batch;       // C nsys
  int nsys;
  float jitter_over_p;
  uint2 key;
  unsigned offset;
  int nsys_g, sys_off;   // Philox counters: system j of chain c counts as
                         // c nsys_g + sys_off + j (a site mesh's rank: its
                         // block of the level's units); nsys and 0 else
};

template <int P, int FORM>
__global__ void __launch_bounds__(kThreads)
mvn_prec_small_kernel(const MvnArgs a) {
  constexpr int GPW = 32 / P;                    // systems a warp
  constexpr int LD = P % 2 == 0 ? P + 1 : P;     // odd row stride
  constexpr int SPB = GPW * kWarps;              // systems a block
  constexpr int kLoads = (SPB * P * P + kThreads - 1) / kThreads;
  __shared__ float tile[SPB * P * LD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp0 = lane / P;
  const bool live_lane = grp0 < GPW;
  const int grp = live_lane ? grp0 : 0;
  const int i = live_lane ? lane - grp0 * P : 0;  // the row this lane owns
  const int base = grp * P;                       // the group's first lane
  const int sys = warp * GPW + grp;               // system in the block
  const long long b0 = static_cast<long long>(blockIdx.x) * SPB;
  const long long b = b0 + sys;
  const bool live = live_lane && b < a.batch;
  const long long bb = b < a.batch ? b : a.batch - 1;   // clamped for loads
  const int c = static_cast<int>(bb / a.nsys);
  const int j = static_cast<int>(bb - static_cast<long long>(c) * a.nsys);
  float* my_tile = tile + (sys * P) * LD;

  // the lane's own loads first, then the block's matrices: all in flight
  // together
  float r = __ldg(a.rhs + bb * P + i);
  const float e_in = a.eps != nullptr ? __ldg(a.eps + bb * P + i) : 0.0f;
  const float s = FORM == kElement || a.scale == nullptr
                      ? 1.0f
                      : __ldg(a.scale + (a.scale_chain ? bb : j));
  float ivr[P];                                  // BetaLambda: iV's row i
  float pr = 0.0f, mu_i = 0.0f;                  // prior; (Gamma Tr')_ij
  if (FORM == kBetaLambda) {
    const int nc = a.nc, nt = a.nt;
    const float* iv = a.iV + (static_cast<long long>(c) * nc + i) * nc;
#pragma unroll
    for (int k = 0; k < P; ++k) ivr[k] = k < nc && i < nc ? __ldg(iv + k) : 0.0f;
    if (i < nc) {
      const float* gm = a.Gamma + (static_cast<long long>(c) * nc + i) * nt;
      const float* tr = a.Tr + static_cast<long long>(j) * nt;
      mu_i = __ldg(gm) * __ldg(tr);
#pragma unroll 4
      for (int t = 1; t < nt; ++t) mu_i = fmaf(__ldg(gm + t), __ldg(tr + t), mu_i);
    } else {
      pr = __ldg(a.prior +
                 (static_cast<long long>(c) * (P - nc) + (i - nc)) * a.nsys + j);
    }
  }
  float row[P];
  if (!a.g_shared) {
    const int nb = static_cast<int>(a.batch - b0 < SPB ? a.batch - b0 : SPB);
    const int total = nb * P * P;
    const float* src = a.G + b0 * P * P;
    float v[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int t = threadIdx.x + q * kThreads;
      v[q] = t < total ? __ldg(src + t) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int t = threadIdx.x + q * kThreads;
      if (t < total) tile[(t / P) * LD + t % P] = v[q];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < P; ++k) row[k] = my_tile[i * LD + k];
  } else {
    const float* g = a.G + static_cast<long long>(c) * P * P + i * P;
#pragma unroll
    for (int k = 0; k < P; ++k) row[k] = __ldg(g + k);
  }

  // the precision's row i and the right-hand side
  if (FORM == kIdentity) {
#pragma unroll
    for (int k = 0; k < P; ++k) row[k] = fmaf(s, row[k], k == i ? 1.0f : 0.0f);
  } else if (FORM == kBetaLambda) {
    float dot = 0.0f;                            // (iV mu)_i, q in order
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float mq = __shfl_sync(kFull, mu_i, base + q);
      if (q < a.nc) dot = fmaf(ivr[q], mq, dot);
    }
#pragma unroll
    for (int k = 0; k < P; ++k)
      row[k] = fmaf(s, row[k], i < a.nc ? ivr[k] : (k == i ? pr : 0.0f));
    r = fmaf(s, r, dot);
  }

  // eps from Philox (drawn before the loads are issued it took longer:
  // scripts/mvn_prec_sweep.py)
  float e = e_in;
  if (a.eps == nullptr) {
    const long long n =
        (static_cast<long long>(c) * a.nsys_g + a.sys_off + j) * P + i;
    const uint4 u = hmsc::philox4x32_10(
        make_uint4(static_cast<unsigned>(n), static_cast<unsigned>(n >> 32),
                   a.offset, 0u),
        a.key);
    e = hmsc::box_muller(u.x, u.y);
  }

  // jitter: (1e-6 / P) x the trace, summed in index order, added first
  float diag = row[0];
#pragma unroll
  for (int k = 1; k < P; ++k) diag = k == i ? row[k] : diag;
  float trace = __shfl_sync(kFull, diag, base);
#pragma unroll
  for (int k = 1; k < P; ++k) trace = trace + __shfl_sync(kFull, diag, base + k);
  const float bump = a.jitter_over_p * trace;
#pragma unroll
  for (int k = 0; k < P; ++k) row[k] = k == i ? row[k] + bump : row[k];

  // right-looking Cholesky, row[k] (k < i) becoming L_ik, with the forward
  // solve L y = rhs folded in: column jj's y_jj is lane jj's r once the
  // column's pivot is known, and every lane below takes its update then.
  // The next column's pivot is lane jj+1's diagonal after this column's
  // update, formed and broadcast ahead of the other lanes' updates
  float inv_i = 0.0f, y_i = 0.0f;
  float piv = __shfl_sync(kFull, row[0], base);
#pragma unroll
  for (int jj = 0; jj < P; ++jj) {
    // 1 / sqrt(pivot) correctly rounded: NaN if indefinite
    const float inv = __frsqrt_rn(piv);
    if (i == jj) inv_i = inv;
    row[jj] = row[jj] * inv;
    if (jj + 1 < P) {
      const float nd = row[jj + 1] - row[jj] * row[jj];
      piv = __shfl_sync(kFull, nd, base + jj + 1);
      if (i == jj + 1) row[jj + 1] = nd;
    }
    const float yj = __shfl_sync(kFull, r * inv, base + jj);
    if (i == jj) y_i = yj;
    if (i > jj) r = r - row[jj] * yj;
#pragma unroll
    for (int k = jj + 1; k < P; ++k) {
      const float lkj = __shfl_sync(kFull, row[jj], base + k);
      if (k != jj + 1 || i != k) row[k] = row[k] - row[jj] * lkj;
    }
  }

  // back solve L' x = y + eps in the JAX op's order: x_m = (y_m + eps_m -
  // sum_{k > m} L_km x_k) / L_mm, k ascending, from L's column m
  // (a warp writes only its own systems' rows, read only by itself)
  __syncwarp();
  if (live_lane) {
#pragma unroll
    for (int k = 0; k < P; ++k) my_tile[i * LD + k] = row[k];
  }
  __syncwarp();
  float col[P];
#pragma unroll
  for (int k = 0; k < P; ++k) col[k] = my_tile[k * LD + i];
  const float z = y_i + e;
  float xk[P];
  float x_i = 0.0f;
#pragma unroll
  for (int m = P - 1; m >= 0; --m) {
    float t = z;
#pragma unroll
    for (int k = m + 1; k < P; ++k) t = t - col[k] * xk[k];
    xk[m] = __shfl_sync(kFull, t * inv_i, base + m);
    if (i == m) x_i = xk[m];
  }
  if (live) a.out[bb * P + i] = x_i;
}

template <int P, int FORM>
int launch_form(const MvnArgs& a, cudaStream_t stream) {
  constexpr int SPB = (32 / P) * kWarps;
  const unsigned blocks = static_cast<unsigned>((a.batch + SPB - 1) / SPB);
  mvn_prec_small_kernel<P, FORM><<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch(const MvnArgs& a, int form, cudaStream_t stream) {
  switch (form) {
    case kElement: return launch_form<P, kElement>(a, stream);
    case kIdentity: return launch_form<P, kIdentity>(a, stream);
    case kBetaLambda: return launch_form<P, kBetaLambda>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// form 0 element, 1 identity, 2 BetaLambda; batch = C nsys systems of
// P <= 16.  A null eps draws Philox normals at (seed, offset), element i of
// system j of chain c from counter (c nsys_g + sys_off + j) P + i.
extern "C" int hmsc_mvn_prec_small(const float* G, int g_shared,
                                   const float* scale, int scale_chain,
                                   const float* rhs, const float* iV,
                                   const float* prior, const float* Gamma,
                                   const float* Tr, int nc, int nt,
                                   const float* eps, float* out,
                                   long long batch, int nsys, int P, int form,
                                   int nsys_g, int sys_off,
                                   unsigned long long seed, unsigned offset,
                                   void* stream) {
  if (batch < 1 || nsys < 1 || batch % nsys != 0 || sys_off < 0 ||
      sys_off + nsys > nsys_g ||
      (form == kBetaLambda && (nc < 1 || nc > P || nt < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (1e-6 / P) in double, then rounded: the JAX op's Python-float factor
  MvnArgs a{G, g_shared, scale, scale_chain, rhs, iV, prior, Gamma, Tr,
            nc, nt, eps, out, batch, nsys,
            static_cast<float>(1e-6 / P), hmsc::seed_key(seed), offset,
            nsys_g, sys_off};
  switch (P) {
    case 1: return launch<1>(a, form, s);
    case 2: return launch<2>(a, form, s);
    case 3: return launch<3>(a, form, s);
    case 4: return launch<4>(a, form, s);
    case 5: return launch<5>(a, form, s);
    case 6: return launch<6>(a, form, s);
    case 7: return launch<7>(a, form, s);
    case 8: return launch<8>(a, form, s);
    case 9: return launch<9>(a, form, s);
    case 10: return launch<10>(a, form, s);
    case 11: return launch<11>(a, form, s);
    case 12: return launch<12>(a, form, s);
    case 13: return launch<13>(a, form, s);
    case 14: return launch<14>(a, form, s);
    case 15: return launch<15>(a, form, s);
    case 16: return launch<16>(a, form, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
