// B8d-3: the GPP (predictive-process) prior quadratics eta_h' iW eta_h, over
// the alpha grid or at each factor's own alpha, with the location move's
// ones-forms.
//
// Replaces the GPP branches of hmsc_tpu/mcmc/spatial.py:
//   eta_quad_grid (:426-437)   for every grid point g and column (c, h):
//       v = sum_u idDg[g,u] eta^2 - Et' iFg[g] Et,  Et = sum_u eta_u idDW12g[g,u,:]
//       or q_full = eta' eta where alphapw[g, 0] == 0 (W = I);
//   eta_quad_at (:463-478) and eta_ones_forms_at (:519-540) at g = alpha[c,h]:
//       q  = t1 - Ee' iF Ee,          (eta' eta at alpha 0)
//       q1 = sum_u idD - E1' iF E1,   (np at alpha 0)
//       s  = sum_u idD eta - E1' iF Ee (1' eta at alpha 0),
//       E1 = sum_u idDW12g[g,u,:], Ee = Et; written as out[c, h, :] = (q, q1, s).
//
// Numerics: iF = F^-1 is ill-conditioned at large alpha (cond(F) reaches
// 2.6e7 on config 3c's grid), and Et' iF Et is a sum of terms up to 1e7
// times larger than itself; summed in float32, or with iF rounded to
// float32, it is off by up to its own size there (the JAX package's float32
// form is), and the alpha sampler then jumps to the grid's top.  So iFg is
// held in float64 on the device, and the knot sums Et, the quadratic and
// the unit sums are accumulated in double; so is the (G, np, nK) grid
// idDW12g, whose float32 rounding moves the ones-form 1' iW 1 by ~2e-5 of
// itself at the grid's top (mcmc/structs.py · _F64_FIELDS); eta and idDg
// stay float32.  The result is rounded to float32 once, at the end.
//
// What bounds it on the H100: bytes.  In grid mode the float64 grid
// idDW12g (80.8 MB at config 3c: G 101, np 1000, nK 100) is read once for
// all chains and factors, iFg (8.1 MB) and idDg (0.4 MB) once too: 0.027
// ms at 3.35 TB/s, against ~81 M double FMAs (~0.005 ms).  In at-alpha mode
// one 0.9 MB slice per (chain, factor).  The first design (one block per
// grid point, 101 blocks for 132 SMs, two doubles in flight a lane; one
// block per column at alpha) ran at 4.6x and 75x those bounds, held by
// memory-level parallelism.  This design:
//   - pass 1 splits the units over blocks: G x U blocks in grid mode, C nf
//     x U at alpha (ops/spatial.py · _quad_splits, a function of the shape
//     alone: 505 and 256 blocks at config 3c).  A block streams its unit
//     range's rows of the grid slice (contiguous, units x nK doubles)
//     through a ring of 4 shared-memory stages of ~8 KB, each filled by
//     one TMA bulk copy completing on the stage's mbarrier (by 8-byte
//     cp.async from every thread where nK is odd, so rows are not 16-byte
//     aligned; at config 3c on an H100 the bulk copies ran the grid pass in
//     0.0361-0.0362 ms against 0.0396-0.0398 for 8-byte copies, in four
//     rounds taken in turn in one process: scripts/gpp_quad_sweep.py
//     --variants shipped,no_bulk --rounds 4), so three stages are in flight
//     while one is summed;
//     thread (knot k, column group) accumulates its columns' sums over
//     the units in order, reading each unit's weights (eta, or 1 and eta
//     at alpha), staged once in double with their loads in flight
//     together, as one broadcast;
//   - each block writes its partial knot sums, and the unit sums t1 (t_d,
//     t_e at alpha), to a float64 scratch buffer (zeros for a slice at
//     alpha 0, whose grid it does not read: pass 2 reads no scratch that
//     pass 1 left unwritten);
//   - pass 2, one block per grid point (per column at alpha), starts
//     streaming that point's iF rows (a ring of 4 stages of ~5.6 KB: a
//     deeper, larger ring measured slower, scripts/gpp_quad_sweep.py) and
//     loading the U partials before anything else, adds the partials in
//     range order (each thread's loads in flight together: the pass is
//     latency-bound), then sums z = iF' Et with the summed Et as weights
//     and takes Et . z (E1' iF E1 and E1' iF Ee from the same stream),
//     then the alpha-0 selection.
// Every sum is taken in a fixed order (units within a range in order, the
// ranges in order, warp-shuffle trees, warps in order); no atomics, so two
// runs give the same bits.  A call is two launches.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 8;           // weight columns a block carries
constexpr int kStageDoubles = 1024;  // ~8 KB of grid rows a pass 1 stage
constexpr int kStages1 = 4;        // pass 1 ring (units of idDW12g)
constexpr int kStages2 = 4;        // pass 2 ring (rows of iF), stages of
constexpr int kRing2Doubles = 2800;  // ~5.6 KB: small shared memory runs faster

struct QuadArgs {
  const float* eta;      // (C, np, nf)
  const float* idDg;     // (G, np)
  const double* W;       // idDW12g (G, np, nK)
  const double* iFg;     // (G, nK, nK)
  const float* alphapw;  // (G, 2)
  const int* alpha;      // (C, nf), at-alpha mode only
  double* partE;         // (items, U, NQ total, nK) partial knot sums
  double* partT;         // (items, U, sums) partial unit sums
  float* out;
  int C, np, nf, nK, G;
  int U, chunk;  // unit ranges: U ranges of chunk units
  int KT, KG;    // knot lanes a block (32..256, a power of two), groups
  int TU, TR;    // rows a ring stage: of the grid (pass 1), of iF (pass 2)
};

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// eta[c, u, f] of column col = c nf + f
__device__ __forceinline__ long long eta_at(int col, int u, int np, int nf) {
  return (static_cast<long long>(col / nf) * np + u) * nf + col % nf;
}

// R rows of nK doubles (contiguous from src) streamed through a ring of NS
// stages of TU rows, 8-byte cp.async a thread (16-byte copies measured
// slower in pass 2);
// the thread of knot k adds w[r][q0 + i] * row_r[k] to acc[i] over the
// rows in order.  ring_start issues the first NS - 1 stages; ring_run
// waits, refills and sums, and leaves the ring drained.
template <int NS>
__device__ __forceinline__ void ring_issue(const double* __restrict__ src,
                                           int R, int nK, int TU,
                                           double* ring, int st) {
  const int per = TU * nK;
  if (st * TU < R) {
    const int n = min(TU, R - st * TU) * nK;
    const double* s = src + static_cast<long long>(st) * per;
    double* d = ring + (st % NS) * per;
    for (int i = threadIdx.x; i < n; i += kThreads) cp_async8(d + i, s + i);
  }
  cp_commit();
}

template <int NS>
__device__ __forceinline__ void ring_start(const double* __restrict__ src,
                                           int R, int nK, int TU,
                                           double* ring) {
  for (int st = 0; st < NS - 1; ++st) ring_issue<NS>(src, R, nK, TU, ring, st);
}

template <int NS, int QT>
__device__ __forceinline__ void ring_run(const double* __restrict__ src,
                                         int R, int nK, int TU, double* ring,
                                         const double* w, int k, int q0,
                                         double (&acc)[QT]) {
  const int nst = (R + TU - 1) / TU;
  for (int st = 0; st < nst; ++st) {
    cp_wait<NS - 2>();
    __syncthreads();  // stage st landed; stage st - 1 is read no more
    ring_issue<NS>(src, R, nK, TU, ring, st + NS - 1);
    if (k < nK) {
      const double* t = ring + (st % NS) * TU * nK + k;
      const double* wr = w + st * TU * kMaxQ + q0;
      const int rows = min(TU, R - st * TU);
      for (int r = 0; r < rows; ++r) {
        const double x = t[r * nK];
        if constexpr (QT == 1) {
          acc[0] = fma(wr[r * kMaxQ], x, acc[0]);
        } else {
#pragma unroll
          for (int i = 0; i < QT; i += 2) {
            const double2 v =
                *reinterpret_cast<const double2*>(wr + r * kMaxQ + i);
            acc[i] = fma(v.x, x, acc[i]);
            acc[i + 1] = fma(v.y, x, acc[i + 1]);
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();
}

// The same stream with one TMA bulk copy a stage (cp.async.bulk, issued by
// thread 0, its arrival counted on the stage's mbarrier full[st % NS]);
// for rows whose every stage starts and ends 16-byte aligned (nK even):
// the copies cost the threads no instructions and pass 1 no LSU traffic.
__device__ __forceinline__ void bulk_issue(const double* __restrict__ src,
                                           int R, int nK, int TU,
                                           double* ring, unsigned long long* full,
                                           int NS, int st) {
  if (threadIdx.x != 0 || st * TU >= R) return;
  const unsigned bytes =
      static_cast<unsigned>(min(TU, R - st * TU) * nK * sizeof(double));
  const unsigned bar =
      static_cast<unsigned>(__cvta_generic_to_shared(full + st % NS));
  const unsigned dst = static_cast<unsigned>(
      __cvta_generic_to_shared(ring + (st % NS) * TU * nK));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src + static_cast<long long>(st) * TU * nK), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(a), "r"(parity) : "memory");
}

// full[NS] initialised (count 1), then the first NS - 1 stages issued
template <int NS>
__device__ __forceinline__ void bulk_start(const double* __restrict__ src,
                                           int R, int nK, int TU,
                                           double* ring,
                                           unsigned long long* full) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      const unsigned bar =
          static_cast<unsigned>(__cvta_generic_to_shared(full + s));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < NS - 1; ++st)
      bulk_issue(src, R, nK, TU, ring, full, NS, st);
  }
}

template <int NS, int QT>
__device__ __forceinline__ void bulk_run(const double* __restrict__ src,
                                         int R, int nK, int TU, double* ring,
                                         unsigned long long* full,
                                         const double* w, int k, int q0,
                                         double (&acc)[QT]) {
  const int nst = (R + TU - 1) / TU;
  __syncthreads();  // the barriers are initialised before anyone waits
  for (int st = 0; st < nst; ++st) {
    bulk_wait(full + st % NS, (st / NS) & 1);
    __syncthreads();  // stage st - 1 is read no more (and the weights set)
    bulk_issue(src, R, nK, TU, ring, full, NS, st + NS - 1);
    if (k < nK) {
      const double* t = ring + (st % NS) * TU * nK + k;
      const double* wr = w + st * TU * kMaxQ + q0;
      const int rows = min(TU, R - st * TU);
      for (int r = 0; r < rows; ++r) {
        const double x = t[r * nK];
        if constexpr (QT == 1) {
          acc[0] = fma(wr[r * kMaxQ], x, acc[0]);
        } else {
#pragma unroll
          for (int i = 0; i < QT; i += 2) {
            const double2 v =
                *reinterpret_cast<const double2*>(wr + r * kMaxQ + i);
            acc[i] = fma(v.x, x, acc[i]);
            acc[i + 1] = fma(v.y, x, acc[i + 1]);
          }
        }
      }
    }
  }
  __syncthreads();
}

constexpr int kBatch = 8;  // independent global loads a thread issues at once

// The block's weights in shared memory, w[u][q] for its R units from u0
// (zero past NQ): in grid mode eta of columns col0 + q, at alpha (1, eta
// of column col0); and dd[u] = idD[u0 + u] in double.  The loads go kBatch
// at a time, so a thread waits for one latency, not one a unit.
template <bool kGrid>
__device__ __forceinline__ void stage_weights(const QuadArgs& a,
                                              const float* __restrict__ idD,
                                              double* w, double* dd, int col0,
                                              int NQ, int u0, int R) {
  for (int i0 = threadIdx.x; i0 < R * kMaxQ; i0 += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int l = 0; l < kBatch; ++l) {
      const int i = i0 + l * kThreads, u = i / kMaxQ, q = i % kMaxQ;
      const bool ok = i < R * kMaxQ && (kGrid ? q < NQ : q == 1);
      v[l] = ok ? a.eta[eta_at(kGrid ? col0 + q : col0, u0 + u, a.np,
                               a.nf)]
                : (!kGrid && q == 0 ? 1.0f : 0.0f);
    }
#pragma unroll
    for (int l = 0; l < kBatch; ++l) {
      const int i = i0 + l * kThreads;
      if (i < R * kMaxQ) w[i] = v[l];
    }
  }
  for (int u = threadIdx.x; u < R; u += kThreads) dd[u] = idD[u0 + u];
}

// s = sum_{r < U} p[r * stride] in r order, 32 loads in flight
__device__ __forceinline__ double ordered_sum(const double* __restrict__ p,
                                              long long stride, int U) {
  constexpr int kLoads = 32;
  double s = 0.0;
  for (int r0 = 0; r0 < U; r0 += kLoads) {
    double v[kLoads];
#pragma unroll
    for (int l = 0; l < kLoads; ++l)
      v[l] = r0 + l < U ? p[(r0 + l) * stride] : 0.0;
#pragma unroll
    for (int l = 0; l < kLoads; ++l)
      if (r0 + l < U) s += v[l];
  }
  return s;
}

// E[m][q] (q < NQ; zero past it) = the U partial knot sums of column q,
// knot m, added in range order: item (q, m)'s partials at p + q qs + m +
// r ustride.  A thread takes kItems items (q-major) and kLoads of each
// item's partials at a time, all loads of a pass in flight together.
template <int kItems, int kLoads>
__device__ __forceinline__ void sum_partials(const double* __restrict__ p,
                                             long long qs, long long ustride,
                                             int U, int nK, int NQ,
                                             double* E) {
  for (int i = threadIdx.x; i < nK * kMaxQ; i += kThreads)
    if (i % kMaxQ >= NQ) E[i] = 0.0;
  const int n = NQ * nK;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kItems) {
    double s[kItems];
#pragma unroll
    for (int m = 0; m < kItems; ++m) s[m] = 0.0;
    for (int r0 = 0; r0 < U; r0 += kLoads) {
      double v[kItems][kLoads];
#pragma unroll
      for (int m = 0; m < kItems; ++m) {
        const int i = i0 + m * kThreads;
        const bool ok = i < n;
        const double* pi = p + (ok ? (i / nK) * qs + i % nK : 0);
#pragma unroll
        for (int l = 0; l < kLoads; ++l)
          v[m][l] = ok && r0 + l < U ? pi[(r0 + l) * ustride] : 0.0;
      }
#pragma unroll
      for (int m = 0; m < kItems; ++m)
#pragma unroll
        for (int l = 0; l < kLoads; ++l)
          if (r0 + l < U) s[m] += v[m][l];
    }
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const int i = i0 + m * kThreads;
      if (i < n) E[(i % nK) * kMaxQ + i / nK] = s[m];
    }
  }
}

// sum_u f(eta[col, u]) over all np units, 32 loads a lane at a time: each
// lane of a warp over its units in order, then the warp's shuffle tree
// (lane 0 holds it)
template <typename F>
__device__ __forceinline__ double warp_unit_sum(const QuadArgs& a, int col,
                                                F f) {
  constexpr int kLoads = 32;
  const int lane = threadIdx.x % 32;
  double t = 0.0;
  for (int u0 = lane; u0 < a.np; u0 += 32 * kLoads) {
    float v[kLoads];
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int u = u0 + 32 * l;
      v[l] = u < a.np ? a.eta[eta_at(col, u, a.np, a.nf)] : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < kLoads; ++l)
      if (u0 + 32 * l < a.np) t += f(static_cast<double>(v[l]));
  }
  return warp_sum(t);
}

// ---------------------------------------------------------------------------
// grid mode
// ---------------------------------------------------------------------------

// Block (g, unit range us, column group x knot group): the partial knot
// sums sum_u eta[col, u] W[g, u, k] over the range, and the unit sums
// sum_u idD[g, u] eta[col, u]^2.
template <int QT, bool kBulk>
__global__ void __launch_bounds__(kThreads, 4)
    gpp_quad_grid_partial_kernel(QuadArgs a) {
  extern __shared__ __align__(16) double sm[];
  const int g = blockIdx.x, us = blockIdx.y;
  const int cz = blockIdx.z / a.KG, kg = blockIdx.z % a.KG;
  const int ncol = a.C * a.nf;
  const int col0 = cz * kMaxQ, NQ = min(kMaxQ, ncol - col0);
  // W = I at alpha 0 (pass 2 takes eta' eta): no unit, zero sums written
  const int u0 = us * a.chunk;
  const int R = a.alphapw[2 * g] == 0.0f
                    ? 0 : max(0, min(a.np, u0 + a.chunk) - u0);
  double* ring = sm;                                 // [kStages1][TU nK]
  double* w = ring + kStages1 * a.TU * a.nK;         // [chunk][kMaxQ]
  double* dd = w + a.chunk * kMaxQ;                  // [chunk]
  const double* src = a.W + (static_cast<long long>(g) * a.np + u0) * a.nK;
  __shared__ unsigned long long full[kStages1];
  if constexpr (kBulk) bulk_start<kStages1>(src, R, a.nK, a.TU, ring, full);
  else ring_start<kStages1>(src, R, a.nK, a.TU, ring);
  stage_weights<true>(a, a.idDg + static_cast<long long>(g) * a.np, w, dd,
                      col0, NQ, u0, R);
  const int k = kg * a.KT + threadIdx.x % a.KT;
  const int q0 = threadIdx.x / a.KT * QT;
  double acc[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i) acc[i] = 0.0;
  if constexpr (kBulk)
    bulk_run<kStages1, QT>(src, R, a.nK, a.TU, ring, full, w, k, q0, acc);
  else
    ring_run<kStages1, QT>(src, R, a.nK, a.TU, ring, w, k, q0, acc);
  const long long base = (static_cast<long long>(g) * a.U + us) * ncol;
  if (k < a.nK) {
#pragma unroll
    for (int i = 0; i < QT; ++i)
      if (q0 + i < NQ) a.partE[(base + col0 + q0 + i) * a.nK + k] = acc[i];
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (kg == 0 && warp < NQ) {  // warp q: t1 of column col0 + q
    double t = 0.0;
    for (int u = lane; u < R; u += 32) {
      const double e = w[u * kMaxQ + warp];
      t += dd[u] * (e * e);
    }
    t = warp_sum(t);
    if (lane == 0) a.partT[base + col0 + warp] = t;
  }
}

// Block (g, column group): Et and t1 summed over the unit ranges in order,
// then v = t1 - Et' iF Et with z = iF' Et streamed from iF's rows; eta' eta
// where alpha_g = 0.
template <int QT>
__global__ void __launch_bounds__(kThreads, 1)
    gpp_quad_grid_final_kernel(QuadArgs a) {
  extern __shared__ __align__(16) double sm[];
  __shared__ double red[kWarps][kMaxQ];
  __shared__ double t1s[kMaxQ];
  const int g = blockIdx.x, cz = blockIdx.y;
  const int ncol = a.C * a.nf;
  const int col0 = cz * kMaxQ, NQ = min(kMaxQ, ncol - col0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int TR = a.TR;
  double* ring = sm;                          // [kStages2][TR nK]
  double* E = ring + kStages2 * TR * a.nK;    // [nK][kMaxQ]: Et by knot
  const double* iF = a.iFg + static_cast<long long>(g) * a.nK * a.nK;
  const long long base = static_cast<long long>(g) * a.U * ncol;
  const long long ustride = static_cast<long long>(ncol) * a.nK;
  // iF's first stages and the partial sums' loads go out before the
  // alpha-0 test, so its load does not delay them; a block at alpha 0
  // drains the stages and leaves the sums (pass 1's zeros) unused
  ring_start<kStages2>(iF, a.nK, a.nK, TR, ring);
  sum_partials<4, 8>(a.partE + (base + col0) * a.nK, a.nK, ustride, a.U,
                     a.nK, NQ, E);
  if (threadIdx.x < NQ)
    t1s[threadIdx.x] = ordered_sum(a.partT + base + col0 + threadIdx.x, ncol,
                                   a.U);
  if (a.alphapw[2 * g] == 0.0f) {  // W = I: eta' eta, warp q for column q
    cp_wait<0>();
    if (warp < NQ) {
      const double t = warp_unit_sum(a, col0 + warp,
                                     [](double e) { return e * e; });
      if (lane == 0)
        a.out[static_cast<long long>(col0 + warp) * a.G + g] =
            static_cast<float>(t);
    }
    return;
  }
  const int q0 = threadIdx.x / a.KT * QT;
  double t2[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i) t2[i] = 0.0;
  for (int kg = 0; kg < a.KG; ++kg) {
    if (kg > 0) ring_start<kStages2>(iF, a.nK, a.nK, TR, ring);
    const int k = kg * a.KT + threadIdx.x % a.KT;
    double z[QT];
#pragma unroll
    for (int i = 0; i < QT; ++i) z[i] = 0.0;
    ring_run<kStages2, QT>(iF, a.nK, a.nK, TR, ring, E, k, q0, z);
    if (k < a.nK) {
#pragma unroll
      for (int i = 0; i < QT; ++i) t2[i] += z[i] * E[k * kMaxQ + q0 + i];
    }
  }
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    const double v = warp_sum(t2[i]);
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < NQ) {  // column q: its column group's warps in order
    const int q = threadIdx.x, wpg = a.KT / 32, grp = q / QT, i = q % QT;
    double s = 0.0;
    for (int w = grp * wpg; w < (grp + 1) * wpg; ++w) s += red[w][i];
    a.out[static_cast<long long>(col0 + q) * a.G + g] =
        static_cast<float>(t1s[q] - s);
  }
}

// ---------------------------------------------------------------------------
// at-alpha mode: weights (1, eta) give E1 and Ee from one stream
// ---------------------------------------------------------------------------

template <int QT, bool kBulk>
__global__ void __launch_bounds__(kThreads, 4)
    gpp_quad_at_partial_kernel(QuadArgs a) {
  extern __shared__ __align__(16) double sm[];
  const int col = blockIdx.x, us = blockIdx.y, kg = blockIdx.z;
  const long long av = a.alpha[col];
  const int u0 = us * a.chunk;  // alpha 0: no unit, zero sums, as in grid mode
  const int R = a.alphapw[2 * av] == 0.0f
                    ? 0 : max(0, min(a.np, u0 + a.chunk) - u0);
  double* ring = sm;
  double* w = ring + kStages1 * a.TU * a.nK;  // [chunk][kMaxQ]: 1, eta, 0...
  double* dd = w + a.chunk * kMaxQ;           // [chunk]
  const double* src = a.W + (av * a.np + u0) * a.nK;
  __shared__ unsigned long long full[kStages1];
  if constexpr (kBulk) bulk_start<kStages1>(src, R, a.nK, a.TU, ring, full);
  else ring_start<kStages1>(src, R, a.nK, a.TU, ring);
  stage_weights<false>(a, a.idDg + av * a.np, w, dd, col, 2, u0, R);
  const int k = kg * a.KT + threadIdx.x % a.KT;
  const int q0 = threadIdx.x / a.KT * QT;
  double acc[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i) acc[i] = 0.0;
  if constexpr (kBulk)
    bulk_run<kStages1, QT>(src, R, a.nK, a.TU, ring, full, w, k, q0, acc);
  else
    ring_run<kStages1, QT>(src, R, a.nK, a.TU, ring, w, k, q0, acc);
  const long long base = static_cast<long long>(col) * a.U + us;
  if (k < a.nK) {
#pragma unroll
    for (int i = 0; i < QT; ++i)
      if (q0 + i < 2) a.partE[(base * 2 + q0 + i) * a.nK + k] = acc[i];
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (kg == 0 && warp < 3) {  // warps 0, 1, 2: t1, t_d, t_e
    double t = 0.0;
    for (int u = lane; u < R; u += 32) {
      const double d = dd[u], e = w[u * kMaxQ + 1];
      t += warp == 0 ? d * (e * e) : warp == 1 ? d : d * e;
    }
    t = warp_sum(t);
    if (lane == 0) a.partT[base * 3 + warp] = t;
  }
}

__device__ double block_sum(double v, double* scratch) {
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by the previous sum
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) t += scratch[w];
  return t;
}

template <int QT>
__global__ void __launch_bounds__(kThreads, 1)
    gpp_quad_at_final_kernel(QuadArgs a) {
  extern __shared__ __align__(16) double sm[];
  __shared__ double scratch[kWarps];
  __shared__ double ts[3];
  const int col = blockIdx.x;
  const long long av = a.alpha[col];
  const int TR = a.TR;
  double* ring = sm;
  double* E = ring + kStages2 * TR * a.nK;  // [nK][kMaxQ]: E1, Ee, 0...
  const double* iF = a.iFg + av * a.nK * a.nK;
  const long long base = static_cast<long long>(col) * a.U;
  ring_start<kStages2>(iF, a.nK, a.nK, TR, ring);  // as in grid mode
  sum_partials<1, 32>(a.partE + base * 2 * a.nK, a.nK, 2LL * a.nK, a.U, a.nK,
                      2, E);
  if (threadIdx.x < 3)
    ts[threadIdx.x] = ordered_sum(a.partT + base * 3 + threadIdx.x, 3, a.U);
  if (a.alphapw[2 * av] == 0.0f) {  // W = I: (eta' eta, np, 1' eta)
    cp_wait<0>();
    const int warp = threadIdx.x / 32;  // warp 0 eta' eta, warp 1 1' eta
    double t = 0.0;
    if (warp == 0) t = warp_unit_sum(a, col, [](double e) { return e * e; });
    if (warp == 1) t = warp_unit_sum(a, col, [](double e) { return e; });
    if (threadIdx.x == 32) scratch[0] = t;
    __syncthreads();
    const double q = t, s = scratch[0];
    if (threadIdx.x == 0) {
      a.out[3 * col] = static_cast<float>(q);
      a.out[3 * col + 1] = static_cast<float>(a.np);
      a.out[3 * col + 2] = static_cast<float>(s);
    }
    return;
  }
  const int q0 = threadIdx.x / a.KT * QT;
  double f11 = 0.0, f1e = 0.0, fee = 0.0;
  for (int kg = 0; kg < a.KG; ++kg) {
    if (kg > 0) ring_start<kStages2>(iF, a.nK, a.nK, TR, ring);
    const int k = kg * a.KT + threadIdx.x % a.KT;
    double z[QT];
#pragma unroll
    for (int i = 0; i < QT; ++i) z[i] = 0.0;
    ring_run<kStages2, QT>(iF, a.nK, a.nK, TR, ring, E, k, q0, z);
    if (k < a.nK) {
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        if (q0 + i == 0) {  // z = iF' E1
          f11 += z[i] * E[k * kMaxQ];
          f1e += z[i] * E[k * kMaxQ + 1];
        } else if (q0 + i == 1) {  // z = iF' Ee
          fee += z[i] * E[k * kMaxQ + 1];
        }
      }
    }
  }
  f11 = block_sum(f11, scratch);
  f1e = block_sum(f1e, scratch);
  fee = block_sum(fee, scratch);
  if (threadIdx.x == 0) {
    a.out[3 * col] = static_cast<float>(ts[0] - fee);
    a.out[3 * col + 1] = static_cast<float>(ts[1] - f11);
    a.out[3 * col + 2] = static_cast<float>(ts[2] - f1e);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// knot lanes: the power of two >= nK in [32, 256]; the rest of the block's
// 256 threads are column groups
int knot_lanes(int nK) {
  int kt = 32;
  while (kt < nK && kt < kThreads) kt *= 2;
  return kt;
}

// columns a thread carries: NQ over the column groups, a power of two
int columns_a_thread(int NQ, int KT) {
  const int groups = kThreads / KT;
  const int need = (NQ + groups - 1) / groups;
  int qt = 1;
  while (qt < need) qt *= 2;
  return qt;
}

template <typename Kern>
cudaError_t launch(Kern kern, dim3 grid, size_t smem, const QuadArgs& a,
                   cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int QT, bool kBulk>
cudaError_t launch_mode(bool grid_mode, const QuadArgs& a, int items,
                        int groups, cudaStream_t st) {
  const size_t ring1 = sizeof(double) * (kStages1 * a.TU * a.nK +
                                         static_cast<size_t>(a.chunk) *
                                             (kMaxQ + 1));
  const size_t ring2 = sizeof(double) * (kStages2 * a.TR * a.nK +
                                         static_cast<size_t>(a.nK) * kMaxQ);
  cudaError_t e;
  if (grid_mode) {
    e = launch(gpp_quad_grid_partial_kernel<QT, kBulk>,
               dim3(items, a.U, groups * a.KG), ring1, a, st);
    if (e != cudaSuccess) return e;
    return launch(gpp_quad_grid_final_kernel<QT>, dim3(items, groups), ring2,
                  a, st);
  }
  e = launch(gpp_quad_at_partial_kernel<QT, kBulk>, dim3(items, a.U, a.KG),
             ring1, a,
             st);
  if (e != cudaSuccess) return e;
  return launch(gpp_quad_at_final_kernel<QT>, dim3(items), ring2, a, st);
}

int run(bool grid_mode, QuadArgs a, int NQ, int items, int groups,
        void* stream) {
  a.KT = knot_lanes(a.nK);
  a.KG = (a.nK + a.KT - 1) / a.KT;
  a.TU = a.nK >= kStageDoubles ? 1 : kStageDoubles / a.nK;
  a.TR = a.nK >= kRing2Doubles ? 1 : kRing2Doubles / a.nK;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // whole 16-byte-aligned stages for the bulk copies
  const bool bulk = a.nK % 2 == 0 &&
                    reinterpret_cast<unsigned long long>(a.W) % 16 == 0;
  switch (columns_a_thread(NQ, a.KT) * 2 + (bulk ? 1 : 0)) {
    case 2: return static_cast<int>(launch_mode<1, false>(grid_mode, a, items, groups, st));
    case 3: return static_cast<int>(launch_mode<1, true>(grid_mode, a, items, groups, st));
    case 4: return static_cast<int>(launch_mode<2, false>(grid_mode, a, items, groups, st));
    case 5: return static_cast<int>(launch_mode<2, true>(grid_mode, a, items, groups, st));
    case 8: return static_cast<int>(launch_mode<4, false>(grid_mode, a, items, groups, st));
    case 9: return static_cast<int>(launch_mode<4, true>(grid_mode, a, items, groups, st));
    case 16: return static_cast<int>(launch_mode<8, false>(grid_mode, a, items, groups, st));
    case 17: return static_cast<int>(launch_mode<8, true>(grid_mode, a, items, groups, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// scratch: float64, G U C nf (nK + 1) entries (ops/spatial.py · _quad_splits
// gives U and chunk)
extern "C" int hmsc_gpp_quad_grid(const float* eta, const float* idDg,
                                  const double* idDW12g, const double* iFg,
                                  const float* alphapw, double* scratch,
                                  float* out, int C, int np, int nf, int nK,
                                  int G, int U, int chunk, void* stream) {
  const int ncol = C * nf;
  if (ncol == 0 || G == 0) return 0;
  if (nK < 1 || U < 1 || chunk < 1 || (U - 1) * chunk >= (np > 0 ? np : 1) ||
      chunk > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  QuadArgs a{};
  a.eta = eta; a.idDg = idDg; a.W = idDW12g; a.iFg = iFg;
  a.alphapw = alphapw; a.alpha = nullptr; a.out = out;
  a.C = C; a.np = np; a.nf = nf; a.nK = nK; a.G = G; a.U = U;
  a.chunk = chunk;
  a.partE = scratch;
  a.partT = scratch + static_cast<long long>(G) * U * ncol * nK;
  const int groups = (ncol + kMaxQ - 1) / kMaxQ;
  return run(true, a, ncol < kMaxQ ? ncol : kMaxQ, G, groups, stream);
}

// scratch: float64, C nf U (2 nK + 3) entries
extern "C" int hmsc_gpp_quad_at(const float* eta, const float* idDg,
                                const double* idDW12g, const double* iFg,
                                const float* alphapw, const int* alpha,
                                double* scratch, float* out, int C, int np,
                                int nf, int nK, int U, int chunk,
                                void* stream) {
  const int ncol = C * nf;
  if (ncol == 0) return 0;
  if (nK < 1 || U < 1 || chunk < 1 || (U - 1) * chunk >= (np > 0 ? np : 1) ||
      chunk > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  QuadArgs a{};
  a.eta = eta; a.idDg = idDg; a.W = idDW12g; a.iFg = iFg;
  a.alphapw = alphapw; a.alpha = alpha; a.out = out;
  a.C = C; a.np = np; a.nf = nf; a.nK = nK; a.G = 0; a.U = U;
  a.chunk = chunk;
  a.partE = scratch;
  a.partT = scratch + static_cast<long long>(ncol) * U * 2 * nK;
  return run(false, a, 2, ncol, 1, stream);
}
