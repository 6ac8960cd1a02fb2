// B4: the GammaV block -- iV ~ Wishart, then Gamma | Beta, iV -- in one
// launch, a block a chain.
//
// Replaces hmsc_tpu/ops/rand.py · wishart with the block around it,
// hmsc_tpu/mcmc/updaters.py · update_gamma_v and gamma_given_beta, on the
// branch without phylogeny and without tenants (every model the port
// samples):
//
//   E    = Beta - Gamma Tr'                              (nc, ns)
//   A    = E E',  BT = Beta Tr                           (nc, nc), (nc, nt)
//   Lw   = chol(A + V0),  T = Lw^-T                      (T T' = (A+V0)^-1)
//   B    = tril(normals, -1) + diag(sqrt(2 g)),  g_i ~ Ga((df - i) / 2)
//   iV   = (T B)(T B)'                                   (Bartlett)
//   prec = iUGamma + kron(Tr'Tr, iV),  rhs = iUGamma mGamma + vec((iV BT)')
//   L    = chol(prec),  gvec = L^-T (L^-1 rhs + eps),  Gamma = gvec (nt, nc)'
//
// with df = f0 + ns and chol_spd's relative jitter (1e-6 x the mean
// diagonal) on both factorisations.  A matrix that is not positive
// definite (a pivot that is not > 0, or NaN) makes the whole factor NaN,
// as ops/linalg.py · chol_spd does, so a NaN in Beta gives NaN in iV and
// Gamma and never an error.  Tr'Tr and iUGamma mGamma are the model data's
// constants (mcmc/structs.py).
//
// The draws: g_i at the Philox counter B3's element form
// (csrc/standard_gamma.cu) gives element c nc + i of a (C, nc) array at
// the launch's first offset, so the element form at the same (seed,
// offset) gives the same unit draws; the strictly lower normals (element
// (c, a, b) of a (C, nc, nc) array) at the second offset, eps (element
// (c, p) of (C, nc nt)) at the third, each one Box-Muller draw a counter.
// Any of the three may be passed in instead (the updaters' `noise` hook),
// which is how chip_smoke.py holds the kernel against the plain update.
//
// What bounds it on the H100: latency.  The bytes (Beta, Tr, Gamma in; iV
// and Gamma out) are ~12 KB at the headline's C 4, nc 2, nt 1, ns 1000;
// the operations are the species sums, (nc (nc+1)/2 + nc nt) ns
// multiply-adds a chain, and two small factorisations whose dependent
// chains are n steps long.  It replaces ~45 small launches a sweep (the
// sums, two chol_spd, a triangular inverse, the Bartlett draw through B3's
// element form, the kron, three triangular solves).  Design
// (scripts/gamma_v_sweep.py times each part):
//   - one block of 512 threads a chain; every global read before the
//     first barrier is a cp.async (the species' Beta and Tr, Gamma, V0,
//     Tr'Tr, iUGamma, iUGamma mGamma), so a thread's copies are in flight
//     together: one round trip, where loads stored one after another cost
//     a round trip each (2.2 us at the headline);
//   - the species are staged in one pass where 40 K floats allow (the
//     headline's 1000 at once), each warp owning whole entries of A (lower
//     triangle) and BT: its lanes sum the species j = lane (mod 32) in
//     ascending order, an entry at a time, then a fixed xor-shuffle tree.
//     Every sum has one owner and one order, no atomics, so reruns give
//     the same bits;
//   - warp 0 then factorises A + V0 (a lane a row, right-looking: column
//     j's pivot read by every lane, each lane scaling and updating its own
//     row, so each entry gets its updates in column order) and forms T a
//     lane a column, while warps 1-3 draw the Bartlett factor and eps;
//   - the rest runs on one warp (two above 32 rows, joined by a named
//     barrier): the Bartlett product and iV, the (nt nc)^2 precision a
//     thread an entry, its factorisation a thread a row the same way, then
//     the forward and back solves a column at a time.
// At the headline the species pass takes ~4 us of its ~8.7, the Wishart
// ~2 and Gamma | Beta ~2 (an H100 SXM at 700 W, scripts/gamma_v_sweep.py);
// the cap (nc 16, nt 4, ns 5000) takes ~0.16 ms on one SM a chain, most of
// it the species pass.
//
// The bf16 form (a non-null Tr16, the bfloat16 shadow of Tr: the GammaV
// block under a precision policy, hmsc_tpu/mcmc/updaters.py:444-512 with
// every mx product bf16 in, float32 out) rounds exactly where the JAX mx
// calls round: E, formed in float32 from the float32 Tr, is rounded for
// E E'; iV and Beta are rounded for iV Beta, that float32 product is
// rounded again for (iV Beta) Tr with Tr read from its shadow, a second
// species pass after the Wishart draw (the float32 form sums Beta Tr in
// the first pass and multiplies by iV after); Tr'Tr comes in from the
// caller, formed once a run from the shadow.  Both factorisations, the
// Bartlett draws and the Gaussian draw stay float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gamma.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// the staging area's budget: up to this many floats of Beta, E and Tr a
// pass, in whole warps' worth of species (the headline's 1000 species in
// one pass)
constexpr int kStageFloats = 40 * 1024;
constexpr int kMaxNc = 16;
constexpr int kMaxN = 64;              // nt nc
// entries a warp owns: (16 * 17 / 2 + 64) / 16, rounded up
constexpr int kMaxEntries = 13;

struct GammaVArgs {
  const float* Beta;     // (C, nc, ns)
  const float* Gamma;    // (C, nc, nt)
  const float* Tr;       // (ns, nt)
  const __nv_bfloat16* Tr16;  // (ns, nt) the bf16 form's shadow, or null
  const float* V0;       // (nc, nc)
  const float* TtT;      // (nt, nt)
  const float* iUG;      // (n, n), n = nc nt
  const float* iUGmG;    // (n,)
  const float* normal;   // (C, nc, nc) or null: Philox
  const float* gamma;    // (C, nc) or null
  const float* eps;      // (C, n) or null
  float* iV;             // (C, nc, nc)
  float* Gamma_out;      // (C, nc, nt)
  int nc, nt, ns, chunk;           // chunk: species staged a pass
  float df;
  uint2 key;
  unsigned off_gamma, off_normal, off_eps;
};

// A barrier for the first `nthreads` threads of the block (a multiple of
// 32): the warp's own below 33 rows, else named barrier 1.
__device__ __forceinline__ void rows_sync(int nthreads) {
  if (nthreads <= 32)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// In-place Cholesky of the n x n matrix S (row stride ld, lower triangle
// read and written), thread i a row, run by the first `nsync` threads.
// chol_spd's jitter: 1e-6 x the mean diagonal.  inv[j] = 1 / L_jj; the
// diagonal of S keeps the last pivots.  Not positive definite: NaN in the
// whole lower triangle and in inv.
__device__ void chol_rows(float* S, int ld, int n, float* inv, int i,
                          int nsync) {
  float tr = S[0];
  for (int k = 1; k < n; ++k) tr += S[k * ld + k];
  const float bump = 1e-6f * (tr / static_cast<float>(n));
  rows_sync(nsync);
  if (i < n) S[i * ld + i] += bump;
  bool bad = false;
  for (int j = 0; j < n; ++j) {
    rows_sync(nsync);                    // column j has all its updates
    const float p = S[j * ld + j];
    const float r = 1.0f / sqrtf(p);
    bad = bad || !(p > 0.0f);
    if (i > j && i < n) S[i * ld + j] *= r;
    if (i == j) inv[j] = r;
    rows_sync(nsync);                    // column j of L is written
    if (i > j && i < n) {
      // row i's updates, four at a time with their loads issued first
      const float lij = S[i * ld + j];
      float* row = S + i * ld;
      int k = j + 1;
      for (; k + 3 <= i; k += 4) {
        const float c0 = S[k * ld + j], c1 = S[(k + 1) * ld + j],
                    c2 = S[(k + 2) * ld + j], c3 = S[(k + 3) * ld + j];
        const float s0 = row[k], s1 = row[k + 1], s2 = row[k + 2],
                    s3 = row[k + 3];
        row[k] = fmaf(-lij, c0, s0);
        row[k + 1] = fmaf(-lij, c1, s1);
        row[k + 2] = fmaf(-lij, c2, s2);
        row[k + 3] = fmaf(-lij, c3, s3);
      }
      for (; k <= i; ++k) row[k] = fmaf(-lij, S[k * ld + j], row[k]);
    }
  }
  rows_sync(nsync);
  if (bad && i < n) {
    for (int k = 0; k <= i; ++k) S[i * ld + k] = __int_as_float(0x7fc00000);
    inv[i] = __int_as_float(0x7fc00000);
  }
  rows_sync(nsync);
}

__device__ __forceinline__ float philox_normal(long long i, uint2 key,
                                               unsigned offset) {
  const uint4 b = hmsc::philox4x32_10(
      make_uint4(static_cast<unsigned>(i), static_cast<unsigned>(i >> 32),
                 offset, 0u),
      key);
  return hmsc::box_muller(b.x, b.y);
}

// A 4-byte copy from global to shared memory with no register round trip
// (cp.async), so that a thread's copies are all in flight at once.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x rounded to bfloat16 (nearest even) and widened: what an mx product
// reads
__device__ __forceinline__ float rd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
gamma_v_kernel(const GammaVArgs a) {
  extern __shared__ float sm[];
  const int nc = a.nc, nt = a.nt, ns = a.ns, n = nc * nt, CH = a.chunk;
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the first pass's entries: A's lower triangle, then (float32 form) BT
  const int nA = nc * (nc + 1) / 2, nout = nA + (kBf16 ? 0 : nc * nt);
  // the staging area, reused for the (n, n + 1) precision afterwards
  const int stage = (2 * nc + nt) * CH;
  const int region = stage > n * (n + 1) ? stage : n * (n + 1);
  float* Bs = sm;                        // (nc, CH) Beta
  float* Es = Bs + nc * CH;              // (nc, CH) E
  float* Ts = Es + nc * CH;              // (nt, CH) Tr transposed
  float* Ps = sm;                        // (n, n + 1) the precision
  float* As = sm + region;               // (nc, nc) E E', then A + V0, Lw
  float* BTs = As + nc * nc;             // (nc, nt) Beta Tr
  float* Gs = BTs + nc * nt;             // (nc, nt) Gamma
  float* Tm = Gs + nc * nt;              // (nc, nc) T
  float* Bb = Tm + nc * nc;              // (nc, nc) the Bartlett factor
  float* TA = Bb + nc * nc;              // (nc, nc)
  float* iVs = TA + nc * nc;             // (nc, nc)
  float* invw = iVs + nc * nc;           // (nc) 1 / Lw_jj
  float* invp = invw + nc;               // (n) 1 / L_jj
  float* xs = invp + n;                  // (n) y, then x
  float* es = xs + n;                    // (n) eps
  float* V0s = es + n;                   // (nc, nc) the constants, staged
  float* TtTs = V0s + nc * nc;           // (nt, nt)    with the species
  float* iUGs = TtTs + nt * nt;          // (n, n)
  float* iUGmGs = iUGs + n * n;          // (n)

  const float* Beta = a.Beta + static_cast<long long>(c) * nc * ns;
  // Gamma and the model's constants, copied beside the first pass's
  // species (all of a thread's copies in flight together; the pass's wait
  // and barrier cover them)
  for (int t = tid; t < nc * nt; t += kThreads)
    cp_async4(Gs + t, a.Gamma + static_cast<long long>(c) * nc * nt + t);
  for (int t = tid; t < nc * nc; t += kThreads) cp_async4(V0s + t, a.V0 + t);
  for (int t = tid; t < nt * nt; t += kThreads) cp_async4(TtTs + t, a.TtT + t);
  for (int t = tid; t < n * n; t += kThreads) cp_async4(iUGs + t, a.iUG + t);
  for (int t = tid; t < n; t += kThreads) cp_async4(iUGmGs + t, a.iUGmG + t);

  // the entries this warp owns: A's lower triangle row by row, then BT
  int xo[kMaxEntries], yo[kMaxEntries];
  float acc[kMaxEntries];
#pragma unroll
  for (int q = 0; q < kMaxEntries; ++q) {
    int e = warp + q * kWarps;
    acc[q] = 0.0f;
    xo[q] = yo[q] = 0;
    if (e < nA) {
      int r = 0;
      while (e > r) { e -= r + 1; ++r; }
      xo[q] = nc * CH + r * CH;                    // Es row r
      yo[q] = nc * CH + e * CH;                    // Es row e (e <= r)
    } else if (e < nout) {
      e -= nA;
      xo[q] = (e / nt) * CH;                       // Bs row a
      yo[q] = 2 * nc * CH + (e % nt) * CH;         // Ts row t
    }
  }

  for (int j0 = 0; j0 < ns; j0 += CH) {
    const int len = min(CH, ns - j0);
    // Beta's and Tr's species (Tr transposed), copied
    for (int r = 0; r < nc; ++r)
      for (int j = tid; j < len; j += kThreads)
        cp_async4(Bs + r * CH + j, Beta + static_cast<long long>(r) * ns + j0 + j);
    for (int u = 0; u < nt; ++u)
      for (int j = tid; j < len; j += kThreads)
        cp_async4(Ts + u * CH + j, a.Tr + static_cast<long long>(j0 + j) * nt + u);
    cp_async_wait_all();
    __syncthreads();
    for (int t = tid; t < nc * len; t += kThreads) {
      const int r = t / len, j = t - r * len;
      float g = Gs[r * nt] * Ts[j];
      for (int u = 1; u < nt; ++u) g = fmaf(Gs[r * nt + u], Ts[u * CH + j], g);
      const float ev = Bs[r * CH + j] - g;
      Es[r * CH + j] = kBf16 ? rd(ev) : ev;
    }
    __syncthreads();
    // an entry at a time, a lane's species in order (with a lane's species
    // outer and its entries inner the headline's pass took 0.0140 ms, not
    // 0.0060: scripts/gamma_v_sweep.py)
#pragma unroll
    for (int q = 0; q < kMaxEntries; ++q) {
      if (warp + q * kWarps < nout) {
        const float* x = sm + xo[q];
        const float* y = sm + yo[q];
        float acc_q = acc[q];
#pragma unroll 4
        for (int j = lane; j < len; j += 32) acc_q = fmaf(x[j], y[j], acc_q);
        acc[q] = acc_q;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kMaxEntries; ++q) {
    int e = warp + q * kWarps;
    if (e < nout) {
      float s = acc[q];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) {
        if (e < nA) {
          int r = 0;
          while (e > r) { e -= r + 1; ++r; }
          As[r * nc + e] = s;
          As[e * nc + r] = s;
        } else {
          BTs[e - nA] = s;
        }
      }
    }
  }
  __syncthreads();

  if (warp == 0) {
    // Lw = chol(A + V0), then T = Lw^-T, a lane a column of Lw^-1
    for (int t = lane; t < nc * nc; t += 32) As[t] += V0s[t];
    __syncwarp();
    chol_rows(As, nc, nc, invw, lane, 32);
    if (lane < nc) {
      const int b = lane;
      for (int r = 0; r < b; ++r) Tm[b * nc + r] = 0.0f;
      Tm[b * nc + b] = invw[b];
      for (int r = b + 1; r < nc; ++r) {
        float s = 0.0f;
        for (int k = b; k < r; ++k) s = fmaf(-As[r * nc + k], Tm[b * nc + k], s);
        Tm[b * nc + r] = s * invw[r];
      }
    }
  } else if (warp == 1) {
    // the Bartlett diagonal: chi^2_{df-i} = 2 Ga((df - i) / 2)
    if (lane < nc) {
      const long long i = static_cast<long long>(c) * nc + lane;
      const float shape = (a.df - static_cast<float>(lane)) * 0.5f;
      const float g = a.gamma ? a.gamma[i]
                              : hmsc::standard_gamma_draw(shape, i, a.key,
                                                          a.off_gamma);
      Bb[lane * nc + lane] = sqrtf(2.0f * g);
    }
  } else if (warp == 3) {
    for (int t = lane; t < n; t += 32) {
      const long long i = static_cast<long long>(c) * n + t;
      es[t] = a.eps ? __ldg(a.eps + i) : philox_normal(i, a.key, a.off_eps);
    }
  } else if (warp == 2) {
    for (int t = lane; t < nc * nc; t += 32) {
      const int r = t / nc, k = t - r * nc;
      if (r == k) continue;
      const long long i = static_cast<long long>(c) * nc * nc + t;
      Bb[t] = r < k ? 0.0f
                    : (a.normal ? a.normal[i]
                                : philox_normal(i, a.key, a.off_normal));
    }
  }
  __syncthreads();
  // the rest on the first one or two warps, joined by rows_sync
  const int rows = n <= 32 ? 32 : 64;
  if (tid < rows) {
    for (int t = tid; t < nc * nc; t += rows) {         // T B
      const int r = t / nc, k = t - r * nc;
      float s = Tm[r * nc] * Bb[k];
      for (int m = 1; m < nc; ++m) s = fmaf(Tm[r * nc + m], Bb[m * nc + k], s);
      TA[t] = s;
    }
    rows_sync(rows);
    float* iV = a.iV + static_cast<long long>(c) * nc * nc;
    for (int t = tid; t < nc * nc; t += rows) {         // (T B)(T B)'
      const int r = t / nc, k = t - r * nc;
      float s = TA[r * nc] * TA[k * nc];
      for (int m = 1; m < nc; ++m) s = fmaf(TA[r * nc + m], TA[k * nc + m], s);
      iVs[t] = s;
      iV[t] = s;
    }
  }
  if constexpr (kBf16) {
    // (iV Beta) Tr as the mx calls round it, a second species pass with
    // every thread: W = rd(rd(iV) rd(Beta)) a (covariate, species) entry
    // (over the covariates in order), then BT[r, u] = sum_j W[r, j]
    // rd(Tr[j, u]) warp-owned as in the first pass; Beta is still staged
    // where one pass held every species
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kMaxEntries; ++q) acc[q] = 0.0f;
    for (int j0 = 0; j0 < ns; j0 += CH) {
      const int len = min(CH, ns - j0);
      if (CH < ns) {
        for (int r = 0; r < nc; ++r)
          for (int j = tid; j < len; j += kThreads)
            cp_async4(Bs + r * CH + j,
                      Beta + static_cast<long long>(r) * ns + j0 + j);
        cp_async_wait_all();
        __syncthreads();
      }
      for (int t = tid; t < nc * len; t += kThreads) {
        const int r = t / len, j = t - r * len;
        float s = 0.0f;
        for (int k = 0; k < nc; ++k)
          s = fmaf(rd(iVs[r * nc + k]), rd(Bs[k * CH + j]), s);
        Es[r * CH + j] = rd(s);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kMaxEntries; ++q) {
        const int e = warp + q * kWarps;
        if (e < nc * nt) {
          const int r = e / nt, u = e - r * nt;
          const float* w = Es + r * CH;
          float acc_q = acc[q];
          for (int j = lane; j < len; j += 32)
            acc_q = fmaf(w[j],
                         __bfloat162float(a.Tr16[static_cast<long long>(
                                                     j0 + j) * nt + u]),
                         acc_q);
          acc[q] = acc_q;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < kMaxEntries; ++q) {
      const int e = warp + q * kWarps;
      if (e < nc * nt) {
        float s = acc[q];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) BTs[e] = s;
      }
    }
    __syncthreads();
  }
  if (tid >= rows) return;
  rows_sync(rows);

  // Gamma | Beta, iV: the (n, n) precision, entry (u nc + r, w nc + k)
  const int ld = n + 1;
  for (int t = tid; t < n * n; t += rows) {
    const int p = t / n, q = t - p * n;
    const int u = p / nc, r = p - u * nc, w = q / nc, k = q - w * nc;
    Ps[p * ld + q] = iUGs[t] + TtTs[u * nt + w] * iVs[r * nc + k];
  }
  float rp = 0.0f, zp = 0.0f;          // thread p: its rhs and eps
  if (tid < n) {
    zp = es[tid];
    const int u = tid / nc, r = tid - u * nc;
    if constexpr (kBf16) {
      rp = iUGmGs[tid] + BTs[r * nt + u];     // ((iV Beta) Tr)[r, u]
    } else {
      float s = iVs[r * nc] * BTs[u];
      for (int k = 1; k < nc; ++k)
        s = fmaf(iVs[r * nc + k], BTs[k * nt + u], s);
      rp = iUGmGs[tid] + s;
    }
  }
  rows_sync(rows);
  chol_rows(Ps, ld, n, invp, tid, rows);
  // forward L y = rhs, a column at a time (each row's updates in order)
  for (int k = 0; k < n; ++k) {
    if (tid == k) xs[k] = rp * invp[k];
    rows_sync(rows);
    if (tid > k && tid < n) rp = fmaf(-Ps[tid * ld + k], xs[k], rp);
  }
  rows_sync(rows);
  // back L' x = y + eps, a column at a time from the last
  if (tid < n) zp = xs[tid] + zp;
  rows_sync(rows);
  for (int k = n - 1; k >= 0; --k) {
    if (tid == k) xs[k] = zp * invp[k];
    rows_sync(rows);
    if (tid < k) zp = fmaf(-Ps[k * ld + tid], xs[k], zp);
  }
  float* G = a.Gamma_out + static_cast<long long>(c) * nc * nt;
  for (int t = tid; t < n; t += rows) {
    const int r = t / nt, u = t - r * nt;          // Gamma[r, u] = x[u nc + r]
    G[t] = xs[u * nc + r];
  }
}

}  // namespace

// One launch for C chains, a block of 512 threads each.  nc <= 16 and
// nc nt <= 64 (ops/rand.py · gamma_v_route); offsets: gamma, normal, eps.
// Tr16 non-null: the bf16 form (TtT then Tr'Tr of the rounded Tr).
extern "C" int hmsc_gamma_v(const float* Beta, const float* Gamma,
                            const float* Tr, const __nv_bfloat16* Tr16,
                            const float* V0,
                            const float* TtT, const float* iUG,
                            const float* iUGmG, const float* normal,
                            const float* gamma, const float* eps, float* iV,
                            float* Gamma_out, int C, int nc, int nt, int ns,
                            float df, unsigned long long seed,
                            unsigned off_gamma, unsigned off_normal,
                            unsigned off_eps, void* stream) {
  if (nc < 1 || nc > kMaxNc || nt < 1 || nc * nt > kMaxN || ns < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = nc * nt;
  // species a pass: all of them where the budget allows, else as many
  // whole warps' worth as fit
  const int per = 2 * nc + nt;
  const int want = (ns + 31) / 32 * 32;
  const int fit = kStageFloats / per / 32 * 32;
  const int chunk = want < fit ? want : fit;
  const int stage = per * chunk;
  const int region = stage > n * (n + 1) ? stage : n * (n + 1);
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(region) + 6 * nc * nc + 2 * nc * nt + nc + 4 * n +
       nt * nt + n * n);
  auto kernel = Tr16 ? gamma_v_kernel<true> : gamma_v_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  GammaVArgs a{Beta, Gamma, Tr, Tr16, V0, TtT, iUG, iUGmG, normal, gamma,
               eps, iV, Gamma_out, nc, nt, ns, chunk, df,
               hmsc::seed_key(seed), off_gamma, off_normal, off_eps};
  kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
