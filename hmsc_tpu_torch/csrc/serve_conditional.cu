// B9b: conditional prediction, the per-draw Gibbs refinement of each query
// row's latent factors against its observed cells.
//
// Replaces hmsc_tpu/serve/kernels.py · _cond_one_draw /
// make_conditional_kernel (:255-368), which the JAX package wrote as a
// lax.scan vmapped over draws.  For each draw n and query row b (its own
// unit in every level, factors starting from its gathered posterior rows,
// zeros for a new unit):
//
//   LFix = X[b] . Beta[n];  isig = 1 / sigma[n]
//   per level r: U = sum_j lam_f lam_g isig_j mask_j,  P = U + I = L L'
//   z0 = z_given_yc(LFix + sum_r rows_r . Lambda_r)
//   mcmc_step times: for each level r in turn,
//       S = z - LFix - sum_{q != r} rows_q . Lambda_q
//       F = (S isig mask) Lambda_r',  rows_r = cho_solve(L, F) + L'^-1 eps
//     then z = z_given_yc(LFix + sum_r rows_r . Lambda_r)
//   E = LFix + sum_r rows_r . Lambda_r;  link (ndtr on probit columns when
//   expected; Z = E + sqrt(sigma) eps, Z > 0 on probit columns when
//   sampled);  y = out * ys + ym
//
// with z_given_yc(E) = E + std eps (std = isig^-1/2), Yc on observed normal
// cells and B1's one-sided truncated normal (truncnorm.cuh · probit_z_draw,
// the same device function) on observed probit cells; then the mean and
// population sd of y over the draws.  No jitter on P, as in the JAX
// kernel.  Unobserved cells carry weight 0 in U and F, and F is the only
// reader of z, so the kernel skips them in those passes and draws no z for
// them (the JAX kernel draws E + std eps there, multiplied by 0).  Nor does
// it draw the z of the last step's refresh: nothing reads it (the JAX scan
// carries it out and drops it).  The draws it does make keep their Philox
// keys.
//
// What bounds it on the H100: instructions.  At the serve path's query (B
// 64, 800 draws, 1000 species, 500 observed, nf 8, mcmc_step 3) the ~1e8
// refreshed probit cells each issue a Philox4x32-10 (~80 integer
// instructions) and a truncated normal (~100 more with normcdff and
// normcdfinvf, fewer with truncnorm.cuh's forms since B1's redesign); that
// is most of the issue-rate floor (scripts/serve_conditional_sweep.py
// reads it from the SASS).  The first version (one block of 256 threads a
// (row, draw chunk), threads over species) sat far above it, held by
// latency: block-wide reductions and warp 0's serial Cholesky and solves
// behind ~14 barriers a draw, and every pass re-reading the draw's Lambda
// from L2 for each of the 64 rows.  This design:
//   - a block owns `rows` query rows and a chunk of draws per draw slot;
//     each warp owns one (row, slot), its lanes over species, so the grams'
//     and F's sums are warp shuffles (a fixed butterfly), and the nf <= 16
//     Cholesky and both triangular solves run in the warp that owns the
//     row: no barrier falls inside a draw;
//   - each draw's Lambda (every level), Beta and sigma are copied by
//     cp.async into shared memory once for all the block's rows, with two
//     stages where they fit (the next draw's copy in flight while one
//     computes), and 1 / sigma and its square root are formed there once
//     (two barriers a draw, between draws); where they do not fit, or a
//     block has one row (nothing to share), the warps read them from L2;
//   - each warp keeps its row's running E = LFix + sum_r rows_r . Lambda_r
//     in shared memory: an observed species' E takes the change of the
//     level just solved at the start of the next pass over the observed
//     species, an unobserved one the whole change once, in the last pass;
//     the sum over levels is formed once a draw;
//   - the observed species of a row are listed once a block (a ballot
//     scan), so the refresh, gram and F passes run only over them, with no
//     idle lanes whatever the mask;
//   - spare warps take draws where a query has fewer rows than warps (draw
//     slots, as B9a's); each warp keeps the Welford moments of its row over
//     its chunk of draws in that chunk's slot of the scratch the combine
//     reads (its own cells, coalesced: shared memory holds only a warp's E,
//     z and observed list, so 16 warps fit an SM beside two stages), and a
//     second kernel combines the chunks in chunk order (serve_common.cuh):
//     no atomics, two runs give the same bits.
// ops/serve.py · conditional_geometry picks rows, slots, stages and the
// chunks from the shape (make_layout below is its shared-memory map).
// Random numbers come from Philox keyed by (species or factor, draw x row,
// offset, refresh tag), or from injected tensors, so the kernel can be
// compared with its plain version on identical inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "serve_common.cuh"
#include "truncnorm.cuh"

namespace {

constexpr int kMaxWarps = 16;
// a block's warps: 16 below nf 16 (~128 registers a thread), else 8
template <int NFM>
__host__ __device__ constexpr int warps_for() {
  return NFM == 16 ? 8 : 16;
}
constexpr int kMaxNc = 64;
constexpr int kMaxNft = 64;
constexpr long long kMaxSmem = 227 * 1024;
constexpr unsigned kTagRows = 0x10000u;
constexpr unsigned kTagOut = 0x20000u;
// an observed species' entry: its index in the low 16 bits, then flags
constexpr unsigned kProbit = 1u << 16;    // fam 2
constexpr unsigned kNormal = 1u << 17;    // fam 1: z is Yc
constexpr unsigned kYcUp = 1u << 18;      // Yc > 0.5
constexpr unsigned kMaskOther = 1u << 19; // mask != 1: read its value

struct Noise {           // injected draws, or all null for Philox
  const float* eps_z;    // (n, steps + 1, B, ns)
  const float* u_z;      // (n, steps + 1, B, ns)
  const float* eps_rows; // (n, steps, B, nf_total)
  const float* eps_out;  // (n, B, ns), sampled mode
};

__host__ __device__ inline long long round16(long long b) {
  return (b + 15) / 16 * 16;
}

// The shared-memory map of a block (mirrored by ops/serve.py ·
// _conditional_smem): slots x stages copies of one draw's operands, then
// each warp's row state.  A copied array starts at its region's start plus
// its source address mod 16 (so 16-byte copies line up), hence the 16
// bytes of slack.
struct Layout {
  long long lam[hmsc::kMaxLevels];   // stage: Lambda_r, raw
  long long beta, sig, isig, sd;     // stage: Beta, sigma raw; 1/sigma, sd
  long long stage;                   // bytes a stage
  long long warps_at;                // the warps' regions start
  long long obs, bits, e, z, small;  // in a warp's region
  long long warp;                    // bytes a warp
  long long total;
};

__host__ __device__ inline Layout make_layout(int ns, int nc, const int* nf,
                                              int nr, int nfm, int ws,
                                              int slots, int stages,
                                              int warps) {
  Layout L{};
  long long at = 0;
  int nft = 0;
  for (int r = 0; r < nr; ++r) {
    L.lam[r] = at;
    at += round16(static_cast<long long>(nf[r]) * ns * ws + 16);
    nft += nf[r];
  }
  L.beta = at;
  at += round16(static_cast<long long>(nc) * ns * ws + 16);
  L.sig = at;
  at += round16(static_cast<long long>(ns) * ws + 16);
  L.isig = at;
  at += round16(4LL * ns);
  L.sd = at;
  at += round16(4LL * ns);
  L.stage = at;
  L.warps_at = static_cast<long long>(slots) * stages * L.stage;
  long long w = 0;
  L.obs = w;                         // entries of the observed species
  w += round16(4LL * ns);
  L.bits = w;                        // a bit a species: observed
  w += round16(4LL * ((ns + 31) / 32));
  L.e = w;
  w += round16(4LL * ns);
  L.z = w;
  w += nr > 1 ? round16(4LL * ns) : 0;
  L.small = w;   // X row, Cholesky factors, packed gram, rows, rows0, delta
  w += round16(4LL * (nc + nr * nfm * nfm + nfm * (nfm + 1) / 2 + 2 * nft +
                      nfm));
  L.warp = w;
  L.total = L.warps_at + warps * L.warp;
  return L;
}

struct Args {
  const float* X;
  const int* uidx;
  const float* Yc;
  const float* mask;
  const void* Beta;
  const void* sigma;
  hmsc::LevelTable lv;
  const int* fam;
  const float* ym;
  const float* ys;
  Noise noise;
  float* pmean;
  float* pm2;
  Layout L;
  int n, B, ns, nc, steps, expected;
  int rows, slots, stages, D, S;
  uint2 key;
  unsigned offset;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a draw's element: from shared memory (staged) or global memory
template <bool kStaged, typename T>
__device__ __forceinline__ float ldv(const T* p) {
  if constexpr (kStaged) return widen(*p);
  else return hmsc::load_draw(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// The whole block copies nbytes from src into the region at dst (16-byte
// aligned): the words holding them, placed at dst + (their address mod
// 16); 4-byte copies up to the first 16-byte boundary and after the last,
// 16-byte copies between.
__device__ __forceinline__ void stage_copy(unsigned char* dst,
                                           const void* src, long long nbytes) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = s & ~uintptr_t(3);
  const uintptr_t a1 = (s + nbytes + 3) & ~uintptr_t(3);
  const uintptr_t b0 = (a0 + 15) & ~uintptr_t(15);
  const uintptr_t head = b0 < a1 ? b0 : a1;
  const uintptr_t b1 = head + ((a1 - head) & ~uintptr_t(15));
  unsigned char* base = dst + (a0 & 15);      // where the word at a0 goes
  const int nh = static_cast<int>((head - a0) / 4);
  const int nb = static_cast<int>((b1 - head) / 16);
  const int nt = static_cast<int>((a1 - b1) / 4);
  for (int i = threadIdx.x; i < nh + nb + nt; i += blockDim.x) {
    if (i < nh) {
      const uintptr_t a = a0 + 4 * i;
      cp_async4(base + (a - a0), reinterpret_cast<const void*>(a));
    } else if (i < nh + nb) {
      const uintptr_t a = head + 16 * static_cast<uintptr_t>(i - nh);
      cp_async16(base + (a - a0), reinterpret_cast<const void*>(a));
    } else {
      const uintptr_t a = b1 + 4 * static_cast<uintptr_t>(i - nh - nb);
      cp_async4(base + (a - a0), reinterpret_cast<const void*>(a));
    }
  }
}

template <typename T>
__device__ __forceinline__ const T* in_stage(const unsigned char* region,
                                             const T* src) {
  return reinterpret_cast<const T*>(
      region + (reinterpret_cast<uintptr_t>(src) & 15));
}

// The warp's Cholesky factor L of P = U + I (U's lower triangle packed row
// by row in `packed`) into Lc (NFM x NFM, row-major), right-looking, lane i
// holding row i; no jitter, NaN on an indefinite P.
template <int NFM>
__device__ __forceinline__ void warp_cholesky(const float* packed, int nf,
                                              float* Lc) {
  const int lane = threadIdx.x & 31;
  float a[NFM];
#pragma unroll
  for (int g = 0; g < NFM; ++g)
    a[g] = (lane < nf && g <= lane)
               ? packed[lane * (lane + 1) / 2 + g] + (g == lane ? 1.0f : 0.0f)
               : 0.0f;
#pragma unroll
  for (int k = 0; k < NFM; ++k) {
    if (k >= nf) break;
    const float lkk = sqrtf(__shfl_sync(0xffffffffu, a[k], k));
    if (lane == k) a[k] = lkk;
    else if (lane > k) a[k] = a[k] / lkk;
#pragma unroll
    for (int g = k + 1; g < NFM; ++g) {      // the trailing rows' update
      const float lgk = __shfl_sync(0xffffffffu, a[k], g);
      if (g < nf && lane >= g) a[g] -= a[k] * lgk;
    }
  }
  if (lane < nf) {
#pragma unroll
    for (int g = 0; g < NFM; ++g) Lc[lane * NFM + g] = g <= lane ? a[g] : 0.0f;
  }
}

// Lane f < nf returns row f of cho_solve(L, F) + L'^-1 eps, from its F_f
// and eps_f: the forward, then both backward substitutions, one unknown a
// step, finished by its lane and broadcast.
template <int NFM>
__device__ __forceinline__ float warp_solve(const float* Lc, int nf, float F,
                                            float eps) {
  const int lane = threadIdx.x & 31;
  float y = F;
#pragma unroll
  for (int k = 0; k < NFM; ++k) {            // L y = F
    if (k >= nf) break;
    if (lane == k) y = y / Lc[k * NFM + k];
    const float yk = __shfl_sync(0xffffffffu, y, k);
    if (lane > k && lane < nf) y -= Lc[lane * NFM + k] * yk;
  }
  float v = eps;
#pragma unroll
  for (int k = NFM - 1; k >= 0; --k) {       // L' x = y, L' v = eps
    if (k >= nf) continue;
    if (lane == k) {
      y = y / Lc[k * NFM + k];
      v = v / Lc[k * NFM + k];
    }
    const float xk = __shfl_sync(0xffffffffu, y, k);
    const float vk = __shfl_sync(0xffffffffu, v, k);
    if (lane < k) {
      const float l = Lc[k * NFM + lane];
      y -= l * xk;
      v -= l * vk;
    }
  }
  return y + v;
}

template <typename T, int NFM, bool kStaged>
__global__ void __launch_bounds__(warps_for<NFM>() * 32)
serve_conditional_kernel(const Args a) {
  constexpr int KG = NFM * (NFM + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout& L = a.L;
  const hmsc::LevelTable& lv = a.lv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nr = lv.nr, nft = lv.nf_total, ns = a.ns, nc = a.nc;
  const int b = blockIdx.x * a.rows + warp % a.rows;
  const int slot = warp / a.rows;
  const int chunk = blockIdx.y * a.slots + slot;
  const int d0 = chunk * a.D;
  const int nd = (b < a.B && d0 < a.n) ? min(a.D, a.n - d0) : 0;
  // the block's draw steps: its first slot's draws, the most of any slot
  const int nd_block = max(0, min(a.D, a.n - blockIdx.y * a.slots * a.D));

  unsigned char* wbase = smem + L.warps_at + warp * L.warp;
  unsigned* obs = reinterpret_cast<unsigned*>(wbase + L.obs);
  unsigned* obits = reinterpret_cast<unsigned*>(wbase + L.bits);
  float* E_s = reinterpret_cast<float*>(wbase + L.e);
  float* z_s = reinterpret_cast<float*>(wbase + L.z);
  float* x_s = reinterpret_cast<float*>(wbase + L.small);
  float* chol_s = x_s + nc;
  float* packed_s = chol_s + nr * NFM * NFM;
  float* rows_s = packed_s + KG;
  float* rows0_s = rows_s + nft;
  float* delta_s = rows0_s + nft;

  const float* yc_b = a.Yc + static_cast<long long>(b) * ns;
  const float* mk_b = a.mask + static_cast<long long>(b) * ns;
  int nobs = 0;
  if (nd > 0) {
    for (int c = lane; c < nc; c += 32) x_s[c] = a.X[b * nc + c];
    for (int j0 = 0; j0 < ns; j0 += 32) {    // the observed species, listed
      const int j = j0 + lane;
      const float m = j < ns ? mk_b[j] : 0.0f;
      const bool o = m > 0.0f;
      const unsigned bal = __ballot_sync(0xffffffffu, o);
      if (o) {
        const int fj = a.fam[j];
        obs[nobs + __popc(bal & ((1u << lane) - 1u))] =
            static_cast<unsigned>(j) | (fj == 2 ? kProbit : 0u) |
            (fj == 1 ? kNormal : 0u) | (yc_b[j] > 0.5f ? kYcUp : 0u) |
            (m != 1.0f ? kMaskOther : 0u);
      }
      if (lane == 0) obits[j0 / 32] = bal;
      nobs += __popc(bal);
    }
    __syncwarp();
  }

  const T* beta_g = static_cast<const T*>(a.Beta);
  const T* sig_g = static_cast<const T*>(a.sigma);
  auto stage_of = [&](int q, int buf) -> unsigned char* {
    return smem + (static_cast<long long>(q) * a.stages + buf) * L.stage;
  };
  // the block's copies of every slot's draw at step ld into stage buffer buf
  auto issue = [&](int ld, int buf) {
    for (int q = 0; q < a.slots; ++q) {
      const int c = blockIdx.y * a.slots + q;
      const int nn = c * a.D + ld;
      if (c >= a.S || ld >= a.D || nn >= a.n) continue;
      unsigned char* st = stage_of(q, buf);
      for (int r = 0; r < nr; ++r)
        stage_copy(st + L.lam[r], static_cast<const T*>(lv.lam[r]) +
                                      static_cast<long long>(nn) * lv.nf[r] *
                                          ns,
                   static_cast<long long>(lv.nf[r]) * ns * sizeof(T));
      stage_copy(st + L.beta, beta_g + static_cast<long long>(nn) * nc * ns,
                 static_cast<long long>(nc) * ns * sizeof(T));
      stage_copy(st + L.sig, sig_g + static_cast<long long>(nn) * ns,
                 static_cast<long long>(ns) * sizeof(T));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // once a staged draw has landed: 1 / sigma and std = isig^-1/2
  auto prepare = [&](int ld, int buf) {
    for (int q = 0; q < a.slots; ++q) {
      const int c = blockIdx.y * a.slots + q;
      const int nn = c * a.D + ld;
      if (c >= a.S || ld >= a.D || nn >= a.n) continue;
      unsigned char* st = stage_of(q, buf);
      const T* sg = in_stage(st + L.sig, sig_g + static_cast<long long>(nn) *
                                                    ns);
      float* is = reinterpret_cast<float*>(st + L.isig);
      float* sd = reinterpret_cast<float*>(st + L.sd);
      for (int j = threadIdx.x; j < ns; j += blockDim.x) {
        const float v = 1.0f / widen(sg[j]);
        is[j] = v;
        sd[j] = 1.0f / sqrtf(v);
      }
    }
  };

  // one draw of the warp's row: the refinement, the link, a Welford step
  auto one_draw = [&](int ld, int buf) {
    const int nn = d0 + ld;
    const unsigned row_id = static_cast<unsigned>(nn) * a.B + b;
    const unsigned char* st = stage_of(slot, buf);
    const T* lam[hmsc::kMaxLevels];
#pragma unroll
    for (int r = 0; r < hmsc::kMaxLevels; ++r) {
      if (r >= nr) break;
      const T* g = static_cast<const T*>(lv.lam[r]) +
                   static_cast<long long>(nn) * lv.nf[r] * ns;
      lam[r] = kStaged ? in_stage(st + L.lam[r], g) : g;
    }
    const T* bg = beta_g + static_cast<long long>(nn) * nc * ns;
    const T* sgg = sig_g + static_cast<long long>(nn) * ns;
    const T* beta = kStaged ? in_stage(st + L.beta, bg) : bg;
    const T* sig = kStaged ? in_stage(st + L.sig, sgg) : sgg;
    const float* isig_st = reinterpret_cast<const float*>(st + L.isig);
    const float* sd_st = reinterpret_cast<const float*>(st + L.sd);
    auto isig = [&](int j) -> float {
      if constexpr (kStaged) return isig_st[j];
      else return 1.0f / ldv<false>(sig + j);
    };
    auto stdv = [&](int j) -> float {
      if constexpr (kStaged) return sd_st[j];
      else return 1.0f / sqrtf(isig(j));
    };
    // z | Yc at E for observed species j, refresh t (0 the initial draw,
    // s before step s): Yc on a normal column, B1's truncated normal on a
    // probit one, E + std eps on another
    auto refresh = [&](unsigned ent, float E, int t) -> float {
      const int j = static_cast<int>(ent & 0xffffu);
      if (ent & kNormal) return yc_b[j];
      const float sd = stdv(j);
      const long long i =
          ((static_cast<long long>(nn) * (a.steps + 1) + t) * a.B + b) * ns +
          j;
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (a.noise.eps_z == nullptr)
        bits = hmsc::philox4x32_10(
            make_uint4(static_cast<unsigned>(j), row_id, a.offset,
                       static_cast<unsigned>(t)), a.key);
      if (ent & kProbit) {
        const float u = a.noise.u_z != nullptr ? a.noise.u_z[i]
                                               : hmsc::uniform01(bits.z);
        return hmsc::probit_z_draw(E, sd, (ent & kYcUp) != 0u, u);
      }
      const float eps = a.noise.eps_z != nullptr
                            ? a.noise.eps_z[i]
                            : hmsc::box_muller(bits.x, bits.y);
      return E + sd * eps;
    };

    // the row's factors from its posterior rows
    for (int i = lane; i < nft; i += 32) {
      int r = 0;
      while (r + 1 < nr && i >= lv.off[r + 1]) ++r;
      const int f = i - lv.off[r];
      const T* eta = static_cast<const T*>(lv.eta[r]);
      const long long row =
          static_cast<long long>(nn) * lv.np[r] + a.uidx[r * a.B + b];
      const float v = hmsc::load_draw(eta + row * lv.nf[r] + f);
      rows_s[i] = v;
      rows0_s[i] = v;
    }
    __syncwarp();
    // E = LFix + sum_r rows_r . Lambda_r, every species, four a lane at a
    // time (their loads independent)
    for (int j0 = lane; j0 < ns; j0 += 128) {
      int jj[4];
      float lf[4], acc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        jj[u] = min(j0 + 32 * u, ns - 1);
        lf[u] = 0.0f;
        acc[u] = 0.0f;
      }
      for (int c = 0; c < nc; ++c) {
        const float xc = x_s[c];
        const T* bc = beta + static_cast<long long>(c) * ns;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          lf[u] = fmaf(xc, ldv<kStaged>(bc + jj[u]), lf[u]);
      }
      for (int r = 0; r < nr; ++r) {
        const int nf = lv.nf[r];
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int f = 0; f < NFM; ++f) {
          if (f >= nf) break;
          const float rf = rows_s[lv.off[r] + f];
          const T* lf_r = lam[r] + static_cast<long long>(f) * ns;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            part[u] = fmaf(rf, ldv<kStaged>(lf_r + jj[u]), part[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] += part[u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + 32 * u < ns) E_s[j0 + 32 * u] = lf[u] + acc[u];
    }

    int pend = -1;                  // the level whose change E still owes
    if (a.steps > 0) {
      // step-invariant: each level's P = U + I and its Cholesky factor
      for (int r = 0; r < nr; ++r) {
        const int nf = lv.nf[r];
        float acc[KG];
#pragma unroll
        for (int k = 0; k < KG; ++k) acc[k] = 0.0f;
        for (int o = lane; o < nobs; o += 32) {
          const unsigned ent = obs[o];
          const int j = static_cast<int>(ent & 0xffffu);
          const float w = isig(j) * ((ent & kMaskOther) ? mk_b[j] : 1.0f);
          float l[NFM];
#pragma unroll
          for (int f = 0; f < NFM; ++f)
            l[f] = f < nf ? ldv<kStaged>(lam[r] + static_cast<long long>(f) *
                                                      ns + j)
                          : 0.0f;
          int k = 0;
#pragma unroll
          for (int f = 0; f < NFM; ++f)
#pragma unroll
            for (int g = 0; g <= f; ++g) acc[k++] += l[f] * l[g] * w;
        }
#pragma unroll
        for (int k = 0; k < KG; ++k) {
          const float t = warp_sum(acc[k]);
          if (lane == (k & 31)) packed_s[k] = t;
        }
        __syncwarp();
        warp_cholesky<NFM>(packed_s, nf, chol_s + r * NFM * NFM);
        __syncwarp();
      }
    }
    for (int s = 0; s < a.steps; ++s) {
      for (int r = 0; r < nr; ++r) {
        const int nf = lv.nf[r];
        const int q = pend;
        const int nfq = q >= 0 ? lv.nf[q] : 0;
        float dq[NFM], rr[NFM], acc[NFM];
#pragma unroll
        for (int f = 0; f < NFM; ++f) {
          dq[f] = f < nfq ? delta_s[f] : 0.0f;
          rr[f] = f < nf ? rows_s[lv.off[r] + f] : 0.0f;
          acc[f] = 0.0f;
        }
        const int t = s;
        for (int o = lane; o < nobs; o += 32) {   // refresh-and-F pass
          const unsigned ent = obs[o];
          const int j = static_cast<int>(ent & 0xffffu);
          float lr[NFM];
#pragma unroll
          for (int f = 0; f < NFM; ++f)
            lr[f] = f < nf ? ldv<kStaged>(lam[r] + static_cast<long long>(f) *
                                                       ns + j)
                           : 0.0f;
          float E = E_s[j];
          if (q >= 0) {                      // the pending level's change
            float upd = 0.0f;
            if (q == r) {
#pragma unroll
              for (int f = 0; f < NFM; ++f) upd = fmaf(dq[f], lr[f], upd);
            } else {
#pragma unroll
              for (int f = 0; f < NFM; ++f)
                if (f < nfq)
                  upd = fmaf(dq[f], ldv<kStaged>(lam[q] +
                                                 static_cast<long long>(f) *
                                                     ns + j), upd);
            }
            E += upd;
            E_s[j] = E;
          }
          float z;
          if (r == 0) {
            z = refresh(ent, E, t);
            if (nr > 1) z_s[j] = z;
          } else {
            z = z_s[j];
          }
          float own = 0.0f;
#pragma unroll
          for (int f = 0; f < NFM; ++f) own = fmaf(rr[f], lr[f], own);
          const float S = z - (E - own);     // z - LFix - the other levels
          const float w = S * isig(j) * ((ent & kMaskOther) ? mk_b[j] : 1.0f);
#pragma unroll
          for (int f = 0; f < NFM; ++f) acc[f] = fmaf(w, lr[f], acc[f]);
        }
        float F = 0.0f;
#pragma unroll
        for (int f = 0; f < NFM; ++f) {
          const float t2 = warp_sum(acc[f]);
          if (lane == f) F = t2;
        }
        const int g = lv.off[r] + lane;
        float eps = 0.0f;
        if (lane < nf) {
          if (a.noise.eps_rows != nullptr) {
            eps = a.noise.eps_rows[((static_cast<long long>(nn) * a.steps + s)
                                    * a.B + b) * nft + g];
          } else {
            const uint4 bits = hmsc::philox4x32_10(
                make_uint4(static_cast<unsigned>(g), row_id, a.offset,
                           kTagRows + static_cast<unsigned>(s)), a.key);
            eps = hmsc::box_muller(bits.x, bits.y);
          }
        }
        const float row = warp_solve<NFM>(chol_s + r * NFM * NFM, nf,
                                          lane < nf ? F : 0.0f, eps);
        __syncwarp();
        if (lane < nf) {
          delta_s[lane] = row - rows_s[lv.off[r] + lane];
          rows_s[lv.off[r] + lane] = row;
        }
        __syncwarp();
        pend = r;
      }
    }

    // the last pass: E's outstanding changes (an observed species the
    // pending level's, an unobserved one each level's whole change), then
    // the link and the moments
    const float inv_count = 1.0f / static_cast<float>(ld + 1);
    // the warp's running moments of its row over its chunk, in the chunk's
    // slot of the (S, B, ns) scratch (coalesced, its own)
    float* __restrict__ mean_g =
        a.pmean + (static_cast<long long>(chunk) * a.B + b) * ns;
    float* __restrict__ m2_g =
        a.pm2 + (static_cast<long long>(chunk) * a.B + b) * ns;
    for (int r = 0; r < nr; ++r) {
      const int nf = lv.nf[r];
      float c_obs[NFM], c_un[NFM];
#pragma unroll
      for (int f = 0; f < NFM; ++f) {
        c_obs[f] = (r == pend && f < nf) ? delta_s[f] : 0.0f;
        c_un[f] = f < nf ? rows_s[lv.off[r] + f] - rows0_s[lv.off[r] + f]
                         : 0.0f;
      }
      const bool last = r == nr - 1;
      // four species a lane at a time, their moments' loads issued first
      for (int j0 = lane; j0 < ns; j0 += 128) {
        float mo[4], qo[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u;
          const bool rd = last && ld > 0 && j < ns;
          mo[u] = rd ? mean_g[j] : 0.0f;
          qo[u] = rd ? m2_g[j] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u;
          if (j >= ns) break;
          const bool o = (obits[j >> 5] >> (j & 31)) & 1u;
          float upd = 0.0f;
#pragma unroll
          for (int f = 0; f < NFM; ++f)
            if (f < nf)
              upd = fmaf(o ? c_obs[f] : c_un[f],
                         ldv<kStaged>(lam[r] + static_cast<long long>(f) * ns
                                      + j), upd);
          const float E = E_s[j] + upd;
          if (!last) {
            E_s[j] = E;
            continue;
          }
          const int fj = a.fam[j];
          float out = E;
          if (a.expected) {
            if (fj == 2) out = normcdff(E);
          } else {
            float eps;
            if (a.noise.eps_out != nullptr) {
              eps = a.noise.eps_out[(static_cast<long long>(nn) * a.B + b) *
                                    ns + j];
            } else {
              const uint4 bits = hmsc::philox4x32_10(
                  make_uint4(static_cast<unsigned>(j), row_id, a.offset,
                             kTagOut), a.key);
              eps = hmsc::box_muller(bits.x, bits.y);
            }
            const float zz = E + sqrtf(ldv<kStaged>(sig + j)) * eps;
            out = (fj == 2) ? (zz > 0.0f ? 1.0f : 0.0f) : zz;
          }
          hmsc::welford(out * a.ys[j] + a.ym[j], inv_count, mo[u], qo[u]);
        }
        if (last) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = j0 + 32 * u;
            if (j < ns) {
              mean_g[j] = mo[u];
              m2_g[j] = qo[u];
            }
          }
        }
      }
    }
    __syncwarp();
  };

  if constexpr (kStaged) {
    if (nd_block > 0) issue(0, 0);
    for (int ld = 0; ld < nd_block; ++ld) {
      const int buf = a.stages == 2 ? (ld & 1) : 0;
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();                 // draw ld has landed everywhere
      prepare(ld, buf);
      __syncthreads();
      if (a.stages == 2 && ld + 1 < nd_block) issue(ld + 1, buf ^ 1);
      if (ld < nd) one_draw(ld, buf);
      if (a.stages == 1 && ld + 1 < nd_block) {
        __syncthreads();               // every warp is done with the stage
        issue(ld + 1, 0);
      }
    }
  } else {
    for (int ld = 0; ld < nd; ++ld) one_draw(ld, 0);
  }
}

template <typename T, int NFM>
cudaError_t launch(const Args& a, int warps, cudaStream_t st) {
  auto kernel = a.stages > 0 ? serve_conditional_kernel<T, NFM, true>
                             : serve_conditional_kernel<T, NFM, false>;
  const int smem = static_cast<int>(a.L.total);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  if (warps > warps_for<NFM>()) return cudaErrorInvalidValue;
  const dim3 grid((a.B + a.rows - 1) / a.rows, (a.S + a.slots - 1) / a.slots);
  kernel<<<grid, warps * 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_nf(int nfm, const Args& a, int warps, cudaStream_t st) {
  switch (nfm) {
    case 4: return launch<T, 4>(a, warps, st);
    case 8: return launch<T, 8>(a, warps, st);
    case 16: return launch<T, 16>(a, warps, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// nfm: 4, 8 or 16, at least every level's nf.  A block of rows x slots
// warps owns `rows` query rows, each slot a chunk of D draws (S chunks in
// all, grid (ceil(B / rows), ceil(S / slots))), with `stages` (0, 1 or 2)
// copies of a draw's operands a slot in shared memory; pmean / pm2 (S, B,
// ns) scratch; mean / sd (B, ns).  The four noise tensors are all given
// (eps_out may be null in expected mode) or all null.  lam / eta: host
// arrays of nr device pointers.
extern "C" int hmsc_serve_conditional(
    const float* X, const int* uidx, const float* Yc, const float* mask,
    const void* Beta, const void* sigma, const unsigned long long* lam,
    const unsigned long long* eta, const int* nf, const int* np, int nr,
    const int* fam, const float* ym, const float* ys, const float* eps_z,
    const float* u_z, const float* eps_rows, const float* eps_out,
    float* pmean, float* pm2, float* mean, float* sd, int n, int B, int ns,
    int nc, int steps, int nfm, int rows, int slots, int stages, int D,
    int S, int bf16, int expected, unsigned long long seed, unsigned offset,
    void* stream) {
  const int warps = rows * slots;
  if (nr > hmsc::kMaxLevels || nc > kMaxNc || D < 1 || S < 1 ||
      (S - 1) * D >= n || steps < 0 || rows < 1 || slots < 1 ||
      warps > kMaxWarps || stages < 0 || stages > 2 || ns > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int nft = 0;
  for (int r = 0; r < nr; ++r) {
    if (nf[r] > nfm) return static_cast<int>(cudaErrorInvalidValue);
    nft += nf[r];
  }
  if (nft > kMaxNft) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.L = make_layout(ns, nc, nf, nr, nfm, bf16 ? 2 : 4, slots, stages, warps);
  if (a.L.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  a.lv = hmsc::make_level_table(lam, eta, nf, np, nr);
  if (B == 0 || ns == 0) return 0;
  a.X = X;
  a.uidx = uidx;
  a.Yc = Yc;
  a.mask = mask;
  a.Beta = Beta;
  a.sigma = sigma;
  a.fam = fam;
  a.ym = ym;
  a.ys = ys;
  a.noise = Noise{eps_z, u_z, eps_rows, eps_out};
  a.pmean = pmean;
  a.pm2 = pm2;
  a.n = n;
  a.B = B;
  a.ns = ns;
  a.nc = nc;
  a.steps = steps;
  a.expected = expected;
  a.rows = rows;
  a.slots = slots;
  a.stages = stages;
  a.D = D;
  a.S = S;
  a.key = hmsc::seed_key(seed);
  a.offset = offset;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? launch_nf<__nv_bfloat16>(nfm, a, warps, st)
                         : launch_nf<float>(nfm, a, warps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hmsc::launch_combine(
      pmean, pm2, mean, sd, static_cast<long long>(B) * ns, n, D, S, st));
}
