// B9a: the fused marginal prediction of the serving engine and of offline
// predict(): linear predictor, link, back-scaling, and the moments over the
// posterior draws (or the draws themselves).
//
// Replaces hmsc_tpu/serve/kernels.py · make_predict_kernel with
// _apply_link_expected / _apply_link_sampled (:109-183), and the shared
// linear_predictor (:52-105) on offline predict's path, which the JAX
// package wrote as einsums over a materialised (n, B, ns) block.  For query
// rows b, species j and draws n:
//
//   L = X[b] . Beta[n, :, j] + sum_r Eta_r[n, uidx[r, b], :] . Lambda_r[n, :, j]
//   expected: ndtr(L) (probit), exp(L + sigma / 2) (Poisson), L (normal)
//   sampled:  Z = L + sqrt(sigma) eps;  Z > 0 (probit), a Poisson draw at
//             exp(min(Z, 30)) (Poisson), Z (normal)
//   y = out * ys[j] + ym[j]
//
// then either the mean and population sd of y over the draws (ddof 0, as
// jnp.std), or y itself for every draw (the (n, B, ns) block B9c and
// offline predict read), or both.
//
// What bounds it on the H100: at the headline (800 draws, nc 2, nf 8, 1000
// species) every query reads all the draws' Beta, Lambda and sigma, ~35 MB
// (0.0105 ms at 3.35 TB/s), and does 2 (nc + nf) B ns n flops (0.015 ms at
// B 64).  But each cell's epilogue (normcdff or expf, the scaling, a
// Welford step) issues ~3x the instructions of its 10 multiply-adds, so at
// B 64 the floor is the issue rate (~0.05 ms), and in draws mode the 205 MB
// of (n, B, ns) output (0.061 ms).  Tensor cores do not pay here: K = nc +
// nf is ~10, and TF32 or bf16 products would miss the 1e-5 gate against
// float32; the products stay float32 FMAs.
//
// The first design (128 species a block, a row tile of 8 a thread over the
// grid's y, Eta staged eight draws at a time behind two barriers, four
// loads in flight a thread) read every draw once per row tile, 8 times at
// B 64.  This design:
//   - a block owns 64 species (two a lane) and a draw chunk, and all query
//     rows up to 64 (row tiles of 64 past that), so each draw's Beta,
//     Lambda and sigma are read once a query; its warps take RB rows each
//     (RB x 2 cells a thread in registers) and, below 64 rows, the draws of
//     a stage in turn (WD draw slots; ops/serve.py · predict_geometry, a
//     function of the shape alone, fills the card at B 1 and B 64);
//   - each draw's slab, the (nc + nf + 1) x 64 rows of Beta, Lambda_r and
//     sigma (contiguous in j), and the query rows' Eta (gathered by uidx)
//     are copied by 4-byte cp.async (16-byte copies of whole rows measured
//     no faster) into a ring of 4 shared-memory stages, so three draws'
//     loads are in flight while one computes; one barrier a stage;
//   - the levels are resolved on the host into a flat per-factor (level,
//     column) map, and each block builds its Eta gather table once, so the
//     staging loop does no division and no search;
//   - a row's covariates and factors sit together as one padded float row
//     (X written once, Eta each stage) read four at a time as a broadcast,
//     each slab value feeding RB multiply-adds;
//   - Welford moments per thread, the draw slots combined by a fixed tree
//     in shared memory (3 steps for 8 slots, one reciprocal a step), then
//     the chunks in chunk order by a second kernel (serve_common.cuh): no
//     atomics, two runs are bit-identical.
// Draws load as float32 or bfloat16 (template): bfloat16 rows are copied as
// the aligned words that hold them (the tensors' storage is 4-byte aligned)
// and widened in registers, Eta through one conversion pass a stage.
// Sampled mode draws from Philox (philox.cuh) keyed by the cell (draw, row,
// species); the Poisson draw is Knuth's product of uniforms below a rate of
// 10 and Hormann's transformed rejection (PTRS, in double) above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "philox.cuh"
#include "serve_common.cuh"

namespace {

constexpr int kTJ = 64;          // species a block, two a lane
constexpr int kMaxWarps = 8;
constexpr int kStages = 4;       // the ring of draws
constexpr int kMaxNc = 64;
constexpr int kMaxNf = 64;       // factors over all levels
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ double uniform_double(unsigned bits) {
  return (static_cast<double>(bits) + 0.5) * 2.3283064365386963e-10;
}

// A Poisson draw at rate lam.  `first` supplies two uniforms (z, w); more
// come from Philox at the cell's counter with rounds 1, 2, ... in ctr.w.
__device__ float poisson_draw(float lam, uint4 ctr, uint2 key, uint4 first) {
  if (isnan(lam)) return nan_f();
  if (!(lam > 0.0f)) return 0.0f;
  unsigned pool[4] = {first.z, first.w, 0u, 0u};
  int avail = 2, taken = 0;
  unsigned round = 1;
  auto next = [&]() -> unsigned {
    if (taken == avail) {
      ctr.w = round++;
      const uint4 b = hmsc::philox4x32_10(ctr, key);
      pool[0] = b.x; pool[1] = b.y; pool[2] = b.z; pool[3] = b.w;
      avail = 4;
      taken = 0;
    }
    return pool[taken++];
  };
  if (lam < 10.0f) {
    // Knuth: the number of uniforms whose running product stays above
    // exp(-lam), less one
    const float floor_p = expf(-lam);
    float p = 1.0f;
    for (int k = 0; k < 1000; ++k) {
      p *= hmsc::uniform01(next());
      if (p <= floor_p) return static_cast<float>(k);
    }
    return nan_f();
  }
  // PTRS (Hormann 1993), as numpy's random_poisson_ptrs
  const double L = lam;
  const double slam = sqrt(L), loglam = log(L);
  const double b = 0.931 + 2.53 * slam;
  const double a = -0.059 + 0.02483 * b;
  const double invalpha = 1.1239 + 1.1328 / (b - 3.4);
  const double vr = 0.9277 - 3.6224 / (b - 2.0);
  for (int it = 0; it < 1000; ++it) {
    const double U = uniform_double(next()) - 0.5;
    const double V = uniform_double(next());
    const double us = 0.5 - fabs(U);
    const double k = floor((2.0 * a / us + b) * U + L + 0.43);
    if (us >= 0.07 && V <= vr) return static_cast<float>(k);
    if (k < 0.0 || (us < 0.013 && V > us)) continue;
    if (log(V) + log(invalpha) - log(a / (us * us) + b) <=
        -L + k * loglam - lgamma(k + 1.0))
      return static_cast<float>(k);
  }
  return nan_f();
}

template <typename T>
struct PredictArgs {
  const float* X;
  const int* uidx;
  const T* Beta;
  const T* sigma;
  const T* lam[hmsc::kMaxLevels];
  const T* eta[hmsc::kMaxLevels];
  int nf[hmsc::kMaxLevels];
  int np[hmsc::kMaxLevels];
  int fl[kMaxNf];  // factor f of a query row: level fl[f], column fc[f]
  int fc[kMaxNf];
  int nr, nft;
  const int* fam;
  const float* ym;
  const float* ys;
  float* draws;
  float* pmean;
  float* pm2;
  int n, B, ns, nc, D, WR, WD;
  uint2 key;
  unsigned offset;
};

// Byte offsets into the dynamic shared memory (ops/serve.py ·
// _predict_smem computes the same total).  A ring stage holds WD draw
// slots; a slot holds the RT x RP row block (X, then Eta), the RP + 1 slab
// rows of TW words (Beta and Lambda in rows 0 .. KL - 1, zero rows up to
// RP, sigma in row RP, so the multiply-add loop reads whole groups of four
// rows with no test), and for bfloat16 the Eta words, their halves and the
// slab rows' halves.  The tables follow the ring; the draw slots' moments
// reuse it.
template <typename T>
__host__ __device__ constexpr int slab_words() {
  return std::is_same<T, float>::value ? kTJ : kTJ / 2 + 2;
}

struct Layout {
  int RP, K;
  size_t slab, eraw, esh, soff, slot, stage, rowptr, rowstr, eitem, lvptr,
      lvstr, total;
};

constexpr size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

Layout make_layout(int nc, int nft, int RT, int WD, bool bf16) {
  Layout L{};
  L.RP = static_cast<int>(round_up(nc + nft, 4));
  L.K = nc + nft + 1;
  const int TW = bf16 ? slab_words<__nv_bfloat16>() : slab_words<float>();
  const size_t rowvec = sizeof(float) * RT * L.RP;
  L.slab = rowvec;
  L.eraw = L.slab + sizeof(uint32_t) * (L.RP + 1) * TW;
  L.esh = L.eraw + (bf16 ? sizeof(uint32_t) * RT * nft : 0);
  L.soff = L.esh + (bf16 ? round_up(RT * nft, 4) : 0);
  L.slot = round_up(L.soff + (bf16 ? round_up(L.RP + 1, 4) : 0), 16);
  L.stage = WD * L.slot;
  const size_t ring = kStages * L.stage;
  const size_t comb = sizeof(float) * 2 * (WD / 2) * RT * kTJ;
  L.rowptr = round_up(ring > comb ? ring : comb, 16);
  L.rowstr = L.rowptr + sizeof(void*) * L.K;
  L.eitem = L.rowstr + sizeof(long long) * L.K;
  L.lvptr = L.eitem + sizeof(int2) * RT * nft;
  L.lvstr = L.lvptr + sizeof(void*) * hmsc::kMaxLevels;
  L.total = L.lvstr + sizeof(long long) * hmsc::kMaxLevels;
  return L;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float widen_half(unsigned word, int high) {
  return __uint_as_float(high ? (word & 0xffff0000u) : (word << 16));
}

// species jj of slab row k: float32 words, or bfloat16 halves from the
// row's first half soff[k]
template <typename T>
__device__ __forceinline__ float slab_at(const uint32_t* slab,
                                         const unsigned char* soff, int k,
                                         int jj) {
  constexpr int TW = slab_words<T>();
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(slab[k * TW + jj]);
  } else {
    const unsigned short* h =
        reinterpret_cast<const unsigned short*>(slab + k * TW);
    return __uint_as_float(static_cast<unsigned>(h[soff[k] + jj]) << 16);
  }
}

template <typename T, int RB, bool EXP>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    serve_predict_kernel(const PredictArgs<T> p, const Layout L) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int WD = p.WD, wr = warp % p.WR, wd = warp / p.WR;
  const int RT = p.WR * RB;
  const int j0 = blockIdx.x * kTJ, b0 = blockIdx.y * RT;
  const int rows = min(RT, p.B - b0);
  const int d0 = blockIdx.z * p.D, d1 = min(p.n, d0 + p.D);
  const int nc = p.nc, nft = p.nft, KL = nc + nft, K = L.K;
  const int RP = L.RP;
  constexpr int TW = slab_words<T>();
  const int tv = min(kTJ, p.ns - j0);
  const int items = rows * nft;
  const T** rowptr = reinterpret_cast<const T**>(smem + L.rowptr);
  long long* rowstr = reinterpret_cast<long long*>(smem + L.rowstr);
  int2* eitem = reinterpret_cast<int2*>(smem + L.eitem);
  const T** lvptr = reinterpret_cast<const T**>(smem + L.lvptr);
  long long* lvstr = reinterpret_cast<long long*>(smem + L.lvstr);

  // the block's tables: each slab row's source at draw 0 and its step a
  // draw; each (row, factor)'s Eta offset within a draw, its level and its
  // place in the row block
  for (int k = tid; k < K; k += nthreads) {
    const T* ptr;
    long long str;
    if (k < nc) {
      ptr = p.Beta + static_cast<long long>(k) * p.ns + j0;
      str = static_cast<long long>(nc) * p.ns;
    } else if (k < KL) {
      const int r = p.fl[k - nc];
      ptr = p.lam[r] + static_cast<long long>(p.fc[k - nc]) * p.ns + j0;
      str = static_cast<long long>(p.nf[r]) * p.ns;
    } else {
      ptr = p.sigma + j0;
      str = p.ns;
    }
    rowptr[k] = ptr;
    rowstr[k] = str;
  }
  if (tid < p.nr) {
    lvptr[tid] = p.eta[tid];
    lvstr[tid] = static_cast<long long>(p.np[tid]) * p.nf[tid];
  }
  for (int i = tid; i < items; i += nthreads) {
    const int b = i / nft, f = i - b * nft;
    const int r = p.fl[f];
    const int u = p.uidx[r * p.B + b0 + b];
    eitem[i] = make_int2(u * p.nf[r] + p.fc[f], ((b * RP + nc + f) << 4) | r);
  }
  // every slot's row block: X once, zero elsewhere (padding rows stay 0);
  // one load an entry, stored to every slot; and the slab's zero rows
  for (int i = tid; i < RT * RP; i += nthreads) {
    const int b = i / RP, c = i - b * RP;
    const float v = b < rows && c < nc ? p.X[(b0 + b) * nc + c] : 0.0f;
    for (int s = 0; s < kStages * WD; ++s)
      reinterpret_cast<float*>(smem + s * L.slot)[i] = v;
  }
  for (int i = tid; i < (RP - KL) * TW; i += nthreads)
    for (int s = 0; s < kStages * WD; ++s) {
      unsigned char* base = smem + s * L.slot;
      reinterpret_cast<uint32_t*>(base + L.slab)[KL * TW + i] = 0u;
      if (!kF32 && i < RP - KL) base[L.soff + KL + i] = 0;
    }
  __syncthreads();

  // copy the draws of stage st (draw d0 + st WD + slot) into ring slot
  auto issue = [&](int st) {
    unsigned char* stage = smem + (st % kStages) * L.stage;
    for (int slot = 0; slot < WD; ++slot) {
      const long long nn = d0 + st * WD + slot;
      if (nn >= d1) break;
      unsigned char* base = stage + slot * L.slot;
      uint32_t* slab = reinterpret_cast<uint32_t*>(base + L.slab);
      for (int k = warp; k < K; k += nwarps) {
        const T* row = rowptr[k] + nn * rowstr[k];
        uint32_t* dst = slab + (k < KL ? k : RP) * TW;  // sigma: row RP
        if constexpr (kF32) {
          for (int w = lane; w < kTJ; w += 32) {
            const bool ok = w < tv;
            cp_async4(dst + w, ok ? row + w : row, ok ? 4 : 0);
          }
        } else {
          // the aligned words holding halves off .. off + tv - 1
          const uintptr_t at = reinterpret_cast<uintptr_t>(row);
          const int off = static_cast<int>((at >> 1) & 1);
          const unsigned char* al =
              reinterpret_cast<const unsigned char*>(at - 2 * off);
          for (int w = lane; w < TW; w += 32) {
            const int nh = min(2, max(0, off + tv - 2 * w));
            cp_async4(dst + w, nh ? al + 4 * w : al, 2 * nh);
          }
          if (lane == 0)
            base[L.soff + (k < KL ? k : RP)] = static_cast<unsigned char>(off);
        }
      }
      for (int i = tid; i < items; i += nthreads) {
        const int2 it = eitem[i];
        const T* src = lvptr[it.y & 15] + nn * lvstr[it.y & 15] + it.x;
        if constexpr (kF32) {
          cp_async4(reinterpret_cast<float*>(base) + (it.y >> 4), src, 4);
        } else {
          const uintptr_t at = reinterpret_cast<uintptr_t>(src);
          const int high = static_cast<int>((at >> 1) & 1);
          cp_async4(reinterpret_cast<uint32_t*>(base + L.eraw) + i,
                    reinterpret_cast<const void*>(at - 2 * high),
                    high ? 4 : 2);
          base[L.esh + i] = static_cast<unsigned char>(high);
        }
      }
    }
    cp_commit();
  };

  float ysj[2], ymj[2];
  int famj[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int jj = lane + 32 * h;
    const bool ok = jj < tv;
    famj[h] = ok ? p.fam[j0 + jj] : 0;
    ymj[h] = ok ? p.ym[j0 + jj] : 0.0f;
    ysj[h] = ok ? p.ys[j0 + jj] : 0.0f;
  }
  const bool mom = p.pmean != nullptr;
  float mean[RB][2], m2[RB][2];
#pragma unroll
  for (int t = 0; t < RB; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) mean[t][h] = m2[t][h] = 0.0f;
  int count = 0;

  const int nst = (d1 - d0 + WD - 1) / WD;
  for (int st = 0; st < kStages - 1; ++st) issue(st);
  for (int st = 0; st < nst; ++st) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage st landed; stage st - 1 is read no more
    issue(st + kStages - 1);
    unsigned char* stage = smem + (st % kStages) * L.stage;
    if constexpr (!kF32) {  // the stage's Eta halves into the row blocks
      for (int slot = 0; slot < WD; ++slot) {
        if (d0 + st * WD + slot >= d1) break;
        unsigned char* base = stage + slot * L.slot;
        const uint32_t* raw = reinterpret_cast<const uint32_t*>(base + L.eraw);
        float* rv = reinterpret_cast<float*>(base);
        for (int i = tid; i < items; i += nthreads)
          rv[eitem[i].y >> 4] = widen_half(raw[i], base[L.esh + i]);
      }
      __syncthreads();
    }
    const int nn = d0 + st * WD + wd;
    if (nn >= d1) continue;
    const unsigned char* base = stage + wd * L.slot;
    const float* rv = reinterpret_cast<const float*>(base) + wr * RB * RP;
    const uint32_t* slab = reinterpret_cast<const uint32_t*>(base + L.slab);
    const unsigned char* soff = base + L.soff;
    float acc[RB][2];
#pragma unroll
    for (int t = 0; t < RB; ++t) acc[t][0] = acc[t][1] = 0.0f;
    for (int k4 = 0; k4 < KL; k4 += 4) {
      float a[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[q][h] = slab_at<T>(slab, soff, k4 + q, lane + 32 * h);
#pragma unroll
      for (int t = 0; t < RB; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(rv + t * RP + k4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = acc[t][h];
          x = fmaf(v.x, a[0][h], x);
          x = fmaf(v.y, a[1][h], x);
          x = fmaf(v.z, a[2][h], x);
          acc[t][h] = fmaf(v.w, a[3][h], x);
        }
      }
    }
    float sig[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sig[h] = slab_at<T>(slab, soff, RP, lane + 32 * h);
    const float inv_count = 1.0f / static_cast<float>(++count);
    // the link a species column at a time, over the thread's RB rows with
    // no branch between them, so their chains interleave; padding rows and
    // species (zero rows, zero slab) are computed and not stored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int jj = lane + 32 * h;
      const long long cell0 =
          (nn * static_cast<long long>(p.B) + b0 + wr * RB) * p.ns + j0 + jj;
      float out[RB];
      if constexpr (EXP) {
        if (famj[h] == 2) {
#pragma unroll
          for (int t = 0; t < RB; ++t) out[t] = normcdff(acc[t][h]);
        } else if (famj[h] == 3) {
          const float half = sig[h] / 2.0f;
#pragma unroll
          for (int t = 0; t < RB; ++t) out[t] = expf(acc[t][h] + half);
        } else {
#pragma unroll
          for (int t = 0; t < RB; ++t) out[t] = acc[t][h];
        }
      } else {
        const float sd = sqrtf(sig[h]);
#pragma unroll
        for (int t = 0; t < RB; ++t) {
          const long long cell = cell0 + static_cast<long long>(t) * p.ns;
          const uint4 bits = hmsc::philox4x32_10(
              make_uint4(static_cast<unsigned>(cell),
                         static_cast<unsigned>(cell >> 32), p.offset, 0u),
              p.key);
          out[t] = acc[t][h] + sd * hmsc::box_muller(bits.x, bits.y);
        }
        if (famj[h] == 2) {
#pragma unroll
          for (int t = 0; t < RB; ++t) out[t] = out[t] > 0.0f ? 1.0f : 0.0f;
        } else if (famj[h] == 3) {
          for (int t = 0; t < RB; ++t) {  // the cell's Philox bits again
            const long long cell = cell0 + static_cast<long long>(t) * p.ns;
            const uint4 ctr = make_uint4(static_cast<unsigned>(cell),
                                         static_cast<unsigned>(cell >> 32),
                                         p.offset, 0u);
            out[t] = poisson_draw(expf(fminf(out[t], 30.0f)), ctr, p.key,
                                  hmsc::philox4x32_10(ctr, p.key));
          }
        }
      }
#pragma unroll
      for (int t = 0; t < RB; ++t) out[t] = out[t] * ysj[h] + ymj[h];
      if (mom) {
#pragma unroll
        for (int t = 0; t < RB; ++t)
          hmsc::welford(out[t], inv_count, mean[t][h], m2[t][h]);
      }
      if (p.draws != nullptr) {
#pragma unroll
        for (int t = 0; t < RB; ++t)
          if (wr * RB + t < rows && jj < tv)
            p.draws[cell0 + static_cast<long long>(t) * p.ns] = out[t];
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free
  if (!mom) return;
  if (WD > 1) {  // the draw slots' moments: a fixed tree over the slots
    const int total = d1 - d0;
    auto slot_count = [&](int w) {  // draws slot w took
      return static_cast<float>(max(0, (total - w + WD - 1) / WD));
    };
    float* cm = reinterpret_cast<float*>(smem);
    float* cq = cm + (WD / 2) * RT * kTJ;
    float cnt = slot_count(wd);
    for (int step = 1; step < WD; step *= 2) {
      const int at = (wd / (2 * step) * RT + wr * RB) * kTJ + lane;
      if (wd % (2 * step) == step) {  // hands its moments to wd - step
#pragma unroll
        for (int t = 0; t < RB; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            cm[at + t * kTJ + 32 * h] = mean[t][h];
            cq[at + t * kTJ + 32 * h] = m2[t][h];
          }
      }
      __syncthreads();
      if (wd % (2 * step) == 0) {  // takes slots wd + step .. wd + 2 step - 1
        float nb = 0.0f;
        for (int w = wd + step; w < wd + 2 * step; ++w) nb += slot_count(w);
        if (nb > 0.0f) {
          const float tot = cnt + nb, r = 1.0f / tot;
#pragma unroll
          for (int t = 0; t < RB; ++t)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float delta = cm[at + t * kTJ + 32 * h] - mean[t][h];
              mean[t][h] += delta * (nb * r);
              m2[t][h] += cq[at + t * kTJ + 32 * h] +
                          delta * delta * (cnt * nb * r);
            }
          cnt = tot;
        }
      }
      __syncthreads();
    }
  }
  if (wd != 0) return;
#pragma unroll
  for (int t = 0; t < RB; ++t) {
    const int b = wr * RB + t;
    if (b >= rows) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int jj = lane + 32 * h;
      if (jj >= tv) continue;
      const long long i =
          (static_cast<long long>(blockIdx.z) * p.B + b0 + b) * p.ns + j0 +
          jj;
      p.pmean[i] = mean[t][h];
      p.pm2[i] = m2[t][h];
    }
  }
}

template <typename T, int RB, bool EXP>
cudaError_t launch(const PredictArgs<T>& p, const Layout& L, dim3 grid,
                   int threads, cudaStream_t st) {
  auto kern = serve_predict_kernel<T, RB, EXP>;
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.total));
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, L.total, st>>>(p, L);
  return cudaGetLastError();
}

template <typename T, bool EXP>
cudaError_t launch_rows(int rb, const PredictArgs<T>& p, const Layout& L,
                        dim3 grid, int threads, cudaStream_t st) {
  switch (rb) {
    case 1: return launch<T, 1, EXP>(p, L, grid, threads, st);
    case 2: return launch<T, 2, EXP>(p, L, grid, threads, st);
    case 4: return launch<T, 4, EXP>(p, L, grid, threads, st);
    case 8: return launch<T, 8, EXP>(p, L, grid, threads, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(PredictArgs<T>& p, const void* Beta, const void* sigma,
                const unsigned long long* lam, const unsigned long long* eta,
                int rb, int S, int smem, int expected, cudaStream_t st) {
  p.Beta = static_cast<const T*>(Beta);
  p.sigma = static_cast<const T*>(sigma);
  for (int r = 0; r < p.nr; ++r) {
    p.lam[r] = reinterpret_cast<const T*>(lam[r]);
    p.eta[r] = reinterpret_cast<const T*>(eta[r]);
  }
  const int RT = p.WR * rb;
  const Layout L = make_layout(p.nc, p.nft, RT, p.WD,
                               !std::is_same<T, float>::value);
  if (L.total > kMaxSmem || L.total != static_cast<size_t>(smem))
    return cudaErrorInvalidValue;  // the caller's geometry disagrees
  const dim3 grid((p.ns + kTJ - 1) / kTJ, (p.B + RT - 1) / RT, S);
  const int threads = 32 * p.WR * p.WD;
  return expected ? launch_rows<T, true>(rb, p, L, grid, threads, st)
                  : launch_rows<T, false>(rb, p, L, grid, threads, st);
}

}  // namespace

// Geometry (ops/serve.py · predict_geometry): rb rows a warp, wr warps over
// rows and wd over draws (wr wd <= 8), the draws split into S chunks of D,
// smem the bytes of shared memory it sized the block for (checked here).
// fl / fc: host arrays of the flat factor map (level, column) over the
// nf_total factors of a query row; lam / eta: host arrays of nr device
// pointers.  pmean / pm2 (S, B, ns) scratch and mean / sd (B, ns) for the
// moments, or all four null; draws (n, B, ns) or null.  bf16 != 0: the
// draws are bfloat16.
extern "C" int hmsc_serve_predict(
    const float* X, const int* uidx, const void* Beta, const void* sigma,
    const unsigned long long* lam, const unsigned long long* eta,
    const int* nf, const int* np, int nr, const int* fl, const int* fc,
    const int* fam, const float* ym, const float* ys, float* draws,
    float* pmean, float* pm2, float* mean, float* sd, int n, int B, int ns,
    int nc, int rb, int wr, int wd, int D, int S, int smem, int bf16,
    int expected, unsigned long long seed, unsigned offset, void* stream) {
  int nft = 0;
  for (int r = 0; r < nr && r < hmsc::kMaxLevels; ++r) nft += nf[r];
  if (nr > hmsc::kMaxLevels || nc > kMaxNc || nft > kMaxNf || D < 1 ||
      S < 1 || (S - 1) * D >= n || (rb != 1 && rb != 2 && rb != 4 &&
                                    rb != 8) ||
      wr < 1 || wd < 1 || wr * wd > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int f = 0; f < nft; ++f)
    if (fl[f] < 0 || fl[f] >= nr || fc[f] < 0 || fc[f] >= nf[fl[f]])
      return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || ns == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    PredictArgs<__nv_bfloat16> p{};
    p.X = X; p.uidx = uidx; p.fam = fam; p.ym = ym; p.ys = ys;
    p.draws = draws; p.pmean = pmean; p.pm2 = pm2;
    p.nr = nr; p.nft = nft; p.n = n; p.B = B; p.ns = ns; p.nc = nc;
    p.D = D; p.WR = wr; p.WD = wd; p.key = hmsc::seed_key(seed);
    p.offset = offset;
    for (int r = 0; r < nr; ++r) { p.nf[r] = nf[r]; p.np[r] = np[r]; }
    for (int f = 0; f < nft; ++f) { p.fl[f] = fl[f]; p.fc[f] = fc[f]; }
    err = run(p, Beta, sigma, lam, eta, rb, S, smem, expected, st);
  } else {
    PredictArgs<float> p{};
    p.X = X; p.uidx = uidx; p.fam = fam; p.ym = ym; p.ys = ys;
    p.draws = draws; p.pmean = pmean; p.pm2 = pm2;
    p.nr = nr; p.nft = nft; p.n = n; p.B = B; p.ns = ns; p.nc = nc;
    p.D = D; p.WR = wr; p.WD = wd; p.key = hmsc::seed_key(seed);
    p.offset = offset;
    for (int r = 0; r < nr; ++r) { p.nf[r] = nf[r]; p.np[r] = np[r]; }
    for (int f = 0; f < nft; ++f) { p.fl[f] = fl[f]; p.fc[f] = fc[f]; }
    err = run(p, Beta, sigma, lam, eta, rb, S, smem, expected, st);
  }
  if (err != cudaSuccess || mean == nullptr) return static_cast<int>(err);
  return static_cast<int>(hmsc::launch_combine(
      pmean, pm2, mean, sd, static_cast<long long>(B) * ns, n, D, S, st));
}
