// B5: the (lognormal-)Poisson latent-response update, as one kernel: the
// whole Z update of a model with Poisson columns.
//
// Replaces hmsc_tpu/ops/rand.py · _pg_moments / polya_gamma and the Poisson
// branch of hmsc_tpu/mcmc/updaters.py · update_z, which the JAX package
// wrote as whole-array ops shaped for the TPU's vector units.  Poisson is
// the r -> inf limit of a negative binomial with r = 1000 (reference
// updateZ.R:68): per cell of a Poisson column
//
//   w  ~ PG(Y + r, Zprev - log r)      moment-matched normal, floored at 1e-38
//   s2 = 1 / (iSigma + w)
//   mu = s2 ((Y - r) / 2 + iSigma (E - log r)) + log r
//   Z  = mu + sqrt(s2) eps2,           Zprev where Z is not finite.
//
// The PG mean is the JAX op's, including its series branch for |z| / 2 <
// 1e-3; the variance is its Taylor series below |z| / 2 = 0.5, where the
// JAX op's closed form cancels (ops/rand.py · _pg_moments says why).
//
// The kernel is the whole of update_z (hmsc_tpu/mcmc/updaters.py:135-205)
// on a model with Poisson columns, in one launch: per cell, by the column's
// family, normal (1) -> Y, probit (2) -> B1's one-sided truncated normal
// (truncnorm.cuh, with B1's float32 guards) at sd = iSigma^-1/2, Poisson
// (3) -> the draw above at Zprev, any other family -> Zprev; then, where
// Ymask is 0, E + sd eps.  It replaces the sweep's ~9 launches of the Z
// block (B1's E-reading form, B5's first version and the torch ops that
// select between them and impute).  The Poisson branch alone, the JAX op's
// signature (ops/rand.py · poisson_z), is this kernel with the other
// columns' families set to 0 and no mask.
//
// What bounds it on the H100: instruction throughput, then bytes.  The first
// version (one thread a cell, a Philox call and two Box-Muller normals a
// cell, a log, a sqrt and a cosine each, tanhf and four IEEE divisions)
// took 0.0582 ms at 4 chains x 1000 x 1000, where its 52 MB take 0.0155.
// Design:
//   - B1's layout: a grid over (column tile, row tile, chain), 32-bit
//     indices within a chain; a thread owns 4 consecutive columns of 4
//     rows on large blocks, so Zprev, E, Y, Z (and injected draws) move as
//     128-bit loads and stores where ns % 4 == 0, its columns' iSigma and
//     family loaded once; on small blocks 2 columns of 1 row (64-bit
//     accesses: at config 5's 4 x 300 x 90, 4 x 4 cells a thread left
//     ~7000 threads, whose dependent chains set the time: 0.0068 ms
//     against 0.0027);
//   - one Philox call feeds two cells: its four words make two Box-Muller
//     pairs, each one log2 and one rsqrt on the flush-to-zero units and
//     one fast sine and cosine for two normals (the uniform's 23 bits
//     centred in their cell, so the log's argument is never 0 or
//     subnormal; sincospif took 0.0314 ms, 0.0277 with __sincosf).
//     Counters: (p, row, chain, offset + 1) for the pair of columns 2p,
//     2p + 1, in both layouts; the probit uniforms are B1's, (g, row,
//     chain, offset) for the columns 4g .. 4g + 3, the imputation normals
//     (g, row, chain, offset + 2).  A cell's draws are made only where its
//     family (and, with NA, its mask) needs them;
//   - divisions are reciprocals on the fast units, (y - r) / 2 a multiply,
//     the variance's series FMAs;
//   - injected tensors replace any of the draws, so the kernel can be
//     compared with its plain version on identical inputs.

#include <cuda_runtime.h>

#include "philox.cuh"
#include "truncnorm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNbR = 1000.0f;
constexpr float kLogNbR = 6.9077552789821368f;   // log(1000)

struct PArgs {
  const float* Y;                        // (ny, ns)
  const float* Zprev;                    // (C, ny, ns)
  const float* E;                        // (C, ny, ns)
  const float* iSigma;                   // (C, ns)
  const int* fam;                        // (ns,)
  const float* Ymask;                    // (ny, ns), or null
  const float* U;                        // probit uniforms, or null
  const float* EPG;                      // the PG normals, or null
  const float* EZ;                       // the Z normals (with EPG)
  const float* ENA;                      // the imputation normals, or null
  float* Z;                              // (C, ny, ns)
  int ny, ns, lg_tcg;
  hmsc::PhiloxKeys keys;
  unsigned offset;
};

// kW consecutive floats: one 128- or 64-bit access where `kVec`, else
// scalar accesses within the n valid ones.
template <bool kVec, int kW>
__device__ __forceinline__ void loadw(const float* p, int n,
                                      float (&v)[kW]) {
  if (kVec && kW == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else if (kVec && kW == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = w.x; v[1] = w.y;
  } else {
#pragma unroll
    for (int q = 0; q < kW; ++q) v[q] = q < n ? p[q] : 0.0f;
  }
}

template <bool kVec, int kW>
__device__ __forceinline__ void storew(float* p, int n,
                                       const float (&v)[kW]) {
  if (kVec && kW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if (kVec && kW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < kW; ++q)
      if (q < n) p[q] = v[q];
  }
}

// Two standard normals from two Philox words (Box-Muller): the radius
// from a uniform on [2^-24, 1 - 2^-24] (23 bits, centred), the angle's
// sine and cosine on the fast units (absolute error ~4e-7 on [-pi, pi)).
__device__ __forceinline__ float2 normal_pair(unsigned b0, unsigned b1) {
  const float u = fmaf(static_cast<float>(b0 >> 9), 1.0f / 8388608.0f,
                       1.0f / 16777216.0f);
  // -2 ln u = -2 ln 2 log2 u, floored above 0 (the fast log2 near u = 1)
  const float w = fmaxf(-1.3862943611198906f * hmsc::lg2_ftz(u), 1e-30f);
  const float r = w * hmsc::rsqrt_ftz(w);
  float s, c;                             // the angle on [-pi, pi)
  __sincosf(fmaf(static_cast<float>(b1 >> 8), 6.2831853f / 16777216.0f,
                 -3.14159265f), &s, &c);
  return make_float2(r * c, r * s);
}

// The Poisson cell: w ~ PG(y + r, zprev - log r), then Z | w.
__device__ __forceinline__ float pg_z(float y, float zprev, float e,
                                      float prec, float e1, float e2) {
  const float h = y + kNbR;
  const float u = 0.5f * fabsf(zprev - kLogNbR);
  const bool small = u < 1e-3f;
  const float us = small ? 1.0f : u;     // safe denominator
  const float ius = hmsc::rcp_ftz(us);
  const float t = tanhf(us);
  const float mean = small ? 0.25f * h * (1.0f - u * u * (1.0f / 3.0f))
                           : h * t * (0.25f * ius);
  float var;
  if (u < 0.5f) {                        // Taylor series in u^2
    const float x = u * u;
    float p = 929569.0f / 729729000.0f;
    p = fmaf(p, x, -5461.0f / 2027025.0f);
    p = fmaf(p, x, 691.0f / 124740.0f);
    p = fmaf(p, x, -31.0f / 2835.0f);
    p = fmaf(p, x, 17.0f / 840.0f);
    p = fmaf(p, x, -1.0f / 30.0f);
    p = fmaf(p, x, 1.0f / 24.0f);
    var = h * p;
  } else {
    const float sech2 = 1.0f - t * t;
    var = h * (t - us * sech2) * (0.0625f * ius * ius * ius);
  }
  const float w = fmaxf(fmaf(sqrtf(var), e1, mean), 1e-38f);
  const float d = prec + w;
  const float s2 = hmsc::rcp_ftz(d);
  const float mu =
      fmaf(s2, fmaf(prec, e - kLogNbR, (y - kNbR) * 0.5f), kLogNbR);
  const float z = fmaf(hmsc::rsqrt_ftz(d), e2, mu);
  return isfinite(z) ? z : zprev;        // the reference's NaN guard
}

template <bool kVec, int kRows, int kW>
__global__ void __launch_bounds__(kThreads)
poisson_z_kernel(const PArgs a) {
  const int c = blockIdx.z;
  const int tcg = 1 << a.lg_tcg;
  const int cg = threadIdx.x & (tcg - 1);
  const int rs = threadIdx.x >> a.lg_tcg;
  const int slots = kThreads >> a.lg_tcg;   // row slots a block
  const int j = (blockIdx.x * tcg + cg) * kW;
  const int row0 = blockIdx.y * slots * kRows;
  if (j >= a.ns) return;
  const int nj = min(kW, a.ns - j);
  const unsigned pair0 = static_cast<unsigned>(j) >> 1;   // PG counters
  const unsigned g = static_cast<unsigned>(j) >> 2;       // the quad's
  const int in_quad = j & 3;                // the thread's first cell in it
  const long long chain = static_cast<long long>(c) * a.ny * a.ns;
  const float* Zp = a.Zprev + chain;
  const float* Ep = a.E + chain;
  float* Zo = a.Z + chain;
  float prec[kW], sd[kW], isd[kW];
  int fm[kW];
  loadw<kVec, kW>(a.iSigma + static_cast<long long>(c) * a.ns + j, nj, prec);
  bool pois[kW / 2] = {}, probit = false;
#pragma unroll
  for (int q = 0; q < kW; ++q) {
    fm[q] = q < nj ? __ldg(a.fam + j + q) : 0;
    pois[q >> 1] |= fm[q] == 3;
    probit |= fm[q] == 2;
    sd[q] = rsqrtf(prec[q]);                // iSigma^-1/2
    isd[q] = prec[q] * sd[q];
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = row0 + rs + r * slots;
    if (i >= a.ny) break;
    const unsigned o = static_cast<unsigned>(i) * a.ns + j;
    float zp[kW], z[kW];
    loadw<kVec, kW>(Zp + o, nj, zp);
    float y[kW], ev[kW], mk[kW];
    float e1[kW] = {}, e2[kW] = {}, u[kW] = {}, en[kW] = {};
    loadw<kVec, kW>(a.Y + o, nj, y);
    loadw<kVec, kW>(Ep + o, nj, ev);
#pragma unroll
    for (int q = 0; q < kW; ++q) mk[q] = 1.0f;
    if (a.Ymask != nullptr) loadw<kVec, kW>(a.Ymask + o, nj, mk);
    bool need_pg[kW / 2], need_u = probit, need_na = false;
#pragma unroll
    for (int hh = 0; hh < kW / 2; ++hh) need_pg[hh] = pois[hh];
    if (a.Ymask != nullptr) {
      need_u = false;
#pragma unroll
      for (int hh = 0; hh < kW / 2; ++hh) need_pg[hh] = false;
#pragma unroll
      for (int q = 0; q < kW; ++q) {
        const bool obs = mk[q] > 0.0f;
        need_pg[q >> 1] |= obs && fm[q] == 3;
        need_u |= obs && fm[q] == 2;
        need_na |= !obs && q < nj;
      }
    }
    if (a.EPG != nullptr) {
      loadw<kVec, kW>(a.EPG + chain + o, nj, e1);
      loadw<kVec, kW>(a.EZ + chain + o, nj, e2);
    } else {
#pragma unroll
      for (int hh = 0; hh < kW / 2; ++hh) {
        if (!need_pg[hh]) continue;
        const uint4 b = hmsc::philox4x32_10(
            make_uint4(pair0 + hh, static_cast<unsigned>(i),
                       static_cast<unsigned>(c), a.offset + 1u),
            a.keys);
        const float2 p0 = normal_pair(b.x, b.y);
        const float2 p1 = normal_pair(b.z, b.w);
        e1[2 * hh] = p0.x;
        e2[2 * hh] = p0.y;
        e1[2 * hh + 1] = p1.x;
        e2[2 * hh + 1] = p1.y;
      }
    }
    if (a.U != nullptr) {
      loadw<kVec, kW>(a.U + chain + o, nj, u);
    } else if (need_u) {
      const uint4 b = hmsc::philox4x32_10(
          make_uint4(g, static_cast<unsigned>(i),
                     static_cast<unsigned>(c), a.offset),
          a.keys);
      const unsigned words[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int q = 0; q < kW; ++q)
        u[q] = hmsc::uniform01(words[in_quad + q]);
    }
    if (a.ENA != nullptr) {
      loadw<kVec, kW>(a.ENA + chain + o, nj, en);
    } else if (need_na) {
      const uint4 b = hmsc::philox4x32_10(
          make_uint4(g, static_cast<unsigned>(i),
                     static_cast<unsigned>(c), a.offset + 2u),
          a.keys);
      const float2 p0 = normal_pair(b.x, b.y);
      const float2 p1 = normal_pair(b.z, b.w);
      const float quad[4] = {p0.x, p0.y, p1.x, p1.y};
#pragma unroll
      for (int q = 0; q < kW; ++q) en[q] = quad[in_quad + q];
    }
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      float zq = zp[q];
      if (mk[q] > 0.0f) {
        if (fm[q] == 3)
          zq = pg_z(y[q], zp[q], ev[q], prec[q], e1[q], e2[q]);
        else if (fm[q] == 1)
          zq = y[q];
        else if (fm[q] == 2)
          zq = hmsc::probit_z_draw(ev[q], sd[q], isd[q], y[q] > 0.5f,
                                   u[q]);
      } else {
        zq = fmaf(sd[q], en[q], ev[q]);    // impute: E + sd eps
      }
      z[q] = zq;
    }
    storew<kVec, kW>(Zo + o, nj, z);
  }
}

template <int kRows, int kW>
int launch(const PArgs& a, int C, bool vec, void* stream) {
  const int tcg = 1 << a.lg_tcg;
  const int slots = kThreads / tcg;
  const dim3 grid(static_cast<unsigned>((a.ns + kW * tcg - 1) / (kW * tcg)),
                  static_cast<unsigned>((a.ny + slots * kRows - 1) /
                                        (slots * kRows)),
                  static_cast<unsigned>(C));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    poisson_z_kernel<true, kRows, kW><<<grid, kThreads, 0, st>>>(a);
  else
    poisson_z_kernel<false, kRows, kW><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The whole Z update, Z (C, ny, ns), from Y (ny, ns), Zprev and E (C, ny,
// ns), iSigma (C, ns) and fam (ns,); Ymask (ny, ns) null without missing
// values; u, eps_pg / eps_z (together) and eps_na each inject their draws
// or are null.  `small`: a thread 1 row of 2 columns, else 4 rows of 4
// (ops/rand.py · z_geometry); `vec`: ns % 4 == 0 and every pointer 16-byte
// aligned.
extern "C" int hmsc_z_mixed(const float* Y, const float* Zprev,
                            const float* E, const float* iSigma,
                            const int* fam, const float* Ymask,
                            const float* u, const float* eps_pg,
                            const float* eps_z, const float* eps_na,
                            float* Z, int C, int ny, int ns, int lg_tcg,
                            int small, int vec, unsigned long long seed,
                            unsigned offset, void* stream) {
  const int rows = small ? 1 : 4;
  if (C < 0 || C > 65535 || ny < 0 || ns < 0 || lg_tcg < 2 || lg_tcg > 5 ||
      static_cast<long long>(ny) * ns >= (1LL << 31) ||
      (ny + rows - 1) / rows >= 65535LL * (kThreads >> lg_tcg))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || ny == 0 || ns == 0) return 0;
  PArgs a{};
  a.Y = Y; a.Zprev = Zprev; a.E = E; a.iSigma = iSigma; a.fam = fam;
  a.Ymask = Ymask; a.U = u; a.EPG = eps_pg; a.EZ = eps_z; a.ENA = eps_na;
  a.Z = Z;
  a.ny = ny;
  a.ns = ns;
  a.lg_tcg = lg_tcg;
  a.keys = hmsc::philox_round_keys(hmsc::seed_key(seed));
  a.offset = offset;
  return small ? launch<1, 2>(a, C, vec != 0, stream)
               : launch<4, 4>(a, C, vec != 0, stream);
}
