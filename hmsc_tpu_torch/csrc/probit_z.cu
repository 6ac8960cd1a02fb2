// B1: the probit latent-response update, one truncated normal per cell, in
// two operand forms of one kernel template.
//
// Replaces hmsc_tpu/ops/rand.py · truncated_normal_onesided (called from
// hmsc_tpu/mcmc/updaters.py · update_z, probit branch), which the JAX
// package wrote as whole-array ops shaped for the TPU's vector units; on
// the TPU, XLA fuses the linear predictor's add into that pass
// (hmsc_tpu/mcmc/sweep.py:232-235, 290-292).
//
//   E-reading form   Z = TN(E, sd) from the linear predictor E (C, ny, ns)
//                    formed by the sweep (models where something else reads
//                    E: several random levels, NA, Poisson or normal
//                    columns, estimated dispersions);
//   fused form       the kernel forms E itself,
//                    e = sum_j X[i,j] Beta[c,j,col]
//                        + sum_h Eta[c,pi[i],h] Lambda[c,h,col] mask[c,h],
//                    where Z's probit branch is E's only reader (every
//                    column probit, no NA, at most one random level), so
//                    the sweep never writes E.
//
// What bounds it on the H100: instruction issue, then bytes.  A cell reads
// E and Y and writes Z (12 bytes; the fused form 8 bytes with Y, Z and the
// small operands) against one Philox quarter, Phi and its inverse.  At
// 4 chains x 1000 x 1000 the bytes take ~11 us (fused ~6 us) at 3.35 TB/s;
// the card issues ~3e13 lane-instructions a second, so ~100 instructions a
// cell take ~13 us.  Design:
//   - a grid over (column tile, row tile, chain): no 64-bit division; a
//     thread owns 4 consecutive columns of R = 4 rows, so E, Y, Z (and
//     injected uniforms) move as 128-bit loads and stores where ns % 4 ==
//     0, scalar otherwise and in the last group; its columns' sd is loaded
//     once; one Philox call a (chain, row, column group) from 32-bit
//     counters feeds its 4 cells;
//   - the draw is truncnorm.cuh's, shared with B9b: Phi and Phi^-1 in
//     fewer instructions than normcdff / normcdfinvf (the Numerical
//     Recipes erfc, AS 241 PPND7) on the fast flush-to-zero units, with
//     the JAX op's float32 guards; Philox's round keys are formed on the
//     host.  Measured on an H100: the E-reading kernel's SASS fell from
//     ~220 to ~165 static instructions a cell against normcdff /
//     normcdfinvf, and its time by ~28% (scripts/probit_z_sweep.py).
//     Against the plain version the draws agree within ~1e-5 of sd
//     (chip_smoke.py gates 1e-4);
//   - the fused form stages its block's rows of [X | Eta[pi]] (a thread a
//     row) and its columns of [Beta ; Lambda mask] in shared memory (K =
//     nc + nf <= 32 floats a row), and forms 4 rows x 4 columns a thread
//     with float32 FMAs: K (1 + 5 / 16) instructions a cell.  The kernel is
//     issue-bound, so forming E costs more instructions than reading it;
//     the form pays where the sweep no longer forms E (its gather, matmul
//     and add, and their launches).
// An optional tensor of uniforms replaces the in-kernel draw, so the kernel
// can be compared with its plain version on identical inputs.

#include <cuda_runtime.h>

#include "philox.cuh"
#include "truncnorm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;          // rows a thread
constexpr int kMaxK = 32;         // fused form: nc + nf

struct ZArgs {
  const float* E;                 // (C, ny, ns), E-reading form
  const float* X;                 // (ny, nc), strides sx0, sx1
  const float* Beta;              // (C, nc, ns), strides sb0, sb1, sb2
  const float* Eta;               // (C, np, nf), strides se0, se1, se2
  const long long* pi;            // (ny,) unit of each row
  const float* Lam;               // (C, nf, ns), strides sl0, sl1, sl2
  const float* mask;              // (C, nf), strides sm0, sm1
  const float* sd;                // (C, ns)
  const float* Y;                 // (ny, ns)
  const float* U;                 // (C, ny, ns) injected uniforms, or null
  float* Z;                       // (C, ny, ns)
  long long sx0, sx1, sb0, sb1, sb2, se0, se1, se2, sl0, sl1, sl2, sm0, sm1;
  int ny, ns, nc, nf;
  int lg_tcg;                     // log2 of the column groups a block
  int row_off;                    // global row of row 0 (a site mesh's
                                  // rank: its block's start), counters only
  hmsc::PhiloxKeys keys;          // the seed's ten round keys
  unsigned offset;
};

template <bool kVec>
__device__ __forceinline__ void load4(const float* p, int n, float (&v)[4]) {
  if (kVec) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = q < n ? p[q] : 0.0f;
  }
}

template <bool kFused, bool kVec>
__global__ void __launch_bounds__(kThreads)
probit_z_kernel(const ZArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.z;
  const int tcg = 1 << a.lg_tcg;
  const int cg = threadIdx.x & (tcg - 1);
  const int rs = threadIdx.x >> a.lg_tcg;
  const int slots = kThreads >> a.lg_tcg;     // row slots a block
  const int tc = 4 * tcg;                     // columns a block
  const int col0 = blockIdx.x * tc;
  const int row0 = blockIdx.y * slots * kRows;
  const int j = col0 + 4 * cg;
  const int K = a.nc + a.nf;
  float* As = sm;                             // [slots * kRows][K]
  float* Bs = sm + slots * kRows * K;         // [K][tc]
  if (kFused) {
    // a thread a row of [X | Eta[pi]]; the columns of [Beta ; Lambda mask]
    // by (k, column) with shifts
    const int i = row0 + static_cast<int>(threadIdx.x);
    if (i - row0 < slots * kRows) {
      float* ar = As + threadIdx.x * K;
      if (i < a.ny) {
        for (int k = 0; k < a.nc; ++k) ar[k] = a.X[i * a.sx0 + k * a.sx1];
        const float* er = a.Eta + c * a.se0 + a.pi[i] * a.se1;
        for (int h = 0; h < a.nf; ++h) ar[a.nc + h] = er[h * a.se2];
      } else {
        for (int k = 0; k < K; ++k) ar[k] = 0.0f;
      }
    }
    const int lg_tc = a.lg_tcg + 2;
    for (int e = threadIdx.x; e < K * tc; e += kThreads) {
      const int k = e >> lg_tc, col = col0 + (e & (tc - 1));
      float v = 0.0f;
      if (col < a.ns) {
        if (k < a.nc) {
          v = a.Beta[c * a.sb0 + k * a.sb1 + col * a.sb2];
        } else {
          const int h = k - a.nc;
          v = a.Lam[c * a.sl0 + h * a.sl1 + col * a.sl2] *
              a.mask[c * a.sm0 + h * a.sm1];
        }
      }
      Bs[e] = v;
    }
    __syncthreads();
  }
  if (j >= a.ns) return;
  const int nj = min(4, a.ns - j);
  const long long cells = static_cast<long long>(a.ny) * a.ns;
  float s[4], is[4];
  load4<kVec>(a.sd + static_cast<long long>(c) * a.ns + j, nj, s);
#pragma unroll
  for (int q = 0; q < 4; ++q) is[q] = q < nj ? 1.0f / s[q] : 0.0f;

  float e[kRows][4];
  if (kFused) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) e[r][q] = 0.0f;
    const float4* B4 = reinterpret_cast<const float4*>(Bs) + cg;
    for (int k = 0; k < K; ++k) {
      const float4 b = B4[k * tcg];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float av = As[(rs + r * slots) * K + k];
        e[r][0] = fmaf(av, b.x, e[r][0]);
        e[r][1] = fmaf(av, b.y, e[r][1]);
        e[r][2] = fmaf(av, b.z, e[r][2]);
        e[r][3] = fmaf(av, b.w, e[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = row0 + rs + r * slots;
    if (i >= a.ny) break;
    const long long yo = static_cast<long long>(i) * a.ns + j;
    const long long zo = c * cells + yo;
    float ev[4], y[4], u[4];
    if (kFused) {
#pragma unroll
      for (int q = 0; q < 4; ++q) ev[q] = e[r][q];
    } else {
      load4<kVec>(a.E + zo, nj, ev);
    }
    load4<kVec>(a.Y + yo, nj, y);
    if (a.U != nullptr) {
      load4<kVec>(a.U + zo, nj, u);
    } else {
      const uint4 b = hmsc::philox4x32_10(
          make_uint4(static_cast<unsigned>(j >> 2),
                     static_cast<unsigned>(i + a.row_off),
                     static_cast<unsigned>(c), a.offset),
          a.keys);
      u[0] = hmsc::uniform01(b.x);
      u[1] = hmsc::uniform01(b.y);
      u[2] = hmsc::uniform01(b.z);
      u[3] = hmsc::uniform01(b.w);
    }
    float z[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      z[q] = hmsc::probit_z_draw(ev[q], s[q], is[q], y[q] > 0.5f,
                                   u[q]);
    if (kVec) {
      *reinterpret_cast<float4*>(a.Z + zo) = make_float4(z[0], z[1], z[2],
                                                         z[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < nj) a.Z[zo + q] = z[q];
    }
  }
}

template <bool kFused>
int launch(const ZArgs& a, int C, bool vec, void* stream) {
  const int tcg = 1 << a.lg_tcg;
  const int slots = kThreads / tcg;
  const unsigned gx = static_cast<unsigned>((a.ns + 4 * tcg - 1) / (4 * tcg));
  const unsigned gy =
      static_cast<unsigned>((a.ny + slots * kRows - 1) / (slots * kRows));
  const size_t smem =
      kFused ? sizeof(float) * (a.nc + a.nf) * (slots * kRows + 4 * tcg) : 0;
  const dim3 grid(gx, gy, static_cast<unsigned>(C));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    probit_z_kernel<kFused, true><<<grid, kThreads, smem, st>>>(a);
  else
    probit_z_kernel<kFused, false><<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int C, int ny, int ns, int lg_tcg) {
  return C >= 0 && C <= 65535 && ny >= 0 && ns >= 0 && lg_tcg >= 2 &&
         lg_tcg <= 5 && static_cast<long long>(C) * ny * ns < (1LL << 62) &&
         (ny + kRows - 1) / kRows < 65535LL * (kThreads >> lg_tcg);
}

}  // namespace

// The E-reading form: Z (C, ny, ns) from E (C, ny, ns).  `vec`: ns % 4 ==
// 0 and every pointer 16-byte aligned (128-bit loads and stores).  Both
// forms draw cell (c, i, j) from the Philox counter of global row i +
// row_off: a site mesh's rank passes its block's first row, so each cell
// gets the bits of the replicated run.
extern "C" int hmsc_probit_z(const float* E, const float* sd, const float* Y,
                             const float* U, float* Z, int C, int ny, int ns,
                             int lg_tcg, int vec, int row_off,
                             unsigned long long seed, unsigned offset,
                             void* stream) {
  if (!valid(C, ny, ns, lg_tcg) || row_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || ny == 0 || ns == 0) return 0;
  ZArgs a{};
  a.E = E; a.sd = sd; a.Y = Y; a.U = U; a.Z = Z;
  a.ny = ny; a.ns = ns; a.lg_tcg = lg_tcg; a.row_off = row_off;
  a.keys = hmsc::philox_round_keys(hmsc::seed_key(seed));
  a.offset = offset;
  return launch<false>(a, C, vec != 0, stream);
}

// The fused form: Z (C, ny, ns) from X (ny, nc), Beta (C, nc, ns), and on
// one random level Eta (C, np, nf) gathered by pi (ny,), Lambda (C, nf, ns)
// and the factor mask (C, nf); nf = 0 without a level.  Strides in
// elements: x (2), beta (3), eta (3), lam (3), mask (2).
extern "C" int hmsc_probit_z_fused(const float* X, const float* Beta,
                                   const float* Eta, const long long* pi,
                                   const float* Lam, const float* mask,
                                   const float* sd, const float* Y,
                                   const float* U, float* Z,
                                   const long long* strides, int C, int ny,
                                   int ns, int nc, int nf, int lg_tcg,
                                   int vec, int row_off,
                                   unsigned long long seed, unsigned offset,
                                   void* stream) {
  if (!valid(C, ny, ns, lg_tcg) || nc < 0 || nf < 0 || nc + nf < 1 ||
      nc + nf > kMaxK || row_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || ny == 0 || ns == 0) return 0;
  ZArgs a{};
  a.X = X; a.Beta = Beta; a.Eta = Eta; a.pi = pi; a.Lam = Lam; a.mask = mask;
  a.sd = sd; a.Y = Y; a.U = U; a.Z = Z;
  a.sx0 = strides[0]; a.sx1 = strides[1];
  a.sb0 = strides[2]; a.sb1 = strides[3]; a.sb2 = strides[4];
  a.se0 = strides[5]; a.se1 = strides[6]; a.se2 = strides[7];
  a.sl0 = strides[8]; a.sl1 = strides[9]; a.sl2 = strides[10];
  a.sm0 = strides[11]; a.sm1 = strides[12];
  a.ny = ny; a.ns = ns; a.nc = nc; a.nf = nf; a.lg_tcg = lg_tcg;
  a.row_off = row_off;
  a.keys = hmsc::philox_round_keys(hmsc::seed_key(seed));
  a.offset = offset;
  return launch<true>(a, C, vec != 0, stream);
}
