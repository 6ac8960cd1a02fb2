// B8b: the NNGP prior quadratics eta_h' iW(alpha) eta_h, over the alpha
// grid or at each factor's own alpha, with the location move's ones-forms.
//
// Replaces the NNGP branches of hmsc_tpu/mcmc/spatial.py:
//   eta_quad_grid      v[c,f,g] = sum_i (eta[c,i,f] - sum_k A[g,i,k] eta[c,nn[i,k],f])^2 / D[g,i]
//                      for every grid point g (update_alpha's G = 101 grid);
//   eta_quad_at        the same at g = alpha[c, f] (the scale interweave);
//   eta_ones_forms_at  (1' iW 1, 1' iW eta) at g = alpha[c, f], i.e.
//                      (sum_i r1_i^2, sum_i r1_i re_i) with
//                      r1_i = (1 - sum_k A[g,i,k]) / sqrt(D[g,i]) and
//                      re_i = (eta_i - sum_k A[g,i,k] eta_nn) / sqrt(D[g,i])
//                      (the location interweave).
// The at-alpha mode writes all three per column: out[c, f, :] = (q, q1, s).
//
// What bounds it on the H100.  Grid mode: bytes, the coefficient grid (G np
// k floats, 4 MB at config 3b's np 1000, k 10) read once, ~1.3 us; the
// G np k ncol multiply-adds are a fraction of that.  At-alpha mode: latency
// (C nf columns of np units, each unit a neighbour list and a gather).
// Design (ops/spatial.py · quad_geometry and quad_at_geometry choose the
// shapes):
//   - grid mode: a block of 512 threads a grid point, a thread a unit at a
//     time.  The lists and the coefficient grid are read with the unit last
//     (LevelData's nn_idx_u (k, np) and nn_coef_u (G, k, np), laid out once
//     when the level is built; the variances nn_D (G, np) are so already),
//     so every global load of a warp is 128 consecutive bytes, and a unit's
//     k list entries, k coefficients and variance are loaded together
//     before the gathers that need them.  eta, whole (C np nf floats: 32 KB
//     at config 3b), is copied into each block's shared memory by 16-byte
//     cp.async and the neighbours are gathered from there (read in place
//     where it would not fit), a chain's adjacent factors by one 8- or
//     16-byte load; a thread carries 8 columns at a time.  A warp reduces
//     its 8 sums in 3 halving shuffle steps and 2 more, then the warps in
//     order.  Measured alternatives on an H100 at config 3b's shape
//     (scripts/nngp_quad_sweep.py): a lane a grid point (eta broadcast from
//     shared memory, the grid read grid point last) 0.0114 ms, its memory
//     pipe busy with the broadcasts; a thread a unit over 8 grid points
//     with the block's stages of the unit-last grid copied into shared
//     memory 0.0127 ms, ~13.7 MB of copies; clusters of 2 blocks a grid
//     point splitting the units 0.0077 ms, each block staging eta; the
//     variance loaded after the gathers, or the next unit's loads issued
//     one unit ahead (128 registers), 0.0068 and 0.0083 ms; the first
//     version 0.0118 ms; this design 0.0062 ms;
//   - at-alpha mode: a cluster of S blocks a column (8 of 128 threads at
//     config 3b's np 1000), a thread a unit, reading the lists nn_idx (np,
//     k) and the grid nn_coef (G, np, k) unit first (the unit-last layout
//     took 0.0035 ms against 0.0032 here); each unit's list and
//     coefficient loads issue together before the gathers that need them;
//     each block writes its 3 partials into every block of the cluster,
//     then one cluster barrier (a single block of 1024 threads a column,
//     with no cluster, took 0.0046 ms against 0.0032 on an H100);
//   - every sum is taken in a fixed order (a thread over its units in
//     order; fixed shuffle patterns; the warps in order; the cluster's
//     blocks in rank order), no atomics, so reruns give the same bits.
//
// The at-alpha mode's bf16-grid form (`bf16` 1: the interweaving moves
// under a precision policy, hmsc_tpu/mcmc/spatial.py:454-462, 502-518 with
// the grids staged) reads the bfloat16 shadows of the coefficient grid and
// the variances as they are and rounds as the JAX package's mx einsum
// does: the neighbours' eta rounded to bfloat16 in the prediction (the
// unit's own eta is not), float32 sums, and sqrt(D) rounded to bfloat16
// (jnp.sqrt of a bfloat16 array) in the ones-forms.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

namespace cgk = cooperative_groups;

constexpr int kGridThreads = 512;  // grid mode: a thread a unit at a time
constexpr int kCols = 8;           // grid mode: columns a pass carries
constexpr int kSlots = 10;         // neighbour slots loaded together
constexpr int kUnroll = 5;         // at alpha: list entries loaded together
constexpr int kClusterMax = 8;

struct GridArgs {
  const float* eta;               // (C, np_eta, nf)
  const int* nn_u;                // (k, np): the lists, unit last
  const float* coef_u;            // (G, k, np): the grid, unit last
  const float* D;                 // (G, np)
  float* out;                     // (C nf, G)
  int C, np, nf, k, G;
  int np_eta, u_off;              // eta's units; unit u of the grids is
                                  // eta's u_off + u (a site mesh's rank)
};

__device__ __forceinline__ void cp_async4(float* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// The cluster barrier split in two: every block arrives when it starts and
// waits before its first write into another block's shared memory, so the
// other blocks have started by then (the wait is long satisfied).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Each block's `n` partials into slot `rank` of every block of the cluster,
// one cluster barrier, then each block holds all of them in `part`.
__device__ __forceinline__ void cluster_exchange(float* part, int n, int S,
                                                 int rank, int e, float v) {
  if (S > 1) cluster_wait();
  if (e < n) {
    for (int r = 0; r < S; ++r) {
      float* pr = S > 1 ? cgk::this_cluster().map_shared_rank(part, r) : part;
      pr[rank * n + e] = v;
    }
  }
  if (S > 1) cgk::this_cluster().sync();
  else __syncthreads();
}

template <bool kEtaSmem, int VW>
__global__ void __launch_bounds__(kGridThreads)
nngp_quad_grid_kernel(const GridArgs a) {
  extern __shared__ __align__(16) float es[];   // eta whole, as in memory
  __shared__ float red[kGridThreads / 32][kCols];
  const int k = a.k, np = a.np, nf = a.nf;
  const int g = blockIdx.x;                     // a block a grid point
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncol = a.C * nf;
  const int n_eta = ncol * a.np_eta;
  if (kEtaSmem) {
    // 16 bytes a copy where eta is 16-byte aligned, else 4
    const int n16 = (reinterpret_cast<unsigned long long>(a.eta) & 15) == 0
                        ? n_eta & ~3 : 0;
    for (int e = 4 * static_cast<int>(threadIdx.x); e < n16;
         e += 4 * kGridThreads)
      cp_async16(es + e, a.eta + e);
    for (int e = n16 + static_cast<int>(threadIdx.x); e < n_eta;
         e += kGridThreads)
      cp_async4(es + e, a.eta + e);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  const float* E = kEtaSmem ? es : a.eta;
  const int* nn = a.nn_u;
  const float* cf = a.coef_u + static_cast<long long>(g) * k * np;
  const float* dg = a.D + static_cast<long long>(g) * np;

  for (int c0 = 0; c0 < ncol; c0 += kCols) {
    // each column's offset in eta (absent ones repeat the last VW, so
    // every VW-wide load stays aligned)
    int base[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int col = c0 + q < ncol ? c0 + q : ncol - VW + q % VW;
      base[q] = (col / nf) * a.np_eta * nf + col % nf;
    }
    // the 8 columns' values at unit offset jn = j nf: VW-wide loads (a
    // chain's consecutive factors are adjacent in eta)
    auto gather = [&](int jn, float (&v)[kCols]) {
#pragma unroll
      for (int q = 0; q < kCols; q += VW) {
        const float* p = E + base[q] + jn;
        if constexpr (VW == 4) {
          const float4 w = *reinterpret_cast<const float4*>(p);
          v[q] = w.x; v[q + 1] = w.y; v[q + 2] = w.z; v[q + 3] = w.w;
        } else if constexpr (VW == 2) {
          const float2 w = *reinterpret_cast<const float2*>(p);
          v[q] = w.x; v[q + 1] = w.y;
        } else {
          v[q] = *p;
        }
      }
    };
    float acc[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[q] = 0.0f;
    for (int i = threadIdx.x; i < np; i += kGridThreads) {
      // the unit's first kSlots list entries and coefficients and its
      // variance, loaded together before the gathers that need them
      int j[kSlots];
      float A[kSlots];
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const bool in = t < k;
        j[t] = in ? __ldg(nn + t * np + i) * nf : 0;
        A[t] = in ? __ldg(cf + t * np + i) : 0.0f;
      }
      const float id = __frcp_rn(__ldg(dg + i));
      float pred[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) pred[q] = 0.0f;
      for (int k0 = 0; k0 < k; k0 += kSlots) {
        if (k0 > 0) {                           // lists longer than kSlots
#pragma unroll
          for (int t = 0; t < kSlots; ++t) {
            const bool in = k0 + t < k;
            j[t] = in ? __ldg(nn + (k0 + t) * np + i) * nf : 0;
            A[t] = in ? __ldg(cf + (k0 + t) * np + i) : 0.0f;
          }
        }
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
          float v[kCols];
          gather(j[t], v);
#pragma unroll
          for (int q = 0; q < kCols; ++q) pred[q] = fmaf(A[t], v[q], pred[q]);
        }
      }
      float own[kCols];
      gather((a.u_off + i) * nf, own);
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const float r = own[q] - pred[q];
        acc[q] = fmaf(r * r, id, acc[q]);
      }
    }
    // the warp's 8 sums over its 32 lanes: three halving steps (lane bits
    // 4, 3, 2 pick the half a lane keeps), then a butterfly over bits 1, 0;
    // lane l ends with the sum of value (l >> 2)
#pragma unroll
    for (int o = 16, h = kCols / 2; o >= 4; o >>= 1, h >>= 1) {
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int x = 0; x < h; ++x) {
        const float send = upper ? acc[x] : acc[x + h];
        const float keep = upper ? acc[x + h] : acc[x];
        acc[x] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    }
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 2);
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
    __syncthreads();                            // red is free again
    if ((lane & 3) == 0) red[warp][lane >> 2] = acc[0];
    __syncthreads();
    if (threadIdx.x < kCols && c0 + static_cast<int>(threadIdx.x) < ncol) {
      float t = 0.0f;
      for (int w = 0; w < kGridThreads / 32; ++w) t += red[w][threadIdx.x];
      a.out[static_cast<long long>(c0 + threadIdx.x) * a.G + g] = t;
    }
  }
}

struct AtArgs {
  const float* eta;               // (C, np_eta, nf)
  const int* nn;                  // (np, k)
  const void* coef;               // (G, np, k), float32 or bfloat16
  const void* D;                  // (G, np), likewise
  const int* alpha;
  float* out;                     // (C nf, 3)
  int np, nf, k, S, units;
  int np_eta, u_off;              // as GridArgs
};

// element i of a float32 or (kBf16) bfloat16 grid, widened
template <bool kBf16>
__device__ __forceinline__ float grid_at(const void* p, long long i) {
  if constexpr (kBf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  else
    return __ldg(static_cast<const float*>(p) + i);
}

// x rounded to bfloat16 (nearest even) and widened, in the bf16 form
template <bool kBf16>
__device__ __forceinline__ float rd(float x) {
  if constexpr (kBf16)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

template <int T, bool kBf16>
__global__ void __launch_bounds__(T)
nngp_quad_at_kernel(const AtArgs a) {
  __shared__ float red[3][T / 32];
  __shared__ float part[kClusterMax * 3];       // every block's partials
  const int S = a.S, k = a.k, nf = a.nf;
  const int rank = S > 1 ? static_cast<int>(cgk::this_cluster().block_rank())
                         : 0;
  if (S > 1) cluster_arrive_relaxed();
  const int col = blockIdx.x / S;               // c * nf + f
  const int c = col / nf, f = col % nf;
  const long long al = __ldg(a.alpha + col);
  const long long Aa = al * a.np * k, Da = al * a.np;
  const float* E = a.eta + static_cast<long long>(c) * a.np_eta * nf + f;
  const int u0 = rank * a.units;
  const int u1 = min(a.np, u0 + a.units);
  float q = 0.0f, q1 = 0.0f, s = 0.0f;
  for (int i = u0 + threadIdx.x; i < u1; i += T) {
    const int* nb = a.nn + static_cast<long long>(i) * k;
    const long long Ai = Aa + static_cast<long long>(i) * k;
    const float d = grid_at<kBf16>(a.D, Da + i);
    const float own = __ldg(E + static_cast<long long>(a.u_off + i) * nf);
    float pred = 0.0f, csum = 0.0f;
    for (int k0 = 0; k0 < k; k0 += kUnroll) {
      int j[kUnroll];
      float A[kUnroll];
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        const bool in = k0 + t < k;
        j[t] = in ? __ldg(nb + k0 + t) : 0;
        A[t] = in ? grid_at<kBf16>(a.coef, Ai + k0 + t) : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        pred = fmaf(A[t],
                    rd<kBf16>(__ldg(E + static_cast<long long>(j[t]) * nf)),
                    pred);
        csum += A[t];
      }
    }
    const float res = own - pred;
    q += res * res / d;
    const float sq = rd<kBf16>(sqrtf(d));
    const float r1 = (1.0f - csum) / sq;
    const float re = res / sq;
    q1 += r1 * r1;
    s += r1 * re;
  }
  // a shuffle tree in the warp, the warps in order, the blocks in rank order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    q += __shfl_xor_sync(0xffffffffu, q, o);
    q1 += __shfl_xor_sync(0xffffffffu, q1, o);
    s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = q;
    red[1][warp] = q1;
    red[2][warp] = s;
  }
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x < 3)
    for (int w = 0; w < T / 32; ++w) t += red[threadIdx.x][w];
  cluster_exchange(part, 3, S, rank, threadIdx.x < 3 ? threadIdx.x : 3, t);
  if (rank == 0 && threadIdx.x < 3) {
    float sum = 0.0f;
    for (int r = 0; r < S; ++r) sum += part[r * 3 + threadIdx.x];
    a.out[3 * col + threadIdx.x] = sum;
  }
}

template <typename Args>
cudaError_t launch_cluster(void (*kernel)(const Args), const Args& a,
                           unsigned blocks, int threads, int S, size_t smem,
                           void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <bool kEtaSmem, int VW>
cudaError_t grid_launch(const GridArgs& a, void* stream) {
  const size_t smem =
      kEtaSmem ? sizeof(float) * ((static_cast<size_t>(a.C) * a.np_eta * a.nf +
                                   3) & ~static_cast<size_t>(3))
               : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nngp_quad_grid_kernel<kEtaSmem, VW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  nngp_quad_grid_kernel<kEtaSmem, VW>
      <<<a.G, kGridThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaSuccess;
}

}  // namespace

// Grid mode: out (C nf, G) from eta (C, np_eta, nf), the lists and the
// grid with the unit last, nn_u (k, np) and coef_u (G, k, np), and the
// variances D (G, np).  A block a grid point; eta whole in each block's
// shared memory where `eta_smem`.  Both modes sum over the np units of the
// grids, unit u reading eta's unit u_off + u: a site mesh's rank passes its
// block of the grids, the whole eta and its block's first unit (np_eta =
// np and u_off = 0 on one card).
extern "C" int hmsc_nngp_quad_grid(const float* eta, const int* nn_u,
                                   const float* coef_u, const float* D,
                                   float* out, int C, int np, int nf, int k,
                                   int G, int eta_smem, int np_eta, int u_off,
                                   void* stream) {
  if (k < 1 || u_off < 0 || u_off + np > np_eta ||
      static_cast<long long>(C) * np_eta * nf >= (1LL << 31) ||
      static_cast<long long>(G) * k * np >= (1LL << 31) ||
      (eta_smem && 4LL * C * np_eta * nf > 227 * 1024))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || np == 0 || nf == 0 || G == 0) return 0;
  const GridArgs a{eta, nn_u, coef_u, D, out, C, np, nf, k, G, np_eta,
                   u_off};
  // the widest loads the factors allow (eta 16-byte aligned)
  const bool al = (reinterpret_cast<unsigned long long>(eta) & 15) == 0;
  const int vw = al && nf % 4 == 0 ? 4 : al && nf % 2 == 0 ? 2 : 1;
  cudaError_t e;
  if (eta_smem)
    e = vw == 4 ? grid_launch<true, 4>(a, stream)
        : vw == 2 ? grid_launch<true, 2>(a, stream)
                  : grid_launch<true, 1>(a, stream);
  else
    e = vw == 4 ? grid_launch<false, 4>(a, stream)
        : vw == 2 ? grid_launch<false, 2>(a, stream)
                  : grid_launch<false, 1>(a, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// At-alpha mode: out (C nf, 3) = (q, 1' iW 1, 1' iW eta) per column, at
// alpha (C nf,), from eta, the lists nn (np, k), the grid coef (G, np, k)
// and the variances D (G, np); S blocks a cluster a column over units of
// `units` each, `threads` (128 or 256) a block; `bf16` 1: coef and D are
// the bfloat16 shadows (the bf16-grid form).
extern "C" int hmsc_nngp_quad_at(const float* eta, const int* nn,
                                 const void* coef, const void* D,
                                 const int* alpha, float* out, int C, int np,
                                 int nf, int k, int S, int units, int threads,
                                 int bf16, int np_eta, int u_off,
                                 void* stream) {
  if (S < 1 || S > kClusterMax || units < 1 ||
      static_cast<long long>(S) * units < np || k < 1 || u_off < 0 ||
      u_off + np > np_eta ||
      static_cast<long long>(C) * np_eta * nf >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || np == 0 || nf == 0) return 0;
  const AtArgs a{eta, nn, coef, D, alpha, out, np, nf, k, S, units, np_eta,
                 u_off};
  const unsigned blocks = static_cast<unsigned>(C) * nf * S;
  cudaError_t e;
  switch (threads * 2 + (bf16 ? 1 : 0)) {
    case 256: e = launch_cluster(nngp_quad_at_kernel<128, false>, a, blocks,
                                 128, S, 0, stream); break;
    case 257: e = launch_cluster(nngp_quad_at_kernel<128, true>, a, blocks,
                                 128, S, 0, stream); break;
    case 512: e = launch_cluster(nngp_quad_at_kernel<256, false>, a, blocks,
                                 256, S, 0, stream); break;
    case 513: e = launch_cluster(nngp_quad_at_kernel<256, true>, a, blocks,
                                 256, S, 0, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
