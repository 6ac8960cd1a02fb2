// B8c: the dense Vecchia precision iW = RiW' RiW of each chain's factors,
// for the NNGP Eta draw below the dense/CG crossover (np nf <= 256).
//
// Replaces hmsc_tpu/mcmc/spatial.py · _nngp_dense_iW, its gram included:
//
//   RiW[c,f,i,:] = (e_i - sum_k A[a,i,k] e_{nn[i,k]}) / sqrt(D[a,i]),
//   iW[c,f,j,l]  = sum_i RiW[c,f,i,j] RiW[c,f,i,l],   a = alpha[c, f],
//
// written densely as (C, nf, np, np).
//
// What bounds it on the H100: latency.  The output is C nf np^2 floats (0.32
// MB at the dense NNGP path's C 4, nf 2, np 100), written in ~0.1 us at the
// memory's rate; the sparse gram is ~np (k + 1)^2 products a factor.  The
// first version wrote RiW a thread a row (no store coalesced: the lanes of
// a warp wrote np floats apart) and left the gram to a second launch
// (torch.matmul, np^3 multiply-adds a factor, nearly all of zeros).
// Design (ops/spatial.py · iw_geometry chooses the shapes):
//   - RiW has row i nonzero at i and at unit i's real neighbours only, all
//     below i (the level's lists are built from the units before each
//     unit), so iW = sum_i r_i r_i' is a sum of sparse outer products, and
//     row j of iW sums r_i[j] r_i over i in {j} and rev(j), the units that
//     list j: the reverse-neighbour CSR the NNGP level carries
//     (LevelData.rev_ptr / rev_pos: pads left out, so unit 0 collects no
//     pad).  That is ~np (k + 1)^2 multiply-adds a factor, not np^3;
//   - a block of `rows` warps per (chain, factor, tile of `rows` rows of
//     iW), a warp a row: the warp zeroes the row in shared memory, then
//     for i = j, then for rev(j) in the CSR's (ascending) order, its lanes
//     add r_i[j] r_i[l] at the k + 1 places l where r_i is nonzero (unit
//     i's real neighbours and i: distinct, so no two lanes meet), and
//     writes the row out, l fastest, so a warp's stores are 128
//     consecutive bytes;
//   - the block first stages, at its factor's alpha, each unit's (from the
//     tile's first row on: every unit its rows meet) scaled coefficients
//     -A rsqrt(D), lists, counts and rsqrt(D) (the values RiW holds, to
//     ~1e-7), and its rows' slices of the reverse-neighbour lists, in
//     shared memory, every load issued before the first store, then one
//     barrier; each warp then holds its row's units that list j, a lane
//     each, in registers;
//   - every entry is one lane's sum in a fixed order (the units i in order,
//     from 0 by fused multiply-adds), no atomics, so reruns give the same
//     bits.
// Measured on an H100 at C 4, nf 2, np 100 (scripts/nngp_dense_iw_sweep.py):
// this design 0.0048 ms with 8 rows a block (16: 0.0051; IEEE sqrt and
// division in place of rsqrtf 0.0057); a thread an entry (j, l), finding
// r_i[l] by comparing l with unit i's list for every i, 0.0126; the pairs
// (unit, r_i[j]) formed in a second pass behind a second barrier 0.0057;
// the first version (RiW, then torch.matmul) 0.040.
//
// The bf16-grid form (`bf16` 1: the dense NNGP Eta draw under a precision
// policy, the JAX _nngp_dense_iW gathering from the staged grids) reads
// the bfloat16 shadows of the coefficient grid and the variances as they
// are, widens them, and builds iW and its gram in float32 as above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// list and coefficient elements a thread stages at a time
constexpr int kStage = 4;

struct IwArgs {
  const int* nn;          // (np, k), pads index 0
  const int* nn_n;        // (np,) real neighbours a unit
  const void* coef;       // (G, np, k), float32 or bfloat16
  const void* D;          // (G, np), likewise
  const int* rev_ptr;     // (np + 1,)
  const int* rev_pos;     // (nnz,) i k + slot
  const int* alpha;       // (C nf,)
  float* out;             // (C, nf, np, np)
  int np, k, nnz;
};

// element i of a float32 or (kBf16) bfloat16 grid, widened
template <bool kBf16>
__device__ __forceinline__ float grid_at(const void* p, long long i) {
  if constexpr (kBf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  else
    return __ldg(static_cast<const float*>(p) + i);
}

template <bool kBf16>
__global__ void __launch_bounds__(1024) nngp_iw_kernel(const IwArgs a) {
  extern __shared__ float sm[];
  const int np = a.np, k = a.k;
  const int rows = blockDim.x >> 5;           // a warp a row
  const int cf = blockIdx.y;                  // c * nf + f
  const int j0 = blockIdx.x * rows;
  const int j1 = min(np, j0 + rows);
  const long long al = __ldg(a.alpha + cf);
  const int e0 = __ldg(a.rev_ptr + j0), e1 = __ldg(a.rev_ptr + j1);
  const long long Aa = al * np * k, Da = al * np;
  // shared: 1 / sqrt(D) and the counts (np), lists and scaled coefficients
  // (np k), the tile's slice of the reverse-neighbour positions (nnz at
  // most), its rows' offsets there (rows + 1) and its rows of iW (rows np)
  float* di = sm;
  int* cnt = reinterpret_cast<int*>(di + np);
  int* nb = cnt + np;
  float* vv = reinterpret_cast<float*>(nb + np * k);
  int* pq = reinterpret_cast<int*>(vv + np * k);
  int* rp = pq + a.nnz;
  float* acc_rows = reinterpret_cast<float*>(rp + rows + 1);
  // the lists and coefficients kStage elements a thread at a time, every
  // load issued before the first store
  for (int base = j0 * k + threadIdx.x; base < np * k;
       base += kStage * blockDim.x) {
    int nbr[kStage];
    float cr[kStage], dr[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < np * k) {
        nbr[u] = __ldg(a.nn + idx);
        cr[u] = grid_at<kBf16>(a.coef, Aa + idx);
        dr[u] = grid_at<kBf16>(a.D, Da + idx / k);
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < np * k) {
        nb[idx] = nbr[u];
        vv[idx] = -cr[u] * rsqrtf(dr[u]);
      }
    }
  }
  for (int i = j0 + threadIdx.x; i < np; i += blockDim.x) {
    di[i] = rsqrtf(grid_at<kBf16>(a.D, Da + i));
    cnt[i] = __ldg(a.nn_n + i);
  }
  for (int jj = threadIdx.x; jj <= j1 - j0; jj += blockDim.x)
    rp[jj] = __ldg(a.rev_ptr + j0 + jj) - e0;
  for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x)
    pq[e - e0] = __ldg(a.rev_pos + e);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = j0 + warp;
  if (j >= np) return;                        // the whole warp
  float* acc = acc_rows + warp * np;
  for (int l = lane; l < np; l += 32) acc[l] = 0.0f;
  // r_i[j] r_i[l] at l in {i} and unit i's real neighbours, i = j first,
  // then the units that list j in order, 32 at a time: lane t holds the
  // t-th (unit i lists j in slot pos - i k, so r_i[j] = vv[pos])
  const int eb = rp[warp], ee = rp[warp + 1];
  for (int c0 = eb - 1; c0 < ee; c0 += 32) {
    const int e = c0 + lane;
    int ui = j;
    float ur = di[j];
    if (e >= eb && e < ee) {
      const int pos = pq[e];
      ui = pos / k;
      ur = vv[pos];
    }
    const int m = min(32, ee - c0);
    __syncwarp();
    if (k < 32) {
      // a lane a place l of r_i (k + 1 <= 32); the next unit's places
      // and values are read while this one's are added
      int i = __shfl_sync(0xffffffffu, ui, 0);
      int n = cnt[i];
      int l = lane < n ? nb[i * k + lane] : i;
      float v = lane < n ? vv[i * k + lane] : di[i];
      float rij = __shfl_sync(0xffffffffu, ur, 0);
      bool on = lane <= n;
      for (int t = 1;; ++t) {
        const int i2 = __shfl_sync(0xffffffffu, ui, t & 31);
        const float r2 = __shfl_sync(0xffffffffu, ur, t & 31);
        int l2 = 0;
        float v2 = 0.0f;
        bool on2 = false;
        if (t < m) {
          const int n2 = cnt[i2];
          on2 = lane <= n2;
          l2 = lane < n2 ? nb[i2 * k + lane] : i2;
          v2 = lane < n2 ? vv[i2 * k + lane] : di[i2];
        }
        if (on) acc[l] = fmaf(rij, v, acc[l]);
        __syncwarp();
        if (t >= m) break;
        l = l2, v = v2, rij = r2, on = on2;
      }
    } else {
      for (int t = 0; t < m; ++t) {
        const int i = __shfl_sync(0xffffffffu, ui, t);
        const float rij = __shfl_sync(0xffffffffu, ur, t);
        const int n = cnt[i];
        for (int s = lane; s <= n; s += 32) {
          const int l = s < n ? nb[i * k + s] : i;
          const float ril = s < n ? vv[i * k + s] : di[i];
          acc[l] = fmaf(rij, ril, acc[l]);
        }
        __syncwarp();
      }
    }
  }
  float* out = a.out + (static_cast<long long>(cf) * np + j) * np;
  for (int l = lane; l < np; l += 32) out[l] = acc[l];
}

}  // namespace

// iW for C nf factors: blocks of 32 rows threads (a warp a row) over (np /
// rows tiles, C nf), `smem` bytes of dynamic shared memory
// (ops/spatial.py · iw_geometry); `bf16` 1: coef and D are the bfloat16
// shadows.
extern "C" int hmsc_nngp_iw(const int* nn, const int* nn_n, const void* coef,
                            const void* D, const int* rev_ptr,
                            const int* rev_pos, const int* alpha, float* out,
                            int C, int nf, int np, int k, int nnz, int rows,
                            int smem, int bf16, void* stream) {
  if (rows < 1 || rows > 32 || np < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = bf16 ? nngp_iw_kernel<true> : nngp_iw_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  IwArgs a{nn, nn_n, coef, D, rev_ptr, rev_pos, alpha, out, np, k, nnz};
  const dim3 grid(static_cast<unsigned>((np + rows - 1) / rows),
                  static_cast<unsigned>(C) * nf);
  kernel<<<grid, 32 * rows, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
