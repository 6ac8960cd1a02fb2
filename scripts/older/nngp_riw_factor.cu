// The first version of kernel B8c, kept as a yardstick: chip_smoke.py and
// scripts/nngp_dense_iw_sweep.py build it on the card and time it, followed
// by the gram (torch.matmul), beside the shipped B8c
// (hmsc_tpu_torch/csrc/nngp_riw.cu), which writes iW in one launch.  It is
// not part of the package and no path runs it.
//
// It writes the dense Vecchia factor RiW of each chain's factors,
//
//   RiW[c,f,i,:] = (e_i - sum_k A[a,i,k] e_{nn[i,k]}) / sqrt(D[a,i]),
//   a = alpha[c, f],
//
// as (C, nf, np, np): one thread per (chain, factor, row) owns its row: it
// zeroes it, adds -A at each neighbour in slot order, adds 1 on the
// diagonal and divides the row by sqrt(D).  No store coalesces (the lanes
// of a warp write np floats apart).

#include <cuda_runtime.h>

namespace {

__global__ void nngp_riw_kernel(const int* __restrict__ nn,
                                const float* __restrict__ coef,
                                const float* __restrict__ D,
                                const int* __restrict__ alpha,
                                float* __restrict__ out, int C, int np,
                                int nf, int k) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= static_cast<long long>(C) * nf * np) return;
  const int i = static_cast<int>(idx % np);
  const long long cf = idx / np;            // c * nf + f
  const long long a = alpha[cf];
  float* row = out + idx * np;              // RiW[c, f, i, :]
  for (int j = 0; j < np; ++j) row[j] = 0.0f;
  const float* Ai = coef + (a * np + i) * k;
  const int* nb = nn + static_cast<long long>(i) * k;
  for (int kk = 0; kk < k; ++kk) row[nb[kk]] += -Ai[kk];
  row[i] += 1.0f;
  const float sq = sqrtf(D[a * np + i]);
  for (int j = 0; j < np; ++j) row[j] = row[j] / sq;
}

}  // namespace

extern "C" int hmsc_nngp_riw(const int* nn, const float* coef,
                             const float* D, const int* alpha, float* out,
                             int C, int np, int nf, int k, void* stream) {
  const long long n = static_cast<long long>(C) * nf * np;
  const int threads = 128;
  nngp_riw_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                    threads, 0, static_cast<cudaStream_t>(stream)>>>(
      nn, coef, D, alpha, out, C, np, nf, k);
  return static_cast<int>(cudaGetLastError());
}
