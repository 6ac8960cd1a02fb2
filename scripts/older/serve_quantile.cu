// The first version of kernel B9c, kept as a yardstick: chip_smoke.py and
// scripts/select_z_sweep.py build it on the card and time it beside the
// shipped B9c (hmsc_tpu_torch/csrc/serve_quantile.cu), which selects the
// wanted ranks instead of sorting.  It is not part of the package and no
// path runs it.
//
// B9c: full-draw quantiles of the predicted responses.
//
// Replaces the jnp.quantile of hmsc_tpu/serve/kernels.py ·
// make_predict_kernel(quantiles=...) (:180-182), which XLA computes by a
// sort of the whole (n, B, ns) block along the draw axis.  For every column
// (b, j) of the draws (n, B, ns) and probability q: jnp.quantile's default
// linear interpolation, at position pos = q (n - 1) in float32,
//
//   lo = floor(pos), hi = ceil(pos), w = pos - lo,
//   quantile = x(lo) (1 - w) + x(hi) w        (sorted x, products and sum
//                                              rounded apart, as XLA does)
//
// and NaN for a column holding a NaN (jnp.quantile's default).
//
// What bounds it on the H100: the sort.  Bytes are small (each draw read
// once, 205 MB at 800 x 64 x 1000, 0.06 ms); a bitonic sort of P = 2^k
// values takes k (k + 1) / 2 compare-exchange stages over P / 2 pairs.
// Design: a block takes cpb consecutive columns (a power of two up to 8:
// one 32-byte sector of a draw row, so loads coalesce) and holds them in
// shared memory as [draw][column], padded with +inf to P; the block's
// threads walk the stages, a barrier between stages; then each (q, column)
// is interpolated by one thread.  The draw count is bounded by shared
// memory: P <= 32768 (one column a block, 128 KB); the wrapper raises
// above it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
serve_quantile_kernel(const float* __restrict__ draws, long long cols, int n,
                      int P, int cpb, const float* __restrict__ q, int nq,
                      float* __restrict__ out) {
  extern __shared__ float s[];               // [P][cpb]
  __shared__ int has_nan[8];
  const int tid = threadIdx.x;
  const long long col0 = static_cast<long long>(blockIdx.x) * cpb;
  if (tid < cpb) has_nan[tid] = 0;
  __syncthreads();
  for (int i = tid; i < P * cpb; i += kThreads) {
    const int d = i / cpb, c = i - d * cpb;
    const long long col = col0 + c;
    float v = __int_as_float(0x7f800000);     // +inf pads the sort
    if (d < n && col < cols) {
      v = draws[static_cast<long long>(d) * cols + col];
      if (isnan(v)) {
        has_nan[c] = 1;
        v = __int_as_float(0x7f800000);
      }
    }
    s[i] = v;
  }
  __syncthreads();
  // cpb and h are powers of two: index arithmetic by shifts and masks
  const int lc = __ffs(cpb) - 1;
  const int pairs = (P / 2) * cpb;
  for (int k = 2; k <= P; k <<= 1) {
    for (int h = k >> 1; h > 0; h >>= 1) {
      const int lh = __ffs(h) - 1;
      for (int i = tid; i < pairs; i += kThreads) {
        const int p = i >> lc, c = i & (cpb - 1);
        const int lo = ((p >> lh) << (lh + 1)) | (p & (h - 1));
        const int hi = lo + h;
        const bool up = (lo & k) == 0;
        const float a = s[(lo << lc) + c], b = s[(hi << lc) + c];
        if ((a > b) == up) {
          s[(lo << lc) + c] = b;
          s[(hi << lc) + c] = a;
        }
      }
      __syncthreads();
    }
  }
  const float last = static_cast<float>(n) - 1.0f;
  for (int i = tid; i < nq * cpb; i += kThreads) {
    const int qi = i / cpb, c = i - qi * cpb;
    const long long col = col0 + c;
    if (col >= cols) continue;
    const float pos = __fmul_rn(q[qi], last);
    const float flo = floorf(pos), fhi = ceilf(pos);
    const float w_hi = __fsub_rn(pos, flo);
    const float w_lo = __fsub_rn(1.0f, w_hi);
    const int lo = min(max(static_cast<int>(flo), 0), n - 1);
    const int hi = min(max(static_cast<int>(fhi), 0), n - 1);
    float v = __fadd_rn(__fmul_rn(s[lo * cpb + c], w_lo),
                        __fmul_rn(s[hi * cpb + c], w_hi));
    if (has_nan[c]) v = __int_as_float(0x7fc00000);
    out[static_cast<long long>(qi) * cols + col] = v;
  }
}

}  // namespace

// draws (n, cols) float32 -> out (nq, cols); P the power of two >= n, cpb
// columns a block (a power of two <= 8), P * cpb floats of shared memory.
extern "C" int hmsc_serve_quantile(const float* draws, long long cols, int n,
                                   int P, int cpb, const float* q, int nq,
                                   float* out, void* stream) {
  if (n < 1 || P < n || cpb < 1 || cpb > 8 ||
      static_cast<long long>(P) * cpb * 4 > 232448 - 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cols == 0 || nq == 0) return 0;
  const int smem = P * cpb * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        serve_quantile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (cols + cpb - 1) / cpb;
  serve_quantile_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      draws, cols, n, P, cpb, q, nq, out);
  return static_cast<int>(cudaGetLastError());
}
