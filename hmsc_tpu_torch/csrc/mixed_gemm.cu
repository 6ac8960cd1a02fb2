// B10: the mixed-precision GEMM, bfloat16 operands with float32
// accumulation and float32 output, batched and strided:
//
//   out[b] = round(op(A[b])) round(op(B[b])),   (M x K) (K x N), b < nb,
//
// each operand given by its pointer and three element strides (batch, row,
// column; a batch stride 0 broadcasts one matrix over the batch), so a
// transposed operand (XE' in XE'XE and XE'Z) is read in place.  An operand
// is float32, rounded at load to bfloat16 by __float2bfloat16_rn (round to
// nearest even, as XLA's convert), or a bfloat16 shadow staged once a run,
// read as it is.
//
// Replaces hmsc_tpu/ops/mixed.py · matmul / einsum (:121-137): dot_general
// on bf16 operands with preferred_element_type=float32, which the JAX
// package's policy'd sweep blocks route their grams and products through.
// torch.matmul on bf16 tensors returns bf16 (a rounded accumulation), a
// different function.
//
// What bounds it on the H100: at the headline's XE'Z (C 4, P 10, ny 1000,
// ns 1000) bytes, Z in float32 (16 MB) read once and 160 KB written,
// 0.0049 ms at 3.35 TB/s, against 8e7 multiply-adds (0.00008 ms on the
// bf16 tensor cores); the skinny grams (XE'XE: 10 x 10 outputs, K 1000,
// C 4; E E' and lam lam' at most 16 wide) are latency.  Design, a simple
// first form (wgmma and TMA come later):
//   - a block of 4 warps a 64 x 64 output tile, a warp 32 x 32 as 2 x 4
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 tiles with
//     float32 accumulators, fragments loaded by ldmatrix (x4) from the k
//     tile in shared memory (A as [m][k], B as [n][k], rows of 40 bf16 so
//     the eight rows of an 8 x 8 matrix fall in distinct banks);
//   - the k tile (32 deep) is loaded by the block with each operand's
//     unit-stride index across a warp's lanes where it has one (coalesced),
//     rounded and stored as bf16, zero past the matrix's edges;
//   - K is split into S consecutive ranges chosen from the shape alone
//     (ops/mixed.py · gemm_splits: ~2 blocks an SM), so the skinny grams
//     fill the card; each split writes its partial tile to a scratch buffer
//     and a second kernel adds the S partials in split order.  No atomics:
//     reruns give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 128;       // 4 warps, 2 x 2, each 32 x 32
constexpr int kLds = kBK + 8;       // a shared row: 40 bf16 = 80 bytes

struct Args {
  const void* a;
  long long sa_b, sa_m, sa_k;
  const void* b;
  long long sb_b, sb_k, sb_n;
  float* out;                       // (nb, M, N), or the (S, nb, M, N) partials
  int nb, M, N, K, chunk, S;
};

template <bool kBf16>
__device__ __forceinline__ __nv_bfloat16 load_bf16(const void* p,
                                                   long long i) {
  if constexpr (kBf16)
    return static_cast<const __nv_bfloat16*>(p)[i];
  else
    return __float2bfloat16_rn(__ldg(static_cast<const float*>(p) + i));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kABf16, bool kBBf16>
__global__ void __launch_bounds__(kThreads) mixed_gemm_kernel(const Args g) {
  __shared__ __align__(16) __nv_bfloat16 As[kBM * kLds];   // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[kBN * kLds];   // [n][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int b = blockIdx.z / g.S, split = blockIdx.z % g.S;
  const int k_lo = split * g.chunk;
  const int k_hi = min(g.K, k_lo + g.chunk);
  const long long abase = static_cast<long long>(b) * g.sa_b;
  const long long bbase = static_cast<long long>(b) * g.sb_b;
  // the lanes run along each operand's unit-stride index where it has one
  const bool a_kfast = g.sa_k == 1, b_nfast = g.sb_n == 1 || g.sb_k != 1;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    // the k tile of A (64 x 32) and of B (32 x 64, stored [n][k])
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int mm = a_kfast ? e / kBK : e % kBM;
      const int kk = a_kfast ? e % kBK : e / kBM;
      const int m = m0 + mm, k = k0 + kk;
      As[mm * kLds + kk] =
          (m < g.M && k < k_hi)
              ? load_bf16<kABf16>(g.a, abase + m * g.sa_m + k * g.sa_k)
              : zero;
    }
    for (int e = tid; e < kBN * kBK; e += kThreads) {
      const int nn = b_nfast ? e % kBN : e / kBK;
      const int kk = b_nfast ? e / kBN : e % kBK;
      const int n = n0 + nn, k = k0 + kk;
      Bs[nn * kLds + kk] =
          (n < g.N && k < k_hi)
              ? load_bf16<kBBf16>(g.b, bbase + k * g.sb_k + n * g.sb_n)
              : zero;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      unsigned af[2][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], As + (wm + 16 * i + (lane & 15)) * kLds + ks +
                           (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4(bfr[j], Bs + (wn + 16 * j + (lane & 7) + (lane >> 4) * 8) *
                                 kLds + ks + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2],
                   bfr[j >> 1][(j & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  float* out = g.out + (static_cast<long long>(split) * g.nb + b) *
                           static_cast<long long>(g.M) * g.N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm + 16 * i + (lane >> 2) + (q >> 1) * 8;
        const int n = n0 + wn + 8 * j + (lane & 3) * 2 + (q & 1);
        if (m < g.M && n < g.N) out[static_cast<long long>(m) * g.N + n] =
            acc[i][j][q];
      }
}

// the S partials of every output added in split order
__global__ void mixed_gemm_sum_kernel(const float* __restrict__ partial,
                                      float* __restrict__ out, long long n,
                                      int S) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (e >= n) return;
  float s = partial[e];
  for (int sp = 1; sp < S; ++sp) s += partial[sp * n + e];
  out[e] = s;
}

template <bool kABf16, bool kBBf16>
cudaError_t launch(const Args& g, int nb, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((g.N + kBN - 1) / kBN),
                  static_cast<unsigned>((g.M + kBM - 1) / kBM),
                  static_cast<unsigned>(nb) * g.S);
  mixed_gemm_kernel<kABf16, kBBf16><<<grid, kThreads, 0, st>>>(g);
  return cudaGetLastError();
}

}  // namespace

// out (nb, M, N) float32 = round(A) round(B); A (b, m, k) and B (b, k, n)
// by their element strides, each float32 (a_bf16 / b_bf16 0) or bfloat16
// (1).  With S > 1 the k range is cut into S ranges of `chunk` (a multiple
// of 32), each written to `partial` (S, nb, M, N), then summed in order.
extern "C" int hmsc_mixed_gemm(const void* a, int a_bf16, long long sa_b,
                               long long sa_m, long long sa_k, const void* b,
                               int b_bf16, long long sb_b, long long sb_k,
                               long long sb_n, float* out, float* partial,
                               int nb, int M, int N, int K, int S, int chunk,
                               void* stream) {
  if (nb < 1 || M < 1 || N < 1 || K < 1 || S < 1 || chunk < 1 ||
      chunk % kBK != 0 || static_cast<long long>(S - 1) * chunk >= K ||
      static_cast<long long>(nb) * S > 65535 || (M + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args g{a, sa_b, sa_m, sa_k, b, sb_b, sb_k, sb_n,
               S > 1 ? partial : out, nb, M, N, K, chunk, S};
  cudaError_t err;
  if (a_bf16 && b_bf16) err = launch<true, true>(g, nb, st);
  else if (a_bf16) err = launch<true, false>(g, nb, st);
  else if (b_bf16) err = launch<false, true>(g, nb, st);
  else err = launch<false, false>(g, nb, st);
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(nb) * M * N;
  mixed_gemm_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                          st>>>(partial, out, n, S);
  return static_cast<int>(cudaGetLastError());
}
