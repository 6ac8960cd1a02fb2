// B6: masked grams and right-hand sides, a weighted sum of outer products.
//
// Replaces the masked contractions of hmsc_tpu/mcmc/updaters.py that the
// JAX package runs when Y has missing values (einsums XLA lays out for the
// TPU's matrix unit):
//
//   per species, _per_species_design_gram / _beta_lambda_joint
//     G[c,j] = sum_i m_ij x_ci x_ci',  R[c,j] = sum_i m_ij Z_cij x_ci
//   per row of a level, _masked_level_gram
//     G[c,i] = sum_j m_ij iSigma_cj l_cj l_cj',
//     R[c,i] = sum_j m_ij iSigma_cj S_cij l_cj
//
// One interface covers both:
//
//   G[c,o] = sum_k w[o,k] a[c,k] v[c,k] v[c,k]'          (C, O, P, P)
//   R[c,o] = sum_k w[o,k] a[c,k] s[c,o,k] v[c,k]         (C, O, P)
//
// with v (C, K, P), w (O, K), a (C, K) (absent: 1) and s (C, O, K) each
// given by its strides, so the per-species form (o = species, k = row) and
// the per-row form (o = row, k = species) read the same tensors in place.
//
// What bounds it on the H100: operations.  At the 1000 x 1000 headline with
// 4 chains it is 2 C O K (P(P+1)/2 + P) ~ 5e8 flops (0.0078 ms at 67
// TFLOP/s) against ~22 MB moved (0.0066 ms).  Both contractions are matrix
// products over k with the same O x K left side up to s: G = W (a v v'), R
// = (W o s)(a v).  The first design (one chain's 64 x 64 output tile a
// block, the right-hand side in blocks of its own) ran 128 blocks on 132
// SMs at the headline, each walking all of K with nothing in flight, and
// lost to one einsum 4.9x.  This design:
//   - packs the columns: the P(P+1)/2 pairs (p <= q) of G's upper triangle
//     and the P entries of R form one column range (65 columns at P 10, 44
//     at P 8), cut into slots of 16; a column tile carries NG gram slots
//     and one right-hand-side slot, so no block computes a mostly empty
//     tile.  The map column -> (p, q), q < 0 for R, is built by the
//     wrapper (ops/gram.py · gram_columns);
//   - forms the column operand once, in a first kernel: B[c, t, k, j] = a_k
//     v_p v_q (gram) or a_k v_p (right-hand side), instead of once in every
//     block that reads it;
//   - splits K over blocks: the split count is a function of the shape
//     alone (ops/gram.py · gram_splits), ~8 blocks an SM (1024 at the
//     headline); each split writes its partial sums to a scratch buffer
//     the wrapper allocates, and a third kernel adds them in split order
//     and mirrors G's symmetric half.  No atomics: two runs give the same
//     bits;
//   - double-buffers the k tiles (16 rows) with 16-byte cp.async: tile t +
//     1 of w, s and B is in flight while tile t's products run; w and s
//     are copied along whichever of o and k is contiguous (o in the
//     per-species form, k in the per-row form) and laid out by k row once
//     a tile, with s multiplied by w;
//   - keeps the multiply-adds in float32 (TF32 keeps ~3 digits, against the
//     1e-4 gate): 128 threads, each 8 outputs x (NG + 1) columns, reading
//     its 8 weights as two 16-byte loads and the columns conflict-free.
//     Three TF32 products on mma.sync (a_hi b_hi + a_hi b_lo + a_lo b_hi)
//     keep float32's accuracy but ran slower than these multiply-adds at
//     this shape: the operands' splits and the fragments' loads outweighed
//     the tensor cores' rate.
//   What still holds it above one einsum for G: the multiply-add loop runs
//   at about half the float32 rate (the weights' shared-memory loads), and
//   the staging of each k tile and the two small kernels around it take
//   about a third of the time (scripts/gram_tile_sweep.py times the tiles).
//
// The bf16 form (`bf16` 1: the masked mx einsums of a policy'd block,
// bf16 operands, float32 accumulation) rounds each operand as the JAX
// package forms it before its mx call, w being a 0/1 mask (exact):
//   G[c,o] = sum_k w[o,k] rd(a[c,k]) rd(v[c,k]) rd(v[c,k])',
//   R[c,o] = sum_k w[o,k] rd(s[c,o,k]) rd(v[c,k]),
// with a kept out of R: the per-row form's caller passes s = S iSigma,
// formed in float32 (the JAX package's S * iSigma * Ymask, rounded).  The
// products of three bfloat16 values are exact in float32, so only the
// order of the sums differs from the float32 form's arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTY = 8;              // thread rows, each kTM outputs
constexpr int kTX = 16;             // thread columns, one of each slot
constexpr int kTM = 8;              // outputs a thread (a multiple of 4)
constexpr int kBK = 16;             // k tile
constexpr int kBO = kTY * kTM;      // outputs a block
constexpr int kThreads = kTY * kTX;
constexpr int kMinBlocks = 4;       // blocks an SM the registers must allow
constexpr int kSlot = kTX;          // columns a slot
constexpr int kMaxSlots = 8;        // gram slots a column tile at most
constexpr int kLd = kBO + 4;        // row stride of the w and w s tiles
constexpr int kRawO = kBO + 4;      // raw tile row stride, o contiguous
constexpr int kRawK = kBK + 4;      // raw tile row stride, k contiguous
constexpr int kRaw = kBO * kRawK > kBK * kRawO ? kBO * kRawK : kBK * kRawO;

// how a raw w or s tile is copied: along o in fours, along o one at a
// time (any strides), or along k in fours
enum Mode { kOVec = 0, kOScalar = 1, kKVec = 2 };

struct Args {
  const float* w; long long w_so, w_sk;
  const float* s; long long s_sc, s_so, s_sk;
  const float* B;                    // (C, T, K, kB) column operand
  float* partial;                    // (S, C, O, T kB)
  int C, O, K, chunk, T, w_mode, s_mode, bf16;
};

// x rounded to bfloat16 (nearest even) and widened
__device__ __forceinline__ float rd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// a (kBK x kBO) tile of x[o, k] into a raw buffer, zero past o_end and
// k_hi: T[kk][ol] (row stride kRawO) in modes kOVec and kOScalar,
// T[ol][kk] (row stride kRawK) in mode kKVec
__device__ __forceinline__ void load_raw(float* T, const float* x,
                                         long long so, long long sk, int o0,
                                         int o_end, int k0, int k_hi,
                                         int mode, int tid) {
  if (mode == kOVec) {
    for (int e = tid; e < kBK * kBO / 4; e += kThreads) {
      const int ol = 4 * (e % (kBO / 4)), kk = e / (kBO / 4);
      const int o = o0 + ol, k = k0 + kk;
      const bool ok = o < o_end && k < k_hi;
      cp_async16(T + kk * kRawO + ol, ok ? x + o + k * sk : x, ok);
    }
  } else if (mode == kKVec) {
    for (int e = tid; e < kBO * kBK / 4; e += kThreads) {
      const int kk = 4 * (e % (kBK / 4)), ol = e / (kBK / 4);
      const int o = o0 + ol, k = k0 + kk;
      const bool ok = o < o_end && k < k_hi;
      cp_async16(T + ol * kRawK + kk, ok ? x + o * so + k : x, ok);
    }
  } else {
    const bool o_fast = so == 1;
    for (int e = tid; e < kBK * kBO; e += kThreads) {
      const int ol = o_fast ? e % kBO : e / kBK;
      const int kk = o_fast ? e / kBO : e % kBK;
      const int o = o0 + ol, k = k0 + kk;
      const bool ok = o < o_end && k < k_hi;
      cp_async4(T + kk * kRawO + ol, ok ? x + o * so + k * sk : x, ok);
    }
  }
}

// The column operand of every (chain, column tile, k): a_k v_p v_q for
// the tile's gram columns, a_k v_p for its right-hand-side slot, 0 past
// the ends.
__global__ void masked_gram_columns_kernel(
    const float* __restrict__ v, long long v_sc, long long v_sk,
    long long v_sp, const float* __restrict__ a, long long a_sc,
    long long a_sk, const int* __restrict__ colp,
    const int* __restrict__ colq, float* __restrict__ B, int C, int K,
    int P, int NG, int T, int bf16) {
  const int kB = (NG + 1) * kSlot, n_pair = P * (P + 1) / 2;
  const long long total = static_cast<long long>(C) * T * K * kB;
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (e >= total) return;
  const int j = static_cast<int>(e % kB);
  const int k = static_cast<int>((e / kB) % K);
  const int ct = static_cast<int>(e / (static_cast<long long>(kB) * K));
  const int c = ct / T, t = ct % T;
  const float* vk = v + c * v_sc + k * v_sk;
  float x = 0.0f;
  const bool gram = j < NG * kSlot;
  if (gram) {
    const int col = t * NG * kSlot + j;
    if (col < n_pair) {
      const float vp = vk[colp[col] * v_sp], vq = vk[colq[col] * v_sp];
      x = bf16 ? rd(vp) * rd(vq) : vp * vq;
    }
  } else {
    const int p = t * kSlot + j - NG * kSlot;
    if (p < P) x = bf16 ? rd(vk[p * v_sp]) : vk[p * v_sp];
  }
  // the bf16 form keeps a out of R's columns (its caller folds a into s)
  if (a != nullptr && (gram || !bf16)) {
    const float av = a[c * a_sc + k * a_sk];
    x *= bf16 ? rd(av) : av;
  }
  B[e] = x;
}

// One (output tile, k split, chain, column tile) block: partial sums of
// the tile's 64 outputs over the split's k range for its NG gram slots
// and its right-hand-side slot; thread (ty, tx) carries outputs 8 ty ..
// 8 ty + 7 and column tx of every slot.
template <int NG>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    masked_gram_kernel(Args A) {
  extern __shared__ __align__(16) float sm[];
  constexpr int kB = (NG + 1) * kSlot;   // columns of a tile
  float* Wraw = sm;                      // [2][kRaw]
  float* Sraw = Wraw + 2 * kRaw;         // [2][kRaw]
  float* Wc = Sraw + 2 * kRaw;           // [kBK][kLd] w
  float* Sc = Wc + kBK * kLd;            // [kBK][kLd] w s
  float* Bs = Sc + kBK * kLd;            // [2][kBK][kB]

  const int tid = threadIdx.x;
  const int ty = tid / kTX, tx = tid % kTX;
  const int o0 = blockIdx.x * kBO;
  const int split = blockIdx.y;
  const int c = blockIdx.z / A.T, t = blockIdx.z % A.T;
  const int k_lo = split * A.chunk;
  const int k_hi = min(A.K, k_lo + A.chunk);
  const float* s = A.s + c * A.s_sc;
  const long long bt = (static_cast<long long>(c) * A.T + t) * A.K * kB;

  auto load = [&](int buf, int k0) {
    load_raw(Wraw + buf * kRaw, A.w, A.w_so, A.w_sk, o0, A.O, k0, k_hi,
             A.w_mode, tid);
    load_raw(Sraw + buf * kRaw, s, A.s_so, A.s_sk, o0, A.O, k0, k_hi,
             A.s_mode, tid);
    for (int e = tid; e < kBK * kB / 4; e += kThreads) {
      const int kk = e / (kB / 4), j = 4 * (e % (kB / 4));
      const bool ok = k0 + kk < k_hi;
      const long long at = bt + static_cast<long long>(k0 + kk) * kB + j;
      cp_async16(Bs + (buf * kBK + kk) * kB + j, ok ? A.B + at : A.B, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float accg[kTM][NG], accr[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    accr[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NG; ++j) accg[i][j] = 0.0f;
  }

  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  if (n_tiles > 0) load(0, k_lo);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // tile it has landed, and every thread is done with tile it - 1's
    // buffers, which the next load overwrites
    __syncthreads();
    if (it + 1 < n_tiles) load(buf ^ 1, k_lo + (it + 1) * kBK);
    // w and w s, laid out by k row
    const float* Wr = Wraw + buf * kRaw;
    const float* Sr = Sraw + buf * kRaw;
    // element q of a thread's four is (kk + q, ol) where w's raw tile runs
    // along k, else (kk, ol + q); 16-byte reads where a raw tile runs the
    // same way, 16-byte writes where the four are along o
    const bool wk = A.w_mode == kKVec, sk = A.s_mode == kKVec;
    for (int e = tid; e < kBK * kBO / 4; e += kThreads) {
      const int ol = wk ? e % kBO : 4 * (e % (kBO / 4));
      const int kk = wk ? 4 * (e / kBO) : e / (kBO / 4);
      const float4 w4 = *reinterpret_cast<const float4*>(
          Wr + (wk ? ol * kRawK + kk : kk * kRawO + ol));
      float4 s4;
      if (sk == wk) {
        s4 = *reinterpret_cast<const float4*>(
            Sr + (sk ? ol * kRawK + kk : kk * kRawO + ol));
      } else if (sk) {               // four o of one k from a k-major tile
        s4 = make_float4(Sr[ol * kRawK + kk], Sr[(ol + 1) * kRawK + kk],
                         Sr[(ol + 2) * kRawK + kk], Sr[(ol + 3) * kRawK + kk]);
      } else {                       // four k of one o from an o-major tile
        s4 = make_float4(Sr[kk * kRawO + ol], Sr[(kk + 1) * kRawO + ol],
                         Sr[(kk + 2) * kRawO + ol], Sr[(kk + 3) * kRawO + ol]);
      }
      if (A.bf16) s4 = make_float4(rd(s4.x), rd(s4.y), rd(s4.z), rd(s4.w));
      const float4 ws = make_float4(w4.x * s4.x, w4.y * s4.y, w4.z * s4.z,
                                    w4.w * s4.w);
      if (wk) {
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
        const float sv[4] = {ws.x, ws.y, ws.z, ws.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          Wc[(kk + q) * kLd + ol] = wv[q];
          Sc[(kk + q) * kLd + ol] = sv[q];
        }
      } else {
        *reinterpret_cast<float4*>(Wc + kk * kLd + ol) = w4;
        *reinterpret_cast<float4*>(Sc + kk * kLd + ol) = ws;
      }
    }
    __syncthreads();
    const float* Bt = Bs + buf * kBK * kB;
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4* wp =
          reinterpret_cast<const float4*>(Wc + kk * kLd + ty * kTM);
      const float4* sp =
          reinterpret_cast<const float4*>(Sc + kk * kLd + ty * kTM);
      float wr[kTM], sr[kTM];
#pragma unroll
      for (int q = 0; q < kTM / 4; ++q) {
        const float4 w4 = wp[q], s4 = sp[q];
        wr[4 * q] = w4.x, wr[4 * q + 1] = w4.y;
        wr[4 * q + 2] = w4.z, wr[4 * q + 3] = w4.w;
        sr[4 * q] = s4.x, sr[4 * q + 1] = s4.y;
        sr[4 * q + 2] = s4.z, sr[4 * q + 3] = s4.w;
      }
      float bg[NG];
#pragma unroll
      for (int j = 0; j < NG; ++j) bg[j] = Bt[kk * kB + j * kSlot + tx];
      const float br = Bt[kk * kB + NG * kSlot + tx];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < NG; ++j)
          accg[i][j] = fmaf(wr[i], bg[j], accg[i][j]);
        accr[i] = fmaf(sr[i], br, accr[i]);
      }
    }
  }

  const long long n_col = static_cast<long long>(A.T) * kB;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int o = o0 + ty * kTM + i;
    if (o >= A.O) continue;
    float* out = A.partial +
                 ((static_cast<long long>(split) * A.C + c) * A.O + o) *
                     n_col +
                 t * kB + tx;
#pragma unroll
    for (int j = 0; j < NG; ++j) out[j * kSlot] = accg[i][j];
    out[NG * kSlot] = accr[i];
  }
}

// The S partials of each (chain, output, packed column) added in split
// order; a gram column written to G[p][q] and G[q][p], a right-hand-side
// column to R[p].
__global__ void masked_gram_sum_kernel(const float* __restrict__ partial,
                                       const int* __restrict__ colp,
                                       const int* __restrict__ colq,
                                       float* __restrict__ G,
                                       float* __restrict__ R, long long CO,
                                       int P, int NG, int T, int S) {
  const int n_pair = P * (P + 1) / 2, n_col = n_pair + P;
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (e >= CO * n_col) return;
  const long long co = e / n_col;
  const int col = static_cast<int>(e - co * n_col);
  // the packed column's place in a partial row of T tiles of (NG + 1)
  // slots, the right-hand side's last
  const int kB = (NG + 1) * kSlot;
  const int pos = col < n_pair
                      ? col / (NG * kSlot) * kB + col % (NG * kSlot)
                      : (col - n_pair) / kSlot * kB + NG * kSlot +
                            (col - n_pair) % kSlot;
  const long long row = static_cast<long long>(T) * kB;
  const float* p0 = partial + co * row + pos;
  float sum = 0.0f;
  for (int sp = 0; sp < S; ++sp) sum += p0[sp * CO * row];
  const int p = colp[col], q = colq[col];
  if (q < 0) {
    R[co * P + p] = sum;
  } else {
    G[(co * P + p) * P + q] = sum;
    if (p != q) G[(co * P + q) * P + p] = sum;
  }
}

template <int NG>
cudaError_t launch(const Args& A, int S, cudaStream_t st) {
  const size_t smem = sizeof(float) * (4 * kRaw + 2 * kBK * kLd +
                                       2 * kBK * (NG + 1) * kSlot);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_gram_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>((A.O + kBO - 1) / kBO),
                  static_cast<unsigned>(S), static_cast<unsigned>(A.C * A.T));
  masked_gram_kernel<NG><<<grid, kThreads, smem, st>>>(A);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hmsc_masked_gram(const float* v, long long v_sc,
                                long long v_sk, long long v_sp,
                                const float* w, long long w_so,
                                long long w_sk, const float* a,
                                long long a_sc, long long a_sk,
                                const float* s, long long s_sc,
                                long long s_so, long long s_sk,
                                const int* colp, const int* colq, float* B,
                                float* partial, float* G, float* R, int C,
                                int O, int K, int P, int NG, int T, int S,
                                int chunk, int bf16, void* stream) {
  if (NG < 1 || NG > kMaxSlots || T < 1 || S < 1 || chunk < 1 ||
      chunk % kBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || O == 0 || P == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kB = (NG + 1) * kSlot;
  // 16-byte copies along o or k where that index is contiguous and every
  // copied row starts on 16 bytes
  auto mode = [&](const float* x, long long so, long long sk, long long sc) {
    const bool al = reinterpret_cast<uintptr_t>(x) % 16 == 0 && sc % 4 == 0;
    if (al && so == 1 && sk % 4 == 0 && O % 4 == 0) return int(kOVec);
    if (al && sk == 1 && so % 4 == 0 && K % 4 == 0) return int(kKVec);
    return int(kOScalar);
  };
  const long long n_b = static_cast<long long>(C) * T * K * kB;
  if (n_b > 0) {
    masked_gram_columns_kernel<<<static_cast<unsigned>((n_b + 255) / 256),
                                 256, 0, st>>>(v, v_sc, v_sk, v_sp, a, a_sc,
                                               a_sk, colp, colq, B, C, K, P,
                                               NG, T, bf16);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args A{w, w_so, w_sk, s, s_sc, s_so, s_sk, B, partial,
               C, O, K, chunk, T,
               mode(w, w_so, w_sk, 0), mode(s, s_so, s_sk, s_sc), bf16};
  cudaError_t err;
  switch (NG) {
    case 1: err = launch<1>(A, S, st); break;
    case 2: err = launch<2>(A, S, st); break;
    case 3: err = launch<3>(A, S, st); break;
    case 4: err = launch<4>(A, S, st); break;
    case 5: err = launch<5>(A, S, st); break;
    case 6: err = launch<6>(A, S, st); break;
    case 7: err = launch<7>(A, S, st); break;
    default: err = launch<8>(A, S, st); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long CO = static_cast<long long>(C) * O;
  const long long total = CO * (P * (P + 1) / 2 + P);
  masked_gram_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256,
                           0, st>>>(partial, colp, colq, G, R, CO, P, NG, T,
                                    S);
  return static_cast<int>(cudaGetLastError());
}
