// B9c: full-draw quantiles of the predicted responses, by selection.
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
// and NaN for a column holding a NaN (jnp.quantile's default); -0.0 and
// +0.0 are equal values.
//
// What bounds it on the H100: by the function, the bytes, each draw read
// once (205 MB at 800 x 64 x 1000, 0.061 ms at 3.35 TB/s); as measured,
// the passes' shared-memory latency (PERF.md).  The function needs only the
// ranks floor(pos) and ceil(pos) of each q, not the order of a column (the
// first version sorted each column in shared memory: 55 barrier-separated
// bitonic stages at 800 draws, 1.49 ms, and at most 32768 draws).  Design:
//   - an exact radix select on an order-preserving key of each float
//     (-0.0 taken as +0.0; then the sign bit of a positive flipped, every
//     bit of a negative), so keys compare as the values do;
//   - a block takes 8 consecutive columns (one 32-byte sector of a draw
//     row; 16 or 32 columns, 64- or 128-byte rows, took 0.428 and 0.429 ms
//     against 0.409), a warp a column.  Up to kStagedMax draws the block
//     stages its tile in shared memory by cp.async, [draw][9] (a word of
//     padding a row, so a warp's reads down its column fall in 32 banks;
//     staging through registers, 8 loads in flight, with the first pass
//     on the way, took 0.589 ms against 0.570).  Above kStagedMax every
//     pass reads the column from global memory, where L2 keeps it: any
//     draw count;
//   - a first pass keys the column in place and finds a NaN and its least
//     and largest key.  Equal, every rank is that value.  Else the
//     bits above the first one where they differ are common to the column,
//     and the digits start there: a histogram of the next 8 bits over the
//     whole column, and each wanted rank's bin from one warp scan of it;
//   - one more pass over the column gathers the keys of the wanted bins
//     into a warp buffer of 320 keys by an atomic cursor a bin (a ballot a
//     bin, in draw order, took 0.589 ms against 0.484), the bins in rank
//     order while they fit: three passes over the column in all where
//     they do; else another gather after the placed ranks are found, and
//     a bin larger than the buffer is refined on the column;
//   - for each wanted rank not yet found, within its bin's keys: while the
//     set holds more than 64 keys and bits remain, a pass histograms it by
//     the next 8 bits, with its least and largest key (equal: the set is
//     one value), and the rank's sub-bin becomes the set.  A set of at most
//     64 keys is gathered, two a lane, and ranked exactly (ties by order),
//     which gives every wanted rank that falls in it;
//   - a warp has one histogram, its own, in shared memory (one word of
//     padding every 32 bins, so the lanes' reads of their 8 bins each fall
//     in 32 banks), counted by shared atomics (aggregated by
//     __match_any_sync: 0.699 ms against 0.586); it holds the gather's
//     cursors between the level-1 counts and the refinements, so 4 blocks
//     of 8 warps fit an SM at 800 draws.

#include <cuda_runtime.h>

namespace {

constexpr int kLogCols = 3;
constexpr int kCols = 1 << kLogCols;       // columns (and warps) a block
constexpr int kThreads = 32 * kCols;
constexpr int kPad = kCols + 1;            // words a staged draw row
constexpr int kBits = 8;                   // digit width
constexpr int kBins = 1 << kBits;
constexpr int kHistWords = kBins + kBins / 32;
constexpr int kFew = 64;                   // a set this small is ranked
constexpr int kBuf = 320;                  // keys of the wanted bins a warp
constexpr int kMaxQ = 16;                  // quantiles a launch
constexpr int kMaxR = 2 * kMaxQ;           // ranks a launch
constexpr int kStagedMax = 2048;           // draws a staged tile holds
// a warp's words: a histogram (the level-1 one, then the gather's
// cursors, then the refinements'), the ranked few, each rank's key, the
// rank, its level-1 bin, the keys before the bin, its count and its keys'
// place in the buffer, the buffer: 4 blocks of 8 warps an SM at 800 draws
constexpr int kWarpWords = kHistWords + kFew + 6 * kMaxR + kBuf;
constexpr unsigned kNone = 0xffffffffu;    // the key of a NaN only

__device__ __forceinline__ unsigned key_of(float v) {
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;            // -0.0 ranks as +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ int hidx(unsigned b) {
  return static_cast<int>(b + (b >> 5));
}

__device__ __forceinline__ void cp_async4(unsigned* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// A column's keys: from the staged tile ([d * kPad]), or read and keyed
// from global memory.
template <bool kStaged>
struct Column {
  const unsigned* tile;                    // the column's first staged key
  const float* g;                          // draws + col
  long long cols;
  __device__ __forceinline__ unsigned operator()(int d) const {
    if (kStaged) return tile[d * kPad];
    return key_of(__ldg(g + d * cols));
  }
};

// Keys gathered in a warp's buffer.
struct Slice {
  const unsigned* k;
  __device__ __forceinline__ unsigned operator()(int d) const { return k[d]; }
};

// A lane's 8 bins of histogram h (bins 8 lane ..) and the warp's
// exclusive and inclusive prefix counts at them.
struct Scan {
  unsigned c[8], excl, incl;
  __device__ __forceinline__ Scan(const unsigned* h, int lane) {
    unsigned s = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c[i] = h[hidx(lane * 8 + i)];
      s += c[i];
    }
    incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    excl = incl - s;
  }
  // the bin holding the k-th (0-based) key counted: its index, the count
  // of the bins before it and its own count
  __device__ __forceinline__ void find(unsigned k, int lane, unsigned& bin,
                                       unsigned& before,
                                       unsigned& count) const {
    const int owner =
        __ffs(__ballot_sync(0xffffffffu, excl <= k && k < incl)) - 1;
    unsigned acc = excl, b = 0, cnt = 0;
    bool found = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!found) {
        if (k < acc + c[i]) {
          b = lane * 8 + i;
          cnt = c[i];
          found = true;
        } else {
          acc += c[i];
        }
      }
    }
    bin = __shfl_sync(0xffffffffu, b, owner);
    before = __shfl_sync(0xffffffffu, acc, owner);
    count = __shfl_sync(0xffffffffu, cnt, owner);
  }
};

// Histogram h of the digit (key >> shift) & dmask over the keys with
// (key & pmask) == prefix, and their least and largest key.
template <class Src>
__device__ __forceinline__ void hist_pass(const Src& src, int n, int lane,
                                          unsigned* h, unsigned prefix,
                                          unsigned pmask, int shift,
                                          unsigned dmask, unsigned& mn,
                                          unsigned& mx) {
  for (int i = lane; i < kHistWords; i += 32) h[i] = 0u;
  __syncwarp();
  unsigned lo = kNone, hi = 0u;
#pragma unroll 4
  for (int d = lane; d < n; d += 32) {
    const unsigned key = src(d);
    if ((key & pmask) == prefix) {
      atomicAdd(h + hidx((key >> shift) & dmask), 1u);
      lo = min(lo, key);
      hi = max(hi, key);
    }
  }
  mn = __reduce_min_sync(0xffffffffu, lo);
  mx = __reduce_max_sync(0xffffffffu, hi);
  __syncwarp();
}

// The cnt (<= 64) keys with (key & pmask) == prefix, gathered in order
// into cand; lane l holds cand[l] and cand[l + 32] (`mine`) and their
// exact ranks among them (`r`, ties by order).
template <class Src>
__device__ __forceinline__ void rank_few(const Src& src, int n, int lane,
                                         unsigned* cand, unsigned prefix,
                                         unsigned pmask, unsigned cnt,
                                         unsigned (&mine)[2],
                                         unsigned (&r)[2]) {
  unsigned base = 0;
  for (int d0 = 0; d0 < n && base < cnt; d0 += 32) {
    const int d = d0 + lane;
    const unsigned key = d < n ? src(d) : 0u;
    const bool hit = d < n && (key & pmask) == prefix;
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (hit) cand[base + __popc(bal & ((1u << lane) - 1u))] = key;
    base += __popc(bal);
  }
  __syncwarp();
  const unsigned i0 = lane, i1 = lane + 32;
  mine[0] = i0 < cnt ? cand[i0] : kNone;
  mine[1] = i1 < cnt ? cand[i1] : kNone;
  r[0] = r[1] = 0;
  for (unsigned j = 0; j < cnt; ++j) {
    const unsigned o = cand[j];
    r[0] += (o < mine[0]) || (o == mine[0] && j < i0);
    r[1] += (o < mine[1]) || (o == mine[1] && j < i1);
  }
  __syncwarp();
}

// The wanted ranks' keys in val from the set of `cnt` keys matching
// prefix / pmask (`rem` low bits not fixed), which holds the ranks
// [below, below + cnt) of the column, within the `n` keys of src: refine
// by digits while the set is large, then rank the few exactly.
template <class Src>
__device__ void resolve(const Src& src, int n, int lane, unsigned* h,
                        unsigned* cand, unsigned* val, const unsigned* rk,
                        int m, unsigned k, unsigned prefix, unsigned pmask,
                        unsigned below, unsigned cnt, int rem) {
  while (cnt > static_cast<unsigned>(kFew) && rem > 0) {
    const int wd = min(kBits, rem), sh = rem - wd;
    const unsigned dm = (1u << wd) - 1u;
    unsigned mn, mx, b, before, c;
    hist_pass(src, n, lane, h, prefix, pmask, sh, dm, mn, mx);
    if (mn == mx) {                        // the set is one value
      prefix = mn;
      rem = 0;
      break;
    }
    Scan(h, lane).find(k - below, lane, b, before, c);
    prefix |= b << sh;
    pmask |= dm << sh;
    below += before;
    cnt = c;
    rem = sh;
  }
  if (rem == 0) {
    // every key of the set is `prefix`: so is every rank in it
    for (int s = lane; s < m; s += 32)
      if (rk[s] >= below && rk[s] < below + cnt) val[s] = prefix;
  } else {
    unsigned mine[2], r[2];
    rank_few(src, n, lane, cand, prefix, pmask, cnt, mine, r);
    // the lane holding the key of each wanted rank in the set writes it
    // (the ranks in a set are distinct, so one lane a rank)
    const bool has0 = static_cast<unsigned>(lane) < cnt;
    const bool has1 = static_cast<unsigned>(lane) + 32 < cnt;
    for (int s = 0; s < m; ++s) {
      const unsigned rs = rk[s];
      if (has0 && rs == below + r[0]) val[s] = mine[0];
      if (has1 && rs == below + r[1]) val[s] = mine[1];
    }
  }
  __syncwarp();
}

struct QArgs {
  const float* draws;                      // (n, cols)
  long long cols;
  int n;
  const float* q;                          // (nq,)
  int nq;
  float* out;                              // (nq, cols)
};

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
serve_quantile_kernel(const QArgs a) {
  extern __shared__ __align__(16) unsigned sm[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* h = sm + w * kWarpWords;       // the warp's histogram
  unsigned* cand = h + kHistWords;
  unsigned* val = cand + kFew;             // each rank's key
  unsigned* rk = val + kMaxR;              // each rank
  unsigned* rbin = rk + kMaxR;             // its level-1 bin,
  unsigned* rbelow = rbin + kMaxR;         // the keys before the bin,
  unsigned* rcnt = rbelow + kMaxR;         // the bin's count
  unsigned* rat = rcnt + kMaxR;            // and its keys in buf (or kNone)
  unsigned* buf = rat + kMaxR;
  unsigned* tile = sm + kCols * kWarpWords;
  const int n = a.n;
  const long long col0 = static_cast<long long>(blockIdx.x) * kCols;
  const long long col = col0 + w;
  if (kStaged) {
    for (int i = threadIdx.x; i < n * kCols; i += kThreads) {
      const int d = i >> kLogCols, c = i & (kCols - 1);
      if (col0 + c < a.cols)
        cp_async4(tile + d * kPad + c,
                  a.draws + static_cast<long long>(d) * a.cols + col0 + c);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  if (col >= a.cols) return;
  const Column<kStaged> src{tile + w, a.draws + col, a.cols};
  // the first pass: a NaN, the least and largest key (staged: keyed in
  // place)
  unsigned lo = kNone, hi = 0u;
  bool bad = false;
  for (int d = lane; d < n; d += 32) {
    const float v =
        kStaged ? __uint_as_float(tile[d * kPad + w])
                : __ldg(a.draws + static_cast<long long>(d) * a.cols + col);
    bad |= isnan(v);
    const unsigned k = key_of(v);
    if (kStaged) tile[d * kPad + w] = k;
    lo = min(lo, k);
    hi = max(hi, k);
  }
  bad = __any_sync(0xffffffffu, bad);
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  __syncwarp();
  const bool any_nan = bad;
  const float last = static_cast<float>(n) - 1.0f;
  const int m = 2 * a.nq;                  // ranks: floor, ceil of each q
  for (int t = lane; t < m; t += 32) {
    const float pos = __fmul_rn(__ldg(a.q + (t >> 1)), last);
    const float f = (t & 1) ? ceilf(pos) : floorf(pos);
    rk[t] = static_cast<unsigned>(min(max(static_cast<int>(f), 0), n - 1));
    val[t] = lo == hi ? lo : kNone;
  }
  __syncwarp();
  if (!any_nan && lo != hi) {
    // the column's keys share the bits above `top`
    const int top = 32 - __clz(lo ^ hi);
    const unsigned pmask0 = top == 32 ? 0u : ~((1u << top) - 1u);
    const unsigned prefix0 = lo & pmask0;
    const int w1 = min(kBits, top), shift1 = top - w1;
    const unsigned dmask1 = (1u << w1) - 1u;
    if (n <= kFew) {
      resolve(src, n, lane, h, cand, val, rk, m, 0u, prefix0, pmask0, 0u,
              static_cast<unsigned>(n), top);
    } else {
      unsigned mn, mx;
      hist_pass(src, n, lane, h, prefix0, pmask0, shift1, dmask1, mn, mx);
      {
        // each rank's level-1 bin, from one scan
        const Scan sc(h, lane);
        for (int t = 0; t < m; ++t) {
          unsigned b, before, c;
          sc.find(rk[t], lane, b, before, c);
          if (lane == 0) {
            rbin[t] = b;
            rbelow[t] = before;
            rcnt[t] = c;
          }
        }
      }
      __syncwarp();
      const unsigned pmask = pmask0 | (dmask1 << shift1);
      // rounds: the wanted bins of the ranks not yet found get places in
      // buf, in rank order, while they fit; one pass over the column
      // gathers their keys (an atomic cursor a bin, in h; in no set order:
      // a rank's value does not depend on it), and their ranks are found
      // on the gathered keys
      for (int round = 0; round < m; ++round) {   // each finds a rank
        if (!__any_sync(0xffffffffu, lane < m && val[lane] == kNone)) break;
        for (int i = lane; i < kHistWords; i += 32) h[i] = kNone;
        __syncwarp();
        unsigned used = 0;
        if (lane == 0) {
          for (int t = 0; t < m; ++t) {
            unsigned at = kNone;
            if (val[t] == kNone) {
              for (int s = 0; s < t; ++s)
                if (rbin[s] == rbin[t] && rat[s] != kNone) at = rat[s];
              if (at == kNone &&
                  used + rcnt[t] <= static_cast<unsigned>(kBuf)) {
                at = used;
                h[hidx(rbin[t])] = used;
                used += rcnt[t];
              }
            }
            rat[t] = at;
          }
        }
        if (__shfl_sync(0xffffffffu, used, 0) == 0) break;
        __syncwarp();
#pragma unroll 4
        for (int d = lane; d < n; d += 32) {
          const unsigned key = src(d);
          unsigned* cur = h + hidx((key >> shift1) & dmask1);
          if (*cur != kNone) buf[atomicAdd(cur, 1u)] = key;
        }
        __syncwarp();
        for (int t = 0; t < m; ++t)
          if (val[t] == kNone && rat[t] != kNone)
            resolve(Slice{buf + rat[t]}, static_cast<int>(rcnt[t]), lane, h,
                    cand, val, rk, m, rk[t], prefix0 | (rbin[t] << shift1),
                    pmask, rbelow[t], rcnt[t], shift1);
      }
      // a bin larger than buf: refined on the whole column
      for (int t = 0; t < m; ++t)
        if (val[t] == kNone)
          resolve(src, n, lane, h, cand, val, rk, m, rk[t],
                  prefix0 | (rbin[t] << shift1), pmask, rbelow[t], rcnt[t],
                  shift1);
    }
  }
  __syncwarp();
  for (int qi = lane; qi < a.nq; qi += 32) {
    float v = __int_as_float(0x7fc00000);
    if (!any_nan) {
      const float pos = __fmul_rn(__ldg(a.q + qi), last);
      const float w_hi = __fsub_rn(pos, floorf(pos));
      const float w_lo = __fsub_rn(1.0f, w_hi);
      v = __fadd_rn(__fmul_rn(value_of(val[2 * qi]), w_lo),
                    __fmul_rn(value_of(val[2 * qi + 1]), w_hi));
    }
    a.out[static_cast<long long>(qi) * a.cols + col] = v;
  }
}

}  // namespace

// draws (n, cols) float32 -> out (nq, cols), nq <= 16; `staged`: n <=
// 2048 draws, the tile in shared memory (ops/serve.py · quantile_layout).
extern "C" int hmsc_serve_quantile(const float* draws, long long cols, int n,
                                   int staged, const float* q, int nq,
                                   float* out, void* stream) {
  if (n < 1 || nq < 0 || nq > kMaxQ || cols < 0 ||
      (staged && n > kStagedMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cols == 0 || nq == 0) return 0;
  const int warps = kCols * kWarpWords * static_cast<int>(sizeof(unsigned));
  const int smem =
      warps + (staged ? n * kPad * static_cast<int>(sizeof(unsigned)) : 0);
  const QArgs a{draws, cols, n, q, nq, out};
  const long long blocks = (cols + kCols - 1) / kCols;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void (*kernel)(QArgs) =
      staged ? serve_quantile_kernel<true> : serve_quantile_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
