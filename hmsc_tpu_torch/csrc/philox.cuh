// Counter-based Philox4x32-10 (Salmon et al., "Parallel random numbers: as
// easy as 1, 2, 3", SC 2011), written out for the port's kernels.  Each
// thread draws from its own counter (element index, launch offset, round),
// keyed by a 64-bit seed the Python wrapper draws from the run's host
// torch.Generator, so a launch needs no generator state on the device.
#pragma once

#include <cstdint>

namespace hmsc {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  const unsigned M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const unsigned W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const unsigned hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += W0;
    key.y += W1;
  }
  return ctr;
}

// The same generator with its ten round keys (key + r (W0, W1), r = 0..9)
// formed on the host and passed in the launch's arguments, where every
// round reads them as constants instead of adding them.
struct PhiloxKeys {
  uint2 k[10];
};

__host__ __device__ inline PhiloxKeys philox_round_keys(uint2 key) {
  PhiloxKeys ks;
  for (int i = 0; i < 10; ++i) {
    ks.k[i] = key;
    key.x += 0x9E3779B9u;
    key.y += 0xBB67AE85u;
  }
  return ks;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr,
                                               const PhiloxKeys& ks) {
  const unsigned M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const unsigned hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ ks.k[i].x, lo1, hi0 ^ ctr.w ^ ks.k[i].y,
                     lo0);
  }
  return ctr;
}

__host__ __device__ __forceinline__ uint2 seed_key(unsigned long long seed) {
  return make_uint2(static_cast<unsigned>(seed),
                    static_cast<unsigned>(seed >> 32));
}

// A uniform on [1e-38, 1), 24 random bits: never 0, so log(u) and
// log1p(-u) stay finite (the JAX package draws on [_TINY, 1), rand.py:18).
__device__ __forceinline__ float uniform01(unsigned bits) {
  return fmaxf(static_cast<float>(bits >> 8) * (1.0f / 16777216.0f), 1e-38f);
}

// One standard normal from two uniforms (Box-Muller, cosine branch).
__device__ __forceinline__ float box_muller(unsigned b0, unsigned b1) {
  const float r = sqrtf(-2.0f * logf(uniform01(b0)));
  return r * cospif(2.0f * uniform01(b1));
}

}  // namespace hmsc
