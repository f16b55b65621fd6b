// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011), written out by hand, and the attention-dropout keep bit built
// on it. Shared by the T5 attention forward and backward sources, so both
// draw the same bits.
//
// Replaces the TPU kernel's hardware PRNG (`pltpu.prng_seed` /
// `prng_random_bits` in `_fwd_kernel` / `_bwd_kernel`), whose stream has no
// counterpart on the card. The keep bit of probability (b, h, q, k) is a
// pure function of (seed, b, h, q, k), independent of how a kernel tiles
// the work, so the forward, the backward (tiled differently) and the plain
// PyTorch version (`ops/fused_attention.py`, `philox4x32_10`) all agree. h
// is the global head: a tensor-parallel rank passes its first head's index
// as the kernels' `head_offset`, so its masks are one process's.
//   counter = (k >> 2, q, h, b), key = (low, high 32 bits of the seed),
//   word    = Philox4x32-10(counter, key)[k & 3],
//   keep    = word > floor(rate * 2^32)   (as the TPU kernel compares).

#pragma once

#include <cstdint>

namespace klab {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t pick_word(uint4 w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// The dropout keep bit of probability (b, h, q, k). `seed` is the 64-bit
// seed read from device memory.
__device__ __forceinline__ bool dropout_keep(uint64_t seed, int b, int h,
                                             int q, int k,
                                             uint32_t threshold) {
  const uint4 ctr = make_uint4((uint32_t)k >> 2, (uint32_t)q, (uint32_t)h,
                               (uint32_t)b);
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  return pick_word(philox4x32_10(ctr, key), k & 3) > threshold;
}

// The Philox key of the int64 seed in device memory: its low and high 32
// bits, as `dropout_keep` forms them; zero without a seed.
__device__ __forceinline__ uint2 seed_key(const long long* seed) {
  if (seed == nullptr) return make_uint2(0u, 0u);
  const uint64_t sd = (uint64_t)*seed;
  return make_uint2((uint32_t)sd, (uint32_t)(sd >> 32));
}

// The keep bits of the four probabilities that share one counter, keys
// 4 * kc .. 4 * kc + 3 of query q: bit i is word i's. One Philox call for
// four keep bits; the tensor-core kernels hand them between lanes.
__device__ __forceinline__ uint32_t keep_nibble(uint2 key, uint32_t kc, int q,
                                                int h, int b,
                                                uint32_t threshold) {
  const uint4 w = philox4x32_10(
      make_uint4(kc, (uint32_t)q, (uint32_t)h, (uint32_t)b), key);
  return (uint32_t)(w.x > threshold) | (uint32_t)(w.y > threshold) << 1 |
         (uint32_t)(w.z > threshold) << 2 | (uint32_t)(w.w > threshold) << 3;
}

}  // namespace klab
