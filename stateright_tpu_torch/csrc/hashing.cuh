// 64-bit fingerprints of encoded state rows, on one row in registers.
//
// The device-code twin of stateright_tpu_torch/hashing.py::device_fp64
// (itself the port of stateright_tpu/tpu/hashing.py::device_fp64): two
// murmur3_32 rounds over the row's uint32 lanes with seeds 0x9747B28C
// (high half) and 0x2E1F36D9 (low half), each with murmur3's final mix,
// packed into one uint64. A fingerprint equal to the sentinel (all ones)
// is nudged down by one and zero becomes one, as on every other side, so
// a table written here is a valid probe structure for all of them.
//
// Native unsigned arithmetic: the int64 policy of the torch code is a
// property of torch tensors, not of the function.

#pragma once

#include <cstdint>

namespace sr {

typedef unsigned long long u64;

constexpr u64 kSentinel = ~0ull;
constexpr uint32_t kSeedHi = 0x9747B28Cu;
constexpr uint32_t kSeedLo = 0x2E1F36D9u;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// One murmur3_32 round absorbing lane k into state h.
__device__ __forceinline__ uint32_t mm3_fold(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h = rotl32(h ^ k, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t mm3_final(uint32_t h, uint32_t nbytes) {
  h ^= nbytes;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// The fingerprint of the first w lanes of v (w <= kMaxW). The loop is
// unrolled over kMaxW with w as a guard, so v stays in registers.
template <int kMaxW>
__device__ __forceinline__ u64 fp64(const uint32_t (&v)[kMaxW], int w) {
  uint32_t hi = kSeedHi, lo = kSeedLo;
#pragma unroll
  for (int j = 0; j < kMaxW; ++j) {
    if (j < w) {
      hi = mm3_fold(hi, v[j]);
      lo = mm3_fold(lo, v[j]);
    }
  }
  hi = mm3_final(hi, 4u * w);
  lo = mm3_final(lo, 4u * w);
  u64 fp = ((u64)hi << 32) | lo;
  if (fp == kSentinel) fp -= 1;
  return fp == 0 ? 1 : fp;
}

}  // namespace sr
