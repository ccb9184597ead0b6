// The packed row format of the device arena, on one row in registers.
//
// The device-code twin of stateright_tpu_torch/packing.py::PackedLayout
// (the port of stateright_tpu/tpu/packing.py pack :261 and unpack :279):
// lane j of a state is a field of bits[j] bits at bit offset[j] of packed
// word word[j], and a field that runs past bit 31 spills into word + 1.
// The word layout equals the reference's bit for bit. A sentinel lane
// holds values below its field's all-ones pattern plus one out-of-band
// value (paxos's empty network slot, 0xFFFFFFFF, taken from the layout):
// pack stores it as min(v, mask), so the sentinel and anything at or above
// the mask become all ones, and unpack turns the all-ones field back into
// the sentinel, as packing.py::pack and _lane do (the reference's
// packing.py :261-297).
//
// A row's lanes and words live in small arrays indexed only by constants
// after unrolling (a runtime index into a register array would put it in
// local memory), so a runtime index is resolved by a select over every
// slot: get_lane / set_lane.

#pragma once

#include <cstdint>

namespace sr {

// A layout of at most kMaxW lanes and kMaxWords words, passed by value
// as a kernel parameter.
template <int kMaxW, int kMaxWords>
struct Layout {
  int w;   // lanes
  int wp;  // packed words a row
  uint8_t word[kMaxW];
  uint8_t offset[kMaxW];
  uint8_t bits[kMaxW];
  uint8_t has_sentinel[kMaxW];  // 1 for a sentinel lane
  uint32_t sentinel[kMaxW];     // its unpacked all-ones value
};

template <int kMaxW>
__device__ __forceinline__ uint32_t get_lane(const uint32_t (&v)[kMaxW],
                                             int j) {
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < kMaxW; ++k)
    if (k == j) out = v[k];
  return out;
}

template <int kMaxW>
__device__ __forceinline__ void set_lane(uint32_t (&v)[kMaxW], int j,
                                         uint32_t x) {
#pragma unroll
  for (int k = 0; k < kMaxW; ++k)
    if (k == j) v[k] = x;
}

// Packed words p[0, wp) -> lanes v[0, w).
template <int kMaxW, int kMaxWords>
__device__ __forceinline__ void unpack(const Layout<kMaxW, kMaxWords>& L,
                                       const uint32_t (&p)[kMaxWords],
                                       uint32_t (&v)[kMaxW]) {
#pragma unroll
  for (int j = 0; j < kMaxW; ++j) {
    v[j] = 0;
    if (j < L.w) {
      const int wd = L.word[j];
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int k = 0; k < kMaxWords; ++k) {
        if (k == wd) lo = p[k];
        if (k == wd + 1) hi = p[k];
      }
      const unsigned long long x =
          (((unsigned long long)hi << 32) | lo) >> L.offset[j];
      const uint32_t mask = (uint32_t)((1ull << L.bits[j]) - 1);
      const uint32_t f = (uint32_t)x & mask;
      v[j] = L.has_sentinel[j] && f == mask ? L.sentinel[j] : f;
    }
  }
}

// Lanes v[0, w) -> packed words p[0, wp); a lane keeps its low bits[j]
// bits, and a sentinel lane saturates at its all-ones pattern, as the
// reference's pack does.
template <int kMaxW, int kMaxWords>
__device__ __forceinline__ void pack(const Layout<kMaxW, kMaxWords>& L,
                                     const uint32_t (&v)[kMaxW],
                                     uint32_t (&p)[kMaxWords]) {
#pragma unroll
  for (int k = 0; k < kMaxWords; ++k) p[k] = 0;
#pragma unroll
  for (int j = 0; j < kMaxW; ++j) {
    if (j < L.w) {
      const uint32_t mask = (uint32_t)((1ull << L.bits[j]) - 1);
      const unsigned long long f =
          L.has_sentinel[j] ? min(v[j], mask) : v[j] & mask;
      const unsigned long long x = f << L.offset[j];
      const int wd = L.word[j];
#pragma unroll
      for (int k = 0; k < kMaxWords; ++k) {
        if (k == wd) p[k] |= (uint32_t)x;
        if (k == wd + 1) p[k] |= (uint32_t)(x >> 32);
      }
    }
  }
}

}  // namespace sr
