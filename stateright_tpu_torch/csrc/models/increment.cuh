// The racy shared counter as device code: the successor of one state under
// one action, and the exact representative of its symmetry class.
//
// The device-code twin of stateright_tpu_torch/models/increment.py
// (IncrementDevice.step and .representative), itself the port of
// stateright_tpu/tpu/models/increment.py step :70-82 and representative
// :92-97, after the reference's examples/increment.rs:163-185.
//
// Lanes (w = 1 + 2T): [0] the shared counter i; for thread k, [1 + 2k]
// its read value t and [2 + 2k] its pc (1 about to read, 2 about to
// write, 3 done). Action k is thread k's one step: a read (t = i, pc = 2)
// when pc == 1, else a write (i = t + 1, pc = 3), enabled when pc is 1 or
// 2. No boundary, no error lane.
//
// The model is a template on its thread count: every lane index is a
// constant after unrolling, but the action's thread, which selects over
// the threads (get_lane / set_lane).

#pragma once

#include <cstdint>

#include "../packing.cuh"
#include "thread_sort.cuh"

namespace sr {

template <int kT>
struct Increment {
  static constexpr int kMaxW = 1 + 2 * kT;
  // A t_bits-bit counter and read values (t_bits = max(2, bit length of
  // T)) and 2-bit pcs (lane_bits()).
  static constexpr int kTBits = kT < 4 ? 2 : (kT < 8 ? 3 : (kT < 16 ? 4 : 5));
  static constexpr int kMaxWords = ((kT + 1) * kTBits + 2 * kT + 31) / 32;
  static constexpr int kMinFanout = kT;

  __host__ __device__ int width() const { return kMaxW; }
  __host__ __device__ int fanout() const { return kT; }

  // Applies action f (thread f's step) to the state in v, in place, and
  // returns whether it is enabled. A disabled action's successor is the
  // write's, as the torch and JAX steps compute it.
  __device__ __forceinline__ bool step(uint32_t (&v)[kMaxW], int f) const {
    const uint32_t t = get_lane(v, 1 + 2 * f);
    const uint32_t pc = get_lane(v, 2 + 2 * f);
    if (pc == 1) {
      set_lane(v, 1 + 2 * f, v[0]);
      set_lane(v, 2 + 2 * f, 2u);
    } else {
      v[0] = t + 1u;
      set_lane(v, 2 + 2 * f, 3u);
    }
    return pc == 1 || pc == 2;
  }

  // The threads sorted by their (t, pc) pairs, keyed t * 4 + pc.
  __device__ __forceinline__ void representative(
      uint32_t (&v)[kMaxW]) const {
    sort_threads<kT, 4, 1>(v);
  }
};

}  // namespace sr
