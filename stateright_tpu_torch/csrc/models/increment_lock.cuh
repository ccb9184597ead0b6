// The shared counter behind a lock as device code: the successor of one
// state under one action, and the exact representative of its symmetry
// class.
//
// The device-code twin of stateright_tpu_torch/models/increment_lock.py
// (IncrementLockDevice.step and .representative), itself the port of
// stateright_tpu/tpu/models/increment_lock.py step :68-87 and
// representative :100-105, after the reference's
// examples/increment_lock.rs:60-96.
//
// Lanes (w = 2 + 2T): [0] the shared counter, [1] the lock held; for
// thread k, [2 + 2k] its read value t and [3 + 2k] its pc (0 wants the
// lock, 1 about to read, 2 about to write, 3 holds the lock after the
// write, 4 done). Action k is thread k's step, chosen by its pc: take the
// lock (lock = 1, pc = 1; enabled when the lock is free), read (t = i, pc
// = 2), write (i = t + 1, pc = 3), or else release (lock = 0, pc = 4;
// enabled at pc 3 with the lock held). No boundary, no error lane.

#pragma once

#include <cstdint>

#include "../packing.cuh"
#include "thread_sort.cuh"

namespace sr {

template <int kT>
struct IncrementLock {
  static constexpr int kMaxW = 2 + 2 * kT;
  // t_bits-bit counter and read values, a 1-bit lock, 3-bit pcs
  // (lane_bits()).
  static constexpr int kTBits = kT < 4 ? 2 : (kT < 8 ? 3 : (kT < 16 ? 4 : 5));
  static constexpr int kMaxWords = ((kT + 1) * kTBits + 1 + 3 * kT + 31) / 32;
  static constexpr int kMinFanout = kT;

  __host__ __device__ int width() const { return kMaxW; }
  __host__ __device__ int fanout() const { return kT; }

  // Applies action f (thread f's step) to the state in v, in place, and
  // returns whether it is enabled; a disabled action's successor is
  // computed all the same, as the torch and JAX steps do.
  __device__ __forceinline__ bool step(uint32_t (&v)[kMaxW], int f) const {
    const uint32_t lock = v[1];
    const uint32_t t = get_lane(v, 2 + 2 * f);
    const uint32_t pc = get_lane(v, 3 + 2 * f);
    uint32_t next_pc;
    if (pc == 0) {  // take the lock
      v[1] = 1u;
      next_pc = 1u;
    } else if (pc == 1) {  // read
      set_lane(v, 2 + 2 * f, v[0]);
      next_pc = 2u;
    } else if (pc == 2) {  // write
      v[0] = t + 1u;
      next_pc = 3u;
    } else {  // release
      v[1] = 0u;
      next_pc = 4u;
    }
    set_lane(v, 3 + 2 * f, next_pc);
    return (pc == 0 && lock == 0) || pc == 1 || pc == 2 ||
           (pc == 3 && lock == 1);
  }

  // The threads sorted by their (t, pc) pairs, keyed t * 8 + pc.
  __device__ __forceinline__ void representative(
      uint32_t (&v)[kMaxW]) const {
    sort_threads<kT, 8, 2>(v);
  }
};

}  // namespace sr
