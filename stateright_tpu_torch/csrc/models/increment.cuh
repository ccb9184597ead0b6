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
// The model is a template on the largest thread count it holds (kMaxT), the
// count t itself at run time (as TwoPhase<N> takes its RMs): the row stays
// in registers of kMaxT threads' lanes, every lane index but the action's
// thread's is a constant after unrolling, and the representative sorts the
// first t threads only. with_increment picks the least capacity of 2, 4, 8
// and 16 that holds a count, so 1 to 16 threads run on four instances.

#pragma once

#include <cstdint>

#include "../packing.cuh"
#include "thread_sort.cuh"

namespace sr {

template <int kMaxT_>
struct Increment {
  static constexpr int kMaxT = kMaxT_;
  static constexpr int kMaxW = 1 + 2 * kMaxT;
  // A t_bits-bit counter and read values (t_bits = max(2, bit length of
  // t)) and 2-bit pcs (lane_bits()); the most words of any t <= kMaxT.
  static constexpr int kTBits =
      kMaxT < 4 ? 2 : (kMaxT < 8 ? 3 : (kMaxT < 16 ? 4 : 5));
  static constexpr int kMaxWords =
      ((kMaxT + 1) * kTBits + 2 * kMaxT + 31) / 32;
  // The fewest threads of the class: one more than the next capacity down.
  static constexpr int kMinFanout = kMaxT > 2 ? kMaxT / 2 + 1 : 1;

  int t;  // threads, 1 <= t <= kMaxT

  __host__ __device__ int width() const { return 1 + 2 * t; }
  __host__ __device__ int fanout() const { return t; }

  // Applies action f (thread f's step) to the state in v, in place, and
  // returns whether it is enabled. A disabled action's successor is the
  // write's, as the torch and JAX steps compute it.
  __device__ __forceinline__ bool step(uint32_t (&v)[kMaxW], int f) const {
    const uint32_t tv = get_lane(v, 1 + 2 * f);
    const uint32_t pc = get_lane(v, 2 + 2 * f);
    if (pc == 1) {
      set_lane(v, 1 + 2 * f, v[0]);
      set_lane(v, 2 + 2 * f, 2u);
    } else {
      v[0] = tv + 1u;
      set_lane(v, 2 + 2 * f, 3u);
    }
    return pc == 1 || pc == 2;
  }

  // The threads sorted by their (t, pc) pairs, keyed t * 4 + pc.
  __device__ __forceinline__ void representative(
      uint32_t (&v)[kMaxW]) const {
    sort_threads<kMaxT, 4, 1>(v, t);
  }
};

// Calls fn with the instance that holds `threads` threads, the least
// capacity of 2, 4, 8 and 16 at or above the count; `none` when none does.
template <class Fn>
long long with_increment(int threads, long long none, Fn&& fn) {
  if (threads < 1) return none;
  if (threads <= 2) return fn(Increment<2>{threads});
  if (threads <= 4) return fn(Increment<4>{threads});
  if (threads <= 8) return fn(Increment<8>{threads});
  if (threads <= 16) return fn(Increment<16>{threads});
  return none;
}

}  // namespace sr
