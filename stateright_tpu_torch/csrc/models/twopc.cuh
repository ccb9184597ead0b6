// Two-phase commit as device code: the successor of one state under one
// action, and the exact representative of its symmetry class.
//
// The device-code twin of stateright_tpu_torch/models/twopc.py
// (TwoPhaseDevice.step and .representative), itself the port of
// stateright_tpu/tpu/models/twopc.py step :97-130 and representative
// :154-185, after the reference's examples/2pc.rs:52-76 and :165-182.
//
// Lanes (w = n + 3): [0, n) RM states (WORKING 0, PREPARED 1, COMMITTED 2,
// ABORTED 3), [n] the TM state (INIT 0, COMMITTED 1, ABORTED 2), [n+1]
// the TM's prepared bitmask, [n+2] the message bitmask (bit 0 Commit,
// bit 1 Abort, bit 2+i Prepared(i)). Action f, in the reference's order:
// 0 TmCommit, 1 TmAbort, then for RM i = (f-2)/5 by (f-2)%5:
// TmRcvPrepared, RmPrepare, RmChooseToAbort, RmRcvCommitMsg,
// RmRcvAbortMsg. 2pc has no boundary and no error lane.
//
// The model is a template on the largest RM count it holds (kMaxN): the
// row stays in registers of that size, and the runtime count n <= kMaxN
// guards each slot.

#pragma once

#include <cstdint>

#include "../packing.cuh"

namespace sr {

template <int kMaxN>
struct TwoPhase {
  static constexpr int kMaxW = kMaxN + 3;
  // 2 bits an RM and the TM, n + n + 2 bits of masks (lane_bits()).
  static constexpr int kMaxWords = (4 * kMaxN + 4 + 31) / 32;
  // The fewest actions at any RM count (one RM).
  static constexpr int kMinFanout = 7;

  int n;  // RM count

  __host__ __device__ int width() const { return n + 3; }
  __host__ __device__ int fanout() const { return 2 + 5 * n; }

  // Applies action f to the state in v, in place, and returns whether the
  // action is enabled. A disabled action's successor is computed all the
  // same, as the torch and JAX steps do, so the stored rows agree.
  __device__ __forceinline__ bool step(uint32_t (&v)[kMaxW], int f) const {
    const uint32_t tm = get_lane(v, n);
    const uint32_t prep = get_lane(v, n + 1);
    const uint32_t msgs = get_lane(v, n + 2);
    if (f == 0) {  // TmCommit
      set_lane(v, n, 1u);
      set_lane(v, n + 2, msgs | 1u);
      return tm == 0 && prep == (1u << n) - 1;
    }
    if (f == 1) {  // TmAbort
      set_lane(v, n, 2u);
      set_lane(v, n + 2, msgs | 2u);
      return tm == 0;
    }
    const int i = (f - 2) / 5;
    const uint32_t rm = get_lane(v, i);
    switch ((f - 2) % 5) {
      case 0:  // TmRcvPrepared(i)
        set_lane(v, n + 1, prep | (1u << i));
        return tm == 0 && ((msgs >> (2 + i)) & 1u);
      case 1:  // RmPrepare(i)
        set_lane(v, i, 1u);
        set_lane(v, n + 2, msgs | (1u << (2 + i)));
        return rm == 0;
      case 2:  // RmChooseToAbort(i)
        set_lane(v, i, 3u);
        return rm == 0;
      case 3:  // RmRcvCommitMsg(i)
        set_lane(v, i, 2u);
        return (msgs & 1u) != 0;
      default:  // RmRcvAbortMsg(i)
        set_lane(v, i, 3u);
        return (msgs & 2u) != 0;
    }
  }

  // The exact canonical member of v's symmetry class, in place. An RM's
  // whole part of the state is the triple (rm state, prepared bit,
  // Prepared(i) message bit), packed into one key; sorting the keys sorts
  // the RMs, and equal keys are identical triples, so the sorted keys
  // alone rebuild the row. The sort is an insertion sort unrolled into a
  // network over kMaxN keys, the absent RMs padded past every real key.
  __device__ __forceinline__ void representative(
      uint32_t (&v)[kMaxW]) const {
    const uint32_t prep = get_lane(v, n + 1);
    const uint32_t msgs = get_lane(v, n + 2);
    uint32_t key[kMaxN];
#pragma unroll
    for (int j = 0; j < kMaxN; ++j)
      key[j] = j < n ? v[j] * 4u + ((prep >> j) & 1u) * 2u +
                           ((msgs >> (2 + j)) & 1u)
                     : 0xFFFFFFFFu;
#pragma unroll
    for (int a = 1; a < kMaxN; ++a) {
#pragma unroll
      for (int b = a; b > 0; --b) {
        const uint32_t lo = min(key[b - 1], key[b]);
        const uint32_t hi = max(key[b - 1], key[b]);
        key[b - 1] = lo;
        key[b] = hi;
      }
    }
    uint32_t new_prep = 0, new_msg = 0;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < n) {
        v[j] = key[j] >> 2;
        new_prep |= ((key[j] >> 1) & 1u) << j;
        new_msg |= (key[j] & 1u) << j;
      }
    }
    set_lane(v, n + 1, new_prep);
    set_lane(v, n + 2, (msgs & 3u) | (new_msg << 2));
  }
};

}  // namespace sr
