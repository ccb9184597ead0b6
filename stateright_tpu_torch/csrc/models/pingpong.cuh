// Ping-pong as device code: the successor of one state under one action of
// the actor layer, its boundary folded into the enabled bit.
//
// The device-code twin of stateright_tpu_torch/models/pingpong.py
// (PingPongDevice.deliver and .boundary on ActorDeviceModel.step), itself
// the port of stateright_tpu/tpu/models/pingpong.py deliver :88 and
// boundary :114, after the reference's actor_test_util.rs:20-37, 60-95.
//
// Lanes (w = 4 + e + 1): [0], [1] each actor's count; [2], [3] the history
// (in, out), left as they are without one; the network of e slots from
// lane 4 (actor_net.cuh) and the overflow flag. Envelope: value << 3 |
// kind << 2 | src << 1 | dst, kind Ping 0 and Pong 1. The network's form
// (lossy, duplicating) and the history are runtime flags, so one
// instantiation holds all eight forms, at up to kMaxE slots. No timers, no
// symmetry; every lane a whole word.

#pragma once

#include <cstdint>

#include "actor_net.cuh"

namespace sr {

template <int kMaxE_>
struct PingPong {
  static constexpr int kMaxE = kMaxE_;
  static constexpr int kNetOff = 4;
  static constexpr int kMaxW = kNetOff + kMaxE + 1;
  // No lane_bits(): each lane is a whole word, and a row is copied, not
  // packed (wave.cuh's WholeWords).
  static constexpr int kMaxWords = kMaxW;
  static constexpr bool kWholeWords = true;
  static constexpr int kMaxOut = 1;
  static constexpr int kTimers = 0, kTimerOff = 0;
  static constexpr int kMinFanout = kMaxE;

  int e;  // net_slots, 1 <= e <= kMaxE
  bool history, lossy, duplicating;
  uint32_t max_nat;

  __host__ __device__ int width() const { return kNetOff + e + 1; }
  __host__ __device__ int fanout() const { return lossy ? 2 * e : e; }

  // Applies action f to the state in v, in place; returns whether it is
  // enabled and its successor lies inside the boundary (both counts at
  // most max_nat).
  __device__ __forceinline__ bool step(uint32_t (&v)[kMaxW], int f) const {
    const bool enabled = actor_step(*this, v, f);
    return enabled && v[0] <= max_nat && v[1] <= max_nat;
  }

  // PingPongActor.on_msg at the envelope's destination: a message whose
  // value is the actor's count is answered to its source and counted (the
  // history records the delivery and the reply).
  __device__ __forceinline__ bool on_deliver(uint32_t (&v)[kMaxW],
                                             uint32_t env,
                                             uint32_t (&outs)[kMaxOut]) const {
    const uint32_t dst = env & 1u, src = (env >> 1) & 1u;
    const uint32_t kind = (env >> 2) & 1u, value = env >> 3;
    const uint32_t count = dst == 0 ? v[0] : v[1];
    const bool handled = count == value;
    const bool pong = kind == 1u;
    const uint32_t reply = ((pong ? value + 1u : value) << 3) |
                           ((pong ? 0u : 1u) << 2) | (dst << 1) | src;
    if (dst == 0) v[0] = count + 1u;
    if (dst == 1) v[1] = count + 1u;
    if (history) {
      v[2] += 1u;
      v[3] += 1u;
    }
    outs[0] = handled ? reply : kEmptyEnv;
    return handled;
  }

  // No symmetry: the row is its own representative.
  __device__ __forceinline__ void representative(uint32_t (&)[kMaxW]) const {}
};

}  // namespace sr
