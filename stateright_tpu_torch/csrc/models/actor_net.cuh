// The actor layer's network as device code: one action of an actor model's
// step, in place on one row, on a network that duplicates or not and loses
// messages or not, with the models' timers.
//
// The device-code twin of the port's batch-first
// actor_device.py::ActorDeviceModel.step (with net_remove_at, net_insert
// and _timeouts), itself the port of stateright_tpu/tpu/actor_device.py
// :127 (_net_effect) and :161 (step): the reference's actor/model.rs
// :238-327.
//
// Lanes of a row: the model's body (each actor's lanes, and below the
// network the timer bitmask, lane H::kTimerOff, where the model has
// timers), then e network slots from lane H::kNetOff, a sorted list of
// envelopes padded with kEmptyEnv (all ones, which sorts last), then the
// overflow flag, the model's error lane. The actions of a row, in the host
// model's order (actor_action): on a lossy network each slot's Drop and
// then its Deliver, f = 2 * slot and 2 * slot + 1; on one that is not, the
// slot's Deliver, f = slot; then the Timeout of each timer actor, from
// f = e * (1 + lossy).
//
// A model H (pingpong.cuh, vsr.cuh, register_workload.cuh) gives:
//   kMaxE, kMaxW, kMaxOut  the most network slots, lanes and sends;
//   kNetOff                its first network lane;
//   kTimers, kTimerOff     its timer actors (0: none) and bitmask lane;
//   e, lossy, duplicating  its runtime slots (1 <= e <= kMaxE) and network
//                          form (static constexpr members where fixed);
//   on_deliver(v, env, outs)  the delivery of envelope env to its
//                          destination, in place on the body of v, the
//                          sends in outs: whether it is handled;
//   on_timeout(v, actor, outs)  likewise the timeout of a timer actor
//                          (only where kTimers > 0).
//
// Every action's successor is computed, enabled or not, on any row, as the
// torch step does: the handler runs on an empty slot's all-ones envelope
// too. The list's removal and inserts are compare-and-select loops over
// kMaxE slots, each guarded by the runtime e, so every lane index is a
// constant after unrolling.

#pragma once

#include <cstdint>

namespace sr {

constexpr uint32_t kEmptyEnv = 0xFFFFFFFFu;

// Action f of a row on a network of e slots: a slot's Deliver or Drop, or a
// timer actor's Timeout (index: the slot, or the actor).
enum ActorKind { kDeliver = 0, kDrop = 1, kTimeout = 2 };
struct ActorAction {
  ActorKind kind;
  int index;
};

__host__ __device__ __forceinline__ ActorAction actor_action(int f, int e,
                                                            bool lossy) {
  const int slots = lossy ? 2 * e : e;
  if (f >= slots) return ActorAction{kTimeout, f - slots};
  if (lossy) return ActorAction{(f & 1) ? kDeliver : kDrop, f >> 1};
  return ActorAction{kDeliver, f};
}

// The network lanes of one row, held while an action runs: the e slots
// (kEmptyEnv past them, and in the spare slot kMaxE) and the overflow lane.
template <int kMaxE>
struct NetList {
  uint32_t net[kMaxE + 1];
  uint32_t err;

  template <int kOff, int kMaxW>
  __device__ __forceinline__ void load(const uint32_t (&v)[kMaxW], int e) {
#pragma unroll
    for (int i = 0; i < kMaxE; ++i) net[i] = i < e ? v[kOff + i] : kEmptyEnv;
    net[kMaxE] = kEmptyEnv;
    err = 0;
#pragma unroll
    for (int i = 0; i <= kMaxE; ++i)
      if (i == e) err = v[kOff + i];
  }

  // The envelope in slot s (s < kMaxE).
  __device__ __forceinline__ uint32_t at(int s) const {
    uint32_t x = kEmptyEnv;
#pragma unroll
    for (int i = 0; i < kMaxE; ++i)
      if (i == s) x = net[i];
    return x;
  }

  // net_remove_at: the tail past slot s shifts left; the list stays sorted.
  __device__ __forceinline__ void remove_at(int s) {
#pragma unroll
    for (int i = 0; i < kMaxE; ++i) net[i] = i < s ? net[i] : net[i + 1];
  }

  // net_insert: each send in turn at its rank, once (a send already in the
  // list, or kEmptyEnv, is skipped); a send into a full list of e drops the
  // largest envelope. Returns whether a send found the list full.
  template <int kOut>
  __device__ __forceinline__ bool insert(const uint32_t (&outs)[kOut],
                                         int e) {
    bool overflow = false;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const uint32_t x = outs[j];
      bool dup = false;
      unsigned pos = 0;
      uint32_t last = kEmptyEnv;
#pragma unroll
      for (int i = 0; i < kMaxE; ++i) {
        dup = dup || net[i] == x;
        pos += net[i] < x ? 1u : 0u;
        if (i == e - 1) last = net[i];
      }
      const bool skip = x == kEmptyEnv || dup;
      overflow = overflow || (!skip && last != kEmptyEnv);
      if (!skip) {
#pragma unroll
        for (int i = kMaxE - 1; i > 0; --i)
          net[i] = (unsigned)i < pos ? net[i]
                   : (unsigned)i == pos ? x
                                        : net[i - 1];
        net[0] = pos == 0 ? x : net[0];
        // The slot past the list's end took the dropped envelope.
#pragma unroll
        for (int i = 0; i < kMaxE; ++i)
          if (i >= e) net[i] = kEmptyEnv;
      }
    }
    return overflow;
  }

  // Writes the e slots back and the overflow lane (set by `overflow`).
  template <int kOff, int kMaxW>
  __device__ __forceinline__ void store(uint32_t (&v)[kMaxW], int e,
                                        bool overflow) const {
#pragma unroll
    for (int i = 0; i < kMaxE; ++i)
      if (i < e) v[kOff + i] = net[i];
#pragma unroll
    for (int i = 0; i <= kMaxE; ++i)
      if (i == e) v[kOff + i] = overflow ? 1u : err;
  }
};

// Action f of model h on the row in v, in place (ActorDeviceModel.step's
// slot f): a Drop removes its slot's envelope and changes nothing else; a
// Deliver runs the handler, removes the envelope unless the network
// duplicates, and inserts the sends; a Timeout runs the actor's handler and
// inserts its sends. Returns whether the action is enabled: a real envelope
// (handled, for a Deliver), or an armed timer whose handler handles it.
template <class H>
__device__ __forceinline__ bool actor_step(const H& h,
                                           uint32_t (&v)[H::kMaxW], int f) {
  NetList<H::kMaxE> n;
  n.template load<H::kNetOff>(v, h.e);
  const ActorAction act = actor_action(f, h.e, h.lossy);
  uint32_t outs[H::kMaxOut];
#pragma unroll
  for (int j = 0; j < H::kMaxOut; ++j) outs[j] = kEmptyEnv;
  bool enabled;
  if (act.kind == kTimeout) {
    if constexpr (H::kTimers > 0) {
      const bool armed = ((v[H::kTimerOff] >> act.index) & 1u) != 0;
      enabled = h.on_timeout(v, act.index, outs) && armed;
    } else {
      enabled = false;  // no such action: f < fanout() never reaches it
    }
  } else {
    const uint32_t env = n.at(act.index);
    enabled = env != kEmptyEnv;
    if (act.kind == kDeliver) {
      enabled = h.on_deliver(v, env, outs) && enabled;
      if (!h.duplicating) n.remove_at(act.index);
    } else {
      n.remove_at(act.index);
    }
  }
  const bool overflow = n.insert(outs, h.e);
  n.template store<H::kNetOff>(v, h.e, overflow);
  return enabled;
}

}  // namespace sr
