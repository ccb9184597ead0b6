// The single-copy register as device code: the server policy of
// register_workload.cuh, whose RegisterWorkload gives the successor of one
// state under one delivery and the exact representative of its
// client-symmetry class.
//
// The device-code twin of the port's models/single_copy.py
// ::SingleCopyDevice.server_deliver and .sym_rewrite_servers, the port of
// stateright_tpu/tpu/models/single_copy.py :45-68, after the reference's
// examples/single-copy-register.rs:18-38.
//
// A server's one lane: the stored value's index (0 = NO_VALUE, else 1 +
// the writer's client index). No internal messages. At one server every
// client shares residue class 0, so the group is the whole symmetric group
// of the clients.
//
// SingleCopyServer<kC, kS, kMinS> holds kMinS to kS servers, the count at
// run time where kMinS < kS (register_workload.cuh); with_single_copy picks
// the instance for a (clients, servers) pair.

#pragma once

#include <cstdint>

#include "register_workload.cuh"

namespace sr {

template <int kC_, int kS_, int kMinS_ = kS_>
struct SingleCopyServer : RegisterEnv<kC_> {
  using B = RegisterEnv<kC_>;
  using typename B::Env;
  using B::env_of;
  using B::kC;
  using B::kEmpty;
  using B::kGet;
  using B::kGetOk;
  using B::kPut;
  using B::kPutOk;
  using B::sym_val;

  static constexpr int kS = kS_, kMinS = kMinS_;
  static constexpr bool kServersAtRunTime = kMinS < kS;
  static_assert(kMinS >= 1 && kMinS <= kS && kS + kC <= 8,
                "the actor field is 3 bits");
  static constexpr int kServerLanes = 1;
  static constexpr int kMaxOut = 1;
  __host__ __device__ static constexpr int server_lanes(int) { return 1; }
  __host__ __device__ static constexpr int max_out(int) { return 1; }
  static constexpr int kExtraBits = 0;
  static constexpr int kServerBits = bit_length(kC);  // the value, 0..C

  // SingleCopyActor.on_msg at server D: a Put stores its value and acks, a
  // Get replies with the cell.
  template <int W>
  static __device__ __forceinline__ bool server(uint32_t (&v)[W],
                                                const Env& m,
                                                uint32_t (&outs)[kMaxOut],
                                                int, int D) {
    const uint32_t value = v[D];
    const bool put = m.kind == kPut, get = m.kind == kGet;
    v[D] = put ? m.value : value;
    outs[0] = put   ? env_of(m.src, D, kPutOk, m.req, 0, 0)
              : get ? env_of(m.src, D, kGetOk, m.req, value, 0)
                    : kEmpty;
    return put || get;
  }

  // -- Client symmetry: the stored value is the only client-derived datum.
  static __device__ __forceinline__ uint32_t sym_server(int, uint32_t x,
                                                        uint32_t sg) {
    return sym_val(x, sg);
  }
  static __device__ __forceinline__ uint32_t sym_extra(uint32_t,
                                                       uint32_t extra,
                                                       uint32_t) {
    return extra;
  }
  static __device__ __forceinline__ uint32_t sym_internal_req(uint32_t,
                                                              uint32_t req,
                                                              uint32_t) {
    return req;
  }
};

template <int kC, int kS, int kMinS = kS>
using SingleCopy = RegisterWorkload<SingleCopyServer<kC, kS, kMinS>>;

// Calls fn with the instance that holds c clients, s servers and net_slots
// e (at most the default at s servers' capacity): every pair of 1 to 4
// clients and 1 to 7 servers, at most 8 actors (22 pairs; the envelope's
// actor field is 3 bits). The pairs that had exact instances before the
// servers came at run time keep them, the fastest form for their sizes:
// 2 / 1, 3 / 1, 4 / 1 (single-copy-register check 2 to 4; check 4's kernel
// rows later PRs compare) and 2 / 2. The other pairs run on an instance a
// client count, the servers at run time. `none` for another pair or more
// slots.
template <class Fn>
long long with_single_copy(int c, int s, int e, long long none, Fn&& fn) {
  if (s < 1 || c + s > 8) return none;
  switch (c) {
    case 1:
      return with_register<SingleCopy<1, 7, 1>>(e, s, none, fn);
    case 2:
      if (s == 1) return with_register<SingleCopy<2, 1>>(e, s, none, fn);
      if (s == 2) return with_register<SingleCopy<2, 2>>(e, s, none, fn);
      return with_register<SingleCopy<2, 6, 1>>(e, s, none, fn);
    case 3:
      if (s == 1) return with_register<SingleCopy<3, 1>>(e, s, none, fn);
      return with_register<SingleCopy<3, 5, 1>>(e, s, none, fn);
    case 4:
      if (s == 1) return with_register<SingleCopy<4, 1>>(e, s, none, fn);
      return with_register<SingleCopy<4, 4, 2>>(e, s, none, fn);
  }
  return none;
}

}  // namespace sr
