// The paxos instances that wave_paxos.cu and sender_paxos.cu (1 to 3
// clients) and wave_paxos4.cu and sender_paxos4.cu (4 clients) build:
// models/paxos.cuh (3 servers, PaxosDevice's only count), each for any
// net_slots from 1 up to its default (5 * clients + 3).
#pragma once

#include <cuda_runtime.h>

#include "models/paxos.cuh"

namespace sr {

// Calls fn with the model instance for clients c and net_slots e, or
// returns cudaErrorInvalidValue when the instantiations do not hold them:
// the clients kLo to kHi (each source holds a range of them, so that the
// client counts build in parallel).
template <int kLo, int kHi, class Fn>
inline int with_paxos(int c, int e, Fn&& fn) {
  if constexpr (kLo <= kHi) {
    if (c == kLo) {
      if (e >= 1 && e <= Paxos<kLo>::kMaxE) return fn(Paxos<kLo>{e});
      return (int)cudaErrorInvalidValue;
    }
    return with_paxos<kLo + 1, kHi>(c, e, fn);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sr
