// The paxos instances that wave_paxos.cu and sender_paxos.cu build:
// models/paxos.cuh at 1 to 4 clients (3 servers, PaxosDevice's only
// count), each for any net_slots from 1 up to its default (5 * clients +
// 3).
#pragma once

#include <cuda_runtime.h>

#include "models/paxos.cuh"

namespace sr {

// Calls fn with the model instance for clients c and net_slots e, or
// returns cudaErrorInvalidValue when the instantiations do not hold them.
template <class Fn>
inline int with_paxos(int c, int e, Fn&& fn) {
  switch (c) {
    case 1:
      if (e >= 1 && e <= Paxos<1>::kMaxE) return fn(Paxos<1>{e});
      break;
    case 2:
      if (e >= 1 && e <= Paxos<2>::kMaxE) return fn(Paxos<2>{e});
      break;
    case 3:
      if (e >= 1 && e <= Paxos<3>::kMaxE) return fn(Paxos<3>{e});
      break;
    case 4:
      if (e >= 1 && e <= Paxos<4>::kMaxE) return fn(Paxos<4>{e});
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace sr
