// The threads' (t, pc) pairs of the shared-counter models in a stable
// order of their key t * kSpan + pc: the representative of increment.cuh
// and increment_lock.cuh.
//
// The device-code twin of stateright_tpu_torch/models/increment.py
// ::sort_threads (JAX's argsort of the uint32 key,
// stateright_tpu/tpu/models/increment.py:92-97). On the rows a run reaches
// the pc is below kSpan, so equal keys are equal pairs and the sort is the
// exact canonical form; a stable sort keeps any row, garbage included,
// equal to the torch version's. The sort is an insertion sort unrolled
// into a network of adjacent compare-exchanges over kT pairs, each moving
// a pair only past a strictly larger key (which is what keeps it stable),
// on keys taken as uint32 (they wrap as JAX's do).

#pragma once

#include <cstdint>

namespace sr {

// Sorts the kT pairs of lanes [kFirst, kFirst + 2 * kT) of v in place.
template <int kT, int kSpan, int kFirst, int kW>
__device__ __forceinline__ void sort_threads(uint32_t (&v)[kW]) {
  uint32_t key[kT], t[kT], pc[kT];
#pragma unroll
  for (int k = 0; k < kT; ++k) {
    t[k] = v[kFirst + 2 * k];
    pc[k] = v[kFirst + 2 * k + 1];
    key[k] = t[k] * (uint32_t)kSpan + pc[k];
  }
#pragma unroll
  for (int a = 1; a < kT; ++a) {
#pragma unroll
    for (int b = a; b > 0; --b) {
      const bool swap = key[b - 1] > key[b];
      const uint32_t k0 = key[b - 1], t0 = t[b - 1], p0 = pc[b - 1];
      key[b - 1] = swap ? key[b] : k0;
      t[b - 1] = swap ? t[b] : t0;
      pc[b - 1] = swap ? pc[b] : p0;
      key[b] = swap ? k0 : key[b];
      t[b] = swap ? t0 : t[b];
      pc[b] = swap ? p0 : pc[b];
    }
  }
#pragma unroll
  for (int k = 0; k < kT; ++k) {
    v[kFirst + 2 * k] = t[k];
    v[kFirst + 2 * k + 1] = pc[k];
  }
}

}  // namespace sr
