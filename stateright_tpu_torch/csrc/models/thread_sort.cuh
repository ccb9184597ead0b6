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
// into a network of adjacent compare-exchanges over the pairs, each moving
// a pair only past a strictly larger key (which is what keeps it stable),
// on keys taken as uint32 (they wrap as JAX's do). The models hold their
// thread count at run time under a capacity (kMaxT): the sort runs over the
// first t pairs only, since a pad pair that took part, or was written at
// all, would change the row and so its fingerprint.

#pragma once

#include <cstdint>

namespace sr {

// Sorts the first t pairs (t <= kMaxT) of lanes [kFirst, kFirst + 2 * kMaxT)
// of v in place; the pairs past them take no part and are not written.
// The count is uniform over a launch, so its guard a branch.
template <int kMaxT, int kSpan, int kFirst, int kW>
__device__ __forceinline__ void sort_threads(uint32_t (&v)[kW], int t) {
  uint32_t key[kMaxT], tv[kMaxT], pc[kMaxT];
#pragma unroll
  for (int k = 0; k < kMaxT; ++k) {
    tv[k] = v[kFirst + 2 * k];
    pc[k] = v[kFirst + 2 * k + 1];
    key[k] = tv[k] * (uint32_t)kSpan + pc[k];
  }
#pragma unroll
  for (int a = 1; a < kMaxT; ++a) {
    if (a < t) {
#pragma unroll
      for (int b = a; b > 0; --b) {
        const bool swap = key[b - 1] > key[b];
        const uint32_t k0 = key[b - 1], t0 = tv[b - 1], p0 = pc[b - 1];
        key[b - 1] = swap ? key[b] : k0;
        tv[b - 1] = swap ? tv[b] : t0;
        pc[b - 1] = swap ? pc[b] : p0;
        key[b] = swap ? k0 : key[b];
        tv[b] = swap ? t0 : tv[b];
        pc[b] = swap ? p0 : pc[b];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxT; ++k) {
    if (k < t) {
      v[kFirst + 2 * k] = tv[k];
      v[kFirst + 2 * k + 1] = pc[k];
    }
  }
}

}  // namespace sr
