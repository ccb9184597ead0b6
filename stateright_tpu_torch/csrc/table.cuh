// The visited-table device code shared by the dedup kernel (table.cu) and
// the wave kernel (wave.cuh): the hash of a slot, the first-occurrence
// claim in the scratch table, the probe/claim walk in the visited table,
// and the candidate pass built from them.
//
// Slot and step functions equal the reference's (stateright_tpu/tpu/
// engine.py): the HIGH bits of fp * 0x9E3779B97F4A7C15 pick the home
// slot of a power-of-two table, and fp * 0xC2B2AE3D27D4EB4F gives the
// odd double-hashing step. See table.cu for what bounds these walks and
// why the result does not depend on which atomicCAS wins.

#pragma once

#include <cstdint>

#include "hashing.cuh"

namespace sr {

constexpr u64 kTableMix = 0x9E3779B97F4A7C15ull;
constexpr u64 kStepMix = 0xC2B2AE3D27D4EB4Full;

__device__ __forceinline__ void slot_hash(u64 fp, int bits, u64* home,
                                          u64* step) {
  const int shift = 64 - bits;
  *home = (fp * kTableMix) >> shift;
  *step = ((fp * kStepMix) >> shift) | 1ull;
}

// Finds or claims fp's slot in the scratch table (2^m_bits >= 2n slots,
// so a free slot always exists) and lowers the slot's row to i. Returns
// the slot. After a grid-wide boundary, row i is the earliest row of its
// fingerprint iff rows[slot] == i.
__device__ __forceinline__ int scratch_claim(u64 fp, int i, u64* keys,
                                             int* rows, int m_bits) {
  const u64 mask = (1ull << m_bits) - 1;
  u64 h, step;
  slot_hash(fp, m_bits, &h, &step);
  for (u64 t = 0; t <= mask; ++t) {
    const u64 old = atomicCAS(&keys[h], kSentinel, fp);
    if (old == kSentinel || old == fp) {
      atomicMin(&rows[h], i);
      return (int)h;
    }
    h = (h + step) & mask;
  }
  return (int)h;  // not reached: the table has more slots than rows
}

// Walks the visited table (2^c_bits slots) from fp's home slot by double
// hashing. Its own key means seen; the sentinel means try to claim it
// with atomicCAS (a loser to the same key has seen it, a loser to another
// key walks on); any other key means walk on. Sets *is_new when this
// walk inserted fp. Returns false when a walk of every slot found neither
// fp nor a free slot: the table is full.
__device__ __forceinline__ bool probe_walk(u64 fp, u64* table, int c_bits,
                                           bool* is_new) {
  const u64 mask = (1ull << c_bits) - 1;
  u64 idx, step;
  slot_hash(fp, c_bits, &idx, &step);
  for (u64 t = 0; t <= mask; ++t) {
    const u64 cur = __ldcg(&table[idx]);
    if (cur == fp) return true;
    if (cur == kSentinel) {
      const u64 old = atomicCAS(&table[idx], kSentinel, fp);
      if (old == kSentinel || old == fp) {
        *is_new = old == kSentinel;
        return true;
      }
    }
    idx = (idx + step) & mask;
  }
  return false;
}

namespace {

// The second pass of both kernels, after the scratch claims landed: row
// i is a candidate iff it holds its slot's least row, and each candidate
// walks the visited table. counts[0..2] gain the new rows, the
// candidates and the unresolved walks (a full table, which the engine
// raises on at the end of its dispatch), aggregated a warp at a time.
__global__ void probe_claim(const u64* __restrict__ fps, long long n,
                            const int* __restrict__ rows,
                            const int* __restrict__ slot_of, u64* table,
                            int c_bits, bool* __restrict__ new_mask,
                            bool* __restrict__ cand_mask, int* counts) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  bool cand = false, is_new = false, unresolved = false;
  if (i < n) {
    const u64 fp = fps[i];
    cand = fp != kSentinel && rows[slot_of[i]] == (int)i;
    if (cand) unresolved = !probe_walk(fp, table, c_bits, &is_new);
    new_mask[i] = is_new;
    cand_mask[i] = cand;
  }
  const unsigned n_new = __popc(__ballot_sync(0xffffffffu, is_new));
  const unsigned n_cand = __popc(__ballot_sync(0xffffffffu, cand));
  const unsigned n_bad = __popc(__ballot_sync(0xffffffffu, unresolved));
  if ((threadIdx.x & 31) == 0) {
    if (n_new) atomicAdd(&counts[0], (int)n_new);
    if (n_cand) atomicAdd(&counts[1], (int)n_cand);
    if (n_bad) atomicAdd(&counts[2], (int)n_bad);
  }
}

}  // namespace

}  // namespace sr
