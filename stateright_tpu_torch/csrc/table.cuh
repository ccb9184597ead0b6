// The visited-table device code shared by the dedup kernel (table.cu) and
// the wave kernel (wave.cuh): the hash of a slot, the walk of the visited
// table, and the two phases of a wave's dedup built from them. The sender
// kernel (wave.cuh) takes the claim and the take of a slot alone
// (claim_slot, take_slot), in a region of the scratch a shard, with no
// walk.
//
// Slot and step functions equal the reference's (stateright_tpu/tpu/
// engine.py): the HIGH bits of fp * 0x9E3779B97F4A7C15 pick the home
// slot of a power-of-two table, and fp * 0xC2B2AE3D27D4EB4F gives the
// odd double-hashing step.
//
// The two phases, for each row i of a wave with fingerprint fp:
// 1. claim_row: find or claim fp's slot in the scratch table with
//    atomicCAS and lower the slot's row to i with atomicMin. The one row
//    whose atomicCAS found the slot empty (there is exactly one for each
//    distinct fingerprint) walks the visited table for fp at once and
//    keeps the outcome in the slot's walk field. Which row walks does not
//    matter: the outcome belongs to the fingerprint, and the visited set
//    does not depend on who inserts.
// 2. resolve: after a grid-wide barrier (every claim has landed), row i
//    is a candidate iff the slot's row is i, the earliest row by
//    construction and never the first to arrive; it is new iff its slot's
//    walk inserted. The candidate then resets the slot (key, row and walk
//    in one 16-byte record), so the scratch is clean again when the phase
//    ends. A later reader of the same slot in this phase is not its
//    candidate, and reads either the least row or kRowNone: neither is its
//    own index.
// Phase 2 touches only the scratch and the two masks; it reads neither the
// fingerprints nor the visited table.
//
// With a shim that defines the CUDA qualifiers away and gives sequential
// atomics, everything outside the __CUDACC__ section compiles with a host
// compiler; tests/test_torch_device_code.py runs the phases so, a row at a
// time in several orders, against the plain versions.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#include <atomic>

#include <cuda_runtime.h>
#endif

#include "hashing.cuh"

namespace sr {

constexpr u64 kTableMix = 0x9E3779B97F4A7C15ull;
constexpr u64 kStepMix = 0xC2B2AE3D27D4EB4Full;
constexpr int kRowNone = 0x7fffffff;

// A scratch slot's walk: clean, or what its fingerprint's walk of the
// visited table did: inserted it, found it there, or found neither it nor
// a free slot in the whole table (the table is full).
constexpr int kWalkNone = 0, kWalkInserted = 1, kWalkFound = 2,
              kWalkFull = 3;

// One slot of the scratch table, 16 bytes, so a claim, its walk's outcome
// and the reset all touch one 32-byte sector. Clean: the sentinel key,
// row kRowNone, walk kWalkNone.
struct alignas(16) Slot {
  u64 key;
  int row;
  int walk;
};

// The caller's scratch: 2^m_bits slots (at least twice the rows, so a
// free slot always exists) and the three counters of the kernel's tally.
// Clean means every slot clean and the tally 0; the kernels take it clean
// and leave it so.
struct Scratch {
  Slot* slots;
  int* tally;  // [3]: new, candidates, unresolved
  int m_bits;
};

__device__ __forceinline__ void slot_hash(u64 fp, int bits, u64* home,
                                          u64* step) {
  const int shift = 64 - bits;
  *home = (fp * kTableMix) >> shift;
  *step = ((fp * kStepMix) >> shift) | 1ull;
}

// Walks the visited table (2^c_bits slots) from fp's home slot by double
// hashing. Its own key means seen; the sentinel means try to claim it
// with atomicCAS (a loser to the same key has seen it, a loser to another
// key walks on); any other key means walk on. A walk of every slot that
// found neither fp nor a free slot means the table is full.
__device__ __forceinline__ int probe_walk(u64 fp, u64* table, int c_bits) {
  const u64 mask = (1ull << c_bits) - 1;
  u64 idx, step;
  slot_hash(fp, c_bits, &idx, &step);
  for (u64 t = 0; t <= mask; ++t) {
    const u64 cur = __ldcg(&table[idx]);
    if (cur == fp) return kWalkFound;
    if (cur == kSentinel) {
      const u64 old = atomicCAS(&table[idx], kSentinel, fp);
      if (old == kSentinel) return kWalkInserted;
      if (old == fp) return kWalkFound;
    }
    idx = (idx + step) & mask;
  }
  return kWalkFull;
}

// Finds or claims fp's slot among the 2^bits slots from `slots`
// (atomicCAS on its key; there are more slots than rows, so a free one
// always exists) and lowers the slot's row to i (atomicMin). Returns the
// slot; *fresh tells whether this call found it empty, which exactly one
// call does for each distinct fingerprint.
__device__ __forceinline__ int claim_slot(u64 fp, int i, Slot* slots,
                                          int bits, bool* fresh) {
  const u64 mask = (1ull << bits) - 1;
  u64 h, step;
  slot_hash(fp, bits, &h, &step);
  for (u64 t = 0; t <= mask; ++t) {
    const u64 old = atomicCAS(&slots[h].key, kSentinel, fp);
    if (old == kSentinel || old == fp) {
      atomicMin(&slots[h].row, i);
      *fresh = old == kSentinel;
      return (int)h;
    }
    h = (h + step) & mask;
  }
  *fresh = false;
  return -1;  // not reached: the scratch has more slots than rows
}

// Phase 1 of row i with fingerprint fp: claim_slot in the whole scratch;
// returns the slot, -1 for the sentinel, which has none. If this call
// claimed the slot empty, it walks the visited table, keeps the outcome in
// the slot's walk field and adds it to acc (new, candidates, unresolved).
__device__ __forceinline__ int claim_row(u64 fp, int i, const Scratch& s,
                                         u64* table, int c_bits,
                                         int (&acc)[3]) {
  if (fp == kSentinel) return -1;
  bool fresh;
  const int h = claim_slot(fp, i, s.slots, s.m_bits, &fresh);
  if (fresh) {
    const int walk = probe_walk(fp, table, c_bits);
    s.slots[h].walk = walk;
    acc[0] += walk == kWalkInserted;
    acc[1] += 1;
    acc[2] += walk == kWalkFull;
  }
  return h;
}

// Adds a block's tallies to the scratch's: a warp's sum into shared
// memory, then one atomic a counter a block. Atomics on one address
// serialise in L2, and one a warp (26,624 warps at S = 851,968) cost more
// than the table walks. Every thread of the block calls it.
__device__ __forceinline__ void flush_tally(const int (&acc)[3],
                                            int* tally) {
  __shared__ int block_sum[3];
  if (threadIdx.x == 0)
    for (int k = 0; k < 3; ++k) block_sum[k] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int v = __reduce_add_sync(0xffffffffu, acc[k]);
    if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(&block_sum[k], v);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < 3; ++k)
      if (block_sum[k] != 0) atomicAdd(&tally[k], block_sum[k]);
}

// Phase 2 of row i, whose phase 1 returned slot: whether row i holds the
// slot (see the note above). The holder reads the slot's walk into *walk
// and resets the slot.
__device__ __forceinline__ bool take_slot(int slot, int i, Slot* slots,
                                          int* walk) {
  if (slot < 0 || __ldcg(&slots[slot].row) != i) return false;
  *walk = __ldcg(&slots[slot].walk);
  slots[slot] = Slot{kSentinel, kRowNone, kWalkNone};
  return true;
}

// Phase 2 of the dedup: row i is a candidate iff it holds its slot, and
// new iff that slot's walk inserted.
__device__ __forceinline__ void resolve(int slot, int i, const Scratch& s,
                                        bool* new_mask, bool* cand_mask) {
  int walk = kWalkNone;
  cand_mask[i] = take_slot(slot, i, s.slots, &walk);
  new_mask[i] = walk == kWalkInserted;
}

// Moves the tally into the caller's counts and clears it: once, in phase
// 2, when no row adds to it any more.
__device__ __forceinline__ void take_tally(int* tally, int* counts) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    counts[k] = __ldcg(&tally[k]);
    tally[k] = 0;
  }
}

#ifdef __CUDACC__

constexpr int kMaxDevices = 64;

// Blocks of `kernel` at `threads` a block that `device` holds at once: the
// runtime is asked once for each kernel and device (a cache of the
// launcher's own), then the answer is reused. 0 for a device index out of
// range.
inline unsigned resident_blocks(std::atomic<unsigned> (&cache)[kMaxDevices],
                                const void* kernel, int threads,
                                int device, size_t dyn_smem = 0) {
  if (device < 0 || device >= kMaxDevices) return 0;
  unsigned most = cache[device].load(std::memory_order_relaxed);
  if (most == 0) {
    int sms = 0, per_sm = 0;
    // A block of more dynamic shared memory than the default 48 KiB opts
    // in, once a kernel and (current) device, before its first launch.
    if (dyn_smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dyn_smem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  dyn_smem);
    most = (unsigned)((sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1));
    cache[device].store(most, std::memory_order_relaxed);
  }
  return most;
}

namespace {

// Phase 2 as its own launch: one thread a row.
__global__ void resolve_rows(const int* __restrict__ slot_of, long long n,
                             Scratch s, bool* __restrict__ new_mask,
                             bool* __restrict__ cand_mask, int* counts) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i == 0) take_tally(s.tally, counts);
  if (i < n) resolve(slot_of[i], (int)i, s, new_mask, cand_mask);
}

}  // namespace

#endif  // __CUDACC__

}  // namespace sr
