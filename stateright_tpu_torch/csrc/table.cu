// Visited-table dedup for one BFS wave: first occurrence within the wave,
// then insert-or-test against the open-addressing table, on Hopper.
//
// Replaces the Pallas kernel stateright_tpu/tpu/pallas_table.py
// ::dedup_and_insert_pallas (body _kernel with fuse_local=True, and
// _probe_claim). It computes the same function: new_mask, cand_mask and
// the counts are equal bit for bit to the plain version
// (stateright_tpu_torch/engine.py::dedup_and_insert), and the table equals
// it as a set. Only the slot layout depends on which atomicCAS wins, and
// the slot layout carries no meaning.
//
// What bounds it on an H100: memory latency and 32-byte sectors, not
// bandwidth or arithmetic. The function reads the S fingerprints (8 B
// each), writes two byte masks, and touches about one sector per candidate
// in the visited table, a dependent random access each. Its scratch table
// (16 B a slot, m >= 2S slots) is neither input nor output, so the bound
// leaves it out. The TPU kernel staged the table in VMEM and claimed in
// batched probe rounds (gather, claim-scatter, re-gather), because a TPU
// has no fine-grained atomics. Here the table stays in HBM
// and a claim is one 64-bit atomicCAS, so a row resolves in one walk.
//
// The design (table.cuh has the phases): phase 1 claims each row's
// scratch slot, and the slot's first claimer walks the visited table at
// once, so the walks' HBM latency overlaps the other rows' claims and
// only one walk is made for each distinct fingerprint; phase 2, after the
// launch boundary, reads each row's slot in the scratch, writes the
// masks and resets the slot. The scratch belongs to the caller, who hands
// it in clean and gets it back clean: no fill a call. Two launches and no
// memset a call, where the first version had two fills, a zeroing of the
// counts, a claim pass and a walk pass that re-read every fingerprint.
// The counts are summed a block at a time before one atomic each: one a
// warp, on three addresses, cost more than the walks. The barrier is the
// launch boundary: a cooperative launch with a grid sync in its place
// (co-resident blocks looping over the rows) measured within a few percent
// of it, either way, on the default path's shape (PERF.md), and the launch
// boundary needs no limit of co-resident blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --split-compile=0
//        -shared -Xcompiler -fPIC (stateright_tpu_torch/_build.py); the
// wrapper and the plain version are in stateright_tpu_torch/table.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "table.cuh"

namespace {

using sr::u64;

constexpr int kThreads = 256;

// Phase 1, one thread a row.
__global__ void claim_rows(const u64* __restrict__ fps, long long n,
                           sr::Scratch s, u64* table, int c_bits,
                           int* __restrict__ slot_of) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  int acc[3] = {0, 0, 0};
  if (i < n)
    slot_of[i] = sr::claim_row(fps[i], (int)i, s, table, c_bits, acc);
  sr::flush_tally(acc, s.tally);
}

}  // namespace

// fps int64[n] (uint64 bit patterns), table int64[2^c_bits] (updated in
// place); the caller's clean scratch, handed back clean: slots
// int64[2^m_bits, 2] (sr::Slot records), tally int32[3] and slot_of
// int32[n], with 2^m_bits >= 2n; outputs masks bool[n] and counts
// int32[3]: new, candidates, unresolved. Launches on `stream` and does not
// synchronise. Returns a CUDA error code, 0 on success.
extern "C" int sr_dedup_and_insert(const void* fps, long long n, void* table,
                                   int c_bits, void* slots, void* tally,
                                   void* slot_of, int m_bits, void* new_mask,
                                   void* cand_mask, void* counts,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaMemsetAsync(counts, 0, 3 * sizeof(int), st);
  const sr::Scratch s{static_cast<sr::Slot*>(slots), static_cast<int*>(tally),
                      m_bits};
  int* so = static_cast<int*>(slot_of);
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  claim_rows<<<blocks, kThreads, 0, st>>>(static_cast<const u64*>(fps), n, s,
                                          static_cast<u64*>(table), c_bits,
                                          so);
  sr::resolve_rows<<<blocks, kThreads, 0, st>>>(
      so, n, s, static_cast<bool*>(new_mask), static_cast<bool*>(cand_mask),
      static_cast<int*>(counts));
  return (int)cudaGetLastError();
}
