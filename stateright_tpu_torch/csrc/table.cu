// Visited-table dedup for one BFS wave: first occurrence within the wave,
// then insert-or-test against the open-addressing table, on Hopper.
//
// Replaces the Pallas kernel stateright_tpu/tpu/pallas_table.py
// ::dedup_and_insert_pallas (body _kernel with fuse_local=True, and
// _probe_claim). It computes the same function: new_mask, cand_mask and
// both counts are equal bit for bit to the plain version
// (stateright_tpu_torch/engine.py::dedup_and_insert), and the table equals
// it as a set. Only the slot layout depends on which atomicCAS wins, and
// the slot layout carries no meaning.
//
// What bounds it on an H100: memory latency and 32-byte sectors, not
// bandwidth or arithmetic. The function reads the S fingerprints (8 B
// each), writes two byte masks, and touches about one sector per candidate
// in the visited table, a dependent random access each. Its own scratch
// table (12 B a slot, m >= 2S slots) is neither input nor output and can
// stay in L2, so the bound leaves it out. The TPU kernel staged the table
// in VMEM and claimed in batched probe rounds (gather, claim-scatter,
// re-gather), because a TPU has no fine-grained atomics. Here the table
// stays in HBM and a claim is one 64-bit atomicCAS, so a row resolves in
// one walk with no extra rounds, and the table size is not bounded by
// on-chip memory. At a full-width 2pc wave (S = 851,968 against 2^27
// slots, 30% full, 665,165 candidates) that bound is 29,804,960 B over
// 3.35 TB/s = 0.0089 ms; this kernel takes about 0.16 ms, some 18x the
// bound (chip_smoke.py; NVIDIA H100 80GB HBM3, power limit 700 W).
//
// Local first occurrence: each valid row claims or finds its fingerprint's
// scratch slot with atomicCAS, then atomicMin's its row index into the
// slot. After the launch boundary, a row is a candidate iff the slot holds
// its own index: the earliest row by construction, never whichever thread
// arrived first.
//
// Pass 2 (a candidate walks the visited table) is sr::probe_claim of
// table.cuh, which the wave kernel (wave.cuh) runs as its second pass too.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (stateright_tpu_torch/_build.py); the wrapper and
// the plain version are in stateright_tpu_torch/table.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "table.cuh"

namespace {

using sr::u64;

constexpr int kThreads = 256;

// Pass 1: every valid row finds or claims its fingerprint's slot in the
// scratch table and lowers the slot's row to its own index.
__global__ void local_claim(const u64* __restrict__ fps, long long n,
                            u64* keys, int* rows, int* __restrict__ slot_of,
                            int m_bits) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u64 fp = fps[i];
  if (fp == sr::kSentinel) return;
  slot_of[i] = sr::scratch_claim(fp, (int)i, keys, rows, m_bits);
}

}  // namespace

// fps int64[n] (uint64 bit patterns), table int64[2^c_bits] (updated in
// place), scratch keys int64[2^m_bits] (all sentinel) and rows
// int32[2^m_bits] (all INT32_MAX), slot_of int32[n], masks bool[n], counts
// int32[3] (zeroed): new, candidates, unresolved. Launches on `stream`
// and does not synchronise. Returns cudaGetLastError().
extern "C" int sr_dedup_and_insert(const void* fps, long long n, void* table,
                                   int c_bits, void* keys, void* rows,
                                   void* slot_of, int m_bits, void* new_mask,
                                   void* cand_mask, void* counts,
                                   void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    local_claim<<<blocks, kThreads, 0, s>>>(
        static_cast<const u64*>(fps), n, static_cast<u64*>(keys),
        static_cast<int*>(rows), static_cast<int*>(slot_of), m_bits);
    sr::probe_claim<<<blocks, kThreads, 0, s>>>(
        static_cast<const u64*>(fps), n, static_cast<const int*>(rows),
        static_cast<const int*>(slot_of), static_cast<u64*>(table), c_bits,
        static_cast<bool*>(new_mask), static_cast<bool*>(cand_mask),
        static_cast<int*>(counts));
  }
  return (int)cudaGetLastError();
}
