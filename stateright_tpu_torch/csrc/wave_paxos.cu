// The single-kernel wave (wave.cuh) for single-decree paxos under the
// register workload, behind a plain C interface: the same interface as
// wave_twopc.cu, with (client_count, net_slots) for params. Its sender
// kernel is sender_paxos.cu: the two entry points are two translation
// units so that their kernels build in parallel, and the fourth client
// count is a third and fourth (wave_paxos4.cu, sender_paxos4.cu): paxos's
// client counts, each unrolled, are the longest build of chip_smoke.py.
//
// Instantiates the kernel for models/paxos.cuh at 1 to 3 clients (3 servers,
// PaxosDevice's only count; 4 clients in wave_paxos4.cu), each for any
// net_slots from 1 up to its default (5 * clients + 3); a larger net_slots, or
// another client count, returns cudaErrorInvalidValue and the wrapper
// (wave.py, which picks the source by the client count: SPLIT_SOURCES) raises
// (paxos_instances.cuh). The packed row's network lanes are sentinel lanes
// (packing.cuh). See wave.cuh for what the kernels compute, what bounds them
// and how they are held to their plain versions.
//
// ptxas for sm_90a (-Xptxas -v, CUDA 12.8), tile_front under
// __launch_bounds__(256, 2), wave / sender: Paxos<1> 79 / 72 registers,
// Paxos<2> 93 / 91, Paxos<3> 127 / 127, no spill, a stack frame of 240,
// 296 and 304 bytes (part of a row in local memory); Paxos<4> 128 / 128,
// a 384-byte frame and 28 / 8 bytes of spill stores (the representative's
// permutation walk of register_workload.cuh). A tile (wave.cuh's
// WaveTile, in dynamic shared memory) of 15,600 / 17,616 bytes at 1 client
// to 33,328 / 35,344 at 4.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --split-compile=0
//        -shared -Xcompiler -fPIC (stateright_tpu_torch/_build.py); the
// wrapper and the plain version are in stateright_tpu_torch/wave.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "paxos_instances.cuh"

// The client counts this translation unit holds: 1 to 3 here, 4 in
// wave_paxos4.cu, which includes this file.
#ifndef SR_PAXOS_LO
#define SR_PAXOS_LO 1
#define SR_PAXOS_HI 3
#endif
#include "wave.cuh"

// client_count clients and net_slots network slots; lanes host int32[5 *
// w] (each lane's packed word, bit offset, bits, sentinel flag and
// sentinel value); vecs int32[batch, wp] (packed rows as uint32 bit
// patterns) and valid bool[batch]; table int64[2^c_bits] (uint64 bit
// patterns, updated in place); outputs for S = batch * fanout slots:
// succ_store int32[S, wp], path_fps int64[S], sflat, new_mask, cand_mask
// bool[S], counts int32[3]: new, candidates, unresolved; the caller's
// clean scratch, handed back clean: slots int64[2^m_bits, 2] (sr::Slot
// records), tally int32[3] and slot_of int32[S], with 2^m_bits >= 2S.
// `device` is the current device. Launches on `stream` and does not
// synchronise. Returns a CUDA error code, 0 on success.
extern "C" int sr_wave_paxos(int client_count, int net_slots, int use_sym,
                             const int* lanes, int w, int wp,
                             const void* vecs,
                             const void* valid, long long batch, int fanout,
                             void* table, int c_bits, void* succ_store,
                             void* path_fps, void* sflat, void* slots,
                             void* tally, void* slot_of, int m_bits,
                             void* new_mask, void* cand_mask, void* counts,
                             int device, void* stream) {
  const sr::WaveArgs a = sr::wave_args(
      use_sym, lanes, w, wp, vecs, valid, batch, fanout, table, c_bits,
      succ_store, path_fps, sflat, slots, tally, slot_of, m_bits, new_mask,
      cand_mask, counts, device, stream);
  return sr::with_paxos<SR_PAXOS_LO, SR_PAXOS_HI>(
      client_count, net_slots, [&](const auto& m) {
    return sr::launch_wave(m, a);
  });
}
