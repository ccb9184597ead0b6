// The single-kernel wave (wave.cuh) for the single-copy register, behind a
// plain C interface: the same interface as wave_paxos.cu, with
// (client_count, server_count, net_slots) for params. Its sender kernel is
// sender_single_copy.cu's, a source of its own so that the two build in
// parallel.
//
// Instantiates the kernel for models/single_copy.cuh at every pair of 1 to 4
// clients and 1 to 7 servers of at most 8 actors (22 pairs;
// SingleCopyDevice.CUDA_INSTANCES), each for any net_slots from 1 up to its
// default (5 * clients + 3), through sr::with_single_copy: exact instances at
// 2, 3 and 4 clients on one server (single-copy-register check 2 to 4) and at
// 2 on two, and one instance a client count with the servers at run time for
// the rest (SingleCopy<1, 7, 1>, <2, 6, 1>, <3, 5, 1>, <4, 4, 2>;
// register_workload.cuh's row at the capacity). Another configuration, or a
// larger net_slots, returns cudaErrorInvalidValue, and the wrapper refuses it
// first. The packed row's network lanes are sentinel lanes (packing.cuh). See
// wave.cuh for what the kernels compute, what bounds them and how they are
// held to their plain versions.
//
// ptxas for sm_90a (-Xptxas -v, CUDA 12.8), tile_front under
// __launch_bounds__(256, 2), wave / sender: SingleCopy<2, 1> 127 / 123
// registers, <3, 1> 117 / 121, <4, 1> 128 / 128, <2, 2> 128 / 128; no
// spill; the instances with the servers at run time: PERF.md section 6.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --split-compile=0
//        -shared -Xcompiler -fPIC (stateright_tpu_torch/_build.py); the
// wrapper and the plain version are in stateright_tpu_torch/wave.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "models/single_copy.cuh"
#include "wave.cuh"

// client_count clients, server_count servers and net_slots network
// slots; lanes host int32[5 * w] (each lane's packed word, bit offset,
// bits, sentinel flag and sentinel value); vecs int32[batch, wp] (packed
// rows as uint32 bit patterns) and valid bool[batch]; table
// int64[2^c_bits] (uint64 bit patterns, updated in place); outputs for S =
// batch * fanout slots: succ_store int32[S, wp], path_fps int64[S], sflat,
// new_mask, cand_mask bool[S], counts int32[3]: new, candidates,
// unresolved; the caller's clean scratch, handed back clean: slots
// int64[2^m_bits, 2] (sr::Slot records), tally int32[3] and slot_of
// int32[S], with 2^m_bits >= 2S. `device` is the current device. Launches
// on `stream` and does not synchronise. Returns a CUDA error code, 0 on
// success.
extern "C" int sr_wave_single_copy(
    int client_count, int server_count, int net_slots, int use_sym,
    const int* lanes, int w, int wp, const void* vecs, const void* valid,
    long long batch, int fanout, void* table, int c_bits, void* succ_store,
    void* path_fps, void* sflat, void* slots, void* tally, void* slot_of,
    int m_bits, void* new_mask, void* cand_mask, void* counts, int device,
    void* stream) {
  const sr::WaveArgs a = sr::wave_args(
      use_sym, lanes, w, wp, vecs, valid, batch, fanout, table, c_bits,
      succ_store, path_fps, sflat, slots, tally, slot_of, m_bits, new_mask,
      cand_mask, counts, device, stream);
  return (int)sr::with_single_copy(
      client_count, server_count, net_slots, cudaErrorInvalidValue,
      [&](const auto& m) { return sr::launch_wave(m, a); });
}
