// The single-kernel wave and the sender kernel (wave.cuh) for the
// single-copy register, behind a plain C interface: the same interface as
// wave_paxos.cu, with (client_count, server_count, net_slots) for params.
//
// Instantiates both kernels for models/single_copy.cuh at 2, 3 and 4
// clients on one server and at 2 clients on two (the configurations
// chip_smoke.py checks), each for any net_slots from 1 up to its default
// (5 * clients + 3); another configuration, or a larger net_slots,
// returns cudaErrorInvalidValue and the wrapper raises. The packed row's
// network lanes are sentinel lanes (packing.cuh). See wave.cuh for what
// the kernels compute, what bounds them and how they are held to their
// plain versions.
//
// ptxas for sm_90a (-Xptxas -v, CUDA 12.8), tile_front under
// __launch_bounds__(256, 2), wave / sender: SingleCopy<2, 1> 127 / 123
// registers, <3, 1> 117 / 121, <4, 1> 128 / 128, <2, 2> 128 / 128; no
// spill in any, a stack frame of 176 to 224 bytes; a tile (wave.cuh's
// WaveTile, in dynamic shared memory) of 12,496 to 21,872 bytes. The build
// takes about 22 s on the H100's machine.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --split-compile=0
//        -shared -Xcompiler -fPIC (stateright_tpu_torch/_build.py); the
// wrapper and the plain version are in stateright_tpu_torch/wave.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "models/single_copy.cuh"
#include "wave.cuh"

namespace {

// Calls fn with the model instance for c clients, s servers and net_slots
// e, or returns cudaErrorInvalidValue when the instantiations do not hold
// them.
template <int kC, int kS, class Fn>
int with_instance(int e, Fn&& fn) {
  using M = sr::SingleCopy<kC, kS>;
  if (e >= 1 && e <= M::kMaxE) return fn(M{e});
  return (int)cudaErrorInvalidValue;
}

template <class Fn>
int with_single_copy(int c, int s, int e, Fn&& fn) {
  if (s == 1 && c == 2) return with_instance<2, 1>(e, fn);
  if (s == 1 && c == 3) return with_instance<3, 1>(e, fn);
  if (s == 1 && c == 4) return with_instance<4, 1>(e, fn);
  if (s == 2 && c == 2) return with_instance<2, 2>(e, fn);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

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
  return with_single_copy(client_count, server_count, net_slots,
      [&](const auto& m) { return sr::launch_wave(m, a); });
}

// client_count clients, server_count servers and net_slots network
// slots; lanes as above; vecs int32[shards, batch, wp] and valid
// bool[shards, batch] (each shard's batch); outputs for S = batch * fanout
// slots a shard: succ_store int32[shards, S, wp], dedup_fps and path_fps
// int64[shards, S], sflat and send_mask bool[shards, S]; the caller's
// clean scratch, handed back clean and read only when local_dedup: slots
// int64[2^m_bits, 2] (sr::Slot records) with shards << region_bits slots
// at least and 2^region_bits >= 2S, and slot_of int32[shards, S].
// `device` is the current device. Launches on `stream` and does not
// synchronise. Returns a CUDA error code, 0 on success.
extern "C" int sr_sender_single_copy(
    int client_count, int server_count, int net_slots, int use_sym,
    int local_dedup, const int* lanes, int w, int wp, const void* vecs,
    const void* valid, long long batch, long long shards, int fanout,
    void* succ_store, void* dedup_fps, void* path_fps, void* sflat,
    void* send_mask, void* slots, void* slot_of, int region_bits,
    int device, void* stream) {
  const sr::SenderArgs a = sr::sender_args(
      use_sym, local_dedup, lanes, w, wp, vecs, valid, batch, shards, fanout,
      succ_store, dedup_fps, path_fps, sflat, send_mask, slots, slot_of,
      region_bits, device, stream);
  return with_single_copy(client_count, server_count, net_slots,
      [&](const auto& m) { return sr::launch_sender(m, a); });
}
