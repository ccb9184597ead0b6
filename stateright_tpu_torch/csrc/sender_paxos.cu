// The sender kernel (wave.cuh) for single-decree paxos under the register
// workload, behind a plain C interface: the same interface as
// wave_twopc.cu's sr_sender_twopc, with (client_count, net_slots) for
// params. A translation unit of its own beside wave_paxos.cu (the wave
// kernel), so that the two build in parallel; the same instances
// (paxos_instances.cuh), the same registers (wave_paxos.cu's header).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --split-compile=0
//        -shared -Xcompiler -fPIC (stateright_tpu_torch/_build.py); the
// wrapper and the plain version are in stateright_tpu_torch/wave.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "paxos_instances.cuh"

// The client counts this translation unit holds: 1 to 3 here, 4 in
// sender_paxos4.cu, which includes this file.
#ifndef SR_PAXOS_LO
#define SR_PAXOS_LO 1
#define SR_PAXOS_HI 3
#endif
#include "wave.cuh"

// client_count clients and net_slots network slots; lanes host int32[5 *
// w] (each lane's packed word, bit offset, bits, sentinel flag and
// sentinel value); vecs int32[shards, batch, wp] and valid bool[shards,
// batch] (each shard's batch); outputs for S = batch * fanout slots a
// shard: succ_store int32[shards, S, wp], dedup_fps and path_fps
// int64[shards, S], sflat and send_mask bool[shards, S]; the caller's
// clean scratch, handed back clean and read only when local_dedup: slots
// int64[2^m_bits, 2] (sr::Slot records) with shards << region_bits slots
// at least and 2^region_bits >= 2S, and slot_of int32[shards, S].
// `device` is the current device. Launches on `stream` and does not
// synchronise. Returns a CUDA error code, 0 on success.
extern "C" int sr_sender_paxos(int client_count, int net_slots, int use_sym,
                               int local_dedup,
                               const int* lanes, int w, int wp,
                               const void* vecs, const void* valid,
                               long long batch, long long shards,
                               int fanout, void* succ_store,
                               void* dedup_fps, void* path_fps, void* sflat,
                               void* send_mask, void* slots,
                               void* slot_of, int region_bits, int device,
                               void* stream) {
  const sr::SenderArgs a = sr::sender_args(
      use_sym, local_dedup, lanes, w, wp, vecs, valid, batch, shards, fanout,
      succ_store, dedup_fps, path_fps, sflat, send_mask, slots, slot_of,
      region_bits, device, stream);
  return sr::with_paxos<SR_PAXOS_LO, SR_PAXOS_HI>(
      client_count, net_slots, [&](const auto& m) {
    return sr::launch_sender(m, a);
  });
}
