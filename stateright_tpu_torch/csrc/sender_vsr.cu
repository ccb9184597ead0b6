// The sender kernel (wave.cuh) for viewstamped replication
// (models/vsr.cuh on models/actor_net.cuh), behind a plain C interface:
// wave_twopc.cu's sr_sender_twopc, with the replica count, the form,
// max_view and net_slots for the model's params. A translation unit of its
// own beside wave_vsr.cu (the wave kernel), so that the two build in
// parallel; the same instances (sr::with_vsr).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --split-compile=0
//        -shared -Xcompiler -fPIC (stateright_tpu_torch/_build.py); the
// wrapper and the plain version are in stateright_tpu_torch/wave.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "models/vsr.cuh"
#include "wave.cuh"

// replicas: the replica count; lossy and duplicating: the form (0 or 1
// each); max_view the boundary; net_slots the network's slots;
// lanes host int32[5 * w] (each lane's packed word, bit offset, bits,
// sentinel flag and sentinel value); vecs int32[shards, batch, wp] and
// valid bool[shards, batch] (each shard's batch); outputs for S = batch *
// fanout slots a shard: succ_store int32[shards, S, wp], dedup_fps and
// path_fps int64[shards, S], sflat and send_mask bool[shards, S]; the
// caller's clean scratch, handed back clean and read only when
// local_dedup: slots int64[2^m_bits, 2] (sr::Slot records) with shards <<
// region_bits slots at least and 2^region_bits >= 2S, and slot_of
// int32[shards, S].
// `device` is the current device. Launches on `stream` and does not
// synchronise. Returns a CUDA error code, 0 on success.
extern "C" int sr_sender_vsr(
    int replicas, int lossy, int duplicating, int max_view,
    int net_slots, int use_sym, int local_dedup, const int* lanes, int w,
    int wp, const void* vecs, const void* valid, long long batch,
    long long shards, int fanout, void* succ_store, void* dedup_fps,
    void* path_fps, void* sflat, void* send_mask, void* slots,
    void* slot_of, int region_bits, int device, void* stream) {
  const sr::SenderArgs a = sr::sender_args(
      use_sym, local_dedup, lanes, w, wp, vecs, valid, batch, shards, fanout,
      succ_store, dedup_fps, path_fps, sflat, send_mask, slots, slot_of,
      region_bits, device, stream);
  return (int)sr::with_vsr(replicas, lossy, duplicating, max_view, net_slots,
      cudaErrorInvalidValue,
      [&](const auto& m) { return sr::launch_sender(m, a); });
}
