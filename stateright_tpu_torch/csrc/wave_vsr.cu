// The single-kernel wave and the sender kernel (wave.cuh) for viewstamped
// replication (models/vsr.cuh on models/actor_net.cuh), behind a plain C
// interface: wave_twopc.cu's, with the replica count, the form, max_view
// and net_slots for the model's params.
//
// Instantiates both kernels at 2, 3 and 4 replicas (VsrDevice's
// CUDA_INSTANCES), at up to 16, 40 and 48 network slots: the default 8n at
// 2, and at 3 and 4 the slots the card's configurations need (3 replicas
// at max_view 2 overflow 8n and take 40; 4 at max_view 1 take 48, a row of
// 82 lanes). The network's form (lossy, duplicating) and max_view are
// runtime. Another count or more slots return cudaErrorInvalidValue, and
// VsrDevice.cuda_model() refuses them first. The tiles at 3 and 4
// replicas (about 72 and 89 KB) pass the 48 KiB a block may declare
// statically, so wave.cuh's tiles are in dynamic shared memory. The rows are
// whole words, copied, not packed (wave.cuh's WholeWords). ptxas' report:
// PERF.md section 7. See wave.cuh for what the kernels compute, what
// bounds them and how they are held to their plain versions.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --split-compile=0
//        -shared -Xcompiler -fPIC (stateright_tpu_torch/_build.py); the
// wrapper and the plain version are in stateright_tpu_torch/wave.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "models/vsr.cuh"
#include "wave.cuh"

namespace {

// Calls fn with the model instance of these params, or returns
// cudaErrorInvalidValue when no instantiation holds them.
template <class Fn>
int with_vsr(int n, int lossy, int duplicating, int max_view, int e,
             Fn&& fn) {
  const bool l = lossy != 0, d = duplicating != 0;
  const uint32_t mv = (uint32_t)max_view;
  if (e < 1 || max_view < 0) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 2:
      if (e <= sr::Vsr<2, 16>::kMaxE) return fn(sr::Vsr<2, 16>{e, l, d, mv});
      break;
    case 3:
      if (e <= sr::Vsr<3, 40>::kMaxE) return fn(sr::Vsr<3, 40>{e, l, d, mv});
      break;
    case 4:
      if (e <= sr::Vsr<4, 48>::kMaxE) return fn(sr::Vsr<4, 48>{e, l, d, mv});
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// replicas: the replica count; lossy and duplicating: the form (0 or 1
// each); max_view the boundary; net_slots the network's slots;
// lanes host int32[5 * w] (each lane's packed word, bit offset, bits,
// sentinel flag and sentinel value); vecs int32[batch, wp] (packed rows as
// uint32 bit patterns) and valid bool[batch]; table int64[2^c_bits]
// (uint64 bit patterns, updated in place); outputs for S = batch * fanout
// slots: succ_store int32[S, wp], path_fps int64[S], sflat, new_mask,
// cand_mask bool[S], counts int32[3]: new, candidates, unresolved; the
// caller's clean scratch, handed back clean: slots int64[2^m_bits, 2]
// (sr::Slot records), tally int32[3] and slot_of int32[S], with 2^m_bits
// >= 2S. `device` is the current device. Launches on `stream` and does not
// synchronise. Returns a CUDA error code, 0 on success.
extern "C" int sr_wave_vsr(
    int replicas, int lossy, int duplicating, int max_view,
    int net_slots, int use_sym, const int* lanes, int w, int wp,
    const void* vecs, const void* valid, long long batch, int fanout,
    void* table, int c_bits, void* succ_store, void* path_fps, void* sflat,
    void* slots, void* tally, void* slot_of, int m_bits, void* new_mask,
    void* cand_mask, void* counts, int device, void* stream) {
  const sr::WaveArgs a = sr::wave_args(
      use_sym, lanes, w, wp, vecs, valid, batch, fanout, table, c_bits,
      succ_store, path_fps, sflat, slots, tally, slot_of, m_bits, new_mask,
      cand_mask, counts, device, stream);
  return with_vsr(replicas, lossy, duplicating, max_view, net_slots,
      [&](const auto& m) { return sr::launch_wave(m, a); });
}

// replicas: the replica count; lossy and duplicating: the form (0 or 1
// each); max_view the boundary; net_slots the network's slots;
// lanes as above; vecs int32[shards, batch, wp] and valid bool[shards,
// batch] (each shard's batch); outputs for S = batch * fanout slots a
// shard: succ_store int32[shards, S, wp], dedup_fps and path_fps
// int64[shards, S], sflat and send_mask bool[shards, S]; the caller's
// clean scratch, handed back clean and read only when local_dedup: slots
// int64[2^m_bits, 2] (sr::Slot records) with shards << region_bits slots
// at least and 2^region_bits >= 2S, and slot_of int32[shards, S].
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
  return with_vsr(replicas, lossy, duplicating, max_view, net_slots,
      [&](const auto& m) { return sr::launch_sender(m, a); });
}
