// The single-kernel wave and the sender kernel (wave.cuh) for ping-pong
// (models/pingpong.cuh on models/actor_net.cuh), behind a plain C
// interface: wave_twopc.cu's, with the form, max_nat and net_slots for the
// model's params.
//
// Instantiates both kernels once, at up to 26 network slots
// (PingPongDevice.CUDA_MAX_SLOTS; 31 lanes), with the history and the
// network's form (lossy, duplicating) as runtime flags: all eight forms.
// More slots return cudaErrorInvalidValue, and PingPongDevice.cuda_model()
// refuses them first. The rows are whole words, copied, not packed
// (wave.cuh's WholeWords). ptxas' report: PERF.md section 7. See wave.cuh for what the kernels compute, what
// bounds them and how they are held to their plain versions.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --split-compile=0
//        -shared -Xcompiler -fPIC (stateright_tpu_torch/_build.py); the
// wrapper and the plain version are in stateright_tpu_torch/wave.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "models/pingpong.cuh"
#include "wave.cuh"

namespace {

using Model = sr::PingPong<26>;

// Calls fn with the model instance of these params, or returns
// cudaErrorInvalidValue when the instantiation does not hold them.
template <class Fn>
int with_pingpong(int history, int lossy, int duplicating, int max_nat,
                  int e, Fn&& fn) {
  if (e < 1 || e > Model::kMaxE || max_nat < 0)
    return (int)cudaErrorInvalidValue;
  return fn(Model{e, history != 0, lossy != 0, duplicating != 0,
                  (uint32_t)max_nat});
}

}  // namespace

// history, lossy and duplicating: the form (0 or 1 each); max_nat the
// boundary; net_slots the network's slots;
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
extern "C" int sr_wave_pingpong(
    int history, int lossy, int duplicating, int max_nat,
    int net_slots, int use_sym, const int* lanes, int w, int wp,
    const void* vecs, const void* valid, long long batch, int fanout,
    void* table, int c_bits, void* succ_store, void* path_fps, void* sflat,
    void* slots, void* tally, void* slot_of, int m_bits, void* new_mask,
    void* cand_mask, void* counts, int device, void* stream) {
  const sr::WaveArgs a = sr::wave_args(
      use_sym, lanes, w, wp, vecs, valid, batch, fanout, table, c_bits,
      succ_store, path_fps, sflat, slots, tally, slot_of, m_bits, new_mask,
      cand_mask, counts, device, stream);
  return with_pingpong(history, lossy, duplicating, max_nat, net_slots,
      [&](const auto& m) { return sr::launch_wave(m, a); });
}

// history, lossy and duplicating: the form (0 or 1 each); max_nat the
// boundary; net_slots the network's slots;
// lanes as above; vecs int32[shards, batch, wp] and valid bool[shards,
// batch] (each shard's batch); outputs for S = batch * fanout slots a
// shard: succ_store int32[shards, S, wp], dedup_fps and path_fps
// int64[shards, S], sflat and send_mask bool[shards, S]; the caller's
// clean scratch, handed back clean and read only when local_dedup: slots
// int64[2^m_bits, 2] (sr::Slot records) with shards << region_bits slots
// at least and 2^region_bits >= 2S, and slot_of int32[shards, S].
// `device` is the current device. Launches on `stream` and does not
// synchronise. Returns a CUDA error code, 0 on success.
extern "C" int sr_sender_pingpong(
    int history, int lossy, int duplicating, int max_nat,
    int net_slots, int use_sym, int local_dedup, const int* lanes, int w,
    int wp, const void* vecs, const void* valid, long long batch,
    long long shards, int fanout, void* succ_store, void* dedup_fps,
    void* path_fps, void* sflat, void* send_mask, void* slots,
    void* slot_of, int region_bits, int device, void* stream) {
  const sr::SenderArgs a = sr::sender_args(
      use_sym, local_dedup, lanes, w, wp, vecs, valid, batch, shards, fanout,
      succ_store, dedup_fps, path_fps, sflat, send_mask, slots, slot_of,
      region_bits, device, stream);
  return with_pingpong(history, lossy, duplicating, max_nat, net_slots,
      [&](const auto& m) { return sr::launch_sender(m, a); });
}
