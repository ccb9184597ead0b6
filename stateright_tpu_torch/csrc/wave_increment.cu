// The single-kernel wave and the sender kernel (wave.cuh) for the racy
// shared counter (models/increment.cuh), behind a plain C interface:
// wave_twopc.cu's, with the thread count for its model param.
//
// Instantiates both kernels at 2, 4, 8 and 16 threads (the counts
// chip_smoke.py runs; IncrementDevice.CUDA_INSTANCES lists them); another
// count returns cudaErrorInvalidValue, and IncrementDevice.cuda_model()
// refuses it first. See wave.cuh for what the kernels compute, what
// bounds them and how they are held to their plain versions. Their plan
// forms (sr_wave_increment_plan, sr_sender_increment_plan: plan.cuh's
// transition-table step under a matmul plan) at 2, 4 and 8 threads, the
// counts CUDA_PLAN_INSTANCES lists.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --split-compile=0
//        -shared -Xcompiler -fPIC (stateright_tpu_torch/_build.py); the
// wrapper and the plain version are in stateright_tpu_torch/wave.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "models/increment.cuh"
#include "plan.cuh"
#include "wave.cuh"

namespace {

// Calls fn with the model instance for `threads` threads, or returns
// cudaErrorInvalidValue when no instantiation holds it.
template <class Fn>
int with_increment(int threads, Fn&& fn) {
  if (threads == 2) return fn(sr::Increment<2>{});
  if (threads == 4) return fn(sr::Increment<4>{});
  if (threads == 8) return fn(sr::Increment<8>{});
  if (threads == 16) return fn(sr::Increment<16>{});
  return (int)cudaErrorInvalidValue;
}

// Likewise, the plan form at 2, 4 and 8 threads (the counts the gate
// admits among the instances above), or cudaErrorInvalidValue when the
// plan does not fit.
template <class Fn>
int with_increment_plan(int threads, const int* plan, const void* tables,
                      Fn&& fn) {
  if (threads == 2)
    return sr::with_plan(sr::Increment<2>{}, plan, tables, fn);
  if (threads == 4)
    return sr::with_plan(sr::Increment<4>{}, plan, tables, fn);
  if (threads == 8)
    return sr::with_plan(sr::Increment<8>{}, plan, tables, fn);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// threads: the thread count;
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
extern "C" int sr_wave_increment(
    int threads, int use_sym, const int* lanes, int w, int wp,
    const void* vecs, const void* valid, long long batch, int fanout,
    void* table, int c_bits, void* succ_store, void* path_fps, void* sflat,
    void* slots, void* tally, void* slot_of, int m_bits, void* new_mask,
    void* cand_mask, void* counts, int device, void* stream) {
  const sr::WaveArgs a = sr::wave_args(
      use_sym, lanes, w, wp, vecs, valid, batch, fanout, table, c_bits,
      succ_store, path_fps, sflat, slots, tally, slot_of, m_bits, new_mask,
      cand_mask, counts, device, stream);
  return with_increment(threads,
      [&](const auto& m) { return sr::launch_wave(m, a); });
}

// threads: the thread count;
// lanes as above; vecs int32[shards, batch, wp] and valid bool[shards,
// batch] (each shard's batch); outputs for S = batch * fanout slots a
// shard: succ_store int32[shards, S, wp], dedup_fps and path_fps
// int64[shards, S], sflat and send_mask bool[shards, S]; the caller's
// clean scratch, handed back clean and read only when local_dedup: slots
// int64[2^m_bits, 2] (sr::Slot records) with shards << region_bits slots
// at least and 2^region_bits >= 2S, and slot_of int32[shards, S].
// `device` is the current device. Launches on `stream` and does not
// synchronise. Returns a CUDA error code, 0 on success.
extern "C" int sr_sender_increment(
    int threads, int use_sym, int local_dedup, const int* lanes, int w,
    int wp, const void* vecs, const void* valid, long long batch,
    long long shards, int fanout, void* succ_store, void* dedup_fps,
    void* path_fps, void* sflat, void* send_mask, void* slots,
    void* slot_of, int region_bits, int device, void* stream) {
  const sr::SenderArgs a = sr::sender_args(
      use_sym, local_dedup, lanes, w, wp, vecs, valid, batch, shards, fanout,
      succ_store, dedup_fps, path_fps, sflat, send_mask, slots, slot_of,
      region_bits, device, stream);
  return with_increment(threads,
      [&](const auto& m) { return sr::launch_sender(m, a); });
}

// The plan forms: threads, then the host plan int32 (wave.py::plan_host)
// and the device tables (wave.py::plan_tables), then sr_wave_increment's or
// sr_sender_increment's arguments (plan.cuh's transition-table step in
// place of the model's).
extern "C" int sr_wave_increment_plan(
    int threads, const int* plan, const void* tables, int use_sym,
    const int* lanes, int w, int wp, const void* vecs, const void* valid,
    long long batch, int fanout, void* table, int c_bits, void* succ_store,
    void* path_fps, void* sflat, void* slots, void* tally, void* slot_of,
    int m_bits, void* new_mask, void* cand_mask, void* counts, int device,
    void* stream) {
  const sr::WaveArgs a = sr::wave_args(
      use_sym, lanes, w, wp, vecs, valid, batch, fanout, table, c_bits,
      succ_store, path_fps, sflat, slots, tally, slot_of, m_bits, new_mask,
      cand_mask, counts, device, stream);
  return with_increment_plan(threads, plan, tables,
      [&](const auto& m) { return sr::launch_wave(m, a); });
}

extern "C" int sr_sender_increment_plan(
    int threads, const int* plan, const void* tables, int use_sym,
    int local_dedup, const int* lanes, int w, int wp, const void* vecs,
    const void* valid, long long batch, long long shards, int fanout,
    void* succ_store, void* dedup_fps, void* path_fps, void* sflat,
    void* send_mask, void* slots, void* slot_of, int region_bits,
    int device, void* stream) {
  const sr::SenderArgs a = sr::sender_args(
      use_sym, local_dedup, lanes, w, wp, vecs, valid, batch, shards, fanout,
      succ_store, dedup_fps, path_fps, sflat, send_mask, slots, slot_of,
      region_bits, device, stream);
  return with_increment_plan(threads, plan, tables,
      [&](const auto& m) { return sr::launch_sender(m, a); });
}
