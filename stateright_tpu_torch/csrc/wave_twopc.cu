// The single-kernel wave and the sender kernel (wave.cuh) for two-phase
// commit, behind a plain C interface.
//
// Instantiates both kernels for models/twopc.cuh at register sizes of
// 4, 8, 12, 16 and 28 RMs (28 is the most the encoding holds) and picks
// the smallest that holds the run's RM count: every lane loop runs over the
// instantiation's lanes, so 10 RMs at 12 (15 lanes, not 19) cut the wave
// kernel's time by a sixth (PERF.md). See wave.cuh for what the kernels
// compute, what bounds them and how they are held to their plain versions.
//
// Their plan forms (sr_wave_twopc_plan, sr_sender_twopc_plan: plan.cuh's
// transition-table step under a matmul plan) at 4 and 8 RMs only: the gate
// admits 2pc up to 7 RMs (at 8 its probe budget is exceeded), and
// TwoPhaseDevice.CUDA_PLAN_INSTANCES lists the counts they hold.
//
// ptxas for sm_90a (-Xptxas -v, CUDA 12.8), tile_front under
// __launch_bounds__(256, 4):
//   TwoPhase<12>: wave 64 registers, sender 64, no spill in either;
//   TwoPhase<16>: wave 64 registers and 8 bytes of spill, sender 64 and
//   no spill.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --split-compile=0
//        -shared -Xcompiler -fPIC (stateright_tpu_torch/_build.py); the
// wrapper and the plain version are in stateright_tpu_torch/wave.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "models/twopc.cuh"
#include "plan.cuh"
#include "wave.cuh"

namespace {

// Calls fn with the plan form of 2pc at rm_count RMs, or returns
// cudaErrorInvalidValue when no instantiation holds it or the plan does
// not fit.
template <class Fn>
int with_twopc_plan(int rm_count, const int* plan, const void* tables,
                    Fn&& fn) {
  if (rm_count < 1) return (int)cudaErrorInvalidValue;
  if (rm_count <= 4)
    return sr::with_plan(sr::TwoPhase<4>{rm_count}, plan, tables, fn);
  if (rm_count <= 8)
    return sr::with_plan(sr::TwoPhase<8>{rm_count}, plan, tables, fn);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// rm_count RMs; lanes host int32[5 * w] (each lane's packed word, bit
// offset, bits, sentinel flag and sentinel value); vecs int32[batch, wp]
// (packed rows as uint32 bit patterns) and valid bool[batch]; table
// int64[2^c_bits] (uint64 bit patterns, updated in place); outputs for S =
// batch * fanout slots:
// succ_store int32[S, wp], path_fps int64[S], sflat, new_mask, cand_mask
// bool[S], counts int32[3]: new, candidates, unresolved; the caller's
// clean scratch, handed back clean: slots int64[2^m_bits, 2] (sr::Slot
// records), tally int32[3] and slot_of int32[S], with 2^m_bits >= 2S.
// `device` is the current device. Launches on `stream` and does not
// synchronise. Returns a CUDA error code, 0 on success.
extern "C" int sr_wave_twopc(int rm_count, int use_sym, const int* lanes,
                             int w, int wp, const void* vecs,
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
  if (rm_count < 1) return (int)cudaErrorInvalidValue;
  if (rm_count <= 4) return sr::launch_wave(sr::TwoPhase<4>{rm_count}, a);
  if (rm_count <= 8) return sr::launch_wave(sr::TwoPhase<8>{rm_count}, a);
  if (rm_count <= 12) return sr::launch_wave(sr::TwoPhase<12>{rm_count}, a);
  if (rm_count <= 16) return sr::launch_wave(sr::TwoPhase<16>{rm_count}, a);
  if (rm_count <= 28) return sr::launch_wave(sr::TwoPhase<28>{rm_count}, a);
  return (int)cudaErrorInvalidValue;
}

// rm_count RMs; lanes as above; vecs int32[shards, batch, wp] and valid
// bool[shards, batch] (each shard's batch); outputs for S = batch * fanout
// slots a shard: succ_store int32[shards, S, wp], dedup_fps and path_fps
// int64[shards, S], sflat and send_mask bool[shards, S]; the caller's
// clean scratch, handed back clean and read only when local_dedup: slots
// int64[2^m_bits, 2] (sr::Slot records) with shards << region_bits slots
// at least and 2^region_bits >= 2S, and slot_of int32[shards, S].
// `device` is the current device. Launches on `stream` and does not
// synchronise. Returns a CUDA error code, 0 on success.
extern "C" int sr_sender_twopc(int rm_count, int use_sym, int local_dedup,
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
  if (rm_count < 1) return (int)cudaErrorInvalidValue;
  if (rm_count <= 4) return sr::launch_sender(sr::TwoPhase<4>{rm_count}, a);
  if (rm_count <= 8) return sr::launch_sender(sr::TwoPhase<8>{rm_count}, a);
  if (rm_count <= 12)
    return sr::launch_sender(sr::TwoPhase<12>{rm_count}, a);
  if (rm_count <= 16)
    return sr::launch_sender(sr::TwoPhase<16>{rm_count}, a);
  if (rm_count <= 28)
    return sr::launch_sender(sr::TwoPhase<28>{rm_count}, a);
  return (int)cudaErrorInvalidValue;
}

// The plan forms: rm_count, then the host plan int32 (wave.py::plan_host)
// and the device tables (wave.py::plan_tables), then sr_wave_twopc's or
// sr_sender_twopc's arguments.
extern "C" int sr_wave_twopc_plan(
    int rm_count, const int* plan, const void* tables, int use_sym,
    const int* lanes, int w, int wp, const void* vecs, const void* valid,
    long long batch, int fanout, void* table, int c_bits, void* succ_store,
    void* path_fps, void* sflat, void* slots, void* tally, void* slot_of,
    int m_bits, void* new_mask, void* cand_mask, void* counts, int device,
    void* stream) {
  const sr::WaveArgs a = sr::wave_args(
      use_sym, lanes, w, wp, vecs, valid, batch, fanout, table, c_bits,
      succ_store, path_fps, sflat, slots, tally, slot_of, m_bits, new_mask,
      cand_mask, counts, device, stream);
  return with_twopc_plan(rm_count, plan, tables,
      [&](const auto& m) { return sr::launch_wave(m, a); });
}

extern "C" int sr_sender_twopc_plan(
    int rm_count, const int* plan, const void* tables, int use_sym,
    int local_dedup, const int* lanes, int w, int wp, const void* vecs,
    const void* valid, long long batch, long long shards, int fanout,
    void* succ_store, void* dedup_fps, void* path_fps, void* sflat,
    void* send_mask, void* slots, void* slot_of, int region_bits,
    int device, void* stream) {
  const sr::SenderArgs a = sr::sender_args(
      use_sym, local_dedup, lanes, w, wp, vecs, valid, batch, shards, fanout,
      succ_store, dedup_fps, path_fps, sflat, send_mask, slots, slot_of,
      region_bits, device, stream);
  return with_twopc_plan(rm_count, plan, tables,
      [&](const auto& m) { return sr::launch_sender(m, a); });
}
