// The single-kernel wave (wave.cuh) for viewstamped
// replication (models/vsr.cuh on models/actor_net.cuh), behind a plain C
// interface: wave_twopc.cu's, with the replica count, the form, max_view
// and net_slots for the model's params.
//
// Instantiates the wave kernel (the sender kernel is sender_vsr.cu's, a
// source of its own so that the two build in parallel) at 1 to 4 replicas
// (VsrDevice's CUDA_INSTANCES): at up to 16, 40 and 48 network slots at 2,
// 3 and 4 replicas (the default 8n at 2; at 3 and 4 the slots a max_view of
// 2 and 1 need, 3 replicas at max_view 2 overflowing 8n; a row of 82 lanes
// at 4), and at up to 64 at every count (98 lanes at 4), sr::with_vsr
// picking the smallest instance that holds a run. The network's form
// (lossy, duplicating) and max_view are runtime. Another count or more
// slots return cudaErrorInvalidValue, and VsrDevice.cuda_model() refuses
// them first. The tiles past 48 KiB (3 and 4 replicas; about 105 KB at 4
// and 64 slots) are in wave.cuh's dynamic shared memory. The rows are whole
// words, copied, not packed (wave.cuh's WholeWords). ptxas' report: PERF.md
// section 6. See wave.cuh for what the kernels compute, what bounds them
// and how they are held to their plain versions.
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
int with_model(int n, int lossy, int duplicating, int max_view, int e,
               Fn&& fn) {
  return (int)sr::with_vsr(n, lossy, duplicating, max_view, e,
                           cudaErrorInvalidValue, fn);
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
  return with_model(replicas, lossy, duplicating, max_view, net_slots,
      [&](const auto& m) { return sr::launch_wave(m, a); });
}
