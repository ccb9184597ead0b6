// The single-kernel wave (wave.cuh) for two-phase commit, behind a plain
// C interface.
//
// Instantiates the wave kernel for models/twopc.cuh at four register
// sizes, 4, 8, 16 and 28 RMs (28 is the most the encoding holds), and
// picks the smallest that holds the run's RM count. See wave.cuh for what
// the kernel computes, what bounds it and how it is held to its plain
// version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (stateright_tpu_torch/_build.py); the wrapper and
// the plain version are in stateright_tpu_torch/wave.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "models/twopc.cuh"
#include "wave.cuh"

// rm_count RMs; lanes host int32[3 * w] (each lane's packed word, bit
// offset and bits); vecs int32[batch, wp] (packed rows as uint32 bit
// patterns) and valid bool[batch]; table int64[2^c_bits] (uint64 bit
// patterns, updated in place); outputs for S = batch * fanout slots:
// succ_store int32[S, wp], path_fps int64[S], sflat, new_mask, cand_mask
// bool[S], counts int32[3] (zeroed): new, candidates, unresolved;
// scratch dedup_fps int64[S], slot_of int32[S], keys int64[2^m_bits] (all
// sentinel), rows int32[2^m_bits] (all INT32_MAX). Launches on `stream`
// and does not synchronise. Returns a CUDA error code, 0 on success.
extern "C" int sr_wave_twopc(int rm_count, int use_sym, const int* lanes,
                             int w, int wp, const void* vecs,
                             const void* valid, long long batch, int fanout,
                             void* table, int c_bits, void* succ_store,
                             void* path_fps, void* sflat, void* dedup_fps,
                             void* keys, void* rows, void* slot_of,
                             int m_bits, void* new_mask, void* cand_mask,
                             void* counts, void* stream) {
  sr::WaveArgs a;
  a.lanes = lanes;
  a.w = w;
  a.wp = wp;
  a.vecs = static_cast<const uint32_t*>(vecs);
  a.valid = static_cast<const bool*>(valid);
  a.batch = batch;
  a.fanout = fanout;
  a.table = static_cast<sr::u64*>(table);
  a.c_bits = c_bits;
  a.succ_store = static_cast<uint32_t*>(succ_store);
  a.path_fps = static_cast<sr::u64*>(path_fps);
  a.sflat = static_cast<bool*>(sflat);
  a.dedup_fps = static_cast<sr::u64*>(dedup_fps);
  a.keys = static_cast<sr::u64*>(keys);
  a.rows = static_cast<int*>(rows);
  a.slot_of = static_cast<int*>(slot_of);
  a.m_bits = m_bits;
  a.new_mask = static_cast<bool*>(new_mask);
  a.cand_mask = static_cast<bool*>(cand_mask);
  a.counts = static_cast<int*>(counts);
  a.use_sym = use_sym != 0;
  a.stream = static_cast<cudaStream_t>(stream);
  if (rm_count < 1) return (int)cudaErrorInvalidValue;
  if (rm_count <= 4) return sr::launch_wave(sr::TwoPhase<4>{rm_count}, a);
  if (rm_count <= 8) return sr::launch_wave(sr::TwoPhase<8>{rm_count}, a);
  if (rm_count <= 16) return sr::launch_wave(sr::TwoPhase<16>{rm_count}, a);
  if (rm_count <= 28) return sr::launch_wave(sr::TwoPhase<28>{rm_count}, a);
  return (int)cudaErrorInvalidValue;
}
