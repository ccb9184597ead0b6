// The append of a wave's new rows to the device arena, on Hopper.
//
// Replaces the appends of the reference's fused wave (stateright_tpu/tpu/
// fused.py:311-315, the four dynamic_update_slice at the arena's tail) and
// of its sharded wave (stateright_tpu/tpu/sharded_fused.py:322-329). JAX
// writes a full window of S rows (n * S sharded) at the tail on purpose:
// a window narrowed behind a cond breaks XLA's in-place aliasing of the
// donated arena. That does not bind torch, and the rows past the tail
// were never part of the meaning: every reader masks by the tail, and the
// next wave overwrites them. The port's plain version (append.py) writes
// every one of the window's rows too, those that are not new to the dump
// row past the arena's last; this kernel writes the new rows alone and no
// dump row. Arena rows [0, tail + new_count) are equal bit for bit either
// way.
//
// What bounds it on an H100: bytes. Each new row reads its compaction
// index and its source row (4 * wp + 8 + 8 + 4 bytes) and writes as many;
// the rows that are not new cost nothing. The count of new rows is known
// only on the device, so the launch has a fixed grid (the blocks the card
// holds at once, asked once and kept by the launcher) and each thread
// walks the new words and rows in strides of the grid: no host read, and
// a CUDA graph can hold the launch. Adjacent threads write adjacent arena
// words. append.cuh has the device code.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --split-compile=0
//        -shared -Xcompiler -fPIC (stateright_tpu_torch/_build.py); the
// wrapper and the plain version are in stateright_tpu_torch/append.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "append.cuh"

// shards stacked shards; sources for rows rows a shard: src_vecs
// int32[shards, rows, wp], src_fps int64[shards, rows], src_par
// int64[shards, rows / div] and src_ebits int32[shards, rows / div];
// comp int64[shards, rows], new_count and tail int64[shards]; the arena
// vecs int32[shards, arena_rows, wp], fps and par int64[shards,
// arena_rows] and ebits int32[shards, arena_rows], updated in place.
// `device` is the current device. Launches on `stream` and does not
// synchronise. Returns a CUDA error code, 0 on success.
extern "C" int sr_append_rows(int shards, long long rows, int div, int wp,
                              long long arena_rows, const void* src_vecs,
                              const void* src_fps, const void* src_par,
                              const void* src_ebits, const void* comp,
                              const void* new_count, const void* tail,
                              void* vecs, void* fps, void* par, void* ebits,
                              int device, void* stream) {
  if (shards < 1 || rows < 1 || div < 1 || rows % div || wp < 1 ||
      arena_rows < 1)
    return (int)cudaErrorInvalidValue;
  sr::AppendArgs a;
  a.shards = shards;
  a.rows = rows;
  a.div = div;
  a.wp = wp;
  a.arena_rows = arena_rows;
  a.src_vecs = static_cast<const uint32_t*>(src_vecs);
  a.src_fps = static_cast<const sr::u64*>(src_fps);
  a.src_par = static_cast<const sr::u64*>(src_par);
  a.src_ebits = static_cast<const uint32_t*>(src_ebits);
  a.comp = static_cast<const long long*>(comp);
  a.new_count = static_cast<const long long*>(new_count);
  a.tail = static_cast<const long long*>(tail);
  a.vecs = static_cast<uint32_t*>(vecs);
  a.fps = static_cast<sr::u64*>(fps);
  a.par = static_cast<sr::u64*>(par);
  a.ebits = static_cast<uint32_t*>(ebits);
  return sr::launch_append(a, device, static_cast<cudaStream_t>(stream));
}
