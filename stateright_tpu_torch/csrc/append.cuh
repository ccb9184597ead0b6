// The append of a wave's new rows to the device arena, for one shard or
// several stacked ones: the device code of append.cu.
//
// Shard k's wave compacted its new rows to the front of its successors
// (comp, the stable order of compaction_order); new row i of shard k goes
// to arena row tail_k + i:
//   vecs[k, tail_k + i]  = src_vecs[k, comp[k, i]]
//   fps[k, tail_k + i]   = src_fps[k, comp[k, i]]
//   par[k, tail_k + i]   = src_par[k, comp[k, i] / div]
//   ebits[k, tail_k + i] = src_ebits[k, comp[k, i] / div]
// for i < new_count_k, and nothing else is written. The fused engine has one
// shard and takes a row's parent fingerprint and eventually bits from its
// parent (div = the fanout); the sharded engine has them for each received
// row (div = 1).
//
// With a shim that defines the CUDA qualifiers away, everything outside
// the __CUDACC__ section compiles with a host compiler;
// tests/test_torch_device_code.py runs append_word and append_row for
// every new row so, against the plain version.

#pragma once

#include <cstdint>

#include "table.cuh"

namespace sr {

// One append over `shards` stacked shards. Source arrays hold `rows` rows
// a shard (and rows / div parents), the arena `arena_rows` rows a shard;
// vecs rows are wp words.
struct AppendArgs {
  int shards;
  long long rows;
  int div;
  int wp;
  long long arena_rows;
  const uint32_t* src_vecs;
  const u64* src_fps;
  const u64* src_par;
  const uint32_t* src_ebits;
  const long long* comp;
  const long long* new_count;
  const long long* tail;
  uint32_t* vecs;
  u64* fps;
  u64* par;
  uint32_t* ebits;
};

// Shard k's count of rows to append: new_count_k, or 0 where the rows would
// not fit the source or the arena (the dump row, arena_rows - 1, included).
// The engines' device predicate keeps a wave's rows inside the arena, so
// the guard only keeps a faulty caller from writing out of bounds.
__device__ __forceinline__ long long append_count(const AppendArgs& a,
                                                  int k) {
  const long long nc = a.new_count[k], tail = a.tail[k];
  const bool fits = nc >= 0 && nc <= a.rows && tail >= 0 &&
                    tail + nc <= a.arena_rows - 1;
  return fits ? nc : 0;
}

// Word w of new row i of shard k.
__device__ __forceinline__ void append_word(const AppendArgs& a, int k,
                                            long long i, int w) {
  const long long src = a.comp[k * a.rows + i];
  a.vecs[(k * a.arena_rows + a.tail[k] + i) * a.wp + w] =
      a.src_vecs[(k * a.rows + src) * a.wp + w];
}

// The fingerprint, parent and eventually bits of new row i of shard k.
__device__ __forceinline__ void append_row(const AppendArgs& a, int k,
                                           long long i) {
  const long long src = a.comp[k * a.rows + i];
  const long long parent = k * (a.rows / a.div) + src / a.div;
  const long long dst = k * a.arena_rows + a.tail[k] + i;
  a.fps[dst] = a.src_fps[k * a.rows + src];
  a.par[dst] = a.src_par[parent];
  a.ebits[dst] = a.src_ebits[parent];
}

#ifdef __CUDACC__

namespace {

constexpr int kAppendThreads = 256;

// A grid-stride loop over each shard's new words, then its new rows: a
// grid fixed at launch (the counts are read here, from device memory), so
// a graph can hold the launch, and work that follows the new rows.
// Adjacent threads write adjacent words of the arena.
__global__ void append_rows(const AppendArgs a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (int k = 0; k < a.shards; ++k) {
    const long long nc = append_count(a, k);
    for (long long j = t0; j < nc * a.wp; j += stride)
      append_word(a, k, j / a.wp, (int)(j % a.wp));
    for (long long i = t0; i < nc; i += stride) append_row(a, k, i);
  }
}

}  // namespace

// Launches the append on `stream` on at most the blocks the device holds
// at once (asked once a device), and no more than the words could use.
inline int launch_append(const AppendArgs& a, int device,
                         cudaStream_t stream) {
  static std::atomic<unsigned> cache[kMaxDevices];
  const unsigned most = resident_blocks(cache, (const void*)append_rows,
                                        kAppendThreads, device);
  if (most == 0) return (int)cudaErrorInvalidDevice;
  const long long words = (long long)a.shards * a.rows * a.wp;
  const long long need = (words + kAppendThreads - 1) / kAppendThreads;
  const unsigned blocks = need < (long long)most ? (unsigned)need : most;
  append_rows<<<blocks, kAppendThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace sr
