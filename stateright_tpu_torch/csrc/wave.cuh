// The single-kernel wave: the whole successor path of one BFS wave, for
// any model that has device code (a template on the model).
//
// Replaces the Pallas kernel stateright_tpu/tpu/pallas_table.py
// ::build_wave_megakernel :380 (with _wave_front :353). From the packed
// batch vecs uint32[B, Wp] and valid bool[B] it computes, for each of the
// S = B * F successor slots (b, f): the packed successor succ_store[S, Wp],
// its path fingerprint path_fps[S], sflat[S] = valid[b] & enabled, and
// then the dedup of the wave against the visited table in place:
// cand_mask[S] (earliest slot of each dedup fingerprint), new_mask[S]
// (candidates this wave inserted) and the counts. Under symmetry the
// dedup fingerprint is the representative's; paths keep the original's.
// Every output equals the plain version (stateright_tpu_torch/wave.py
// ::wave_megakernel_plain) bit for bit; the table equals it as a set.
//
// Structure. Pass 1 (wave_front) gives one thread a slot at a time, in a
// grid-stride loop: it unpacks row b, applies action f in registers,
// fingerprints, re-packs and stores the successor, and claims the scratch
// slot of its dedup fingerprint (atomicCAS, then atomicMin of its index).
// The first occurrence needs every claim to land before any slot reads
// its winner: on the TPU the whole wave is one program instance, here it
// is the launch boundary. Pass 2 is table.cuh's probe_claim, the dedup
// kernel's own second pass, over the dedup fingerprints pass 1 wrote.
//
// What bounds it on an H100: bytes and the latency of the table walk.
// The function reads the packed batch and writes the packed successors,
// the path fingerprints and three byte masks, and touches about one
// 32-byte sector per candidate in the visited table. The TPU kernel's
// VMEM gate (wave_kernel_ok :330) has no counterpart: the table stays in
// HBM, and the only limit is the int32 row index (S < 2^31). The dedup
// fingerprints and the scratch table are neither input nor output. At a
// full-width wave of 2pc at 10 RMs (B = 16,384 rows of a mid-run arena,
// S = 851,968, against 2^27 slots 30% full, 86,817 candidates) that bound
// is 19,112,992 B over 3.35 TB/s = 0.0057 ms; this kernel takes about
// 0.157 ms, some 28x the bound (chip_smoke.py; NVIDIA H100 80GB HBM3,
// power limit 700 W). This first version re-reads row b for each of its F
// slots (from L1), and keeps no row in shared memory.
//
// The sender kernel (launch_sender) replaces the Pallas kernel
// build_sender_megakernel :451, the front half of the wave kernel with no
// table that the sharded engine runs a shard at a time. Its input is the
// shards' batches stacked, vecs uint32[n, B, Wp] and valid bool[n, B]; for
// each shard's S slots it writes succ_store, dedup_fps, path_fps, sflat
// and send_mask: the earliest slot of each dedup fingerprint within its
// own shard when local_dedup (the exchange_novel_only contract), else
// sflat. Pass 1 is the same wave_front, over all n * S slots in one
// launch, each shard claiming in its own scratch region (one shared over
// all shards would drop a later shard's copy of a state an earlier shard
// also produced); pass 2 (sender_mask) reads the regions. It has no table,
// no probe and no counts. Its outputs equal the plain version
// (stateright_tpu_torch/wave.py::sender_megakernel_plain) bit for bit.
// Its bound is bytes: the packed batch and valid read, the packed
// successors, two fingerprint arrays and two byte masks written.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "hashing.cuh"
#include "packing.cuh"
#include "table.cuh"

namespace sr {

// Pointers and sizes of one wave, as the C entry point receives them.
struct WaveArgs {
  const int* lanes;  // host int32[3 * w]: each lane's word, offset, bits
  int w, wp;
  const uint32_t* vecs;  // [B, wp]
  const bool* valid;     // [B]
  long long batch;
  int fanout;
  u64* table;  // [2^c_bits], in place
  int c_bits;
  uint32_t* succ_store;  // [S, wp]
  u64* path_fps;         // [S]
  bool* sflat;           // [S]
  u64* dedup_fps;        // [S], scratch
  u64* keys;             // [2^m_bits], all sentinel
  int* rows;             // [2^m_bits], all INT32_MAX
  int* slot_of;          // [S], scratch
  int m_bits;
  bool* new_mask;  // [S]
  bool* cand_mask;
  int* counts;  // [3], zeroed: new, candidates, unresolved
  bool use_sym;
  cudaStream_t stream;
};

// Pointers and sizes of one sender wave over n stacked shards.
struct SenderArgs {
  const int* lanes;  // host int32[3 * w]
  int w, wp;
  const uint32_t* vecs;  // [shards, B, wp]
  const bool* valid;     // [shards, B]
  long long batch;       // B, rows a shard
  long long shards;
  int fanout;
  uint32_t* succ_store;  // [shards, S, wp], S = B * fanout
  u64* dedup_fps;        // [shards, S]
  u64* path_fps;         // [shards, S]
  bool* sflat;           // [shards, S]
  bool* send_mask;       // [shards, S]
  u64* keys;             // [shards, 2^m_bits], all sentinel
  int* rows;             // [shards, 2^m_bits], all INT32_MAX
  int* slot_of;          // [shards, S], scratch
  int m_bits;
  bool use_sym, local_dedup;
  cudaStream_t stream;
};

namespace {

constexpr int kWaveThreads = 256;

// The first scratch slot of slot i's region. One region (the wave
// kernel's) needs no division, and slots fit 32 bits (the wrappers check
// it), where a division costs a third of a 64-bit one.
__device__ __forceinline__ long long region_base(long long i, long long S,
                                                 long long region_slots,
                                                 int m_bits) {
  if (region_slots >= S) return 0;
  return (long long)((unsigned)i / (unsigned)region_slots) << m_bits;
}

// Pass 1 of both kernels. Slot i's dedup fingerprint claims its slot in
// scratch region i / region_slots (2^m_bits slots a region), so the first
// occurrence is taken within each region: the wave kernel has one region,
// the sender kernel one a shard. With keys null nothing is claimed.
template <class M>
__global__ void wave_front(M m, Layout<M::kMaxW, M::kMaxWords> L,
                           const uint32_t* __restrict__ vecs,
                           const bool* __restrict__ valid, long long S,
                           int F, bool use_sym,
                           uint32_t* __restrict__ succ_store,
                           u64* __restrict__ path_fps,
                           bool* __restrict__ sflat,
                           u64* __restrict__ dedup_fps, u64* keys, int* rows,
                           int* __restrict__ slot_of, int m_bits,
                           long long region_slots) {
  constexpr int kMaxW = M::kMaxW, kMaxWords = M::kMaxWords;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < S; i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / F;
    const int f = (int)(i - b * F);
    uint32_t p[kMaxWords];
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k)
      p[k] = k < L.wp ? vecs[b * L.wp + k] : 0u;
    uint32_t v[kMaxW];
    unpack(L, p, v);
    const bool sf = m.step(v, f) && valid[b];
    const u64 pfp = fp64(v, L.w);
    pack(L, v, p);
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k)
      if (k < L.wp) succ_store[i * L.wp + k] = p[k];
    path_fps[i] = pfp;
    sflat[i] = sf;
    u64 dfp = kSentinel;
    if (sf) {
      dfp = pfp;
      if (use_sym) {
        m.representative(v);
        dfp = fp64(v, L.w);
      }
      if (keys != nullptr) {
        const long long base = region_base(i, S, region_slots, m_bits);
        slot_of[i] = scratch_claim(dfp, (int)i, keys + base, rows + base,
                                   m_bits);
      }
    }
    dedup_fps[i] = dfp;
  }
}

// Pass 2 of the sender kernel: with local dedup, slot i is sent iff it
// holds the least row of its fingerprint's slot in its own region; without
// it, iff it is a valid successor.
__global__ void sender_mask(const u64* __restrict__ dedup_fps,
                            const bool* __restrict__ sflat, long long n,
                            long long region_slots,
                            const int* __restrict__ rows,
                            const int* __restrict__ slot_of, int m_bits,
                            bool local_dedup, bool* __restrict__ send_mask) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool send = sflat[i];
  if (local_dedup)
    send = dedup_fps[i] != kSentinel &&
           rows[region_base(i, n, region_slots, m_bits) + slot_of[i]] ==
               (int)i;
  send_mask[i] = send;
}

}  // namespace

template <class M>
bool make_layout(const M& m, const int* lanes, int w, int wp, int fanout,
                 Layout<M::kMaxW, M::kMaxWords>* L) {
  if (w != m.width() || w > M::kMaxW || wp > M::kMaxWords ||
      fanout != m.fanout())
    return false;
  L->w = w;
  L->wp = wp;
  for (int j = 0; j < w; ++j) {
    L->word[j] = (uint8_t)lanes[j];
    L->offset[j] = (uint8_t)lanes[w + j];
    L->bits[j] = (uint8_t)lanes[2 * w + j];
  }
  return true;
}

// Blocks of pass 1 for S slots: as many as the card holds at once, at
// most one a slot; the grid-stride loop covers the rest.
template <class M>
unsigned front_blocks(long long S) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wave_front<M>,
                                                kWaveThreads, 0);
  const long long want = (S + kWaveThreads - 1) / kWaveThreads;
  const long long most = (long long)(sms > 0 ? sms : 1) *
                         (per_sm > 0 ? per_sm : 1);
  return (unsigned)(want < most ? want : most);
}

// Launches both passes on a.stream for model m; does not synchronise.
// Returns cudaErrorInvalidValue when the layout or the fanout does not fit
// the model, else cudaGetLastError().
template <class M>
int launch_wave(const M& m, const WaveArgs& a) {
  Layout<M::kMaxW, M::kMaxWords> L;
  if (!make_layout(m, a.lanes, a.w, a.wp, a.fanout, &L))
    return (int)cudaErrorInvalidValue;
  const long long S = a.batch * a.fanout;
  if (S > 0) {
    const unsigned want = (unsigned)((S + kWaveThreads - 1) / kWaveThreads);
    wave_front<M><<<front_blocks<M>(S), kWaveThreads, 0, a.stream>>>(
        m, L, a.vecs, a.valid, S, a.fanout, a.use_sym, a.succ_store,
        a.path_fps, a.sflat, a.dedup_fps, a.keys, a.rows, a.slot_of,
        a.m_bits, S);
    probe_claim<<<want, kWaveThreads, 0, a.stream>>>(
        a.dedup_fps, S, a.rows, a.slot_of, a.table, a.c_bits, a.new_mask,
        a.cand_mask, a.counts);
  }
  return (int)cudaGetLastError();
}

// Launches the sender kernel, both passes, on a.stream for model m over
// all shards at once; does not synchronise. Same return codes as
// launch_wave.
template <class M>
int launch_sender(const M& m, const SenderArgs& a) {
  Layout<M::kMaxW, M::kMaxWords> L;
  if (!make_layout(m, a.lanes, a.w, a.wp, a.fanout, &L))
    return (int)cudaErrorInvalidValue;
  const long long region = a.batch * a.fanout;
  const long long S = a.shards * region;
  if (S > 0) {
    const unsigned want = (unsigned)((S + kWaveThreads - 1) / kWaveThreads);
    wave_front<M><<<front_blocks<M>(S), kWaveThreads, 0, a.stream>>>(
        m, L, a.vecs, a.valid, S, a.fanout, a.use_sym, a.succ_store,
        a.path_fps, a.sflat, a.dedup_fps,
        a.local_dedup ? a.keys : nullptr, a.rows, a.slot_of, a.m_bits,
        region);
    sender_mask<<<want, kWaveThreads, 0, a.stream>>>(
        a.dedup_fps, a.sflat, S, region, a.rows, a.slot_of, a.m_bits,
        a.local_dedup, a.send_mask);
  }
  return (int)cudaGetLastError();
}

}  // namespace sr
