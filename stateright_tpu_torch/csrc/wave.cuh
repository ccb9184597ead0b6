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
// What bounds it on an H100: the per-slot integer work (unpack, step,
// two murmur3 fingerprints and the re-pack, lanes resolved by selects in
// registers) and the latency of the scratch claims and the table walk. Its
// bytes are the packed batch read, the packed successors, path
// fingerprints and three byte masks written, and about one 32-byte sector
// per candidate in the visited table. The TPU kernel's VMEM gate
// (wave_kernel_ok :330) has no counterpart: the table stays in HBM, and
// the only limit is the int32 row index (S < 2^31). At a full-width wave
// of 2pc at 10 RMs (B = 16,384 rows of a mid-run arena, S = 851,968,
// against 2^27 slots 30% full, 86,817 candidates) that bound is
// 19,112,992 B over 3.35 TB/s = 0.0057 ms (chip_smoke.py; PERF.md has
// the kernel's times).
//
// The design, for this card. Phase 1 (wave_claim) walks the slots a tile
// of kWaveThreads at a time, one thread a slot, over a grid of the blocks
// the card holds at once. A tile's parent rows (at most
// kWaveThreads / F + 2) are unpacked once into shared memory; each thread
// splits its slot into row and action with 32-bit arithmetic, applies the
// step to its parent's lanes, fingerprints and re-packs, and stages its
// outputs in shared memory, which the block then writes out with
// coalesced 16-byte stores (the successors, path fingerprints and sflat of
// a tile are contiguous). Then each valid slot claims its dedup
// fingerprint's scratch slot, and the first claimer walks the visited
// table (table.cuh): the walks overlap the other slots' claims. The
// dedup fingerprints never reach HBM. Phase 2 (table.cuh's resolve_rows,
// after the launch boundary) writes the masks from the scratch and leaves
// it clean. The caller owns the scratch: no fill a call. Measured choices
// (PERF.md): the launch boundary as the barrier, since a cooperative
// launch with a grid sync ran phase 2 on the front's small grid and was
// slower; 16-byte stores from the staging, level with TMA bulk stores
// (cp.async.bulk) at the 12-RM instantiation that 10 RMs use; and
// __launch_bounds__(256, 4), 64 registers for four blocks an SM (no spill
// at 12 RMs, 24 bytes at 16), faster than three at 80 registers.
//
// The sender kernel (launch_sender) replaces the Pallas kernel
// build_sender_megakernel :451, the front half of the wave kernel with no
// table that the sharded engine runs a shard at a time. Its input is the
// shards' batches stacked, vecs uint32[n, B, Wp] and valid bool[n, B]; for
// each shard's S slots it writes succ_store, dedup_fps, path_fps, sflat
// and send_mask: the earliest slot of each dedup fingerprint within its
// own shard when local_dedup (the exchange_novel_only contract), else
// sflat. Pass 1 (wave_front) runs over all n * S slots in one launch, a
// slot a thread in a grid-stride loop, each shard claiming in its own
// scratch region (one shared over all shards would drop a later shard's
// copy of a state an earlier shard also produced); pass 2 (sender_mask)
// reads the regions. It has no table, no probe and no counts. Its outputs
// equal the plain version (stateright_tpu_torch/wave.py
// ::sender_megakernel_plain) bit for bit. Its bound is bytes: the packed
// batch and valid read, the packed successors, two fingerprint arrays and
// two byte masks written.

#pragma once

#include <cstdint>

#include "hashing.cuh"
#include "packing.cuh"
#include "table.cuh"

namespace sr {

constexpr int kWaveThreads = 256;

// Successor f of the unpacked row v (clobbered) of a row that is valid or
// not: returns sflat (enabled, of a valid row); q gets the successor's
// packed words, *pfp its path fingerprint and *dfp its dedup fingerprint,
// the representative's under symmetry and the sentinel when not sflat.
template <class M>
__device__ __forceinline__ bool expand_slot(
    const M& m, const Layout<M::kMaxW, M::kMaxWords>& L,
    uint32_t (&v)[M::kMaxW], int f, bool row_valid, bool use_sym,
    uint32_t (&q)[M::kMaxWords], u64* pfp, u64* dfp) {
  const bool sf = m.step(v, f) && row_valid;
  *pfp = fp64(v, L.w);
  pack(L, v, q);
  *dfp = kSentinel;
  if (sf) {
    *dfp = *pfp;
    if (use_sym) {
      m.representative(v);
      *dfp = fp64(v, L.w);
    }
  }
  return sf;
}

// The layout of lanes (host int32[3 * w]: each lane's word, offset and
// bits) for model m; false when the widths or the fanout do not fit it.
template <class M>
bool make_layout(const M& m, const int* lanes, int w, int wp, int fanout,
                 Layout<M::kMaxW, M::kMaxWords>* L) {
  if (w != m.width() || w > M::kMaxW || wp > M::kMaxWords ||
      fanout != m.fanout() || fanout < M::kMinFanout)
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

#ifdef __CUDACC__

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
  Scratch scratch;       // the caller's, clean
  int* slot_of;          // [S], scratch
  bool* new_mask;        // [S]
  bool* cand_mask;
  int* counts;  // [3]: new, candidates, unresolved
  bool use_sym;
  int device;
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
  int device;
  cudaStream_t stream;
};

// The wave kernel's parameters, one struct so one pointer passes them.
template <class M>
struct WaveParams {
  M m;
  Layout<M::kMaxW, M::kMaxWords> L;
  const uint32_t* vecs;
  const bool* valid;
  unsigned S;  // slots, < 2^31
  unsigned F;
  bool use_sym;
  uint32_t* succ_store;
  u64* path_fps;
  bool* sflat;
  u64* table;
  int c_bits;
  Scratch scratch;
  int* slot_of;
  bool* new_mask;
  bool* cand_mask;
  int* counts;
};

// One block's shared memory in phase 1: the tile's parent rows unpacked
// (a tile of kWaveThreads slots spans at most kWaveThreads / F + 2 rows,
// F >= M::kMinFanout), and its outputs staged for the full-line stores.
template <class M>
struct WaveTile {
  static constexpr int kRows = kWaveThreads / M::kMinFanout + 2;
  uint32_t lanes[kRows][M::kMaxW];
  bool valid[kRows];
  alignas(16) uint32_t succ[kWaveThreads * M::kMaxWords];
  alignas(16) u64 pfp[kWaveThreads];
  alignas(16) bool sflat[kWaveThreads];
};

namespace {

// Copies n bytes of a staged tile from shared memory to global memory
// (both ends 16-byte aligned): 16 bytes a thread a step, the ragged end a
// byte at a time.
__device__ __forceinline__ void copy_out(void* dst, const void* src,
                                         unsigned n) {
  const unsigned n16 = n / 16;
  for (unsigned c = threadIdx.x; c < n16; c += blockDim.x)
    static_cast<uint4*>(dst)[c] = static_cast<const uint4*>(src)[c];
  for (unsigned c = n16 * 16 + threadIdx.x; c < n; c += blockDim.x)
    static_cast<char*>(dst)[c] = static_cast<const char*>(src)[c];
}

// Phase 1 of the wave kernel (see the note at the top), for a block.
template <class M>
__device__ __forceinline__ void wave_tiles(const WaveParams<M>& a,
                                           WaveTile<M>& tile) {
  constexpr int kMaxW = M::kMaxW, kMaxWords = M::kMaxWords;
  const unsigned tid = threadIdx.x, F = a.F, wp = a.L.wp;
  int acc[3] = {0, 0, 0};
  for (unsigned t0 = blockIdx.x * kWaveThreads; t0 < a.S;
       t0 += gridDim.x * kWaveThreads) {
    const unsigned n = min((unsigned)kWaveThreads, a.S - t0);
    const unsigned b0 = t0 / F;
    const unsigned rows = (t0 + n - 1) / F - b0 + 1;
    __syncthreads();  // the last tile's stores have read the staging
    if (tid < rows) {
      uint32_t p[kMaxWords];
#pragma unroll
      for (int k = 0; k < kMaxWords; ++k)
        p[k] = k < (int)wp ? a.vecs[(b0 + tid) * wp + k] : 0u;
      uint32_t v[kMaxW];
      unpack(a.L, p, v);
#pragma unroll
      for (int j = 0; j < kMaxW; ++j) tile.lanes[tid][j] = v[j];
      tile.valid[tid] = a.valid[b0 + tid];
    }
    __syncthreads();
    u64 dfp = kSentinel;
    if (tid < n) {
      const unsigned i = t0 + tid;
      const unsigned r = i / F - b0;
      const int f = (int)(i - (b0 + r) * F);
      uint32_t v[kMaxW];
#pragma unroll
      for (int j = 0; j < kMaxW; ++j) v[j] = tile.lanes[r][j];
      uint32_t q[kMaxWords];
      u64 pfp;
      tile.sflat[tid] = expand_slot(a.m, a.L, v, f, tile.valid[r],
                                    a.use_sym, q, &pfp, &dfp);
#pragma unroll
      for (int k = 0; k < kMaxWords; ++k)
        if (k < (int)wp) tile.succ[tid * wp + k] = q[k];
      tile.pfp[tid] = pfp;
    }
    __syncthreads();
    copy_out(a.succ_store + (size_t)t0 * wp, tile.succ, n * wp * 4);
    copy_out(a.path_fps + t0, tile.pfp, n * 8);
    copy_out(a.sflat + t0, tile.sflat, n);
    if (tid < n)
      a.slot_of[t0 + tid] =
          claim_row(dfp, (int)(t0 + tid), a.scratch, a.table, a.c_bits, acc);
  }
  flush_tally(acc, a.scratch.tally);
}

// Phase 1 as its own launch; phase 2 is table.cuh's resolve_rows.
template <class M>
__global__ void __launch_bounds__(kWaveThreads, M::kMaxW > 20 ? 2 : 4)
    wave_claim(const WaveParams<M> a) {
  __shared__ WaveTile<M> tile;
  wave_tiles(a, tile);
}

// The first scratch slot of slot i's region (the sender kernel's; slots
// fit 32 bits, the wrappers check it).
__device__ __forceinline__ long long region_base(long long i, long long S,
                                                 long long region_slots,
                                                 int m_bits) {
  if (region_slots >= S) return 0;
  return (long long)((unsigned)i / (unsigned)region_slots) << m_bits;
}

// Pass 1 of the sender kernel. Slot i's dedup fingerprint claims its slot
// in scratch region i / region_slots (2^m_bits slots a region), so the
// first occurrence is taken within each shard. With keys null nothing is
// claimed.
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

// Launches both phases on a.stream for model m; does not synchronise.
// Returns cudaErrorInvalidValue when the layout or the fanout does not fit
// the model, else the launches' CUDA error code.
template <class M>
int launch_wave(const M& m, const WaveArgs& a) {
  WaveParams<M> p;
  if (!make_layout(m, a.lanes, a.w, a.wp, a.fanout, &p.L))
    return (int)cudaErrorInvalidValue;
  const long long S = a.batch * a.fanout;
  if (S <= 0)
    return (int)cudaMemsetAsync(a.counts, 0, 3 * sizeof(int), a.stream);
  p.m = m;
  p.vecs = a.vecs;
  p.valid = a.valid;
  p.S = (unsigned)S;
  p.F = (unsigned)a.fanout;
  p.use_sym = a.use_sym;
  p.succ_store = a.succ_store;
  p.path_fps = a.path_fps;
  p.sflat = a.sflat;
  p.table = a.table;
  p.c_bits = a.c_bits;
  p.scratch = a.scratch;
  p.slot_of = a.slot_of;
  p.new_mask = a.new_mask;
  p.cand_mask = a.cand_mask;
  p.counts = a.counts;
  static std::atomic<unsigned> cache[kMaxDevices];
  const unsigned most = resident_blocks(cache, (const void*)wave_claim<M>,
                                        kWaveThreads, a.device);
  if (most == 0) return (int)cudaErrorInvalidDevice;
  const long long tiles = (S + kWaveThreads - 1) / kWaveThreads;
  const unsigned grid = (unsigned)(tiles < most ? tiles : most);
  wave_claim<M><<<grid, kWaveThreads, 0, a.stream>>>(p);
  resolve_rows<<<(unsigned)tiles, kWaveThreads, 0, a.stream>>>(
      a.slot_of, S, a.scratch, a.new_mask, a.cand_mask, a.counts);
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
    static std::atomic<unsigned> cache[kMaxDevices];
    const unsigned most = resident_blocks(cache, (const void*)wave_front<M>,
                                          kWaveThreads, a.device);
    if (most == 0) return (int)cudaErrorInvalidDevice;
    const long long want = (S + kWaveThreads - 1) / kWaveThreads;
    wave_front<M><<<(unsigned)(want < most ? want : most), kWaveThreads, 0,
                    a.stream>>>(
        m, L, a.vecs, a.valid, S, a.fanout, a.use_sym, a.succ_store,
        a.path_fps, a.sflat, a.dedup_fps, a.local_dedup ? a.keys : nullptr,
        a.rows, a.slot_of, a.m_bits, region);
    sender_mask<<<(unsigned)want, kWaveThreads, 0, a.stream>>>(
        a.dedup_fps, a.sflat, S, region, a.rows, a.slot_of, a.m_bits,
        a.local_dedup, a.send_mask);
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace sr
