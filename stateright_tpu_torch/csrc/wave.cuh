// The single-kernel wave and the sender kernel: the whole successor path
// of one BFS wave, and its front half for the sharded engine, for any
// model that has device code (templates on the model), on one tile loop.
//
// The single-kernel wave (launch_wave) replaces the Pallas kernel
// stateright_tpu/tpu/pallas_table.py::build_wave_megakernel :380 (with
// _wave_front :353). From the packed batch vecs uint32[B, Wp] and valid
// bool[B] it computes, for each of the S = B * F successor slots (b, f):
// the packed successor succ_store[S, Wp], its path fingerprint
// path_fps[S], sflat[S] = valid[b] & enabled, and then the dedup of the
// wave against the visited table in place: cand_mask[S] (earliest slot of
// each dedup fingerprint), new_mask[S] (candidates this wave inserted) and
// the counts. Under symmetry the dedup fingerprint is the
// representative's; paths keep the original's. Every output equals the
// plain version (stateright_tpu_torch/wave.py::wave_megakernel_plain) bit
// for bit; the table equals it as a set.
//
// The sender kernel (launch_sender) replaces the Pallas kernel
// build_sender_megakernel :451: the front half of the wave with no table,
// which the sharded engine runs on every shard's batch at once. Its input
// is the shards' batches stacked, vecs uint32[n, B, Wp] and valid
// bool[n, B]; for each shard's S slots it writes succ_store, dedup_fps,
// path_fps, sflat and send_mask: the earliest slot of each dedup
// fingerprint within its own shard when local_dedup (the
// exchange_novel_only contract), else sflat. It has no table, no walk and
// no counts. Its outputs equal the plain version (wave.py
// ::sender_megakernel_plain) bit for bit.
//
// What bounds them on an H100: the per-slot integer work (unpack, step,
// two murmur3 fingerprints and the re-pack, lanes resolved by selects in
// registers) and the latency of the scratch claims (and of the wave
// kernel's table walks). Their bytes: the packed batch read, the packed
// successors, path fingerprints and byte masks written, and for the wave
// kernel about one 32-byte sector per candidate in the visited table, for
// the sender the dedup fingerprints. The TPU kernels' VMEM gate
// (wave_kernel_ok :330) has no counterpart: the table stays in HBM, and
// the only limit is the int32 row index (n * S < 2^31). chip_smoke.py
// computes each bound from its run's inputs (at the full-width shapes,
// 0.0057 ms for the wave kernel and 0.0067 ms for the sender, both by
// bytes); PERF.md has the kernels' times.
//
// The design, for this card. One tile loop (front_tiles, kernel
// tile_front) serves both, a template on what a slot does after its
// tile's stores (WaveTail, SenderTail). The grid, the blocks the card
// holds at once, walks (shard, tile) pairs, kWaveThreads slots a tile
// (fewer when the fanout is below the model's kMinFanout, so that a tile's
// rows fit the staging) and one thread a slot; a tile never straddles a
// shard (the wave kernel is one shard), so its shard is known once a tile
// and a shard's last tile may be ragged. A tile's parent rows (at most
// kWaveThreads / F + 2) are unpacked once into shared memory; each thread
// splits its slot into row and action with 32-bit arithmetic, applies the
// step to its parent's lanes, fingerprints and re-packs, and stages its
// outputs in shared memory, which the block then writes out with
// coalesced 16-byte stores (a tile's outputs are contiguous; element
// stores where a shard's start leaves a destination off 16 bytes). Then
// each slot's tail runs:
// - the wave kernel claims its dedup fingerprint's slot in the caller's
//   scratch, and the first claimer walks the visited table (table.cuh's
//   claim_row): the walks overlap the other slots' claims. The dedup
//   fingerprints never reach HBM. Its phase 2 (table.cuh's resolve_rows,
//   after the launch boundary) writes the masks from the scratch and
//   leaves it clean.
// - the sender, with local dedup, claims the same kind of 16-byte slot
//   (claim_slot: atomicCAS on the key, atomicMin of the row, one sector)
//   in its shard's region of the caller's scratch, 2^region_bits >= 2S
//   slots from slot shard << region_bits (one region shared over all
//   shards would drop a later shard's copy of a state an earlier shard
//   also produced), and walks nothing. Its pass 2 (send_rows, after the
//   launch boundary) sends slot i iff slot_of[i] names a slot whose row
//   is i, and that slot then resets it (take_slot), so the scratch goes
//   back clean to the owner-side inserts of the same wave. Pass 2 reads
//   neither the fingerprints nor sflat. Without local dedup nothing is
//   claimed, send_mask is written from pass 1's staging of sflat, and
//   pass 2 is not launched: one launch.
// The caller owns the scratch: no fill a call. Measured choices (PERF.md):
// the launch boundary as the barrier, since a cooperative launch with a
// grid sync ran phase 2 on the front's small grid and was slower (a
// development tree, PR 4, not kept); 16-byte stores from the staging,
// level with TMA bulk stores (cp.async.bulk) at the 12-RM instantiation
// that 10 RMs use (the same tree); and __launch_bounds__(256, 4), 64
// registers for four blocks an SM, faster than three at 80 registers; a
// model of more than 20 lanes (paxos: 37 to 64) takes two blocks an SM,
// up to 128 registers. ptxas (-Xptxas -v, sm_90a) for tile_front: see
// wave_twopc.cu and wave_paxos.cu.

#pragma once

#include <cstdint>
#include <type_traits>

#include "hashing.cuh"
#include "packing.cuh"
#include "table.cuh"

namespace sr {

constexpr int kWaveThreads = 256;

// Whether model M's lanes are all whole words (M::kWholeWords: a model
// with no lane_bits(), ping-pong's and VSR's): its layout must then be the
// identity, and its rows are copied, not packed. The codec's select over
// every word for each lane (unpack and pack, O(W x Wp)) would otherwise be
// most of a wide row's instructions and of its build.
template <class M, class = void>
struct WholeWords : std::false_type {};
template <class M>
struct WholeWords<M, std::void_t<decltype(M::kWholeWords)>>
    : std::bool_constant<M::kWholeWords> {};

// Whether model M's rows use the codec on words in memory
// (M::kIndexedCodec: packing.cuh's unpack_from and pack_into), O(W) code
// in place of the select's O(W x Wp): the register workloads' instances
// that take the server count at run time, whose rows of up to 111 lanes
// and 18 words otherwise made their kernels the build's longest.
template <class M, class = void>
struct IndexedCodec : std::false_type {};
template <class M>
struct IndexedCodec<M, std::void_t<decltype(M::kIndexedCodec)>>
    : std::bool_constant<M::kIndexedCodec> {};

// Successor f of the unpacked row v (clobbered) of a row that is valid or
// not: returns sflat (enabled, of a valid row); store(v) takes the
// successor's lanes (to pack them), *pfp gets its path fingerprint and
// *dfp its dedup fingerprint, the representative's under symmetry and the
// sentinel when not sflat.
template <class M, class Store>
__device__ __forceinline__ bool expand_slot(
    const M& m, const Layout<M::kMaxW, M::kMaxWords>& L,
    uint32_t (&v)[M::kMaxW], int f, bool row_valid, bool use_sym,
    Store&& store, u64* pfp, u64* dfp) {
  const bool sf = m.step(v, f) && row_valid;
  *pfp = fp64(v, L.w);
  store(v);
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

// The layout of lanes (host int32[5 * w]: each lane's word, offset, bits,
// sentinel flag and sentinel value, a uint32 bit pattern) for model m;
// false when the widths or the fanout do not fit it.
template <class M>
bool make_layout(const M& m, const int* lanes, int w, int wp, int fanout,
                 Layout<M::kMaxW, M::kMaxWords>* L) {
  if (w != m.width() || w > M::kMaxW || wp > M::kMaxWords ||
      fanout != m.fanout() || fanout < 1)
    return false;
  L->w = w;
  L->wp = wp;
  for (int j = 0; j < w; ++j) {
    L->word[j] = (uint8_t)lanes[j];
    L->offset[j] = (uint8_t)lanes[w + j];
    L->bits[j] = (uint8_t)lanes[2 * w + j];
    L->has_sentinel[j] = lanes[3 * w + j] != 0;
    L->sentinel[j] = (uint32_t)lanes[4 * w + j];
    if (WholeWords<M>::value &&
        (L->word[j] != j || L->offset[j] != 0 || L->bits[j] != 32 ||
         L->has_sentinel[j]))
      return false;
  }
  return !WholeWords<M>::value || wp == w;
}

// One block's shared memory in the tile loop: the tile's parent rows
// unpacked (a tile of T slots spans at most (T - 1) / F + 2 rows, so
// kRows rows hold a tile of kWaveThreads slots at F >= M::kMinFanout; a
// smaller fanout takes tiles of (kRows - 1) * F slots), and its outputs
// staged for the full-line stores; the dedup fingerprints too when
// kDedupOut (the sender's).
template <class M, bool kDedupOut>
struct WaveTile {
  static constexpr int kRows = kWaveThreads / M::kMinFanout + 2;
  uint32_t lanes[kRows][M::kMaxW];
  bool valid[kRows];
  alignas(16) uint32_t succ[kWaveThreads * M::kMaxWords];
  alignas(16) u64 pfp[kWaveThreads];
  alignas(16) u64 dfp[kDedupOut ? kWaveThreads : 1];
  alignas(16) bool sflat[kWaveThreads];
};

// Unpacks the packed row p (wp words) into row r of the tile.
template <class M, bool kDedupOut>
__device__ __forceinline__ void stage_row(
    const Layout<M::kMaxW, M::kMaxWords>& L, const uint32_t* p, bool valid,
    WaveTile<M, kDedupOut>& tile, unsigned r) {
  if constexpr (IndexedCodec<M>::value) {
    uint32_t v[M::kMaxW];
    unpack_from(L, p, v);
#pragma unroll
    for (int j = 0; j < M::kMaxW; ++j) tile.lanes[r][j] = v[j];
  } else {
    uint32_t w[M::kMaxWords];
#pragma unroll
    for (int k = 0; k < M::kMaxWords; ++k) w[k] = k < L.wp ? p[k] : 0u;
    if constexpr (WholeWords<M>::value) {
#pragma unroll
      for (int j = 0; j < M::kMaxW; ++j) tile.lanes[r][j] = w[j];
    } else {
      uint32_t v[M::kMaxW];
      unpack(L, w, v);
#pragma unroll
      for (int j = 0; j < M::kMaxW; ++j) tile.lanes[r][j] = v[j];
    }
  }
  tile.valid[r] = valid;
}

// Slot t of the tile, action f of the tile's row r: expands it and stages
// its successor, path fingerprint, sflat and (kDedupOut) dedup fingerprint
// at position t. Returns the dedup fingerprint.
template <class M, bool kDedupOut>
__device__ __forceinline__ u64 stage_slot(
    const M& m, const Layout<M::kMaxW, M::kMaxWords>& L,
    WaveTile<M, kDedupOut>& tile, unsigned t, unsigned r, int f,
    bool use_sym) {
  uint32_t v[M::kMaxW];
#pragma unroll
  for (int j = 0; j < M::kMaxW; ++j) v[j] = tile.lanes[r][j];
  u64 pfp, dfp;
  if constexpr (IndexedCodec<M>::value) {
    uint32_t* dst = tile.succ + t * L.wp;
    tile.sflat[t] = expand_slot(
        m, L, v, f, tile.valid[r], use_sym,
        [&](const uint32_t (&x)[M::kMaxW]) { pack_into(L, x, dst); }, &pfp,
        &dfp);
  } else {
    uint32_t q[M::kMaxWords];
    tile.sflat[t] = expand_slot(
        m, L, v, f, tile.valid[r], use_sym,
        [&](const uint32_t (&x)[M::kMaxW]) {
          if constexpr (WholeWords<M>::value) {
#pragma unroll
            for (int k = 0; k < M::kMaxWords; ++k)
              q[k] = k < L.w ? x[k] : 0u;
          } else {
            pack(L, x, q);
          }
        },
        &pfp, &dfp);
#pragma unroll
    for (int k = 0; k < M::kMaxWords; ++k)
      if (k < L.wp) tile.succ[t * L.wp + k] = q[k];
  }
  tile.pfp[t] = pfp;
  if (kDedupOut) tile.dfp[t] = dfp;
  return dfp;
}

// What a slot of the single-kernel wave does after its tile's stores:
// claims its dedup fingerprint's slot in the scratch, and the first
// claimer walks the visited table (claim_row); the block's counts go to
// the scratch's tally at the end.
struct WaveTail {
  static constexpr bool kSender = false;
  u64* table;  // [2^c_bits], in place
  int c_bits;
  Scratch scratch;  // the caller's, clean
  int* slot_of;     // [S]

  __device__ __forceinline__ void claim(u64 dfp, unsigned i, unsigned,
                                        int (&acc)[3]) const {
    slot_of[i] = claim_row(dfp, (int)i, scratch, table, c_bits, acc);
  }
  __device__ __forceinline__ void finish(const int (&acc)[3]) const {
    flush_tally(acc, scratch.tally);
  }
};

// The sender kernel's: with local dedup, slot i of shard k claims its
// dedup fingerprint's slot in region k of the scratch (2^region_bits
// slots from slot k << region_bits) and walks nothing; pass 2 (send) then
// tells the holder of each slot, which resets it. Without local dedup,
// nothing.
struct SenderTail {
  static constexpr bool kSender = true;
  u64* dedup_fps;  // [n, S]
  bool* send_mask;  // [n, S]
  bool local_dedup;
  Slot* slots;  // the caller's scratch, clean; n << region_bits slots
  int region_bits;
  int* slot_of;  // [n, S]

  __device__ __forceinline__ void claim(u64 dfp, unsigned i, unsigned k,
                                        int (&)[3]) const {
    if (!local_dedup) return;
    int slot = -1;
    if (dfp != kSentinel) {
      const unsigned base = k << region_bits;
      bool fresh;
      slot = (int)base + claim_slot(dfp, (int)i, slots + base, region_bits,
                                    &fresh);
    }
    slot_of[i] = slot;
  }
  __device__ __forceinline__ void finish(const int (&)[3]) const {}

  // Pass 2 of slot i, after every claim has landed.
  __device__ __forceinline__ void send(unsigned i) const {
    int walk;
    send_mask[i] = take_slot(slot_of[i], (int)i, slots, &walk);
  }
};

#ifdef __CUDACC__

// Pointers and sizes of one wave, as the C entry point receives them.
struct WaveArgs {
  const int* lanes;  // host int32[5 * w]: word, offset, bits, sentinel
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
  const int* lanes;  // host int32[5 * w]
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
  Slot* slots;           // the caller's scratch, read only when local_dedup
  int* slot_of;          // [shards, S], likewise
  int region_bits;
  bool use_sym, local_dedup;
  int device;
  cudaStream_t stream;
};

// The C entry points' arguments (wave_<model>.cu), as launch_wave takes
// them.
inline WaveArgs wave_args(int use_sym, const int* lanes, int w, int wp,
                          const void* vecs, const void* valid,
                          long long batch, int fanout, void* table,
                          int c_bits, void* succ_store, void* path_fps,
                          void* sflat, void* slots, void* tally,
                          void* slot_of, int m_bits, void* new_mask,
                          void* cand_mask, void* counts, int device,
                          void* stream) {
  WaveArgs a;
  a.lanes = lanes;
  a.w = w;
  a.wp = wp;
  a.vecs = static_cast<const uint32_t*>(vecs);
  a.valid = static_cast<const bool*>(valid);
  a.batch = batch;
  a.fanout = fanout;
  a.table = static_cast<u64*>(table);
  a.c_bits = c_bits;
  a.succ_store = static_cast<uint32_t*>(succ_store);
  a.path_fps = static_cast<u64*>(path_fps);
  a.sflat = static_cast<bool*>(sflat);
  a.scratch = Scratch{static_cast<Slot*>(slots), static_cast<int*>(tally),
                      m_bits};
  a.slot_of = static_cast<int*>(slot_of);
  a.new_mask = static_cast<bool*>(new_mask);
  a.cand_mask = static_cast<bool*>(cand_mask);
  a.counts = static_cast<int*>(counts);
  a.use_sym = use_sym != 0;
  a.device = device;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

// Likewise for launch_sender.
inline SenderArgs sender_args(int use_sym, int local_dedup, const int* lanes,
                              int w, int wp, const void* vecs,
                              const void* valid, long long batch,
                              long long shards, int fanout, void* succ_store,
                              void* dedup_fps, void* path_fps, void* sflat,
                              void* send_mask, void* slots, void* slot_of,
                              int region_bits, int device, void* stream) {
  SenderArgs a;
  a.lanes = lanes;
  a.w = w;
  a.wp = wp;
  a.vecs = static_cast<const uint32_t*>(vecs);
  a.valid = static_cast<const bool*>(valid);
  a.batch = batch;
  a.shards = shards;
  a.fanout = fanout;
  a.succ_store = static_cast<uint32_t*>(succ_store);
  a.dedup_fps = static_cast<u64*>(dedup_fps);
  a.path_fps = static_cast<u64*>(path_fps);
  a.sflat = static_cast<bool*>(sflat);
  a.send_mask = static_cast<bool*>(send_mask);
  a.slots = static_cast<Slot*>(slots);
  a.slot_of = static_cast<int*>(slot_of);
  a.region_bits = region_bits;
  a.use_sym = use_sym != 0;
  a.local_dedup = local_dedup != 0;
  a.device = device;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

// The tile loop's parameters, one struct so one pointer passes them.
template <class M, class Tail>
struct FrontParams {
  M m;
  Layout<M::kMaxW, M::kMaxWords> L;
  const uint32_t* vecs;  // [shards, B, wp]
  const bool* valid;     // [shards, B]
  unsigned B, S, F;      // rows and slots a shard, actions a row
  unsigned T;            // slots a tile, at most kWaveThreads
  unsigned shards, tiles;  // tiles a shard
  bool use_sym;
  uint32_t* succ_store;  // [shards, S, wp]
  u64* path_fps;         // [shards, S]
  bool* sflat;           // [shards, S]
  Tail tail;
};

namespace {

// Copies count elements of a staged tile from shared memory (16-byte
// aligned) to global memory: 16 bytes a thread a step where dst is 16-byte
// aligned too, an element a thread a step for the rest.
template <class T>
__device__ __forceinline__ void copy_out(T* dst, const T* src,
                                         unsigned count) {
  unsigned c0 = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const unsigned n16 = count * sizeof(T) / 16;
    for (unsigned c = threadIdx.x; c < n16; c += blockDim.x)
      reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(src)[c];
    c0 = n16 * (16 / sizeof(T));
  }
  for (unsigned c = c0 + threadIdx.x; c < count; c += blockDim.x)
    dst[c] = src[c];
}

// The tile loop (see the note at the top), for a block.
template <class M, class Tail>
__device__ __forceinline__ void front_tiles(
    const FrontParams<M, Tail>& a, WaveTile<M, Tail::kSender>& tile) {
  const unsigned tid = threadIdx.x, F = a.F, wp = a.L.wp;
  int acc[3] = {0, 0, 0};
  for (unsigned p = blockIdx.x; p < a.shards * a.tiles; p += gridDim.x) {
    const unsigned k = p / a.tiles;  // the tile's shard
    const unsigned t0 = (p - k * a.tiles) * a.T;  // in the shard
    const unsigned n = min(a.T, a.S - t0);
    const unsigned b0 = t0 / F;
    const unsigned rows = (t0 + n - 1) / F - b0 + 1;
    const unsigned g0 = k * a.S + t0;    // over all shards
    const unsigned row0 = k * a.B + b0;  // likewise
    __syncthreads();  // the last tile's stores have read the staging
    if (tid < rows)
      stage_row(a.L, a.vecs + (size_t)(row0 + tid) * wp, a.valid[row0 + tid],
                tile, tid);
    __syncthreads();
    u64 dfp = kSentinel;
    if (tid < n) {
      const unsigned r = (t0 + tid) / F - b0;
      dfp = stage_slot(a.m, a.L, tile, tid, r, (int)(t0 + tid - (b0 + r) * F),
                       a.use_sym);
    }
    __syncthreads();
    copy_out(a.succ_store + (size_t)g0 * wp, tile.succ, n * wp);
    copy_out(a.path_fps + g0, tile.pfp, n);
    copy_out(a.sflat + g0, tile.sflat, n);
    if constexpr (Tail::kSender) {
      copy_out(a.tail.dedup_fps + g0, tile.dfp, n);
      if (!a.tail.local_dedup) copy_out(a.tail.send_mask + g0, tile.sflat, n);
    }
    if (tid < n) a.tail.claim(dfp, g0 + tid, k, acc);
  }
  a.tail.finish(acc);
}

// The tile lives in dynamic shared memory, sizeof(WaveTile) bytes a block:
// a wide row's outgrows the 48 KiB a block may declare statically (VSR at
// 3 and 4 replicas stages 66 and 82 words a slot, about 72 and 89 KB a
// tile).
template <class M, class Tail>
__global__ void __launch_bounds__(kWaveThreads, M::kMaxW > 20 ? 2 : 4)
    tile_front(const FrontParams<M, Tail> a) {
  extern __shared__ uint4 tile_smem[];
  front_tiles(a, *reinterpret_cast<WaveTile<M, Tail::kSender>*>(tile_smem));
}

// The sender's pass 2 as its own launch: one thread a slot.
__global__ void send_rows(const SenderTail t, unsigned n) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) t.send(i);
}

// Fills the tile loop's common parameters for `shards` shards of `batch`
// rows; false when the layout or the fanout does not fit the model.
template <class M, class Tail>
bool front_params(const M& m, const int* lanes, int w, int wp, int fanout,
                  const uint32_t* vecs, const bool* valid, long long batch,
                  long long shards, bool use_sym, uint32_t* succ_store,
                  u64* path_fps, bool* sflat, FrontParams<M, Tail>* p) {
  if (!make_layout(m, lanes, w, wp, fanout, &p->L)) return false;
  p->m = m;
  p->vecs = vecs;
  p->valid = valid;
  p->B = (unsigned)batch;
  p->S = (unsigned)(batch * fanout);
  p->F = (unsigned)fanout;
  p->T = min((unsigned)kWaveThreads,
             (unsigned)(WaveTile<M, Tail::kSender>::kRows - 1) * p->F);
  p->shards = (unsigned)shards;
  p->tiles = (p->S + p->T - 1) / p->T;
  p->use_sym = use_sym;
  p->succ_store = succ_store;
  p->path_fps = path_fps;
  p->sflat = sflat;
  return true;
}

// Launches the tile loop over p's tiles on `stream`, on at most the blocks
// the device holds at once (asked once a kernel and device).
template <class M, class Tail>
int launch_front(const FrontParams<M, Tail>& p, int device,
                 cudaStream_t stream) {
  static std::atomic<unsigned> cache[kMaxDevices];
  constexpr size_t smem = sizeof(WaveTile<M, Tail::kSender>);
  const unsigned most = resident_blocks(cache, (const void*)tile_front<M, Tail>,
                                        kWaveThreads, device, smem);
  if (most == 0) return (int)cudaErrorInvalidDevice;
  const unsigned tiles = p.shards * p.tiles;
  tile_front<M, Tail><<<(tiles < most ? tiles : most), kWaveThreads, smem,
                        stream>>>(p);
  return 0;
}

}  // namespace

// Launches both phases on a.stream for model m; does not synchronise.
// Returns cudaErrorInvalidValue when the layout or the fanout does not fit
// the model, else the launches' CUDA error code.
template <class M>
int launch_wave(const M& m, const WaveArgs& a) {
  FrontParams<M, WaveTail> p;
  if (!front_params(m, a.lanes, a.w, a.wp, a.fanout, a.vecs, a.valid,
                    a.batch, 1, a.use_sym, a.succ_store, a.path_fps, a.sflat,
                    &p))
    return (int)cudaErrorInvalidValue;
  if (p.S == 0)
    return (int)cudaMemsetAsync(a.counts, 0, 3 * sizeof(int), a.stream);
  p.tail = WaveTail{a.table, a.c_bits, a.scratch, a.slot_of};
  const int rc = launch_front(p, a.device, a.stream);
  if (rc != 0) return rc;
  resolve_rows<<<(p.S + kWaveThreads - 1) / kWaveThreads, kWaveThreads, 0,
                 a.stream>>>(
      a.slot_of, p.S, a.scratch, a.new_mask, a.cand_mask, a.counts);
  return (int)cudaGetLastError();
}

// Launches the sender kernel on a.stream for model m over all shards at
// once: the tile loop, then with local dedup pass 2; does not
// synchronise. Same return codes as launch_wave.
template <class M>
int launch_sender(const M& m, const SenderArgs& a) {
  FrontParams<M, SenderTail> p;
  if (!front_params(m, a.lanes, a.w, a.wp, a.fanout, a.vecs, a.valid,
                    a.batch, a.shards, a.use_sym, a.succ_store, a.path_fps,
                    a.sflat, &p))
    return (int)cudaErrorInvalidValue;
  const unsigned n = p.shards * p.S;
  if (n == 0) return 0;
  p.tail = SenderTail{a.dedup_fps, a.send_mask, a.local_dedup, a.slots,
                      a.region_bits, a.slot_of};
  const int rc = launch_front(p, a.device, a.stream);
  if (rc != 0) return rc;
  if (a.local_dedup)
    send_rows<<<(n + kWaveThreads - 1) / kWaveThreads, kWaveThreads, 0,
                a.stream>>>(p.tail, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace sr
