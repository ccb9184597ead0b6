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

namespace {

constexpr int kWaveThreads = 256;

template <class M>
__global__ void wave_front(M m, Layout<M::kMaxW, M::kMaxWords> L,
                           const uint32_t* __restrict__ vecs,
                           const bool* __restrict__ valid, long long S,
                           int F, bool use_sym,
                           uint32_t* __restrict__ succ_store,
                           u64* __restrict__ path_fps,
                           bool* __restrict__ sflat,
                           u64* __restrict__ dedup_fps, u64* keys, int* rows,
                           int* __restrict__ slot_of, int m_bits) {
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
      slot_of[i] = scratch_claim(dfp, (int)i, keys, rows, m_bits);
    }
    dedup_fps[i] = dfp;
  }
}

}  // namespace

// Launches both passes on a.stream for model m; does not synchronise.
// Returns cudaErrorInvalidValue when the layout or the fanout does not fit
// the model, else cudaGetLastError().
template <class M>
int launch_wave(const M& m, const WaveArgs& a) {
  constexpr int kMaxW = M::kMaxW, kMaxWords = M::kMaxWords;
  if (a.w != m.width() || a.w > kMaxW || a.wp > kMaxWords ||
      a.fanout != m.fanout())
    return (int)cudaErrorInvalidValue;
  Layout<kMaxW, kMaxWords> L;
  L.w = a.w;
  L.wp = a.wp;
  for (int j = 0; j < a.w; ++j) {
    L.word[j] = (uint8_t)a.lanes[j];
    L.offset[j] = (uint8_t)a.lanes[a.w + j];
    L.bits[j] = (uint8_t)a.lanes[2 * a.w + j];
  }
  const long long S = a.batch * a.fanout;
  if (S > 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wave_front<M>,
                                                  kWaveThreads, 0);
    const long long want = (S + kWaveThreads - 1) / kWaveThreads;
    const long long most = (long long)(sms > 0 ? sms : 1) *
                           (per_sm > 0 ? per_sm : 1);
    wave_front<M><<<(unsigned)(want < most ? want : most), kWaveThreads, 0,
                    a.stream>>>(m, L, a.vecs, a.valid, S, a.fanout,
                                a.use_sym, a.succ_store, a.path_fps,
                                a.sflat, a.dedup_fps, a.keys, a.rows,
                                a.slot_of, a.m_bits);
    probe_claim<<<(unsigned)want, kWaveThreads, 0, a.stream>>>(
        a.dedup_fps, S, a.rows, a.slot_of, a.table, a.c_bits, a.new_mask,
        a.cand_mask, a.counts);
  }
  return (int)cudaGetLastError();
}

}  // namespace sr
