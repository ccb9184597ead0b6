"""The dedup and wave kernels' device code, run on the CPU.

The phases of ``stateright_tpu_torch/csrc/table.cuh`` and ``wave.cuh``
are ``__device__`` functions outside the CUDA-only section, so a host
compiler builds them behind a small shim: the CUDA qualifiers defined
away, one thread a block, and sequential atomics. The harness below runs
phase 1 (claim + walk; under the wave kernel, the tile loop's per-slot
steps first: row staged, slot expanded and staged) for every row, then
phase 2 (resolve + reset) for every row, a row at a time in a given
arrival order: forward, reverse and a seeded shuffle; and the sender
kernel's per-slot steps (the claim in its shard's region, no walk) and
its pass 2 (send + reset) the same way over 2 and 3 stacked shards.
Held to the plain versions (``dedup_and_insert_plain``,
``wave_megakernel_plain``, ``sender_megakernel_plain``) exactly: masks,
counts, successors, fingerprints and sflat bit for bit, the table as a
set. Also: the scratch comes back clean, exactly one row walks the
visited table for each distinct valid fingerprint and only in phase 1,
the sender touches no tally, and the outputs do not depend on the order.
The tile loop's shared memory, barriers and stores run only on the card
(``chip_smoke.py``).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from stateright_tpu_torch import carry, table, wave
from stateright_tpu_torch.engine import (expand_frontier,
                                         fingerprint_successors,
                                         host_table_insert)
from stateright_tpu_torch.hashing import SENTINEL_U64
from stateright_tpu_torch.models import twopc
from stateright_tpu_torch.packing import compile_layout

torch.set_num_threads(2)

CSRC = table.__file__.rsplit("/", 1)[0] + "/csrc"

SHIM = r"""
#pragma once
#include <algorithm>
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
inline void __syncthreads() {}
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
static Dim3 threadIdx, blockIdx, blockDim, gridDim;
template <class T> T atomicCAS(T* p, T cmp, T val) {
  const T old = *p;
  if (old == cmp) *p = val;
  return old;
}
inline int atomicMin(int* p, int v) {
  const int old = *p;
  if (v < old) *p = v;
  return old;
}
inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p += v;
  return old;
}
inline int __reduce_add_sync(unsigned, int v) { return v; }
// Reads of the visited table are counted, to see who walks it and when.
extern long long g_table_reads;
extern const void* g_table_lo;
extern const void* g_table_hi;
template <class T> T __ldcg(const T* p) {
  if ((const void*)p >= g_table_lo && (const void*)p < g_table_hi)
    ++g_table_reads;
  return *p;
}
using std::max;
using std::min;
"""

HARNESS = r"""
#include <vector>
#include "wave.cuh"
#include "models/twopc.cuh"

long long g_table_reads = 0;
const void* g_table_lo = nullptr;
const void* g_table_hi = nullptr;

using sr::u64;

namespace {

// Phase 1 of row i, noting whether it read the visited table.
int claim(u64 fp, long long i, const sr::Scratch& s, u64* table, int c_bits,
          unsigned char* walked) {
  const long long before = g_table_reads;
  int acc[3] = {0, 0, 0};
  const int slot = sr::claim_row(fp, (int)i, s, table, c_bits, acc);
  sr::flush_tally(acc, s.tally);
  walked[i] = g_table_reads != before;
  return slot;
}

// Phase 2 over every row in `order`; returns the table reads it made.
long long resolve_all(const std::vector<int>& slot_of, const long long* order,
                      const sr::Scratch& s, bool* new_mask, bool* cand_mask,
                      int* counts) {
  const long long before = g_table_reads;
  sr::take_tally(s.tally, counts);
  for (size_t k = 0; k < slot_of.size(); ++k) {
    const long long i = order[k];
    sr::resolve(slot_of[i], (int)i, s, new_mask, cand_mask);
  }
  return g_table_reads - before;
}

// Copies slot t of a staged tile out to slot i of the outputs.
template <class Tile>
void unstage(const Tile& tile, unsigned t, long long i, int wp, uint32_t* succ,
             u64* path_fps, bool* sflat) {
  for (int j = 0; j < wp; ++j) succ[i * wp + j] = tile.succ[t * wp + j];
  path_fps[i] = tile.pfp[t];
  sflat[i] = tile.sflat[t];
}

// The wave kernel's per-slot work a slot at a time: the parent row staged,
// the slot expanded and staged, copied out, then its tail's claim.
template <int kMaxN>
long long wave_t(int rm, int use_sym, const int* lanes, int w, int wp,
                 const uint32_t* vecs, const bool* valid, long long batch,
                 int fanout, u64* table, int c_bits, sr::Scratch s,
                 const long long* order1, const long long* order2,
                 uint32_t* succ, u64* path_fps, bool* sflat, bool* new_mask,
                 bool* cand_mask, int* counts, unsigned char* walked) {
  using M = sr::TwoPhase<kMaxN>;
  using Tile = sr::WaveTile<M, false>;
  const M m{rm};
  sr::Layout<M::kMaxW, M::kMaxWords> L;
  if (!sr::make_layout(m, lanes, w, wp, fanout, &L)) return -1;
  const long long S = batch * fanout;
  std::vector<int> slot_of(S);
  const sr::WaveTail tail{table, c_bits, s, slot_of.data()};
  static Tile tile;
  for (long long k = 0; k < S; ++k) {
    const long long i = order1[k], b = i / fanout;
    const unsigned t = i % sr::kWaveThreads, r = b % Tile::kRows;
    sr::stage_row(L, vecs + b * wp, valid[b], tile, r);
    const u64 dfp = sr::stage_slot(m, L, tile, t, r, (int)(i - b * fanout),
                                   use_sym != 0);
    unstage(tile, t, i, wp, succ, path_fps, sflat);
    const long long before = g_table_reads;
    int acc[3] = {0, 0, 0};
    tail.claim(dfp, (unsigned)i, 0, acc);
    tail.finish(acc);
    walked[i] = g_table_reads != before;
  }
  return resolve_all(slot_of, order2, s, new_mask, cand_mask, counts);
}

// The sender kernel's per-slot work over `shards` stacked shards a slot
// at a time (row staged, slot expanded and staged, copied out, the claim
// in its shard's region), then pass 2 a slot at a time. Returns -1 when
// the layout does not fit, -2 when a tally was touched, else 0.
template <int kMaxN>
long long sender_t(int rm, int use_sym, int local_dedup, const int* lanes,
                   int w, int wp, const uint32_t* vecs, const bool* valid,
                   long long batch, long long shards, int fanout,
                   sr::Slot* slots, int region_bits, const long long* order1,
                   const long long* order2, uint32_t* succ, u64* dedup_fps,
                   u64* path_fps, bool* sflat, bool* send_mask) {
  using M = sr::TwoPhase<kMaxN>;
  using Tile = sr::WaveTile<M, true>;
  const M m{rm};
  sr::Layout<M::kMaxW, M::kMaxWords> L;
  if (!sr::make_layout(m, lanes, w, wp, fanout, &L)) return -1;
  const long long S = batch * fanout, n = shards * S;
  std::vector<int> slot_of(n, -7);
  const sr::SenderTail tail{dedup_fps, send_mask, local_dedup != 0, slots,
                            region_bits, slot_of.data()};
  static Tile tile;
  for (long long k = 0; k < n; ++k) {
    const long long i = order1[k], shard = i / S, j = i - shard * S;
    const long long b = j / fanout, row = shard * batch + b;
    const unsigned t = i % sr::kWaveThreads, r = b % Tile::kRows;
    sr::stage_row(L, vecs + row * wp, valid[row], tile, r);
    const u64 dfp = sr::stage_slot(m, L, tile, t, r, (int)(j - b * fanout),
                                   use_sym != 0);
    unstage(tile, t, i, wp, succ, path_fps, sflat);
    dedup_fps[i] = tile.dfp[t];
    if (!local_dedup) send_mask[i] = tile.sflat[t];
    int acc[3] = {0, 0, 0};
    tail.claim(dfp, (unsigned)i, (unsigned)shard, acc);
    tail.finish(acc);
    if (acc[0] || acc[1] || acc[2]) return -2;
  }
  if (local_dedup)
    for (long long k = 0; k < n; ++k) tail.send((unsigned)order2[k]);
  return 0;
}

}  // namespace

extern "C" long long dedup_phases(const u64* fps, long long n, u64* table,
                                  int c_bits, sr::Slot* slots, int* tally,
                                  int m_bits,
                                  const long long* order1,
                                  const long long* order2, bool* new_mask,
                                  bool* cand_mask, int* counts,
                                  unsigned char* walked) {
  g_table_lo = table;
  g_table_hi = table + (1ll << c_bits);
  const sr::Scratch s{slots, tally, m_bits};
  std::vector<int> slot_of(n);
  for (long long k = 0; k < n; ++k) {
    const long long i = order1[k];
    slot_of[i] = claim(fps[i], i, s, table, c_bits, walked);
  }
  return resolve_all(slot_of, order2, s, new_mask, cand_mask, counts);
}

extern "C" long long wave_phases(
    int rm, int use_sym, const int* lanes, int w, int wp, const uint32_t* vecs,
    const bool* valid, long long batch, int fanout, u64* table, int c_bits,
    sr::Slot* slots, int* tally, int m_bits,
    const long long* order1, const long long* order2, uint32_t* succ,
    u64* path_fps, bool* sflat, bool* new_mask, bool* cand_mask, int* counts,
    unsigned char* walked) {
  g_table_lo = table;
  g_table_hi = table + (1ll << c_bits);
  const sr::Scratch s{slots, tally, m_bits};
  return wave_t<8>(rm, use_sym, lanes, w, wp, vecs, valid, batch, fanout,
                   table, c_bits, s, order1, order2, succ, path_fps, sflat,
                   new_mask, cand_mask, counts, walked);
}

extern "C" long long sender_phases(
    int rm, int use_sym, int local_dedup, const int* lanes, int w, int wp,
    const uint32_t* vecs, const bool* valid, long long batch,
    long long shards, int fanout, sr::Slot* slots, int region_bits,
    const long long* order1, const long long* order2, uint32_t* succ,
    u64* dedup_fps, u64* path_fps, bool* sflat, bool* send_mask) {
  return sender_t<8>(rm, use_sym, local_dedup, lanes, w, wp, vecs, valid,
                     batch, shards, fanout, slots, region_bits, order1,
                     order2, succ, dedup_fps, path_fps, sflat, send_mask);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine to build the device code with")
    root = tmp_path_factory.mktemp("device_code")
    shutil.copytree(CSRC, root / "csrc")
    (root / "shim.h").write_text(SHIM)
    (root / "harness.cpp").write_text(HARNESS)
    so = root / "device_code.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-include", str(root / "shim.h"), "-I", str(root / "csrc"),
                    "-o", str(so), str(root / "harness.cpp")], check=True,
                   capture_output=True, timeout=120)
    return ctypes.CDLL(str(so))


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class _Scratch:
    """A clean scratch of the kernels' layout (``table.DedupScratch``),
    for ``n`` rows in ``shards`` shards."""

    def __init__(self, n, shards=1):
        self.m_bits, self.region_bits = table.scratch_bits(n, shards)
        self.slots = np.tile(np.array(table.CLEAN_SLOT, np.int64),
                             (1 << self.m_bits, 1))
        self.tally = np.zeros(3, np.int32)

    def args(self):
        return _ptr(self.slots), _ptr(self.tally)

    def is_clean(self):
        return ((self.slots == np.array(table.CLEAN_SLOT)).all()
                and not self.tally.any())


def _orders(n, seed):
    rng = np.random.default_rng(seed)
    fwd = np.arange(n, dtype=np.int64)
    return {"forward": (fwd, fwd), "reverse": (fwd[::-1].copy(),) * 2,
            "shuffled": (rng.permutation(n), rng.permutation(n))}


def _dedup(lib, fps, host_table, order1, order2):
    """The device code's dedup of ``fps`` against a copy of
    ``host_table``: ``(new, cand, counts, table, walked, phase-2 table
    reads, scratch)``."""
    n = len(fps)
    t = host_table.copy()
    s = _Scratch(n)
    new, cand = np.zeros(n, np.bool_), np.zeros(n, np.bool_)
    counts, walked = np.full(3, -7, np.int32), np.zeros(n, np.uint8)
    fn = lib.dedup_phases
    fn.restype = ctypes.c_longlong
    reads = fn(ctypes.c_void_p(_ptr(fps)), ctypes.c_longlong(n),
               ctypes.c_void_p(_ptr(t)),
               ctypes.c_int(len(t).bit_length() - 1),
               *[ctypes.c_void_p(a) for a in s.args()],
               ctypes.c_int(s.m_bits), ctypes.c_void_p(_ptr(order1)),
               ctypes.c_void_p(_ptr(order2)), ctypes.c_void_p(_ptr(new)),
               ctypes.c_void_p(_ptr(cand)), ctypes.c_void_p(_ptr(counts)),
               ctypes.c_void_p(_ptr(walked)))
    return new, cand, counts, t, walked.astype(bool), reads, s


def _as_set(a):
    return set(a[a != SENTINEL_U64].tolist())


def _stream(rng, n, resident):
    """The reference tests' stream: duplicates, sentinels, revisits."""
    fresh = rng.integers(1, 1 << 62, n, dtype=np.uint64)
    out = fresh.copy()
    dup = rng.random(n) < 0.3
    out[dup] = rng.choice(fresh, dup.sum())
    rev = rng.random(n) < 0.2
    out[rev] = rng.choice(resident, rev.sum())
    out[rng.random(n) < 0.1] = SENTINEL_U64
    return out


def _check_walks(fps, walked, reads, s):
    """One walk for each distinct valid fingerprint, all in phase 1, and
    the scratch clean."""
    valid = fps != SENTINEL_U64
    assert walked.sum() == len(np.unique(fps[valid]))
    assert set(fps[walked].tolist()) == set(fps[valid].tolist())
    assert not walked[~valid].any()
    assert reads == 0
    assert s.is_clean()


@pytest.mark.parametrize("order", ["forward", "reverse", "shuffled"])
def test_dedup_phases_match_the_plain_version(lib, order):
    rng = np.random.default_rng(5)
    capacity = 1 << 13
    resident = rng.integers(1, 1 << 62, capacity // 8, dtype=np.uint64)
    host = np.full(capacity, SENTINEL_U64, np.uint64)
    host_table_insert(host, resident)
    fps = _stream(rng, 1000, resident)
    o1, o2 = _orders(len(fps), 9)[order]
    new, cand, counts, t, walked, reads, s = _dedup(lib, fps, host, o1, o2)

    t_p = carry.u64_in(host)
    new_p, cand_p, c_new, c_cand, full = table.dedup_and_insert_plain(
        carry.u64_in(fps), t_p)
    assert np.array_equal(new, new_p.numpy())
    assert np.array_equal(cand, cand_p.numpy())
    assert counts.tolist() == [int(c_new), int(c_cand), int(bool(full))]
    assert _as_set(t) == _as_set(carry.u64_out(t_p))
    assert 0 < counts[0] < counts[1] < (fps != SENTINEL_U64).sum()
    _check_walks(fps, walked, reads, s)


def test_dedup_phases_flag_a_full_table(lib):
    """A table with 6 free slots and 30 fresh candidates: the walks of 24
    find it full. Which 6 get in depends on the arrival order; the rest
    of the outputs do not."""
    rng = np.random.default_rng(6)
    capacity = 64
    resident = rng.integers(1, 1 << 62, capacity - 6, dtype=np.uint64)
    host = np.full(capacity, SENTINEL_U64, np.uint64)
    host_table_insert(host, resident)
    fresh = rng.integers(1, 1 << 62, 30, dtype=np.uint64)
    fps = np.concatenate([fresh, fresh[:10], resident[:5],
                          np.full(3, SENTINEL_U64, np.uint64)])
    fps = fps[rng.permutation(len(fps))]
    _, cand_p, _, c_cand, full = table.dedup_and_insert_plain(
        carry.u64_in(fps), carry.u64_in(host))
    assert bool(full)
    for o1, o2 in _orders(len(fps), 3).values():
        new, cand, counts, t, walked, reads, s = _dedup(lib, fps, host, o1,
                                                        o2)
        assert np.array_equal(cand, cand_p.numpy())
        assert counts.tolist() == [6, int(c_cand), 24]
        assert new.sum() == 6 and not (new & ~cand).any()
        assert _as_set(t) == set(resident.tolist()) | set(
            fps[new].tolist())
        _check_walks(fps, walked, reads, s)


def _frontier(rm, sym, B, rng):
    """``B`` packed rows of a 2pc frontier a few waves in (with invalid
    rows and holes), its layout and a table of the states seen so far."""
    dm = twopc.TwoPhaseDevice(rm)
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    capacity = 1 << 14
    t = torch.full((capacity,), -1, dtype=torch.int64)
    rows = [np.asarray(dm.encode(s), np.uint32)
            for s in twopc.TwoPhaseSys(rm).init_states()]
    store = torch.from_numpy(layout.pack_np(np.stack(rows)).view(np.int32))
    for _ in range(3):
        valid = torch.ones(store.shape[0], dtype=torch.bool)
        succ, _, _, new, *_ = wave.wave_megakernel_plain(
            dm, store, valid, t, sym, layout)
        store = succ[new][:B].contiguous()
    n = store.shape[0]
    packed = np.zeros((B, layout.packed_width), np.uint32)
    packed[:n] = carry.words_out(store)
    packed[n:] = rng.integers(0, 1 << 20, (B - n, layout.packed_width))
    valid = np.arange(B) < n
    valid[rng.random(B) < 0.1] = False
    return dm, layout, packed, valid, carry.u64_out(t)


@pytest.mark.parametrize("rm, sym", [(3, False), (4, False), (5, False),
                                     (3, True), (5, True)])
def test_wave_phases_match_the_plain_version(lib, rm, sym):
    rng = np.random.default_rng(rm)
    B = 48
    dm, layout, packed, valid, host = _frontier(rm, sym, B, rng)
    F, wp = dm.max_fanout, layout.packed_width
    S = B * F
    _, _, lanes = wave.cuda_model(dm, layout)
    want = wave.wave_megakernel_plain(
        dm, carry.words_in(packed), torch.from_numpy(valid),
        t_p := carry.u64_in(host), sym, layout)
    outs = []
    for name, (o1, o2) in _orders(S, rm).items():
        t = host.copy()
        s = _Scratch(S)
        succ = np.zeros((S, wp), np.uint32)
        pfps = np.zeros(S, np.uint64)
        sflat, new, cand = (np.zeros(S, np.bool_) for _ in range(3))
        counts, walked = np.full(3, -7, np.int32), np.zeros(S, np.uint8)
        fn = lib.wave_phases
        fn.restype = ctypes.c_longlong
        p = ctypes.c_void_p
        reads = fn(ctypes.c_int(rm), ctypes.c_int(int(sym)),
                   p(_ptr(lanes)), ctypes.c_int(layout.width),
                   ctypes.c_int(wp), p(_ptr(packed)), p(_ptr(valid)),
                   ctypes.c_longlong(B), ctypes.c_int(F), p(_ptr(t)),
                   ctypes.c_int(len(t).bit_length() - 1),
                   *[p(a) for a in s.args()], ctypes.c_int(s.m_bits),
                   p(_ptr(o1)), p(_ptr(o2)), p(_ptr(succ)), p(_ptr(pfps)),
                   p(_ptr(sflat)), p(_ptr(new)), p(_ptr(cand)),
                   p(_ptr(counts)), p(_ptr(walked)))
        assert reads >= 0, "the layout did not fit the device model"
        got = (succ, pfps, sflat, new, cand)
        for g, w in zip(got, (carry.words_out(want[0]),
                              carry.u64_out(want[1]), want[2].numpy(),
                              want[3].numpy(), want[4].numpy())):
            assert np.array_equal(g, w), name
        assert counts.tolist() == [int(want[5]), int(want[6]),
                                   int(bool(want[7]))]
        assert _as_set(t) == _as_set(carry.u64_out(t_p))
        # The dedup fingerprints the walks were made for, from the plain
        # stages: one walk each, in phase 1 only.
        succ_t, sf_t, _, _ = expand_frontier(
            dm, layout.unpack(carry.words_in(packed)),
            torch.from_numpy(valid))
        dfps = carry.u64_out(fingerprint_successors(
            dm, succ_t, sf_t, sym)[0])
        _check_walks(dfps, walked.astype(bool), reads, s)
        outs.append(got)
    assert want[6] > 0 and want[5] > 0
    for a, b in zip(outs, outs[1:]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _sender_rows(rm, sym, n, rng):
    """``n`` shards' batches of a 2pc frontier: repeats within shard 0,
    and shard 1 starting with shard 0's rows (uint32[n, B, Wp],
    bool[n, B])."""
    B = 16
    dm, layout, packed, valid, _ = _frontier(rm, sym, n * B, rng)
    packed = packed.reshape(n, B, -1)
    valid = valid.reshape(n, B)
    for k, part in ((0, slice(B // 2, None)), (1, slice(None, B // 2))):
        packed[k, part] = packed[0, :B // 2]
        valid[k, part] = valid[0, :B // 2]
    return dm, layout, np.ascontiguousarray(packed), valid


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("local_dedup", [True, False],
                         ids=["local_dedup", "no_local_dedup"])
@pytest.mark.parametrize("rm, sym", [(3, False), (4, False), (5, False),
                                     (3, True), (5, True)])
def test_sender_phases_match_the_plain_version(lib, rm, sym, local_dedup, n):
    """The sender kernel's per-slot work and pass 2 against
    ``sender_megakernel_plain``, bit for bit, in three arrival orders, in
    the engine's scratch for ``n`` shards (n = 3: regions in a scratch
    sized for a shard count that is not a power of two)."""
    rng = np.random.default_rng(10 * rm + n)
    dm, layout, packed, valid = _sender_rows(rm, sym, n, rng)
    B, F, wp = valid.shape[1], dm.max_fanout, layout.packed_width
    S = B * F
    _, _, lanes = wave.cuda_model(dm, layout)
    want = wave.sender_megakernel_plain(
        dm, carry.words_in(packed), torch.from_numpy(valid), sym, layout,
        local_dedup)
    want = (carry.words_out(want[0]), carry.u64_out(want[1]),
            carry.u64_out(want[2]), want[3].numpy(), want[4].numpy())
    if local_dedup:  # shard 0 does not send its repeats; shard 1 sends
        # states shard 0 sends too
        assert want[4][0].sum() < want[3][0].sum()
        assert set(want[1][0][want[4][0]]) & set(want[1][1][want[4][1]])
    else:
        assert np.array_equal(want[4], want[3])
    outs = []
    for name, (o1, o2) in _orders(n * S, rm).items():
        s = _Scratch(n * S, n)
        succ = np.zeros((n, S, wp), np.uint32)
        dfps, pfps = np.zeros((n, S), np.uint64), np.zeros((n, S), np.uint64)
        sflat, send = np.zeros((n, S), np.bool_), np.zeros((n, S), np.bool_)
        fn = lib.sender_phases
        fn.restype = ctypes.c_longlong
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        rc = fn(i(rm), i(int(sym)), i(int(local_dedup)), p(_ptr(lanes)),
                i(layout.width), i(wp), p(_ptr(packed)), p(_ptr(valid)),
                ll(B), ll(n), i(F), p(_ptr(s.slots)), i(s.region_bits),
                p(_ptr(o1)), p(_ptr(o2)), p(_ptr(succ)), p(_ptr(dfps)),
                p(_ptr(pfps)), p(_ptr(sflat)), p(_ptr(send)))
        assert rc == 0, "the layout did not fit, or a tally was touched"
        got = (succ, dfps, pfps, sflat, send)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), name
        assert s.is_clean(), name
        outs.append(got)
    for a, b in zip(outs, outs[1:]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
