"""The kernels' device code, run on the CPU.

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
The wave and sender cases run 2pc (``csrc/models/twopc.cuh``) and paxos
(``csrc/models/paxos.cuh``, with sentinel lanes in its packed rows).
paxos's device step is also held to ``PaxosDevice.step`` on every slot
(successor and enabled bit) at 1 to 4 clients, on reachable rows (JAX's
levels, as ``test_torch_paxos.py`` makes them) and on seeded adversarial
rows (random lanes, garbage and empty envelopes, unsorted networks, fewer
network slots than the default); its ``representative`` to the port's;
and ``packing.cuh``'s codec to ``packing.py``, sentinel lanes included.
The tile loop's shared memory, barriers and stores run only on the card
(``chip_smoke.py``).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from stateright_tpu_torch import append, carry, table, wave
from stateright_tpu_torch.engine import (compaction_order, expand_frontier,
                                         fingerprint_successors,
                                         host_table_insert)
from stateright_tpu_torch.actor_device import EMPTY_ENV
from stateright_tpu_torch.hashing import SENTINEL_U64
from stateright_tpu_torch.models import paxos, twopc
from stateright_tpu_torch.packing import compile_layout

torch.set_num_threads(2)

CSRC = table.__file__.rsplit("/", 1)[0] + "/csrc"

SHIM = r"""
#pragma once
#include <algorithm>
#include <cstdint>
#include <type_traits>
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
#include "append.cuh"
#include "wave.cuh"
#include "models/paxos.cuh"
#include "models/twopc.cuh"

long long g_table_reads = 0;
const void* g_table_lo = nullptr;
const void* g_table_hi = nullptr;

using sr::u64;

namespace {

// Calls fn with a model instance: model 0 is 2pc at p0 RMs, model 1 paxos
// at p0 clients and p1 network slots. -1 for a model it does not hold.
template <class Fn>
long long with_model(int model, int p0, int p1, Fn&& fn) {
  if (model == 0) return fn(sr::TwoPhase<8>{p0});
  if (model == 1 && p1 >= 1) {
    switch (p0) {
      case 1:
        if (p1 <= sr::Paxos<1>::kMaxE) return fn(sr::Paxos<1>{p1});
        break;
      case 2:
        if (p1 <= sr::Paxos<2>::kMaxE) return fn(sr::Paxos<2>{p1});
        break;
      case 3:
        if (p1 <= sr::Paxos<3>::kMaxE) return fn(sr::Paxos<3>{p1});
        break;
      case 4:
        if (p1 <= sr::Paxos<4>::kMaxE) return fn(sr::Paxos<4>{p1});
        break;
    }
  }
  return -1;
}

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
template <class M>
long long wave_t(const M& m, int use_sym, const int* lanes, int w, int wp,
                 const uint32_t* vecs, const bool* valid, long long batch,
                 int fanout, u64* table, int c_bits, sr::Scratch s,
                 const long long* order1, const long long* order2,
                 uint32_t* succ, u64* path_fps, bool* sflat, bool* new_mask,
                 bool* cand_mask, int* counts, unsigned char* walked) {
  using Tile = sr::WaveTile<M, false>;
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
template <class M>
long long sender_t(const M& m, int use_sym, int local_dedup, const int* lanes,
                   int w, int wp, const uint32_t* vecs, const bool* valid,
                   long long batch, long long shards, int fanout,
                   sr::Slot* slots, int region_bits, const long long* order1,
                   const long long* order2, uint32_t* succ, u64* dedup_fps,
                   u64* path_fps, bool* sflat, bool* send_mask) {
  using Tile = sr::WaveTile<M, true>;
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
    int model, int p0, int p1, int use_sym, const int* lanes, int w, int wp,
    const uint32_t* vecs, const bool* valid, long long batch, int fanout,
    u64* table, int c_bits, sr::Slot* slots, int* tally, int m_bits,
    const long long* order1, const long long* order2, uint32_t* succ,
    u64* path_fps, bool* sflat, bool* new_mask, bool* cand_mask, int* counts,
    unsigned char* walked) {
  g_table_lo = table;
  g_table_hi = table + (1ll << c_bits);
  const sr::Scratch s{slots, tally, m_bits};
  return with_model(model, p0, p1, [&](const auto& m) {
    return wave_t(m, use_sym, lanes, w, wp, vecs, valid, batch, fanout,
                  table, c_bits, s, order1, order2, succ, path_fps, sflat,
                  new_mask, cand_mask, counts, walked);
  });
}

extern "C" long long sender_phases(
    int model, int p0, int p1, int use_sym, int local_dedup, const int* lanes,
    int w, int wp, const uint32_t* vecs, const bool* valid, long long batch,
    long long shards, int fanout, sr::Slot* slots, int region_bits,
    const long long* order1, const long long* order2, uint32_t* succ,
    u64* dedup_fps, u64* path_fps, bool* sflat, bool* send_mask) {
  return with_model(model, p0, p1, [&](const auto& m) {
    return sender_t(m, use_sym, local_dedup, lanes, w, wp, vecs, valid, batch,
                    shards, fanout, slots, region_bits, order1, order2, succ,
                    dedup_fps, path_fps, sflat, send_mask);
  });
}

// The append kernel's device code for every shard, a word then a row at a
// time, last first (the grid-stride loop's order does not matter). Returns
// the rows it appended.
extern "C" long long append_phases(
    int shards, long long rows, int div, int wp, long long arena_rows,
    const uint32_t* src_vecs, const u64* src_fps, const u64* src_par,
    const uint32_t* src_ebits, const long long* comp,
    const long long* new_count, const long long* tail, uint32_t* vecs,
    u64* fps, u64* par, uint32_t* ebits) {
  const sr::AppendArgs a{shards,  rows,      div,       wp,
                         arena_rows, src_vecs, src_fps,  src_par,
                         src_ebits, comp,      new_count, tail,
                         vecs,      fps,       par,       ebits};
  long long written = 0;
  for (int k = 0; k < shards; ++k) {
    const long long nc = sr::append_count(a, k);
    for (long long j = nc * wp - 1; j >= 0; --j)
      sr::append_word(a, k, j / wp, (int)(j % wp));
    for (long long i = nc - 1; i >= 0; --i) sr::append_row(a, k, i);
    written += nc;
  }
  return written;
}

// The model's step on every slot of n rows of w lanes: succ[n, F, w] and
// enabled[n, F]. -1 when w is not the model's width.
extern "C" long long model_step(int model, int p0, int p1,
                                const uint32_t* rows, long long n, int w,
                                uint32_t* succ, bool* enabled) {
  return with_model(model, p0, p1, [&](const auto& m) -> long long {
    using M = std::decay_t<decltype(m)>;
    if (w != m.width()) return -1;
    const int F = m.fanout();
    for (long long b = 0; b < n; ++b) {
      for (int f = 0; f < F; ++f) {
        uint32_t v[M::kMaxW] = {};
        for (int j = 0; j < w; ++j) v[j] = rows[b * w + j];
        enabled[b * F + f] = m.step(v, f);
        for (int j = 0; j < w; ++j) succ[(b * F + f) * w + j] = v[j];
      }
    }
    return 0;
  });
}

// The model's representative of n rows of w lanes, into out[n, w].
extern "C" long long model_representative(int model, int p0, int p1,
                                          const uint32_t* rows, long long n,
                                          int w, uint32_t* out) {
  return with_model(model, p0, p1, [&](const auto& m) -> long long {
    using M = std::decay_t<decltype(m)>;
    if (w != m.width()) return -1;
    for (long long b = 0; b < n; ++b) {
      uint32_t v[M::kMaxW] = {};
      for (int j = 0; j < w; ++j) v[j] = rows[b * w + j];
      m.representative(v);
      for (int j = 0; j < w; ++j) out[b * w + j] = v[j];
    }
    return 0;
  });
}

// The codec of the model's layout (lanes as the kernels take them): n rows
// of w lanes packed into wp words a row (pack != 0), or back.
extern "C" long long layout_codec(int model, int p0, int p1, int pack,
                                  const int* lanes, int w, int wp,
                                  const uint32_t* in, long long n,
                                  uint32_t* out) {
  return with_model(model, p0, p1, [&](const auto& m) -> long long {
    using M = std::decay_t<decltype(m)>;
    sr::Layout<M::kMaxW, M::kMaxWords> L;
    if (!sr::make_layout(m, lanes, w, wp, m.fanout(), &L)) return -1;
    for (long long b = 0; b < n; ++b) {
      uint32_t v[M::kMaxW] = {}, p[M::kMaxWords] = {};
      if (pack) {
        for (int j = 0; j < w; ++j) v[j] = in[b * w + j];
        sr::pack(L, v, p);
        for (int k = 0; k < wp; ++k) out[b * wp + k] = p[k];
      } else {
        for (int k = 0; k < wp; ++k) p[k] = in[b * wp + k];
        sr::unpack(L, p, v);
        for (int j = 0; j < w; ++j) out[b * w + j] = v[j];
      }
    }
    return 0;
  });
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


#: the harness's model codes, each model's system and device form, the
#: waves its frontier is taken after, and the bound of its garbage words
#: (paxos's reach the all-ones fields of its sentinel lanes)
_MODELS = {"twopc": (0, twopc.TwoPhaseSys, twopc.TwoPhaseDevice, 3, 1 << 20),
           "paxos": (1, paxos.PaxosSys, paxos.PaxosDevice, 6, 1 << 32)}


def _params(dm):
    """The harness's ``(model, p0, p1)`` of device model ``dm``."""
    if isinstance(dm, paxos.PaxosDevice):
        return 1, dm.C, dm.net_slots
    return 0, dm.rm_count, 0


def _frontier(model, size, sym, B, rng):
    """``B`` packed rows of a frontier a few waves in (with invalid rows
    and holes), its layout and a table of the states seen so far."""
    _, sys_cls, dm_cls, waves, garbage = _MODELS[model]
    dm = dm_cls(size)
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    capacity = 1 << 14
    t = torch.full((capacity,), -1, dtype=torch.int64)
    rows = [np.asarray(dm.encode(s), np.uint32)
            for s in sys_cls(size).init_states()]
    store = torch.from_numpy(layout.pack_np(np.stack(rows)).view(np.int32))
    for _ in range(waves):
        valid = torch.ones(store.shape[0], dtype=torch.bool)
        succ, _, _, new, *_ = wave.wave_megakernel_plain(
            dm, store, valid, t, sym, layout)
        store = succ[new][:B].contiguous()
    n = store.shape[0]
    packed = np.zeros((B, layout.packed_width), np.uint32)
    packed[:n] = carry.words_out(store)
    packed[n:] = rng.integers(0, garbage, (B - n, layout.packed_width))
    valid = np.arange(B) < n
    valid[rng.random(B) < 0.1] = False
    return dm, layout, packed, valid, carry.u64_out(t)


#: the wave and sender cases: 2pc at 3 to 5 RMs (the ids they had when
#: 2pc was the only model), paxos at 1 to 4 clients
_CASES = [pytest.param("twopc", rm, sym, id=f"{rm}-{sym}")
          for rm, sym in ((3, False), (4, False), (5, False), (3, True),
                          (5, True))]
_PAXOS_CASES = [pytest.param("paxos", c, sym, id=f"paxos{c}-{sym}")
                for c, sym in ((1, False), (2, False), (3, False),
                               (4, False), (4, True))]


@pytest.mark.parametrize("model, size, sym", _CASES + _PAXOS_CASES)
def test_wave_phases_match_the_plain_version(lib, model, size, sym):
    rng = np.random.default_rng(size)
    B = 48
    dm, layout, packed, valid, host = _frontier(model, size, sym, B, rng)
    F, wp = dm.max_fanout, layout.packed_width
    S = B * F
    _, _, lanes = wave.cuda_model(dm, layout)
    want = wave.wave_megakernel_plain(
        dm, carry.words_in(packed), torch.from_numpy(valid),
        t_p := carry.u64_in(host), sym, layout)
    outs = []
    for name, (o1, o2) in _orders(S, size).items():
        t = host.copy()
        s = _Scratch(S)
        succ = np.zeros((S, wp), np.uint32)
        pfps = np.zeros(S, np.uint64)
        sflat, new, cand = (np.zeros(S, np.bool_) for _ in range(3))
        counts, walked = np.full(3, -7, np.int32), np.zeros(S, np.uint8)
        fn = lib.wave_phases
        fn.restype = ctypes.c_longlong
        p = ctypes.c_void_p
        reads = fn(*[ctypes.c_int(a) for a in _params(dm)],
                   ctypes.c_int(int(sym)), p(_ptr(lanes)),
                   ctypes.c_int(layout.width), ctypes.c_int(wp),
                   p(_ptr(packed)), p(_ptr(valid)),
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


def _sender_rows(model, size, sym, n, rng):
    """``n`` shards' batches of a frontier: repeats within shard 0, and
    shard 1 starting with shard 0's rows (uint32[n, B, Wp], bool[n, B])."""
    B = 16
    dm, layout, packed, valid, _ = _frontier(model, size, sym, n * B, rng)
    packed = packed.reshape(n, B, -1)
    valid = valid.reshape(n, B)
    for k, part in ((0, slice(B // 2, None)), (1, slice(None, B // 2))):
        packed[k, part] = packed[0, :B // 2]
        valid[k, part] = valid[0, :B // 2]
    return dm, layout, np.ascontiguousarray(packed), valid


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("local_dedup", [True, False],
                         ids=["local_dedup", "no_local_dedup"])
@pytest.mark.parametrize("model, size, sym", _CASES + [
    c for c in _PAXOS_CASES if c.id in ("paxos1-False", "paxos2-False",
                                        "paxos4-True")])
def test_sender_phases_match_the_plain_version(lib, model, size, sym,
                                               local_dedup, n):
    """The sender kernel's per-slot work and pass 2 against
    ``sender_megakernel_plain``, bit for bit, in three arrival orders, in
    the engine's scratch for ``n`` shards (n = 3: regions in a scratch
    sized for a shard count that is not a power of two)."""
    rng = np.random.default_rng(10 * size + n)
    dm, layout, packed, valid = _sender_rows(model, size, sym, n, rng)
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
    for name, (o1, o2) in _orders(n * S, size).items():
        s = _Scratch(n * S, n)
        succ = np.zeros((n, S, wp), np.uint32)
        dfps, pfps = np.zeros((n, S), np.uint64), np.zeros((n, S), np.uint64)
        sflat, send = np.zeros((n, S), np.bool_), np.zeros((n, S), np.bool_)
        fn = lib.sender_phases
        fn.restype = ctypes.c_longlong
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        rc = fn(*[i(a) for a in _params(dm)], i(int(sym)),
                i(int(local_dedup)), p(_ptr(lanes)),
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


# -- paxos's device step, representative and sentinel packing ----------------


def _call(lib, name, *args):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_longlong
    return fn(*args)


def _device_step(lib, dm, rows):
    """``csrc/models/paxos.cuh``'s step on every slot of ``rows
    uint32[n, W]``: ``(succ uint32[n, F, W], enabled bool[n, F])``."""
    rows = np.ascontiguousarray(rows, np.uint32)
    n, w = rows.shape
    succ = np.zeros((n, dm.max_fanout, w), np.uint32)
    enabled = np.zeros((n, dm.max_fanout), np.bool_)
    rc = _call(lib, "model_step", *[ctypes.c_int(a) for a in _params(dm)],
               ctypes.c_void_p(_ptr(rows)), ctypes.c_longlong(n),
               ctypes.c_int(w), ctypes.c_void_p(_ptr(succ)),
               ctypes.c_void_p(_ptr(enabled)))
    assert rc == 0, "the row width is not the model's"
    return succ, enabled


def _device_representative(lib, dm, rows):
    rows = np.ascontiguousarray(rows, np.uint32)
    out = np.zeros_like(rows)
    rc = _call(lib, "model_representative",
               *[ctypes.c_int(a) for a in _params(dm)],
               ctypes.c_void_p(_ptr(rows)), ctypes.c_longlong(len(rows)),
               ctypes.c_int(rows.shape[1]), ctypes.c_void_p(_ptr(out)))
    assert rc == 0
    return out


def _adversarial(dm, n, rng):
    """Seeded rows no run reaches: random lanes (most of them small, so
    comparisons and table clamps go both ways), networks of random and
    empty envelopes built from random fields (every kind and destination,
    extra bits in and past their range), half of them unsorted."""
    w, off, e = dm.state_width, dm.net_offset, dm.net_slots
    rows = rng.integers(0, 1 << 32, (n, w), dtype=np.uint64)
    small = rng.random((n, w)) < 0.6
    rows[small] = rng.integers(0, 16, small.sum())
    env = (rng.integers(0, 8, (n, e)) | rng.integers(0, 8, (n, e)) << 3
           | rng.integers(0, 16, (n, e)) << 6
           | rng.integers(0, 8, (n, e)) << 10
           | rng.integers(0, 8, (n, e)) << 13
           | rng.integers(0, 1 << 12, (n, e)) << dm.extra_shift) & 0xFFFFFFFF
    narrow = rng.random((n, e)) < 0.5
    env[narrow] &= (1 << (dm.extra_shift + 7)) - 1
    net = rows[:, off:off + e]
    keep = rng.random((n, e)) < 0.3
    net[:] = np.where(keep, net, env)
    net[rng.random((n, e)) < 0.3] = EMPTY_ENV
    ordered = rng.random(n) < 0.5
    net[ordered] = np.sort(net[ordered], axis=1)
    return rows.astype(np.uint32)


@pytest.fixture(scope="module")
def reachable():
    """Rows JAX's paxos step reaches level by level from init, a seeded
    sample a level: every one at 1 client (265)."""
    from test_torch_paxos import _levels
    return {1: _levels(1, 64), 2: _levels(2, 14, cap=40),
            3: _levels(3, 12, cap=24, seed=3),
            4: _levels(4, 10, cap=24, seed=4)}


def _assert_step_equal(lib, dm, rows):
    succ, enabled = _device_step(lib, dm, rows)
    want, want_en = dm.step(carry.rows_in(rows))
    assert np.array_equal(enabled, want_en.numpy())
    assert np.array_equal(succ, carry.rows_out(want))
    return enabled


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_paxos_step_matches_the_port_on_reachable_rows(lib, reachable, c):
    """Every slot of every row, enabled or not: the successor's lanes and
    the enabled bit, bit for bit."""
    rows = reachable[c]
    enabled = _assert_step_equal(lib, paxos.PaxosDevice(c), rows)
    assert enabled.sum() > len(rows) and not enabled.all()


@pytest.mark.parametrize("c, net_slots", [(1, 0), (2, 0), (3, 0), (4, 0),
                                          (1, 2), (3, 7)])
def test_paxos_step_matches_the_port_on_adversarial_rows(lib, c, net_slots):
    """Garbage rows (the kernels expand every row of a batch, valid or
    not), at the default network size and at fewer slots (a runtime
    net_slots, and inserts into full lists)."""
    dm = paxos.PaxosDevice(c, net_slots=net_slots)
    rng = np.random.default_rng(100 + 10 * c + net_slots)
    rows = _adversarial(dm, 1500, rng)
    enabled = _assert_step_equal(lib, dm, rows)
    assert 0 < enabled.sum() < enabled.size
    overflow = _device_step(lib, dm, rows)[0][..., dm.error_lane]
    assert (overflow == 1).any()


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_paxos_representative_matches_the_port(lib, reachable, c):
    """The least row over the client permutations: the row itself below 4
    clients (a trivial group at 3 servers), clients 0 and 3 swapped where
    that is smaller at 4, on reachable and adversarial rows (which reach
    every clamp of the rewrite tables)."""
    dm = paxos.PaxosDevice(c)
    rng = np.random.default_rng(c)
    rows = np.concatenate([reachable[c], _adversarial(dm, 1000, rng),
                           rng.integers(0, 64, (500, dm.state_width))
                           ]).astype(np.uint32)
    got = _device_representative(lib, dm, rows)
    assert np.array_equal(got, carry.rows_out(
        dm.representative(carry.rows_in(rows))))
    assert (got != rows).any() == (c == 4)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_sentinel_packing_matches_packing_py(lib, c):
    """``packing.cuh``'s pack and unpack against ``packing.py`` on
    paxos's layout (every network lane a sentinel lane): lanes below, at
    and above their field's mask and the sentinel itself; words with
    all-ones fields."""
    dm = paxos.PaxosDevice(c)
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    w, wp = layout.width, layout.packed_width
    _, _, lanes = wave.cuda_model(dm, layout)
    rng = np.random.default_rng(c)
    n = 800
    rows = _adversarial(dm, n, rng).astype(np.int64)
    mask = np.array([lane.mask for lane in layout.lanes])
    pick = rng.integers(0, 4, (n, w))
    rows = np.where(pick == 0, np.minimum(mask, rows), rows)
    rows = np.where(pick == 1, mask + rng.integers(0, 3, (n, w)), rows)
    rows = np.where(pick == 2, mask - 1, rows)
    rows = np.minimum(rows, 0xFFFFFFFF).astype(np.uint32)
    sentinel = [j for j, lane in enumerate(layout.lanes)
                if lane.sentinel is not None]
    assert len(sentinel) == dm.net_slots
    rows[rng.random((n, w)) < 0.1] = EMPTY_ENV
    def codec(pack, src, out):
        assert _call(lib, "layout_codec",
                     *[ctypes.c_int(a) for a in _params(dm)],
                     ctypes.c_int(pack), ctypes.c_void_p(_ptr(lanes)),
                     ctypes.c_int(w), ctypes.c_int(wp),
                     ctypes.c_void_p(_ptr(src)), ctypes.c_longlong(n),
                     ctypes.c_void_p(_ptr(out))) == 0
        return out

    packed = codec(1, rows, np.zeros((n, wp), np.uint32))
    assert np.array_equal(packed, carry.words_out(
        layout.pack(carry.rows_in(rows))))
    words = rng.integers(0, 1 << 32, (n, wp), dtype=np.uint64).astype(
        np.uint32)
    words[::3] = 0xFFFFFFFF
    words[1::3] = packed[1::3]
    unpacked = codec(0, words, np.zeros((n, w), np.uint32))
    want = carry.rows_out(layout.unpack(carry.words_in(words)))
    assert np.array_equal(unpacked, want)
    assert (want[:, sentinel] == EMPTY_ENV).any()
    assert (want[:, sentinel] != EMPTY_ENV).any()


# -- The append kernel -------------------------------------------------------


@pytest.mark.parametrize("case", [
    # shards, source rows a shard, rows a parent, packed words, arena rows
    # a shard (the dump row last), each shard's tail and new rows
    ("none new", 1, 60, 12, 3, 128, [40], [0]),
    ("ragged", 1, 60, 12, 3, 128, [40], [23]),
    ("every row new", 1, 60, 12, 3, 128, [67], [60]),
    ("sharded, unequal tails", 3, 90, 1, 20, 160, [0, 57, 69], [31, 90, 0]),
    ("rows onto the dump row", 2, 30, 1, 2, 64, [34, 5], [30, 7])])
def test_append_matches_the_plain_version(lib, case):
    """``append.cuh``'s device code against ``append_rows_plain``: arena
    rows ``[0, tail + new_count)`` of every shard equal bit for bit in all
    four arrays, and no other row written (the dump row included), except
    where the rows would pass the arena: there nothing is."""
    tag, n, rows, div, wp, U, tails, counts = case
    rng = np.random.default_rng(len(tag))

    def words(shape):
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(
            np.uint32)

    def keys(shape):
        return rng.integers(0, 1 << 64, shape, dtype=np.uint64)

    src = (words((n, rows, wp)), keys((n, rows)), keys((n, rows // div)),
           words((n, rows // div)))
    mask = np.zeros((n, rows), bool)
    for k, c in enumerate(counts):
        mask[k, rng.choice(rows, c, replace=False)] = True
    comp = compaction_order(torch.from_numpy(mask)).numpy()
    new_count = mask.sum(1).astype(np.int64)
    tail = np.array(tails, np.int64)
    arena = (words((n, U, wp)), keys((n, U)), keys((n, U)), words((n, U)))
    got = tuple(a.copy() for a in arena)
    written = _call(lib, "append_phases", ctypes.c_int(n),
                    ctypes.c_longlong(rows), ctypes.c_int(div),
                    ctypes.c_int(wp), ctypes.c_longlong(U),
                    *[ctypes.c_void_p(_ptr(a)) for a in (
                        *src, comp, new_count, tail, *got)])
    # A shard whose rows would pass the arena appends none.
    fits = tail + new_count <= U - 1
    assert written == int((new_count * fits).sum())

    def tensor(a):
        return torch.from_numpy(
            a.view(np.int64 if a.dtype == np.uint64 else np.int32).copy())

    want = tuple(tensor(a) for a in arena)
    append.append_rows(want, tuple(tensor(a) for a in src),
                       torch.from_numpy(comp),
                       torch.from_numpy(np.where(fits, new_count, 0)),
                       torch.from_numpy(tail), div)
    for k in range(n):
        end = int(tail[k] + new_count[k]) if fits[k] else 0
        for g, w, a in zip(got, want, arena):
            assert np.array_equal(g[k, :end], w[k, :end].numpy().view(
                g.dtype)), (tag, k)
            assert np.array_equal(g[k, end:], a[k, end:]), (tag, k)
