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
The wave and sender cases run 2pc (``csrc/models/twopc.cuh``), paxos
(``csrc/models/paxos.cuh``, with sentinel lanes in its packed rows),
single-copy and ABD (``single_copy.cuh``, ``abd.cuh``), the register
workloads on ``csrc/models/register_workload.cuh``. Their device steps
are also held to the port's ``step`` on every slot (successor and
enabled bit): paxos at 1 to 4 clients, single-copy at 1 to 4 clients on
one server and 2 on two, ABD at 2 clients on two and three servers, on
reachable rows (JAX's levels, as ``test_torch_paxos.py`` and
``test_torch_registers.py`` make them) and on seeded adversarial rows
(random lanes, garbage and empty envelopes, unsorted networks, fewer
network slots than the default); their ``representative`` to the
port's; and ``packing.cuh``'s codec to ``packing.py``, sentinel lanes
included. The plan form of the step (``plan.cuh``'s ``PlanStep``, the
harness's models 100 + m under ``set_plan``) is held to the torch
``matmul_wave.matmul_expand`` on every slot of random in-domain rows of
2pc and the shared counters, and the tile loop's per-slot steps with it
to the kernels' plain versions under the plan.
The tile loop's shared memory, barriers and stores run only on the card
(``chip_smoke.py``).
"""

import ctypes
import random
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from stateright_tpu_torch import (append, carry, matmul_wave, table,
                                  test_util, wave)
from stateright_tpu_torch.engine import (compaction_order, expand_frontier,
                                         fingerprint_successors,
                                         host_table_insert)
from stateright_tpu_torch.actor_device import EMPTY_ENV
from stateright_tpu_torch.hashing import SENTINEL_U64
from stateright_tpu_torch.models import (abd, increment, increment_lock,
                                         paxos, pingpong, single_copy,
                                         sliding_puzzle, twopc, vsr)
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
template <class T> T __ldg(const T* p) { return *p; }
using std::max;
using std::min;
"""

HARNESS = r"""
#include <vector>
#include "append.cuh"
#include "plan.cuh"
#include "wave.cuh"
#include "models/abd.cuh"
#include "models/dgraph.cuh"
#include "models/increment.cuh"
#include "models/increment_lock.cuh"
#include "models/linear_equation.cuh"
#include "models/paxos.cuh"
#include "models/pingpong.cuh"
#include "models/single_copy.cuh"
#include "models/sliding_puzzle.cuh"
#include "models/twopc.cuh"
#include "models/vsr.cuh"

long long g_table_reads = 0;
const void* g_table_lo = nullptr;
const void* g_table_hi = nullptr;

using sr::u64;

namespace {

// Calls fn with register workload M<kC, kS> at net_slots e, -1 when e is
// not in 1..kMaxE.
template <int kC, int kS, template <int, int> class M, class Fn>
long long with_register(int e, Fn&& fn) {
  if (e < 1 || e > M<kC, kS>::kMaxE) return -1;
  return fn(M<kC, kS>{e});
}

// The graph that model 5 runs (set_dgraph).
sr::DGraph g_dgraph;

// The matmul plan that model 100 + m runs (set_plan): the host array and
// the tables, as the plan-form entry points take them.
const int* g_plan = nullptr;
const uint32_t* g_plan_tables = nullptr;

template <class Fn>
long long with_model_step(int model, int p0, int p1, int p2, Fn&& fn);

// Calls fn with a model instance: model 0 is 2pc at p0 RMs, model 1 paxos
// at p0 clients and p1 network slots, model 2 single-copy and model 3 ABD
// at p0 clients, p2 servers and p1 network slots, model 4 LinearEquation,
// model 5 the DGraph of the last set_dgraph, model 6 increment and model 7
// increment_lock at p0 threads, model 8 the p0 x p1 sliding puzzle (each
// at the sizes its entry point instantiates); model 9 ping-pong at max_nat
// p0 and p1 network slots, its form in p2's bits (history 1, lossy 2,
// duplicating 4); model 10 VSR at p0 replicas and p1 network slots, p2's
// bits lossy 1 and duplicating 2 and max_view above them (the instances of
// wave_pingpong.cu and wave_vsr.cu). Model 100 + m is model m with its
// step replaced by the plan of the last set_plan (plan.cuh's PlanStep), -2
// when that plan does not load. -1 for a model it does not hold.
template <class Fn>
long long with_model(int model, int p0, int p1, int p2, Fn&& fn) {
  if (model < 100) return with_model_step(model, p0, p1, p2, fn);
  return with_model_step(model - 100, p0, p1, p2,
                         [&](const auto& m) -> long long {
    using M = std::decay_t<decltype(m)>;
    static sr::PlanStep<M> p;
    if (!p.load(m, g_plan, g_plan_tables)) return -2;
    return fn(p);
  });
}

template <class Fn>
long long with_model_step(int model, int p0, int p1, int p2, Fn&& fn) {
  if (model == 0) return fn(sr::TwoPhase<8>{p0});
  if (model == 9 && p1 >= 1 && p1 <= sr::PingPong<26>::kMaxE)
    return fn(sr::PingPong<26>{p1, (p2 & 1) != 0, (p2 & 2) != 0,
                               (p2 & 4) != 0, (uint32_t)p0});
  if (model == 10 && p1 >= 1) {
    const bool l = (p2 & 1) != 0, d = (p2 & 2) != 0;
    const uint32_t mv = (uint32_t)(p2 >> 2);
    if (p0 == 2 && p1 <= 16) return fn(sr::Vsr<2, 16>{p1, l, d, mv});
    if (p0 == 3 && p1 <= 40) return fn(sr::Vsr<3, 40>{p1, l, d, mv});
    if (p0 == 4 && p1 <= 48) return fn(sr::Vsr<4, 48>{p1, l, d, mv});
  }
  if (model == 4) return fn(sr::LinearEquation{});
  if (model == 5) return fn(g_dgraph);
  if (model == 6) {
    if (p0 == 2) return fn(sr::Increment<2>{});
    if (p0 == 4) return fn(sr::Increment<4>{});
    if (p0 == 8) return fn(sr::Increment<8>{});
    if (p0 == 16) return fn(sr::Increment<16>{});
  }
  if (model == 7) {
    if (p0 == 2) return fn(sr::IncrementLock<2>{});
    if (p0 == 4) return fn(sr::IncrementLock<4>{});
    if (p0 == 8) return fn(sr::IncrementLock<8>{});
  }
  if (model == 8) {
    const int k = p0 * 10 + p1;
    if (k == 23) return fn(sr::SlidingPuzzle<2, 3>{});
    if (k == 33) return fn(sr::SlidingPuzzle<3, 3>{});
    if (k == 43) return fn(sr::SlidingPuzzle<4, 3>{});
  }
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
  if (model == 2) {
    const int k = p0 * 10 + p2;
    if (k == 11) return with_register<1, 1, sr::SingleCopy>(p1, fn);
    if (k == 21) return with_register<2, 1, sr::SingleCopy>(p1, fn);
    if (k == 31) return with_register<3, 1, sr::SingleCopy>(p1, fn);
    if (k == 41) return with_register<4, 1, sr::SingleCopy>(p1, fn);
    if (k == 22) return with_register<2, 2, sr::SingleCopy>(p1, fn);
    if (k == 32) return with_register<3, 2, sr::SingleCopy>(p1, fn);
  }
  if (model == 3) {
    const int k = p0 * 10 + p2;
    if (k == 11) return with_register<1, 1, sr::Abd>(p1, fn);
    if (k == 22) return with_register<2, 2, sr::Abd>(p1, fn);
    if (k == 23) return with_register<2, 3, sr::Abd>(p1, fn);
    if (k == 33) return with_register<3, 3, sr::Abd>(p1, fn);
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

// Loads model 5's graph from a DGraph entry point's host table; 0 on
// success, -1 when it does not fit.
extern "C" long long set_dgraph(const int* table) {
  return g_dgraph.load(table) ? 0 : -1;
}

// Sets the plan models 100 + m run: the host array (wave.py::plan_host)
// and the tables (wave.py::plan_tables), read at each call.
extern "C" long long set_plan(const int* plan, const uint32_t* tables) {
  g_plan = plan;
  g_plan_tables = tables;
  return 0;
}

// The bytes of the plan a kernel's parameters carry (plan.cuh's Plan).
extern "C" long long plan_param_bytes() { return sizeof(sr::Plan); }

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
    int model, int p0, int p1, int p2, int use_sym, const int* lanes, int w,
    int wp, const uint32_t* vecs, const bool* valid, long long batch,
    int fanout,
    u64* table, int c_bits, sr::Slot* slots, int* tally, int m_bits,
    const long long* order1, const long long* order2, uint32_t* succ,
    u64* path_fps, bool* sflat, bool* new_mask, bool* cand_mask, int* counts,
    unsigned char* walked) {
  g_table_lo = table;
  g_table_hi = table + (1ll << c_bits);
  const sr::Scratch s{slots, tally, m_bits};
  return with_model(model, p0, p1, p2, [&](const auto& m) {
    return wave_t(m, use_sym, lanes, w, wp, vecs, valid, batch, fanout,
                  table, c_bits, s, order1, order2, succ, path_fps, sflat,
                  new_mask, cand_mask, counts, walked);
  });
}

extern "C" long long sender_phases(
    int model, int p0, int p1, int p2, int use_sym, int local_dedup,
    const int* lanes, int w, int wp, const uint32_t* vecs, const bool* valid,
    long long batch, long long shards, int fanout, sr::Slot* slots,
    int region_bits,
    const long long* order1, const long long* order2, uint32_t* succ,
    u64* dedup_fps, u64* path_fps, bool* sflat, bool* send_mask) {
  return with_model(model, p0, p1, p2, [&](const auto& m) {
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
extern "C" long long model_step(int model, int p0, int p1, int p2,
                                const uint32_t* rows, long long n, int w,
                                uint32_t* succ, bool* enabled) {
  return with_model(model, p0, p1, p2, [&](const auto& m) -> long long {
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
extern "C" long long model_representative(int model, int p0, int p1, int p2,
                                          const uint32_t* rows, long long n,
                                          int w, uint32_t* out) {
  return with_model(model, p0, p1, p2, [&](const auto& m) -> long long {
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
extern "C" long long layout_codec(int model, int p0, int p1, int p2,
                                  int pack, const int* lanes, int w, int wp,
                                  const uint32_t* in, long long n,
                                  uint32_t* out) {
  return with_model(model, p0, p1, p2, [&](const auto& m) -> long long {
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
           "paxos": (1, paxos.PaxosSys, paxos.PaxosDevice, 6, 1 << 32),
           "single_copy": (2, single_copy.SingleCopySys,
                           lambda c: single_copy.SingleCopyDevice(c, 1), 4,
                           1 << 32),
           "abd": (3, abd.AbdSys, abd.AbdDevice, 6, 1 << 32),
           "linear_equation": (4, lambda abc: test_util.LinearEquation(*abc),
                               lambda abc: test_util.LinearEquation(
                                   *abc).device_model(), 12, 1 << 32),
           "dgraph": (5, lambda seed: _graph(seed),
                      lambda seed: _graph(seed).device_model(), 0, 12),
           "increment": (6, increment.IncrementModel,
                         increment.IncrementDevice, 3, 1 << 32),
           "increment_lock": (7, increment_lock.IncrementLockModel,
                              increment_lock.IncrementLockDevice, 6,
                              1 << 32),
           "puzzle": (8, lambda rc: sliding_puzzle.SlidingPuzzle(*rc),
                      lambda rc: sliding_puzzle.PuzzleDevice(*rc), 8,
                      1 << 32),
           "pingpong": (9, lambda m: pingpong.PingPongSys(m, lossy=True),
                        lambda m: pingpong.PingPongDevice(m, lossy=True), 8,
                        1 << 32),
           "vsr": (10, lambda n: vsr.VsrSys(n, 1),
                   lambda n: vsr.VsrDevice(n, 1), 6, 1 << 32)}


def _graph(seed):
    """A random graph of the differential fuzz, with a placeholder
    property."""
    return test_util.random_graph(random.Random(seed), "p",
                                  lambda rows: rows[:, 0] < 0)


def _params(lib, dm):
    """The harness's ``(model, p0, p1, p2)`` of device model ``dm`` (a
    DGraph's table loaded into the harness first)."""
    if isinstance(dm, test_util.DGraphDevice):
        _, (graph,) = dm.cuda_model()
        assert _call(lib, "set_dgraph", ctypes.c_void_p(_ptr(graph))) == 0
        return 5, 0, 0, 0
    if isinstance(dm, test_util.LinearEquationDevice):
        return 4, 0, 0, 0
    if isinstance(dm, increment.IncrementDevice):
        return 6, dm.thread_count, 0, 0
    if isinstance(dm, increment_lock.IncrementLockDevice):
        return 7, dm.thread_count, 0, 0
    if isinstance(dm, sliding_puzzle.PuzzleDevice):
        return 8, dm.rows, dm.cols, 0
    if isinstance(dm, pingpong.PingPongDevice):
        return 9, dm.max_nat, dm.net_slots, (
            dm.maintains_history | dm.lossy << 1 | dm.duplicating << 2)
    if isinstance(dm, vsr.VsrDevice):
        return 10, dm.n, dm.net_slots, (
            dm.lossy | dm.duplicating << 1 | dm.max_view << 2)
    if isinstance(dm, paxos.PaxosDevice):
        return 1, dm.C, dm.net_slots, 0
    if isinstance(dm, single_copy.SingleCopyDevice):
        return 2, dm.C, dm.net_slots, dm.S
    if isinstance(dm, abd.AbdDevice):
        return 3, dm.C, dm.net_slots, dm.S
    return 0, dm.rm_count, 0, 0


def _seed(size):
    """A seed from a model's size (an int, or a tuple of them)."""
    return size if isinstance(size, int) else sum(size)


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
#: single-copy at 3 and 4 clients on one server, ABD at 2 clients on two
_REGISTER_CASES = [pytest.param(m, c, sym, id=f"{m}{c}-{sym}")
                   for m, c, sym in (("single_copy", 3, False),
                                     ("single_copy", 4, True),
                                     ("abd", 2, False))]
#: the plain device models: the fixtures, the shared counters (threads)
#: and the puzzle (its board)
_PLAIN_CASES = [pytest.param(m, size, sym, id=f"{m}{size}-{sym}")
                for m, size, sym in (
                    ("linear_equation", (2, 4, 7), False),
                    ("dgraph", 1000, False), ("dgraph", 1003, False),
                    ("increment", 4, False), ("increment", 8, True),
                    ("increment_lock", 4, True), ("increment_lock", 8, False),
                    ("puzzle", (2, 3), False), ("puzzle", (4, 3), False))]
#: the actor models on actor_net.cuh: ping-pong lossy and duplicating, VSR
#: at 2 to 4 replicas (its rows of 34, 50 and 66 lanes and its timers)
_ACTOR_CASES = [pytest.param(m, size, False, id=f"{m}{size}")
                for m, size in (("pingpong", 5), ("vsr", 2), ("vsr", 3),
                                ("vsr", 4))]


@pytest.mark.parametrize("model, size, sym", _CASES + _PAXOS_CASES
                         + _REGISTER_CASES + _PLAIN_CASES + _ACTOR_CASES)
def test_wave_phases_match_the_plain_version(lib, model, size, sym):
    rng = np.random.default_rng(_seed(size))
    B = 48
    dm, layout, packed, valid, host = _frontier(model, size, sym, B, rng)
    F, wp = dm.max_fanout, layout.packed_width
    S = B * F
    _, _, lanes = wave.cuda_model(dm, layout)
    want = wave.wave_megakernel_plain(
        dm, carry.words_in(packed), torch.from_numpy(valid),
        t_p := carry.u64_in(host), sym, layout)
    outs = []
    for name, (o1, o2) in _orders(S, _seed(size)).items():
        t = host.copy()
        s = _Scratch(S)
        succ = np.zeros((S, wp), np.uint32)
        pfps = np.zeros(S, np.uint64)
        sflat, new, cand = (np.zeros(S, np.bool_) for _ in range(3))
        counts, walked = np.full(3, -7, np.int32), np.zeros(S, np.uint8)
        fn = lib.wave_phases
        fn.restype = ctypes.c_longlong
        p = ctypes.c_void_p
        reads = fn(*[ctypes.c_int(a) for a in _params(lib, dm)],
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
    c for c in _PAXOS_CASES + _REGISTER_CASES
    if c.id in ("paxos1-False", "paxos2-False", "paxos4-True",
                "single_copy4-True", "abd2-False")] + _PLAIN_CASES
    + _ACTOR_CASES[:2])
def test_sender_phases_match_the_plain_version(lib, model, size, sym,
                                               local_dedup, n):
    """The sender kernel's per-slot work and pass 2 against
    ``sender_megakernel_plain``, bit for bit, in three arrival orders, in
    the engine's scratch for ``n`` shards (n = 3: regions in a scratch
    sized for a shard count that is not a power of two)."""
    rng = np.random.default_rng(10 * _seed(size) + n)
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
    for name, (o1, o2) in _orders(n * S, _seed(size)).items():
        s = _Scratch(n * S, n)
        succ = np.zeros((n, S, wp), np.uint32)
        dfps, pfps = np.zeros((n, S), np.uint64), np.zeros((n, S), np.uint64)
        sflat, send = np.zeros((n, S), np.bool_), np.zeros((n, S), np.bool_)
        fn = lib.sender_phases
        fn.restype = ctypes.c_longlong
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        rc = fn(*[i(a) for a in _params(lib, dm)], i(int(sym)),
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
    rc = _call(lib, "model_step", *[ctypes.c_int(a) for a in _params(lib, dm)],
               ctypes.c_void_p(_ptr(rows)), ctypes.c_longlong(n),
               ctypes.c_int(w), ctypes.c_void_p(_ptr(succ)),
               ctypes.c_void_p(_ptr(enabled)))
    assert rc == 0, "the row width is not the model's"
    return succ, enabled


def _device_representative(lib, dm, rows):
    rows = np.ascontiguousarray(rows, np.uint32)
    out = np.zeros_like(rows)
    rc = _call(lib, "model_representative",
               *[ctypes.c_int(a) for a in _params(lib, dm)],
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
                     *[ctypes.c_int(a) for a in _params(lib, dm)],
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


# -- The register corpus's device steps and representatives -----------------


@pytest.fixture(scope="module")
def register_rows():
    """Rows JAX's single-copy and ABD steps reach level by level from
    init, a seeded sample a level (``test_torch_registers.py``'s
    ``_levels``): every one of single-copy 2/1 (93) and ABD 2/2 (544)."""
    from test_torch_registers import MODELS, _levels
    sc, ab = MODELS["single_copy"][0], MODELS["abd"][0]
    return {(single_copy.SingleCopyDevice, 1, 1): _levels(sc(1, 1)),
            (single_copy.SingleCopyDevice, 2, 1): _levels(sc(2, 1)),
            (single_copy.SingleCopyDevice, 3, 1): _levels(sc(3, 1), cap=60,
                                                          seed=3),
            (single_copy.SingleCopyDevice, 4, 1): _levels(sc(4, 1), cap=40,
                                                          seed=4),
            (single_copy.SingleCopyDevice, 2, 2): _levels(sc(2, 2)),
            (abd.AbdDevice, 2, 2): _levels(ab(2, 2)),
            (abd.AbdDevice, 2, 3): _levels(ab(2, 3), levels=14, cap=40,
                                           seed=5)}


_REGISTER_MODELS = [(single_copy.SingleCopyDevice, c, s)
                    for c, s in ((1, 1), (2, 1), (3, 1), (4, 1), (2, 2))] + [
    (abd.AbdDevice, 2, 2), (abd.AbdDevice, 2, 3)]


def _register_id(key):
    return f"{key[0].__name__}-{key[1]}-{key[2]}"


@pytest.mark.parametrize("key", _REGISTER_MODELS, ids=_register_id)
def test_register_step_matches_the_port_on_reachable_rows(lib, register_rows,
                                                          key):
    """``register_workload.cuh``'s step on each model's server policy
    (``single_copy.cuh``, ``abd.cuh``), every slot of every row, enabled
    or not, on reachable rows and on rows near them (``_perturbed``,
    which reach the deeper branches): the successor's lanes and the
    enabled bit, bit for bit."""
    from test_torch_registers import _perturbed
    rows = register_rows[key]
    dm = key[0](key[1], key[2])
    enabled = _assert_step_equal(lib, dm, rows)
    assert enabled.sum() >= len(rows) - 1 and not enabled.all()
    rng = np.random.default_rng(7 * key[1] + key[2])
    _assert_step_equal(lib, dm, _perturbed(rows, dm, 600, rng))


@pytest.mark.parametrize("key, net_slots", [
    ((single_copy.SingleCopyDevice, 4, 1), 0),
    ((single_copy.SingleCopyDevice, 2, 2), 0),
    ((single_copy.SingleCopyDevice, 3, 1), 4),
    ((abd.AbdDevice, 2, 2), 0), ((abd.AbdDevice, 2, 3), 0),
    ((abd.AbdDevice, 2, 2), 3)],
    ids=lambda k: _register_id(k) if isinstance(k, tuple) else str(k))
def test_register_step_matches_the_port_on_adversarial_rows(lib, key,
                                                            net_slots):
    """Garbage rows (garbage envelopes, unsorted networks, lanes past
    their ranges), at the default network size and at fewer slots (a
    runtime net_slots, and inserts into full lists)."""
    dm = key[0](key[1], key[2], net_slots=net_slots)
    rng = np.random.default_rng(200 + 10 * key[1] + net_slots)
    rows = _adversarial(dm, 1500, rng)
    enabled = _assert_step_equal(lib, dm, rows)
    assert 0 < enabled.sum() < enabled.size
    overflow = _device_step(lib, dm, rows)[0][..., dm.error_lane]
    assert (overflow == 1).any()


@pytest.mark.parametrize("key", _REGISTER_MODELS, ids=_register_id)
def test_register_representative_matches_the_port(lib, register_rows, key):
    """The least row over the client permutations, walked in the kernel as
    Lehmer codes with the running least held as its permutation and its
    sorted network: the whole symmetric group at one server (23
    permutations at 4 clients), the row itself where each client has its
    own residue class (single-copy 2/2, ABD); on reachable and
    adversarial rows, which reach the value map's clamp."""
    dm = key[0](key[1], key[2])
    rng = np.random.default_rng(key[1] + 10 * key[2])
    rows = np.concatenate([register_rows[key], _adversarial(dm, 600, rng),
                           rng.integers(0, 8, (300, dm.state_width))
                           ]).astype(np.uint32)
    got = _device_representative(lib, dm, rows)
    want = dm.representative(carry.rows_in(rows))
    assert np.array_equal(got, carry.rows_out(want))
    assert (got != rows).any() == (key[2] == 1 and key[1] > 1)


# -- The plain device models' steps and representatives ----------------------


#: every instantiated size of the plain device models (two random graphs
#: of the differential fuzz), with the system that gives its init states
_PLAIN_MODELS = (
    [(test_util.LinearEquation(2, 4, 7), "linear_equation"),
     (_graph(1000), "dgraph 1000"), (_graph(1003), "dgraph 1003")]
    + [(increment.IncrementModel(t), f"increment {t}")
       for t in increment.IncrementDevice.CUDA_INSTANCES]
    + [(increment_lock.IncrementLockModel(t), f"increment_lock {t}")
       for t in increment_lock.IncrementLockDevice.CUDA_INSTANCES]
    + [(sliding_puzzle.SlidingPuzzle(r, c), f"puzzle {r}x{c}")
       for r, c in sliding_puzzle.PuzzleDevice.CUDA_INSTANCES])


def _plain_rows(model, rng, levels=12, cap=64, n_adv=400):
    """Rows the port's step reaches level by level from ``model``'s init
    (a seeded sample of at most ``cap`` a level), then seeded adversarial
    rows: lanes of every size, most of them small (pcs, cells and node ids
    on both sides of their ranges), some at the top of the uint32 range
    (so that the increments wrap)."""
    dm = model.device_model()
    rows = np.stack([dm.encode(s) for s in model.init_states()])
    seen, out = {r.tobytes() for r in rows}, [rows]
    for _ in range(levels):
        succ, valid = dm.step(carry.rows_in(rows))
        nxt = []
        for r in carry.rows_out(succ)[valid.numpy()]:
            if r.tobytes() not in seen:
                seen.add(r.tobytes())
                nxt.append(r)
        if not nxt:
            break
        rows = np.stack(nxt)
        if len(rows) > cap:
            rows = rows[np.sort(rng.choice(len(rows), cap, replace=False))]
        out.append(rows)
    w = dm.state_width
    adv = rng.integers(0, 1 << 32, (n_adv, w), dtype=np.uint64)
    small = rng.random((n_adv, w)) < 0.7
    adv[small] = rng.integers(0, 14, small.sum())
    top = rng.random((n_adv, w)) < 0.05
    adv[top] = 0xFFFFFFFF - rng.integers(0, 3, top.sum())
    return np.concatenate(out + [adv.astype(np.uint32)])


@pytest.mark.parametrize("model, tag", _PLAIN_MODELS,
                         ids=[tag for _, tag in _PLAIN_MODELS])
def test_plain_model_step_matches_the_port(lib, model, tag):
    """Each model's ``.cuh`` step on every slot of reachable and
    adversarial rows, at every size its entry point instantiates: the
    successor's lanes and the enabled bit, bit for bit, against the port's
    torch step."""
    dm = model.device_model()
    rows = _plain_rows(model, np.random.default_rng(len(tag)))
    enabled = _assert_step_equal(lib, dm, rows)
    assert enabled.any()
    assert enabled.all() == (tag == "linear_equation")


@pytest.mark.parametrize("model, tag", _PLAIN_MODELS,
                         ids=[tag for _, tag in _PLAIN_MODELS])
def test_plain_model_representative_matches_the_port(lib, model, tag):
    """The shared counters' thread sort (``thread_sort.cuh``: stable, on
    uint32 keys) against the port's, on reachable and adversarial rows
    (pcs past the key's span and keys that wrap: equal keys of unequal
    pairs); the models without symmetry leave a row as it is."""
    dm = model.device_model()
    rows = _plain_rows(model, np.random.default_rng(7 + len(tag)))
    got = _device_representative(lib, dm, rows)
    want = dm.representative(carry.rows_in(rows))
    if want is None:
        assert np.array_equal(got, rows)
    else:
        assert np.array_equal(got, carry.rows_out(want))
        assert (got != rows).any()


@pytest.mark.parametrize("model, tag", [m for m in _PLAIN_MODELS
                                        if "increment" in m[1]],
                         ids=[tag for _, tag in _PLAIN_MODELS
                              if "increment" in tag])
def test_plain_model_packing_matches_packing_py(lib, model, tag):
    """``packing.cuh``'s pack and unpack on the shared counters' packed
    layouts (their ``lane_bits``) against ``packing.py``: lanes past their
    widths truncated alike, every word pattern unpacked alike."""
    dm = model.device_model()
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    w, wp = layout.width, layout.packed_width
    _, _, lanes = wave.cuda_model(dm, layout)
    rng = np.random.default_rng(len(tag))
    rows = _plain_rows(model, rng)
    n = len(rows)

    def codec(pack, src, out):
        assert _call(lib, "layout_codec",
                     *[ctypes.c_int(a) for a in _params(lib, dm)],
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
    unpacked = codec(0, words, np.zeros((n, w), np.uint32))
    assert np.array_equal(unpacked, carry.rows_out(
        layout.unpack(carry.words_in(words))))


# -- The append kernel -------------------------------------------------------


# -- The actor models' device steps on actor_net.cuh ------------------------


def _actor_rows(model, rng, levels=24, cap=48, n_adv=600):
    """Rows the port's step reaches level by level from ``model``'s init
    inside its boundary (a seeded sample of at most ``cap`` a level), then
    seeded adversarial rows: lanes of every size (most of them small, so
    that counts, views, statuses and masks compare both ways; some at the
    top of the uint32 range, so that they wrap) and networks of envelopes
    of random fields (every kind, and destinations past the replicas),
    garbage and empty ones, half of them sorted."""
    dm = model.device_model()
    w, off, e = dm.state_width, dm.net_offset, dm.net_slots
    rows = np.stack([dm.encode(s) for s in model.init_states()])
    seen, out = {r.tobytes() for r in rows}, [rows]
    for _ in range(levels):
        succ, valid = dm.step(carry.rows_in(rows))
        flat = succ.reshape(-1, w)
        keep = (valid.reshape(-1) & dm.boundary(flat)).numpy()
        nxt = []
        for r in carry.rows_out(flat)[keep]:
            if r.tobytes() not in seen:
                seen.add(r.tobytes())
                nxt.append(r)
        if not nxt:
            break
        rows = np.stack(nxt)
        if len(rows) > cap:
            rows = rows[np.sort(rng.choice(len(rows), cap, replace=False))]
        out.append(rows)
    adv = rng.integers(0, 1 << 32, (n_adv, w), dtype=np.uint64)
    small = rng.random((n_adv, w)) < 0.7
    adv[small] = rng.integers(0, 6, small.sum())
    top = rng.random((n_adv, w)) < 0.05
    adv[top] = 0xFFFFFFFF - rng.integers(0, 3, top.sum())
    env = rng.integers(0, 1 << 15, (n_adv, e), dtype=np.uint64)
    wide = rng.random((n_adv, e)) < 0.1
    env[wide] = rng.integers(0, 1 << 32, wide.sum(), dtype=np.uint64)
    env[rng.random((n_adv, e)) < 0.3] = EMPTY_ENV
    ordered = rng.random(n_adv) < 0.5
    env[ordered] = np.sort(env[ordered], axis=1)
    adv[:, off:off + e] = env
    return np.concatenate(out + [adv.astype(np.uint32)])


#: ping-pong in each of its eight forms (history, lossy, duplicating) at
#: the default 16 slots, at the instance's 26 and at 3 (whose inserts
#: overflow); VSR at 2 to 4 replicas at the default 8n slots and at the
#: instances' most, each network form at 2, and 3 slots at 3 (overflow)
_ACTOR_MODELS = (
    [pingpong.PingPongSys(3, h, lossy=l, duplicating=d)
     for h in (False, True) for l in (False, True) for d in (False, True)]
    + [pingpong.PingPongSys(5, lossy=True, net_slots=26),
       pingpong.PingPongSys(5, lossy=True, net_slots=3)]
    + [vsr.VsrSys(2, 1, lossy=l, duplicating=d)
       for l in (False, True) for d in (True, False)]
    + [vsr.VsrSys(3, 1), vsr.VsrSys(3, 2, net_slots=40),
       vsr.VsrSys(4, 1), vsr.VsrSys(4, 1, net_slots=48),
       vsr.VsrSys(3, 1, lossy=True, net_slots=3)])


def _actor_id(model):
    dm = model.device_model()
    name = (f"pingpong-h{int(dm.maintains_history)}"
            if isinstance(dm, pingpong.PingPongDevice)
            else f"vsr{dm.n}-v{dm.max_view}")
    return (f"{name}-l{int(dm.lossy)}-d{int(dm.duplicating)}"
            f"-e{dm.net_slots}")


@pytest.mark.parametrize("model", _ACTOR_MODELS,
                         ids=[_actor_id(m) for m in _ACTOR_MODELS])
def test_actor_step_matches_the_port(lib, model):
    """``pingpong.cuh`` and ``vsr.cuh`` on ``actor_net.cuh``: every action
    of every row, enabled or not (a Deliver, a Drop on a lossy network, a
    replica's Timeout), on reachable and adversarial rows: the successor's
    lanes bit for bit, and the enabled bit as the torch step's valid bit
    inside the boundary (which the device code folds into it). Every kind
    of action is enabled somewhere, and a network of 3 slots overflows
    (from a clear overflow lane)."""
    dm = model.device_model()
    rows = _actor_rows(model, np.random.default_rng(dm.state_width))
    succ, enabled = _device_step(lib, dm, rows)
    want, valid = dm.step(carry.rows_in(rows))
    inside = dm.boundary(want.reshape(-1, dm.state_width)).view(valid.shape)
    assert np.array_equal(succ, carry.rows_out(want))
    assert np.array_equal(enabled, (valid & inside).numpy())
    e, lossy = dm.net_slots, int(dm.lossy)
    kinds = {"deliver": enabled[:, lossy:e * (1 + lossy):1 + lossy],
             "drop": enabled[:, 0:2 * e:2] if lossy else None,
             "timeout": enabled[:, e * (1 + lossy):] if dm.n_timers
             else None}
    for kind, en in kinds.items():
        assert en is None or en.any(), kind
    if e == 3:
        clear = rows[:, None, dm.error_lane] == 0
        assert ((succ[..., dm.error_lane] == 1) & clear).any()


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


# -- The plan form of the step (csrc/plan.cuh) --------------------------------


def _set_plan(lib, plan):
    """Loads ``plan`` (host array and tables, as the plan-form entry points
    take them) into the harness; returns what must outlive the calls."""
    host = wave.plan_host(plan)
    tables = np.ascontiguousarray(wave.plan_tables(plan).view(np.uint32))
    assert _call(lib, "set_plan", ctypes.c_void_p(_ptr(host)),
                 ctypes.c_void_p(_ptr(tables))) == 0
    return host, tables


def _plan_of(dm):
    cls = matmul_wave.classify(dm)
    assert cls.regular, cls.reason
    return cls.plan


def _in_domain(dm, n, rng):
    """``n`` uniform in-domain rows (uint32 [n, W]) of ``dm``'s declared
    lanes, as ``tests/test_matmul_wave.py`` draws its frontiers."""
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    return np.stack([rng.integers(0, 1 << lane.bits, size=n,
                                  dtype=np.uint32)
                     for lane in layout.lanes], axis=1)


#: the plan step's cases: 2pc at 5 RMs and increment_lock at 4 threads,
#: and the other sizes the entry points instantiate that the tests keep
#: small
_PLAN_STEP_MODELS = [pytest.param(twopc.TwoPhaseDevice(5), id="twopc5"),
                     pytest.param(increment_lock.IncrementLockDevice(4),
                                  id="increment_lock4"),
                     pytest.param(twopc.TwoPhaseDevice(3), id="twopc3"),
                     pytest.param(increment.IncrementDevice(4),
                                  id="increment4")]


@pytest.mark.parametrize("dm", _PLAN_STEP_MODELS)
def test_plan_step_matches_matmul_expand(lib, dm):
    """``PlanStep``'s step on every slot of seeded random in-domain rows:
    the successor's lanes and the enabled bit, bit for bit, against the
    torch ``matmul_expand`` (and so against the model's own step, which
    ``test_torch_matmul_wave.py`` holds it to), every slot, enabled or
    not."""
    plan = _plan_of(dm)
    keep = _set_plan(lib, plan)
    model, p0, p1, p2 = _params(lib, dm)
    F, W = dm.max_fanout, dm.state_width
    for seed in range(3):
        rows = _in_domain(dm, 256, np.random.default_rng(seed))
        succ = np.zeros((len(rows), F, W), np.uint32)
        enabled = np.zeros((len(rows), F), np.bool_)
        rc = _call(lib, "model_step", *[ctypes.c_int(a) for a in (
            100 + model, p0, p1, p2)], ctypes.c_void_p(_ptr(rows)),
            ctypes.c_longlong(len(rows)), ctypes.c_int(W),
            ctypes.c_void_p(_ptr(succ)), ctypes.c_void_p(_ptr(enabled)))
        assert rc == 0
        want, sv, _, _ = matmul_wave.matmul_expand(
            dm, plan, carry.rows_in(rows), torch.ones(len(rows),
                                                      dtype=torch.bool))
        assert np.array_equal(enabled, sv.reshape(-1, F).numpy()), seed
        assert np.array_equal(succ.reshape(-1, W), carry.rows_out(want)), \
            seed
        assert enabled.any() and not enabled.all()
    del keep


@pytest.mark.parametrize("model, size, sym", [
    pytest.param("twopc", 5, False, id="twopc5"),
    pytest.param("twopc", 5, True, id="twopc5-sym"),
    pytest.param("increment_lock", 4, True, id="increment_lock4-sym")])
def test_plan_wave_and_sender_phases_match_the_plain_version(lib, model,
                                                            size, sym):
    """The tile loop's per-slot steps with ``PlanStep`` in the model's
    place (the plan-form kernels' device code) against
    ``wave_megakernel_plain`` and ``sender_megakernel_plain`` under the
    plan, bit for bit: successors, fingerprints, masks, counts, the
    table as a set, the scratch clean."""
    rng = np.random.default_rng(_seed(size) + 40)
    B = 48
    dm, layout, packed, valid, host = _frontier(model, size, sym, B, rng)
    plan = _plan_of(dm)
    keep = _set_plan(lib, plan)
    code, p0, p1, p2 = _params(lib, dm)
    F, wp = dm.max_fanout, layout.packed_width
    S = B * F
    _, _, lanes = wave.cuda_model(dm, layout)
    want = wave.wave_megakernel_plain(
        dm, carry.words_in(packed), torch.from_numpy(valid),
        t_p := carry.u64_in(host), sym, layout, plan)
    o1, o2 = _orders(S, size)["shuffled"]
    t, s = host.copy(), _Scratch(S)
    succ = np.zeros((S, wp), np.uint32)
    pfps = np.zeros(S, np.uint64)
    sflat, new, cand = (np.zeros(S, np.bool_) for _ in range(3))
    counts, walked = np.full(3, -7, np.int32), np.zeros(S, np.uint8)
    p, i = ctypes.c_void_p, ctypes.c_int
    reads = _call(lib, "wave_phases", *[i(a) for a in (100 + code, p0, p1,
                                                        p2)],
                  i(int(sym)), p(_ptr(lanes)), i(layout.width), i(wp),
                  p(_ptr(packed)), p(_ptr(valid)), ctypes.c_longlong(B),
                  i(F), p(_ptr(t)), i(len(t).bit_length() - 1),
                  *[p(a) for a in s.args()], i(s.m_bits), p(_ptr(o1)),
                  p(_ptr(o2)), p(_ptr(succ)), p(_ptr(pfps)), p(_ptr(sflat)),
                  p(_ptr(new)), p(_ptr(cand)), p(_ptr(counts)),
                  p(_ptr(walked)))
    assert reads >= 0
    for g, w in zip((succ, pfps, sflat, new, cand),
                    (carry.words_out(want[0]), carry.u64_out(want[1]),
                     want[2].numpy(), want[3].numpy(), want[4].numpy())):
        assert np.array_equal(g, w)
    assert counts.tolist() == [int(want[5]), int(want[6]), int(bool(want[7]))]
    assert _as_set(t) == _as_set(carry.u64_out(t_p)) and s.is_clean()
    assert int(want[5]) > 0

    n = 2
    spacked = np.ascontiguousarray(packed[:n * 16].reshape(n, 16, wp))
    svalid = np.ascontiguousarray(valid[:n * 16].reshape(n, 16))
    S = 16 * F
    want = wave.sender_megakernel_plain(
        dm, carry.words_in(spacked), torch.from_numpy(svalid), sym, layout,
        True, plan)
    s = _Scratch(n * S, n)
    o1, o2 = _orders(n * S, size)["reverse"]
    out = (np.zeros((n, S, wp), np.uint32), np.zeros((n, S), np.uint64),
           np.zeros((n, S), np.uint64), np.zeros((n, S), np.bool_),
           np.zeros((n, S), np.bool_))
    ll = ctypes.c_longlong
    rc = _call(lib, "sender_phases", *[i(a) for a in (100 + code, p0, p1,
                                                       p2)],
               i(int(sym)), i(1), p(_ptr(lanes)), i(layout.width), i(wp),
               p(_ptr(spacked)), p(_ptr(svalid)), ll(16), ll(n), i(F),
               p(_ptr(s.slots)), i(s.region_bits), p(_ptr(o1)), p(_ptr(o2)),
               *[p(_ptr(a)) for a in out])
    assert rc == 0
    for g, w in zip(out, (carry.words_out(want[0]), carry.u64_out(want[1]),
                          carry.u64_out(want[2]), want[3].numpy(),
                          want[4].numpy())):
        assert np.array_equal(g, w)
    assert s.is_clean()
    del keep


def test_plan_fits_the_kernel_parameters(lib):
    """``plan.cuh``'s capacities are ``wave.py``'s, its ``Plan`` leaves
    room in a kernel's 4 KB of parameters, and a plan past a capacity
    does not load (the entry point then refuses the launch)."""
    text = (CSRC + "/plan.cuh")
    consts = dict(re.findall(r"constexpr int (kPlan\w+) = (\d+);",
                             open(text).read()))
    assert [int(consts[k]) for k in ("kPlanGroups", "kPlanKeys",
                                     "kPlanEntries", "kPlanConsts",
                                     "kPlanActions")] == [
        wave.PLAN_GROUPS, wave.PLAN_KEYS, wave.PLAN_ENTRIES,
        wave.PLAN_CONSTS, wave.PLAN_ACTIONS]
    assert _call(lib, "plan_param_bytes") <= 2800
    dm = twopc.TwoPhaseDevice(3)
    host = wave.plan_host(_plan_of(dm)).copy()
    host[0] = wave.PLAN_GROUPS + 1
    tables = np.zeros(4, np.uint32)
    assert _call(lib, "set_plan", ctypes.c_void_p(_ptr(host)),
                 ctypes.c_void_p(_ptr(tables))) == 0
    rows = np.zeros((1, dm.state_width), np.uint32)
    out = np.zeros((1, dm.max_fanout, dm.state_width), np.uint32)
    en = np.zeros((1, dm.max_fanout), np.bool_)
    assert _call(lib, "model_step", *[ctypes.c_int(a) for a in (
        100, 3, 0, 0)], ctypes.c_void_p(_ptr(rows)), ctypes.c_longlong(1),
        ctypes.c_int(dm.state_width), ctypes.c_void_p(_ptr(out)),
        ctypes.c_void_p(_ptr(en))) == -2
