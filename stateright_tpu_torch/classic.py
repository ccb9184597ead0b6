"""The classic per-wave BFS: the host keeps the queue and the parent map,
and the card runs one wave a launch.

The port's copy of ``stateright_tpu/tpu/engine.py::TpuBfsChecker`` (:127)
and of its wave programs, in its own module because ``wave.py`` imports
``engine.py``. The parts and their JAX counterparts:

- ``classic_wave``: ``build_wave`` (:2017). Properties on the popped rows,
  then the successor path: the torch stages (``engine``) and the dedup
  kernel (``table.dedup_and_insert``, from ``dedup_and_insert_pallas``)
  with the engine's scratch, or with ``wave_kernel=True`` the single-kernel
  wave (``wave.wave_megakernel``, from ``build_wave_megakernel``) on the
  packed rows; then the compaction of the first ``out_rows`` new rows
  (``compaction_order`` and a gather, torch ops, as they are XLA outside
  any Pallas kernel in JAX). Under a matmul plan (``wave_matmul``) the
  expand stage is ``matmul_wave.matmul_expand`` in the torch stages and
  the plan form of the wave kernel (``build_wave`` :2097, :1948-1970).
- ``classic_regather``: ``build_regather`` (:2219). A wave whose new rows
  outgrew its output rung is expanded again through the torch stages
  (``matmul_expand`` under a plan, :2242) and compacted by its own
  novelty mask at a rung that fits; the table is not touched.
- ``CudaBfsChecker``: the host loop. The queue of blocks and
  ``_take_batch`` (:1203); the host properties (``_eval_host_conds``
  :1244, one unpack and one decode pass a wave for all of them); the
  output rung from an 8-wave history (``_pick_out_rows`` :957) and the
  regather of an overflowed wave (``_process_wave`` :1410-1460); the
  visitor on every popped row; ``_run_waves`` (:1275), with ``pipeline``:
  the next wave goes out before the last is read, when a full widest
  batch is queued; growth (``_needs_growth`` :1582), whose rehash is the
  fused engine's chunked insert through the dedup kernel
  (``fused.BfsEngine._insert_chunked``); the error lane (:1568); the
  parent log and paths (``_parent_map`` and ``_reconstruct_path``
  :1825-1856); checkpoints with JAX's sections (``_snapshot`` :571).

**The readback.** A wave's outputs are copied to pinned host slots of its
own (one set a wave in flight, two in all) with ``non_blocking`` copies
and an event; the host waits on that event alone, so the next wave, when
it is already launched, runs on while the host reads the last (JAX's
``int(new_count)`` waits on one wave only; a ``.item()`` on the default
stream would wait for every wave launched). All ``out_rows`` rows of a
wave come down whatever its count: the count is known only once they
have. The output ladder bounds them. The novelty mask a regather needs is
copied to a device buffer of the wave's slot, since the next wave's graph
replay writes the graph's own.

**Graphs.** On the card each wave is one CUDA graph (``graphs.py``),
keyed ``(batch, capacity, out_rows)`` as JAX keys its wave programs
(``_wave_fn`` :882): run eagerly the first time, captured the second,
replayed after, all dropped at a growth. The graph reads the batch from
a static device buffer filled by a copy from the slot's pinned upload
rows, and its outputs stay where the capture put them.

**The parent log.** As in JAX, each wave appends its new rows' path
fingerprints and their parents' as arrays. A chain walk does not build
JAX's dict of every child: it searches the log's blocks in order, the
first entry of a child winning (JAX's ``setdefault``); a snapshot takes
each child's first entry by a stable dedup of the concatenated log.
``_parent_map()`` builds the dict (the tests' and a visitor's).

**The tiered store** (``store/tiered.py``, the ``tier_*`` keywords;
engine :1613-1716): where the table's next growth would pass the device
budget, whole ``fp % P`` partitions go to the store's warm tier (cold
segments under host pressure) and the table is rebuilt at the same
capacity through the dedup kernel (``_spill_for_headroom``); each wave's
new rows are probed against the spilled partitions on the host, right
after the error lane, and a row found there is dropped before the
counts, the parent log and the queue (``_resident``, the table's
occupancy, still counts it: it is back in the table). Under a host
budget, queue blocks page out to disk (``FrontierRef``) and back.

**Telemetry** (``obs``; engine :473-524, :1410-1566): each processed
wave's dispatch-log entry is the schema's wave event (``bytes_per_state``,
``table_bytes``, ``io_stall_s``, ``arena_bytes`` null: the queue is on
the host), logged, recorded in the flight ring and traced; an overflowed
wave's regather emits ``overflow_redispatch`` first, a growth one
``grow`` with the old and new capacity, and the profiler's record of a
wave is kernel 2's declared cost, or kernel 1's after the torch stages.
The bytes each wave's outputs took to the host are ``bytes_down``, one a
wave.

The mux, fault injection and preemption of the JAX engine are not ported
(ROADMAP A10, A13).
"""

from __future__ import annotations

import contextlib
import itertools
import time
import warnings
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from .engine import (compaction_order, eval_properties,
                     fingerprint_successors, pick_bucket, succ_bucket_ladder)
from .fused import KERNELS, BfsEngine, _tier_knobs, _u64, checkpoint_name
from .graphs import DispatchGraphs
from .hashing import SENTINEL, device_fp64
from .mesh import _umod
from .matmul_wave import expand
from .checkpoint_format import make_header
from .model import Expectation
from .path import Path
from .store.tiered import FrontierRef
from .table import dedup_and_insert, dedup_cost
from .wave import wave_cost, wave_megakernel

__all__ = ["CudaBfsChecker", "classic_wave", "classic_regather"]

#: the waves in flight at most (one processed while the next runs)
_SLOTS = 2
#: the small outputs of a wave, in one int64 vector
(_SUCC, _CAND, _NEW, _OVERFLOW, _FULL) = range(5)


def classic_wave(dm, vecs: torch.Tensor, valid: torch.Tensor,
                 table: torch.Tensor, layout, prop_fns=(),
                 use_sym: bool = False, out_rows: Optional[int] = None,
                 wave_kernel: bool = False, scratch=None, plan=None):
    """One BFS level of ``B`` packed rows ``vecs int32[B, Wp]`` (``valid
    bool[B]``) against the visited table ``table int64[C]``, updated in
    place: ``build_wave``'s outputs ``(conds, succ_count, cand_count,
    terminal, new_count, new_vecs, new_fps, new_parent, new_mask,
    overflow)`` and, where JAX returns the table, ``full`` (bool 0-dim:
    a candidate found no free slot).

    ``conds`` holds a bool[B] for each property with a device predicate
    (``prop_fns``, None for a host one). ``new_vecs``, ``new_fps`` and
    ``new_parent`` are the first ``out_rows`` (default ``B * F``)
    compacted rows of the wave's new successors (packed rows, path
    fingerprints, int32 parent rows), in frontier order; ``new_mask``
    marks all of them, and ``overflow`` is ``new_count > out_rows``.
    Nothing here reads a device value on the host, so it can run ahead of
    the host and inside a CUDA graph. ``plan``, a
    ``matmul_wave.MatmulPlan``, runs the expand stage in its
    transition-table form."""
    B, F = vecs.shape[0], dm.max_fanout
    S = B * F
    K = S if out_rows is None else min(max(1, int(out_rows)), S)
    rows = layout.unpack(vecs)
    conds = eval_properties(prop_fns, rows)
    if wave_kernel:
        (succ_store, path_fps, sflat, new_mask, _, new_count, cand_count,
         full) = wave_megakernel(dm, vecs, valid, table, use_sym, layout,
                                 scratch=scratch, plan=plan)
        succ_count = sflat.sum(dtype=torch.int64)
        terminal = valid & ~sflat.reshape(B, F).any(dim=1)
        comp = compaction_order(new_mask)[:K]
        new_vecs = succ_store[comp]
    else:
        succ, sflat, succ_count, terminal = expand(dm, plan, rows, valid)
        dedup_fps, path_fps = fingerprint_successors(dm, succ, sflat,
                                                     use_sym)
        new_mask, _, new_count, cand_count, full = dedup_and_insert(
            dedup_fps, table, scratch=scratch)
        comp = compaction_order(new_mask)[:K]
        # Packing after the gather: only the K rows pay the codec.
        new_vecs = layout.pack(succ[comp])
    new_fps = path_fps[comp]
    new_parent = (comp // F).to(torch.int32)
    conds_out = [c for c in conds if c is not None]
    return (conds_out, succ_count, cand_count, terminal, new_count,
            new_vecs, new_fps, new_parent, new_mask, new_count > K, full)


def classic_regather(dm, vecs: torch.Tensor, valid: torch.Tensor,
                     new_mask: torch.Tensor, out_rows: int, layout,
                     plan=None):
    """The output ladder's overflow recovery (``build_regather``): the
    same batch expanded again, compacted by the wave's own ``new_mask``
    at a rung of ``out_rows`` rows: ``(new_vecs, new_fps, new_parent)``
    as ``classic_wave`` would have given them at that rung. The table is
    not touched: the wave already inserted every new row. ``plan`` as
    ``classic_wave``'s."""
    F = dm.max_fanout
    K = min(max(1, int(out_rows)), vecs.shape[0] * F)
    succ, _, _, _ = expand(dm, plan, layout.unpack(vecs), valid)
    comp = compaction_order(new_mask)[:K]
    rows = succ[comp]
    return (layout.pack(rows), device_fp64(rows),
            (comp // F).to(torch.int32))


class _Slot:
    """The pinned host rows of one wave in flight: its batch as uploaded,
    and its outputs as copied down; and the device copy of its novelty
    mask for a regather."""

    def __init__(self, B: int, S: int, wp: int, P: int, device,
                 small: int = 5):
        def pinned(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=True)

        self.vecs = pinned((B, wp), torch.int32)
        self.valid = pinned((B,), torch.bool)
        self.small = pinned((small,), torch.int64)
        self.conds = pinned((P * B,), torch.bool)
        self.terminal = pinned((B,), torch.bool)
        self.new_vecs = pinned((S, wp), torch.int32)
        self.new_fps = pinned((S,), torch.int64)
        self.new_parent = pinned((S,), torch.int32)
        self.mask = torch.empty((S,), dtype=torch.bool, device=device)
        self.event = None


class CudaBfsChecker(BfsEngine):
    """The classic per-wave BFS: a host queue and parent log, one wave a
    launch."""

    _ENGINE_ID = "classic"
    #: the shards a wave pops a batch from (the sharded subclass's mesh)
    _n = 1
    _VISITED_SPILL_CAPABLE = True

    def __init__(self, builder, device: torch.device, batch_size: int = 1024,
                 table_capacity: int = 1 << 16, wave_kernel: bool = False,
                 max_batch_size=None, pipeline=None, succ_ladder=None,
                 cuda_graph: bool = False, checkpoint_path=None,
                 checkpoint_every_waves: int = 64, resume_from=None,
                 async_io=None, wave_matmul=None, device_model=None,
                 **tier):
        self._configure(builder, device, batch_size, table_capacity,
                        wave_kernel, max_batch_size, checkpoint_path,
                        checkpoint_every_waves, async_io, wave_matmul,
                        device_model, _tier_knobs(tier))
        for p, fn in zip(self._properties, self._prop_fns):
            if fn is None:
                warnings.warn(
                    f"property {p.name!r} has no device predicate; "
                    "falling back to host evaluation per wave (slow)",
                    stacklevel=3)
        on_card = device.type == "cuda"
        # One wave ahead on the card; on the CPU the host and the "device"
        # share the cores, as in JAX.
        self._pipeline = on_card if pipeline is None else bool(pipeline)
        self._succ_ladder_on = True if succ_ladder is None else bool(
            succ_ladder)
        #: recent (batch, new rows) pairs the next output rung is sized by
        self._succ_hist: deque = deque(maxlen=8)
        self._eventually_idx = [
            i for i, p in enumerate(self._properties)
            if p.expectation is Expectation.EVENTUALLY]
        self._n_dev = sum(fn is not None for fn in self._prop_fns)
        #: fingerprint -> (row, action into it) of the visitor's replays
        self._replayed: Dict[int, tuple] = {}
        self._start(resume_from)

        #: waves processed, table rehashes, the dedup kernel's calls they
        #: took (``_insert_chunked``'s chunks) and checkpoints written
        self.waves = self.rehashes = self.rehash_chunks = 0
        self.checkpoints = 0
        #: (monotonic time, state count): one at the run's start, one a wave
        self.wave_log: list = []
        #: one dict a processed wave: its wave event, under the schema's
        #: keys (``bucket``, ``inflight``, ``out_rows``, ``rows``,
        #: ``novel``, ``overflow``, ...)
        self.dispatch_log: List[dict] = []
        #: the bytes each processed wave's outputs took to the host
        self.bytes_down: List[int] = []
        #: host seconds in the launches, in processing the outputs, and
        #: waiting for them
        self.host_sec = {"launch": 0.0, "process": 0.0, "wait": 0.0}
        self._graphs = DispatchGraphs(KERNELS) if cuda_graph else None
        self._wave_outs: Dict[tuple, tuple] = {}
        self._launched = 0
        if on_card:
            self._make_slots(device)
        self._spawn_worker()

    def _make_slots(self, device) -> None:
        """The card's pinned host slots, one a wave in flight, and the
        static device rows a wave reads its batch from."""
        wp = self._layout.packed_width
        self._slots = [_Slot(self._B_max, self._B_max * self._F, wp,
                             self._n_dev, device) for _ in range(_SLOTS)]
        self._in_vecs = torch.zeros((self._B_max, wp), dtype=torch.int32,
                                    device=device)
        self._in_valid = torch.zeros((self._B_max,), dtype=torch.bool,
                                     device=device)

    # -- Seeding -----------------------------------------------------------

    def _start(self, resume_from) -> None:
        """Seeds the queue, the parent log and the table, from the init
        states or from the checkpoint at ``resume_from`` (engine
        :393-444)."""
        if resume_from is None:
            seed, fps, ebits, visited = self._init_rows()
        else:
            seed, fps, ebits, visited = self._load_checkpoint(resume_from)
        self._pending: deque = deque()
        if len(fps):
            self._pending.append((seed, fps, ebits))
        # The host map the seeding read (the roots, or a file's parent
        # sections) is the log's first block; the dict starts empty.
        self._parent_log: list = [self._parents]
        self._parents: Dict[int, Optional[int]] = {}
        self._parents_consumed = 0
        visited = self._spill_seed(visited)
        while self._capacity < 4 * len(visited) + 2 * self._B_max * self._F:
            self._capacity *= 2
        self._table = self._new_table(visited, resume_from is not None)
        #: the table's occupancy, which lags the unique count once the
        #: store evicted visited partitions
        self._resident = len(visited)

    def _reset_engine_state(self) -> None:
        """Drops what a restart rebuilds (engine :707-724)."""
        self._drop_graphs()
        self._succ_hist.clear()
        self._replayed.clear()
        self.wave_log = []
        self._table = None

    # -- The wave ------------------------------------------------------------

    def _pick_out_rows(self, B: int) -> int:
        """The next wave's output rung at batch ``B``: twice the most new
        rows of the last 8 waves (scaled to ``B``), up the ladder; the
        full ``B * F`` until the history holds 8 waves, or with the ladder
        off (engine :957-978)."""
        full = self._succ_full_rows(B)
        if (not self._succ_ladder_on
                or len(self._succ_hist) < self._succ_hist.maxlen):
            return full
        ladder = succ_bucket_ladder(full)
        if len(ladder) == 1:
            return full
        want = 0
        for b, novel in self._succ_hist:
            want = max(want, novel * -(-B // b))
        return pick_bucket(ladder, 2 * want + 16)

    def _succ_full_rows(self, B: int) -> int:
        """A wave's whole successor space at batch ``B``: the output
        ladder's top rung (engine :903)."""
        return B * self._F

    def _wave(self, B: int, K: int, vecs, valid) -> tuple:
        """``classic_wave`` at this engine's settings, with its outputs
        gathered for the host: ``(conds [P, B] or None, small int64[5],
        terminal, new_vecs, new_fps, new_parent, new_mask)``."""
        (conds, succ_count, cand_count, terminal, new_count, new_vecs,
         new_fps, new_parent, new_mask, overflow, full) = classic_wave(
            self._dm, vecs, valid, self._table, self._layout,
            self._prop_fns, self._use_symmetry, K, self._wave_kernel,
            self._scratch, self._matmul_plan)
        small = torch.stack([succ_count, cand_count.to(torch.int64),
                             new_count.to(torch.int64),
                             overflow.to(torch.int64), full.to(torch.int64)])
        return (torch.stack(conds) if conds else None, small, terminal,
                new_vecs, new_fps, new_parent, new_mask)

    def _take_batch(self, pending: deque, rows: int, vecs, fps, ebits) -> int:
        """Moves up to ``rows`` rows of the queue ``pending`` into
        ``vecs``, ``fps`` and ``ebits`` (engine :1203-1242): the queue
        holds whole blocks, one a wave, so this is array copies, with no
        work a row. A block the store paged out is read back first, and
        the next paged-out ones are read ahead: one, or four with
        ``async_io``, within the next 8 (32) blocks."""
        taken = 0
        while pending and taken < rows:
            if isinstance(pending[0], FrontierRef):
                width, depth = (4, 32) if self._aio.enabled else (1, 8)
                ahead = [b for b in itertools.islice(pending, 1, depth)
                         if isinstance(b, FrontierRef)][:width]
                pending[0] = self._store.fetch_frontier(
                    pending[0], prefetch=ahead or None)
            bv, bf, be = pending[0]
            k = len(bf)
            take = min(k, rows - taken)
            vecs[taken:taken + take] = bv[:take]
            fps[taken:taken + take] = bf[:take]
            ebits[taken:taken + take] = be[:take]
            if take == k:
                pending.popleft()
            else:
                pending[0] = (bv[take:], bf[take:], be[take:])
            taken += take
        return taken

    def _dispatch_wave(self, B: int, inflight: int) -> dict:
        """Takes a batch of ``B`` rows from the queue and launches its wave
        (engine :1359-1408); on the card the outputs' copies to the wave's
        host slot go out behind it. Returns the wave's context for
        ``_process_wave``."""
        t0 = time.perf_counter()
        K = self._pick_out_rows(B)
        wp = self._layout.packed_width
        on_card = self._device.type == "cuda"
        slot = self._slots[self._launched % _SLOTS] if on_card else None
        self._launched += 1
        if on_card:
            up = slot.vecs.numpy()[:B].view(np.uint32)
        else:
            up = np.empty((B, wp), np.uint32)
        batch_fps = np.zeros(B, np.uint64)
        batch_ebits = np.zeros(B, np.uint32)
        n = self._take_batch(self._pending, B, up, batch_fps, batch_ebits)
        up[n:] = 0
        valid = np.arange(B) < n
        key = (B, self._capacity, K)
        meta = {"bucket": B, "inflight": inflight, "out_rows": K, "rows": n,
                "kernel_path": self.kernel_path(),
                "expand_impl": self._expand_impl(), "compiled": False}
        wave = dict(meta=meta, vecs=up, fps=batch_fps, ebits=batch_ebits,
                    valid=valid, n=n, slot=slot)
        prof = (self._prof_start(key, lambda: self._wave_costs(B))
                if self._prof.enabled else None)
        if not on_card:
            outs = self._wave(B, K, torch.from_numpy(up.view(np.int32)),
                              torch.from_numpy(valid))
            if prof is not None:
                meta.update(self._prof_stop(prof))
            wave["outs"] = [None if t is None else t.numpy()
                            for t in outs[:6]]
            wave["mask"] = outs[6]
        else:
            with torch.cuda.device(self._device):
                slot.valid.numpy()[:B] = valid
                self._in_vecs[:B].copy_(slot.vecs[:B], non_blocking=True)
                self._in_valid[:B].copy_(slot.valid[:B], non_blocking=True)
                args = (B, K, self._in_vecs[:B], self._in_valid[:B])
                outs = self._graphed(key, lambda: self._wave(*args), meta)
                if prof is not None:
                    meta.update(self._prof_stop(prof))
                self._copy_down(slot, outs, K < B * self._F)
        self.host_sec["launch"] += time.perf_counter() - t0
        return wave

    def _wave_costs(self, B: int) -> list:
        """The declared cost of the kernel a wave of ``B`` rows launches,
        at the shape's full work: kernel 2, or kernel 1 after the torch
        stages."""
        if self._wave_kernel:
            return [wave_cost(self._dm, B, self._layout.packed_width,
                              self._use_symmetry, self._matmul_plan)]
        return [dedup_cost(B * self._F)]

    def _graphed(self, key, fn, meta=None):
        """``fn()``'s outputs, through the graph at ``key`` when graphs are
        on (``meta["compiled"]`` set when this call captured)."""
        if self._graphs is None:
            return fn()

        def run():
            self._wave_outs[key] = fn()

        captured = self._graphs.run(key, run)
        if meta is not None:
            meta["compiled"] = captured
        return self._wave_outs[key]

    @staticmethod
    def _copy_down(slot: _Slot, outs, regather: bool) -> None:
        """Queues the copies of a wave's outputs to its slot behind the
        wave, and the event the host waits on; with ``regather`` (an
        output rung below the whole successor space) the novelty mask's
        copy to the slot's device buffer too."""
        conds, small, terminal, new_vecs, new_fps, new_parent, mask = outs
        slot.small.copy_(small, non_blocking=True)
        if conds is not None:
            slot.conds[:conds.numel()].copy_(conds.reshape(-1),
                                             non_blocking=True)
        slot.terminal[:terminal.numel()].copy_(terminal, non_blocking=True)
        k = new_vecs.shape[0]
        slot.new_vecs[:k].copy_(new_vecs, non_blocking=True)
        slot.new_fps[:k].copy_(new_fps, non_blocking=True)
        slot.new_parent[:k].copy_(new_parent, non_blocking=True)
        if regather:
            # A regather needs the mask after the next wave overwrote it.
            slot.mask[:mask.numel()].copy_(mask, non_blocking=True)
        slot.event = torch.cuda.Event()
        slot.event.record()

    def _fetch(self, wave: dict):
        """The wave's outputs on the host, as numpy arrays: ``(conds
        [P, n * B] or None, small, terminal, new_vecs [n * K, Wp],
        new_fps, new_parent)`` for the ``n`` shards' batches of ``B`` rows
        and rungs of ``K``; on the card after a wait on the wave's own
        event."""
        slot = wave["slot"]
        if slot is None:
            return wave["outs"]
        t0 = time.perf_counter()
        slot.event.synchronize()
        self.host_sec["wait"] += time.perf_counter() - t0
        nB = self._n * wave["meta"]["bucket"]
        nK = self._n * wave["meta"]["out_rows"]
        P = self._n_dev
        return ((slot.conds.numpy()[:P * nB].reshape(P, nB) if P else None),
                slot.small.numpy(), slot.terminal.numpy()[:nB],
                slot.new_vecs.numpy()[:nK], slot.new_fps.numpy()[:nK],
                slot.new_parent.numpy()[:nK])

    def _regather(self, wave: dict, k: int):
        """An overflowed wave's ``k`` new rows, regathered at the least
        rung that holds them (engine :1436-1450)."""
        B = wave["meta"]["bucket"]
        k2 = pick_bucket(succ_bucket_ladder(B * self._F), k)
        dev = self._device
        if wave["slot"] is None:
            mask = wave["mask"]
        else:
            mask = wave["slot"].mask[:B * self._F]
        vecs = torch.from_numpy(wave["vecs"].view(np.int32))
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            outs = classic_regather(
                self._dm, vecs.to(dev),
                torch.from_numpy(wave["valid"]).to(dev), mask, k2,
                self._layout, self._matmul_plan)
            new_vecs, new_fps, new_parent = (t.cpu().numpy() for t in outs)
        wave["meta"].update(out_rows=k2, overflow=True)
        if self._tracer.enabled:
            self._tracer.event("overflow_redispatch", bucket=B, out_rows=k2,
                               novel=k)
        return k2, new_vecs, new_fps, new_parent

    def _eval_host_conds(self, conds_out, batch_vecs, rows):
        """Every property's condition over the batch (engine :1244-1273):
        the device's where it has a predicate, else the host condition on
        the decoded rows ``rows``; the unpack and the decode run once a
        wave, for all host properties."""
        model = self._model
        conds: List[np.ndarray] = []
        dev_i = 0
        decoded = None
        for i, fn in enumerate(self._prop_fns):
            if fn is not None:
                conds.append(conds_out[dev_i])
                dev_i += 1
                continue
            if decoded is None:
                unpacked = self._layout.unpack_np(batch_vecs)
                decoded = [(r, self._dm.decode(unpacked[r])) for r in rows]
            cond = np.zeros(len(batch_vecs), bool)
            prop_cond = self._properties[i].condition
            for r, state in decoded:
                cond[r] = bool(prop_cond(model, state))
            conds.append(cond)
        return conds

    def _process_wave(self, wave: dict) -> None:
        """Applies a launched wave's outputs to the counts, discoveries,
        the parent log and the queue (engine :1410-1566)."""
        conds_out, small, terminal, new_vecs, new_fps, new_parent = \
            self._fetch(wave)
        t0 = time.perf_counter()
        meta, n = wave["meta"], wave["n"]
        batch_vecs, batch_fps = wave["vecs"], wave["fps"]
        batch_ebits, valid = wave["ebits"], wave["valid"]
        if small[_FULL]:
            raise RuntimeError("the visited table filled up: a candidate "
                               "found no free slot")
        conds = self._eval_host_conds(conds_out, batch_vecs, range(n))
        if self._visitor is not None:
            for r in range(n):
                self._visitor.visit(self._model,
                                    self._reconstruct_path(int(batch_fps[r])))
        k = int(small[_NEW])
        K = meta["out_rows"]
        down = (K * (new_vecs.itemsize * new_vecs.shape[1] + 12)
                + len(terminal) * (1 + self._n_dev) + small.nbytes)
        meta["overflow"] = False
        if small[_OVERFLOW]:
            k2, new_vecs, new_fps, new_parent = self._regather(wave, k)
            down += k2 * (new_vecs.itemsize * new_vecs.shape[1] + 12)
        # Copies: the slot's rows are overwritten two waves on.
        new_vecs = new_vecs[:k].view(np.uint32).copy()
        new_fps = new_fps[:k].view(np.uint64).copy()
        parent_rows = new_parent[:k].astype(np.int64)
        self._check_error_lane(new_vecs)
        # The table knows only its resident rows: a spilled state
        # generated again looks new there (and is back in it), so the
        # store's probe drops it before the counts, the parent log and
        # the queue (engine :1460-1478).
        k_dev = k
        if self._store.active and k and self._store.spilled_rows:
            present = self._store.probe(
                self._store_probe_fps(new_vecs, new_fps))
            if present.any():
                keep = ~present
                new_vecs, new_fps = new_vecs[keep], new_fps[keep]
                parent_rows = parent_rows[keep]
                k = len(new_fps)

        with self._lock:
            self._state_count += int(small[_SUCC])
            self._resident += k_dev
            self._succ_hist.append((meta["bucket"], k_dev))
            now = time.monotonic()
            self.wave_log.append((now, self._state_count))
            self.waves += 1
            entry = dict(
                meta, t=now, states=self._state_count,
                unique=self._unique_count + k, waves=1,
                successors=int(small[_SUCC]), candidates=int(small[_CAND]),
                novel=k, capacity=self._capacity,
                load_factor=round(self._resident / self._capacity, 4),
                **self._wave_gauges())
            self._tier_gauges(entry)
            if self._prof.enabled:
                self._stamp_cost(entry)
            self.dispatch_log.append(entry)
            self.bytes_down.append(down)
            ebits_after = self._cleared_ebits(conds, batch_ebits)
            self._record_discoveries(conds, valid, terminal, ebits_after,
                                     batch_fps)
            if k:
                self._parent_log.append(
                    (new_fps, batch_fps[parent_rows], None))
                self._unique_count += k
                self._pending.append(
                    (new_vecs, new_fps, ebits_after[parent_rows]))
        if self._store.active and k:
            # The host tier's budget: the queue's last blocks page out.
            self._store.balance_frontier((self._pending,))
        self._publish(entry)
        self.host_sec["process"] += time.perf_counter() - t0

    def _wave_gauges(self) -> dict:
        """A wave event's byte gauges and its I/O stall (engine
        :1493-1507): a row's stored bytes, the table's, and no arena (the
        queue is on the host)."""
        return dict(bytes_per_state=4 * self._layout.packed_width,
                    arena_bytes=None,
                    table_bytes=self._table_bytes(self._capacity),
                    io_stall_s=self._take_io_stall())

    def _tier_gauges(self, entry: dict) -> None:
        """Adds the store's tier gauges to a wave's log entry (engine
        :1508-1513)."""
        if self._store.active:
            entry.update(self._store.gauges(),
                         tier_device_rows=self._resident,
                         tier_device_bytes=self._table_bytes(self._capacity))

    def _cleared_ebits(self, conds, batch_ebits: np.ndarray) -> np.ndarray:
        """The batch's eventually bits with each property's cleared where
        its row satisfied it: the bits the row's children inherit
        (bfs.rs:212-222)."""
        ebits_after = batch_ebits.copy()
        for i in self._eventually_idx:
            ebits_after &= ~np.where(conds[i], np.uint32(1 << i),
                                     np.uint32(0))
        return ebits_after

    def _record_discoveries(self, conds, valid: np.ndarray,
                            terminal: np.ndarray, ebits_after: np.ndarray,
                            batch_fps: np.ndarray) -> None:
        """A wave's first hits, in batch order, under the lock:
        Always/Sometimes at the first failing or matching valid row
        (bfs.rs:196-211), then each eventually property at the first
        valid terminal row with its bit still set (bfs.rs:223-226,
        265-272)."""
        properties = self._properties
        for i, prop in enumerate(properties):
            if prop.name in self._discoveries:
                continue
            if prop.expectation is Expectation.ALWAYS:
                hits = valid & ~conds[i]
            elif prop.expectation is Expectation.SOMETIMES:
                hits = valid & conds[i]
            else:
                continue
            rows = np.flatnonzero(hits)
            if rows.size:
                self._discoveries[prop.name] = int(batch_fps[rows[0]])
        for r in np.flatnonzero(terminal & valid & (ebits_after != 0)):
            for i in self._eventually_idx:
                name = properties[i].name
                if (ebits_after[r] >> i) & 1 \
                        and name not in self._discoveries:
                    self._discoveries[name] = int(batch_fps[r])

    def _check_error_lane(self, new_vecs: np.ndarray) -> None:
        """Raises if a new state set the model's error lane (engine
        :1568-1580)."""
        lane = self._dm.error_lane
        if lane is None or not new_vecs.size:
            return
        if self._layout.lane_np(new_vecs, lane).any():
            raise RuntimeError(
                f"device model error lane {lane} is set in a generated "
                "state: an encoding capacity was exceeded (for actor "
                "models: raise net_slots)")

    # -- Host loop ---------------------------------------------------------

    def _run_waves(self) -> None:
        """The host loop, one wave ahead with ``pipeline`` (engine
        :1275-1357): the next wave goes out before the last is processed
        only when a full widest batch is queued, so every wave holds what
        a sequential loop's would, and the results are the same. Growth
        and checkpoints wait for the wave in flight. Each wave's width is
        the least rung of the bucket ladder that covers the queue."""
        pending = self._pending
        P = len(self._properties)
        self.wave_log.append((time.monotonic(), self._state_count))
        wave_index = last_ckpt = 0
        inflight = None
        while pending or inflight is not None:
            with self._lock:
                done = (len(self._discoveries) == P
                        or (self._target is not None
                            and self._state_count >= self._target))
            if done:
                # The wave in flight inserted its rows: process it, or
                # the queue would lose their subtrees.
                if inflight is not None:
                    self._process_wave(inflight)
                return
            ckpt_due = (self._ckpt_path is not None
                        and wave_index - last_ckpt >= self._ckpt_every)
            growth_due = self._needs_growth()
            if inflight is None:
                if ckpt_due:
                    self._write_checkpoint(self._ckpt_path)
                    last_ckpt = wave_index
                    ckpt_due = False
                if growth_due:
                    self._grow_table()
                    growth_due = False
            queued = 0
            for b in pending:
                queued += _block_rows(b)
                if queued >= self._B_max:
                    break
            next_wave = None
            may_dispatch = (inflight is None
                            or (self._pipeline and queued >= self._B_max))
            if queued and may_dispatch and not growth_due and not ckpt_due:
                wave_index += 1
                next_wave = self._dispatch_wave(
                    pick_bucket(self._buckets, queued),
                    inflight=0 if inflight is None else 1)
            if inflight is not None:
                self._process_wave(inflight)
            inflight = next_wave

    def _load_after(self) -> int:
        """The occupancy growth holds under half the capacity, with two
        waves of headroom (engine :1582-1597): with a wave in flight the
        occupancy lags its insertions by up to ``B_max * F``, and the next
        wave adds as many."""
        return self._resident + 2 * self._B_max * self._F

    def _needs_growth(self) -> bool:
        return self._load_after() > self._capacity // 2

    def _grow_target(self) -> int:
        """The capacity growth would take now (engine :1599-1606)."""
        cap = self._capacity
        while self._load_after() > cap // 2:
            cap *= 2
        return cap

    def _rehash(self, capacity: int) -> torch.Tensor:
        """The table rehashed into ``capacity`` slots."""
        table = torch.full((capacity,), SENTINEL, dtype=torch.int64,
                           device=self._table.device)
        if bool(self._insert_chunked(self._table, table)):
            raise RuntimeError("rehash found no free slot")
        return table

    def _grow_table(self) -> None:
        """Doubles the capacity until the headroom holds and rehashes the
        table into it once (engine :1802-1818), through the dedup kernel
        in strided chunks with the engine's scratch, as the fused engines
        do (``_insert_chunked``). Every wave graph goes: they hold the old
        table. Where the new capacity would pass the tiered store's
        device budget, visited partitions spill instead, and the growth
        may then be needed no more (engine :1780-1795)."""
        if self._spill_for_headroom() and not self._needs_growth():
            return
        self._drop_graphs()
        cap = self._grow_target()
        if self._tracer.enabled:
            self._tracer.event("grow", kind="table", old=self._capacity,
                               new=cap)
        with (torch.cuda.device(self._device)
              if self._device.type == "cuda" else contextlib.nullcontext()):
            table = self._rehash(cap)
        self.rehash_chunks += self._n * self._chunks(self._capacity)
        self._table, self._capacity = table, cap
        self.rehashes += 1

    def _drop_graphs(self) -> None:
        """Drops every wave graph and its outputs: they hold the table."""
        if self._graphs is not None:
            self._graphs.clear()
        self._wave_outs.clear()

    # -- The tiered store ------------------------------------------------------

    def _device_rows(self) -> int:
        return self._resident

    def _spill_seed(self, visited: np.ndarray) -> np.ndarray:
        """The keys a new table is built from, fresh or resumed (engine
        :1623-1651): where all of ``visited`` would size the table past
        the device budget, whole partitions go to the warm tier first
        and the rest are returned."""
        store = self._store
        if (not store.active or store.device_budget is None
                or not len(visited)):
            return visited
        visited = np.asarray(visited, np.uint64)

        def cap_for(n_rows: int) -> int:
            cap = self._capacity
            while cap < 4 * n_rows + 2 * self._B_max * self._F:
                cap *= 2
            return cap

        def fits(keep) -> bool:
            return (self._table_bytes(cap_for(len(keep)))
                    <= store.device_budget)

        if fits(visited):
            return visited
        mask = store.spill_mask(visited, fits)
        if not mask.any():
            return visited
        store.spill_visited(visited[mask])
        return visited[~mask]

    def _spill_for_headroom(self) -> bool:
        """The spill in place of a growth past the device budget (engine
        :1653-1686): whole ``fp % P`` partitions of the table go to the
        warm tier until the rest leaves headroom, and the table is
        rebuilt in place at the same capacity (``_refill_table``), so the
        graphs stay. False where nothing spilled: the growth stays inside the
        budget, or even an empty table would leave no headroom (the
        store notes the pressure, and the table grows past the
        budget)."""
        store = self._store
        if not store.active or store.device_budget is None:
            return False
        target = self._grow_target()
        if self._table_bytes(target) <= store.device_budget:
            return False
        # The partitions are picked from counts taken on the device (JAX's
        # ``spill_mask`` choice), so only the evicted keys leave the card.
        # The table is read a chunk at a time, and the kept keys wait in
        # one buffer a slice sized from the counts: beside the table the
        # spill holds those keys and one chunk's temporaries, under JAX's
        # extra table.
        P, n = store.partitions, self._n
        slices = self._table.view(n, -1)
        hist = torch.zeros((P, n), dtype=torch.int64, device=slices.device)
        for i, keys in _resident_chunks(slices):
            hist[:, i] += torch.bincount(_partition_ids(keys, P),
                                         minlength=P)
        hist = hist.cpu().numpy()
        taken = (store.spill_partitions(hist, self._spill_enough_counts)
                 if self._spill_enough_counts(np.zeros(n, np.int64))
                 else [])
        if not taken:
            store.note_device_pressure(self._table_bytes(target),
                                       store.device_budget)
            return False
        out = torch.zeros(P, dtype=torch.bool, device=slices.device)
        out[taken] = True
        counts = hist.sum(axis=0) - hist[taken].sum(axis=0)
        # Each buffer padded with sentinels to a whole number of the
        # refill's chunks, so ``_insert_chunked`` copies none of it.
        chunks = [self._chunks(int(c)) for c in counts]
        kept = [slices.new_full((-(-int(c) // k) * k,), SENTINEL)
                for c, k in zip(counts, chunks)]
        at, spilled = [0] * n, []
        for i, keys in _resident_chunks(slices):
            gone = out[_partition_ids(keys, P)]
            spilled.append(_u64(keys[gone]))
            stay = keys[~gone]
            kept[i][at[i]:at[i] + stay.numel()] = stay
            at[i] += stay.numel()
        store.spill_visited(np.concatenate(spilled))
        with (torch.cuda.device(self._device)
              if self._device.type == "cuda" else contextlib.nullcontext()):
            self._refill_table(kept, counts)
        return True

    def _refill_table(self, kept, counts: np.ndarray) -> None:
        """Empties the table in place and inserts each slice's int64 keys
        ``kept[i]`` (on its device, sentinel-padded; ``counts[i]`` of
        them) again, through the dedup kernel in strided chunks: the wave
        graphs, which hold the table, stay."""
        self._table.fill_(SENTINEL)
        if bool(self._insert_chunked(kept[0], self._table)):
            raise RuntimeError("the table's rebuild found no free slot")
        self._resident = int(counts.sum())

    def _spill_enough_counts(self, kept: np.ndarray) -> bool:
        """Whether keeping ``kept`` rows (their counts by shard) in the
        table leaves two waves of headroom at the current capacity (the
        reference's ``_spill_enough``, engine :1615-1621)."""
        return int(kept.sum()) + 2 * self._B_max * self._F \
            <= self._capacity // 2

    def _store_probe_fps(self, new_vecs: np.ndarray,
                         new_fps: np.ndarray) -> np.ndarray:
        """The fingerprints a wave's new rows are probed by: under
        symmetry the table (and so the spilled partitions) holds the
        representatives' fingerprints, not the rows' own, so they are
        computed here, on the engine's device (engine :1688-1716)."""
        if not self._use_symmetry or not len(new_vecs):
            return new_fps
        rows = self._layout.unpack(torch.from_numpy(
            np.ascontiguousarray(new_vecs).view(np.int32)).to(self._device))
        return _u64(device_fp64(self._dm.representative(rows)))

    # -- The parent log and paths --------------------------------------------

    def _parent_map(self) -> Dict[int, Optional[int]]:
        """fingerprint -> parent fingerprint (None at a root), built from
        the log as JAX builds it (engine :1825-1841): each block folded in
        once, in order, a child's first entry kept."""
        with self._lock:
            log = self._parent_log
            while self._parents_consumed < len(log):
                child, parent, rooted = log[self._parents_consumed]
                if rooted is None:
                    for f, p in zip(child.tolist(), parent.tolist()):
                        self._parents.setdefault(f, p)
                else:
                    for f, p, r in zip(child.tolist(), parent.tolist(),
                                       rooted.tolist()):
                        self._parents.setdefault(f, None if r else p)
                log[self._parents_consumed] = None
                self._parents_consumed += 1
        return self._parents

    def _parent_of(self, fp: int, blocks):
        """``(found, parent)`` of ``fp``: from the dict, else the first
        entry of the first of the log's unfolded ``blocks`` that holds
        it."""
        if fp in self._parents:
            return True, self._parents[fp]
        key = np.uint64(fp)
        for child, parent, rooted in blocks:
            hit = np.flatnonzero(child == key)
            if len(hit):
                i = hit[0]
                if rooted is not None and rooted[i]:
                    return True, None
                return True, int(parent[i])
        return False, None

    def _fingerprint_chain(self, fp: int) -> List[int]:
        """The fingerprints from a root to ``fp``, walked as JAX's
        ``_reconstruct_path`` walks its dict, without building it: each
        link a search of the log, earliest block and row first."""
        with self._lock:
            blocks = self._parent_log[self._parents_consumed:]
        chain: deque = deque()
        cur = int(fp)
        while True:
            found, source = self._parent_of(cur, blocks)
            if not found:
                break
            chain.appendleft(cur)
            if source is None:
                break
            cur = source
        return list(chain)

    def _reconstruct_path(self, fp: int) -> Path:
        """The path to ``fp`` for the visitor: the dict is built once and
        extended a wave at a time, as in JAX. Every popped row is visited
        after its parent, so the replay steps only the last link; the rows
        replayed are kept (``_replayed``) for the run."""
        self._parent_map()
        return Path.from_device_fingerprints(
            self._model, self._fingerprint_chain(fp), self._dm,
            self._replayed)

    def parent_log_bytes(self) -> int:
        """Host bytes the parent log and dict hold (the dict at 56 bytes
        an entry, CPython's smallest)."""
        with self._lock:
            blocks = [b for b in self._parent_log if b is not None]
            n_dict = len(self._parents)
        return sum(a.nbytes for b in blocks for a in b
                   if a is not None) + 56 * n_dict

    # -- Checkpoints ---------------------------------------------------------

    def _parent_sections(self):
        """``(child, parent, rooted)`` in the order of JAX's dict: the
        folded dict, then the log's blocks, each child's first entry kept
        (a stable dedup, as ``setdefault``)."""
        with self._lock:
            items = list(self._parents.items())
            blocks = self._parent_log[self._parents_consumed:]
        child = [np.fromiter((c for c, _ in items), np.uint64, len(items))]
        parent = [np.fromiter((0 if p is None else p for _, p in items),
                              np.uint64, len(items))]
        rooted = [np.fromiter((p is None for _, p in items), bool,
                              len(items))]
        for c, p, r in blocks:
            child.append(c)
            parent.append(p)
            rooted.append(np.zeros(len(c), bool) if r is None else r)
        child, parent, rooted = (np.concatenate(a) for a in (child, parent,
                                                             rooted))
        _, first = np.unique(child, return_index=True)
        if len(first) < len(child):
            keep = np.sort(first)
            child, parent, rooted = child[keep], parent[keep], rooted[keep]
        return child, parent, rooted

    def _pending_blocks(self) -> list:
        """The queue's blocks, in order (engine :563); a block the store
        paged out is read, its file kept."""
        return self._materialized(self._pending)

    def _materialized(self, blocks) -> list:
        return [self._store.load_ref(b) if isinstance(b, FrontierRef)
                else b for b in blocks]

    def _snapshot(self) -> dict:
        """The checkpoint's sections at a rest point (engine :571-627)."""
        child, parent, rooted = self._parent_sections()
        blocks = self._pending_blocks()
        layout = self._layout
        wp = layout.packed_width
        visited, refs = self._visited_section()
        header = make_header(
            model_name=checkpoint_name(self._model),
            state_width=self._dm.state_width, state_count=self._state_count,
            unique_count=self._unique_count,
            use_symmetry=self._use_symmetry, discoveries=self._discoveries,
            row_format="packed" if layout.packs else "u32",
            lane_bits=layout.specs if layout.packs else None,
            packed_width=wp if layout.packs else None, store=refs)
        return dict(
            header=header, visited=visited,
            pending_vecs=(np.concatenate([b[0] for b in blocks]) if blocks
                          else np.zeros((0, wp), np.uint32)),
            pending_fps=(np.concatenate([b[1] for b in blocks]) if blocks
                         else np.zeros(0, np.uint64)),
            pending_ebits=(np.concatenate([b[2] for b in blocks]) if blocks
                           else np.zeros(0, np.uint32)),
            parent_child=child, parent_parent=parent, parent_rooted=rooted)

    # -- Checker API -------------------------------------------------------

    def scheduler_stats(self) -> dict:
        """The host loop's telemetry under the reference's keys
        (``tpu/engine.py::scheduler_stats`` :1032): the bucket ladder and
        the waves each bucket served, the deepest pipelining, the output
        rungs the waves took and the regathers (``succ_ladder``), the
        candidates the local dedup left, the wave kernel's path, the
        expand stage's form (``wave_matmul``); and the
        graphs' captures, replays and capture seconds (None with graphs
        off)."""
        with self._lock:
            log = list(self.dispatch_log)
        succ = sum(e["successors"] for e in log)
        cand = sum(e["candidates"] for e in log)
        # A sharded wave pops a bucket a shard (engine :1055-1060).
        padded = sum(e["bucket"] for e in log) * self._n
        buckets: Dict[str, int] = {}
        out_rows: Dict[str, int] = {}
        for e in log:
            buckets[str(e["bucket"])] = buckets.get(str(e["bucket"]), 0) + 1
            out_rows[str(e["out_rows"])] = out_rows.get(
                str(e["out_rows"]), 0) + 1
        g = self._graphs
        return {
            "bucket_ladder": list(self._buckets),
            "bucket_dispatches": buckets,
            "dispatches": len(log),
            "bucket_compiles": sum(1 for e in log if e["compiled"]),
            "max_inflight": max((e["inflight"] for e in log), default=0),
            "succ_ladder": {
                "enabled": self._succ_ladder_on,
                "out_rows_dispatches": out_rows,
                "overflow_redispatches": sum(1 for e in log
                                             if e["overflow"]),
                "occupancy": (round(sum(e["rows"] for e in log) / padded, 4)
                              if padded else 0.0)},
            "wave_kernel": {"enabled": self._wave_kernel,
                            "path": self.kernel_path(),
                            "waves_per_round_trip": 1},
            "wave_matmul": self._wave_matmul_stats(),
            "store": self.store_stats(),
            "local_dedup": {
                "successors": succ, "distinct_candidates": cand,
                "collapse_ratio": (round(1.0 - cand / max(succ, 1), 4)
                                   if succ else 0.0)},
            "graphs": None if g is None else {
                "captures": g.captures, "replays": g.replays,
                "capture_sec": g.capture_sec},
            **self._obs_stats()}


#: the most table slots ``_spill_for_headroom`` reads at a time
_SPILL_CHUNK = 1 << 21


def _resident_chunks(slices: torch.Tensor):
    """``(i, keys)``: the keys of table slice ``i`` (``slices[i]``), a
    sixteenth of the slice (at most ``_SPILL_CHUNK`` slots) at a time,
    sentinels dropped, in slot order: a chunk's temporaries stay a small
    share of the table's bytes at every size."""
    step = max(1, min(_SPILL_CHUNK, slices.shape[1] // 16))
    for i in range(slices.shape[0]):
        for lo in range(0, slices.shape[1], step):
            chunk = slices[i, lo:lo + step]
            yield i, chunk[chunk != SENTINEL]


def _partition_ids(keys: torch.Tensor, P: int) -> torch.Tensor:
    """``fp % P`` of int64 bit patterns (a mask where ``P`` is a power of
    two: a 64-bit division is slow)."""
    return keys & (P - 1) if not P & (P - 1) else _umod(keys, P)


def _block_rows(block) -> int:
    """A queue block's rows, paged out or not."""
    return block.rows if isinstance(block, FrontierRef) else len(block[1])
