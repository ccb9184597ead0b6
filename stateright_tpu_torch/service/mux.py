"""Many concurrent checks in one device wave: ``MuxGroup``.

The port's copy of ``stateright_tpu/service/mux.py``. A job service
runs each job on an engine of its own, and at its target shape (many
small jobs of one model and knobs) each engine's waves are small and the
card idles between host round trips. A group admits same-shape jobs as
tenants: each group wave draws a batch from several tenants' queues at
once, the rows carrying a trailing tenant lane
(``packing.PackedLayout.with_tenant_lane``), and one ``engine.mux_wave``
expands all of them, splitting the counts per tenant by segment sums over
that lane.

Tenants share one visited table, kept apart by tags: each admission
draws a 64-bit tag (splitmix64 of an admission counter, never reused,
so a departed tenant's entries cannot collide with a newcomer's states),
and the wave XORs each row's dedup fingerprint with its tenant's tag
before the dedup. Path fingerprints stay untagged, so parent logs,
discoveries and checkpoints read real state fingerprints.

Each tenant's counts, discoveries, parents and checkpoint sections are
those of its solo run (the port's classic engine, and JAX's): its rows
are assembled contiguously in its own queue order, kernel 1's first
occurrence resolves to the earliest row (``atomicMin`` on the row), the
compaction is stable, and tags keep tenants' keys apart. That holds for
runs that exhaust their queue (or preempt-resume chains of them): an
early stop stops at a wave, which depends on the composition, so a
service multiplexes only jobs without one (``MUX_KNOBS``).

**The table on the card.** JAX rebuilds the table at each admission and
growth on the host (``_rebuild_table``, ``host_table_insert`` on one
core) and keeps a host shadow for joiners. The port rebuilds it on the
card through kernel 1's chunked insert (``fused.insert_chunked``) from
the live tenants' tagged fingerprints, and inserts a boundary's joiners
into the live table in place where nothing is dead and nothing grows,
so no shadow is kept. The table equals JAX's as a set. On the CPU the
same code runs kernel 1's plain version.

**The wave on the card** is one CUDA graph a ``(bucket, capacity)``, as
the classic engine captures its waves: the batch and the tags live in
static device buffers (the tags rewritten in place at admission), run
eagerly the first time, captured the second, replayed after, and all
dropped when the table is rebuilt.

Mux tenants keep the per-wave host boundary: the group runs in one
process on one card, a tenant failure fails that tenant, and preempt
and resume are its recovery.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..checkpoint_format import write_atomic
from ..classic import (check_error_lane, cleared_ebits, eval_host_conds,
                       fingerprint_chain, parent_sections, record_discoveries)
from ..engine import batch_bucket_ladder, mux_wave, pick_bucket
from ..fused import KERNELS, insert_chunked, read_checkpoint, snapshot_sections
from ..graphs import DispatchGraphs
from ..hashing import SENTINEL, host_fp64
from ..io.async_io import writer_from_config
from ..model import Expectation, property_predicates
from ..obs import tracer_from_env, wave_obs_from_env
from ..packing import compile_layout
from ..path import Path
from ..table import DedupScratch, load_library
from ..wave import spawn_program

__all__ = ["MuxGroup", "TenantHandle", "MUX_KNOBS"]

#: the knobs a job may set and still join a group: schedules the whole
#: group shares. Anything else (symmetry, the tiered store's budgets, a
#: target state count, whose stop depends on the composition) routes a
#: job to an engine of its own.
MUX_KNOBS = frozenset({"batch_size", "max_batch_size", "table_capacity",
                       "checkpoint_every_waves", "async_io"})

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """The tenant tag's mixer (splitmix64's finalizer)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class _Tenant:
    """One admitted job's state inside a group; its mutable fields are
    guarded by the group's condition variable."""

    __slots__ = ("id", "slot", "tag", "ckpt_path", "tracer", "pending",
                 "parent_log", "visited_blocks", "state_count",
                 "unique_count", "discoveries", "preempt_requested",
                 "preempted", "done", "error", "prog_hits", "prog_misses",
                 "waves")

    def __init__(self, job_id: str, slot: int, tag: int,
                 ckpt_path: Optional[str], tracer):
        self.id = job_id
        self.slot = slot
        self.tag = tag
        self.ckpt_path = ckpt_path
        self.tracer = tracer
        #: queued blocks ``(tenant-lane rows uint32, path fps, ebits)``
        self.pending: deque = deque()
        #: the parent log, as the classic engine's: blocks ``(child,
        #: parent, rooted or None)``, a child's first entry winning
        self.parent_log: List[tuple] = []
        #: the untagged dedup fingerprints, a block a wave (the seeds or
        #: the file's visited set first): together the tenant's visited
        #: set, which checkpoints and table rebuilds read
        self.visited_blocks: List[np.ndarray] = []
        self.state_count = 0
        self.unique_count = 0
        self.discoveries: Dict[str, int] = {}
        self.preempt_requested = False
        self.preempted = False
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.prog_hits = 0
        self.prog_misses = 0
        self.waves = 0

    def rows_queued(self) -> int:
        return sum(len(b[1]) for b in self.pending)

    def rows_visited(self) -> int:
        return sum(len(b) for b in self.visited_blocks)


#: a slot's placeholder between its reservation and the seeded admission
_RESERVED = object()


class TenantHandle:
    """What a job service holds for one tenant: the checker's count,
    discovery, preempt and join surface, backed by the shared group."""

    def __init__(self, group: "MuxGroup", tenant: _Tenant):
        self._g = group
        self._t = tenant

    @property
    def preempted(self) -> bool:
        return self._t.preempted

    def state_count(self) -> int:
        with self._g._cv:
            return self._t.state_count

    def unique_state_count(self) -> int:
        with self._g._cv:
            return self._t.unique_count

    def discoveries(self) -> Dict[str, Path]:
        return self._g._tenant_discoveries(self._t)

    def preempt(self) -> None:
        """Drains the tenant at the next wave boundary to its own
        checkpoint generation; its co-tenants run on."""
        with self._g._cv:
            self._t.preempt_requested = True
            self._g._cv.notify_all()

    def join(self) -> "TenantHandle":
        self._t.done.wait()
        if self._t.error is not None:
            raise self._t.error
        return self

    def is_done(self) -> bool:
        return self._t.done.is_set()

    def scheduler_stats(self) -> dict:
        """The group's view under JAX's keys (``mux.py:184-200``):
        ``engine`` ``"mux"``, the group's tenants now and at most, its
        waves, and the program cache's hits and misses at this tenant's
        admission."""
        g = self._g
        with g._cv:
            return {
                "engine": "mux",
                "jobs_in_group": len(g._live),
                "jobs_in_group_high_water": g._live_high_water,
                "group_waves": g._wave_count,
                "program_cache": {
                    "shared": g._prog_cache is not None,
                    "hits": self._t.prog_hits,
                    "misses": self._t.prog_misses,
                },
                "async_io": {"enabled": bool(g._aio.enabled)},
                "slo": g._wave_obs.slo_status(),
                "anomalies": g._wave_obs.anomalies(),
            }


class MuxGroup:
    """One shared engine multiplexing same-shape jobs' waves.

    The group's worker thread runs the wave loop. Tenants join at wave
    boundaries (``admit``), drain to their own checkpoint generation on
    ``preempt``, and retire one by one as each finishes, without
    disturbing the others. When the last tenant leaves, the group closes
    (a service then opens a fresh one for the next arrival).

    ``device``: a CUDA device (the current one by default, which raises
    on a machine without one), or ``"cpu"``, where the wave runs kernel
    1's plain version and no graph."""

    def __init__(self, model, *, knobs: Optional[dict] = None,
                 program_cache=None, program_key: Optional[tuple] = None,
                 trace_path: Optional[str] = None, max_jobs: int = 8,
                 device=None):
        knobs = dict(knobs or {})
        bad = set(knobs) - MUX_KNOBS
        if bad:
            raise ValueError(f"knobs {sorted(bad)} are not mux-eligible")
        self._device = _resolve_device(device)
        self._model = model
        dm = model.device_model()
        self._dm = dm
        self._properties = model.properties()
        if len(self._properties) > 32:
            raise NotImplementedError("at most 32 properties on device")
        self._prop_fns = property_predicates(self._properties, dm)
        self._ebits_all = 0
        self._eventually_idx: List[int] = []
        for i, p in enumerate(self._properties):
            if p.expectation is Expectation.EVENTUALLY:
                self._ebits_all |= 1 << i
                self._eventually_idx.append(i)

        self._B = max(1, int(knobs.get("batch_size", 1024)))
        self._buckets = batch_bucket_ladder(self._B,
                                            knobs.get("max_batch_size"))
        self._B_max = self._buckets[-1]
        self._F = dm.max_fanout
        self._W = dm.state_width
        # The port's engines always store packed rows (the identity
        # layout where packing saves nothing), so the model part of a mux
        # row is the solo engine's storage row.
        self._base = compile_layout(dm.lane_bits(), self._W)
        self._mux = self._base.with_tenant_lane()
        self._Wmux = self._base.packed_width + 1
        self._ckpt_every = max(1, int(knobs.get("checkpoint_every_waves",
                                                64)))
        self._capacity = 1 << max(12, (int(knobs.get(
            "table_capacity", 1 << 16)) - 1).bit_length())

        self._J = max(1, int(max_jobs))
        self._prog_cache = program_cache if program_key is not None \
            else None
        self._prog_key = tuple(program_key) if program_key is not None \
            else None

        self._cv = threading.Condition()
        self._slots: List = [None] * self._J
        self._tags = np.zeros(self._J, np.uint64)
        self._used_tags: set = set()
        self._live: List[_Tenant] = []
        self._joining: List[_Tenant] = []
        self._adm_seq = 0
        self._rr = 0
        self._ever = False
        self._stop = False
        self._closed = False
        self._live_rows = 0
        self._dead_rows = 0
        self._live_high_water = 0
        self._states_total = 0
        self._unique_total = 0
        self._wave_count = 0
        #: the table's rebuilds and in-place joiner inserts, and the
        #: seconds each took (to its ``full`` flag read)
        self.rebuilds: List[float] = []
        self.joins: List[float] = []

        dev = self._device
        on_card = dev.type == "cuda"
        if on_card:
            # Kernel 1's library, built and loaded once a process: a
            # failed build raises here.
            load_library()
        # The visited table (built at the first boundary), the wave's
        # static inputs and the tags, and kernel 1's scratch for a wave.
        self._visited: Optional[torch.Tensor] = None
        self._in_vecs = torch.zeros((self._B_max, self._Wmux),
                                    dtype=torch.int32, device=dev)
        self._in_valid = torch.zeros(self._B_max, dtype=torch.bool,
                                     device=dev)
        self._tag_dev = torch.zeros(self._J, dtype=torch.int64, device=dev)
        self._scratch = (DedupScratch(self._B_max * self._F, dev)
                         if on_card else None)
        self._graphs = DispatchGraphs(KERNELS) if on_card else None
        self._wave_outs: Dict[tuple, tuple] = {}
        if on_card:
            self._up_vecs = torch.empty((self._B_max, self._Wmux),
                                        dtype=torch.int32, pin_memory=True)
            self._up_valid = torch.empty(self._B_max, dtype=torch.bool,
                                         pin_memory=True)

        self._aio = writer_from_config(knobs.get("async_io"),
                                       name="stpu-aio-mux")
        self._trace_path = trace_path
        self._tracer = tracer_from_env("mux", path=trace_path, meta={
            "model": type(model).__name__, "batch_size": self._B,
            "bucket_ladder": list(self._buckets),
            "table_capacity": self._capacity, "max_jobs": self._J,
            "state_width": self._W})
        #: the group wave's latency histograms, SLOs and anomalies, over
        #: the total line's entry
        self._wave_obs = wave_obs_from_env("mux")

        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- Admission -------------------------------------------------------------

    def admit(self, job_id: str, *, trace_path: Optional[str] = None,
              checkpoint_path: Optional[str] = None,
              resume_from: Optional[str] = None
              ) -> Optional[TenantHandle]:
        """Admits one job as a tenant and returns its handle, or None
        when the group cannot take it (every slot busy, or the group
        closed): the service then opens a fresh group. The seeding (the
        init states' encoding or the checkpoint's load) runs outside the
        group's lock; the wave loop puts the tenant's fingerprints into
        the shared table at its next boundary."""
        with self._cv:
            if self._closed or self._stop:
                return None
            free = [s for s in range(self._J) if self._slots[s] is None]
            if not free:
                return None
            slot = free[0]
            self._slots[slot] = _RESERVED
            self._adm_seq += 1
            tag = _splitmix64(self._adm_seq)
            while tag in self._used_tags or tag == 0:
                self._adm_seq += 1
                tag = _splitmix64(self._adm_seq)
            self._used_tags.add(tag)
        try:
            tenant = self._build_tenant(job_id, slot, tag, trace_path,
                                        checkpoint_path, resume_from)
        except BaseException:
            with self._cv:
                self._slots[slot] = None
            raise
        # Every admission resolves the group's program through the
        # process-wide cache, so the Nth same-shape job records a hit,
        # as a solo engine's scheduler_stats do.
        self._admission_program(tenant)
        with self._cv:
            if self._closed or self._stop:
                self._slots[slot] = None
                tenant.tracer.close()
                return None
            self._slots[slot] = tenant
            self._tags[slot] = np.uint64(tag)
            self._joining.append(tenant)
            self._cv.notify_all()
        return TenantHandle(self, tenant)

    def _build_tenant(self, job_id, slot, tag, trace_path, ckpt_path,
                      resume_from) -> _Tenant:
        tracer = tracer_from_env("mux", path=trace_path, meta={
            "model": type(self._model).__name__, "job": job_id,
            "mux_slot": slot})
        t = _Tenant(job_id, slot, tag, ckpt_path, tracer)
        if resume_from is not None:
            self._load_tenant_checkpoint(t, resume_from)
            return t
        # The solo engine's seeding (``fused.BfsEngine._init_rows``).
        init_states = self._model.init_states()
        seen: Dict[int, None] = {}
        vecs: List[np.ndarray] = []
        for s in init_states:
            vec = np.asarray(self._dm.encode(s), np.uint32)
            fp = host_fp64(vec)
            if fp not in seen:
                seen[fp] = None
                vecs.append(vec)
        fps = np.array(list(seen), np.uint64)
        t.state_count = len(init_states)
        t.unique_count = len(fps)
        if vecs:
            t.pending.append((self._rows_with_tag(np.stack(vecs), slot),
                              fps, np.full(len(fps), self._ebits_all,
                                           np.uint32)))
        t.parent_log = [(fps, np.zeros(len(fps), np.uint64),
                         np.ones(len(fps), bool))]
        t.visited_blocks = [fps]
        return t

    def _load_tenant_checkpoint(self, t: _Tenant, path: str) -> None:
        """The solo engine's resume for one tenant (``read_checkpoint``):
        the counts, discoveries, queue, parent sections and visited set of
        a snapshot of either package's engines or of a group (their
        sections are equal); a v5 file's cold segments are read into the
        visited set (the group has no store)."""
        img = read_checkpoint(path, self._model, self._base, self._W, False)
        t.state_count, t.unique_count = img.state_count, img.unique_count
        t.discoveries = img.discoveries
        if len(img.fps):
            t.pending.append((self._rows_with_tag(img.rows, t.slot), img.fps,
                              img.ebits))
        t.parent_log = [img.parents]
        t.visited_blocks = [img.visited]

    def _rows_with_tag(self, model_rows: np.ndarray,
                       slot: int) -> np.ndarray:
        """Unpacked model rows as tenant-lane rows of ``slot``."""
        model_rows = np.asarray(model_rows, np.uint32)
        self._base.check_fits(model_rows)
        return self._mux.pack_tenant_np(
            model_rows, np.full(len(model_rows), slot, np.uint32))

    # -- The shared program ----------------------------------------------------

    def _admission_program(self, tenant: _Tenant) -> None:
        """Resolves the group's program through the process-wide cache
        under JAX's key (``mux.py:461-463``: the model key, ``mux``,
        packing, symmetry, the slots, the batch), so the Nth same-shape
        job records a hit, as a solo engine's ``scheduler_stats`` do. The
        program is the dedup path's ``wave.SpawnProgram``: no matmul
        classification (a group expands by the model's step), and on the
        card kernel 1's library, already loaded with the group."""
        if self._prog_cache is None:
            return
        key = (self._prog_key, "mux", self._base.packs, False, self._J,
               self._B)
        _, hit = self._prog_cache.get_or_build(key, lambda: spawn_program(
            self._dm, self._base, self._device, False, False, False))
        if hit:
            tenant.prog_hits += 1
        else:
            tenant.prog_misses += 1

    # -- The shared visited table ----------------------------------------------

    def _tagged_keys(self, tenants) -> torch.Tensor:
        """The tenants' visited sets XORed with their tags, int64 bit
        patterns on the group's device."""
        parts = [np.concatenate(t.visited_blocks) ^ np.uint64(t.tag)
                 for t in tenants if t.visited_blocks]
        keys = (np.concatenate(parts) if parts else np.zeros(0, np.uint64))
        return torch.from_numpy(keys.view(np.int64)).to(self._device)

    def _insert(self, keys: torch.Tensor, table: torch.Tensor) -> None:
        """Kernel 1's chunked insert of distinct ``keys`` into ``table``
        with the group's scratch (its plain version on the CPU)."""
        with self._on_device():
            full, _ = insert_chunked(keys, table, self._scratch,
                                     self._B_max * self._F)
            if bool(full):
                raise RuntimeError("the mux table's rebuild found no free "
                                   "slot")

    def _rebuild_table(self) -> None:
        """Builds the table anew from the live tenants' tagged
        fingerprints (dropping dead tenants' entries), growing the
        capacity first if needed: at admission, growth and the compaction
        of dead entries, at a wave boundary. Every wave graph goes: they
        hold the old table."""
        t0 = time.monotonic()
        while self._capacity // 2 < (self._live_rows
                                     + 2 * self._B_max * self._F):
            self._capacity *= 2
        self._drop_graphs()
        table = torch.full((self._capacity,), SENTINEL, dtype=torch.int64,
                           device=self._device)
        self._insert(self._tagged_keys(self._live), table)
        self._visited = table
        self._dead_rows = 0
        self.rebuilds.append(time.monotonic() - t0)

    def _integrate_joiners(self, joiners) -> None:
        """Puts a boundary's joiners into the table: in place, by kernel
        1, where the table holds no dead entries and needs no growth (the
        wave graphs stay), else by a rebuild. Slot placement may differ
        from a rebuild's; membership, all a probe sees, cannot."""
        if (self._visited is None or self._dead_rows
                or self._capacity // 2 < (self._live_rows
                                          + 2 * self._B_max * self._F)):
            self._rebuild_table()
            return
        t0 = time.monotonic()
        self._insert(self._tagged_keys(joiners), self._visited)
        self.joins.append(time.monotonic() - t0)

    def _table_stale(self) -> bool:
        occupied = self._live_rows + self._dead_rows
        return (self._visited is None
                or occupied + 2 * self._B_max * self._F
                > self._capacity // 2
                or self._dead_rows > max(self._live_rows, 4096))

    def _drop_graphs(self) -> None:
        if self._graphs is not None:
            self._graphs.clear()
        self._wave_outs.clear()

    def _on_device(self):
        return (torch.cuda.device(self._device)
                if self._device.type == "cuda" else contextlib.nullcontext())

    # -- The wave loop ---------------------------------------------------------

    def _run(self) -> None:
        try:
            while True:
                with self._cv:
                    while not (self._joining or self._live
                               or self._stop or self._ever):
                        self._cv.wait(timeout=0.5)
                    if not self._joining and not self._live:
                        # Drained (or stopped before the first admission):
                        # the group is done for good.
                        self._closed = True
                        return
                    joiners, self._joining = self._joining, []
                    if joiners:
                        self._ever = True
                        self._live.extend(joiners)
                        for t in joiners:
                            self._live_rows += t.rows_visited()
                        self._live_high_water = max(
                            self._live_high_water, len(self._live))
                        tags = torch.from_numpy(self._tags.view(np.int64))
                    if self._stop:
                        for t in self._live:
                            t.preempt_requested = True
                if joiners:
                    # The static tag buffer, rewritten in place: the
                    # graphs read it at each replay.
                    with self._on_device():
                        self._tag_dev.copy_(tags)
                    self._integrate_joiners(joiners)
                # The boundary: finished tenants retire first (a run that
                # drained completed, as the solo loop ends before it
                # checks the preempt flag), then preempted ones, each to
                # its own checkpoint generation.
                for t in list(self._live):
                    if (not t.pending
                            or len(t.discoveries) == len(self._properties)):
                        self._retire(t, preempted=False)
                for t in list(self._live):
                    if t.preempt_requested:
                        self._retire(t, preempted=True)
                if not self._live:
                    continue
                if self._wave_count % self._ckpt_every == 0 \
                        and self._wave_count:
                    # A safe point: the last generation lands (its
                    # writer's failure raises here, the group's) before
                    # the next one starts.
                    self._aio.join()
                    for t in self._live:
                        if t.ckpt_path is not None:
                            self._write_tenant_checkpoint(t)
                if self._table_stale():
                    old = self._capacity
                    self._rebuild_table()
                    if self._tracer.enabled and self._capacity != old:
                        self._tracer.event("grow", kind="table", old=old,
                                           new=self._capacity)
                self._wave()
            self._aio.join()
        except BaseException as e:  # surfaced at every tenant's join()
            with self._cv:
                self._closed = True
                pending = self._live + self._joining
                self._live, self._joining = [], []
                for t in pending:
                    if t.error is None:
                        t.error = e
            for t in pending:
                t.tracer.close()
                t.done.set()
        finally:
            with self._cv:
                self._closed = True
            if self._wave_obs.enabled:
                self._wave_obs.close(self._tracer)
            self._tracer.close()

    def _allocate(self, order, queued) -> list:
        """Each tenant's rows of the next wave (``mux.py:651-671``): equal
        shares of the budget first (from a rotated start, so no tenant
        owns the front of the batch), then what is left to whoever still
        has rows."""
        budget = min(sum(queued), self._B_max)
        share = budget // len(order)
        alloc = [min(q, share) for q in queued]
        left = budget - sum(alloc)
        for i, q in enumerate(queued):
            if left <= 0:
                break
            extra = min(q - alloc[i], left)
            alloc[i] += extra
            left -= extra
        return alloc

    def _wave(self) -> None:
        with self._cv:
            k = self._rr % len(self._live)
            order = self._live[k:] + self._live[:k]
            self._rr += 1
            queued = [t.rows_queued() for t in order]
        alloc = self._allocate(order, queued)
        bucket = pick_bucket(self._buckets, sum(alloc))
        batch_vecs = np.zeros((bucket, self._Wmux), np.uint32)
        batch_fps = np.zeros(bucket, np.uint64)
        batch_ebits = np.zeros(bucket, np.uint32)
        segments: List[tuple] = []
        row = 0
        for t, take in zip(order, alloc):
            if not take:
                continue
            lo = row
            taken = 0
            while t.pending and taken < take:
                vecs, fps, ebits = t.pending[0]
                use = min(len(fps), take - taken)
                if use == len(fps):
                    t.pending.popleft()
                else:
                    t.pending[0] = (vecs[use:], fps[use:], ebits[use:])
                batch_vecs[row:row + use] = vecs[:use]
                batch_fps[row:row + use] = fps[:use]
                batch_ebits[row:row + use] = ebits[:use]
                row += use
                taken += use
            segments.append((t, lo, row))
        valid = np.arange(bucket) < row
        compiled = self._launch(bucket, batch_vecs, valid)
        self._process(segments, bucket, row, batch_vecs, batch_fps,
                      batch_ebits, valid, compiled, *self._fetch())

    def _launch(self, bucket: int, batch_vecs: np.ndarray,
                valid: np.ndarray) -> bool:
        """Runs the wave on the batch (``engine.mux_wave``), on the card
        through the graph of ``(bucket, capacity)``; reads nothing back.
        Returns whether the wave captured its graph."""
        key = (bucket, self._capacity)
        vecs, ok = self._in_vecs[:bucket], self._in_valid[:bucket]

        def run():
            return mux_wave(self._dm, vecs, ok, self._tag_dev,
                            self._visited, self._mux, self._prop_fns,
                            scratch=self._scratch)

        self._last_key = key
        if self._graphs is None:
            vecs.copy_(torch.from_numpy(batch_vecs.view(np.int32)))
            ok.copy_(torch.from_numpy(valid))
            self._wave_outs[key] = run()
            return False
        with self._on_device():
            self._up_vecs.numpy()[:bucket] = batch_vecs.view(np.int32)
            self._up_valid.numpy()[:bucket] = valid
            vecs.copy_(self._up_vecs[:bucket], non_blocking=True)
            ok.copy_(self._up_valid[:bucket], non_blocking=True)

            def capture():
                self._wave_outs[key] = run()

            return self._graphs.run(key, capture)

    def _fetch(self):
        """The last wave's outputs on the host, in two reads: the counts,
        the device predicates' masks and ``terminal`` in one vector, then
        the new rows only (``new_count`` of them). ``new_dedup`` is
        ``new_fps`` (a group takes no symmetry), read once."""
        (conds, terminal, seg_succ, seg_cand, seg_novel, new_count,
         new_vecs, new_fps, _, new_parent, full) = \
            self._wave_outs[self._last_key]
        J, B = self._J, terminal.shape[0]
        with self._on_device():
            head = torch.cat([
                seg_succ, seg_cand, seg_novel,
                new_count.reshape(1).to(torch.int64),
                full.reshape(1).to(torch.int64),
                torch.stack(list(conds) + [terminal]).reshape(-1).to(
                    torch.int64)]).cpu().numpy()
            if head[3 * J + 1]:
                raise RuntimeError("the visited table filled up: a "
                                   "candidate found no free slot")
            k = int(head[3 * J])
            masks = head[3 * J + 2:].reshape(-1, B).astype(bool)
            fps = new_fps[:k].cpu().numpy().view(np.uint64)
            return (list(masks[:-1]), masks[-1], head[:J], head[J:2 * J],
                    head[2 * J:3 * J], k,
                    new_vecs[:k].cpu().numpy().view(np.uint32), fps, fps,
                    new_parent[:k].cpu().numpy().astype(np.int64))

    def _process(self, segments, bucket, n, batch_vecs, batch_fps,
                 batch_ebits, valid, compiled, conds_out, terminal,
                 seg_succ, seg_cand, seg_novel, k, new_vecs, new_fps,
                 new_dedup, parent_rows) -> None:
        """Splits a wave's outputs by tenant (``mux.py:742-880``): each
        tenant's counts, discoveries in its own queue order, parent log,
        queue and visited blocks; then the group's trace lines."""
        properties = self._properties
        # The classic engine's own steps, on the rows' model words (the
        # tenant word dropped) and, for the discoveries, on each tenant's
        # contiguous rows.
        conds = eval_host_conds(self._model, self._dm, self._base,
                                properties, self._prop_fns, conds_out,
                                batch_vecs[:, :-1], range(n))
        ebits_after = cleared_ebits(self._eventually_idx, conds, batch_ebits)
        jobs_in_wave = len(segments)
        succ_total = cand_total = 0
        per_job: List[tuple] = []
        # A tenant's rows are contiguous, and the compaction is stable, so
        # its new rows are one contiguous run of the wave's (their parent
        # rows never decrease).
        bounds = np.searchsorted(parent_rows, [lo for _, lo, _ in segments]
                                 + [segments[-1][2]] if segments else [])
        for j, (t, lo, hi) in enumerate(segments):
            sel = slice(int(bounds[j]), int(bounds[j + 1]))
            t_k = sel.stop - sel.start
            t_succ = int(seg_succ[t.slot])
            t_cand = int(seg_cand[t.slot])
            if t_k != int(seg_novel[t.slot]):
                raise RuntimeError(
                    f"mux wave split inconsistency: segment of job {t.id} "
                    f"claims {int(seg_novel[t.slot])} novel rows, parent "
                    f"ranges yield {t_k}")
            succ_total += t_succ
            cand_total += t_cand
            failure: Optional[BaseException] = None
            try:
                check_error_lane(self._dm, self._base, new_vecs[sel][:, :-1])
            except RuntimeError as e:
                failure = e
            with self._cv:
                t.state_count += t_succ
                # The first hits in the tenant's queue order, its rows
                # being contiguous and in order (the solo rule).
                record_discoveries(
                    t.discoveries, properties, self._eventually_idx,
                    [c[lo:hi] for c in conds], valid[lo:hi], terminal[lo:hi],
                    ebits_after[lo:hi], batch_fps[lo:hi])
                if t_k and failure is None:
                    parents = parent_rows[sel]
                    t.parent_log.append((new_fps[sel], batch_fps[parents],
                                         None))
                    t.unique_count += t_k
                    t.pending.append((new_vecs[sel], new_fps[sel],
                                      ebits_after[parents]))
                    t.visited_blocks.append(new_dedup[sel])
                    self._live_rows += t_k
                elif t_k:
                    # The failed tenant's insertions stay in the table as
                    # dead entries until the next rebuild.
                    self._dead_rows += t_k
                if failure is not None:
                    t.error = failure
                t.waves += 1
            per_job.append((t, hi - lo, t_succ, t_cand, t_k))
        with self._cv:
            self._states_total += succ_total
            self._unique_total += k
            self._wave_count += 1
            states, unique = self._states_total, self._unique_total
        for t, _, _, _, _ in per_job:
            if t.error is not None and not t.done.is_set():
                self._retire_failed(t)
        total_entry = None
        if self._tracer.enabled or self._wave_obs.enabled:
            total_entry = self._wave_entry(
                states, unique, bucket, n, succ_total, cand_total, k,
                compiled, None, jobs_in_wave)
        if self._tracer.enabled:
            # One total line (job_id null) and then exactly
            # ``jobs_in_wave`` attributed lines whose deltas sum to it:
            # the v9 split. Every line carries the group's cumulative
            # states and unique; a tenant's own are in its own trace.
            self._tracer.wave(total_entry)
            for t, t_rows, t_succ, t_cand, t_k in per_job:
                self._tracer.wave(self._wave_entry(
                    states, unique, bucket, t_rows, t_succ, t_cand, t_k,
                    False, t.id, jobs_in_wave))
        if self._wave_obs.enabled:
            self._wave_obs.wave(total_entry, self._tracer)
        for t, t_rows, t_succ, t_cand, t_k in per_job:
            if t.tracer.enabled:
                with self._cv:
                    t_states, t_unique = t.state_count, t.unique_count
                t.tracer.wave(self._wave_entry(
                    t_states, t_unique, bucket, t_rows, t_succ, t_cand, t_k,
                    compiled, t.id, jobs_in_wave))

    def kernel_path(self) -> str:
        """The wave's dedup: ``dedup_kernel`` (kernel 1) on the card,
        ``dedup_plain`` on the CPU."""
        return ("dedup_kernel" if self._device.type == "cuda"
                else "dedup_plain")

    def _wave_entry(self, states, unique, bucket, rows, succ, cand,
                    novel, compiled, job_id, jobs_in_wave) -> dict:
        occupied = self._live_rows + self._dead_rows
        return {
            "states": int(states), "unique": int(unique),
            "bucket": int(bucket), "waves": 1, "inflight": 0,
            "compiled": bool(compiled), "successors": int(succ),
            "candidates": int(cand), "novel": int(novel),
            "out_rows": int(bucket * self._F),
            "capacity": int(self._capacity),
            "load_factor": round(occupied / self._capacity, 4),
            "overflow": False, "bytes_per_state": 4 * self._Wmux,
            "arena_bytes": None, "table_bytes": self._capacity * 8,
            "kernel_path": self.kernel_path(), "rows": int(rows),
            "job_id": job_id, "jobs_in_wave": int(jobs_in_wave),
        }

    # -- Retirement and checkpoints --------------------------------------------

    def _retire(self, t: _Tenant, preempted: bool) -> None:
        # A pending writer failure of another tenant's generation raises
        # first, as the group's, before this tenant's last one.
        self._aio.join()
        try:
            if t.ckpt_path is not None:
                self._write_tenant_checkpoint(t)
                # The last generation lands before the tenant is done:
                # a client reads the file right after join().
                self._aio.join()
        except (OSError, RuntimeError, ValueError) as e:
            t.error = e
        with self._cv:
            t.preempted = preempted and t.error is None
            self._release(t)
        t.tracer.close()
        t.done.set()

    def _retire_failed(self, t: _Tenant) -> None:
        with self._cv:
            if t in self._live:
                self._release(t)
        t.tracer.close()
        t.done.set()

    def _release(self, t: _Tenant) -> None:
        """Frees a leaving tenant's slot; its rows stay in the table as
        dead entries. The caller holds the lock."""
        self._live.remove(t)
        self._slots[t.slot] = None
        rows = t.rows_visited()
        self._live_rows -= rows
        self._dead_rows += rows

    def _write_tenant_checkpoint(self, t: _Tenant) -> None:
        """Takes the tenant's snapshot now and hands its write to the
        group's writer (the tenants' generations in order)."""
        payload = self._tenant_snapshot(t)
        path = t.ckpt_path
        self._aio.submit(lambda: write_atomic(path, payload))

    def _tenant_snapshot(self, t: _Tenant) -> dict:
        """The solo classic engine's snapshot for one tenant
        (``snapshot_sections``): the visited set sorted, the queue's rows
        with the tenant word dropped and the parent sections in the log's
        order, so the sections equal its solo run's."""
        with self._cv:
            blocks = list(t.pending)
            log = list(t.parent_log)
            visited_blocks = list(t.visited_blocks)
            state_count, unique_count = t.state_count, t.unique_count
            discoveries = dict(t.discoveries)
        visited = (np.sort(np.concatenate(visited_blocks))
                   if visited_blocks else np.zeros(0, np.uint64))
        return snapshot_sections(
            self._model, self._base, self._W, False, state_count,
            unique_count, discoveries, visited, None,
            [(v[:, :-1], f, e) for v, f, e in blocks], parent_sections(log))

    # -- Paths and discoveries -------------------------------------------------

    def _tenant_discoveries(self, t: _Tenant) -> Dict[str, Path]:
        with self._cv:
            found = list(t.discoveries.items())
            log = list(t.parent_log)
        return {name: Path.from_device_fingerprints(
                    self._model, fingerprint_chain(fp, log, {}), self._dm)
                for name, fp in found}

    # -- Lifecycle -------------------------------------------------------------

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def jobs_in_group(self) -> int:
        with self._cv:
            return len(self._live) + len(self._joining)

    def close(self, timeout: float = 30.0) -> None:
        """Stops the group: live tenants preempt (each drains to its
        checkpoint), then the loop ends. Idempotent."""
        with self._cv:
            self._stop = True
            for t in self._live:
                t.preempt_requested = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)

    def join(self, timeout: Optional[float] = None) -> None:
        """Waits for the group's worker thread, which outlives its last
        tenant's ``join()`` by its closing steps: join it before the
        interpreter exits, so no daemon thread is still freeing tensors
        then."""
        self._thread.join(timeout=timeout)


def _resolve_device(device) -> torch.device:
    """The group's device: the current CUDA device by default (raising on
    a machine without one), or the one given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("MuxGroup needs a CUDA device and none is "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
