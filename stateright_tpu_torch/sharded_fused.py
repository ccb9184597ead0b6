"""The sharded fused BFS: per-shard device arenas and an in-dispatch
exchange, driven from one process.

The port's copy of ``stateright_tpu/tpu/sharded_fused.py::
ShardedFusedTpuBfsChecker`` on the port's fused engine (``fused.py``).

- **Shards.** Shard ``i`` owns the fingerprints of its partition
  (``fp % n``, through ``membership.OwnerMap``): the slice ``i`` of the
  visited table and an arena of its own, rows ``[head_i, tail_i)`` its
  share of the queue. The shards of one device are stacked along a
  leading axis (``mesh.py``): the table is ``int64[n, cap]``, the arena
  columns ``[n, ucap + 1, ...]`` with each shard's dump row at ``ucap``.
- **A wave**, for every shard at once: properties and first hits, the
  successors' front half (the sender kernel ``wave.sender_megakernel``
  with ``wave_kernel=True``, else torch stages), eventually bits, the
  owner bucketing into ``n * S`` rows a shard (``S = B * F``) and the
  exchange (``Mesh.all_to_all`` of five arrays), both in ``route_home``,
  which the classic sharded engine (``sharded.py``) shares; the owner's
  insert into its own table slice (``table.dedup_and_insert``, one call
  a shard), compaction, and the appends at each shard's tail (one launch of
  the append kernel, ``append.py``, for every shard). With
  ``exchange_novel_only`` (the default) a sender keeps only the first
  occurrence of each fingerprint among its own successors.
- **Lockstep.** As in JAX, one global ``go`` predicate, from reductions
  over the shard axis, masks every shard's wave: live rows anywhere, no
  error, and ``R = n * S`` rows of headroom in the fullest shard's arena
  and table. A dispatch launches K waves and reads nothing back; the
  host loop, its in-flight depth, the bucket ladder (the bucket from the
  fullest shard's queue) and the dispatch graphs are the fused engine's.
- **Discovery order is shard-major**: the lowest shard with a hit wins,
  and within it the first row.
- **Paths.** A row lives at the owner of its dedup fingerprint, while its
  parent link is a path fingerprint (they differ under symmetry), so a
  chain walk searches every shard's rows.

- **Checkpoints** are the fused engine's, with the queue's rows taken
  shard by shard and the parent sections in JAX's per-shard sync order;
  a resumed run splits the pending rows over the arenas and the visited
  set over the table slices by owner, each slice built by the dedup
  kernel. A file crosses between the two engines either way.

- **The tiered store** (``store/tiered.py``): the arena-span roll for
  each shard (``_roll_span``) under a device budget, as the unsharded
  fused engine's; the visited table is never spilled.

- **Telemetry** (``obs``): the fused engine's, each dispatch's wave
  event with the reference's fields (:588-643: the rows every shard
  consumed, the fullest slice's load factor, every shard's arena and
  slice bytes, the ownership ``epoch``), ``grow`` events at each
  doubling, the profiler's record from the sender kernel's, the ``n``
  inserts' and the append's declared costs.

- **Faults** (``resilience/``): the fused engine's ``wave_crash`` in
  ``_retire`` (:552-556) and its growth's ``grow_oom`` and OOM degrade
  (:678), around this engine's ``_grow_at``; a supervised run resumes in
  place (``restart_from``). Not ported: an ownership remap and the
  elastic workers (ROADMAP A13 (c)).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from .append import append_cost, append_rows
from .engine import (compaction_order, eval_properties,
                     fingerprint_successors, first_occurrence_sorted,
                     pick_bucket)
from .fused import (ERR_LANE, ERR_TABLE_FULL, ST_CAND, ST_DISC, ST_ERR,
                    ST_HEAD, ST_OCC, ST_SUCC, ST_TAIL, ST_TARGET, ST_WAVES,
                    FusedCudaBfsChecker, _i32, _pow2, _shift_down, _u32,
                    _u64)
from .hashing import SENTINEL, SENTINEL_U64, to_u64
from .matmul_wave import expand
from .membership import EpochOwnership, OwnerMap
from .mesh import _umod, route_home  # noqa: F401 (_umod: tests read it here)
from .model import Expectation
from .table import dedup_and_insert, dedup_cost
from .wave import sender_cost, sender_megakernel

__all__ = ["ShardedFusedCudaBfsChecker"]


def _combine_first(disc, hit, fps):
    """Keeps the first hit's fingerprint, once: the lowest shard with a
    hit, and its first row (``hit``, ``fps`` are ``[n, B]``)."""
    row = hit.to(torch.int32).argmax(dim=1, keepdim=True)
    first_fp = fps.gather(1, row).squeeze(1)
    has = hit.any(dim=1)
    winner = has.to(torch.int32).argmax().reshape(1)
    first = first_fp.index_select(0, winner).reshape(())
    return torch.where((disc == SENTINEL) & has.any(), first, disc)


class ShardedFusedCudaBfsChecker(EpochOwnership, FusedCudaBfsChecker):
    """The fused engine over a mesh of stacked shards. ``batch_size`` is
    per shard."""

    _ENGINE_ID = "sharded_fused"
    _SENDER_KERNEL = True
    _POLLS_PREEMPT = False

    def __init__(self, builder, mesh, batch_size: int = 512,
                 exchange_novel_only=None, **kwargs):
        self._mesh = mesh
        self._n = mesh.n
        self._owner_map = OwnerMap.identity(self._n)
        self._exchange_novel = (True if exchange_novel_only is None
                                else bool(exchange_novel_only))
        # The owner of each fingerprint partition, made here at rest and
        # not inside a dispatch (None at the identity map).
        self._assign = (None if self._owner_map.is_identity else torch.tensor(
            self._owner_map.assignment(), dtype=torch.int64,
            device=mesh.device))
        super().__init__(builder, mesh.device, batch_size=batch_size,
                         **kwargs)

    # -- Seeding -------------------------------------------------------------

    def _new_table(self, visited: np.ndarray, resumed: bool) -> torch.Tensor:
        """The stacked table (``_stacked_table``); sets each shard's
        occupancy."""
        table, self._occs = self._stacked_table(visited, resumed)
        return table

    def _seed(self, seed, fps, ebits, visited, resumed: bool) -> None:
        """Splits the seeds by owner (the table by the dedup
        fingerprints, the arenas by the path fingerprints, as JAX's
        ``_new_table`` and ``_run_waves`` do, :478-497) and builds the
        stacked table, arenas and per-shard stats."""
        n, device = self._n, self._device
        self._table = self._new_table(visited, resumed)

        owner = self._owners(fps)
        tails = np.bincount(owner, minlength=n).astype(np.int64)
        R = n * self._B_max * self._F
        max_seed = int(tails.max(initial=0))
        ucap = self._arena_capacity or max(1 << 14, 4 * R, _pow2(max_seed))
        ucap = max(_pow2(ucap), _pow2(max_seed))
        self._ucap = ucap
        wp = self._layout.packed_width
        vecs = np.zeros((n, ucap + 1, wp), np.uint32)
        afps = np.full((n, ucap + 1), SENTINEL_U64, np.uint64)
        aebits = np.zeros((n, ucap + 1), np.uint32)
        for i in range(n):
            k = int(tails[i])
            vecs[i, :k] = seed[owner == i]
            afps[i, :k] = fps[owner == i]
            aebits[i, :k] = ebits[owner == i]
        self._vecs = torch.from_numpy(vecs.view(np.int32)).to(device)
        self._fps = torch.from_numpy(afps.view(np.int64)).to(device)
        self._par = torch.full_like(self._fps, SENTINEL)
        self._ebits = torch.from_numpy(aebits.view(np.int32)).to(device)

        self._heads, self._tails = np.zeros(n, np.int64), tails
        # The parent log, as JAX keeps it a shard at a time (:530,
        # :820-836): each shard's rows past its seeds go to the parent
        # sections in the segments each sync took, shard by shard.
        self._n_seeds, self._shard_synced = tails.copy(), tails.copy()
        self._segments: List[tuple] = []
        self._parent_blocks: List[tuple] = []
        P = len(self._properties)
        stats = np.zeros((n, ST_DISC + P), np.int64)
        stats[:, ST_TAIL] = tails
        stats[:, ST_OCC] = self._occs
        stats[:, ST_TARGET] = self._target_left()
        stats[:, ST_DISC:] = SENTINEL
        self._stats = torch.from_numpy(stats).to(device)

    def _scratch_shape(self):
        """``DedupScratch``'s rows and shards: the rows of one owner-side
        insert, every row a shard may receive (``R = n * S``), and the
        sender kernel's ``n`` shards of ``S`` rows, at the widest bucket.
        The sender and the ``n`` inserts of a wave share one scratch, in
        stream order."""
        return self._n * self._B_max * self._F, self._n

    # -- Device dispatch -----------------------------------------------------

    def _dispatch(self, bucket: int) -> None:
        """Runs K waves of ``bucket`` rows a shard on every shard from
        ``self._stats`` ``[n, L]`` and writes the next stats into it in
        place; reads nothing back."""
        dm, layout, mesh = self._dm, self._layout, self._mesh
        n, B, F = self._n, bucket, self._F
        ucap, cap = self._ucap, self._capacity
        W, wp = dm.state_width, layout.packed_width
        S = B * F
        R = n * S          # rows an owner may receive
        P = len(self._properties)
        dev = self._device
        st = self._stats
        head, tail, occ, err = (st[:, i] for i in (ST_HEAD, ST_TAIL, ST_OCC,
                                                   ST_ERR))
        succ_total, cand_total, target = (st[0, i] for i in (
            ST_SUCC, ST_CAND, ST_TARGET))
        waves = torch.zeros((), dtype=torch.int64, device=dev)
        disc = list(st[0, ST_DISC:].unbind())
        rb = torch.arange(B, dtype=torch.int64, device=dev)
        shard = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
        arena_row = shard * (ucap + 1)    # each shard's first arena row
        arena = (self._vecs, self._fps, self._par, self._ebits)
        vecs = self._vecs.view(n * (ucap + 1), wp)
        fps_a, eb_a = self._fps.view(-1), self._ebits.view(-1)
        for _ in range(self._K):
            # The reference's while_loop condition, every operand reduced
            # over the shards (sharded_fused.py:339-353).
            go = ((mesh.psum(tail - head) > 0) & (mesh.pmax(err) == 0)
                  & (mesh.pmax(tail) + R <= ucap)
                  & (mesh.pmax(occ) + R <= cap // 2)
                  & (succ_total < target))
            if P:
                go = go & ~(torch.stack(disc) != SENTINEL).all()
            idx = head[:, None] + rb
            valid = (idx < tail[:, None]) & go
            flat = (arena_row + idx.clamp(max=ucap - 1)).reshape(-1)
            bstore = vecs.index_select(0, flat).view(n, B, wp)
            rows = layout.unpack(bstore).view(n * B, W)
            bfps = fps_a.index_select(0, flat).view(n, B)
            bebits = eb_a.index_select(0, flat).view(n, B)

            conds = [c.view(n, B)
                     for c in eval_properties(self._prop_fns, rows)]
            for i, prop in enumerate(self._properties):
                if prop.expectation is Expectation.ALWAYS:
                    disc[i] = _combine_first(disc[i], valid & ~conds[i],
                                             bfps)
                elif prop.expectation is Expectation.SOMETIMES:
                    disc[i] = _combine_first(disc[i], valid & conds[i], bfps)

            if self._wave_kernel:
                succ_store, dedup_fps, path_fps, sflat, send_mask = \
                    sender_megakernel(dm, bstore, valid, self._use_symmetry,
                                      layout, self._exchange_novel,
                                      scratch=self._scratch,
                                      plan=self._matmul_plan)
                succ_count = sflat.sum(dtype=torch.int64)
                terminal = valid & ~sflat.view(n, B, F).any(dim=2)
            else:
                succ, sflat, succ_count, terminal = expand(
                    dm, self._matmul_plan, rows, valid.reshape(n * B))
                dedup_fps, path_fps = fingerprint_successors(
                    dm, succ, sflat, self._use_symmetry)
                dedup_fps, path_fps, sflat = (
                    t.view(n, S) for t in (dedup_fps, path_fps, sflat))
                terminal = terminal.view(n, B)
                send_mask = (first_occurrence_sorted(dedup_fps)
                             if self._exchange_novel else sflat)
                succ_store = layout.pack(succ).view(n, S, wp)
            parent_fps = bfps[:, :, None].expand(n, B, F).reshape(n, S)

            cleared = bebits
            for i, prop in enumerate(self._properties):
                if prop.expectation is Expectation.EVENTUALLY:
                    cleared = torch.where(conds[i], cleared & ~_i32(1 << i),
                                          cleared)
            for i, prop in enumerate(self._properties):
                if prop.expectation is Expectation.EVENTUALLY:
                    hit = valid & terminal & (((cleared >> i) & 1) != 0)
                    disc[i] = _combine_first(disc[i], hit, bfps)
            child_ebits = cleared[:, :, None].expand(n, B, F).reshape(n, S)

            # Each sender's rows to their owners (``route_home``).
            recv_vecs, recv_dedup, recv_path, recv_parent, recv_ebits = \
                route_home(mesh, dedup_fps, send_mask, self._assign, (
                    (succ_store, 0), (dedup_fps, SENTINEL),
                    (path_fps, SENTINEL), (parent_fps, SENTINEL),
                    (child_ebits, 0)))

            # The owner's insert into its own table slice.
            owned = [dedup_and_insert(recv_dedup[k], self._table[k],
                                      scratch=self._scratch)
                     for k in range(n)]
            new_mask = torch.stack([o[0] for o in owned])
            new_count = torch.stack([o[2] for o in owned]).to(torch.int64)
            cand_count = torch.stack([o[3] for o in owned]).sum(
                dtype=torch.int64)
            full = torch.stack([o[4] for o in owned])
            comp = compaction_order(new_mask)

            if dm.error_lane is not None:
                bad = ((layout.lane(recv_vecs, dm.error_lane) != 0)
                       & new_mask).any(dim=1)
                err = err | torch.where(bad, ERR_LANE, 0)
            err = err | torch.where(full, ERR_TABLE_FULL, 0)

            # Append each shard's new rows at its tail, in the order it
            # received them, each with its own parent and eventually bits.
            append_rows(arena, (recv_vecs, recv_path, recv_parent,
                                recv_ebits), comp, new_count,
                        tail.contiguous(), 1)

            head = torch.where(go, torch.minimum(head + B, tail), head)
            tail = tail + new_count
            occ = occ + new_count
            succ_total = succ_total + succ_count
            cand_total = cand_total + cand_count
            waves = waves + go
        # The ST_* row layout, one row a shard (the shared values
        # repeated), so the next dispatch chains on it.
        st.copy_(torch.stack(
            [head, tail, occ] + [x.expand(n) for x in (succ_total,
                                                      cand_total, target)]
            + [err, waves.expand(n)] + [d.expand(n) for d in disc], dim=1))

    # -- Host loop ------------------------------------------------------------

    def _live(self) -> bool:
        return bool((self._tails > self._heads).any())

    def _pick_bucket(self) -> int:
        """The next dispatch's width a shard, from the fullest shard's
        queue (``sharded_fused.py:658-663``)."""
        return pick_bucket(self._buckets,
                           int((self._tails - self._heads).max()))

    def _needs_growth(self, bucket: int) -> bool:
        R = self._n * bucket * self._F
        return (int(self._occs.max()) + R > self._capacity // 2
                or int(self._tails.max()) + R > self._ucap)

    def _process(self, st: np.ndarray) -> None:
        """Applies one dispatch's stats ``[n, L]`` (absolute values)."""
        err = int(np.bitwise_or.reduce(st[:, ST_ERR]))
        if err & ERR_LANE:
            raise RuntimeError(
                f"device model error lane {self._dm.error_lane} is set in a "
                "generated state: an encoding capacity was exceeded")
        if err & ERR_TABLE_FULL:
            raise RuntimeError("the visited table filled up: a candidate "
                               "found no free slot")
        with self._lock:
            tails = st[:, ST_TAIL].copy()
            self._unique_count += int(tails.sum() - self._tails.sum())
            self._heads, self._tails = st[:, ST_HEAD].copy(), tails
            self._occs = st[:, ST_OCC].copy()
            self._state_count = self._base_states + int(st[0, ST_SUCC])
            self.candidates = int(st[0, ST_CAND])
            self.waves += int(st[0, ST_WAVES])
            self.dispatches += 1
            for i, prop in enumerate(self._properties):
                fp = int(st[0, ST_DISC + i])
                if fp != SENTINEL and prop.name not in self._discoveries:
                    self._discoveries[prop.name] = to_u64(fp)

    def _device_rows(self) -> int:
        return int(self._occs.sum())

    def _dispatch_costs(self, bucket: int) -> list:
        """The declared costs of one dispatch's kernels at the shape's full
        work: K waves of the sender kernel (with the wave kernel on), the
        ``n`` owner-side inserts of ``R = n * S`` rows, and the append."""
        n, S, wp = self._n, bucket * self._F, self._layout.packed_width
        R = n * S
        wave = [dedup_cost(R)] * n + [append_cost(wp, n * R)]
        if self._wave_kernel:
            wave.append(sender_cost(self._dm, n, bucket, wp,
                                    self._use_symmetry, self._matmul_plan))
        return wave * self._K

    def _wave_prev(self) -> tuple:
        return (self._heads.copy(), self._state_count, self.candidates,
                self._unique_count)

    def _wave_entry(self, st: np.ndarray, meta: dict, prev: tuple) -> dict:
        """A retired dispatch's wave event (sharded_fused :588-612): the
        rows consumed over every shard, the fullest slice's load, the
        bytes of every shard's arena and slice, the ownership epoch."""
        heads_prev, states_prev, cand_prev, unique_prev = prev
        n, wp = self._n, self._layout.packed_width
        return dict(
            meta, t=time.monotonic(), states=self._state_count,
            unique=self._unique_count, waves=int(st[0, ST_WAVES]),
            successors=self._state_count - states_prev,
            candidates=self.candidates - cand_prev,
            novel=self._unique_count - unique_prev,
            rows=int((self._heads - heads_prev).sum()), out_rows=None,
            capacity=self._capacity,
            load_factor=round(int(self._occs.max()) / self._capacity, 4),
            overflow=False, bytes_per_state=4 * wp,
            arena_bytes=n * self._ucap * self._arena_row_bytes(),
            table_bytes=n * self._capacity * 8,
            io_stall_s=self._take_io_stall(), epoch=self._owner_map.epoch)

    def _table_short(self, bucket: int) -> bool:
        return (int(self._occs.max()) + self._n * bucket * self._F
                > self._capacity // 2)

    def _grow_at(self, bucket: int) -> None:
        """Growth at a rest point (``_run_waves`` :670-766), inside the
        fused engine's ``_grow`` and its OOM degrade (:678), the dispatch
        graphs dropped where a slice or an arena grows: every table slice
        doubles, each re-inserted
        through the dedup kernel (``_rehash_fn``; JAX in one call a slice,
        the port's ``_insert_chunked`` in chunks through the engine's
        scratch, for the reasons ``FusedCudaBfsChecker._grow`` gives),
        until the fullest keeps its load at most 1/2 after a dispatch of
        ``bucket`` rows a shard; every arena doubles (``_grow_fn``) until
        the fullest takes such a dispatch's appends, or, past the tiered
        store's device budget, rolls each shard's expanded prefix off the
        card (``_roll_span``, :691-743), keeping the graphs."""
        n = self._n
        R = n * bucket * self._F
        while int(self._occs.max()) + R > self._capacity // 2:
            if self._tracer.enabled:
                self._tracer.event("grow", kind="table", old=self._capacity,
                                   new=2 * self._capacity)
            self._drop_graphs()
            self._table = self._rehash(2 * self._capacity)
            self._capacity *= 2
            self.rehashes += 1
        while int(self._tails.max()) + R > self._ucap:
            if self._span_over_budget(int(self._heads.max())):
                self._roll_span()
                continue
            self._drop_graphs()
            ucap = 2 * self._ucap
            if self._tracer.enabled:
                self._tracer.event("grow", kind="arena", old=self._ucap,
                                   new=ucap)

            def grown(a, fill):
                out = torch.full((n, ucap + 1) + a.shape[2:], fill,
                                 dtype=a.dtype, device=a.device)
                out[:, :self._ucap] = a[:, :self._ucap]
                return out

            new = (grown(self._vecs, 0), grown(self._fps, SENTINEL),
                   grown(self._par, SENTINEL), grown(self._ebits, 0))
            with self._lock:
                self._vecs, self._fps, self._par, self._ebits = new
                self._ucap = ucap
            self.arena_grows += 1

    def _roll_span(self) -> None:
        """Each shard's expanded prefix ``[0, head_i)`` off the card and
        its live window shifted down by its own head, in place
        (:696-743): every shard's parent rows synced first (JAX's
        ``_fetch_parents(None)``) and every synced segment moved to the
        host blocks, in order; the tails, and with them the baseline the
        next dispatch's new rows are counted from, move down by the
        shifts; the stats are rewritten in place, so the graphs stay. The
        whole roll holds the lock, as the fused engine's does."""
        with self._lock:
            self._sync_segments()
            for i, lo, hi in self._segments:
                self._parent_blocks.append(
                    (_u64(self._fps[i, lo:hi]).copy(),
                     _u64(self._par[i, lo:hi]).copy()))
            self._segments = []
            shifts = self._heads.copy()
            for i in range(self._n):
                for a in (self._vecs, self._fps, self._par, self._ebits):
                    _shift_down(a[i], int(shifts[i]), int(self._tails[i]))
            self._tails = self._tails - shifts
            self._heads = np.zeros(self._n, np.int64)
            self._shard_synced = self._shard_synced - shifts
            self._n_seeds = np.maximum(self._n_seeds - shifts, 0)
            self.rolls += 1
        dev = self._stats.device
        self._stats[:, ST_HEAD] = 0
        self._stats[:, ST_TAIL] = torch.from_numpy(self._tails).to(dev)
        rows = int(shifts.sum())
        self._store.note_arena_span(rows, rows * self._arena_row_bytes())

    # -- Checkpoints ----------------------------------------------------------

    def _pending_blocks(self) -> list:
        """Each shard's queue rows ``[head_i, tail_i)``, in shard order
        (JAX :838-853)."""
        blocks = []
        for i in range(self._n):
            lo, hi = int(self._heads[i]), int(self._tails[i])
            if hi > lo:
                blocks.append((_u32(self._vecs[i, lo:hi]),
                               _u64(self._fps[i, lo:hi]),
                               _u32(self._ebits[i, lo:hi])))
        if not blocks:
            blocks.append((np.zeros((0, self._layout.packed_width),
                                    np.uint32), np.zeros(0, np.uint64),
                           np.zeros(0, np.uint32)))
        return blocks

    def _sync_segments(self) -> None:
        """JAX's parent sync (:820-836): every shard's rows ``[synced_i,
        tail_i)``, shard by shard, become the next segments."""
        for i in range(self._n):
            lo, hi = int(self._shard_synced[i]), int(self._tails[i])
            if hi > lo:
                self._segments.append((i, lo, hi))
                self._shard_synced[i] = hi

    def _parent_rows(self):
        """The arenas' part of the parent map in JAX's per-shard sync
        order: each snapshot first syncs every shard (``_sync_segments``),
        and the map holds every segment synced since the last roll, in
        order (the rolls moved the earlier ones to the host blocks)."""
        self._sync_segments()
        empty = self._fps.new_empty(0)
        return (torch.cat([empty] + [self._fps[i, lo:hi]
                                     for i, lo, hi in self._segments]),
                torch.cat([empty] + [self._par[i, lo:hi]
                                     for i, lo, hi in self._segments]))

    # -- Paths ---------------------------------------------------------------

    def _arena_parent(self, cur: int):
        """The parent of fingerprint ``cur`` among every shard's rows
        ``[n_seed_i, tail_i)``, or None. The caller holds the lock."""
        fps, par = self._fps, self._par
        lo, hi = self._n_seeds.copy(), self._tails.copy()
        cols = torch.arange(fps.shape[1], device=fps.device)[None, :]
        live = ((cols >= torch.from_numpy(lo).to(fps.device)[:, None])
                & (cols < torch.from_numpy(hi).to(fps.device)[:, None]))
        hit = torch.nonzero((fps == cur) & live)
        if not len(hit):
            return None
        k, row = hit[0].tolist()
        return int(par[k, row])

    # -- Checker API ----------------------------------------------------------

    def kernel_path(self) -> str:
        """Which front half the waves run: ``sender_kernel`` (the sender
        kernel) or ``dedup_kernel`` (torch stages, with the dedup kernel
        on the owner side either way) on the card, and
        ``sender_plain`` or ``dedup_plain`` on the CPU; each with
        ``+matmul`` under a matmul plan."""
        on_card = self._device.type == "cuda"
        if self._wave_kernel:
            path = "sender_kernel" if on_card else "sender_plain"
        else:
            path = "dedup_kernel" if on_card else "dedup_plain"
        return path + self._matmul_suffix()
