"""The classic sharded BFS: the per-wave host loop over stacked shards.

The port's copy of ``stateright_tpu/tpu/sharded.py::ShardedTpuBfsChecker``
on the port's classic engine (``classic.py``), as JAX's class builds on
``TpuBfsChecker``. It runs what the sharded fused engine
(``sharded_fused.py``) cannot: a visitor, or a property the host
evaluates, each needing a host step a wave. The shards share one device,
stacked along a leading axis (``mesh.py``), as in the sharded fused
engine.

- **Shards.** Shard ``i`` owns the fingerprints of partition ``fp % n``
  (``membership.OwnerMap``): slice ``i`` of the visited table ``int64[n,
  C]`` (``C`` a shard) and a host queue of its own. ``_shard_counts``
  holds each slice's occupancy; the table grows when the fullest slice
  could pass half load in one wave, ``max(_shard_counts) + n * B_max * F
  > C // 2`` (JAX :181-190). Its slices are built, rehashed and seeded on
  resume through the dedup kernel in strided chunks of the engine's
  scratch (``EpochOwnership._stacked_table`` and ``_rehash``, shared
  with the sharded fused engine; JAX :158-173).
- **A wave** (``sharded_wave``, JAX's ``_route_fn`` and ``_wave_fn``
  :222-411), for every shard at once: the properties on the popped rows;
  the front half (``sharded_front``): with ``wave_kernel=True`` the sender
  kernel (``wave.sender_megakernel``, where JAX calls
  ``sender_kernel_impl`` :256), else the torch stages and, with
  ``exchange_novel_only`` (the default), each sender's first occurrences
  (``first_occurrence_sorted``); the parent of each successor; the
  exchange of the rows to their owners (``mesh.route_home``, the one
  exchange of both sharded engines); the owner's insert into its
  own slice through the dedup kernel (``table.dedup_and_insert``) with
  the engine's scratch; and each shard's first ``K`` new rows, ``K`` the
  output rung, with the overflow flag.
- **Kernel 1 on the owner side.** JAX's classic sharded engine inserts
  through its XLA ``dedup_impl`` (:357; ``table_impl`` is forced to
  ``"xla"`` at :101-108). The port inserts through its dedup kernel, as
  its sharded fused engine does: the plain version stays the reference
  on the CPU, and the kernel is held to it on the card.
- **Parents and eventually bits** do not ride the exchange as JAX's do
  (:279-287): a successor carries its parent's row in the stacked batch,
  an int32, and the host takes the parent's fingerprint and its
  eventually bits, cleared where the parent satisfied an eventually
  property, from the batch. Every eventually property has a device
  predicate here (``_check_support``), so the bits are those JAX clears
  on the device.
- **The regather** (``sharded_regather``, JAX :414-454): a wave whose
  fullest shard's new rows outgrew the rung runs its front half and
  exchange again and compacts each shard by the wave's own novelty mask
  at a rung that holds the fullest; the table is not touched.
- **The host loop** (``_run_waves``, JAX :486-780): the queues seeded by
  ownership; at each wave's start a checkpoint when due, the stop tests
  and growth, in that order; the bucket from the widest shard queue and
  ``K`` from ``_pick_out_rows`` over the ``n * B * F`` rows a shard may
  receive; the host conditions; the visitor on every popped row; the
  error lane; the exchange integrity check (always on: a shard's block
  shorter than its new count, or holding a sentinel fingerprint, raises
  ``ExchangeIntegrityError``); the counts, the parent log and a wave-log
  entry with JAX's fields; the discoveries in stacked-batch order. JAX
  slices each shard's block to a power of two only to bound its compiled
  shapes: the port copies all ``K`` rows of each shard down.
- **On the card** a wave, and a regather, is one CUDA graph
  (``graphs.py``), keyed ``(B, capacity, K, epoch)`` as JAX keys its wave
  programs (:350), and ``("regather", B, K, epoch)``. A wave reads its
  batch from static device rows filled from a pinned host slot, and its
  outputs go down to the slot with ``non_blocking`` copies and an event;
  inside a wave nothing reads a device value on the host, which waits on
  the wave's event alone. The loop is synchronous, as JAX's:
  ``pipeline=True`` raises.
- **Checkpoints** are the classic engine's sections, with every shard's
  queue in the pending rows, shard by shard (JAX :126-136); a file
  crosses between this engine, the port's other engines and JAX's.

- **The tiered store** (the classic engine's, JAX :190-210, :661-680,
  :774-776): the table's bytes count every shard (``n * C * 8``); a
  spill keeps the fullest shard's survivors within a wave's headroom;
  each shard's new block is probed against the spilled partitions, the
  device's new counts still feeding the shards' occupancy; the host
  budget pages blocks out of every shard's queue.

- **Telemetry** (``obs``): the classic engine's, each wave's event with
  JAX's fields (:700-750: the rows of every shard, the fullest slice's
  load factor, every slice's bytes, the ownership ``epoch``), an
  ``overflow_redispatch`` before a regathered wave's; the profiler's
  record of a wave is the sender kernel's declared cost (with the wave
  kernel on) and the ``n`` owner-side inserts'.

- **Faults** (``resilience/``): ``wave_crash`` at the top of
  ``_process_wave`` (JAX fires it at the wave's start, :518),
  ``a2a_short`` and ``a2a_corrupt`` on the fetched blocks between
  ``_shard_blocks`` and the integrity check (``_inject_exchange_faults``,
  :456-490), which raises the fault plan's ``ExchangeIntegrityError``,
  and the classic engine's growth with its ``grow_oom`` and OOM degrade
  (:158-190). Not ported: an ownership remap and the elastic workers
  (ROADMAP A13 (c)).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from .classic import CudaBfsChecker, _block_rows, _Slot
from .engine import (compaction_order, eval_properties,
                     fingerprint_successors, first_occurrence_sorted,
                     pick_bucket, succ_bucket_ladder)
from .hashing import SENTINEL, SENTINEL_U64
from .matmul_wave import expand
from .membership import EpochOwnership, OwnerMap
from .mesh import route_home
from .model import Expectation
from .resilience.faults import ExchangeIntegrityError
from .table import dedup_and_insert, dedup_cost
from .wave import sender_cost, sender_megakernel

__all__ = ["ShardedCudaBfsChecker", "ExchangeIntegrityError",
           "sharded_front", "sharded_wave", "sharded_regather"]

#: the small outputs of a wave, in one int64 vector; each shard's new
#: rows from ``_NEW``
(_SUCC, _CAND, _OVERFLOW, _FULL, _NEW) = range(5)


def sharded_front(dm, mesh, store: torch.Tensor, valid: torch.Tensor,
                  layout, use_sym: bool, exchange_novel: bool, assign,
                  wave_kernel: bool, scratch=None, rows=None, plan=None):
    """The sender side of a sharded wave for ``n`` stacked shards of
    ``B`` packed rows (``store int32[n, B, Wp]``, ``valid bool[n, B]``)
    and the exchange home: ``(succ_count int64 0-dim, terminal bool[n,
    B], recv_vecs int32[n, R, Wp], recv_dedup int64[n, R], recv_path
    int64[n, R], recv_parent int32[n, R])`` with ``R = n * B * F``; a
    received row's parent is its row in the stacked batch. ``rows`` are
    the batch's unpacked rows ``[n * B, W]`` where the caller has them.
    ``plan``, a ``matmul_wave.MatmulPlan``, runs the expand stage in its
    transition-table form (JAX's ``tpu/sharded.py`` :258, :274). Reads
    nothing on the host."""
    n, B = valid.shape
    F, wp = dm.max_fanout, layout.packed_width
    S = B * F
    if wave_kernel:
        succ_store, dedup_fps, path_fps, sflat, send_mask = \
            sender_megakernel(dm, store, valid, use_sym, layout,
                              exchange_novel, scratch=scratch, plan=plan)
        succ_count = sflat.sum(dtype=torch.int64)
        terminal = valid & ~sflat.view(n, B, F).any(dim=2)
    else:
        if rows is None:
            rows = layout.unpack(store).reshape(n * B, -1)
        succ, sflat, succ_count, terminal = expand(
            dm, plan, rows, valid.reshape(n * B))
        dedup_fps, path_fps = fingerprint_successors(dm, succ, sflat,
                                                     use_sym)
        dedup_fps, path_fps, sflat = (t.view(n, S) for t in (
            dedup_fps, path_fps, sflat))
        terminal = terminal.view(n, B)
        send_mask = (first_occurrence_sorted(dedup_fps) if exchange_novel
                     else sflat)
        # Packed before the exchange, as in JAX: the rows ride it packed.
        succ_store = layout.pack(succ).view(n, S, wp)
    parent = torch.arange(n * B, dtype=torch.int32, device=valid.device)
    parent = parent.view(n, B, 1).expand(n, B, F).reshape(n, S)
    recv = route_home(mesh, dedup_fps, send_mask, assign, (
        (succ_store, 0), (dedup_fps, SENTINEL), (path_fps, SENTINEL),
        (parent, -1)))
    return (succ_count, terminal, *recv)


def _compact(new_mask, K: int, recv_vecs, recv_path, recv_parent):
    """Each shard's first ``K`` rows marked in ``new_mask`` (``[n, R]``),
    in their order: ``(vecs [n, K, Wp], path fps [n, K], parent rows [n,
    K])``."""
    comp = compaction_order(new_mask)[:, :K]
    wp = recv_vecs.shape[2]
    return (recv_vecs.gather(1, comp[:, :, None].expand(-1, -1, wp)),
            recv_path.gather(1, comp), recv_parent.gather(1, comp))


def sharded_wave(dm, mesh, store: torch.Tensor, valid: torch.Tensor,
                 table: torch.Tensor, layout, prop_fns=(),
                 use_sym: bool = False, exchange_novel: bool = True,
                 assign=None, out_rows=None, wave_kernel: bool = False,
                 scratch=None, plan=None):
    """One BFS level of ``n`` stacked shards against the stacked visited
    table ``table int64[n, C]``, updated in place (JAX's ``_wave_fn``
    :343-412): ``(conds, succ_count, cand_count, terminal, new_count,
    new_vecs, new_fps, new_parent, new_mask, overflow, full)``.

    ``conds`` holds a ``bool[n * B]`` for each property with a device
    predicate; ``succ_count`` and ``cand_count`` are totals over the
    shards; ``new_count int64[n]`` counts each shard's new rows, marked
    in ``new_mask bool[n, R]`` over its received rows; ``new_vecs``,
    ``new_fps`` and ``new_parent`` are each shard's first ``out_rows``
    (default ``R``) of them, ``[n, K, ...]``; ``overflow`` is whether a
    shard's new rows outgrew ``K``, and ``full`` whether a candidate
    found no free slot. Reads nothing on the host, so a CUDA graph can
    hold it."""
    n, B = valid.shape
    R = n * B * dm.max_fanout
    K = R if out_rows is None else min(max(1, int(out_rows)), R)
    rows = layout.unpack(store).reshape(n * B, -1)
    conds = eval_properties(prop_fns, rows)
    (succ_count, terminal, recv_vecs, recv_dedup, recv_path,
     recv_parent) = sharded_front(dm, mesh, store, valid, layout, use_sym,
                                  exchange_novel, assign, wave_kernel,
                                  scratch, rows, plan)
    # The owner's insert into its own slice, a call a shard.
    owned = [dedup_and_insert(recv_dedup[k], table[k], scratch=scratch)
             for k in range(n)]
    new_mask = torch.stack([o[0] for o in owned])
    new_count = torch.stack([o[2] for o in owned]).to(torch.int64)
    cand_count = torch.stack([o[3] for o in owned]).sum(dtype=torch.int64)
    full = torch.stack([o[4] for o in owned]).any()
    new_vecs, new_fps, new_parent = _compact(new_mask, K, recv_vecs,
                                             recv_path, recv_parent)
    return ([c for c in conds if c is not None], succ_count, cand_count,
            terminal, new_count, new_vecs, new_fps, new_parent, new_mask,
            (new_count > K).any(), full)


def sharded_regather(dm, mesh, store: torch.Tensor, valid: torch.Tensor,
                     new_mask: torch.Tensor, out_rows: int, layout,
                     use_sym: bool = False, exchange_novel: bool = True,
                     assign=None, wave_kernel: bool = False, scratch=None,
                     plan=None):
    """The overflow recovery (JAX's ``_regather_fn`` :414-454): the same
    batch's front half and exchange again, which route every row to the
    same slot, and each shard compacted by the wave's own ``new_mask``
    ``[n, R]`` at a rung of ``out_rows`` rows: ``(new_vecs, new_fps,
    new_parent)`` as ``sharded_wave`` gives them at that rung. The table
    is not touched."""
    n, B = valid.shape
    K = min(max(1, int(out_rows)), n * B * dm.max_fanout)
    (_, _, recv_vecs, _, recv_path, recv_parent) = sharded_front(
        dm, mesh, store, valid, layout, use_sym, exchange_novel, assign,
        wave_kernel, scratch, plan=plan)
    return _compact(new_mask, K, recv_vecs, recv_path, recv_parent)


class ShardedCudaBfsChecker(EpochOwnership, CudaBfsChecker):
    """The classic engine over a mesh of stacked shards. ``batch_size`` is
    per shard."""

    _ENGINE_ID = "sharded"
    _SENDER_KERNEL = True
    _POLLS_PREEMPT = False

    def __init__(self, builder, mesh, batch_size: int = 512,
                 exchange_novel_only=None, pipeline=None, **kwargs):
        if pipeline:
            raise NotImplementedError(
                "the sharded engine's wave loop is not software-pipelined "
                "(as in JAX, tpu/sharded.py:96-100); drop pipeline=True")
        self._mesh = mesh
        self._n = mesh.n
        self._owner_map = OwnerMap.identity(self._n)
        self._exchange_novel = (True if exchange_novel_only is None
                                else bool(exchange_novel_only))
        # The owner of each partition as a tensor, made at rest (None at
        # the identity map).
        self._assign = (None if self._owner_map.is_identity else torch.tensor(
            self._owner_map.assignment(), dtype=torch.int64,
            device=mesh.device))
        super().__init__(builder, mesh.device, batch_size=batch_size,
                         pipeline=False, **kwargs)

    def _check_support(self) -> None:
        """An eventually property needs a device predicate (JAX
        :114-122): its bits are cleared at the parent, whose row is gone
        after the exchange."""
        for p, fn in zip(self._properties, self._prop_fns):
            if p.expectation is Expectation.EVENTUALLY and fn is None:
                raise NotImplementedError(
                    f"the sharded engine needs a device predicate for "
                    f"eventually property {p.name!r} (per-path bits are "
                    "cleared on the device before the exchange)")

    def _scratch_shape(self):
        """The rows of one owner-side insert, every row a shard may
        receive (``R = n * S``), and the sender kernel's ``n`` shards of
        ``S`` rows, at the widest bucket."""
        return self._n * self._B_max * self._F, self._n

    def _make_slots(self, device) -> None:
        """One pinned host slot (the loop is synchronous) for ``n * B``
        batch rows and ``n * R`` output rows, and the static device rows
        a wave reads its batch from."""
        rows, wp = self._n * self._B_max, self._layout.packed_width
        self._slots = [_Slot(rows, self._n * self._succ_full_rows(
            self._B_max), wp, self._n_dev, device, small=_NEW + self._n)]
        self._in_vecs = torch.zeros((rows, wp), dtype=torch.int32,
                                    device=device)
        self._in_valid = torch.zeros((rows,), dtype=torch.bool,
                                     device=device)

    # -- The stacked table ---------------------------------------------------

    def _new_table(self, visited: np.ndarray, resumed: bool) -> torch.Tensor:
        """The stacked table (``_stacked_table``); sets each shard's
        occupancy (JAX :138-156)."""
        table, occs = self._stacked_table(visited, resumed)
        self._shard_counts = occs.tolist()
        return table

    def _load_after(self) -> int:
        """The fullest shard's occupancy after one more wave of every
        shard's whole fan-out at the widest bucket: growth holds it under
        half a slice (JAX :181-190)."""
        return max(self._shard_counts) + self._n * self._B_max * self._F

    def _succ_full_rows(self, B: int) -> int:
        """The rows a shard may receive in one wave (JAX :214-216)."""
        return self._n * B * self._F

    def _refill_table(self, kept, counts: np.ndarray) -> None:
        """Empties every table slice in place and inserts slice ``i``'s
        int64 keys ``kept[i]`` (sentinel-padded; ``counts[i]`` of them)
        into it again, which sets its occupancy; the wave graphs stay."""
        self._table.fill_(SENTINEL)
        full = torch.stack([self._insert_chunked(kept[i], self._table[i])
                            for i in range(self._n)]).any()
        if bool(full):
            raise RuntimeError("the table's rebuild found no free slot")
        self._shard_counts = [int(c) for c in counts]
        self._resident = int(counts.sum())

    def _spill_enough_counts(self, kept: np.ndarray) -> bool:
        """Whether the fullest shard's kept rows (``kept``, by shard)
        leave a wave's headroom at the current capacity (JAX :196-210)."""
        return int(kept.max()) + self._n * self._B_max * self._F \
            <= self._capacity // 2

    def _pending_blocks(self) -> list:
        """The pre-split queue, then every shard's queue in shard order
        (JAX :126-136), paged-out blocks read."""
        blocks = list(self._pending)
        for q in getattr(self, "_queues", ()):
            blocks.extend(q)
        return self._materialized(blocks)

    def _reset_engine_state(self) -> None:
        """A restart drops the failed run's shard queues too (JAX
        :175-179)."""
        super()._reset_engine_state()
        self.__dict__.pop("_queues", None)

    # -- The wave ------------------------------------------------------------

    def _wave(self, B: int, K: int, store, valid) -> tuple:
        """``sharded_wave`` at this engine's settings, its outputs
        gathered for the host: ``(conds [P, n * B] or None, small
        int64[4 + n], terminal, new_vecs [n * K, Wp], new_fps, new_parent,
        new_mask [n * R])``."""
        (conds, succ_count, cand_count, terminal, new_count, new_vecs,
         new_fps, new_parent, new_mask, overflow, full) = sharded_wave(
            self._dm, self._mesh, store, valid, self._table, self._layout,
            self._prop_fns, self._use_symmetry, self._exchange_novel,
            self._assign, K, self._wave_kernel, self._scratch,
            self._matmul_plan)
        small = torch.cat([torch.stack([
            succ_count, cand_count, overflow.to(torch.int64),
            full.to(torch.int64)]), new_count])
        return (torch.stack(conds) if conds else None, small,
                terminal.reshape(-1), new_vecs.flatten(0, 1),
                new_fps.reshape(-1), new_parent.reshape(-1),
                new_mask.reshape(-1))

    def _regathered(self, B: int, K: int, store, valid, mask) -> tuple:
        """``sharded_regather`` at this engine's settings, flattened."""
        return tuple(t.flatten(0, 1) for t in sharded_regather(
            self._dm, self._mesh, store, valid, mask, K, self._layout,
            self._use_symmetry, self._exchange_novel, self._assign,
            self._wave_kernel, self._scratch, self._matmul_plan))

    def _dispatch_wave(self, B: int) -> dict:
        """Takes up to ``B`` rows from each shard's queue into the
        stacked batch (JAX :546-559) and launches its wave; on the card
        the outputs' copies to the slot go out behind it."""
        t0 = time.perf_counter()
        n, wp = self._n, self._layout.packed_width
        nB = n * B
        K = self._pick_out_rows(B)
        on_card = self._device.type == "cuda"
        slot = self._slots[0] if on_card else None
        up = (slot.vecs.numpy()[:nB].view(np.uint32) if on_card
              else np.empty((nB, wp), np.uint32))
        batch_fps = np.zeros(nB, np.uint64)
        batch_ebits = np.zeros(nB, np.uint32)
        valid = np.zeros(nB, bool)
        for i, q in enumerate(self._queues):
            lo = i * B
            m = self._take_batch(q, B, up[lo:lo + B], batch_fps[lo:lo + B],
                                 batch_ebits[lo:lo + B])
            up[lo + m:lo + B] = 0
            valid[lo:lo + m] = True
        epoch = self._owner_map.epoch
        meta = {"bucket": B, "inflight": 0, "out_rows": K,
                "rows": int(valid.sum()), "kernel_path": self.kernel_path(),
                "expand_impl": self._expand_impl(), "compiled": False,
                "epoch": epoch}
        wave = dict(meta=meta, vecs=up, fps=batch_fps, ebits=batch_ebits,
                    valid=valid, slot=slot)
        prof = (self._prof_start((B, self._capacity, K, epoch),
                                 lambda: self._wave_costs(B))
                if self._prof.enabled else None)
        if not on_card:
            outs = self._wave(B, K, torch.from_numpy(up.view(np.int32)).view(
                n, B, wp), torch.from_numpy(valid).view(n, B))
            if prof is not None:
                meta.update(self._prof_stop(prof))
            wave["outs"] = [None if t is None else t.numpy()
                            for t in outs[:6]]
            wave["mask"] = outs[6]
        else:
            with torch.cuda.device(self._device):
                slot.valid.numpy()[:nB] = valid
                self._in_vecs[:nB].copy_(slot.vecs[:nB], non_blocking=True)
                self._in_valid[:nB].copy_(slot.valid[:nB], non_blocking=True)
                args = (B, K, self._in_vecs[:nB].view(n, B, wp),
                        self._in_valid[:nB].view(n, B))
                outs = self._graphed((B, self._capacity, K, epoch),
                                     lambda: self._wave(*args), meta)
                if prof is not None:
                    meta.update(self._prof_stop(prof))
                self._copy_down(slot, outs,
                                regather=K < self._succ_full_rows(B))
        self.host_sec["launch"] += time.perf_counter() - t0
        return wave

    def _wave_costs(self, B: int) -> list:
        """The declared costs of a wave's kernels at the shape's full
        work: the sender kernel (wave kernel on) and the ``n`` owner-side
        inserts of ``R = n * B * F`` rows."""
        n = self._n
        costs = [dedup_cost(self._succ_full_rows(B))] * n
        if self._wave_kernel:
            costs.append(sender_cost(self._dm, n, B,
                                     self._layout.packed_width,
                                     self._use_symmetry, self._matmul_plan))
        return costs

    def _regather(self, wave: dict, worst: int):
        """An overflowed wave's new rows, regathered at the least rung
        that holds the fullest shard's ``worst`` (JAX :591-606)."""
        n, B = self._n, wave["meta"]["bucket"]
        wp = self._layout.packed_width
        R = self._succ_full_rows(B)
        K = pick_bucket(succ_bucket_ladder(R), worst)
        slot = wave["slot"]
        if slot is None:
            outs = self._regathered(
                B, K, torch.from_numpy(wave["vecs"].view(np.int32)).view(
                    n, B, wp), torch.from_numpy(wave["valid"]).view(n, B),
                wave["mask"].view(n, R))
            new_vecs, new_fps, new_parent = (t.numpy() for t in outs)
        else:
            nB, nK = n * B, n * K
            with torch.cuda.device(self._device):
                args = (B, K, self._in_vecs[:nB].view(n, B, wp),
                        self._in_valid[:nB].view(n, B),
                        slot.mask[:n * R].view(n, R))
                outs = self._graphed(("regather", B, K,
                                      self._owner_map.epoch),
                                     lambda: self._regathered(*args))
                for dst, src in zip((slot.new_vecs, slot.new_fps,
                                     slot.new_parent), outs):
                    dst[:nK].copy_(src, non_blocking=True)
                slot.event = torch.cuda.Event()
                slot.event.record()
            t0 = time.perf_counter()
            slot.event.synchronize()
            self.host_sec["wait"] += time.perf_counter() - t0
            new_vecs, new_fps, new_parent = (
                slot.new_vecs.numpy()[:nK], slot.new_fps.numpy()[:nK],
                slot.new_parent.numpy()[:nK])
        wave["meta"].update(out_rows=K)
        if self._tracer.enabled:
            self._tracer.event("overflow_redispatch", bucket=B, out_rows=K,
                               novel=worst)
        return K, new_vecs, new_fps, new_parent

    def _shard_blocks(self, K: int, new_count, new_vecs, new_fps,
                      new_parent) -> list:
        """Each shard's new rows as ``(packed rows uint32, path fps
        uint64, parent rows int64)``, copied out of the slot (JAX
        :617-634), the error lane checked."""
        blocks = []
        for i in range(self._n):
            lo, k = i * K, int(new_count[i])
            vecs = new_vecs[lo:lo + k].view(np.uint32).copy()
            self._check_error_lane(vecs)
            blocks.append((vecs, new_fps[lo:lo + k].view(np.uint64).copy(),
                           new_parent[lo:lo + k].astype(np.int64)))
        return blocks

    @staticmethod
    def _check_exchange(blocks: list, new_count) -> None:
        """The owner-side exchange integrity check (JAX :637-658), always
        on: each shard's block holds exactly its new count of rows, none
        with the sentinel fingerprint."""
        for i, (_, fps, _) in enumerate(blocks):
            k = int(new_count[i])
            if len(fps) != k:
                raise ExchangeIntegrityError(
                    f"the exchange delivered {len(fps)} rows to shard {i} "
                    f"where its dedup reported {k} new states (short "
                    "exchange); resume from the last checkpoint")
            if k and (fps == SENTINEL_U64).any():
                raise ExchangeIntegrityError(
                    f"the exchange delivered a sentinel fingerprint inside "
                    f"shard {i}'s new block (corrupt exchange payload); "
                    "resume from the last checkpoint")

    def _inject_exchange_faults(self, blocks: list) -> list:
        """The fault plan's exchange damage on the fetched blocks (JAX
        :456-490): ``a2a_short`` drops a block's last row, ``a2a_corrupt``
        writes the sentinel over a fingerprint; the integrity check then
        catches either. A fault fires only where a nonempty block exists
        to damage, so each ``fault`` event has a failure to pair with. The
        port's blocks are ``(vecs, fps, parent rows)``."""
        target = next((i for i, b in enumerate(blocks) if len(b[1])), None)
        if target is None:
            return blocks
        if self._faults.fires("a2a_short", self._tracer, shard=target):
            vecs, fps, parents = blocks[target]
            blocks[target] = (vecs[:-1], fps[:-1], parents[:-1])
            # A one-row block is empty now: pick again for the next fault.
            target = next((i for i, b in enumerate(blocks) if len(b[1])),
                          None)
        if target is not None and self._faults.fires(
                "a2a_corrupt", self._tracer, shard=target):
            vecs, fps, parents = blocks[target]
            fps = fps.copy()
            fps[-1] = SENTINEL_U64
            blocks[target] = (vecs, fps, parents)
        return blocks

    def _process_wave(self, wave: dict) -> None:
        """Applies a wave's outputs to the counts, discoveries, the parent
        log and the shard queues (JAX :588-774)."""
        if self._faults.active:
            self._faults.crash("wave_crash", self._tracer,
                               wave=len(self.dispatch_log))
        conds_out, small, terminal, new_vecs, new_fps, new_parent = \
            self._fetch(wave)
        t0 = time.perf_counter()
        n, meta = self._n, wave["meta"]
        batch_vecs, batch_fps = wave["vecs"], wave["fps"]
        batch_ebits, valid = wave["ebits"], wave["valid"]
        if small[_FULL]:
            raise RuntimeError("the visited table filled up: a candidate "
                               "found no free slot")
        new_count = small[_NEW:_NEW + n].copy()
        succ, cand = int(small[_SUCC]), int(small[_CAND])
        K = meta["out_rows"]
        row_bytes = new_vecs.itemsize * new_vecs.shape[1] + 12
        down = (n * K * row_bytes + small.nbytes
                + len(terminal) * (1 + self._n_dev))
        meta["overflow"] = bool(small[_OVERFLOW])
        if meta["overflow"]:
            K, new_vecs, new_fps, new_parent = self._regather(
                wave, int(new_count.max()))
            down += n * K * row_bytes
        popped = np.flatnonzero(valid)
        conds = self._eval_host_conds(conds_out, batch_vecs, popped)
        if self._visitor is not None:
            for r in popped:
                self._visitor.visit(self._model,
                                    self._reconstruct_path(int(batch_fps[r])))
        blocks = self._shard_blocks(K, new_count, new_vecs, new_fps,
                                    new_parent)
        if self._faults.active:
            blocks = self._inject_exchange_faults(blocks)
        self._check_exchange(blocks, new_count)
        if self._store.active and self._store.spilled_rows:
            # A spilled state generated again is back in its owner's
            # slice, but not new (JAX :660-680).
            blocks = [self._unspilled(b) for b in blocks]
        ebits_after = self._cleared_ebits(conds, batch_ebits)
        with self._lock:
            self._state_count += succ
            self._succ_hist.append((meta["bucket"], int(new_count.max())))
            self._resident += int(new_count.sum())
            novel = 0
            for i, (vecs, fps, parent_rows) in enumerate(blocks):
                self._shard_counts[i] += int(new_count[i])
                k = len(fps)
                if not k:
                    continue
                self._unique_count += k
                novel += k
                self._parent_log.append((fps, batch_fps[parent_rows], None))
                self._queues[i].append((vecs, fps, ebits_after[parent_rows]))
            now = time.monotonic()
            self.wave_log.append((now, self._state_count))
            self.waves += 1
            # The fullest shard's load factor, the quantity growth gates
            # on.
            entry = dict(
                meta, t=now, states=self._state_count,
                unique=self._unique_count, waves=1, successors=succ,
                candidates=cand, novel=novel, capacity=self._capacity,
                load_factor=round(max(self._shard_counts) / self._capacity,
                                  4), **self._wave_gauges())
            self._tier_gauges(entry)
            if self._prof.enabled:
                self._stamp_cost(entry)
            self.dispatch_log.append(entry)
            self.bytes_down.append(down)
            # The first hits in stacked-batch order (JAX :751-774).
            self._record_discoveries(conds, valid, terminal, ebits_after,
                                     batch_fps)
        if self._store.active and novel:
            self._store.balance_frontier(self._queues)
        self._publish(entry)
        self.host_sec["process"] += time.perf_counter() - t0

    def _unspilled(self, block):
        """A shard's new block without the rows the store holds."""
        vecs, fps, parent_rows = block
        if not len(fps):
            return block
        present = self._store.probe(self._store_probe_fps(vecs, fps))
        if not present.any():
            return block
        keep = ~present
        return vecs[keep], fps[keep], parent_rows[keep]

    # -- Host loop -------------------------------------------------------------

    def _run_waves(self) -> None:
        """The synchronous host loop (JAX :486-780): the queues seeded by
        owner, then a wave at a time while any shard's queue holds rows,
        each started by a checkpoint when one is due
        (``checkpoint_every_waves``), the stop tests and growth; its width
        the least rung that covers the widest shard queue."""
        n = self._n
        queues = [deque() for _ in range(n)]
        self._queues = queues
        while self._pending:
            vecs, fps, ebits = self._pending.popleft()
            owners = self._owners(fps)
            for i in range(n):
                mask = owners == i
                if mask.any():
                    queues[i].append((vecs[mask], fps[mask], ebits[mask]))
        P = len(self._properties)
        self.wave_log.append((time.monotonic(), self._state_count))
        wave_index = 0
        while any(queues):
            wave_index += 1
            if (self._ckpt_path is not None
                    and wave_index % self._ckpt_every == 0):
                self._write_checkpoint(self._ckpt_path)
            with self._lock:
                if (len(self._discoveries) == P
                        or (self._target is not None
                            and self._state_count >= self._target)):
                    return
            if self._needs_growth():
                self._grow_table()
            widest = 0
            for q in queues:
                rows = 0
                for blk in q:
                    rows += _block_rows(blk)
                    if rows >= self._B_max:
                        break
                widest = max(widest, rows)
            self._process_wave(self._dispatch_wave(
                pick_bucket(self._buckets, widest)))

    # -- Checker API -----------------------------------------------------------

    def kernel_path(self) -> str:
        """Which front half the waves run: ``sender_kernel`` (the sender
        kernel) or ``dedup_kernel`` (torch stages, with the dedup kernel
        on the owner side either way) on the card, and ``sender_plain``
        or ``dedup_plain`` on the CPU; each with ``+matmul`` under a matmul
        plan."""
        on_card = self._device.type == "cuda"
        if self._wave_kernel:
            path = "sender_kernel" if on_card else "sender_plain"
        else:
            path = "dedup_kernel" if on_card else "dedup_plain"
        return path + self._matmul_suffix()
