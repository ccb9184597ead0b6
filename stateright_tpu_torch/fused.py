"""Fused device BFS: the checker's whole state lives on the device.

The port's copy of ``stateright_tpu/tpu/fused.py::FusedTpuBfsChecker``
together with the parts of ``tpu/engine.py::TpuBfsChecker`` it inherits
(seeding, the table capacity rule, growth, paths, the Checker API).

- **Arena.** Every discovered state is a row of a device arena: packed
  words ``vecs[U+1, Wp]``, ``fps[U+1]``, parent ``par[U+1]`` and
  eventually-bits ``ebits[U+1]``. Rows ``[head, tail)`` are the BFS
  queue, all rows are the parent map, and row ``U`` is a dump row that
  absorbs the writes of rows that are not new.
- **Dispatches.** One dispatch runs ``K`` waves with no host
  synchronisation. JAX runs them in a ``lax.while_loop``; torch has no
  device-side loop, so the stop predicates are computed on the device
  into a ``go`` flag that masks the wave's rows, and a wave past a rest
  point is a no-op (the reference's "launched past a rest point" rule).
  Appends go to a device-side ``tail`` through ``index_copy_``. The host
  reads one small stats tensor per dispatch, in the ``ST_*`` layout.
- **Rest points.** Between dispatches the host grows the visited table
  (a rehash through the same dedup kernel) or the arena when the next
  dispatch could overflow either, and retires discoveries.
- **Paths.** Parents stay in the arena; a path reconstruction reads its
  chain from there on demand.

The successor path of a wave runs one of two ways, each a CUDA kernel on
the card and its plain version on the CPU:

- by default, torch stage functions (``engine``) for the step, the
  fingerprints and the packing, and ``table.dedup_and_insert`` for the
  dedup;
- with ``wave_kernel=True``, the single-kernel wave
  ``wave.wave_megakernel``, on the packed batch as it lies in the arena.

The table's rehash at rest points goes through ``table.dedup_and_insert``
either way, in chunks of at most a wave's rows with the engine's scratch.
``kernel_path()`` says which implementation ran.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np
import torch

from .checker import Checker
from .engine import (compaction_order, eval_properties, expand_frontier,
                     fingerprint_successors, host_table_insert)
from .hashing import SENTINEL, SENTINEL_U64, host_fp64, to_i64, to_u64
from .model import Expectation
from .packing import compile_layout
from .path import Path
from .table import DedupScratch, dedup_and_insert
from .wave import cuda_model, wave_megakernel

__all__ = ["FusedCudaBfsChecker", "ST_HEAD", "ST_TAIL", "ST_OCC",
           "ST_SUCC", "ST_CAND", "ST_TARGET", "ST_ERR", "ST_WAVES",
           "ST_DISC", "ERR_LANE", "ERR_TABLE_FULL"]

# Dispatch-stats layout (int64), read by the host once per dispatch and
# chained on the device into the next one. Discovery fingerprints follow
# from ST_DISC, one slot per property (SENTINEL until found).
(ST_HEAD, ST_TAIL, ST_OCC, ST_SUCC, ST_CAND, ST_TARGET, ST_ERR,
 ST_WAVES) = range(8)
ST_DISC = 8
#: ST_ERR bits: a generated state set the model's error lane; a
#: candidate found no free slot in the visited table.
ERR_LANE, ERR_TABLE_FULL = 1, 2


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _i32(bits: int) -> int:
    """A uint32 bit pattern as the int32 that holds it."""
    return bits - (1 << 32) if bits >> 31 else bits


def _first_hit(disc, hit, fps):
    """Keeps the first (frontier-order) hit's fingerprint, once."""
    row = hit.to(torch.int32).argmax().reshape(1)
    first = fps.index_select(0, row).reshape(())
    return torch.where((disc == SENTINEL) & hit.any(), first, disc)


class FusedCudaBfsChecker(Checker):
    """Device-arena BFS with multi-wave dispatches."""

    def __init__(self, builder, device: torch.device, batch_size: int = 1024,
                 table_capacity: int = 1 << 16, arena_capacity=None,
                 waves_per_dispatch: int = 16, wave_kernel: bool = False):
        model = builder._model
        dm = model.device_model()
        self._model, self._dm, self._device = model, dm, device
        self._properties = model.properties()
        if len(self._properties) > 32:
            raise NotImplementedError("at most 32 properties on device")
        preds = dm.device_properties()
        missing = [p.name for p in self._properties if p.name not in preds]
        if missing:
            raise ValueError(f"properties {missing} have no device "
                             "predicate; the port checks on the device only")
        self._prop_fns = [preds[p.name] for p in self._properties]
        self._use_symmetry = builder._symmetry
        W = dm.state_width
        if self._use_symmetry and dm.representative(
                torch.zeros((1, W), dtype=torch.int64)) is None:
            raise NotImplementedError(
                "symmetry() needs DeviceModel.representative()")
        self._target = builder._target_state_count
        self._B, self._F = int(batch_size), dm.max_fanout
        self._K = max(1, int(waves_per_dispatch))
        self._layout = compile_layout(dm.lane_bits(), W)
        self._wave_kernel = bool(wave_kernel)
        if self._wave_kernel and device.type == "cuda":
            cuda_model(dm, self._layout)  # raises before any device work
        self._ebits_all = 0
        for i, p in enumerate(self._properties):
            if p.expectation is Expectation.EVENTUALLY:
                self._ebits_all |= 1 << i

        # Seed from the init states; under symmetry an init state whose
        # representative was already seen is dropped.
        init_states = model.init_states()
        seen: Dict[int, None] = {}
        vecs: List[np.ndarray] = []
        fps: List[int] = []
        for s in init_states:
            vec = np.asarray(dm.encode(s), np.uint32)
            rep_fp = fp = host_fp64(vec)
            if self._use_symmetry:
                rep = dm.representative(
                    torch.from_numpy(vec.astype(np.int64))[None])
                rep_fp = host_fp64(rep[0].numpy().astype(np.uint32))
            if rep_fp in seen:
                continue
            seen[rep_fp] = None
            vecs.append(vec)
            fps.append(fp)
        n_seed = len(fps)
        self._state_count = len(init_states)
        self._base_states = len(init_states)
        self._unique_count = n_seed

        # Visited table: capacity rounds up to a power of two, and is at
        # least 4x the seeds plus two dispatch widths of headroom.
        S = self._B * self._F
        cap = 1 << max(12, (int(table_capacity) - 1).bit_length())
        while cap < 4 * n_seed + 2 * S:
            cap *= 2
        self._capacity = cap
        seed = np.stack(vecs) if vecs else np.zeros((0, W), np.uint32)
        self._layout.check_fits(seed)
        self._seed(self._layout.pack_np(seed),
                   np.array(fps, np.uint64), np.array(list(seen), np.uint64),
                   arena_capacity)

        # The kernels' scratch for a wave's rows, handed to every call
        # (the rehash's chunks too) and back clean from each.
        rows, shards = self._scratch_shape()
        self._scratch = (DedupScratch(rows, device, shards)
                         if device.type == "cuda" else None)
        self._discoveries: Dict[str, int] = {}
        #: waves that expanded rows, dispatches run, table rehashes and
        #: arena doublings, and candidates that reached the table probe
        self.waves = self.dispatches = self.rehashes = self.arena_grows = 0
        self.candidates = 0
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _seed(self, seed: np.ndarray, fps: np.ndarray, rep_fps: np.ndarray,
              arena_capacity) -> None:
        """Builds the visited table from the seeds' dedup fingerprints
        ``rep_fps``, the arena from their packed rows ``seed`` and path
        fingerprints ``fps`` (uint64), and the first dispatch's stats."""
        device, n_seed = self._device, len(fps)
        S = self._B * self._F
        table = np.full(self._capacity, SENTINEL_U64, np.uint64)
        host_table_insert(table, rep_fps)
        self._table = torch.from_numpy(table.view(np.int64)).to(device)

        ucap = _pow2(max(arena_capacity or max(1 << 15, 4 * S), n_seed))
        self._ucap = ucap
        self._vecs = torch.zeros((ucap + 1, self._layout.packed_width),
                                 dtype=torch.int32, device=device)
        self._vecs[:n_seed] = torch.from_numpy(seed.view(np.int32))
        self._fps = torch.full((ucap + 1,), SENTINEL, dtype=torch.int64,
                               device=device)
        self._fps[:n_seed] = torch.from_numpy(fps.view(np.int64))
        self._par = torch.full_like(self._fps, SENTINEL)
        self._ebits = torch.zeros((ucap + 1,), dtype=torch.int32,
                                  device=device)
        self._ebits[:n_seed] = _i32(self._ebits_all)

        self._head, self._tail, self._occ = 0, n_seed, n_seed
        P = len(self._properties)
        stats = [0] * (ST_DISC + P)
        stats[ST_TAIL] = stats[ST_OCC] = n_seed
        stats[ST_TARGET] = self._target_left()
        stats[ST_DISC:] = [SENTINEL] * P
        self._stats = torch.tensor(stats, dtype=torch.int64, device=device)

    def _scratch_shape(self):
        """``DedupScratch``'s rows and shards: a wave's, the rows of one
        call of its dedup kernel, one shard."""
        return self._B * self._F, 1

    def _target_left(self) -> int:
        """Successors still to generate before the target state count
        (effectively unbounded without one)."""
        return (self._target - self._base_states
                if self._target is not None else 1 << 62)

    # -- Device dispatch ---------------------------------------------------

    def _dispatch(self) -> torch.Tensor:
        """Runs K waves on the device from ``self._stats`` and returns
        the next stats tensor. Nothing here reads a device value on the
        host, so the K waves queue up without a synchronisation."""
        dm, layout = self._dm, self._layout
        B, F, ucap, cap = self._B, self._F, self._ucap, self._capacity
        S = B * F
        P = len(self._properties)
        st = self._stats
        head, tail, occ, succ_total, cand_total, target, err = (
            st[i] for i in (ST_HEAD, ST_TAIL, ST_OCC, ST_SUCC, ST_CAND,
                            ST_TARGET, ST_ERR))
        waves = torch.zeros((), dtype=torch.int64, device=self._device)
        disc = list(st[ST_DISC:].unbind())
        rb = torch.arange(B, dtype=torch.int64, device=self._device)
        rs = torch.arange(S, dtype=torch.int64, device=self._device)
        for _ in range(self._K):
            # The reference's while_loop condition (fused.py:324-333).
            go = ((head < tail) & (err == 0) & (tail + S <= ucap)
                  & (occ + S <= cap // 2) & (succ_total < target))
            if P:
                go = go & ~(torch.stack(disc) != SENTINEL).all()
            idx = head + rb
            valid = (idx < tail) & go
            idx = idx.clamp(max=ucap - 1)
            bstore = self._vecs[idx]
            rows = layout.unpack(bstore)
            bfps = self._fps[idx]
            bebits = self._ebits[idx]

            conds = eval_properties(self._prop_fns, rows)
            for i, prop in enumerate(self._properties):
                if prop.expectation is Expectation.ALWAYS:
                    disc[i] = _first_hit(disc[i], valid & ~conds[i], bfps)
                elif prop.expectation is Expectation.SOMETIMES:
                    disc[i] = _first_hit(disc[i], valid & conds[i], bfps)

            err_col = None
            if self._wave_kernel:
                # The whole successor path in one kernel, on the packed
                # rows; succ_count and terminal follow from sflat, and
                # the error lane is read from the packed successors.
                (succ_store, path_fps, sflat, new_mask, _, new_count,
                 cand_count, full) = wave_megakernel(
                    dm, bstore, valid, self._table, self._use_symmetry,
                    layout, scratch=self._scratch)
                succ_count = sflat.sum(dtype=torch.int64)
                terminal = valid & ~sflat.reshape(B, F).any(dim=1)
                if dm.error_lane is not None:
                    err_col = layout.lane(succ_store, dm.error_lane)
            else:
                succ, sflat, succ_count, terminal = expand_frontier(
                    dm, rows, valid)
                dedup_fps, path_fps = fingerprint_successors(
                    dm, succ, sflat, self._use_symmetry)
                new_mask, _, new_count, cand_count, full = dedup_and_insert(
                    dedup_fps, self._table, scratch=self._scratch)
                succ_store = layout.pack(succ)
                if dm.error_lane is not None:
                    err_col = succ[:, dm.error_lane]
            comp = compaction_order(new_mask)

            # Eventually bits: clear the satisfied ones at the parent,
            # then flag terminal parents with bits left (bfs.rs:212-272).
            cleared = bebits
            for i, prop in enumerate(self._properties):
                if prop.expectation is Expectation.EVENTUALLY:
                    cleared = torch.where(conds[i], cleared & ~_i32(1 << i),
                                          cleared)
            for i, prop in enumerate(self._properties):
                if prop.expectation is Expectation.EVENTUALLY:
                    hit = valid & terminal & (((cleared >> i) & 1) != 0)
                    disc[i] = _first_hit(disc[i], hit, bfps)

            if err_col is not None:
                bad = ((err_col != 0) & new_mask).any()
                err = err | torch.where(bad, ERR_LANE, 0)
            err = err | torch.where(full, ERR_TABLE_FULL, 0)

            # Append the new rows at the tail in frontier order (the
            # bfs.rs:262 enqueue order); the rest go to the dump row.
            nc = new_count.to(torch.int64)
            pos = torch.where(rs < nc, tail + rs, ucap)
            parent = comp // F
            self._vecs.index_copy_(0, pos, succ_store[comp])
            self._fps.index_copy_(0, pos, path_fps[comp])
            self._par.index_copy_(0, pos, bfps[parent])
            self._ebits.index_copy_(0, pos, cleared[parent])

            head = torch.where(go, torch.minimum(head + B, tail), head)
            tail = tail + nc
            occ = occ + nc
            succ_total = succ_total + succ_count
            cand_total = cand_total + cand_count
            waves = waves + go
        return torch.stack([head, tail, occ, succ_total, cand_total, target,
                            err, waves] + disc)

    # -- Host loop ---------------------------------------------------------

    def _run(self) -> None:
        try:
            self._run_waves()
        except BaseException as e:  # surfaced at join()
            self._error = e
        finally:
            self._done.set()

    def _run_waves(self) -> None:
        P = len(self._properties)
        while True:
            with self._lock:
                done = (len(self._discoveries) == P
                        or (self._target is not None
                            and self._state_count >= self._target))
            if done or not self._live():
                return
            if self._needs_growth():
                self._grow()
                continue
            self._stats = self._dispatch()
            self._process(self._stats.cpu().numpy())

    def _live(self) -> bool:
        """Whether the queue holds rows to expand."""
        return self._head < self._tail

    def _needs_growth(self) -> bool:
        """Whether the next dispatch could overflow the table's half load
        or the arena."""
        S = self._B * self._F
        return (self._occ + S > self._capacity // 2
                or self._tail + S > self._ucap)

    def _process(self, st: np.ndarray) -> None:
        """Applies one dispatch's stats (absolute values)."""
        if st[ST_ERR] & ERR_LANE:
            raise RuntimeError(
                f"device model error lane {self._dm.error_lane} is set in a "
                "generated state: an encoding capacity was exceeded")
        if st[ST_ERR] & ERR_TABLE_FULL:
            raise RuntimeError("the visited table filled up: a candidate "
                               "found no free slot")
        with self._lock:
            tail = int(st[ST_TAIL])
            self._unique_count += tail - self._tail
            self._head, self._tail = int(st[ST_HEAD]), tail
            self._occ = int(st[ST_OCC])
            self._state_count = self._base_states + int(st[ST_SUCC])
            self.candidates = int(st[ST_CAND])
            self.waves += int(st[ST_WAVES])
            self.dispatches += 1
            for i, prop in enumerate(self._properties):
                fp = int(st[ST_DISC + i])
                if fp != SENTINEL and prop.name not in self._discoveries:
                    self._discoveries[prop.name] = to_u64(fp)

    def _rehash(self, old: torch.Tensor, new: torch.Tensor):
        """Re-inserts table ``old``'s keys into the empty table ``new``
        through the dedup kernel with the engine's scratch (see
        ``_grow``), in ``n`` chunks of at most the scratch's rows, ``n`` a
        power of two: chunk k is every n-th slot from slot k, copied
        contiguous. Not runs of adjacent slots: the keys of adjacent slots
        share the high bits of their hash, which also pick their home
        slots in the scratch, so a run of them piles into a small window
        of it (``chip_smoke.py``'s rehash case, 2^26 slots into 2^27 on an
        H100: about 20 times slower in runs than in strides). Returns a
        bool 0-dim tensor on the device, the chunks' ``full`` flags ORed:
        whether a key found no free slot."""
        n = _pow2(-(-old.shape[0] // self._scratch_shape()[0]))
        cols = old.view(-1, n)
        return torch.stack([
            dedup_and_insert(cols[:, k].contiguous(), new,
                             scratch=self._scratch)[4]
            for k in range(n)]).any()

    def _grow(self) -> None:
        """Growth at a rest point: the table doubles until the next
        dispatch keeps its load at most 1/2 (each doubling re-inserts the
        old table through the dedup kernel, ``_rehash``), and the arena
        doubles until a dispatch's appends fit.

        JAX rehashes a table in one ``dedup_and_insert`` call over all its
        slots. The port chunks it through the engine's scratch, at most a
        wave's rows a call, and reads the ORed ``full`` flags once: a call
        over C rows would need a scratch of 2·C slots of 16 bytes, which
        ``table.DedupScratch`` refuses above 2^30 slots (so the table could
        not grow past 2^30) and which would set the peak of device memory.
        The old keys are distinct, so chunks change neither the set the new
        table holds nor its occupancy, and sentinel slots stay invalid
        rows; slot order has no meaning."""
        S = self._B * self._F
        while self._occ + S > self._capacity // 2:
            table = torch.full((2 * self._capacity,), SENTINEL,
                               dtype=torch.int64, device=self._table.device)
            if bool(self._rehash(self._table, table)):
                raise RuntimeError("rehash found no free slot")
            self._table, self._capacity = table, 2 * self._capacity
            self.rehashes += 1
        while self._tail + S > self._ucap:
            ucap = 2 * self._ucap

            def grown(a, fill):
                out = torch.full((ucap + 1,) + a.shape[1:], fill,
                                 dtype=a.dtype, device=a.device)
                out[:self._ucap] = a[:self._ucap]
                return out

            with self._lock:
                self._vecs = grown(self._vecs, 0)
                self._fps = grown(self._fps, SENTINEL)
                self._par = grown(self._par, SENTINEL)
                self._ebits = grown(self._ebits, 0)
                self._ucap = ucap
            self.arena_grows += 1

    # -- Paths -------------------------------------------------------------

    def _fingerprint_chain(self, fp: int) -> List[int]:
        """The uint64 fingerprints from an init state to ``fp``, read
        from the arena's parent column."""
        with self._lock:
            fps, par, tail = self._fps, self._par, self._tail
        fps, chain = fps[:tail], []
        cur = to_i64(fp)
        while cur != SENTINEL:
            chain.append(to_u64(cur))
            row = int(torch.nonzero(fps == cur)[0, 0])
            cur = int(par[row])
        return chain[::-1]

    # -- Checker API -------------------------------------------------------

    def model(self):
        return self._model

    def kernel_path(self) -> str:
        """Which successor-path implementation the waves run:
        ``megakernel`` (the single-kernel wave) or ``dedup_kernel``
        (torch stages around the dedup kernel) on the card, and their
        plain versions ``megakernel_plain`` or ``dedup_plain`` on the
        CPU."""
        on_card = self._device.type == "cuda"
        if self._wave_kernel:
            return "megakernel" if on_card else "megakernel_plain"
        return "dedup_kernel" if on_card else "dedup_plain"

    def state_count(self) -> int:
        with self._lock:
            return self._state_count

    def unique_state_count(self) -> int:
        with self._lock:
            return self._unique_count

    def discoveries(self) -> Dict[str, Path]:
        with self._lock:
            found = list(self._discoveries.items())
        return {name: Path.from_fingerprints(
                    self._model, self._fingerprint_chain(fp), self._dm)
                for name, fp in found}

    def join(self) -> "FusedCudaBfsChecker":
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self

    def is_done(self) -> bool:
        return self._done.is_set()
