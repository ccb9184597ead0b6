"""Fused device BFS: the checker's whole state lives on the device.

The port's copy of ``stateright_tpu/tpu/fused.py::FusedTpuBfsChecker``,
and in ``BfsEngine`` the parts of ``tpu/engine.py::TpuBfsChecker`` that
it shares with the port's classic engine (``classic.py``): seeding and
resuming, the table and its chunked inserts, checkpoints, the worker and
the Checker API. A visitor or a property the host evaluates needs a host
step a wave, which this engine has not: it raises ``FusedUnsupported``
and the builder spawns the classic engine.

- **Arena.** Every discovered state is a row of a device arena: packed
  words ``vecs[U+1, Wp]``, ``fps[U+1]``, parent ``par[U+1]`` and
  eventually-bits ``ebits[U+1]``. Rows ``[head, tail)`` are the BFS
  queue, all rows are the parent map, and row ``U`` is a dump row that
  absorbs the appends' plain version's writes of rows that are not new
  (the append kernel writes the new rows alone).
- **Dispatches.** One dispatch runs ``K`` waves of ``bucket`` rows with
  no host synchronisation. JAX runs them in a ``lax.while_loop``; torch
  has no device-side loop, so the stop predicates are computed on the
  device into a ``go`` flag that masks the wave's rows, and a wave past a
  rest point is a no-op (the reference's "launched past a rest point"
  rule). The new rows go to a device-side ``tail`` through the append
  kernel (``append.py``). A dispatch writes its stats, in the ``ST_*``
  layout, in place into the static ``_stats`` tensor the next one reads.
  On the card a dispatch is one CUDA graph (``graphs.py``): JAX's one
  program a dispatch.
- **The host loop** (``_run_waves``, the reference's :460-816 without
  the arena-span spill and the tracer) launches up to
  ``inflight_dispatches`` dispatches ahead of its stats reads: after each
  launch it copies the stats to a pinned host slot of its own and waits
  for that copy alone when it retires the dispatch. The width of each
  dispatch is the least rung of the bucket ladder (``max_batch_size``)
  that covers the queue, as last retired.
- **Rest points.** Between dispatches the host grows the visited table
  (a rehash through the same dedup kernel) or the arena when the next
  dispatch could overflow either, once every dispatch in flight is
  retired, and retires discoveries.
- **Paths.** Parents stay in the arena; a path reconstruction reads its
  chain from there on demand, and from the host's parent map (the seeds,
  or a checkpoint's parent sections) for the rows it does not hold.
- **Checkpoints** (the reference's ``tpu/engine.py`` :552-800 and the
  fused hooks): with ``checkpoint_path`` the loop writes a snapshot at a
  rest point once ``checkpoint_every_waves * batch_size`` new states
  arrived since the last, with no dispatch in flight and after any
  growth, and one at the end of the run. A snapshot reads the device
  only (the visited set, the queue's rows, the parents), so the dispatch
  graphs stay. ``resume_from`` starts from a snapshot of either of the
  port's engines or of a JAX BFS engine; its visited set goes into the
  table through the dedup kernel (``_new_table``). ``checkpoint()`` and
  ``restart_from()`` are the reference's.

The successor path of a wave runs one of two ways, each a CUDA kernel on
the card and its plain version on the CPU:

- by default, torch stage functions (``engine``) for the step, the
  fingerprints and the packing, and ``table.dedup_and_insert`` for the
  dedup;
- with ``wave_kernel=True``, the single-kernel wave
  ``wave.wave_megakernel``, on the packed batch as it lies in the arena.

With ``wave_matmul`` (``matmul_wave.py``) a regular model's expand stage
runs in its transition-table form either way: ``matmul_expand`` in the
torch stages, the plan form of the kernel (``csrc/plan.cuh``) with
``wave_kernel=True``. The model is classified at spawn (``_configure``,
the reference's ``tpu/engine.py`` :290-319); an irregular one warns once
and keeps its step.

The table's rehash at rest points goes through ``table.dedup_and_insert``
either way, in chunks of at most a wave's rows with the engine's scratch.
``kernel_path()`` says which implementation ran.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from .append import append_rows
from .checker import Checker
from .checkpoint_format import (load_checkpoint, make_header, pending_rows,
                                validate_header, write_atomic)
from .engine import (batch_bucket_ladder, compaction_order, eval_properties,
                     fingerprint_successors, host_table_insert, pick_bucket)
from .graphs import DispatchGraphs
from .hashing import SENTINEL, SENTINEL_U64, host_fp64, to_i64, to_u64
from .io.async_io import writer_from_config
from .matmul_wave import expand, gate, wave_matmul_on
from .model import Expectation, property_predicates
from .packing import compile_layout
from .path import Path
from .table import DedupScratch, dedup_and_insert
from .visitor import as_visitor
from .wave import cuda_model, cuda_plan, sender_megakernel, wave_megakernel

__all__ = ["BfsEngine", "FusedCudaBfsChecker", "FusedUnsupported", "KERNELS",
           "ST_HEAD", "ST_TAIL", "ST_OCC", "ST_SUCC", "ST_CAND", "ST_TARGET",
           "ST_ERR", "ST_WAVES", "ST_DISC", "ERR_LANE", "ERR_TABLE_FULL"]

# Dispatch-stats layout (int64), read by the host once per dispatch and
# chained on the device into the next one. Discovery fingerprints follow
# from ST_DISC, one slot per property (SENTINEL until found).
(ST_HEAD, ST_TAIL, ST_OCC, ST_SUCC, ST_CAND, ST_TARGET, ST_ERR,
 ST_WAVES) = range(8)
ST_DISC = 8
#: ST_ERR bits: a generated state set the model's error lane; a
#: candidate found no free slot in the visited table.
ERR_LANE, ERR_TABLE_FULL = 1, 2
#: the kernel wrappers whose ``.launches`` a dispatch graph accounts for
KERNELS = (dedup_and_insert, wave_megakernel, sender_megakernel,
           append_rows)


#: the header sections of modules the port has not ported, which no
#: resume may drop
_UNPORTED = {
    "store": "references cold segments of the tiered store "
             "(stateright_tpu/store/tiered.py, ROADMAP A6)",
    "shard": "marks one partition of an elastic run "
             "(stateright_tpu/resilience/elastic.py, ROADMAP A13)",
    "elastic": "marks an elastic run's manifest "
               "(stateright_tpu/resilience/elastic.py, ROADMAP A13)"}
_I64_MIN = -(1 << 63)


def checkpoint_name(model) -> str:
    """The model name a checkpoint header records: the model's
    ``checkpoint_name`` where it sets one, else its class's name."""
    return model.checkpoint_name or type(model).__name__


def _u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit patterns on any device as numpy ``uint32``."""
    return t.cpu().numpy().view(np.uint32)


def _u64(t: torch.Tensor) -> np.ndarray:
    """int64 bit patterns on any device as numpy ``uint64``."""
    return t.cpu().numpy().view(np.uint64)


def _first_occurrences(keys: torch.Tensor) -> torch.Tensor:
    """True at the first occurrence of each key of ``keys``."""
    order = torch.sort(keys, stable=True).indices
    s = keys[order]
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    out = torch.empty_like(first)
    out[order] = first
    return out


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


class FusedUnsupported(TypeError):
    """The model or builder needs a host step a wave (a visitor, or a
    property the host evaluates), which only the classic engine has:
    ``spawn_cuda_bfs`` then spawns it, unless ``fused=True``."""


class BfsEngine(Checker):
    """What the port's device engines share (the reference's
    ``TpuBfsChecker``, of which its fused engine is a subclass): the
    configuration, seeding and resuming, the visited table and its
    chunked inserts, checkpoints, the worker thread and the Checker API.
    A subclass sets up its own state in ``_start`` and runs its host loop
    in ``_run_waves``."""

    def _configure(self, builder, device: torch.device, batch_size: int,
                   table_capacity: int, wave_kernel: bool, max_batch_size,
                   checkpoint_path, checkpoint_every_waves: int,
                   async_io, wave_matmul=None, dm=None) -> None:
        model = builder._model
        if dm is None:  # not resolved by ``spawn_cuda_bfs`` already
            dm = model.device_model()
        self._model, self._dm, self._device = model, dm, device
        self._properties = model.properties()
        if len(self._properties) > 32:
            raise NotImplementedError("at most 32 properties on device")
        self._prop_fns = property_predicates(self._properties, dm)
        self._visitor = (None if builder._visitor is None
                         else as_visitor(builder._visitor))
        # A configuration this engine cannot run raises here, before the
        # writer thread, the scratch and the table exist.
        self._check_support()
        self._use_symmetry = bool(builder._symmetry)
        W = dm.state_width
        if self._use_symmetry and dm.representative(
                torch.zeros((1, W), dtype=torch.int64)) is None:
            raise NotImplementedError(
                "symmetry() needs DeviceModel.representative()")
        self._target = builder._target_state_count
        self._B, self._F = int(batch_size), dm.max_fanout
        self._buckets = batch_bucket_ladder(self._B, max_batch_size)
        self._B_max = self._buckets[-1]
        self._layout = compile_layout(dm.lane_bits(), W)
        self._wave_kernel = bool(wave_kernel)
        # The expand stage's transition-table form: the model classified
        # now (its step probed on this device), as the reference does at
        # spawn; an irregular one warns once and keeps its step.
        self._wave_matmul_on = wave_matmul_on(wave_matmul)
        self._matmul_plan = self._matmul_reason = None
        if self._wave_matmul_on:
            cls = gate(dm, device)
            self._matmul_plan, self._matmul_reason = cls.plan, cls.reason
        if self._wave_kernel and device.type == "cuda":
            # Both raise before any device work.
            cuda_model(dm, self._layout)
            if self._matmul_plan is not None:
                cuda_plan(dm, self._layout, self._matmul_plan)
        self._ebits_all = 0
        for i, p in enumerate(self._properties):
            if p.expectation is Expectation.EVENTUALLY:
                self._ebits_all |= 1 << i
        self._ckpt_path = checkpoint_path
        self._ckpt_every = max(1, int(checkpoint_every_waves))
        # One checkpoint writer an engine: inline, or its own thread.
        self._aio = writer_from_config(
            async_io, name=f"stpu-aio-{type(self).__name__}")

        # The kernels' scratch for a wave's rows, handed to every call
        # (the table's chunked inserts too) and back clean from each.
        rows, shards = self._scratch_shape()
        self._scratch = (DedupScratch(rows, device, shards)
                         if device.type == "cuda" else None)
        # Visited table: capacity rounds up to a power of two, and is at
        # least 4x the visited set plus two of the widest dispatch's
        # widths (``_start``).
        self._capacity = 1 << max(12, (int(table_capacity) - 1).bit_length())
        self._discoveries: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _check_support(self) -> None:
        """Raises for a configuration this engine cannot run (the
        reference's hook of the same name)."""

    def _spawn_worker(self) -> None:
        """Starts the worker thread that runs ``_run``."""
        self._done = threading.Event()
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _init_rows(self):
        """The init states as seed rows: ``(packed rows, path fps, ebits,
        dedup fps)``, numpy ``uint32``/``uint64``. Under symmetry an init
        state whose representative was already seen is dropped. The
        seeds are the host parent map's roots."""
        model, dm = self._model, self._dm
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
        self._state_count = self._base_states = len(init_states)
        self._unique_count = len(fps)
        seed = (np.stack(vecs) if vecs
                else np.zeros((0, dm.state_width), np.uint32))
        self._layout.check_fits(seed)
        fps = np.array(fps, np.uint64)
        self._parents = (fps, np.zeros(len(fps), np.uint64),
                         np.ones(len(fps), bool))
        return (self._layout.pack_np(seed), fps,
                np.full(len(fps), self._ebits_all, np.uint32),
                np.array(list(seen), np.uint64))

    def _new_table(self, visited: np.ndarray, resumed: bool) -> torch.Tensor:
        """A table of the engine's capacity holding the ``uint64``
        fingerprints ``visited``, on the engine's device.

        A fresh run's seeds go in on the host (``host_table_insert``), as
        in JAX. A resumed run's visited set goes up as it lies in the file
        and into the table through the dedup kernel, in strided chunks of
        at most the scratch's rows with the engine's scratch, its chunks'
        ``full`` flags ORed and read once (``_insert_chunked``): on the
        card the kernel builds a table of millions of keys where the
        host's insert takes seconds. JAX inserts on the host either way
        (``tpu/engine.py`` :803-811); this is the port's own choice.
        Slot order has no meaning (checkpoints sort the set), so the two
        tables hold the same set at the same capacity."""
        cap = self._capacity
        if not resumed:
            table = np.full(cap, SENTINEL_U64, np.uint64)
            host_table_insert(table, visited)
            return torch.from_numpy(table.view(np.int64)).to(self._device)
        table = torch.full((cap,), SENTINEL, dtype=torch.int64,
                           device=self._device)
        keys = torch.from_numpy(
            np.ascontiguousarray(visited, np.uint64).view(np.int64)
        ).to(self._device)
        if bool(self._insert_chunked(keys, table)):
            raise RuntimeError("the resumed visited set found no free slot")
        return table

    def _scratch_shape(self):
        """``DedupScratch``'s rows and shards: the widest wave's, the rows
        of one call of its dedup kernel, one shard."""
        return self._B_max * self._F, 1

    def _run(self) -> None:
        try:
            self._run_waves()
            if self._ckpt_path is not None:
                self._write_checkpoint(self._ckpt_path)
            # The last generation lands, or its writer's failure raises,
            # before the run is done.
            self._aio.join()
        except BaseException as e:  # surfaced at join()
            self._error = e
        finally:
            self._done.set()

    def _chunks(self, n: int) -> int:
        """The chunks ``_insert_chunked`` takes for ``n`` keys: the least
        power of two of chunks of at most the scratch's rows."""
        return _pow2(-(-n // self._scratch_shape()[0]))

    def _insert_chunked(self, keys: torch.Tensor, table: torch.Tensor):
        """Inserts the distinct int64 keys ``keys`` (sentinels are not
        keys) into ``table`` through the dedup kernel with the engine's
        scratch, in ``n`` chunks of at most the scratch's rows, ``n`` a
        power of two: chunk k is every n-th key from key k, copied
        contiguous (the keys padded with sentinels to a multiple of n).
        Not runs of adjacent slots of an old table: the keys of adjacent
        slots share the high bits of their hash, which also pick their
        home slots in the scratch, so a run of them piles into a small
        window of it (``chip_smoke.py``'s rehash case, 2^26 slots into
        2^27 on an H100: about 20 times slower in runs than in strides).
        Returns a bool 0-dim tensor on the device, the chunks' ``full``
        flags ORed: whether a key found no free slot."""
        n = self._chunks(keys.shape[0])
        pad = -keys.shape[0] % n
        if pad:
            keys = torch.cat([keys, keys.new_full((pad,), SENTINEL)])
        if not keys.numel():
            return torch.zeros((), dtype=torch.bool, device=table.device)
        cols = keys.view(-1, n)
        return torch.stack([
            dedup_and_insert(cols[:, k].contiguous(), table,
                             scratch=self._scratch)[4]
            for k in range(n)]).any()

    def _visited_sorted(self) -> np.ndarray:
        """The visited set, ``uint64`` sorted (engine :603-610): the
        table's keys with the sentinels dropped, sorted on the device as
        the unsigned values they stand for."""
        keys = self._table[self._table != SENTINEL]
        return _u64(torch.sort(keys ^ _I64_MIN).values ^ _I64_MIN)

    def _write_checkpoint(self, path: str) -> None:
        """Writes one generation at a rest point (engine :629-662): joins
        the last write first (its failure raises here), takes the
        snapshot on this thread, and hands the write to the writer."""
        self._aio.join()
        payload = self._snapshot()
        self._aio.submit(lambda: write_atomic(path, payload))
        self.checkpoints += 1

    def checkpoint(self, path: str) -> None:
        """Writes a resumable snapshot to ``path``, once the run has
        stopped (done, every property found, or the target reached), and
        returns when the file has landed. While the run goes, pass
        ``checkpoint_path`` to ``spawn_cuda_bfs`` instead."""
        if not self._done.is_set():
            raise RuntimeError(
                "checkpoint() while the checker is running would race the "
                "wave loop; pass checkpoint_path=... to spawn_cuda_bfs for "
                "periodic snapshots, or join() first")
        if self._error is not None:
            # A failed dispatch's states may be in the table but not in
            # the queue; a snapshot would lose their subtrees.
            raise RuntimeError(
                "checkpoint() after a failed run would snapshot a torn "
                "frontier; resume from the last periodic checkpoint "
                "(restart_from) instead") from self._error
        self._write_checkpoint(path)
        self._aio.join()

    def restart_from(self, path: str) -> "BfsEngine":
        """Recovers this instance in place once its run has stopped (the
        reference's, engine :692-753): drops the failed run's flag, its
        arena, table and dispatch graphs, reloads the snapshot at
        ``path`` and restarts the worker. The kernels stay built and the
        scratch stays."""
        if not self._done.is_set():
            raise RuntimeError(
                "restart_from() while the checker is running; join() "
                "(or wait for the failure) first")
        self._thread.join()
        self._aio.reset()
        self._error = None
        self._discoveries = {}
        self.dispatch_log = []
        self._reset_engine_state()
        self._start(path)
        self._spawn_worker()
        return self

    def _load_checkpoint(self, path: str):
        """Restores the counts, discoveries and host parent map from the
        checkpoint at ``path`` (engine :755-800) and returns its seed
        rows as ``_init_rows`` does: the pending rows packed in this
        engine's layout (a ``u32`` or ``packed`` file alike), their
        fingerprints and eventually bits, and the visited set."""
        W = self._dm.state_width
        with load_checkpoint(path) as data:
            header = validate_header(
                data, model_name=checkpoint_name(self._model),
                state_width=W, use_symmetry=self._use_symmetry)
            for key, what in _UNPORTED.items():
                if header.get(key):
                    raise NotImplementedError(
                        f"checkpoint {path!r} has a {key!r} section, which "
                        f"{what}; the port cannot resume it")
            rows = pending_rows(data, header, W)
            self._layout.check_fits(rows)
            seed = self._layout.pack_np(rows)
            fps = np.asarray(data["pending_fps"], np.uint64)
            ebits = np.asarray(data["pending_ebits"], np.uint32)
            self._parents = (
                np.asarray(data["parent_child"], np.uint64),
                np.asarray(data["parent_parent"], np.uint64),
                np.asarray(data["parent_rooted"], bool))
            visited = np.asarray(data["visited"], np.uint64)
        self._state_count = self._base_states = int(header["state_count"])
        self._unique_count = int(header["unique_count"])
        self._discoveries = {k: int(v)
                             for k, v in header["discoveries"].items()}
        return seed, fps, ebits, visited

    def model(self):
        return self._model

    def kernel_path(self) -> str:
        """Which successor-path implementation the waves run:
        ``megakernel`` (the single-kernel wave) or ``dedup_kernel``
        (torch stages around the dedup kernel) on the card, and their
        plain versions ``megakernel_plain`` or ``dedup_plain`` on the
        CPU; each with ``+matmul`` when the expand stage runs a matmul
        plan (the reference's suffix, ``tpu/engine.py`` :925-929)."""
        on_card = self._device.type == "cuda"
        if self._wave_kernel:
            path = "megakernel" if on_card else "megakernel_plain"
        else:
            path = "dedup_kernel" if on_card else "dedup_plain"
        return path + self._matmul_suffix()

    def _matmul_suffix(self) -> str:
        return "+matmul" if self._matmul_plan is not None else ""

    def _expand_impl(self) -> str:
        """The expand stage the waves run: ``matmul`` (a plan's tables) or
        ``step`` (the model's own, also an irregular model's with the knob
        on)."""
        return "matmul" if self._matmul_plan is not None else "step"

    def _wave_matmul_stats(self) -> dict:
        """``scheduler_stats()["wave_matmul"]``, the reference's five keys
        (``tpu/engine.py`` :1103-1109)."""
        plan = self._matmul_plan
        return {"enabled": self._wave_matmul_on, "active": plan is not None,
                "expand_impl": self._expand_impl(),
                "reason": self._matmul_reason,
                "matmul_ops": plan.matmul_ops if plan is not None else 0}

    def state_count(self) -> int:
        with self._lock:
            return self._state_count

    def unique_state_count(self) -> int:
        with self._lock:
            return self._unique_count

    def discoveries(self) -> Dict[str, Path]:
        with self._lock:
            found = list(self._discoveries.items())
        return {name: Path.from_device_fingerprints(
                    self._model, self._fingerprint_chain(fp), self._dm)
                for name, fp in found}

    def join(self) -> "BfsEngine":
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self

    def is_done(self) -> bool:
        return self._done.is_set()


class FusedCudaBfsChecker(BfsEngine):
    """Device-arena BFS with multi-wave dispatches."""

    def __init__(self, builder, device: torch.device, batch_size: int = 1024,
                 table_capacity: int = 1 << 16, arena_capacity=None,
                 waves_per_dispatch: int = 16, wave_kernel: bool = False,
                 max_batch_size=None, inflight_dispatches: int = 1,
                 cuda_graph: bool = False, checkpoint_path=None,
                 checkpoint_every_waves: int = 64, resume_from=None,
                 async_io=None, wave_matmul=None, device_model=None):
        self._K = max(1, int(waves_per_dispatch))
        # Dispatches launched ahead of the oldest one's stats read; safe at
        # any depth, since a dispatch launched past a rest point is a no-op.
        self._depth = max(1, int(inflight_dispatches))
        self._configure(builder, device, batch_size, table_capacity,
                        wave_kernel, max_batch_size, checkpoint_path,
                        checkpoint_every_waves, async_io, wave_matmul,
                        device_model)
        self._arena_capacity = arena_capacity
        self._start(resume_from)

        #: waves that expanded rows, dispatches run, table rehashes,
        #: arena doublings and checkpoints written, and candidates that
        #: reached the table probe
        self.waves = self.dispatches = self.rehashes = self.arena_grows = 0
        self.checkpoints = self.candidates = 0
        #: one dict a retired dispatch: its ``bucket``, the dispatches in
        #: flight at its launch (``inflight``, itself included), its
        #: ``waves`` that expanded rows, whether it ``compiled`` (paid a
        #: graph capture) and its ``expand_impl``
        self.dispatch_log: List[dict] = []
        self._graphs = DispatchGraphs(KERNELS) if cuda_graph else None
        # The ring of host slots the stats are copied to, one a dispatch
        # in flight (pinned, so the copy does not wait for the card).
        pinned = device.type == "cuda"
        self._host_stats = [torch.empty(self._stats.shape,
                                        dtype=torch.int64, pin_memory=pinned)
                            for _ in range(self._depth)]
        self._launched = 0
        self._spawn_worker()

    def _check_support(self) -> None:
        """A visitor or a property with no device predicate needs a host
        step a wave (the reference's ``tpu/fused.py`` :162-170)."""
        if self._visitor is not None:
            raise FusedUnsupported(
                "visitors need the per-wave host loop; the builder falls "
                "back to the classic engine")
        if any(fn is None for fn in self._prop_fns):
            raise FusedUnsupported(
                "host-fallback properties need the per-wave host loop; "
                "the builder falls back to the classic engine")

    def _start(self, resume_from) -> None:
        """Seeds a run: from the init states, or from the checkpoint at
        ``resume_from``; then grows the table's capacity to the rule and
        builds the device state (``_seed``)."""
        if resume_from is None:
            seed, fps, ebits, visited = self._init_rows()
        else:
            seed, fps, ebits, visited = self._load_checkpoint(resume_from)
        while self._capacity < 4 * len(visited) + 2 * self._B_max * self._F:
            self._capacity *= 2
        self._seed(seed, fps, ebits, visited, resumed=resume_from is not None)

    def _seed(self, seed: np.ndarray, fps: np.ndarray, ebits: np.ndarray,
              visited: np.ndarray, resumed: bool) -> None:
        """Builds the visited table from the dedup fingerprints
        ``visited`` (``_new_table``), the arena from the seeds' packed
        rows ``seed``, path fingerprints ``fps`` and eventually bits
        ``ebits`` (numpy ``uint32``/``uint64``), and the first dispatch's
        stats. A resumed run's table is built by the dedup kernel, not on
        the host as in JAX: slot order has no meaning, since checkpoints
        sort the visited set (``tpu/engine.py`` :603-610)."""
        device, n_seed = self._device, len(fps)
        self._table = self._new_table(visited, resumed)
        S = self._B_max * self._F
        ucap = _pow2(max(self._arena_capacity or max(1 << 15, 4 * S),
                         n_seed))
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
        self._ebits[:n_seed] = torch.from_numpy(ebits.view(np.int32))

        # The seed rows' parents are in the host map: the arena's own
        # part of the parent map starts after them.
        self._n_seed = n_seed
        self._head, self._tail, self._occ = 0, n_seed, len(visited)
        P = len(self._properties)
        stats = [0] * (ST_DISC + P)
        stats[ST_TAIL], stats[ST_OCC] = n_seed, len(visited)
        stats[ST_TARGET] = self._target_left()
        stats[ST_DISC:] = [SENTINEL] * P
        self._stats = torch.tensor(stats, dtype=torch.int64, device=device)

    def _target_left(self) -> int:
        """Successors still to generate before the target state count
        (effectively unbounded without one)."""
        return (self._target - self._base_states
                if self._target is not None else 1 << 62)

    # -- Device dispatch ---------------------------------------------------

    def _dispatch(self, bucket: int) -> None:
        """Runs K waves of ``bucket`` rows on the device from
        ``self._stats`` and writes the next stats into it in place. Nothing
        here reads a device value on the host, so the K waves queue up
        without a synchronisation, and a CUDA graph can hold them."""
        dm, layout = self._dm, self._layout
        B, F, ucap, cap = bucket, self._F, self._ucap, self._capacity
        S = B * F
        P = len(self._properties)
        st = self._stats
        head, tail, occ, succ_total, cand_total, target, err = (
            st[i] for i in (ST_HEAD, ST_TAIL, ST_OCC, ST_SUCC, ST_CAND,
                            ST_TARGET, ST_ERR))
        waves = torch.zeros((), dtype=torch.int64, device=self._device)
        disc = list(st[ST_DISC:].unbind())
        rb = torch.arange(B, dtype=torch.int64, device=self._device)
        arena = tuple(a[None] for a in (self._vecs, self._fps, self._par,
                                        self._ebits))
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
                    layout, scratch=self._scratch, plan=self._matmul_plan)
                succ_count = sflat.sum(dtype=torch.int64)
                terminal = valid & ~sflat.reshape(B, F).any(dim=1)
                if dm.error_lane is not None:
                    err_col = layout.lane(succ_store, dm.error_lane)
            else:
                succ, sflat, succ_count, terminal = expand(
                    dm, self._matmul_plan, rows, valid)
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
            # bfs.rs:262 enqueue order), each with its parent's
            # fingerprint and eventually bits.
            nc = new_count.to(torch.int64)
            append_rows(arena, (succ_store[None], path_fps[None], bfps[None],
                                cleared[None]), comp[None], nc.reshape(1),
                        tail.reshape(1), F)

            head = torch.where(go, torch.minimum(head + B, tail), head)
            tail = tail + nc
            occ = occ + nc
            succ_total = succ_total + succ_count
            cand_total = cand_total + cand_count
            waves = waves + go
        st.copy_(torch.stack([head, tail, occ, succ_total, cand_total,
                              target, err, waves] + disc))

    # -- Host loop ---------------------------------------------------------

    def _run_waves(self) -> None:
        """The pipelined host loop (the reference's ``_run_waves``
        :640-816). Every dispatch stops at a true rest point on the device,
        so the loop launches the next one from the stats on the device
        before it reads the last: up to ``inflight_dispatches`` ahead. It
        retires the oldest first when it must act on stats at rest (growth
        due, or the queue as last read drained), and every launched
        dispatch before it returns: their insertions are real. With
        ``checkpoint_path`` a checkpoint is due once
        ``checkpoint_every_waves * batch_size`` new states arrived since
        the last one this run wrote (a resumed run's first is due at
        once, as in JAX); it is written at rest, after any growth
        (:656-663, :766-769)."""
        P = len(self._properties)
        inflight: deque = deque()
        last_ckpt = 0
        while True:
            with self._lock:
                done = (len(self._discoveries) == P
                        or (self._target is not None
                            and self._state_count >= self._target))
            live = self._live()
            if done or (not live and not inflight):
                break
            bucket = self._pick_bucket()
            growth = self._needs_growth(bucket)
            ckpt_due = (self._ckpt_path is not None
                        and (self._unique_count - last_ckpt
                             >= self._ckpt_every * self._B))
            if (growth or ckpt_due or not live) and inflight:
                self._retire(inflight.popleft())
                continue
            if growth:
                self._grow(bucket)
                continue
            if ckpt_due:
                self._write_checkpoint(self._ckpt_path)
                last_ckpt = self._unique_count
                continue
            inflight.append(self._launch(bucket, len(inflight) + 1))
            if len(inflight) >= self._depth:
                self._retire(inflight.popleft())
        while inflight:
            self._retire(inflight.popleft())

    def _launch(self, bucket: int, inflight: int = 1):
        """Launches one dispatch of ``bucket`` rows (a graph's replay once
        its key was captured) and the copy of its stats to the next host
        slot: ``(host slot, copy's event or None, meta)`` for
        ``_retire``."""
        on_card = self._device.type == "cuda"
        with torch.cuda.device(self._device) if on_card else contextlib.nullcontext():
            if self._graphs is None:
                self._dispatch(bucket)
                captured = False
            else:
                captured = self._graphs.run(
                    bucket, lambda: self._dispatch(bucket))
            host = self._host_stats[self._launched % self._depth]
            self._launched += 1
            host.copy_(self._stats, non_blocking=on_card)
            copied = None
            if on_card:
                copied = torch.cuda.Event()
                copied.record()
        return host, copied, {"bucket": bucket, "inflight": inflight,
                              "compiled": captured,
                              "expand_impl": self._expand_impl()}

    def _retire(self, entry) -> None:
        """Waits for one launched dispatch's stats and applies them."""
        host, copied, meta = entry
        if copied is not None:
            copied.synchronize()
        st = host.numpy()
        self._process(st)
        with self._lock:
            self.dispatch_log.append(dict(
                meta, waves=int(st[..., ST_WAVES].reshape(-1)[0])))

    def _pick_bucket(self) -> int:
        """The next dispatch's width: the least rung that covers the
        queue as last retired."""
        return pick_bucket(self._buckets, self._tail - self._head)

    def _live(self) -> bool:
        """Whether the queue holds rows to expand."""
        return self._head < self._tail

    def _needs_growth(self, bucket: int) -> bool:
        """Whether a dispatch of ``bucket`` rows could overflow the
        table's half load or the arena."""
        S = bucket * self._F
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

    def _grow(self, bucket: int) -> None:
        """Growth at a rest point, with no dispatch in flight: every
        dispatch graph goes (they hold the tensors that growth replaces),
        the table doubles until a dispatch of ``bucket`` rows keeps its
        load at most 1/2 (each doubling re-inserts the old table through
        the dedup kernel, ``_insert_chunked``), and the arena doubles until
        such a dispatch's appends fit.

        JAX rehashes a table in one ``dedup_and_insert`` call over all its
        slots. The port chunks it through the engine's scratch, at most a
        wave's rows a call, and reads the ORed ``full`` flags once: a call
        over C rows would need a scratch of 2·C slots of 16 bytes, which
        ``table.DedupScratch`` refuses above 2^30 slots (so the table could
        not grow past 2^30) and which would set the peak of device memory.
        The old keys are distinct, so chunks change neither the set the new
        table holds nor its occupancy, and sentinel slots stay invalid
        rows; slot order has no meaning."""
        if self._graphs is not None:
            self._graphs.clear()
        S = bucket * self._F
        while self._occ + S > self._capacity // 2:
            table = torch.full((2 * self._capacity,), SENTINEL,
                               dtype=torch.int64, device=self._table.device)
            if bool(self._insert_chunked(self._table, table)):
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

    # -- Checkpoints ---------------------------------------------------------

    def _pending_blocks(self) -> list:
        """The queue's rows ``[head, tail)`` as ``(packed vecs, fps,
        ebits)`` blocks, numpy ``uint32``/``uint64``/``uint32``."""
        lo, hi = self._head, self._tail
        return [(_u32(self._vecs[lo:hi]), _u64(self._fps[lo:hi]),
                 _u32(self._ebits[lo:hi]))]

    def _parent_rows(self):
        """The arena's part of the parent map: the fingerprints and
        parents of rows ``[n_seed, tail)`` (the seed rows' are in the
        host map), as tensors on the device, in the order JAX's parent
        log holds them."""
        lo, hi = self._n_seed, self._tail
        return self._fps[lo:hi], self._par[lo:hi]

    def _parent_sections(self):
        """``(child, parent, rooted)``, in the order of JAX's
        ``_parent_map`` (engine :1825): the host map (the seeds as roots,
        or the parent sections a run resumed from), then the arena's rows
        in the order JAX fetches them, each child's first entry kept (the
        reference's ``setdefault``)."""
        h_child, h_parent, h_rooted = self._parents
        a_child, a_parent = self._parent_rows()
        keys = torch.cat([torch.from_numpy(h_child.view(np.int64)).to(
            a_child.device), a_child])
        child = np.concatenate([h_child, _u64(a_child)])
        parent = np.concatenate([h_parent, _u64(a_parent)])
        rooted = np.concatenate([h_rooted, np.zeros(len(a_child), bool)])
        first = _first_occurrences(keys)
        if not bool(first.all()):
            keep = first.cpu().numpy()
            child, parent, rooted = child[keep], parent[keep], rooted[keep]
        return child, parent, rooted

    def _snapshot(self) -> dict:
        """The checkpoint's sections at a rest point (engine :571-627),
        each with the reference's name and dtype."""
        child, parent, rooted = self._parent_sections()
        blocks = self._pending_blocks()
        layout = self._layout
        header = make_header(
            model_name=checkpoint_name(self._model),
            state_width=self._dm.state_width, state_count=self._state_count,
            unique_count=self._unique_count,
            use_symmetry=self._use_symmetry, discoveries=self._discoveries,
            row_format="packed" if layout.packs else "u32",
            lane_bits=layout.specs if layout.packs else None,
            packed_width=layout.packed_width if layout.packs else None)
        return dict(header=header, visited=self._visited_sorted(),
                    pending_vecs=np.concatenate([b[0] for b in blocks]),
                    pending_fps=np.concatenate([b[1] for b in blocks]),
                    pending_ebits=np.concatenate([b[2] for b in blocks]),
                    parent_child=child, parent_parent=parent,
                    parent_rooted=rooted)

    def _reset_engine_state(self) -> None:
        """Drops the device state a restart rebuilds (fused :882-893)."""
        if self._graphs is not None:
            self._graphs.clear()
        self._table = self._vecs = self._fps = self._par = None
        self._ebits = self._stats = None

    # -- Paths -------------------------------------------------------------

    def _arena_parent(self, cur: int):
        """The parent (int64 bit pattern) of arena row fingerprint
        ``cur`` among the rows whose parents the arena holds, or None."""
        with self._lock:
            fps, par = self._parent_rows()
        hit = torch.nonzero(fps == cur)
        return int(par[hit[0, 0]]) if len(hit) else None

    def _fingerprint_chain(self, fp: int) -> List[int]:
        """The uint64 fingerprints from an init state to ``fp``: each
        link from the host map (its roots end the chain), else from the
        arena's parent column, as JAX's ``_reconstruct_path`` walks its
        parent map."""
        h_child, h_parent, h_rooted = self._parents
        chain = []
        cur = to_i64(fp)
        while True:
            chain.append(to_u64(cur))
            i = np.flatnonzero(h_child == np.uint64(to_u64(cur)))
            if len(i):
                if h_rooted[i[0]]:
                    break
                cur = to_i64(int(h_parent[i[0]]))
                continue
            cur = self._arena_parent(cur)
            if cur is None:
                break
        return chain[::-1]

    # -- Checker API -------------------------------------------------------

    def scheduler_stats(self) -> dict:
        """The host loop's telemetry, under the reference's keys
        (``tpu/engine.py::scheduler_stats``): the bucket ladder, the
        dispatches each bucket served, the dispatches retired, those that
        paid a graph capture, and the deepest pipelining reached; the
        expand stage's form (``wave_matmul``); and the dispatch graphs'
        captures, replays and capture seconds (None with graphs off)."""
        with self._lock:
            log = list(self.dispatch_log)
        buckets: Dict[str, int] = {}
        for e in log:
            buckets[str(e["bucket"])] = buckets.get(str(e["bucket"]), 0) + 1
        g = self._graphs
        return {
            "bucket_ladder": list(self._buckets),
            "bucket_dispatches": buckets,
            "dispatches": len(log),
            "bucket_compiles": sum(1 for e in log if e["compiled"]),
            "max_inflight": max((e["inflight"] for e in log), default=0),
            "wave_matmul": self._wave_matmul_stats(),
            "graphs": None if g is None else {
                "captures": g.captures, "replays": g.replays,
                "capture_sec": g.capture_sec}}
