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
- **The host loop** (``_run_waves``, the reference's :460-816) launches
  up to
  ``inflight_dispatches`` dispatches ahead of its stats reads: after each
  launch it copies the stats to a pinned host slot of its own and waits
  for that copy alone when it retires the dispatch. The width of each
  dispatch is the least rung of the bucket ladder (``max_batch_size``)
  that covers the queue, as last retired.
- **Rest points.** Between dispatches the host grows the visited table
  (a rehash through the same dedup kernel) or the arena when the next
  dispatch could overflow either, once every dispatch in flight is
  retired, and retires discoveries.
- **The tiered store** (``store/tiered.py``, the ``tier_*`` keywords):
  where an arena doubling would pass the device budget, the arena rolls
  instead (``_roll_span``, the reference's :700-750): the expanded prefix
  ``[0, head)`` leaves the card, its parent rows for host blocks, and the
  live window shifts to row 0 in place, with the stats, so the dispatch
  graphs stay. The visited table is never spilled: the dedup runs on the
  card across a dispatch, too late for a host probe.
- **Paths.** Parents stay in the arena; a path reconstruction reads its
  chain from there on demand, and from the host's parent map (the seeds,
  or a checkpoint's parent sections, then the rows the rolls moved) for
  the rows it does not hold.
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
  ``wave.wave_megakernel``, on the packed batch as it lies in the arena,
  where its entry points hold the model (``wave.wave_kernel_fits``,
  decided at spawn): past the sizes they hold, the engine warns once and
  runs the torch stages with kernel 1, as JAX drops to its XLA path past
  its kernels' VMEM gate.

With ``wave_matmul`` (``matmul_wave.py``) a regular model's expand stage
runs in its transition-table form either way: ``matmul_expand`` in the
torch stages, the plan form of the kernel (``csrc/plan.cuh``) with
``wave_kernel=True``. The model is classified at spawn (``_configure``,
the reference's ``tpu/engine.py`` :290-319); an irregular one warns once
and keeps its step.

The table's rehash at rest points goes through ``table.dedup_and_insert``
either way, in chunks of at most a wave's rows with the engine's scratch.
``kernel_path()`` says which implementation ran.

**Telemetry** (``obs``; ``BfsEngine._arm_obs``, shared by the four
device engines): each retired dispatch's dispatch-log entry is the
schema's wave event (fused :585-637), recorded in the flight ring,
traced (``STpu_TRACE``) and fed to the histograms, SLOs and slow-wave
detector; growth emits ``grow`` at each doubling, checkpoints
``ckpt_begin`` / ``ckpt_done``, and a run that raises dumps the ring
(``flight_dump``). With ``STpu_PROF`` the dispatch graph's record is the
sum of its kernels' declared costs (``_dispatch_costs``), a sampled
dispatch timed by CUDA events around its launch or replay and read at
its stats read. Nothing is added inside a dispatch, and with no variable
set each switch is one attribute check.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time
import warnings
from collections import deque
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .append import append_cost, append_rows
from .checker import Checker
from .checkpoint_format import (load_checkpoint, make_header, pending_rows,
                                validate_header, write_atomic)
from .engine import (batch_bucket_ladder, compaction_order, eval_properties,
                     fingerprint_successors, host_table_insert, pick_bucket)
from .graphs import DispatchGraphs
from .hashing import SENTINEL, SENTINEL_U64, host_fp64, to_i64, to_u64
from .io.async_io import writer_from_config
from .matmul_wave import expand, wave_matmul_on
from .model import Expectation, property_predicates
from .obs import (prof_from_env, recorder_from_env, tracer_from_env,
                  wave_obs_from_env)
from .obs.prof import elapsed_s, has_record, mark, sum_costs
from .packing import compile_layout
from .path import Path
from .resilience.faults import fault_plan_from_env, is_oom
from .store.tiered import load_cold_refs, store_from_config
from .table import DedupScratch, dedup_and_insert, dedup_cost
from .visitor import as_visitor
from .wave import (SpawnProgram, sender_megakernel, spawn_program,
                   wave_cost, wave_megakernel)

__all__ = ["BfsEngine", "FusedCudaBfsChecker", "FusedUnsupported", "KERNELS",
           "insert_chunked", "CheckpointImage", "read_checkpoint",
           "snapshot_sections",
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
    "shard": "marks one partition of an elastic run "
             "(stateright_tpu/resilience/elastic.py, ROADMAP A13)",
    "elastic": "marks an elastic run's manifest "
               "(stateright_tpu/resilience/elastic.py, ROADMAP A13)"}
_I64_MIN = -(1 << 63)


def checkpoint_name(model) -> str:
    """The model name a checkpoint header records: the model's
    ``checkpoint_name`` where it sets one, else its class's name."""
    return model.checkpoint_name or type(model).__name__


class CheckpointImage(NamedTuple):
    """A checkpoint as a resume reads it (``read_checkpoint``)."""
    state_count: int
    unique_count: int
    discoveries: Dict[str, int]
    #: the pending rows, unpacked ``uint32[n, W]``
    rows: np.ndarray
    fps: np.ndarray
    ebits: np.ndarray
    #: the parent sections ``(child, parent, rooted)``
    parents: tuple
    visited: np.ndarray


def read_checkpoint(path: str, model, layout, W: int, use_symmetry: bool,
                    attach_refs=None) -> CheckpointImage:
    """Reads the checkpoint at ``path`` (engine :755-800) for a run of
    ``model`` whose rows are ``layout``'s: its header checked, its pending
    rows (a ``u32`` or ``packed`` file alike) held to the layout. Cold
    segments a v5 ``store`` section references go to ``attach_refs(refs,
    base_dir=)`` where given (a store that can evict visited rows), else
    are read into the visited set (engine :788-812), each checked by its
    CRCs and its content hash. The engines and the mux's tenants resume
    through it."""
    with load_checkpoint(path) as data:
        header = validate_header(
            data, model_name=checkpoint_name(model), state_width=W,
            use_symmetry=use_symmetry)
        for key, what in _UNPORTED.items():
            if header.get(key):
                raise NotImplementedError(
                    f"checkpoint {path!r} has a {key!r} section, which "
                    f"{what}; the port cannot resume it")
        rows = pending_rows(data, header, W)
        layout.check_fits(rows)
        fps = np.asarray(data["pending_fps"], np.uint64)
        ebits = np.asarray(data["pending_ebits"], np.uint32)
        parents = (np.asarray(data["parent_child"], np.uint64),
                   np.asarray(data["parent_parent"], np.uint64),
                   np.asarray(data["parent_rooted"], bool))
        visited = np.asarray(data["visited"], np.uint64)
    refs = header.get("store")
    if refs:
        base_dir = os.path.dirname(os.path.abspath(path))
        if attach_refs is not None:
            attach_refs(refs, base_dir=base_dir)
        else:
            cold = load_cold_refs(refs, base_dir=base_dir)
            if len(cold):
                visited = np.concatenate([visited, cold])
    return CheckpointImage(
        int(header["state_count"]), int(header["unique_count"]),
        {k: int(v) for k, v in header["discoveries"].items()}, rows, fps,
        ebits, parents, visited)


def snapshot_sections(model, layout, W: int, use_symmetry: bool,
                      state_count: int, unique_count: int, discoveries,
                      visited: np.ndarray, refs, blocks, sections) -> dict:
    """A checkpoint's sections (engine :571-627), each with the
    reference's name and dtype: the header, the visited set, the queue's
    ``blocks`` (``(rows in layout, fps, ebits)``, in order) and the
    parent ``sections`` ``(child, parent, rooted)``. The engines and the
    mux's tenants snapshot through it."""
    child, parent, rooted = sections
    wp = layout.packed_width
    header = make_header(
        model_name=checkpoint_name(model), state_width=W,
        state_count=state_count, unique_count=unique_count,
        use_symmetry=use_symmetry, discoveries=discoveries,
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


def insert_chunked(keys: torch.Tensor, table: torch.Tensor, scratch,
                   rows: int):
    """Inserts the distinct int64 keys ``keys`` (sentinels are not keys)
    into ``table`` through the dedup kernel with ``scratch``, in ``n``
    chunks of at most ``rows`` keys, ``n`` a power of two: chunk k is
    every n-th key from key k, copied contiguous (the keys padded with
    sentinels to a multiple of n). Not runs of adjacent slots of an old
    table: the keys of adjacent slots share the high bits of their hash,
    which also pick their home slots in the scratch, so a run of them
    piles into a small window of it (``chip_smoke.py``'s rehash case,
    2^26 slots into 2^27 on an H100: about 20 times slower in runs than
    in strides). Returns ``(full, n)``: a bool 0-dim tensor on the
    device, the chunks' ``full`` flags ORed (whether a key found no free
    slot), and the chunks taken (0 for no keys)."""
    n = _pow2(-(-keys.shape[0] // rows))
    pad = -keys.shape[0] % n
    if pad:
        keys = torch.cat([keys, keys.new_full((pad,), SENTINEL)])
    if not keys.numel():
        return torch.zeros((), dtype=torch.bool, device=table.device), 0
    cols = keys.view(-1, n)
    return torch.stack([
        dedup_and_insert(cols[:, k].contiguous(), table, scratch=scratch)[4]
        for k in range(n)]).any(), n


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

    #: whether the tiered store may evict visited partitions from this
    #: engine's table: only an engine with a host step a wave, which can
    #: drop a spilled fingerprint generated again before it is counted
    #: (the reference's flag, ``tpu/engine.py`` :156-163)
    _VISITED_SPILL_CAPABLE = False

    def _configure(self, builder, device: torch.device, batch_size: int,
                   table_capacity: int, wave_kernel: bool, max_batch_size,
                   checkpoint_path, checkpoint_every_waves: int,
                   async_io, wave_matmul=None, dm=None, tier=None,
                   program_cache=None, program_key=None) -> None:
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
        self._wave_kernel_on = bool(wave_kernel)
        self._wave_matmul_on = wave_matmul_on(wave_matmul)
        # What the spawn resolves before any device work, shared through
        # the program cache where one is armed: the expand stage's
        # transition-table form (the model classified, its step probed on
        # this device, as the reference does at spawn; an irregular one
        # warns once and keeps its step), the kernels' size gate and
        # their loaded libraries (a failed build raises here).
        self._prog_cache = program_cache if program_key is not None else None
        self._prog_key = (tuple(program_key) if program_key is not None
                          else None)
        self._prog_hits = self._prog_misses = 0
        prog = self._spawn_program()
        cls = prog.classification
        self._matmul_plan = None if cls is None else cls.plan
        self._matmul_reason = None if cls is None else cls.reason
        # Where the kernels hold no instance of the model (or of its plan
        # form), the waves run the torch stages with kernel 1, as JAX's
        # drop to its XLA path past its VMEM gate; nothing else moves the
        # path.
        self._wave_kernel = self._wave_kernel_on and prog.fits
        if not prog.fits:
            warnings.warn(
                f"wave_kernel=True: {type(dm).__name__}: {prog.reason}; its "
                f"waves run the torch stages with kernel 1 instead "
                f"(kernel_path {self.kernel_path()!r})", RuntimeWarning,
                stacklevel=4)
        # Cooperative preemption (a job service's DELETE): the wave loop
        # checks the event at its dispatch boundary, drains what is in
        # flight and stops at a safe point, so the end-of-run checkpoint
        # is a valid resume image.
        self._preempt_evt = threading.Event()
        self.preempted = False
        self._ebits_all = 0
        for i, p in enumerate(self._properties):
            if p.expectation is Expectation.EVENTUALLY:
                self._ebits_all |= 1 << i
        self._ckpt_path = checkpoint_path
        self._ckpt_every = max(1, int(checkpoint_every_waves))
        # One checkpoint writer an engine: inline, or its own thread.
        self._aio = writer_from_config(
            async_io, name=f"stpu-aio-{type(self).__name__}")
        # The tiered store (``store/tiered.py``), made before any
        # checkpoint load, since a v5 resume attaches its cold segments;
        # its cold writes share the checkpoints' writer (engine
        # :362-386). ``tier`` holds the ``tier_*`` keywords.
        tier = tier or {}
        self._store = store_from_config(
            device_bytes=tier.get("tier_device_bytes"),
            host_bytes=tier.get("tier_host_bytes"),
            segment_dir=tier.get("tier_dir"),
            n_partitions=tier.get("tier_partitions"),
            meta={"model_name": checkpoint_name(model), "state_width": W,
                  "use_symmetry": self._use_symmetry}, owner=self)
        self._store.attach_async(self._aio)
        #: the fault plan (``resilience/faults.py``): the live
        #: ``STpu_FAULTS`` plan or the shared ``NULL_PLAN``; every hook is
        #: behind ``.active``, one attribute check a dispatch, outside any
        #: launch (engine :492-497)
        self._faults = fault_plan_from_env()
        #: the capacity the last growth asked for (a ``degrade`` event's
        #: ``requested``)
        self._grow_requested = 0

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
        #: the dedup kernel's calls at rest points (``_insert_chunked``'s
        #: chunks: rehashes, a resumed table, a table rebuilt after a
        #: visited spill)
        self.table_chunks = 0

    def _check_support(self) -> None:
        """Raises for a configuration this engine cannot run (the
        reference's hook of the same name)."""

    #: whether the waves' front half is the sender kernel (kernel 3)
    #: rather than the wave kernel (kernel 2): the sharded engines
    _SENDER_KERNEL = False

    #: whether the wave loop polls ``preempt()``: not on the sharded
    #: engines, as in JAX
    _POLLS_PREEMPT = True

    def _spawn_program(self) -> SpawnProgram:
        """``wave.spawn_program`` for this engine, through the program cache
        when one is armed (``program_cache`` and ``program_key`` both
        given, as in JAX, ``tpu/engine.py:181-197``). The shared key is
        JAX's (``engine.py:843-852``): the model key, the engine, the
        table path, packing, symmetry, ``wave_kernel`` and the matmul
        knob, then the shape key (the row's lanes, actions and packed
        words, and the device)."""
        dm, device = self._dm, self._device

        def build():
            return spawn_program(dm, self._layout, device,
                                 self._wave_matmul_on, self._wave_kernel_on,
                                 self._SENDER_KERNEL)

        if self._prog_cache is None:
            return build()
        key = (self._prog_key, self._ENGINE_ID,
               "cuda" if device.type == "cuda" else "plain",
               self._layout.packs, self._use_symmetry, self._wave_kernel_on,
               self._wave_matmul_on, dm.state_width, dm.max_fanout,
               self._layout.packed_width, str(device))
        prog, hit = self._prog_cache.get_or_build(key, build)
        if hit:
            self._prog_hits += 1
        else:
            self._prog_misses += 1
        return prog

    def _program_cache_stats(self) -> dict:
        """``scheduler_stats()["program_cache"]`` (engine :1150-1154)."""
        return {"shared": self._prog_cache is not None,
                "hits": self._prog_hits, "misses": self._prog_misses}

    def _arm_obs(self) -> None:
        """The run telemetry (``obs``; the reference's ``tpu/engine.py``
        :473-524): the tracer (``STpu_TRACE``) with the run's settings in
        its ``run_start`` and, under a matmul plan, the ``matmul_ops``
        gauge; the flight ring (on unless ``STpu_FLIGHT=0``), whose dump
        a failed run's ``flight_dump`` names; the histograms, SLOs and
        slow-wave detector (``STpu_HIST`` / ``STpu_SLO`` /
        ``STpu_ANOMALY``); the wave profiler (``STpu_PROF``). Each is a
        shared null object when its variable is unset, and a dispatch
        then pays one attribute check for it."""
        self._tracer = tracer_from_env(self._ENGINE_ID, meta={
            "model": type(self._model).__name__, "batch_size": self._B,
            "bucket_ladder": list(self._buckets),
            "table_capacity": self._capacity,
            "table_impl": "cuda" if self._device.type == "cuda" else "plain",
            "max_fanout": self._F, "state_width": self._dm.state_width})
        if self._tracer.enabled and self._matmul_plan is not None:
            self._tracer.event("gauge", name="matmul_ops",
                               value=float(self._matmul_plan.matmul_ops))
        self._flight = recorder_from_env(f"{self._ENGINE_ID}-{os.getpid()}")
        #: the newest postmortem's path (a failed run sets it)
        self.flight_dump = None
        self._wave_obs = wave_obs_from_env(self._ENGINE_ID)
        if self._wave_obs.enabled and self._flight.armed:
            self._flight.set_hist_source(self._wave_obs.final_snapshot_event)
        self._prof = prof_from_env(self._ENGINE_ID)
        #: host seconds the loop waited on checkpoint writes since the
        #: last wave event (the v10 ``io_stall_s``)
        self._io_stall_s = 0.0
        self._ckpt_gen = 0

    def _spawn_worker(self) -> None:
        """Starts the worker thread that runs ``_run`` (the telemetry armed
        first, once)."""
        if getattr(self, "_tracer", None) is None:
            self._arm_obs()
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
            if self._flight.armed:
                # The postmortem of a run that raised (engine :1186-1193).
                self.flight_dump = self._flight.dump(
                    f"{type(e).__name__}: {e}")
        finally:
            if self._wave_obs.enabled:
                # A short run may never reach the snapshot cadence.
                self._wave_obs.close(self._tracer)
            self._tracer.close()
            self._done.set()

    def _chunks(self, n: int) -> int:
        """The chunks ``_insert_chunked`` takes for ``n`` keys: the least
        power of two of chunks of at most the scratch's rows."""
        return _pow2(-(-n // self._scratch_shape()[0]))

    def _insert_chunked(self, keys: torch.Tensor, table: torch.Tensor):
        """``insert_chunked`` with the engine's scratch, its chunks counted
        in ``table_chunks``."""
        full, chunks = insert_chunked(keys, table, self._scratch,
                                      self._scratch_shape()[0])
        self.table_chunks += chunks
        return full

    def _visited_sorted(self) -> np.ndarray:
        """The visited set, ``uint64`` sorted (engine :603-610): the
        table's keys with the sentinels dropped, sorted on the device as
        the unsigned values they stand for."""
        keys = self._table[self._table != SENTINEL]
        return _u64(torch.sort(keys ^ _I64_MIN).values ^ _I64_MIN)

    def _visited_section(self):
        """``(visited, store refs)`` of a snapshot (engine :593-612): the
        table's keys and the store's warm ones, sorted (a spilled key
        admitted to the table again is in both, as in JAX); the cold
        segments travel as the v5 refs (None without cold ones)."""
        visited = self._visited_sorted()
        if not self._store.active:
            return visited, None
        warm = self._store.warm_fps()
        if len(warm):
            visited = np.sort(np.concatenate([visited, warm]))
        return visited, self._store.checkpoint_refs()

    def _write_checkpoint(self, path: str) -> None:
        """Writes one generation at a rest point (engine :629-662): joins
        the last write first (its failure raises here), takes the
        snapshot on this thread, and hands the write to the writer; with
        the ``ckpt_begin`` and ``ckpt_done`` events, the latter from the
        thread that wrote. The time the loop spent here is its
        ``io_stall_s``."""
        t0 = time.monotonic()
        self._aio.join()
        payload = self._snapshot()
        self._ckpt_gen += 1
        gen, tracer = self._ckpt_gen, self._tracer
        if tracer.enabled:
            tracer.event("ckpt_begin", gen=gen, path=path,
                         **{"async": bool(self._aio.enabled)})

        def land() -> None:
            w0 = time.monotonic()
            write_atomic(path, payload)
            if tracer.enabled:
                tracer.event("ckpt_done", gen=gen, path=path,
                             write_s=round(time.monotonic() - w0, 6))

        self._aio.submit(land)
        self.checkpoints += 1
        self._io_stall_s += time.monotonic() - t0

    def _take_io_stall(self) -> float:
        """The loop's I/O stall since the last wave event, drained."""
        s, self._io_stall_s = self._io_stall_s, 0.0
        return round(s, 6)

    # -- The OOM degrade ---------------------------------------------------

    def _degrade_bucket(self, err: BaseException) -> bool:
        """Drops the top rung of the batch ladder after an allocation
        failure (engine :1736-1760): narrower dispatches need less table
        and arena headroom, so the growth is tried again against a smaller
        need. False at the base rung (nothing left to shed). The ladder
        alone moves: a wave's slots, scratch and graphs keep their sizes
        and keys, and a batch never passes the new top rung."""
        if len(self._buckets) <= 1:
            return False
        old = self._B_max
        self._buckets = self._buckets[:-1]
        self._B_max = self._buckets[-1]
        warnings.warn(
            f"table/arena growth hit an allocation failure "
            f"({type(err).__name__}: {str(err)[:160]}); degrading the "
            f"dispatch bucket ladder {old} -> {self._B_max} and retrying",
            RuntimeWarning)
        if self._tracer.enabled:
            # requested / kept: the capacity the failed growth asked for
            # and the one that exists.
            self._tracer.event(
                "degrade", kind="batch_bucket", old=old, new=self._B_max,
                requested=int(self._grow_requested),
                kept=int(self._capacity), _flush=True)
        return True

    def _handle_grow_failure(self, err: BaseException) -> None:
        """The OOM degrade of every growth site, called from its
        ``except`` clause (engine :1762-1775): a failure that is not an
        allocation failure (``is_oom``), or one at the base rung, raises
        again unchanged; otherwise the ladder degrades and one ``recover``
        (``kind`` ``grow_degrade``) pairs with the fault."""
        if not is_oom(err) or not self._degrade_bucket(err):
            raise err
        if self._tracer.enabled:
            self._tracer.event("recover", attempt=1, backoff_s=0.0,
                               resumed_from=None, kind="grow_degrade",
                               _flush=True)

    # -- Wave events ---------------------------------------------------------

    def _prof_key(self, key: tuple) -> str:
        """The profiler's program identity (the reference's): the engine
        id, a digest of what fixes the program beyond its shapes, and the
        graph key."""
        prefix = (type(self._dm).__name__, self._dm.state_width,
                  self._dm.max_fanout, self._layout.packed_width,
                  self._wave_kernel, self._use_symmetry,
                  self._matmul_plan is not None, self._device.type)
        digest = hashlib.blake2s(repr(prefix).encode(),
                                 digest_size=4).hexdigest()
        return f"{self._ENGINE_ID}|{digest}|{key!r}"

    def _prof_start(self, key: tuple, costs):
        """Before a launch, armed profiler only: the dispatch's program key
        (from the graph key ``key``), whether it is new, the card's peak
        memory before it, and the start mark when the dispatch is sampled,
        with ``costs`` (a callable giving its kernels' declared costs),
        for ``_prof_stop``."""
        pkey = self._prof_key(key)
        new = not has_record(pkey)
        base = (torch.cuda.max_memory_allocated(self._device)
                if new and self._device.type == "cuda" else None)
        start = (mark(self._device) if self._prof.should_sample(pkey)
                 else None)
        return pkey, start, new, base, costs

    def _prof_stop(self, token) -> dict:
        """Right after the launch: captures a new key's record (its peak
        the growth of the card's peak memory over the launch) and marks
        the end of a sampled dispatch. Returns the wave entry's riders."""
        pkey, start, new, base, costs = token
        if new:
            peak = (torch.cuda.max_memory_allocated(self._device) - base
                    if base is not None else None)
            self._prof.capture(pkey, sum_costs(costs()), peak)
        riders = {"_prof_key": pkey}
        if start is not None:
            riders["_prof_t"] = (start, mark(self._device))
        return riders

    def _stamp_cost(self, entry: dict) -> None:
        """Armed profiler only: pops a wave entry's riders, stamps its cost
        fields and emits the sampled dispatch's ``profile_snapshot``. The
        stats read before this waited for the dispatch, so its end mark
        is complete."""
        t = entry.pop("_prof_t", None)
        self._prof.wave(entry, entry.pop("_prof_key", None),
                        None if t is None else elapsed_s(*t),
                        self._tracer, self._flight)

    def _publish(self, entry: dict) -> None:
        """A logged wave entry to the flight ring, the tracer and the
        wave-obs facade (engine :1515-1566), each behind its switch."""
        if self._flight.armed:
            self._flight.record(entry)
        if self._tracer.enabled:
            self._tracer.wave(entry)
        if self._wave_obs.enabled:
            self._wave_obs.wave(entry, self._tracer, self._flight)

    def _obs_stats(self) -> dict:
        """``scheduler_stats()``'s ``slo``, ``anomalies`` and ``prof``
        (engine :1164-1169)."""
        return {"slo": self._wave_obs.slo_status(),
                "anomalies": self._wave_obs.anomalies(),
                "prof": self._prof.stats() if self._prof.enabled else None}

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
        if self._device.type == "cuda":
            # The failed run may have left launches in flight on graphs
            # and tensors the reset drops.
            torch.cuda.synchronize(self._device)
        self._aio.reset()
        # The preempt event survives a restart (a preempt that raced a
        # crash still targets the job); only the outcome flag resets.
        self.preempted = False
        self._io_stall_s = 0.0
        self._error = None
        self._discoveries = {}
        self.dispatch_log = []
        self._reset_engine_state()
        if self._store.active:
            # The warm and cold tiers come back from the file's refs, not
            # from the failed run (engine :725-731).
            self._store.reset()
        self._start(path)
        self._tracer = tracer_from_env(self._ENGINE_ID, meta={
            "model": type(self._model).__name__, "restarted_from": path})
        self._spawn_worker()
        return self

    def _load_checkpoint(self, path: str):
        """Restores the counts, discoveries and host parent map from the
        checkpoint at ``path`` (``read_checkpoint``) and returns its seed
        rows as ``_init_rows`` does: the pending rows packed in this
        engine's layout, their fingerprints and eventually bits, and the
        visited set. Cold segments a v5 ``store`` section references are
        attached to this engine's store where it can evict visited rows,
        else read into the visited set."""
        attach = (self._store.attach_refs if self._store.active
                  and self._VISITED_SPILL_CAPABLE else None)
        img = read_checkpoint(path, self._model, self._layout,
                              self._dm.state_width, self._use_symmetry,
                              attach)
        self._parents = img.parents
        self._state_count = self._base_states = img.state_count
        self._unique_count = img.unique_count
        self._discoveries = img.discoveries
        return (self._layout.pack_np(img.rows), img.fps, img.ebits,
                img.visited)

    def _table_bytes(self, capacity: int) -> int:
        """The visited table's device bytes at ``capacity`` slots (the
        sharded engines count every shard)."""
        return capacity * 8

    def _device_rows(self) -> int:
        """The table's occupancy, which lags the unique count once the
        store evicted visited partitions."""
        return self._occ

    def store_stats(self) -> dict:
        """The tiered store's settings and counters, and the device tier:
        ``scheduler_stats()["store"]`` (engine :1717-1735)."""
        stats = self._store.stats()
        if self._store.active:
            with self._lock:
                resident = int(self._device_rows())
                unique = self._unique_count
            stats["device"] = {
                "rows": resident,
                "table_bytes": self._table_bytes(self._capacity),
                "budget": self._store.device_budget}
            stats["resident_ratio"] = round(resident / max(1, unique), 4)
        return stats

    def model(self):
        return self._model

    def kernel_path(self) -> str:
        """Which successor-path implementation the waves run:
        ``megakernel`` (the single-kernel wave) or ``dedup_kernel``
        (torch stages around the dedup kernel, also with
        ``wave_kernel=True`` past the sizes the kernels hold) on the
        card, and their plain versions ``megakernel_plain`` or
        ``dedup_plain`` on the CPU; each with ``+matmul`` when the expand
        stage runs a matmul plan (the reference's suffix,
        ``tpu/engine.py`` :925-929)."""
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

    def preempt(self) -> None:
        """Requests a cooperative stop (the reference's,
        ``tpu/engine.py:1874-1884``): the wave loop drains any in-flight
        dispatch at its next boundary, writes the end-of-run checkpoint
        (when ``checkpoint_path`` is set: a safe point, so the image is a
        valid resume source), and stops with ``self.preempted`` True. The
        run is not failed: ``join()`` returns normally and a later run
        resumes from the checkpoint bit for bit. Idempotent; a no-op once
        the run finished. The sharded engines (``_POLLS_PREEMPT`` off) do
        not poll the flag, as in JAX, so there it is a no-op: a job
        service schedules onto the classic and fused engines."""
        self._preempt_evt.set()

    def _preempt_due(self) -> bool:
        """Whether the loop stops here for a ``preempt()`` (never where
        ``_POLLS_PREEMPT`` is off)."""
        if not self._POLLS_PREEMPT or not self._preempt_evt.is_set():
            return False
        self.preempted = True
        return True

    def join(self) -> "BfsEngine":
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self

    def is_done(self) -> bool:
        return self._done.is_set()


class FusedCudaBfsChecker(BfsEngine):
    """Device-arena BFS with multi-wave dispatches."""

    _ENGINE_ID = "fused"

    def __init__(self, builder, device: torch.device, batch_size: int = 1024,
                 table_capacity: int = 1 << 16, arena_capacity=None,
                 waves_per_dispatch: int = 16, wave_kernel: bool = False,
                 max_batch_size=None, inflight_dispatches: int = 1,
                 cuda_graph: bool = False, checkpoint_path=None,
                 checkpoint_every_waves: int = 64, resume_from=None,
                 async_io=None, wave_matmul=None, device_model=None,
                 program_cache=None, program_key=None, **tier):
        self._K = max(1, int(waves_per_dispatch))
        # Dispatches launched ahead of the oldest one's stats read; safe at
        # any depth, since a dispatch launched past a rest point is a no-op.
        self._depth = max(1, int(inflight_dispatches))
        self._configure(builder, device, batch_size, table_capacity,
                        wave_kernel, max_batch_size, checkpoint_path,
                        checkpoint_every_waves, async_io, wave_matmul,
                        device_model, _tier_knobs(tier), program_cache,
                        program_key)
        self._arena_capacity = arena_capacity
        self._start(resume_from)

        #: waves that expanded rows, dispatches run, table rehashes,
        #: arena doublings, arena-span rolls and checkpoints written, and
        #: candidates that reached the table probe
        self.waves = self.dispatches = self.rehashes = self.arena_grows = 0
        self.rolls = self.checkpoints = self.candidates = 0
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
        # part of the parent map starts after them. An arena-span roll
        # moves the expanded prefix's parents to host blocks
        # (``_parent_blocks``) and shifts this bound down with the rows.
        self._n_seed = n_seed
        self._parent_blocks: List[tuple] = []
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
            if self._preempt_due():
                # Preemption (fused :641-647): to the epilogue below, which
                # retires every dispatch in flight; the arena holds their
                # parents, so the end-of-run checkpoint is a resume image.
                break
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
        prof = None
        with torch.cuda.device(self._device) if on_card else contextlib.nullcontext():
            if self._prof.enabled:
                prof = self._prof_start(
                    ("dispatch", bucket, self._capacity, self._ucap, self._K),
                    lambda: self._dispatch_costs(bucket))
            if self._graphs is None:
                self._dispatch(bucket)
                captured = False
            else:
                captured = self._graphs.run(
                    bucket, lambda: self._dispatch(bucket))
            if prof is not None:
                prof = self._prof_stop(prof)
            host = self._host_stats[self._launched % self._depth]
            self._launched += 1
            host.copy_(self._stats, non_blocking=on_card)
            copied = None
            if on_card:
                copied = torch.cuda.Event()
                copied.record()
        meta = {"bucket": bucket, "inflight": inflight, "compiled": captured,
                "kernel_path": self.kernel_path(),
                "expand_impl": self._expand_impl()}
        if prof is not None:
            meta.update(prof)
        return host, copied, meta

    def _dispatch_costs(self, bucket: int) -> list:
        """The declared costs of the kernels one dispatch of ``bucket``
        rows launches, at the shape's full work: K waves of the wave kernel
        (or the dedup kernel after the torch stages) and the append."""
        S, wp = bucket * self._F, self._layout.packed_width
        if self._wave_kernel:
            front = wave_cost(self._dm, bucket, wp, self._use_symmetry,
                              self._matmul_plan)
        else:
            front = dedup_cost(S)
        return [front, append_cost(wp, S, div=self._F)] * self._K

    def _retire(self, entry) -> None:
        """Waits for one launched dispatch's stats, applies them and logs
        the dispatch's wave event (fused :546-637). The fault plan's
        ``wave_crash`` comes first (fused :551-557, sharded_fused
        :552-556): the dispatch's table and arena writes are real and its
        stats are lost, a torn frontier that only a checkpoint repairs."""
        if self._faults.active:
            self._faults.crash("wave_crash", self._tracer,
                               wave=len(self.dispatch_log))
        host, copied, meta = entry
        if copied is not None:
            copied.synchronize()
        st = host.numpy()
        prev = self._wave_prev()
        self._process(st)
        with self._lock:
            meta = self._wave_entry(st, meta, prev)
        if self._store.active:
            # The tier gauges (fused :607-615): the device tier is the
            # live arenas and the table.
            n = getattr(self, "_n", 1)
            meta.update(self._store.gauges(),
                        tier_device_rows=int(self._device_rows()),
                        tier_device_bytes=n * (
                            self._ucap * self._arena_row_bytes()
                            + self._capacity * 8))
        if self._prof.enabled:
            self._stamp_cost(meta)
        with self._lock:
            self.dispatch_log.append(meta)
        self._publish(meta)

    def _wave_prev(self) -> tuple:
        """What a wave event's deltas are taken against: the queue's head
        and the totals as last retired."""
        return (self._head, self._state_count, self.candidates,
                self._unique_count)

    def _wave_entry(self, st: np.ndarray, meta: dict, prev: tuple) -> dict:
        """A retired dispatch's wave event under the schema's keys (fused
        :585-606), from its stats ``st`` and ``prev`` (``_wave_prev``
        before they were applied). The caller holds the lock."""
        head_prev, states_prev, cand_prev, unique_prev = prev
        wp = self._layout.packed_width
        return dict(
            meta, t=time.monotonic(), states=self._state_count,
            unique=self._unique_count, waves=int(st[ST_WAVES]),
            successors=self._state_count - states_prev,
            candidates=self.candidates - cand_prev,
            novel=self._unique_count - unique_prev,
            rows=self._head - head_prev, out_rows=None,
            capacity=self._capacity,
            load_factor=round(self._occ / self._capacity, 4),
            overflow=False, bytes_per_state=4 * wp,
            arena_bytes=self._ucap * self._arena_row_bytes(),
            table_bytes=self._capacity * 8,
            io_stall_s=self._take_io_stall())

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
        rows; slot order has no meaning.

        Under the tiered store's device budget, an arena that must grow
        past it rolls instead while it has an expanded prefix
        (``_roll_span``, fused :700-750); that keeps the dispatch graphs,
        which growth drops.

        An allocation failure (the card's ``torch.OutOfMemoryError`` or
        the fault plan's ``grow_oom``) sheds the ladder's top rung instead
        of failing the run (fused :670-766, ``_handle_grow_failure``); the
        loop's next turn picks a bucket from the shorter ladder and
        decides again whether to grow. The table and the arena are
        replaced only once their new tensors exist, so a failed
        allocation leaves ``_capacity``, ``_ucap`` and the tensors as they
        were, and the next dispatch captures its graph against them."""
        try:
            self._grow_requested = (2 * self._capacity
                                    if self._table_short(bucket)
                                    else self._capacity)
            if self._faults.active:
                self._faults.crash("grow_oom", self._tracer)
            self._grow_at(bucket)
        except Exception as e:  # noqa: BLE001 — a non-OOM raises again
            self._handle_grow_failure(e)

    def _table_short(self, bucket: int) -> bool:
        """Whether a dispatch of ``bucket`` rows could pass the table's
        half load."""
        return self._occ + bucket * self._F > self._capacity // 2

    def _grow_at(self, bucket: int) -> None:
        """``_grow``'s doublings and rolls for a dispatch of ``bucket``
        rows."""
        S = bucket * self._F
        while self._occ + S > self._capacity // 2:
            if self._tracer.enabled:
                self._tracer.event("grow", kind="table", old=self._capacity,
                                   new=2 * self._capacity)
            self._drop_graphs()
            table = torch.full((2 * self._capacity,), SENTINEL,
                               dtype=torch.int64, device=self._table.device)
            if bool(self._insert_chunked(self._table, table)):
                raise RuntimeError("rehash found no free slot")
            self._table, self._capacity = table, 2 * self._capacity
            self.rehashes += 1
        while self._tail + S > self._ucap:
            if self._span_over_budget(self._head):
                self._roll_span()
                continue
            self._drop_graphs()
            ucap = 2 * self._ucap
            if self._tracer.enabled:
                self._tracer.event("grow", kind="arena", old=self._ucap,
                                   new=ucap)

            def grown(a, fill):
                out = torch.full((ucap + 1,) + a.shape[1:], fill,
                                 dtype=a.dtype, device=a.device)
                out[:self._ucap] = a[:self._ucap]
                return out

            new = (grown(self._vecs, 0), grown(self._fps, SENTINEL),
                   grown(self._par, SENTINEL), grown(self._ebits, 0))
            with self._lock:
                self._vecs, self._fps, self._par, self._ebits = new
                self._ucap = ucap
            self.arena_grows += 1

    def _drop_graphs(self) -> None:
        if self._graphs is not None:
            self._graphs.clear()

    # -- The arena-span roll (the tiered store's device valve) -------------

    def _arena_row_bytes(self) -> int:
        """Device bytes an arena row takes: its packed words, its
        fingerprint, its parent's and its eventually bits."""
        return 4 * self._vecs.shape[-1] + 8 + 8 + 4

    def _arena_device_bytes(self) -> int:
        """Device bytes of the arenas and the table after an arena
        doubling: the reference's roll test (fused :701-705, sharded
        :691-695, whose ``n`` shards each hold both)."""
        n = getattr(self, "_n", 1)
        return n * (2 * self._ucap * self._arena_row_bytes()
                    + self._capacity * 8)

    def _span_over_budget(self, head: int) -> bool:
        """Whether the arena must roll rather than double: an arena
        doubling would pass the store's device budget and ``head`` (the
        largest shard head) rows are expanded. Where it would pass the
        budget with nothing to roll, the store notes the pressure and the
        arena doubles."""
        store = self._store
        if not store.active or store.device_budget is None:
            return False
        if self._arena_device_bytes() <= store.device_budget:
            return False
        if head > 0:
            return True
        store.note_device_pressure(self._arena_device_bytes(),
                                   store.device_budget)
        return False

    def _roll_span(self) -> None:
        """Moves the expanded prefix ``[0, head)`` off the card and shifts
        the live window ``[head, tail)`` to row 0, in place (fused
        :706-743): the prefix's parent rows go to the host blocks first,
        in arena order, so the parent sections and chains stay JAX's.
        The stats are rewritten in place, so the dispatch graphs stay.
        The whole roll holds the lock, which a walk of the parent links
        takes to search the arena (``_fingerprint_chain``)."""
        with self._lock:
            shift, lo = self._head, self._n_seed
            if shift > lo:
                # Copies: on the CPU the arrays would share the arena's
                # memory, which the shift overwrites.
                self._parent_blocks.append(
                    (_u64(self._fps[lo:shift]).copy(),
                     _u64(self._par[lo:shift]).copy()))
            for a in (self._vecs, self._fps, self._par, self._ebits):
                _shift_down(a, shift, self._tail)
            self._n_seed = max(lo - shift, 0)
            self._head, self._tail = 0, self._tail - shift
            self.rolls += 1
        self._stats[ST_HEAD] = 0
        self._stats[ST_TAIL] = self._tail
        self._store.note_arena_span(shift, shift * self._arena_row_bytes())

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
        or the parent sections a run resumed from), then the rows the
        arena-span rolls moved to the host, then the arena's rows in the
        order JAX fetches them, each child's first entry kept (the
        reference's ``setdefault``)."""
        h_child, h_parent, h_rooted = self._parents
        a_child, a_parent = self._parent_rows()
        blocks = self._parent_blocks
        b_child = [c for c, _ in blocks]
        keys = torch.cat([torch.from_numpy(c.view(np.int64)).to(
            a_child.device) for c in [h_child] + b_child] + [a_child])
        child = np.concatenate([h_child] + b_child + [_u64(a_child)])
        parent = np.concatenate([h_parent] + [p for _, p in blocks]
                                + [_u64(a_parent)])
        rooted = np.concatenate([h_rooted, np.zeros(
            len(child) - len(h_rooted), bool)])
        first = _first_occurrences(keys)
        if not bool(first.all()):
            keep = first.cpu().numpy()
            child, parent, rooted = child[keep], parent[keep], rooted[keep]
        return child, parent, rooted

    def _snapshot(self) -> dict:
        """The checkpoint's sections at a rest point (engine :571-627),
        each with the reference's name and dtype."""
        sections = self._parent_sections()
        visited, refs = self._visited_section()
        return snapshot_sections(
            self._model, self._layout, self._dm.state_width,
            self._use_symmetry, self._state_count, self._unique_count,
            self._discoveries, visited, refs, self._pending_blocks(),
            sections)

    def _reset_engine_state(self) -> None:
        """Drops the device state a restart rebuilds (fused :882-893)."""
        self._drop_graphs()
        self._table = self._vecs = self._fps = self._par = None
        self._ebits = self._stats = None

    # -- Paths -------------------------------------------------------------

    def _arena_parent(self, cur: int):
        """The parent (int64 bit pattern) of arena row fingerprint
        ``cur`` among the rows whose parents the arena holds, or None.
        The caller holds the lock."""
        fps, par = self._parent_rows()
        hit = torch.nonzero(fps == cur)
        return int(par[hit[0, 0]]) if len(hit) else None

    @staticmethod
    def _moved_parent(blocks, key):
        """The parent of ``key`` in the rows the rolls moved to the host
        (``blocks``, earliest first), or None."""
        return next((p[j[0]] for c, p in blocks
                     for j in [np.flatnonzero(c == key)] if len(j)), None)

    def _fingerprint_chain(self, fp: int) -> List[int]:
        """The uint64 fingerprints from an init state to ``fp``: each
        link from the host map (its roots end the chain), else from the
        rows the rolls moved to the host, else from the arena's parent
        column, as JAX's ``_reconstruct_path`` walks its parent map. A
        walk during a run may meet a roll, which moves arena rows to the
        host blocks: where the arena misses a link and a roll came since
        the blocks were read, they are read again and the link sought
        again."""
        h_child, h_parent, h_rooted = self._parents
        with self._lock:
            blocks, rolls = list(self._parent_blocks), self.rolls
        chain = []
        cur = to_i64(fp)
        while True:
            chain.append(to_u64(cur))
            key = np.uint64(to_u64(cur))
            i = np.flatnonzero(h_child == key)
            if len(i):
                if h_rooted[i[0]]:
                    break
                cur = to_i64(int(h_parent[i[0]]))
                continue
            moved = self._moved_parent(blocks, key)
            if moved is not None:
                cur = to_i64(int(moved))
                continue
            with self._lock:
                stale = self.rolls != rolls
                if stale:
                    blocks, rolls = list(self._parent_blocks), self.rolls
                else:
                    parent = self._arena_parent(cur)
            if stale:
                chain.pop()
                continue
            if parent is None:
                break
            cur = parent
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
            "store": self.store_stats(),
            "program_cache": self._program_cache_stats(),
            "graphs": None if g is None else {
                "captures": g.captures, "replays": g.replays,
                "capture_sec": g.capture_sec},
            **self._obs_stats()}


def _shift_down(a: torch.Tensor, shift: int, end: int) -> None:
    """Moves rows ``[shift, end)`` of ``a`` to ``[0, end - shift)`` in
    place, front to back in chunks of at most ``shift`` rows, so that no
    chunk's source overlaps its destination (``copy_`` refuses an overlap)
    and no second buffer the arena's size is needed."""
    src = shift
    while shift and src < end:
        n = min(shift, end - src)
        a[src - shift:src - shift + n].copy_(a[src:src + n])
        src += n


#: the ``spawn_cuda_bfs`` keywords of the tiered store
TIER_KNOBS = ("tier_device_bytes", "tier_host_bytes", "tier_dir",
              "tier_partitions")


def _tier_knobs(knobs: dict) -> dict:
    """An engine's extra keywords, which may only be the store's."""
    bad = sorted(set(knobs) - set(TIER_KNOBS))
    if bad:
        raise TypeError(f"unexpected keyword arguments {bad}")
    return knobs
