"""``CheckerBuilder``: configures and spawns the port's engines.

The port's copy of ``stateright_tpu/checker/builder.py`` for the engines
this package has: ``spawn_bfs`` runs the host BFS (``bfs.py``);
``spawn_cuda_bfs`` runs the fused device BFS (``fused.py``) by default,
the classic per-wave BFS (``classic.py``) where the fused one cannot run
the model (a visitor, or a property the host evaluates) or the caller
asks for it, or with ``sharded=True`` or a ``mesh`` the sharded fused BFS
(``sharded_fused.py``) or its classic twin (``sharded.py``), by the same
rule; on a CUDA device, or on the CPU when the caller asks; and the host
BFS, with a warning, for a configuration with no device form. The
engines are chosen by JAX's ``spawn_tpu_bfs`` rules
(``checker/builder.py`` :147-216).
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import torch

from .classic import CudaBfsChecker
from .device_model import DeviceFormUnavailable
from .fused import FusedCudaBfsChecker, FusedUnsupported
from .mesh import Mesh
from .sharded import ShardedCudaBfsChecker
from .sharded_fused import ShardedFusedCudaBfsChecker

__all__ = ["CheckerBuilder"]


class CheckerBuilder:
    """Builds a checker for a model. Instantiate through
    ``model.checker()``."""

    def __init__(self, model):
        self._model = model
        self._symmetry = False
        self._target_state_count: Optional[int] = None
        self._thread_count = 1
        self._visitor = None

    def symmetry(self) -> "CheckerBuilder":
        """Dedups by the device model's ``representative``; paths keep
        the original states."""
        self._symmetry = True
        return self

    def symmetry_fn(self, representative) -> "CheckerBuilder":
        """Symmetry with an explicit canonicaliser of host states. The
        device engines dedup by the device model's ``representative``
        either way, as JAX's do (``tpu/engine.py`` :228); the function is
        kept for the host DFS the port does not have yet (ROADMAP A17: the
        host BFS ignores symmetry, as JAX's does)."""
        self._symmetry = representative
        return self

    def threads(self, thread_count: int) -> "CheckerBuilder":
        """The host BFS's worker count (1 by default, which makes its
        discovery paths shortest); the device engines ignore it."""
        self._thread_count = thread_count
        return self

    def visitor(self, visitor) -> "CheckerBuilder":
        """A function ``f(model, path)`` or a ``CheckerVisitor`` run on
        every state the checker evaluates (the host BFS's or the classic
        engine's)."""
        self._visitor = visitor
        return self

    def spawn_bfs(self):
        """Spawns the host BFS (``bfs.BfsChecker``) on the model's host
        transitions and conditions, with ``threads()`` workers; call
        ``join()`` to wait for it. A model whose host form the port lacks
        raises ``NotImplementedError`` naming the ROADMAP item."""
        from .bfs import BfsChecker

        return BfsChecker(self)

    def target_state_count(self, count: int) -> "CheckerBuilder":
        """Stops once about ``count`` states were generated (never fewer
        if more exist)."""
        self._target_state_count = count if count > 0 else None
        return self

    def spawn_cuda_bfs(self, device=None, batch_size: Optional[int] = None,
                       table_capacity: Optional[int] = None,
                       arena_capacity: Optional[int] = None,
                       waves_per_dispatch: Optional[int] = None,
                       wave_kernel: Optional[bool] = None, sharded=None,
                       mesh=None,
                       exchange_novel_only=None,
                       max_batch_size: Optional[int] = None,
                       inflight_dispatches: Optional[int] = None,
                       cuda_graph: Optional[bool] = None,
                       checkpoint_path: Optional[str] = None,
                       checkpoint_every_waves: Optional[int] = None,
                       resume_from: Optional[str] = None,
                       async_io: Optional[bool] = None,
                       fused: Optional[bool] = None,
                       pipeline: Optional[bool] = None,
                       succ_ladder: Optional[bool] = None,
                       wave_matmul: Optional[bool] = None):
        """Spawns a device BFS; call ``join()`` to wait for it.

        ``device=None`` means the current CUDA device and raises when
        there is none: the port never falls back to the CPU on its own.
        ``device="cpu"`` runs the same engine with the kernels' plain
        versions. ``wave_kernel=True`` runs each wave's successor path
        as one kernel (``wave.py``; the sender kernel on a sharded
        engine); ``None``, the default, follows the ``STpu_WAVE_KERNEL``
        environment variable, as in JAX (unset, empty or ``"0"`` is off,
        anything else on), and an explicit value wins. On the card it
        needs a model with CUDA device code (``DeviceModel.cuda_model()``)
        and raises for one without, or for a size its entry point holds
        no instance of; ``kernel_path()`` says which path ran. Every
        model of ``models/`` and ``test_util.py`` has one, at the sizes
        its entry point holds (``CUDA_INSTANCES``): 2pc; the actor
        models on ``csrc/models/actor_net.cuh`` (every network form:
        duplicating or not, lossy or not, with timers), the register
        workloads paxos, single-copy and ABD, and ping-pong and
        viewstamped replication; LinearEquation, DGraph, increment,
        increment_lock and the sliding puzzle. ``batch_size`` defaults
        to 1,024.

        The engine, by JAX's rules: the fused engine by default; the
        classic per-wave engine (``classic.py``) when the fused one
        cannot run the model (a ``visitor``, or a property with a host
        condition and no device predicate, ``FusedUnsupported``) unless
        ``fused=True``, which then raises; ``fused=False`` or
        ``pipeline=True`` ask for the classic engine, which drops the
        fused engine's knobs (``waves_per_dispatch``, ``arena_capacity``,
        ``inflight_dispatches``). The classic engine's own knobs:
        ``pipeline`` (launch the next wave before reading the last, when
        a full widest batch is queued; default on for a CUDA device, off
        on the CPU) and ``succ_ladder`` (default on: bound the new rows a
        wave sends to the host by the output ladder, regathering a wave
        that outgrows its rung). None of these changes a result.

        The host loop's knobs, as in JAX: ``max_batch_size`` makes the
        dispatch width adaptive, the least rung of ``batch_size``'s
        doublings up to it that covers the queue (unset: always
        ``batch_size``); ``inflight_dispatches`` is how many dispatches
        run ahead of the host's stats reads (1, the default: a read after
        every dispatch; JAX's default is 2, which on the card with graphs
        measured slower, PERF.md §6). ``cuda_graph`` runs each dispatch
        (each wave, on the classic engine) as one CUDA graph, captured at
        the second dispatch of each width and table and arena size (and
        output rung) and replayed after: ``None`` (the default) means on
        for a CUDA device, ``False`` runs every dispatch op by op, and
        ``True`` on the CPU raises. None of the three changes a result.

        With ``mesh`` (a list of devices, one a shard) or ``sharded=True``
        (one shard a visible CUDA device) the sharded fused BFS runs
        instead: the fingerprint space is split over the shards by
        ``fp % n``, ``batch_size`` (default 512) is per shard, and
        ``exchange_novel_only`` (default on) drops a sender's repeated
        successors before the exchange. The shards must share one
        device, stacked: ``mesh=["cpu"] * n`` or ``["cuda:0"] * n``. The
        classic sharded engine (``sharded.py``) runs by the unsharded
        rule: where the sharded fused one cannot run the model (a
        visitor, or a property with no device predicate) unless
        ``fused=True``, which then raises, or with ``fused=False``; it
        takes ``succ_ladder`` and drops the fused knobs, and its loop is
        synchronous, so ``pipeline=True`` raises ``NotImplementedError``,
        as in JAX. It needs a device predicate for every eventually
        property.

        Checkpoints, as in JAX's ``spawn_tpu_bfs``: with
        ``checkpoint_path`` the run writes a snapshot there at a rest
        point each time ``checkpoint_every_waves * batch_size`` new states
        have arrived (every ``checkpoint_every_waves`` waves on the
        classic engine), and one at its end, keeping the last two
        generations (the older at ``checkpoint_path + ".prev"``).
        ``resume_from`` starts the run from a snapshot of any of the
        port's engines or of a JAX BFS engine; it must be of the same
        model, width and symmetry setting. ``async_io=True`` (or the
        ``STpu_ASYNC_IO`` environment variable) writes on a thread of its
        own: the same bytes, and a failure raises at the next write or at
        ``join()``. A file's sections and dtypes are the JAX package's
        (``checkpoint_format.py``), so either package resumes the
        other's.

        ``wave_matmul=True`` (``None``, the default, follows the
        ``STpu_WAVE_MATMUL`` environment variable, as in JAX) runs a
        regular model's expand stage in its transition-table form
        (``matmul_wave.py``) on every engine and path: classified at spawn
        by probing the model's own step, ``matmul_expand`` on the torch
        stages and the plan form of the kernels with ``wave_kernel=True``,
        which on the card the entry points hold for 2pc, increment and
        increment_lock at 1 to 8 RMs or threads (another regular model
        raises there). An irregular model warns once and
        keeps its step. It changes no result; ``kernel_path()`` ends in
        ``+matmul`` and ``scheduler_stats()["wave_matmul"]`` says which
        form ran and why.

        A configuration with no device form (``device_model()`` raises
        ``DeviceFormUnavailable``: paxos on other than 3 servers, a
        register workload past 4 clients, ABD where request ids collide)
        runs on the host BFS (``spawn_bfs()``), by JAX's rules: a
        ``RuntimeWarning`` names the reason and every knob passed that
        the host BFS drops, and this happens before the device is
        resolved, so it needs no card. Under ``checkpoint_path``,
        ``resume_from`` or ``fused=True``, which the host BFS cannot
        honour, it raises ``DeviceFormUnavailable`` instead. Nothing else
        falls back: no card, a kernel that fails, a size the kernels do
        not hold, ``FusedUnsupported``."""
        # The engine knobs as passed (every parameter but the engine
        # choice), for the fallback's warning.
        passed = {k: v for k, v in locals().items()
                  if k not in ("self", "sharded", "mesh", "fused")}
        if fused and pipeline:
            raise ValueError(
                "fused=True and pipeline=True are mutually exclusive: "
                "pipelining is a classic-engine knob")
        try:
            dm = self._model.device_model()
        except DeviceFormUnavailable as e:
            return self._host_fallback(e, passed, fused,
                                       mesh is not None or bool(sharded))
        # A knob left unset takes the engine's own default.
        knobs = _given(device_model=dm, table_capacity=table_capacity,
                       wave_kernel=wave_kernel_on(wave_kernel),
                       max_batch_size=max_batch_size,
                       checkpoint_path=checkpoint_path,
                       checkpoint_every_waves=checkpoint_every_waves,
                       resume_from=resume_from, async_io=async_io,
                       wave_matmul=wave_matmul)
        fused_knobs = _given(arena_capacity=arena_capacity,
                             waves_per_dispatch=waves_per_dispatch,
                             inflight_dispatches=inflight_dispatches)
        classic = fused is False or bool(pipeline)
        if mesh is not None or sharded:
            args = (device, mesh, batch_size or 512, exchange_novel_only,
                    cuda_graph)
            classic_knobs = dict(pipeline=pipeline, succ_ladder=succ_ladder)
            if not classic:
                try:
                    return self._spawn_sharded(
                        ShardedFusedCudaBfsChecker, *args, **knobs,
                        **fused_knobs)
                except FusedUnsupported:
                    if fused:
                        raise
            return self._spawn_sharded(ShardedCudaBfsChecker, *args,
                                       **knobs, **classic_knobs)
        if exchange_novel_only is not None:
            raise ValueError("exchange_novel_only is a knob of the sharded "
                             "engine: pass sharded=True or a mesh")
        if device is None:
            device = _default_device()
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        knobs.update(batch_size=batch_size or 1024,
                     cuda_graph=_graphs_on(cuda_graph, device))
        if not classic:
            try:
                return FusedCudaBfsChecker(self, device, **knobs,
                                           **fused_knobs)
            except FusedUnsupported:
                if fused:
                    raise
        return CudaBfsChecker(self, device, pipeline=pipeline,
                              succ_ladder=succ_ladder, **knobs)

    def _host_fallback(self, e: DeviceFormUnavailable, passed: dict, fused,
                       sharded: bool):
        """The host BFS for a configuration with no device form, by JAX's
        rules (``stateright_tpu/checker/builder.py`` :160-186): refused
        under the knobs it cannot honour, else a warning naming the
        dropped ones."""
        critical = [k for k in ("resume_from", "checkpoint_path")
                    if passed[k] is not None]
        if fused:
            critical.append("fused=True")
        if critical:
            raise DeviceFormUnavailable(
                f"{e}; refusing the host-BFS fallback because it cannot "
                f"honor {critical} — drop those knobs or use a "
                "device-formable configuration") from e
        dropped = sorted(k for k, v in passed.items() if v is not None)
        if sharded:
            dropped.append("mesh/sharded")
        warnings.warn(
            f"no device form for this configuration ({e}); falling back "
            "to the host BFS engine"
            + (f" (dropping engine knobs {dropped})" if dropped else ""),
            RuntimeWarning, stacklevel=3)
        return self.spawn_bfs()

    def _spawn_sharded(self, engine, device, mesh, batch_size,
                       exchange_novel_only, cuda_graph, **kwargs):
        if mesh is None:
            if device is not None:
                raise ValueError("sharded=True meshes every visible CUDA "
                                 "device; to shard on one device pass "
                                 "mesh=[device] * n")
            _default_device()
            mesh = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        mesh = Mesh(mesh)
        if device is not None and Mesh([device]).device != mesh.device:
            raise ValueError(f"device {device} is not the mesh's device "
                             f"{mesh.device}")
        return engine(
            self, mesh, batch_size=batch_size,
            exchange_novel_only=exchange_novel_only,
            cuda_graph=_graphs_on(cuda_graph, mesh.device), **kwargs)


def _given(**knobs) -> dict:
    """``knobs`` without those left ``None``."""
    return {k: v for k, v in knobs.items() if v is not None}


def wave_kernel_on(wave_kernel) -> bool:
    """``spawn_cuda_bfs``'s ``wave_kernel`` resolved: ``None`` follows the
    ``STpu_WAVE_KERNEL`` environment variable, as the reference's does
    (``stateright_tpu/tpu/engine.py:278-281``)."""
    if wave_kernel is None:
        return os.environ.get("STpu_WAVE_KERNEL", "") not in ("", "0")
    return bool(wave_kernel)


def _graphs_on(cuda_graph, device: torch.device) -> bool:
    """``spawn_cuda_bfs``'s ``cuda_graph`` resolved for ``device``."""
    if cuda_graph is None:
        return device.type == "cuda"
    if cuda_graph and device.type != "cuda":
        raise ValueError(f"cuda_graph=True needs a CUDA device, not "
                         f"{device}: CUDA graphs run only on the card")
    return bool(cuda_graph)


def _default_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "spawn_cuda_bfs() needs a CUDA device and none is "
            "available; pass device='cpu' to run on the CPU")
    return "cuda"
