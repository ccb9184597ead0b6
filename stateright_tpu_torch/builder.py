"""``CheckerBuilder``: configures and spawns the port's engines.

The port's copy of ``stateright_tpu/checker/builder.py`` for the engines
this package has: ``spawn_cuda_bfs`` runs the fused device BFS
(``fused.py``), or with ``sharded=True`` or a ``mesh`` the sharded fused
BFS (``sharded_fused.py``), on a CUDA device, or on the CPU when the
caller asks.
"""

from __future__ import annotations

from typing import Optional

import torch

from .fused import FusedCudaBfsChecker
from .mesh import Mesh
from .sharded_fused import ShardedFusedCudaBfsChecker

__all__ = ["CheckerBuilder"]


class CheckerBuilder:
    """Builds a checker for a model. Instantiate through
    ``model.checker()``."""

    def __init__(self, model):
        self._model = model
        self._symmetry = False
        self._target_state_count: Optional[int] = None

    def symmetry(self) -> "CheckerBuilder":
        """Dedups by the device model's ``representative``; paths keep
        the original states."""
        self._symmetry = True
        return self

    def target_state_count(self, count: int) -> "CheckerBuilder":
        """Stops once about ``count`` states were generated (never fewer
        if more exist)."""
        self._target_state_count = count if count > 0 else None
        return self

    def spawn_cuda_bfs(self, device=None, batch_size: Optional[int] = None,
                       table_capacity: int = 1 << 16,
                       arena_capacity: Optional[int] = None,
                       waves_per_dispatch: int = 16,
                       wave_kernel: bool = False, sharded=None, mesh=None,
                       exchange_novel_only=None) -> FusedCudaBfsChecker:
        """Spawns the fused device BFS; call ``join()`` to wait for it.

        ``device=None`` means the current CUDA device and raises when
        there is none: the port never falls back to the CPU on its own.
        ``device="cpu"`` runs the same engine with the kernels' plain
        versions. ``wave_kernel=True`` runs each wave's successor path
        as one kernel (``wave.py``); on the card it needs a model with
        CUDA device code (``DeviceModel.cuda_model()``) and raises for
        one without. ``batch_size`` defaults to 1,024.

        With ``mesh`` (a list of devices, one a shard) or ``sharded=True``
        (one shard a visible CUDA device) the sharded fused BFS runs
        instead: the fingerprint space is split over the shards by
        ``fp % n``, ``batch_size`` (default 512) is per shard, and
        ``exchange_novel_only`` (default on) drops a sender's repeated
        successors before the exchange. The shards must share one
        device, stacked: ``mesh=["cpu"] * n`` or ``["cuda:0"] * n``."""
        if mesh is not None or sharded:
            return self._spawn_sharded(
                device, mesh, batch_size or 512, exchange_novel_only,
                table_capacity=table_capacity, arena_capacity=arena_capacity,
                waves_per_dispatch=waves_per_dispatch,
                wave_kernel=wave_kernel)
        if exchange_novel_only is not None:
            raise ValueError("exchange_novel_only is a knob of the sharded "
                             "engine: pass sharded=True or a mesh")
        if device is None:
            device = _default_device()
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return FusedCudaBfsChecker(
            self, device, batch_size=batch_size or 1024,
            table_capacity=table_capacity, arena_capacity=arena_capacity,
            waves_per_dispatch=waves_per_dispatch, wave_kernel=wave_kernel)

    def _spawn_sharded(self, device, mesh, batch_size, exchange_novel_only,
                       **kwargs) -> ShardedFusedCudaBfsChecker:
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
        return ShardedFusedCudaBfsChecker(
            self, mesh, batch_size=batch_size,
            exchange_novel_only=exchange_novel_only, **kwargs)


def _default_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "spawn_cuda_bfs() needs a CUDA device and none is "
            "available; pass device='cpu' to run on the CPU")
    return "cuda"
