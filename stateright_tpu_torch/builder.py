"""``CheckerBuilder``: configures and spawns the port's engine.

The port's copy of ``stateright_tpu/checker/builder.py`` for the one
engine this package has: ``spawn_cuda_bfs`` runs the fused device BFS
(``fused.py``) on a CUDA device, or on the CPU when the caller asks.
"""

from __future__ import annotations

from typing import Optional

import torch

from .fused import FusedCudaBfsChecker

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

    def spawn_cuda_bfs(self, device=None, batch_size: int = 1024,
                       table_capacity: int = 1 << 16,
                       arena_capacity: Optional[int] = None,
                       waves_per_dispatch: int = 16,
                       wave_kernel: bool = False) -> FusedCudaBfsChecker:
        """Spawns the fused device BFS; call ``join()`` to wait for it.

        ``device=None`` means the current CUDA device and raises when
        there is none: the port never falls back to the CPU on its own.
        ``device="cpu"`` runs the same engine with the kernels' plain
        versions. ``wave_kernel=True`` runs each wave's successor path
        as one kernel (``wave.py``); on the card it needs a model with
        CUDA device code (``DeviceModel.cuda_model()``) and raises for
        one without."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "spawn_cuda_bfs() needs a CUDA device and none is "
                    "available; pass device='cpu' to run on the CPU")
            device = "cuda"
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return FusedCudaBfsChecker(
            self, device, batch_size=batch_size,
            table_capacity=table_capacity, arena_capacity=arena_capacity,
            waves_per_dispatch=waves_per_dispatch, wave_kernel=wave_kernel)
