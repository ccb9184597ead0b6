"""``DeviceModel``: the contract a model meets to run on the port's engine.

The port's copy of ``stateright_tpu/tpu/device_model.py``, batch-first:
every device function takes a whole batch of rows, because the engine
and its kernels work on batches, never on one state at a time.

- A state is encoded as ``state_width`` uint32 lanes; on the device a
  batch of them is ``int64[B, W]`` (lane values in ``[0, 2^32)``, see
  ``hashing``). The encoding must be injective.
- ``step(rows[B, W]) -> (succ[B, F, W], valid[B, F])``, with
  ``F = max_fanout``. Slot ``f`` is the f-th action in the order the
  reference model enumerates actions, so the BFS visits states in the
  reference's level order. Invalid slots may hold anything.
- ``device_properties()`` maps property names to predicates
  ``rows[B, W] -> bool[B]``.
- ``cuda_model()`` names the model's CUDA device code, which the
  single-kernel wave (``wave.py``) needs on the card; ``None`` by
  default.

Every device function must be synchronisation-free (no ``.item()``, no
boolean-mask indexing, no ``nonzero``): the engine runs several waves
per host round trip and reads nothing back in between.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["DeviceModel", "DeviceFormUnavailable", "cuda_instance"]


class DeviceFormUnavailable(NotImplementedError):
    """The model's configuration lies outside what its device encoding
    can express (the port has no host engine to fall back to)."""


def cuda_instance(name: str, key, instances, what: str) -> None:
    """Raises ``NotImplementedError`` unless ``csrc/wave_<name>.cu``
    instantiates its kernels at ``key``, one of ``instances`` (``what``
    names ``key`` in the message): a model's ``cuda_model()`` refuses a
    size before any launch."""
    if key not in instances:
        raise NotImplementedError(
            f"csrc/wave_{name}.cu has no instance at {what} (it holds "
            f"{list(instances)}): run it with wave_kernel=False on the card")


class DeviceModel:
    """The device form of a :class:`~stateright_tpu_torch.model.Model`."""

    #: number of uint32 lanes per encoded state
    state_width: int
    #: static maximum number of actions per state
    max_fanout: int
    #: lane that must stay 0 in every generated state; a nonzero value
    #: makes the engine raise (an encoding capacity was exceeded). None
    #: disables the check.
    error_lane: Optional[int] = None
    #: the sizes (the first of ``cuda_model()``'s params) at which the
    #: kernels' entry points hold the plan form of the model's step
    #: (``csrc/plan.cuh``, ``wave.cuda_plan``): none by default
    CUDA_PLAN_INSTANCES: Tuple[int, ...] = ()

    # -- Host-side codec -------------------------------------------------

    def encode(self, state) -> np.ndarray:
        """Encodes a host state as ``uint32[state_width]`` (injective)."""
        raise NotImplementedError

    def decode(self, vec: np.ndarray):
        """Decodes an encoded state back to the host representation."""
        raise NotImplementedError

    def action_names(self) -> List:
        """The label of each of the ``max_fanout`` action slots, for
        paths and reports."""
        return list(range(self.max_fanout))

    def action_label(self, vec: np.ndarray, f: int):
        """The label of action slot ``f`` taken from the state ``vec``
        (``uint32[state_width]``), for paths: ``action_names()[f]`` unless
        a model's actions depend on the state."""
        return self.action_names()[f]

    # -- Device-side (batch-first torch functions) -----------------------

    def step(self, rows: torch.Tensor):
        """``int64[B, W] -> (int64[B, F, W], bool[B, F])``."""
        raise NotImplementedError

    def device_properties(self) -> Dict[str, Callable]:
        """Predicates ``int64[B, W] -> bool[B]`` keyed by property name."""
        return {}

    def lane_bits(self):
        """Per-lane bit widths of the encoding for the packed storage
        rows (``packing``): one spec per lane, an int ``b`` or a
        ``(b, sentinel)`` pair. ``None`` means 32 bits per lane (rows are
        then stored unpacked). A value wider than its declared lane
        would be truncated, so the widths are part of the contract."""
        return None

    def boundary(self, rows: torch.Tensor) -> Optional[torch.Tensor]:
        """``int64[N, W] -> bool[N]``: which successors lie inside the
        checked space. ``None`` (the default) means all of them."""
        return None

    def representative(self, rows: torch.Tensor) -> Optional[torch.Tensor]:
        """``int64[N, W] -> int64[N, W]``: the canonical member of each
        row's symmetry class. Dedup uses its fingerprint when the
        builder enables symmetry; paths keep the original rows'
        fingerprints. ``None`` means symmetry is unsupported."""
        return None

    def cuda_model(self) -> Optional[Tuple[str, Tuple[int, ...]]]:
        """The model's step as CUDA device code, for the single-kernel
        wave (``spawn_cuda_bfs(wave_kernel=True)`` on the card):
        ``(name, params)``, where ``csrc/models/<name>.cuh`` holds the
        device step and representative, ``csrc/wave_<name>.cu`` the C
        entry point, and ``params`` the runtime ints that entry point
        takes first (a numpy array among them goes as a host int32
        pointer: a per-instance table, which the entry point copies into
        the kernel's parameters). The device code computes exactly this
        class's ``step`` (its ``boundary`` folded into the enabled bit) and
        ``representative``; a subclass that overrides one of them, or a
        hook they are built from (``wave._DEVICE_HOOKS``: an actor
        model's delivery, a register workload's client and symmetry),
        without declaring its own ``cuda_model`` has none. ``None`` (the
        default) means no device code: the wave kernel then runs only as
        its plain version, on the CPU."""
        return None
