"""The shared counter fixed with a lock: host types, model, device form.

The port's copy of ``examples/increment_lock.py`` (``LockState``,
``IncrementLockModel``) and ``stateright_tpu/tpu/models/increment_lock.py``
(the device encoding), after the reference's ``examples/increment_lock.rs``:
the racy counter of ``increment.py`` with its read and write inside a
lock, so ``always "fin"`` and ``always "mutex"`` hold.

State lanes (``W = 2 + 2T``, each a uint32 value): ``[0]`` the shared
counter, ``[1]`` the lock held, then per thread k ``[2 + 2k]`` its read
value and ``[3 + 2k]`` its pc (0 wants the lock, 1 about to read, 2
about to write, 3 holds the lock after the write, 4 done). One action a
thread, in thread order, chosen by its pc.

The representative sorts the threads by their whole ``(t, pc)`` pair, as
``increment.py``'s does. Its CUDA device code (``cuda_model()``) is
``csrc/models/increment_lock.cuh``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device_model import DeviceModel, cuda_instance
from ..model import Model, Property
from .increment import sort_threads

__all__ = ["LockState", "IncrementLockModel", "IncrementLockDevice"]

_KINDS = ("lock", "read", "write", "release")


@dataclass(frozen=True)
class LockState:
    i: int                          # shared counter
    lock: bool
    s: Tuple[Tuple[int, int], ...]  # per-thread (t, pc)


class IncrementLockModel(Model):
    """``increment_lock.rs:48-107``. Actions: ``("lock" | "read" |
    "write" | "release", tid)``."""

    #: its host transitions are not ported yet: it runs on the device
    #: engines only
    host_form_item = "A16"

    def __init__(self, thread_count: int):
        self.thread_count = thread_count

    def init_states(self):
        return [LockState(0, False, ((0, 0),) * self.thread_count)]

    def properties(self):
        return [
            Property.always("fin", lambda _, state: sum(
                1 for t, pc in state.s if pc >= 3) == state.i),
            Property.always("mutex", lambda _, state: sum(
                1 for t, pc in state.s if 1 <= pc < 4) <= 1),
        ]

    def device_model(self) -> "IncrementLockDevice":
        return IncrementLockDevice(self.thread_count)


class IncrementLockDevice(DeviceModel):

    #: the thread counts that ``csrc/wave_increment_lock.cu`` holds
    #: (instances at capacities of 2, 4, 8 and 16 threads, the count at
    #: run time)
    CUDA_INSTANCES = tuple(range(1, 17))
    #: the thread counts whose plan form (``wave.cuda_plan``) it holds
    CUDA_PLAN_INSTANCES = tuple(range(1, 9))

    def __init__(self, thread_count: int):
        self.thread_count = thread_count
        self.state_width = 2 + 2 * thread_count
        self.max_fanout = thread_count

    def lane_bits(self):
        """Counter and read values bounded by the thread count (one write
        a thread, serialised by the lock), a 1-bit lock, a 3-bit pc."""
        t_bits = max(2, self.thread_count.bit_length())
        return [t_bits, 1] + [t_bits, 3] * self.thread_count

    def cuda_model(self):
        """``csrc/models/increment_lock.cuh`` at this thread count. Raises
        for a count it holds no instance of (past 16 threads)."""
        T = self.thread_count
        cuda_instance("increment_lock", T, self.CUDA_INSTANCES,
                      f"{T} threads")
        return "increment_lock", (self.thread_count,)

    def action_label(self, vec, f: int):
        return (_KINDS[min(int(vec[3 + 2 * f]), 3)], f)

    # -- Codec -----------------------------------------------------------

    def encode(self, state) -> np.ndarray:
        vec = np.zeros(self.state_width, np.uint32)
        vec[0] = state.i
        vec[1] = 1 if state.lock else 0
        for k, (t, pc) in enumerate(state.s):
            vec[2 + 2 * k] = t
            vec[3 + 2 * k] = pc
        return vec

    def decode(self, vec: np.ndarray) -> LockState:
        return LockState(
            int(vec[0]), bool(vec[1]),
            tuple((int(vec[2 + 2 * k]), int(vec[3 + 2 * k]))
                  for k in range(self.thread_count)))

    # -- Device transition (increment_lock.rs:60-96) ---------------------

    def step(self, rows: torch.Tensor):
        T = self.thread_count
        n = rows.shape[0]
        k = torch.arange(T, device=rows.device)
        i, lock = rows[:, :1], rows[:, 1:2]
        t, pc = rows[:, 2 + 2 * k], rows[:, 3 + 2 * k]
        take, read, write = pc == 0, pc == 1, pc == 2
        release = ~(take | read | write)
        succ = rows[:, None, :].expand(n, T, self.state_width).clone()
        # take: lock = 1, pc = 1; read: t = i, pc = 2; write: i = t + 1
        # (uint32), pc = 3; anything else: release, lock = 0, pc = 4.
        succ[:, :, 0] = torch.where(write, (t + 1) & 0xFFFFFFFF, i)
        succ[:, :, 1] = torch.where(take, 1, torch.where(release, 0, lock))
        succ[:, k, 2 + 2 * k] = torch.where(read, i, t)
        succ[:, k, 3 + 2 * k] = torch.where(
            take, 1, torch.where(read, 2, torch.where(write, 3, 4)))
        valid = ((take & (lock == 0)) | read | write
                 | ((pc == 3) & (lock == 1)))
        return succ, valid

    # -- Properties (increment_lock.rs:98-104) ---------------------------

    def device_properties(self):
        T = self.thread_count

        def fin(rows):
            done = (rows[:, 3:3 + 2 * T:2] >= 3).sum(dim=1)
            return done == rows[:, 0]

        def mutex(rows):
            pc = rows[:, 3:3 + 2 * T:2]
            return ((pc >= 1) & (pc < 4)).sum(dim=1) <= 1

        return {"fin": fin, "mutex": mutex}

    # -- Symmetry --------------------------------------------------------

    def representative(self, rows: torch.Tensor) -> torch.Tensor:
        return sort_threads(rows, 2, 8)
