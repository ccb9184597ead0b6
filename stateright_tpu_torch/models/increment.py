"""The racy shared counter: the host types, the model, and its device form.

The port's copy of ``examples/increment.py`` (``IncrementState``,
``IncrementModel``) and ``stateright_tpu/tpu/models/increment.py`` (the
device encoding), after the reference's ``examples/increment.rs``: each
thread reads the shared counter into a local, then writes local + 1
back; ``always "fin"`` (as many writes done as the counter says) is
violated when writes interleave. 13 unique states at 2 threads, 8 with
symmetry.

State lanes (``W = 1 + 2T``, each a uint32 value): ``[0]`` the shared
counter ``i``; per thread k, ``[1 + 2k]`` its read value ``t`` and
``[2 + 2k]`` its program counter (1 about to read, 2 about to write, 3
done). One action a thread, in thread order: read when pc == 1, write
when pc == 2.

The representative sorts the threads by their whole ``(t, pc)`` pair, an
exact canonical form. Its CUDA device code (``cuda_model()``) is
``csrc/models/increment.cuh``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device_model import DeviceModel, cuda_instance
from ..model import Model, Property

__all__ = ["IncrementState", "IncrementModel", "IncrementDevice",
           "sort_threads"]

_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class IncrementState:
    i: int                          # shared counter
    s: Tuple[Tuple[int, int], ...]  # per-thread (t, pc)


class IncrementModel(Model):
    """``increment.rs:155-197``. Actions: ``("read", tid)`` and
    ``("write", tid)``."""

    #: its host transitions are not ported yet: it runs on the device
    #: engines only
    host_form_item = "A16"

    def __init__(self, thread_count: int):
        self.thread_count = thread_count

    def init_states(self):
        return [IncrementState(0, ((0, 1),) * self.thread_count)]

    def properties(self):
        return [Property.always("fin", lambda _, state: sum(
            1 for t, pc in state.s if pc == 3) == state.i)]

    def device_model(self) -> "IncrementDevice":
        return IncrementDevice(self.thread_count)


def sort_threads(rows: torch.Tensor, first: int, pc_span: int):
    """``rows`` with the threads' ``(t, pc)`` pairs, from lane ``first``
    on, in the stable order of the key ``t * pc_span + pc`` taken as a
    uint32 (JAX's ``argsort`` on its uint32 lanes; the key wraps as
    theirs does)."""
    n, w = rows.shape
    pairs = rows[:, first:].reshape(n, -1, 2)
    key = (pairs[..., 0] * pc_span + pairs[..., 1]) & _U32
    order = torch.argsort(key, dim=1, stable=True)
    pairs = torch.gather(pairs, 1, order[..., None].expand_as(pairs))
    return torch.cat([rows[:, :first], pairs.reshape(n, -1)], dim=1)


class IncrementDevice(DeviceModel):

    #: the thread counts that ``csrc/wave_increment.cu`` holds (instances
    #: at capacities of 2, 4, 8 and 16 threads, the count at run time)
    CUDA_INSTANCES = tuple(range(1, 17))
    #: the thread counts whose plan form (``wave.cuda_plan``) it holds
    CUDA_PLAN_INSTANCES = tuple(range(1, 9))

    def __init__(self, thread_count: int):
        self.thread_count = thread_count
        self.state_width = 1 + 2 * thread_count
        self.max_fanout = thread_count

    def lane_bits(self):
        """The counter and every read value are bounded by the thread
        count (each thread writes once); the pc is 1 to 3."""
        t_bits = max(2, self.thread_count.bit_length())
        return [t_bits] + [t_bits, 2] * self.thread_count

    def cuda_model(self):
        """``csrc/models/increment.cuh`` at this thread count. Raises for
        a count it holds no instance of (past 16 threads)."""
        T = self.thread_count
        cuda_instance("increment", T, self.CUDA_INSTANCES, f"{T} threads")
        return "increment", (self.thread_count,)

    def action_label(self, vec, f: int):
        return ("read" if int(vec[2 + 2 * f]) == 1 else "write", f)

    # -- Codec -----------------------------------------------------------

    def encode(self, state) -> np.ndarray:
        vec = np.zeros(self.state_width, np.uint32)
        vec[0] = state.i
        for k, (t, pc) in enumerate(state.s):
            vec[1 + 2 * k] = t
            vec[2 + 2 * k] = pc
        return vec

    def decode(self, vec: np.ndarray) -> IncrementState:
        return IncrementState(
            int(vec[0]),
            tuple((int(vec[1 + 2 * k]), int(vec[2 + 2 * k]))
                  for k in range(self.thread_count)))

    # -- Device transition (increment.rs:163-185) ------------------------

    def step(self, rows: torch.Tensor):
        T = self.thread_count
        n = rows.shape[0]
        k = torch.arange(T, device=rows.device)
        t, pc = rows[:, 1 + 2 * k], rows[:, 2 + 2 * k]
        succ = rows[:, None, :].expand(n, T, self.state_width).clone()
        read = pc == 1
        # Read: t = i, pc = 2. Write: i = t + 1 (uint32), pc = 3.
        succ[:, k, 1 + 2 * k] = torch.where(read, rows[:, :1], t)
        succ[:, k, 2 + 2 * k] = torch.where(read, 2, 3)
        succ[:, :, 0] = torch.where(read, rows[:, :1], (t + 1) & _U32)
        return succ, read | (pc == 2)

    # -- Properties ------------------------------------------------------

    def device_properties(self):
        T = self.thread_count

        def fin(rows):
            done = (rows[:, 2:2 + 2 * T:2] == 3).sum(dim=1)
            return done == rows[:, 0]

        return {"fin": fin}

    # -- Symmetry (exact: threads are exchangeable (t, pc) pairs) --------

    def representative(self, rows: torch.Tensor) -> torch.Tensor:
        return sort_threads(rows, 1, 4)
