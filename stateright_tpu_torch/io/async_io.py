"""A bounded background writer for checkpoint generations.

The port's copy of ``stateright_tpu/io/async_io.py`` (``SyncWriter``,
``AsyncWriter``, ``writer_from_config`` and the ``STpu_ASYNC_IO``
default), for the writes the port has: checkpoints and the tiered
store's cold segments (``store/tiered.py``). An engine keeps one writer,
which both share. At a rest point
it takes the snapshot itself, so the bytes are those a write on the spot
would give, and hands only the CRCs, the compression, the rotation and
the rename to the writer.

- **Joins at rest points.** ``join()`` waits for every submitted task
  and re-raises the first failure, once: a write that failed on the
  writer's thread raises at the next checkpoint's join, or at the end of
  the run, on the engine's own thread. One FIFO thread and a join
  before each submit keep the generations in order, so the keep-last-2
  rotation is that of inline writes.
- **Bounded.** ``submit`` blocks while ``slots`` tasks are outstanding.

``SyncWriter`` has the same surface and runs each task inline: the
default, unless ``async_io=True`` or the ``STpu_ASYNC_IO`` environment
variable (the reference's, read the same way) turns the writer on.

The time an engine's loop spends in a checkpoint's join, snapshot and
submit (the whole write, inline) is the next wave event's ``io_stall_s`` (schema v10; ``fused.BfsEngine.
_write_checkpoint``, ``_take_io_stall``), as in the reference's engines.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Optional

__all__ = ["ASYNC_IO_ENV", "AsyncWriter", "SyncWriter",
           "async_io_from_env", "writer_from_config"]

#: unset, "" or "0" is off, anything else on
ASYNC_IO_ENV = "STpu_ASYNC_IO"


def async_io_from_env() -> bool:
    """The environment's default for the ``async_io`` knob."""
    return os.environ.get(ASYNC_IO_ENV, "") not in ("", "0")


class SyncWriter:
    """The knob-off writer: every task runs inline on the caller's
    thread, and its failure raises there."""

    enabled = False

    def submit(self, fn: Callable[[], None]) -> None:
        fn()

    def join(self) -> None:
        """Nothing to wait for: an inline task finished or raised."""

    def reset(self) -> None:
        """Nothing pending, no failure held."""


class AsyncWriter:
    """One writer thread and a queue of ``slots`` tasks at most."""

    enabled = True

    def __init__(self, *, slots: int = 2,
                 name: str = "stpu-async-io") -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(slots)))
        self._cv = threading.Condition()
        self._outstanding = 0
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=name)
        self._thread.start()

    def submit(self, fn: Callable[[], None]) -> None:
        """Queues ``fn`` for the writer thread, blocking while the slots
        are full. A failure raises at the next ``join()``."""
        with self._cv:
            self._outstanding += 1
        self._q.put(fn)

    def join(self) -> None:
        """Waits for every submitted task, then re-raises the first
        failure the writer held (and drops it)."""
        err = self._drain()
        if err is not None:
            raise err

    def reset(self) -> None:
        """Drops a failure held, after draining (a restart supersedes
        the generation that failed)."""
        self._drain()

    def _drain(self) -> Optional[BaseException]:
        with self._cv:
            while self._outstanding:
                self._cv.wait()
            err, self._error = self._error, None
        return err

    def _loop(self) -> None:
        while True:
            fn = self._q.get()
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — raised at join
                with self._cv:
                    if self._error is None:
                        self._error = e
            finally:
                with self._cv:
                    self._outstanding -= 1
                    self._cv.notify_all()


def writer_from_config(async_io: Optional[bool] = None, *, slots: int = 2,
                       name: str = "stpu-async-io"):
    """An ``AsyncWriter`` when ``async_io`` (else the environment) says
    on, else a ``SyncWriter``."""
    on = async_io_from_env() if async_io is None else bool(async_io)
    return AsyncWriter(slots=slots, name=name) if on else SyncWriter()
