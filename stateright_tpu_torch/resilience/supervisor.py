"""Supervised crash recovery: the bounded-retry run loop.

The port's copy of ``stateright_tpu/resilience/supervisor.py``. A
``Supervisor`` wraps an engine factory with bounded retry and jittered
exponential backoff, each attempt resuming from the newest checkpoint
generation that passes its CRCs (``checkpoint_format.verify_file``): a
torn or corrupt current file falls back to its ``.prev``
(``checkpoint_format`` keeps the last two).

Recovery, in order of preference:

1. **In place** (``restart_from``, ``fused.BfsEngine.restart_from``): the
   failed device engine reloads the checkpoint into the same instance,
   so the kernels' libraries stay loaded, the scratch stays, and the
   resumed table is built by kernel 1's chunks; it also clears the
   engine's failed-run flag, so a later ``checkpoint()`` works.
2. **Respawn**: an engine with no in-place restart (the host BFS), or a
   checker that died while it was made, is made again by the factory with
   ``resume_from`` at the newest valid generation (None: from scratch,
   the host engine's only way, still exact for a full enumeration). The
   failed engine is collected first (``gc.collect()``): its error's
   traceback holds it in a cycle, and its tensors would otherwise still
   hold the card's memory when the new one allocates (a respawn after a
   real ``torch.OutOfMemoryError`` then failed at spawn).

A retry does not move the run to the CPU or to the host engines: a kernel
that fails to build or to launch raises through every retry and ends in
``abort``, as JAX's does.

Every retry emits a ``retry`` event (the ``self.recoveries`` record),
and exhaustion a terminal ``abort`` carrying the failed engine's flight
dump and its tiered store's high-water marks; both flushed, since the
lint pairs each ``fault`` with them in file order.
"""

from __future__ import annotations

import gc
import os
import random
import time
from typing import Callable, List, Optional

from ..obs.tracer import tracer_from_env

__all__ = ["Supervisor", "supervise", "newest_valid_checkpoint"]


def newest_valid_checkpoint(path: Optional[str]) -> Optional[str]:
    """The newest generation at ``path`` that passes the integrity check
    (a readable npz, its header, every section's CRC32): ``path``, else
    ``path + PREV_SUFFIX``, else None (resume from scratch). JAX's
    ``supervisor.py:48-68``."""
    from ..checkpoint_format import PREV_SUFFIX, verify_file

    if not path:
        return None
    for candidate in (path, path + PREV_SUFFIX):
        if not os.path.exists(candidate):
            continue
        try:
            verify_file(candidate)
            return candidate
        except ValueError:
            continue
    return None


class Supervisor:
    """Runs ``factory(resume_from=...)`` to its end, retrying a failure
    from the newest valid checkpoint (JAX's ``supervisor.py:71-244``).

    ``factory`` returns a checker whose ``join()`` raises on failure
    (every engine of the port). ``checkpoint_path`` is the path the
    factory hands the engine; without it a retry starts from scratch.
    ``self.recoveries`` holds one dict a retry (attempt, backoff, jitter,
    the file resumed from, the flight dump, the error): the ``retry``
    event's fields.

    Each delay is ``backoff_s * backoff_factor ** (attempt - 1)`` capped
    at ``max_backoff_s``, plus ``U(0, jitter_frac)`` of it drawn from
    ``rng`` (seeded from the OS by default, so workers resuming from one
    event spread out); ``rng`` and ``sleep`` are injectable for tests. A
    checker that stopped preempted returns from ``join()`` normally and
    is not retried: read ``checker.preempted``. ``trace_path`` is where
    the supervisor's own events go (default ``STpu_TRACE``)."""

    def __init__(self, factory: Callable, *,
                 checkpoint_path: Optional[str] = None,
                 max_retries: int = 3, backoff_s: float = 0.05,
                 backoff_factor: float = 2.0, max_backoff_s: float = 5.0,
                 jitter_frac: float = 0.25,
                 rng: Optional[random.Random] = None,
                 trace_path: Optional[str] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self._factory = factory
        self._ckpt = checkpoint_path
        self._max_retries = max(0, int(max_retries))
        self._backoff = float(backoff_s)
        self._factor = float(backoff_factor)
        self._max_backoff = float(max_backoff_s)
        self._jitter_frac = max(0.0, float(jitter_frac))
        # Entropy-seeded: workers of one fleet often share a pid.
        self._rng = rng if rng is not None else random.Random(
            os.urandom(16))
        self._trace_path = trace_path
        self._sleep = sleep
        self.recoveries: List[dict] = []

    def run(self):
        """Runs to the end; returns the joined checker of the attempt that
        succeeded. After ``max_retries`` recoveries the last error raises,
        with a terminal ``abort`` event.

        The first attempt also resumes from the newest valid generation
        when one exists at ``checkpoint_path``: a killed process leaves
        only its checkpoints, and a fresh supervisor continues from them.
        Start from a fresh path to begin anew."""
        tracer = tracer_from_env("supervisor", path=self._trace_path,
                                 meta={
                                     "checkpoint_path": self._ckpt,
                                     "max_retries": self._max_retries})
        checker = None
        resume: Optional[str] = newest_valid_checkpoint(self._ckpt)
        attempt = 0
        try:
            while True:
                try:
                    if (checker is not None and resume is not None
                            and hasattr(checker, "restart_from")):
                        # In place: the loaded kernels and the scratch
                        # stay; the failed-run flag clears.
                        checker.restart_from(resume)
                    else:
                        checker = None  # a half-made checker is dead
                        # A failed engine holds its error, whose traceback
                        # holds the engine: collect it, so its card memory
                        # is free before the next one allocates its own.
                        gc.collect()
                        checker = self._factory(resume_from=resume)
                    checker.join()
                    return checker
                except Exception as e:  # noqa: BLE001 — the handler of
                    # last resort for an engine's failure
                    # The failed engine's flight ring dumped at its
                    # failure; the record names the postmortem.
                    dump = getattr(checker, "flight_dump", None)
                    if attempt >= self._max_retries:
                        if tracer.enabled:
                            tracer.event(
                                "abort", attempts=attempt, _flush=True,
                                dump=dump,
                                tiers=self._store_high_water(checker),
                                reason=f"{type(e).__name__}: {e}"[:300])
                        raise
                    attempt += 1
                    base = min(
                        self._backoff * self._factor ** (attempt - 1),
                        self._max_backoff)
                    jitter = base * self._jitter_frac * self._rng.random()
                    self._sleep(base + jitter)
                    resume = newest_valid_checkpoint(self._ckpt)
                    record = {
                        "attempt": attempt,
                        "backoff_s": round(base, 4),
                        "jitter_s": round(jitter, 4),
                        "resumed_from": resume,
                        "dump": dump,
                        "error": f"{type(e).__name__}: {e}"[:300]}
                    self.recoveries.append(record)
                    if tracer.enabled:
                        tracer.event("retry", _flush=True, **record)
        finally:
            tracer.close()

    @staticmethod
    def _store_high_water(checker):
        """The failed engine's tiered-store high-water marks
        (``store_stats()``), or None without a store, or where the call
        itself fails: a dying engine must not mask its own abort."""
        fn = getattr(checker, "store_stats", None)
        if not callable(fn):
            return None
        try:
            stats = fn()
        except Exception:  # noqa: BLE001 — diagnostics must not raise
            return None
        if not stats.get("enabled"):
            return None
        return {
            "device_table_bytes": stats.get("device", {}).get(
                "table_bytes"),
            "device_budget": stats.get("device_budget"),
            "host_high_water_bytes": stats.get("host", {}).get(
                "high_water_bytes"),
            "host_budget": stats.get("host_budget"),
            "disk_high_water_bytes": stats.get("disk", {}).get(
                "high_water_bytes"),
            "spill_bytes": stats.get("spill_bytes"),
            "resident_ratio": stats.get("resident_ratio"),
        }


def supervise(factory: Callable, **kwargs):
    """``Supervisor(factory, **kwargs).run()``."""
    return Supervisor(factory, **kwargs).run()
