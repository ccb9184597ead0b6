"""What the host engines share: ``HostChecker``.

The host BFS (``bfs.py``) and DFS (``dfs.py``) both run the model's host
transitions and conditions with ``threads(n)`` workers on the
``_market.py`` pool. This layer holds what they have in common: starting
the workers, the evaluation of the properties at a state taken, the
``Checker`` API but the discoveries, and the run telemetry (``obs``; the
reference's ``checker/base.py::_emit_wave``): with ``STpu_TRACE`` or any
of ``STpu_HIST`` / ``STpu_SLO`` / ``STpu_ANOMALY`` set, one wave event a
worker block, whose ``capacity`` / ``load_factor`` / ``table_bytes`` are
the visited store's (a CPython dict or set: its slot capacity under the
growth policy, and its measured bytes).
"""

from __future__ import annotations

import sys
import threading
import time

from ._market import JobMarket, SharedCount, run_worker_loop
from .checker import Checker
from .model import Expectation, Model, require_host_form
from .obs import tracer_from_env, wave_obs_from_env
from .visitor import as_visitor

__all__ = ["HostChecker", "host_store_capacity"]


def host_store_capacity(rows: int) -> int:
    """The host visited store's slot capacity at ``rows`` entries, from
    CPython's dict growth policy (power-of-two slots, growth at 2/3
    load, 8 at least): the host engines' ``capacity`` wave gauge."""
    cap = 8
    while 3 * max(0, int(rows)) >= 2 * cap:
        cap *= 2
    return cap


class HostChecker(Checker):
    """A host engine in progress or done: the model's host transitions
    and conditions, ``threads()`` workers on a ``JobMarket``. A subclass
    gives the visited set ``_generated``, the pending job and its
    ``check_block``, and rebuilds its discovery paths."""

    def __init__(self, builder):
        model = builder._model
        self._properties = model.properties()
        require_host_form(model, self._properties)
        self._model = model
        self._thread_count = builder._thread_count
        self._visitor = (as_visitor(builder._visitor)
                         if builder._visitor else None)
        self._init_states = [s for s in model.init_states()
                             if model.within_boundary(s)]
        self._state_count = SharedCount(len(self._init_states))
        #: the eventually properties' bits, each cleared on a path once
        #: the property holds there
        self._ebits = frozenset(
            i for i, p in enumerate(self._properties)
            if p.expectation is Expectation.EVENTUALLY)
        self._discoveries: dict = {}
        self._tracer = tracer_from_env(self._ENGINE_ID, meta={
            "model": type(model).__name__, "threads": self._thread_count})
        self._wave_obs = wave_obs_from_env(self._ENGINE_ID)
        #: serialises a wave event's counter reads and its write
        self._emit_lock = threading.Lock()

    def _emit_wave(self, bucket: int, successors: int, novel: int) -> None:
        """One wave event for a worker block of ``bucket`` states taken,
        ``successors`` generated and ``novel`` new (the reference's
        ``Checker._emit_wave``). Called only with the tracer or the
        wave-obs facade on. The counters are read and the event written
        under one lock, so that with several workers the cumulative
        counts a stream holds never go backwards."""
        with self._emit_lock:
            unique = self.unique_state_count()
            capacity = host_store_capacity(unique)
            table_bytes = sys.getsizeof(self._generated)
            entry = {
                "t": time.monotonic(), "states": self.state_count(),
                "unique": unique, "bucket": bucket,
                "waves": 1, "inflight": 0, "compiled": False,
                "successors": successors, "candidates": successors,
                "novel": novel, "out_rows": novel,
                "capacity": capacity,
                "load_factor": round(unique / capacity, 4),
                "overflow": False,
                "bytes_per_state": None, "arena_bytes": None,
                "table_bytes": table_bytes,
                # The host store is the host tier.
                "tier_host_rows": unique,
                "tier_host_bytes": table_bytes}
            if self._tracer.enabled:
                self._tracer.wave(entry)
            if self._wave_obs.enabled:
                self._wave_obs.wave(entry, self._tracer)

    def _start(self, builder, pending, empty_job, split_off) -> None:
        """Starts the workers on the job ``pending``."""
        self._market = JobMarket(self._thread_count, pending)
        self._handles = []
        for _ in range(self._thread_count):
            t = threading.Thread(
                target=run_worker_loop,
                args=(self._market, self._thread_count, self._check_block,
                      self._discoveries, len(self._properties),
                      builder._target_state_count, self._state_count),
                kwargs=dict(empty_job=empty_job, job_len=len,
                            split_off=split_off),
                daemon=True)
            t.start()
            self._handles.append(t)

    def _evaluate(self, state, ebits, found):
        """Evaluates every property without a discovery at ``state``: an
        always or sometimes discovery records ``found`` (the state's
        path) at once, and an eventually property that holds clears its
        bit. Returns whether any property still awaits a discovery, and
        the bits."""
        model, discoveries = self._model, self._discoveries
        is_awaiting_discoveries = False
        for i, prop in enumerate(self._properties):
            if prop.name in discoveries:
                continue
            if prop.expectation is Expectation.ALWAYS:
                if not prop.condition(model, state):
                    discoveries[prop.name] = found
                else:
                    is_awaiting_discoveries = True
            elif prop.expectation is Expectation.SOMETIMES:
                if prop.condition(model, state):
                    discoveries[prop.name] = found
                else:
                    is_awaiting_discoveries = True
            else:  # EVENTUALLY: found only at terminal states
                is_awaiting_discoveries = True
                if prop.condition(model, state):
                    ebits = ebits - {i}
        return is_awaiting_discoveries, ebits

    def _terminal(self, ebits, found) -> None:
        """At a terminal state, each eventually bit still set is a
        counterexample, ``found``."""
        for i, prop in enumerate(self._properties):
            if i in ebits:
                self._discoveries[prop.name] = found

    def model(self) -> Model:
        return self._model

    def state_count(self) -> int:
        return self._state_count.value

    def unique_state_count(self) -> int:
        return len(self._generated)

    def join(self) -> "HostChecker":
        for h in self._handles:
            h.join()
        self._handles = []
        if self._wave_obs.enabled:
            self._wave_obs.close(self._tracer)
        self._tracer.close()
        if self._market.errors:
            raise self._market.errors[0]
        return self

    def is_done(self) -> bool:
        with self._market.lock:
            idle = (not self._market.jobs
                    and self._market.wait_count == self._thread_count)
        return idle or len(self._discoveries) == len(self._properties)
