"""What the host engines share: ``HostChecker``.

The host BFS (``bfs.py``) and DFS (``dfs.py``) both run the model's host
transitions and conditions with ``threads(n)`` workers on the
``_market.py`` pool. This layer holds what they have in common: starting
the workers, the evaluation of the properties at a state taken, and the
``Checker`` API but the discoveries.
"""

from __future__ import annotations

import threading

from ._market import JobMarket, SharedCount, run_worker_loop
from .checker import Checker
from .model import Expectation, Model, require_host_form
from .visitor import as_visitor

__all__ = ["HostChecker"]


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
        if self._market.errors:
            raise self._market.errors[0]
        return self

    def is_done(self) -> bool:
        with self._market.lock:
            idle = (not self._market.jobs
                    and self._market.wait_count == self._thread_count)
        return idle or len(self._discoveries) == len(self._properties)
