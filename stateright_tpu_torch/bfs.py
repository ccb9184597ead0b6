"""The host breadth-first engine: ``BfsChecker``.

The port's copy of ``stateright_tpu/checker/bfs.py`` (after the
reference's ``src/checker/bfs.rs``), which ``spawn_bfs()`` runs, and
which ``spawn_cuda_bfs()`` falls back to for a configuration with no
device form. It runs the model's host transitions (``Model.actions`` /
``next_state``) and host conditions. The visited map ``_generated`` maps
each state's host ``fingerprint`` to its parent's, and a path is rebuilt
by replaying the model (``Path.from_fingerprints``). Pending states are
taken FIFO, so with one worker (the default) the visit order is BFS
order and every discovery path is a shortest one. Properties are
evaluated when a state is taken: an always or sometimes discovery is
recorded at once; an eventually property clears its bit on the path when
satisfied, and a bit still set at a terminal state is a counterexample,
with the reference's caveat kept for parity (a revisit counts as not
terminal, and the bits follow the first path to a state only,
``bfs.rs:239-259``). Symmetry is ignored, as in the JAX package.

Left out: the JAX engine's run tracer, fault plan and wave telemetry,
which belong to the ports of ``obs`` (ROADMAP A8) and ``resilience``
(A13).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from ._market import JobMarket, SharedCount, run_worker_loop
from .checker import Checker
from .fingerprint import fingerprint
from .model import Expectation, Model, require_host_form
from .path import Path
from .visitor import as_visitor

__all__ = ["BfsChecker"]


class BfsChecker(Checker):
    """A host BFS in progress or done. Instantiate through
    ``model.checker().spawn_bfs()``."""

    def __init__(self, builder):
        model = builder._model
        properties = model.properties()
        require_host_form(model, properties)
        self._model = model
        self._properties = properties
        self._thread_count = builder._thread_count
        self._visitor = (as_visitor(builder._visitor)
                         if builder._visitor else None)

        init_states = [s for s in model.init_states()
                       if model.within_boundary(s)]
        self._state_count = SharedCount(len(init_states))
        generated: Dict[int, Optional[int]] = {}
        for s in init_states:
            generated.setdefault(fingerprint(s), None)
        self._generated = generated
        ebits = frozenset(i for i, p in enumerate(properties)
                          if p.expectation is Expectation.EVENTUALLY)
        pending = deque((s, fingerprint(s), ebits) for s in init_states)
        self._discoveries: Dict[str, int] = {}

        self._market = JobMarket(self._thread_count, pending)
        self._handles = []
        for _ in range(self._thread_count):
            t = threading.Thread(
                target=run_worker_loop,
                args=(self._market, self._thread_count, self._check_block,
                      self._discoveries, len(properties),
                      builder._target_state_count, self._state_count),
                kwargs=dict(empty_job=deque, job_len=len,
                            split_off=_split_off_deque),
                daemon=True)
            t.start()
            self._handles.append(t)

    def _check_block(self, pending: deque, max_count: int) -> None:
        """Takes up to ``max_count`` states from ``pending`` (the
        reference's ``check_block``, ``bfs.rs:165-274``)."""
        model = self._model
        properties = self._properties
        generated = self._generated
        discoveries = self._discoveries
        visitor = self._visitor

        actions: List = []
        generated_count = 0  # added to the shared count once a block
        try:
            while max_count > 0:
                max_count -= 1
                if not pending:
                    return
                state, state_fp, ebits = pending.pop()
                if visitor is not None:
                    visitor.visit(model, self._reconstruct_path(state_fp))

                # Done once every property has a discovery.
                is_awaiting_discoveries = False
                for i, prop in enumerate(properties):
                    if prop.name in discoveries:
                        continue
                    if prop.expectation is Expectation.ALWAYS:
                        if not prop.condition(model, state):
                            discoveries[prop.name] = state_fp
                        else:
                            is_awaiting_discoveries = True
                    elif prop.expectation is Expectation.SOMETIMES:
                        if prop.condition(model, state):
                            discoveries[prop.name] = state_fp
                        else:
                            is_awaiting_discoveries = True
                    else:  # EVENTUALLY: found only at terminal states
                        is_awaiting_discoveries = True
                        if prop.condition(model, state):
                            ebits = ebits - {i}
                if not is_awaiting_discoveries:
                    return

                is_terminal = True
                actions.clear()
                model.actions(state, actions)
                for action in actions:
                    next_state = model.next_state(state, action)
                    if next_state is None:
                        continue
                    if not model.within_boundary(next_state):
                        continue
                    generated_count += 1
                    # A revisit is not terminal, though it may close a
                    # cycle; ebits are not part of the identity
                    # (bfs.rs:239-259, kept for parity).
                    next_fp = fingerprint(next_state)
                    is_terminal = False
                    if next_fp in generated:
                        continue
                    generated[next_fp] = state_fp
                    pending.appendleft((next_state, next_fp, ebits))
                if is_terminal:
                    for i, prop in enumerate(properties):
                        if i in ebits:
                            discoveries[prop.name] = state_fp
        finally:
            self._state_count.add(generated_count)

    def _reconstruct_path(self, fp: int) -> Path:
        """Walks the parent links back to an init state, then replays the
        model along the fingerprints (``bfs.rs:314-342``)."""
        fingerprints: deque = deque()
        next_fp = fp
        while next_fp in self._generated:
            source = self._generated[next_fp]
            fingerprints.appendleft(next_fp)
            if source is None:
                break
            next_fp = source
        return Path.from_fingerprints(self._model, fingerprints)

    # -- Checker API -----------------------------------------------------

    def model(self) -> Model:
        return self._model

    def state_count(self) -> int:
        return self._state_count.value

    def unique_state_count(self) -> int:
        return len(self._generated)

    def discoveries(self) -> Dict[str, Path]:
        return {name: self._reconstruct_path(fp)
                for name, fp in list(self._discoveries.items())}

    def join(self) -> "BfsChecker":
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


def _split_off_deque(pending: deque, size: int) -> deque:
    """Removes and returns the ``size`` states at the back of
    ``pending`` (taken soonest), in their order: ``VecDeque::split_off``."""
    share = deque()
    for _ in range(size):
        share.appendleft(pending.pop())
    return share
