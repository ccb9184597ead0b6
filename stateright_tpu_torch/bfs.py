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

Its wave events (``STpu_TRACE``, one a worker block, engine id
``host_bfs``) are ``host.HostChecker``'s. Left out: the JAX engine's
fault plan, which belongs to the port of ``resilience`` (ROADMAP A13).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from .fingerprint import fingerprint
from .host import HostChecker
from .path import Path

__all__ = ["BfsChecker"]


class BfsChecker(HostChecker):
    """A host BFS in progress or done. Instantiate through
    ``model.checker().spawn_bfs()``."""

    _ENGINE_ID = "host_bfs"

    def __init__(self, builder):
        super().__init__(builder)
        generated: Dict[int, Optional[int]] = {}
        for s in self._init_states:
            generated.setdefault(fingerprint(s), None)
        self._generated = generated
        self._start(builder, deque((s, fingerprint(s), self._ebits)
                                   for s in self._init_states),
                    deque, _split_off_deque)

    def _check_block(self, pending: deque, max_count: int) -> None:
        """Takes up to ``max_count`` states from ``pending`` (the
        reference's ``check_block``, ``bfs.rs:165-274``)."""
        model = self._model
        generated = self._generated
        visitor = self._visitor

        actions: List = []
        generated_count = 0  # added to the shared count once a block
        popped = novel_count = 0  # the block's wave event
        try:
            while max_count > 0:
                max_count -= 1
                if not pending:
                    return
                state, state_fp, ebits = pending.pop()
                popped += 1
                if visitor is not None:
                    visitor.visit(model, self._reconstruct_path(state_fp))
                # Done once every property has a discovery.
                is_awaiting, ebits = self._evaluate(state, ebits, state_fp)
                if not is_awaiting:
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
                    novel_count += 1
                    pending.appendleft((next_state, next_fp, ebits))
                if is_terminal:
                    self._terminal(ebits, state_fp)
        finally:
            self._state_count.add(generated_count)
            if popped and (self._tracer.enabled or self._wave_obs.enabled):
                self._emit_wave(popped, generated_count, novel_count)

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

    def discoveries(self) -> Dict[str, Path]:
        return {name: self._reconstruct_path(fp)
                for name, fp in list(self._discoveries.items())}


def _split_off_deque(pending: deque, size: int) -> deque:
    """Removes and returns the ``size`` states at the back of
    ``pending`` (taken soonest), in their order: ``VecDeque::split_off``."""
    share = deque()
    for _ in range(size):
        share.appendleft(pending.pop())
    return share
