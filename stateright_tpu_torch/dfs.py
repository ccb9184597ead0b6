"""The host depth-first engine: ``DfsChecker``.

The port's copy of ``stateright_tpu/checker/dfs.py`` (after the
reference's ``src/checker/dfs.rs``), which ``spawn_dfs()`` runs on the
model's host transitions (``Model.actions`` / ``next_state``) and host
conditions. Beside the host BFS (``bfs.py``) it differs in three ways:
the visited set holds bare fingerprints (no parent links); each pending
entry carries its whole fingerprint trace, so a discovery keeps its full
path; and pending states are taken LIFO. Properties are evaluated when a
state is taken, as in the BFS, and an eventually bit still set at a
terminal state is a counterexample.

Symmetry lives here (``dfs.rs:258-267``): with ``symmetry()`` or
``symmetry_fn(f)`` the visited set holds the fingerprint of each
successor's representative, while the path goes on with the original
state's fingerprint. Jumping to the canonical member could leave the
collected path with no valid extension (the regression at
``dfs.rs:399-425``).

Its wave events (``STpu_TRACE``, one a worker block, engine id
``host_dfs``) are ``host.HostChecker``'s.
"""

from __future__ import annotations

from typing import Dict, List

from .fingerprint import fingerprint
from .host import HostChecker
from .path import Path

__all__ = ["DfsChecker"]


class DfsChecker(HostChecker):
    """A host DFS in progress or done. Instantiate through
    ``model.checker().spawn_dfs()``."""

    _ENGINE_ID = "host_dfs"

    def __init__(self, builder):
        super().__init__(builder)
        symmetry = builder._symmetry
        self._symmetry = symmetry
        self._generated = {
            fingerprint(s if symmetry is None else symmetry(s))
            for s in self._init_states}
        self._start(builder, [(s, [fingerprint(s)], self._ebits)
                              for s in self._init_states],
                    list, _split_off_list)

    def _check_block(self, pending: list, max_count: int) -> None:
        """Takes up to ``max_count`` states from the top of ``pending``
        (the reference's ``check_block``, ``dfs.rs:172-301``). A trace is
        never changed once made, so a discovery keeps it as it is."""
        model = self._model
        generated = self._generated
        visitor = self._visitor
        symmetry = self._symmetry

        actions: List = []
        generated_count = 0  # added to the shared count once a block
        popped = novel_count = 0  # the block's wave event
        try:
            while max_count > 0:
                max_count -= 1
                if not pending:
                    return
                state, fingerprints, ebits = pending.pop()
                popped += 1
                if visitor is not None:
                    visitor.visit(
                        model, Path.from_fingerprints(model, fingerprints))
                # Done once every property has a discovery.
                is_awaiting, ebits = self._evaluate(state, ebits,
                                                    fingerprints)
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
                    # A revisit is not terminal (as in the BFS).
                    is_terminal = False
                    # Dedup by the representative; the path goes on with
                    # the state's own fingerprint, taken only when new.
                    seen_fp = fingerprint(next_state if symmetry is None
                                          else symmetry(next_state))
                    if seen_fp in generated:
                        continue
                    generated.add(seen_fp)
                    novel_count += 1
                    next_fp = (seen_fp if symmetry is None
                               else fingerprint(next_state))
                    pending.append(
                        (next_state, fingerprints + [next_fp], ebits))
                if is_terminal:
                    self._terminal(ebits, fingerprints)
        finally:
            self._state_count.add(generated_count)
            if popped and (self._tracer.enabled or self._wave_obs.enabled):
                self._emit_wave(popped, generated_count, novel_count)

    def discoveries(self) -> Dict[str, Path]:
        return {name: Path.from_fingerprints(self._model, fps)
                for name, fps in list(self._discoveries.items())}


def _split_off_list(pending: list, size: int) -> list:
    """Removes and returns the top ``size`` entries of the stack (taken
    soonest), in their order."""
    share = pending[-size:]
    del pending[-size:]
    return share
