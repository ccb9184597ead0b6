"""Checker visitors: a hook run on every state the checker evaluates.

The port's copy of ``stateright_tpu/checker/visitor.py`` (after the
reference's ``src/checker/visitor.rs``). A visitor receives the model and
the ``Path`` by which the checker reached the state it evaluates; the
classic engine (``classic.py``) rebuilds that path from its parent map
for every row a wave pops. A plain callable ``f(model, path)`` serves
wherever a visitor is expected. The fused engines have no per-wave host
step, so a builder with a visitor spawns the classic engine.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Set

from .path import Path

__all__ = ["CheckerVisitor", "as_visitor", "PathRecorder", "StateRecorder"]


class CheckerVisitor:
    """Visits every state evaluated by the checker."""

    def visit(self, model, path: Path) -> None:
        raise NotImplementedError


class _FnVisitor(CheckerVisitor):
    def __init__(self, fn: Callable):
        self._fn = fn

    def visit(self, model, path: Path) -> None:
        self._fn(model, path)


def as_visitor(v) -> CheckerVisitor:
    """A visitor, or a callable made into one."""
    if isinstance(v, CheckerVisitor):
        return v
    if callable(v):
        return _FnVisitor(v)
    raise TypeError(f"not a visitor: {v!r}")


class PathRecorder(CheckerVisitor):
    """Records every visited path. A path was replayed against the model
    to be built, so recording it also checks it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._paths: Set[Path] = set()

    @classmethod
    def new_with_accessor(cls):
        recorder = cls()

        def accessor() -> Set[Path]:
            with recorder._lock:
                return set(recorder._paths)

        return recorder, accessor

    def visit(self, model, path: Path) -> None:
        with self._lock:
            self._paths.add(path)


class StateRecorder(CheckerVisitor):
    """Records the last state of every visited path, in visit order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._states: List = []

    @classmethod
    def new_with_accessor(cls):
        recorder = cls()

        def accessor() -> List:
            with recorder._lock:
                return list(recorder._states)

        return recorder, accessor

    def visit(self, model, path: Path) -> None:
        with self._lock:
            self._states.append(path.last_state())
