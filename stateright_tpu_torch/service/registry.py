"""``ModelRegistry``: the checking service's corpus of models by name.

The port's copy of ``stateright_tpu/service/registry.py``. A job names a
corpus entry and its parameters; the registry builds the model (its
device form attached) and gives the canonical parameter key that scopes
the program cache (``jit_cache.WaveProgramCache``): two jobs may share a
spawn's program exactly when their ``(name, canonical params)`` agree,
because the registry builds the same model from the same key every
time.

The default corpus holds JAX's nine names, defaults and docs, built on
the port's own models (``models/``); the port imports nothing of
``examples/``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

__all__ = ["CorpusEntry", "ModelRegistry", "default_registry"]


@dataclass(frozen=True)
class CorpusEntry:
    """One registered model: ``build(**params)`` returns a model ready for
    ``checker()``; ``defaults`` double as the parameter schema (unknown
    keys are refused, values coerced to the default's type)."""
    name: str
    build: Callable
    defaults: Dict[str, object]
    doc: str


class ModelRegistry:
    def __init__(self):
        self._entries: Dict[str, CorpusEntry] = {}
        self._lock = threading.Lock()

    def register(self, name: str, build: Callable,
                 defaults: Optional[Dict[str, object]] = None,
                 doc: str = "") -> None:
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
            self._entries[name] = CorpusEntry(
                name, build, dict(defaults or {}), doc)

    def names(self):
        with self._lock:
            return sorted(self._entries)

    def entry(self, name: str) -> CorpusEntry:
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise KeyError(
                f"unknown model {name!r}; registered: {self.names()}")
        return entry

    def describe(self):
        """The corpus listing: name, doc and the parameter schema with
        its defaults."""
        return [{"name": e.name, "doc": e.doc, "params": dict(e.defaults)}
                for _, e in sorted(self._entries.items())]

    def resolve_params(self, name: str,
                       params: Optional[dict]) -> Dict[str, object]:
        """The defaults merged with ``params``: unknown keys refused,
        values coerced to the default's type (a JSON submission's "3" and
        3.0 both mean the int 3)."""
        entry = self.entry(name)
        resolved = dict(entry.defaults)
        for key, value in (params or {}).items():
            if key not in resolved:
                raise ValueError(
                    f"model {name!r} has no parameter {key!r}; "
                    f"accepts {sorted(resolved)}")
            want = type(resolved[key])
            try:
                resolved[key] = (bool(value) if want is bool
                                 else want(value))
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"parameter {key!r} of model {name!r}: {e}") from e
        return resolved

    def build(self, name: str, params: Optional[dict] = None):
        """``(model, canonical params)``."""
        entry = self.entry(name)
        resolved = self.resolve_params(name, params)
        return entry.build(**resolved), resolved

    def program_key(self, name: str, params: Optional[dict] = None
                    ) -> Tuple:
        """The program cache's model key: the corpus name and the
        canonical parameter items."""
        resolved = self.resolve_params(name, params)
        return (name, tuple(sorted(resolved.items())))


# -- The default corpus --------------------------------------------------------


def _twopc(rm_count):
    from ..models.twopc import TwoPhaseSys

    return TwoPhaseSys(rm_count)


def _paxos(client_count, server_count):
    from ..models.paxos import PaxosSys

    return PaxosSys(client_count, server_count)


def _increment(thread_count):
    from ..models.increment import IncrementModel

    return IncrementModel(thread_count)


def _increment_lock(thread_count):
    from ..models.increment_lock import IncrementLockModel

    return IncrementLockModel(thread_count)


def _single_copy(client_count, server_count):
    from ..models.single_copy import SingleCopySys

    return SingleCopySys(client_count, server_count)


def _abd(client_count, server_count):
    from ..models.abd import AbdSys

    return AbdSys(client_count, server_count)


def _pingpong(max_nat, maintains_history, lossy, duplicating):
    from ..models.pingpong import PingPongSys

    return PingPongSys(max_nat, maintains_history, lossy=lossy,
                       duplicating=duplicating)


def _sliding_puzzle(rows, cols):
    from ..models.sliding_puzzle import SlidingPuzzle

    return SlidingPuzzle(rows, cols)


def _vsr(n, max_view, lossy, duplicating):
    from ..models.vsr import VsrSys

    return VsrSys(n, max_view, lossy=lossy, duplicating=duplicating)


_DEFAULT: Optional[ModelRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> ModelRegistry:
    """The process-wide default corpus (built once): JAX's nine entries
    with their defaults and docs (``stateright_tpu/service/registry.py``
    :213-246)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is not None:
            return _DEFAULT
        r = ModelRegistry()
        r.register("twopc", _twopc, {"rm_count": 3},
                   "two-phase commit (Gray & Lamport TLA+ subset)")
        r.register("paxos", _paxos,
                   {"client_count": 2, "server_count": 3},
                   "single-decree Paxos with linearizability history")
        r.register("increment", _increment, {"thread_count": 3},
                   "racy read-inc-write counter (finds the lost update)")
        r.register("increment_lock", _increment_lock,
                   {"thread_count": 3},
                   "spinlock-guarded counter (race eliminated)")
        r.register("single_copy", _single_copy,
                   {"client_count": 2, "server_count": 1},
                   "single-copy register (linearizable by construction)")
        r.register("abd", _abd, {"client_count": 2, "server_count": 2},
                   "ABD quorum register (linearizable reads/writes)")
        r.register("pingpong", _pingpong,
                   {"max_nat": 3, "maintains_history": False,
                    "lossy": False, "duplicating": True},
                   "ping-pong counter pair (actor-layer workout)")
        r.register("sliding_puzzle", _sliding_puzzle,
                   {"rows": 2, "cols": 3},
                   "sliding tile puzzle (search workload)")
        r.register("vsr", _vsr,
                   {"n": 3, "max_view": 1, "lossy": False,
                    "duplicating": True},
                   "viewstamped-replication primary/backup with view "
                   "change (round-14 corpus addition)")
        _DEFAULT = r
        return r
