"""The program cache: what one spawn resolves, shared by the engines and
mux groups of one program key in a process.

The port's copy of ``stateright_tpu/jit_cache.py::WaveProgramCache`` and
``shared_program_cache``. JAX's cache holds compiled XLA executables.
The port has none: its dispatches are CUDA graphs, and a graph binds one
engine's buffers (its table, arena and stats), so the graphs stay per
engine. What the cache holds is what a spawn builds that binds no buffer
(``wave.SpawnProgram``): the matmul gate's classification (its step
probed on the card, seconds at spawn) and the size gate's verdict; the
kernels' libraries the first build loads stay loaded for the process.

JAX's ``enable_persistent_jit_cache`` and ``host_profile_fingerprint``
serialise XLA executables across processes. The port's counterpart is
``_build.py``'s build directory, where each kernel library is built once
and loaded by every later process; no XLA cache is ported.

Keys are JAX's: a model key that a corpus registry certifies
(``service/registry.py::ModelRegistry.program_key``) and the engine's
path knobs, then the shape key. A model with no registry key never
reaches the cache.
"""

from __future__ import annotations

import threading

__all__ = ["WaveProgramCache", "shared_program_cache"]

#: the most programs a cache keeps (JAX's default bound)
MAX_PROGRAMS = 256


class WaveProgramCache:
    """In-process cache of spawn programs, shared across engine instances:
    ``get_or_build`` runs ``build()`` at most once a key across every
    thread (a lock a key held over the build), so N concurrent same-key
    spawns pay one build and N - 1 hits. Bounded (``MAX_PROGRAMS``, the
    oldest first out): keys embed the callers' knobs. Eviction drops the
    cache's reference only; an engine keeps what it fetched."""

    def __init__(self):
        self._programs: dict = {}
        self._locks: dict = {}
        self._mu = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_build(self, key, build):
        """``(program, hit)``; ``build()`` runs at most once a key."""
        with self._mu:
            prog = self._programs.get(key)
            if prog is not None:
                self.hits += 1
                return prog, True
            lock = self._locks.setdefault(key, threading.Lock())
        with lock:
            with self._mu:
                prog = self._programs.get(key)
                if prog is not None:
                    self.hits += 1
                    return prog, True
            prog = build()
            with self._mu:
                self._programs[key] = prog
                self.misses += 1
                while len(self._programs) > MAX_PROGRAMS:
                    oldest = next(iter(self._programs))
                    del self._programs[oldest]
                    self._locks.pop(oldest, None)
                    self.evictions += 1
        return prog, False

    def stats(self) -> dict:
        with self._mu:
            return {"programs": len(self._programs),
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "hit_ratio": round(
                        self.hits / max(1, self.hits + self.misses), 4)}


_SHARED_CACHE = None
_SHARED_CACHE_MU = threading.Lock()


def shared_program_cache() -> WaveProgramCache:
    """The process-wide program cache (made at first use), which a job
    service hands to every engine and mux group it spawns."""
    global _SHARED_CACHE
    with _SHARED_CACHE_MU:
        if _SHARED_CACHE is None:
            _SHARED_CACHE = WaveProgramCache()
        return _SHARED_CACHE
