"""Deterministic fault injection: the ``STpu_FAULTS`` registry.

The port's copy of ``stateright_tpu/resilience/faults.py``: the same
spec grammar, the same 14 points, and the same hit counting, so one spec
fires at the same hits in both packages. A run that dies mid-way (a
growth's allocation failure, a checkpoint torn mid-write, a damaged
exchange block) can be made to die on demand, and the recovery paths
(``supervisor.Supervisor``, the checkpoints' keep-last-2 rotation, the
engines' OOM degrade) are tested code.

Spec grammar (the ``STpu_FAULTS`` environment variable)::

    STpu_FAULTS="grow_oom@n=1,torn_ckpt@n=2,wave_crash@n=12@times=2"

Comma-separated entries, each ``point[@key=value]...``:

- ``n=N``      fire from the Nth *hit* of the point on (hits are counted
               a point, process-wide). Default 1; ``wave=N`` is an
               alias.
- ``times=K``  fire on K consecutive eligible hits (default 1; ``0`` is
               every eligible hit).
- ``p=X``      Bernoulli(X) a hit instead of the window, drawn from a
               generator seeded by ``seed=S`` and the point's name: two
               runs of one spec fire alike.

Where the hooks are in the port (``FAULT_POINTS``): ``wave_crash`` in the
four device engines (``classic.py``, ``sharded.py``, and ``fused.py``'s
``_retire`` for both fused engines), ``grow_oom`` at their growth sites,
``torn_ckpt`` and ``ckpt_crc`` in ``checkpoint_format.write_atomic``,
``a2a_short`` and ``a2a_corrupt`` in the classic sharded engine's
exchange, ``host_crash`` in the host BFS, and ``spill_fail``,
``disk_full`` and ``page_in_torn`` in ``store/tiered.py``. The registry
also holds ``child_death`` (the bench's, not ported), ``worker_crash``
(the elastic workers') and ``admit_fault`` / ``preempt_wedge`` (the
overload controller's): a spec naming them parses as in JAX, and
nothing in the port hits them yet.

Unset, every site gets the shared ``NULL_PLAN`` and pays one attribute
check (``plan.active``). Each firing emits a ``fault`` event, flushed, on
the caller's tracer or the port's ``obs.tracer.tracer_from_env``; each
recovery emits ``recover``, ``retry`` or a terminal ``abort``, the
pairing ``tools/trace_lint.py`` checks.

``is_oom`` differs from JAX's in one way: a real allocation failure on a
CUDA card is ``torch.OutOfMemoryError`` (a ``RuntimeError``, not a
``MemoryError``) reading "CUDA out of memory", which JAX's textual match
(``RESOURCE_EXHAUSTED`` / ``Out of memory``) would miss; the port matches
it by class and by the text "out of memory" in any case.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Dict, Optional

from ..obs.tracer import tracer_from_env

__all__ = [
    "FAULTS_ENV", "FAULT_POINTS", "InjectedFault", "InjectedOom",
    "ExchangeIntegrityError", "FaultPlan", "NULL_PLAN",
    "fault_plan_from_env", "reset_fault_plans", "strip_point", "is_oom",
]

#: Environment knob: a comma-separated fault spec (see the module
#: docstring). Unset means the shared ``NULL_PLAN``.
FAULTS_ENV = "STpu_FAULTS"

#: The registry, JAX's keys and texts: every injectable site. A spec
#: naming an unknown point is refused at parse time, so a typo cannot
#: disarm a chaos run.
FAULT_POINTS: Dict[str, str] = {
    "wave_crash": "engine wave loops (all four device engines): raise "
                  "while processing the Nth dispatch",
    "grow_oom": "visited-table/arena growth (all four device engines): "
                "simulated RESOURCE_EXHAUSTED at the Nth grow attempt",
    "torn_ckpt": "checkpoint writer: the Nth write dies mid-write, "
                 "leaving truncated bytes at the final path",
    "ckpt_crc": "checkpoint writer: the Nth write silently lands one "
                "corrupted section (lying disk; caught by the v3 CRCs)",
    "a2a_short": "sharded all-to-all: the Nth exchange delivers a short "
                 "shard block (tail rows missing)",
    "a2a_corrupt": "sharded all-to-all: the Nth exchange delivers a "
                   "corrupted fingerprint payload",
    "host_crash": "host BFS worker: raise in the Nth check block",
    "child_death": "bench device child: os._exit mid-run at the Nth "
                   "supervision tick (models SIGKILL/preemption)",
    "worker_crash": "elastic worker: die (hard-exit / abrupt socket "
                    "close) at the Nth coordinated round — the "
                    "coordinator's lease machinery must turn it into "
                    "worker_lost + migration, not an abort",
    "spill_fail": "tiered store: the Nth device->host visited spill "
                  "dies before any tier mutation — recovered by a "
                  "supervised checkpoint resume",
    "disk_full": "tiered store: the Nth cold write (visited segment "
                 "or frontier stash) raises at allocation (models "
                 "ENOSPC) — recovered by a supervised checkpoint "
                 "resume",
    "page_in_torn": "tiered store: the Nth cold-segment write lands "
                    "torn (truncated final path) — the store's "
                    "immediate CRC re-verify falls back to the "
                    "rotation predecessor and keeps the rows warm; "
                    "at a frontier page-in site it raises instead",
    "admit_fault": "overload controller: the Nth admission decision "
                   "raises mid-policy, BEFORE any job state mutates — "
                   "submission handling must fail that one request and "
                   "leak nothing (no half-admitted job, queue "
                   "unwedged, later submissions unaffected)",
    "preempt_wedge": "overload controller: the Nth controller-driven "
                     "park dies mid-actuation (models a wedged "
                     "checkpoint write at the drain rest point) — the "
                     "controller must survive its own crash, the "
                     "victim keeps running under its Supervisor, and "
                     "any park that does land still pairs with a "
                     "resume or terminal abort",
}


class InjectedFault(RuntimeError):
    """An injected failure (``STpu_FAULTS``), a plain ``RuntimeError``:
    recovery code treats it as the failure it stands for."""


class InjectedOom(InjectedFault, MemoryError):
    """An injected allocation failure, caught by the handlers of a real
    one."""


class ExchangeIntegrityError(RuntimeError):
    """A sharded exchange delivered a block that fails the owner-side
    integrity check (short rows, or sentinel fingerprints in the
    payload). The wave's table insertions are already applied, so the
    frontier in memory is torn: resume from the last checkpoint."""


def is_oom(err: BaseException) -> bool:
    """Whether ``err`` is an allocation failure worth degrading for: a
    ``MemoryError`` (``InjectedOom`` too), a ``torch.OutOfMemoryError``
    (the caching allocator's, a ``RuntimeError``), or an error whose text
    says ``RESOURCE_EXHAUSTED`` or "out of memory" in any case (JAX's
    textual match, which reads "Out of memory", made case-blind so that
    "CUDA out of memory" matches too)."""
    if isinstance(err, MemoryError):
        return True
    import torch

    oom = getattr(torch, "OutOfMemoryError", None)
    if oom is not None and isinstance(err, oom):
        return True
    text = f"{type(err).__name__}: {err}"
    return "RESOURCE_EXHAUSTED" in text or "out of memory" in text.lower()


class _PointState:
    __slots__ = ("n", "times", "p", "rng", "hits", "fired")

    def __init__(self, n: int, times: int, p: Optional[float],
                 seed: int, point: str):
        self.n = n
        self.times = times
        self.p = p
        # A stream a point: a spec replays alike whatever other points
        # interleave (JAX's seeding, so both packages draw the same).
        self.rng = random.Random(f"{seed}:{point}") if p is not None \
            else None
        self.hits = 0
        self.fired = 0


class FaultPlan:
    """A parsed ``STpu_FAULTS`` spec with hit counters a point.

    Plans are cached a spec string (``fault_plan_from_env``), so a
    supervisor's respawned engine continues the same countdown: a
    ``times=1`` fault fires once a process, not once an engine."""

    active = True

    def __init__(self, spec: str):
        self.spec = spec
        self._lock = threading.Lock()
        self._points: Dict[str, _PointState] = {}
        self._tracer = None
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split("@")
            point, kvs = parts[0].strip(), parts[1:]
            if point not in FAULT_POINTS:
                raise ValueError(
                    f"unknown fault point {point!r} in {FAULTS_ENV} "
                    f"(known: {sorted(FAULT_POINTS)})")
            n, times, p, seed = 1, 1, None, 0
            for kv in kvs:
                key, _, value = kv.partition("=")
                key, value = key.strip(), value.strip()
                if key in ("n", "wave"):
                    n = int(value)
                elif key == "times":
                    times = int(value)
                elif key == "p":
                    p = float(value)
                elif key == "seed":
                    seed = int(value)
                else:
                    raise ValueError(
                        f"unknown fault key {key!r} in {FAULTS_ENV} "
                        f"entry {entry!r} (known: n/wave, times, p, "
                        "seed)")
            if n < 1:
                raise ValueError(
                    f"fault point {point!r}: n must be >= 1")
            self._points[point] = _PointState(n, times, p, seed, point)

    def _decide(self, point: str) -> Optional[int]:
        """Counts one hit of ``point``; the hit's index when the plan
        fires there, else None (JAX's rule, bit for bit)."""
        st = self._points.get(point)
        if st is None:
            return None
        with self._lock:
            st.hits += 1
            if st.hits < st.n:
                return None
            if st.times and st.fired >= st.times:
                return None
            if st.p is not None and st.rng.random() >= st.p:
                return None
            if st.p is None and st.times \
                    and st.hits >= st.n + st.times:
                return None
            st.fired += 1
            return st.hits

    def _emit(self, point: str, hit: int, mode: str, tracer,
              **ctx) -> None:
        if tracer is None or not tracer.enabled:
            # A site with no engine tracer (the checkpoint writer) still
            # records its firing, on the plan's own tracer, made once
            # under the lock.
            with self._lock:
                if self._tracer is None:
                    self._tracer = tracer_from_env(
                        "faults", meta={"spec": self.spec})
            tracer = self._tracer
        if tracer.enabled:
            # Flushed: the lint pairs a fault with its recovery in file
            # order, and several producers append to one stream.
            tracer.event("fault", point=point, hit=hit, mode=mode,
                         _flush=True, **ctx)

    def crash(self, point: str, tracer=None, **ctx) -> None:
        """Raises ``InjectedFault`` (``InjectedOom`` for ``grow_oom``)
        when the plan fires at this hit; nothing otherwise."""
        hit = self._decide(point)
        if hit is None:
            return
        if point == "grow_oom":
            self._emit(point, hit, "oom", tracer, **ctx)
            raise InjectedOom(
                f"injected RESOURCE_EXHAUSTED at fault point "
                f"{point!r} (hit {hit})")
        self._emit(point, hit, "raise", tracer, **ctx)
        raise InjectedFault(
            f"injected crash at fault point {point!r} (hit {hit})")

    def fires(self, point: str, tracer=None, mode: str = "corrupt",
              **ctx) -> bool:
        """Counts a hit and says whether the caller applies the point's
        damage (the sites whose fault is bad data, not an exception)."""
        hit = self._decide(point)
        if hit is None:
            return False
        self._emit(point, hit, mode, tracer, **ctx)
        return True

    def close(self) -> None:
        with self._lock:
            tracer, self._tracer = self._tracer, None
        if tracer is not None:
            tracer.close()


class _NullPlan:
    """The disarmed plan: ``active`` is False and every probe does
    nothing. A hot loop guards with ``if plan.active:``."""

    __slots__ = ()
    active = False
    spec = ""

    def crash(self, point, tracer=None, **ctx) -> None:
        pass

    def fires(self, point, tracer=None, mode="corrupt", **ctx) -> bool:
        return False

    def close(self) -> None:
        pass


#: The shared disarmed plan (compared by identity, like ``NULL_TRACER``).
NULL_PLAN = _NullPlan()

#: spec string -> live plan, so hit counters outlive an engine.
_PLANS: Dict[str, FaultPlan] = {}
_PLANS_LOCK = threading.Lock()


def fault_plan_from_env(spec: Optional[str] = None):
    """The plan every site uses: ``STpu_FAULTS`` (or ``spec``) set means
    the process's cached plan for that spec; unset means ``NULL_PLAN``."""
    spec = os.environ.get(FAULTS_ENV, "") if spec is None else spec
    if not spec:
        return NULL_PLAN
    with _PLANS_LOCK:
        plan = _PLANS.get(spec)
        if plan is None:
            plan = _PLANS[spec] = FaultPlan(spec)
        return plan


def reset_fault_plans() -> None:
    """Drops every cached plan (fresh counters): test isolation, so two
    tests arming one spec do not share a spent countdown."""
    with _PLANS_LOCK:
        for plan in _PLANS.values():
            plan.close()
        _PLANS.clear()


def strip_point(spec: str, point: str) -> str:
    """``spec`` without its entries for ``point`` (JAX's bench uses it to
    respawn a child without the ``child_death`` that killed it)."""
    return ",".join(
        e for e in spec.split(",")
        if e.strip() and e.strip().split("@")[0].strip() != point)
