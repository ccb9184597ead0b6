"""Consistency semantics: sequential reference objects and history testers.

The port's copy of what the host models need from
``stateright_tpu/semantics/`` (``base.py``, ``linearizability.py`` and
``register.py``), after the reference's ``src/semantics/``. A concurrent
system is correct against a *sequential reference object*
(``SequentialSpec``); a ``ConsistencyTester`` records an operation
history, per thread, and decides whether it can be serialized. A tester
rides inside a model's state as the actor model's history, so it
compares, hashes and fingerprints by value, with the JAX package's class
names, fields and fingerprint encoding.

The device form of the register workloads checks linearizability on the
device (``register_workload.py``); the host BFS runs this search
(``serialized_history``), as the JAX package does where its C++ verdict
is not built.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from .fingerprint import fingerprint

__all__ = ["SequentialSpec", "ConsistencyTester", "RecordingTester",
           "LinearizabilityTester", "Register", "Read", "ReadOk", "Write",
           "WriteOk"]


class SequentialSpec:
    """A sequential reference object ("this system should behave like a
    register"). ``invoke`` applies an operation and returns its return
    value."""

    def invoke(self, op) -> Any:
        raise NotImplementedError

    def is_valid_step(self, op, ret) -> bool:
        """Whether invoking ``op`` may return ``ret``."""
        return self.invoke(op) == ret

    def clone(self) -> "SequentialSpec":
        raise NotImplementedError


class ConsistencyTester:
    """Records invocations and returns per thread and tests the history.
    ``on_invoke`` / ``on_return`` raise ``ValueError`` on an invalid
    history (a second op in flight, a return with no invocation); an
    inconsistent one only makes ``is_consistent`` false."""

    def on_invoke(self, thread_id, op) -> "ConsistencyTester":
        raise NotImplementedError

    def on_return(self, thread_id, ret) -> "ConsistencyTester":
        raise NotImplementedError

    def is_consistent(self) -> bool:
        raise NotImplementedError


class RecordingTester(ConsistencyTester):
    """The recording half of a tester: per-thread histories and in-flight
    ops, cloning, and value identity. A subclass says what an in-flight
    entry holds (``_invoke_entry``), what it completes to
    (``_complete_entry``) and how the history serializes."""

    __slots__ = ("init_ref_obj", "history_by_thread",
                 "in_flight_by_thread", "is_valid_history", "_fp")

    def __init__(self, init_ref_obj: SequentialSpec):
        self.init_ref_obj = init_ref_obj
        self.history_by_thread: dict = {}
        self.in_flight_by_thread: dict = {}
        self.is_valid_history = True
        self._fp = None

    def _invoke_entry(self, thread_id, op):
        raise NotImplementedError

    def _complete_entry(self, in_flight_entry, ret):
        raise NotImplementedError

    def _in_flight_op(self, in_flight_entry):
        raise NotImplementedError

    def serialized_history(self):
        raise NotImplementedError

    def on_invoke(self, thread_id, op):
        if not self.is_valid_history:
            raise ValueError("Earlier history was invalid.")
        if thread_id in self.in_flight_by_thread:
            self.is_valid_history = False
            self._fp = None
            raise ValueError(
                f"Thread already has an operation in flight. "
                f"thread_id={thread_id!r}, "
                f"op={self._in_flight_op(self.in_flight_by_thread[thread_id])!r}, "
                f"history_by_thread={self.history_by_thread!r}")
        self.in_flight_by_thread[thread_id] = self._invoke_entry(
            thread_id, op)
        self.history_by_thread.setdefault(thread_id, ())
        self._fp = None
        return self

    def on_return(self, thread_id, ret):
        if not self.is_valid_history:
            raise ValueError("Earlier history was invalid.")
        if thread_id not in self.in_flight_by_thread:
            self.is_valid_history = False
            self._fp = None
            raise ValueError(
                f"There is no in-flight invocation for this thread ID. "
                f"thread_id={thread_id!r}, unexpected_return={ret!r}, "
                f"history={self.history_by_thread.get(thread_id, ())!r}")
        entry = self.in_flight_by_thread.pop(thread_id)
        self.history_by_thread[thread_id] = (
            self.history_by_thread.get(thread_id, ())
            + (self._complete_entry(entry, ret),))
        self._fp = None
        return self

    #: verdicts by (tester class, history fingerprint): many states of an
    #: actor model share a history, and the search is exponential
    _verdict_memo: dict = {}

    def is_consistent(self) -> bool:
        key = (type(self), hash(self))
        memo = RecordingTester._verdict_memo
        verdict = memo.get(key)
        if verdict is None:
            verdict = self.serialized_history() is not None
            if len(memo) >= 1 << 22:  # bounds the memo's footprint
                memo.clear()
            memo[key] = verdict
        return verdict

    def clone(self):
        t = type(self).__new__(type(self))
        t.init_ref_obj = self.init_ref_obj
        t.history_by_thread = dict(self.history_by_thread)
        t.in_flight_by_thread = dict(self.in_flight_by_thread)
        t.is_valid_history = self.is_valid_history
        t._fp = None
        return t

    def __eq__(self, other):
        return (type(other) is type(self)
                and self.init_ref_obj == other.init_ref_obj
                and self.history_by_thread == other.history_by_thread
                and self.in_flight_by_thread == other.in_flight_by_thread
                and self.is_valid_history == other.is_valid_history)

    def __hash__(self):
        if self._fp is None:
            self._fp = fingerprint(self)
        return self._fp

    def __fingerprint__(self):
        return (type(self).__name__, self.init_ref_obj,
                self.history_by_thread, self.in_flight_by_thread,
                self.is_valid_history)

    def __repr__(self):
        return (f"{type(self).__name__}(init={self.init_ref_obj!r}, "
                f"history={self.history_by_thread!r}, "
                f"in_flight={self.in_flight_by_thread!r}, "
                f"valid={self.is_valid_history})")


class LinearizabilityTester(RecordingTester):
    """Linearizability: sequential consistency plus real-time order. A
    history entry is ``(cs, op, ret)`` and an in-flight one ``(cs, op)``,
    where ``cs`` holds a ``(peer thread, index of its last completed op)``
    happened-before edge for each other thread with a completed op when
    ``op`` started; the search never serializes ``op`` before such a
    peer op."""

    __slots__ = ()

    def _invoke_entry(self, thread_id, op):
        cs = tuple(sorted(
            (tid, len(h) - 1)
            for tid, h in self.history_by_thread.items()
            if tid != thread_id and h))
        return (cs, op)

    def _complete_entry(self, entry, ret):
        cs, op = entry
        return (cs, op, ret)

    def _in_flight_op(self, entry):
        return entry[1]

    def serialized_history(self) -> Optional[list]:
        """A total order of the ops, as ``(op, ret)`` pairs, that respects
        each thread's order and the real-time edges and that the reference
        object accepts (an in-flight op may take effect or not), or
        ``None`` when there is none."""
        if not self.is_valid_history:
            return None
        remaining = {
            t: tuple(enumerate(self.history_by_thread[t]))
            for t in sorted(self.history_by_thread)}
        return _serialize([], self.init_ref_obj, remaining,
                          dict(self.in_flight_by_thread))


def _violates_realtime(cs, remaining) -> bool:
    """Whether a peer still has an unserialized op at or before the
    recorded happened-before index."""
    for peer_id, min_peer_time in cs:
        ops = remaining.get(peer_id)
        if ops and ops[0][0] <= min_peer_time:
            return True
    return False


def _serialize(valid_history, ref_obj, remaining, in_flight):
    if all(not h for h in remaining.values()):
        return valid_history
    for thread_id in remaining:
        history = remaining[thread_id]
        if not history:
            # Only this thread's in-flight op, if it has one.
            if thread_id not in in_flight:
                continue
            cs, op = in_flight[thread_id]
            if _violates_realtime(cs, remaining):
                continue
            next_ref = ref_obj.clone()
            ret = next_ref.invoke(op)
            next_in_flight = dict(in_flight)
            del next_in_flight[thread_id]
            result = _serialize(valid_history + [(op, ret)], next_ref,
                                remaining, next_in_flight)
            if result is not None:
                return result
        else:
            # The thread's next completed op.
            _, (cs, op, ret) = history[0]
            next_remaining = dict(remaining)
            next_remaining[thread_id] = history[1:]
            if _violates_realtime(cs, next_remaining):
                continue
            next_ref = ref_obj.clone()
            if not next_ref.is_valid_step(op, ret):
                continue
            result = _serialize(valid_history + [(op, ret)], next_ref,
                                next_remaining, in_flight)
            if result is not None:
                return result
    return None


# -- The register -----------------------------------------------------------


@dataclass(frozen=True)
class Write:
    value: Any

    def __repr__(self):
        return f"Write({self.value!r})"


@dataclass(frozen=True)
class Read:
    def __repr__(self):
        return "Read"


@dataclass(frozen=True)
class WriteOk:
    def __repr__(self):
        return "WriteOk"


@dataclass(frozen=True)
class ReadOk:
    value: Any

    def __repr__(self):
        return f"ReadOk({self.value!r})"


class Register(SequentialSpec):
    """A read/write register holding ``value``."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value

    def invoke(self, op):
        if type(op) is Write:
            self.value = op.value
            return WriteOk()
        return ReadOk(self.value)

    def is_valid_step(self, op, ret) -> bool:
        if type(op) is Write and type(ret) is WriteOk:
            self.value = op.value
            return True
        if type(op) is Read and type(ret) is ReadOk:
            return self.value == ret.value
        return False

    def clone(self) -> "Register":
        return Register(self.value)

    def __eq__(self, other):
        return isinstance(other, Register) and self.value == other.value

    def __hash__(self):
        return hash(("Register", self.value))

    def __fingerprint__(self):
        return ("Register", self.value)

    def __repr__(self):
        return f"Register({self.value!r})"
