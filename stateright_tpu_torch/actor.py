"""The host side of actor systems, as far as the port's engine uses it.

The port's copy of the host types of ``stateright_tpu/actor/`` and
``stateright_tpu/semantics/`` that an actor model's device form needs for
its init states, its ``encode``/``decode`` and the action labels of a
``Path``: actor ids, envelopes and the network set, the register messages
and the client and server state wrappers, the actor-model state, and the
linearizability tester's history as a plain record. The port checks on the
device, so nothing here runs an actor's handler or searches a history;
the reprs equal the JAX package's, so a decoded state reads the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, List, Optional

__all__ = ["Id", "Envelope", "Network", "ActorModelState", "DeliverAction",
           "DropAction", "TimeoutAction", "Internal", "Put", "Get", "PutOk", "GetOk",
           "RegisterClientState", "RegisterServerState", "NO_VALUE",
           "Register", "Read", "ReadOk", "Write", "WriteOk",
           "LinearizabilityTester"]

#: the register's value before any write
NO_VALUE = "\x00"


class Id(int):
    """An actor's index in its system."""

    __slots__ = ()

    def __repr__(self) -> str:
        return f"Id({int(self)})"


@dataclass(frozen=True)
class Envelope:
    """A message in flight from ``src`` to ``dst``."""

    src: Id
    dst: Id
    msg: Any

    def __repr__(self) -> str:
        return (f"Envelope {{ src: {self.src!r}, dst: {self.dst!r}, "
                f"msg: {self.msg!r} }}")


class Network:
    """The set of envelopes in flight; equal sets are equal networks."""

    __slots__ = ("_envs",)

    def __init__(self, envelopes: Optional[Iterable[Envelope]] = None):
        self._envs = dict.fromkeys(envelopes or ())

    def __iter__(self):
        return iter(self._envs)

    def __eq__(self, other) -> bool:
        return isinstance(other, Network) and self._envs == other._envs

    def __repr__(self) -> str:
        return "{" + ", ".join(repr(e) for e in self._envs) + "}"


class ActorModelState:
    """A snapshot of an actor system: each actor's state, the network,
    the timer flags and the recorded history."""

    __slots__ = ("actor_states", "network", "is_timer_set", "history")

    def __init__(self, actor_states: List, network: Network,
                 is_timer_set: List[bool], history: Any):
        self.actor_states = actor_states
        self.network = network
        self.is_timer_set = is_timer_set
        self.history = history

    def __eq__(self, other) -> bool:
        return (isinstance(other, ActorModelState)
                and self.actor_states == other.actor_states
                and self.history == other.history
                and self.is_timer_set == other.is_timer_set
                and self.network == other.network)

    def __repr__(self) -> str:
        return (f"ActorModelState {{ actor_states: {self.actor_states!r}, "
                f"network: {self.network!r}, "
                f"is_timer_set: {self.is_timer_set!r}, "
                f"history: {self.history!r} }}")


@dataclass(frozen=True)
class DeliverAction:
    """The delivery of one envelope: an actor model's action."""

    src: Id
    dst: Id
    msg: Any

    def __repr__(self) -> str:
        return (f"Deliver {{ src: {self.src!r}, dst: {self.dst!r}, "
                f"msg: {self.msg!r} }}")


@dataclass(frozen=True)
class DropAction:
    """The loss of one envelope, on a lossy network: an actor model's
    action."""

    envelope: Envelope

    def __repr__(self) -> str:
        return f"Drop({self.envelope!r})"


@dataclass(frozen=True)
class TimeoutAction:
    """The timeout of an actor's armed timer: an actor model's action."""

    id: Id

    def __repr__(self) -> str:
        return f"Timeout({self.id!r})"


# -- Register messages and actor states ----------------------------------


@dataclass(frozen=True)
class Internal:
    """A message of the register system's own protocol."""

    msg: Any

    def __repr__(self):
        return f"Internal({self.msg!r})"


@dataclass(frozen=True)
class Put:
    request_id: int
    value: Any

    def __repr__(self):
        return f"Put({self.request_id}, {self.value!r})"


@dataclass(frozen=True)
class Get:
    request_id: int

    def __repr__(self):
        return f"Get({self.request_id})"


@dataclass(frozen=True)
class PutOk:
    request_id: int

    def __repr__(self):
        return f"PutOk({self.request_id})"


@dataclass(frozen=True)
class GetOk:
    request_id: int
    value: Any

    def __repr__(self):
        return f"GetOk({self.request_id}, {self.value!r})"


@dataclass(frozen=True)
class RegisterClientState:
    """A scripted client: the request it awaits (None when done) and the
    operations it has issued."""

    awaiting: Any
    op_count: int

    def __repr__(self):
        return (f"Client {{ awaiting: {self.awaiting!r}, "
                f"op_count: {self.op_count} }}")


@dataclass(frozen=True)
class RegisterServerState:
    """A server's own state, wrapped."""

    state: Any

    def __repr__(self):
        return f"Server({self.state!r})"


# -- The register's history ----------------------------------------------


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


@dataclass(frozen=True)
class Register:
    """A read/write register's initial value."""

    value: Any

    def __repr__(self):
        return f"Register({self.value!r})"


class LinearizabilityTester:
    """A register history as the linearizability tester records it: per
    thread, the completed ``(happened-before edges, op, ret)`` entries
    and the in-flight ``(edges, op)``. The device checks it; this record
    only carries it through ``decode``."""

    __slots__ = ("init_ref_obj", "history_by_thread", "in_flight_by_thread",
                 "is_valid_history")

    def __init__(self, init_ref_obj: Register):
        self.init_ref_obj = init_ref_obj
        self.history_by_thread: dict = {}
        self.in_flight_by_thread: dict = {}
        self.is_valid_history = True

    def on_invoke(self, thread_id, op) -> "LinearizabilityTester":
        """Records ``op`` in flight on ``thread_id``, with an edge from
        the last completed op of every other thread."""
        if thread_id in self.in_flight_by_thread:
            raise ValueError(f"thread {thread_id!r} already has an op in "
                             "flight")
        edges = tuple(sorted((tid, len(h) - 1)
                             for tid, h in self.history_by_thread.items()
                             if tid != thread_id and h))
        self.in_flight_by_thread[thread_id] = (edges, op)
        self.history_by_thread.setdefault(thread_id, ())
        return self

    def __eq__(self, other) -> bool:
        return (type(other) is type(self)
                and self.init_ref_obj == other.init_ref_obj
                and self.history_by_thread == other.history_by_thread
                and self.in_flight_by_thread == other.in_flight_by_thread
                and self.is_valid_history == other.is_valid_history)

    def __repr__(self):
        return (f"{type(self).__name__}(init={self.init_ref_obj!r}, "
                f"history={self.history_by_thread!r}, "
                f"in_flight={self.in_flight_by_thread!r}, "
                f"valid={self.is_valid_history})")
