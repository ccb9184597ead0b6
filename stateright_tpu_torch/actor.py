"""Actor systems on the host: actors, the network, and ``ActorModel``.

The port's copy of ``stateright_tpu/actor/core.py``, ``model_state.py``
and ``model.py`` (after the reference's ``src/actor.rs`` and
``src/actor/model.rs``), with the register messages of
``stateright_tpu/actor/register.py``. An actor is a state machine that
handles messages and timeouts; ``ActorModel`` makes a list of actors and
a network into a ``Model`` whose actions are the delivery of an envelope
in flight, its loss on a lossy network, and the timeout of an armed
timer, so the host BFS (``bfs.py``) explores every interleaving. A
history rides along in the state, updated by the ``record_msg_in`` /
``record_msg_out`` hooks: the consistency testers plug in there
(``semantics.py``, ``register_workload.py``).

The states are what the device forms encode and decode
(``actor_device.py``, ``register_workload.py``): ``ActorModelState``
with a ``Network`` of ``Envelope``s. Their reprs, equality and host
fingerprints equal the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from pprint import pformat
from typing import Any, Callable, Iterable, List, Optional, Tuple

from .fingerprint import fingerprint
from .model import Model, Property
from .semantics import (LinearizabilityTester, Read, ReadOk, Register, Write,
                        WriteOk)

__all__ = ["Id", "Envelope", "Network", "ActorModelState", "SendCmd",
           "SetTimerCmd", "CancelTimerCmd", "Out", "Actor", "majority",
           "model_peers", "ActorModel", "DeliverAction", "DropAction",
           "TimeoutAction", "Internal", "Put", "Get", "PutOk", "GetOk",
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
    """The set of envelopes in flight: equal sets are equal networks, and
    hash and fingerprint alike whatever their order; iteration follows
    insertion, which is deterministic."""

    __slots__ = ("_envs",)

    def __init__(self, envelopes: Optional[Iterable[Envelope]] = None):
        self._envs = dict.fromkeys(envelopes or ())

    @staticmethod
    def from_iter(envelopes: Iterable[Envelope]) -> "Network":
        return Network(envelopes)

    def copy(self) -> "Network":
        n = Network.__new__(Network)
        n._envs = dict(self._envs)
        return n

    def insert(self, env: Envelope) -> None:
        self._envs[env] = None

    def remove(self, env: Envelope) -> None:
        self._envs.pop(env, None)

    def __iter__(self):
        return iter(self._envs)

    def __eq__(self, other) -> bool:
        return isinstance(other, Network) and self._envs == other._envs

    def __hash__(self) -> int:
        return hash(frozenset(self._envs))

    def __fingerprint__(self):
        return self._envs  # a dict fingerprints order-insensitively

    def __repr__(self) -> str:
        return "{" + ", ".join(repr(e) for e in self._envs) + "}"


class ActorModelState:
    """A snapshot of an actor system: each actor's state, the network,
    the timer flags and the recorded history. Treated as immutable:
    ``clone()`` copies the containers and shares the actor states."""

    __slots__ = ("actor_states", "network", "is_timer_set", "history", "_fp")

    def __init__(self, actor_states: List, network: Network,
                 is_timer_set: List[bool], history: Any):
        self.actor_states = actor_states
        self.network = network
        self.is_timer_set = is_timer_set
        self.history = history
        self._fp: Optional[int] = None

    def clone(self) -> "ActorModelState":
        return ActorModelState(list(self.actor_states), self.network.copy(),
                               list(self.is_timer_set), self.history)

    def __fingerprint__(self):
        return (self.actor_states, self.history, self.is_timer_set,
                self.network)

    def __eq__(self, other) -> bool:
        return (isinstance(other, ActorModelState)
                and self.actor_states == other.actor_states
                and self.history == other.history
                and self.is_timer_set == other.is_timer_set
                and self.network == other.network)

    def __hash__(self) -> int:
        if self._fp is None:
            self._fp = fingerprint(self)
        return self._fp

    def __repr__(self) -> str:
        return (f"ActorModelState {{ actor_states: {self.actor_states!r}, "
                f"network: {self.network!r}, "
                f"is_timer_set: {self.is_timer_set!r}, "
                f"history: {self.history!r} }}")


# -- Actors ----------------------------------------------------------------


@dataclass(frozen=True)
class SendCmd:
    """Send ``msg`` to ``dst``."""

    dst: Id
    msg: Any


@dataclass(frozen=True)
class SetTimerCmd:
    """Set (or reset) the actor's timer; ``range`` is a duration range in
    seconds, irrelevant under the checker."""

    range: Tuple[float, float]


@dataclass(frozen=True)
class CancelTimerCmd:
    """Cancel the actor's timer, if set."""


class Out:
    """The commands a handler emits."""

    __slots__ = ("commands",)

    def __init__(self):
        self.commands: List = []

    def send(self, recipient: Id, msg: Any) -> None:
        self.commands.append(SendCmd(recipient, msg))

    def broadcast(self, recipients: Iterable[Id], msg: Any) -> None:
        for recipient in recipients:
            self.commands.append(SendCmd(recipient, msg))

    def set_timer(self, duration_range: Tuple[float, float]) -> None:
        self.commands.append(SetTimerCmd(duration_range))

    def cancel_timer(self) -> None:
        self.commands.append(CancelTimerCmd())

    def __repr__(self) -> str:
        return repr(self.commands)


class Actor:
    """An actor: ``on_start`` gives its initial state, and the handlers
    return the next state, or ``None`` for "unchanged", emitting commands
    into ``o``. States are immutable values (frozen dataclasses, tuples):
    return a new one, never mutate."""

    def on_start(self, id: Id, o: Out):
        raise NotImplementedError

    def on_msg(self, id: Id, state, src: Id, msg, o: Out):
        return None

    def on_timeout(self, id: Id, state, o: Out):
        return None


def majority(cluster_size: int) -> int:
    """The number of nodes that make a majority."""
    return cluster_size // 2 + 1


def model_peers(self_ix: int, count: int) -> List[Id]:
    """The ids of actor ``self_ix``'s peers among ``count``."""
    return [Id(j) for j in range(count) if j != self_ix]


# -- The actor model -------------------------------------------------------


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


class ActorModel(Model):
    """A system of actors over a simulated network, as a ``Model``. The
    network duplicates (a delivered envelope stays, so it can be
    delivered again) unless ``with_duplicating_network(False)``, and
    loses envelopes (a Drop action each) with
    ``with_lossy_network(True)``. ``cfg`` is any configuration the
    property conditions read as ``model.cfg``; ``init_history`` seeds the
    history."""

    def __init__(self, cfg: Any = None, init_history: Any = None):
        self.actors: List[Actor] = []
        self.cfg = cfg
        self.duplicating_network = True
        self.init_history = init_history
        self._init_network: List[Envelope] = []
        self.lossy_network = False
        self._properties: List[Property] = []
        self._record_msg_in: Callable = lambda cfg, history, env: None
        self._record_msg_out: Callable = lambda cfg, history, env: None
        self._within_boundary: Callable = lambda cfg, state: True

    # -- Builder API -------------------------------------------------------

    def actor(self, actor: Actor) -> "ActorModel":
        self.actors.append(actor)
        return self

    def with_duplicating_network(self, duplicating: bool) -> "ActorModel":
        self.duplicating_network = duplicating
        return self

    def with_init_network(self, envelopes: Iterable[Envelope]
                          ) -> "ActorModel":
        self._init_network = list(envelopes)
        return self

    def with_lossy_network(self, lossy: bool) -> "ActorModel":
        self.lossy_network = lossy
        return self

    def property(self, *args):
        """``(expectation, name, condition)`` adds a property (the
        builder knob); ``(name)`` looks one up (``Model.property``)."""
        if len(args) == 1:
            return Model.property(self, args[0])
        expectation, name, condition = args
        self._properties.append(Property(expectation, name, condition))
        return self

    def record_msg_in(self, record: Callable) -> "ActorModel":
        """``record(cfg, history, envelope)`` -> the history after a
        delivery, or ``None`` for unchanged."""
        self._record_msg_in = record
        return self

    def record_msg_out(self, record: Callable) -> "ActorModel":
        """As ``record_msg_in``, for each message sent."""
        self._record_msg_out = record
        return self

    def with_boundary(self, boundary: Callable) -> "ActorModel":
        """``boundary(cfg, state) -> bool`` prunes the state space."""
        self._within_boundary = boundary
        return self

    # -- The model ----------------------------------------------------------

    def _process_commands(self, id: Id, out: Out,
                          state: ActorModelState) -> None:
        index = int(id)
        for c in out.commands:
            if type(c) is SendCmd:
                env = Envelope(id, c.dst, c.msg)
                history = self._record_msg_out(self.cfg, state.history, env)
                if history is not None:
                    state.history = history
                state.network.insert(env)
            elif type(c) is SetTimerCmd:
                # The timer list grows on demand; its length is part of
                # the state's identity.
                while len(state.is_timer_set) <= index:
                    state.is_timer_set.append(False)
                state.is_timer_set[index] = True
            elif index < len(state.is_timer_set):  # CancelTimerCmd
                state.is_timer_set[index] = False

    def init_states(self) -> List[ActorModelState]:
        state = ActorModelState([], Network(self._init_network), [],
                                self.init_history)
        for index, actor in enumerate(self.actors):
            out = Out()
            state.actor_states.append(actor.on_start(Id(index), out))
            self._process_commands(Id(index), out, state)
        return [state]

    def actions(self, state: ActorModelState, actions: List) -> None:
        for env in state.network:
            if self.lossy_network:
                actions.append(DropAction(env))
            if int(env.dst) < len(self.actors):
                actions.append(DeliverAction(env.src, env.dst, env.msg))
        for index, is_scheduled in enumerate(state.is_timer_set):
            if is_scheduled:
                actions.append(TimeoutAction(Id(index)))

    def next_state(self, last_sys_state: ActorModelState, action
                   ) -> Optional[ActorModelState]:
        kind = type(action)
        if kind is DropAction:
            next_state = last_sys_state.clone()
            next_state.network.remove(action.envelope)
            return next_state

        if kind is DeliverAction:
            index = int(action.dst)
            if index >= len(last_sys_state.actor_states):
                return None
            out = Out()
            next_actor_state = self.actors[index].on_msg(
                action.dst, last_sys_state.actor_states[index], action.src,
                action.msg, out)
            # A delivery that changes nothing is no action.
            if next_actor_state is None and not out.commands:
                return None
            env = Envelope(action.src, action.dst, action.msg)
            history = self._record_msg_in(self.cfg, last_sys_state.history,
                                          env)
            next_sys_state = last_sys_state.clone()
            if not self.duplicating_network:
                next_sys_state.network.remove(env)
            if next_actor_state is not None:
                next_sys_state.actor_states[index] = next_actor_state
            if history is not None:
                next_sys_state.history = history
            self._process_commands(action.dst, out, next_sys_state)
            return next_sys_state

        # TimeoutAction. As in the reference, a timeout always clears the
        # timer and yields a state (its no-op test cannot hold).
        index = int(action.id)
        out = Out()
        next_actor_state = self.actors[index].on_timeout(
            action.id, last_sys_state.actor_states[index], out)
        next_sys_state = last_sys_state.clone()
        next_sys_state.is_timer_set[index] = False
        if next_actor_state is not None:
            next_sys_state.actor_states[index] = next_actor_state
        self._process_commands(action.id, out, next_sys_state)
        return next_sys_state

    def format_action(self, action) -> str:
        if type(action) is DeliverAction:
            return f"{action.src!r} → {action.msg!r} → {action.dst!r}"
        return repr(action)

    def format_step(self, last_state: ActorModelState, action
                    ) -> Optional[str]:
        if type(action) is DropAction:
            return f"DROP: {action.envelope!r}"
        index = int(action.dst if type(action) is DeliverAction
                    else action.id)
        if index >= len(last_state.actor_states):
            return None
        last_actor_state = last_state.actor_states[index]
        out = Out()
        if type(action) is DeliverAction:
            next_actor_state = self.actors[index].on_msg(
                action.dst, last_actor_state, action.src, action.msg, out)
        else:
            next_actor_state = self.actors[index].on_timeout(
                action.id, last_actor_state, out)
        lines = [f"OUT: {out!r}", ""]
        if next_actor_state is not None:
            lines += [f"NEXT_STATE: {pformat(next_actor_state)}", "",
                      f"PREV_STATE: {pformat(last_actor_state)}"]
        else:
            lines += [f"UNCHANGED: {pformat(last_actor_state)}"]
        return "\n".join(lines) + "\n"

    def properties(self) -> List[Property]:
        return list(self._properties)

    def within_boundary(self, state: ActorModelState) -> bool:
        return self._within_boundary(self.cfg, state)


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
