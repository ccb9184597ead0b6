"""The ``Model`` a user checks, and its named ``Property`` predicates.

The port's copy of ``stateright_tpu/model.py``. A model is a transition
system: its initial states, and on the host the enabled ``actions`` of a
state and the ``next_state`` an action leads to, which the host BFS
(``bfs.py``), the host DFS (``dfs.py``) and host paths (``path.py``)
run. Its device form
(``device_model()``) holds the same transition function over encoded
rows, for the device engines. A property is a name, an expectation and a
host ``condition(model, state)``; on the device its predicate is the
device model's (``device_properties``) where it has one, and the classic
engine (``classic.py``) evaluates a property that has none by its
condition, on decoded states, a wave at a time.

A model with no host transitions (a device form alone) raises
``NotImplementedError`` from ``actions``, and so do the host engines.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from pprint import pformat
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["Expectation", "Property", "Model", "property_predicates",
           "require_host_form"]


class Expectation(Enum):
    """Whether a property is always, eventually, or sometimes true."""

    ALWAYS = "always"
    EVENTUALLY = "eventually"
    SOMETIMES = "sometimes"


@dataclass(frozen=True)
class Property:
    """A named property. The host ``condition(model, state)`` is what the
    host engine evaluates, and what a device engine evaluates where the
    device model has no predicate of this name."""

    expectation: Expectation
    name: str
    condition: Optional[Callable[[Any, Any], bool]] = None

    @staticmethod
    def always(name: str, condition=None) -> "Property":
        """A safety invariant: the checker hunts a counterexample."""
        return Property(Expectation.ALWAYS, name, condition)

    @staticmethod
    def eventually(name: str, condition=None) -> "Property":
        """A liveness property: a counterexample is a terminal path that
        never satisfies it (sound on acyclic state graphs only)."""
        return Property(Expectation.EVENTUALLY, name, condition)

    @staticmethod
    def sometimes(name: str, condition=None) -> "Property":
        """A reachability property: the checker hunts an example."""
        return Property(Expectation.SOMETIMES, name, condition)


def property_predicates(properties, dm) -> list:
    """Each property's device predicate, or None where the device model
    has none and the property's host condition stands in. A property
    with neither raises ``ValueError``."""
    preds = dm.device_properties()
    neither = [p.name for p in properties
               if p.name not in preds and p.condition is None]
    if neither:
        raise ValueError(f"properties {neither} have neither a device "
                         "predicate nor a host condition")
    return [preds.get(p.name) for p in properties]


class Model:
    """A transition system: ``init_states``, and ``actions`` with
    ``next_state`` on the host, ``device_model()`` on the device; either
    may be missing. Subclass and implement what the engines you spawn
    need, with ``properties`` and optionally ``within_boundary`` and the
    formatting hooks."""

    #: the model name a checkpoint header records, where it is not the
    #: class's name: the name the JAX package writes for the same model,
    #: so that a checkpoint crosses between the packages
    checkpoint_name = None

    def init_states(self) -> List:
        """The initial states, as host objects (the device model encodes
        them for the device engines)."""
        raise NotImplementedError

    def actions(self, state, actions: List) -> None:
        """Appends the actions enabled at ``state`` to ``actions``."""
        raise NotImplementedError(_no_host_form(self))

    def next_state(self, last_state, action):
        """The state ``action`` leads to from ``last_state``; ``None``
        means the action is ignored."""
        raise NotImplementedError(_no_host_form(self))

    def properties(self) -> List[Property]:
        return []

    def within_boundary(self, state) -> bool:
        """Whether ``state`` lies inside the space to check."""
        return True

    def device_model(self):
        """The :class:`~stateright_tpu_torch.device_model.DeviceModel`."""
        raise NotImplementedError

    def format_action(self, action) -> str:
        return _fmt(action)

    def format_step(self, last_state, action) -> Optional[str]:
        next_state = self.next_state(last_state, action)
        return None if next_state is None else pformat(next_state)

    def next_steps(self, last_state) -> List[Tuple[Any, Any]]:
        """The ``(action, state)`` pairs that follow ``last_state``."""
        actions: List = []
        self.actions(last_state, actions)
        steps = []
        for action in actions:
            next_state = self.next_state(last_state, action)
            if next_state is not None:
                steps.append((action, next_state))
        return steps

    def next_states(self, last_state) -> List:
        """The states that follow ``last_state``."""
        return [s for _, s in self.next_steps(last_state)]

    def property(self, name: str) -> Property:
        for p in self.properties():
            if p.name == name:
                return p
        available = [p.name for p in self.properties()]
        raise KeyError(
            f"Unknown property. requested={name}, available={available}")

    def checker(self):
        """A ``CheckerBuilder`` for this model."""
        from .builder import CheckerBuilder

        return CheckerBuilder(self)


def _no_host_form(model) -> str:
    return (f"{type(model).__name__} has no host transition function: "
            "implement actions() and next_state() to run it on the host "
            "engines")


def require_host_form(model, properties) -> None:
    """Raises ``NotImplementedError`` unless the host engines can run
    ``model``: it has ``actions`` and every property has a host
    condition."""
    if type(model).actions is Model.actions:
        raise NotImplementedError(_no_host_form(model))
    bare = [p.name for p in properties if p.condition is None]
    if bare:
        raise NotImplementedError(
            f"properties {bare} of {type(model).__name__} have no host "
            "condition, which the host engines evaluate")


def _fmt(value: Any) -> str:
    """Debug-style formatting: an Enum member prints as its bare name."""
    if isinstance(value, Enum):
        return value.name
    return repr(value)
