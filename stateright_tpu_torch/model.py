"""The ``Model`` a user checks, and its named ``Property`` predicates.

The port's copy of what the engine needs from ``stateright_tpu/model.py``.
A property is a name, an expectation and an optional host ``condition(model,
state)``. Its predicate on the device is the device model's
(``device_properties``) where it has one; the classic engine
(``classic.py``) evaluates a property that has none by its condition, on
decoded states, a wave at a time.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, List, Optional

__all__ = ["Expectation", "Property", "Model", "property_predicates"]


class Expectation(Enum):
    """Whether a property is always, eventually, or sometimes true."""

    ALWAYS = "always"
    EVENTUALLY = "eventually"
    SOMETIMES = "sometimes"


@dataclass(frozen=True)
class Property:
    """A named property. The device model supplies its predicate; the
    host ``condition(model, state)``, where given, is what an engine
    evaluates when the device model has none."""

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
    """A transition system given by its initial states and its device
    form (``device_model``), which holds the transition function."""

    #: the model name a checkpoint header records, where it is not the
    #: class's name: the name the JAX package writes for the same model,
    #: so that a checkpoint crosses between the packages
    checkpoint_name = None

    def init_states(self) -> List:
        """The initial states, as host objects the device model encodes."""
        raise NotImplementedError

    def properties(self) -> List[Property]:
        return []

    def device_model(self):
        """The :class:`~stateright_tpu_torch.device_model.DeviceModel`."""
        raise NotImplementedError

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
