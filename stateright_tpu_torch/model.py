"""The ``Model`` a user checks, and its named ``Property`` predicates.

The port's copy of what the engine needs from ``stateright_tpu/model.py``.
The port checks on the device only, so a property here is a name and an
expectation; its predicate is the device model's (``device_properties``).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List

__all__ = ["Expectation", "Property", "Model"]


class Expectation(Enum):
    """Whether a property is always, eventually, or sometimes true."""

    ALWAYS = "always"
    EVENTUALLY = "eventually"
    SOMETIMES = "sometimes"


@dataclass(frozen=True)
class Property:
    """A named property; the device model supplies its predicate."""

    expectation: Expectation
    name: str

    @staticmethod
    def always(name: str) -> "Property":
        """A safety invariant: the checker hunts a counterexample."""
        return Property(Expectation.ALWAYS, name)

    @staticmethod
    def eventually(name: str) -> "Property":
        """A liveness property: a counterexample is a terminal path that
        never satisfies it (sound on acyclic state graphs only)."""
        return Property(Expectation.EVENTUALLY, name)

    @staticmethod
    def sometimes(name: str) -> "Property":
        """A reachability property: the checker hunts an example."""
        return Property(Expectation.SOMETIMES, name)


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
