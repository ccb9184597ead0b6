"""Symmetry reduction on the host: rewrite plans and representatives.

The port's copy of ``stateright_tpu/symmetry.py`` (after the reference's
``src/checker/{representative,rewrite,rewrite_plan}.rs``, the
Symmetric-Spin technique), which the host DFS's ``symmetry()`` runs
(``dfs.py``). A ``RewritePlan`` is built by sorting a per-process field
of a state; it permutes a per-process collection into that order
(``reindex``) and maps a process id held elsewhere in the state to its
new index (``rewrite``). ``rewrite_value`` walks the common containers
and rewrites exactly the ``Id`` values (a scalar is left alone, as the
reference's no-op ``Rewrite`` impls do). A model with plain-integer
process indices (2pc) rewrites them in its own ``representative``.

The device engines canonicalise encoded rows instead, with the device
model's ``representative``.
"""

from __future__ import annotations

from dataclasses import fields, is_dataclass, replace
from enum import Enum
from typing import Any, Callable, List, Optional, Sequence

from .actor import ActorModelState, Id, Network
from .fingerprint import fingerprint_bytes

__all__ = ["RewritePlan", "rewrite_value", "actor_model_representative",
           "sort_key"]


def sort_key(value: Any):
    """A total order over values of mixed types: ``(type name, digest)``
    (natural comparison varies with the mix). Orders actor states where
    the reference needs ``Ord`` on them."""
    return (type(value).__qualname__, fingerprint_bytes(value))


class RewritePlan:
    """How process ids are rewritten so that the result behaves as the
    original under symmetry (``rewrite_plan.rs:19-89``)."""

    __slots__ = ("reindex_mapping", "rewrite_mapping")

    def __init__(self, reindex_mapping: List[int]):
        self.reindex_mapping = list(reindex_mapping)
        # rewrite_mapping[src] = dst
        pairs = sorted((src, dst)
                       for dst, src in enumerate(self.reindex_mapping))
        self.rewrite_mapping = [dst for _, dst in pairs]

    @staticmethod
    def from_values_to_sort(values: Sequence,
                            key: Optional[Callable] = None) -> "RewritePlan":
        """The plan that sorts ``values`` (``rewrite_plan.rs:36-49``),
        by their natural order or by ``key`` (``sort_key`` for values of
        mixed types)."""
        indexed = list(enumerate(values))
        if key is None:
            indexed.sort(key=lambda iv: iv[1])
        else:
            indexed.sort(key=lambda iv: key(iv[1]))
        return RewritePlan([i for i, _ in indexed])

    def reindex(self, indexed: Sequence) -> list:
        """A per-process collection in the plan's order, each element
        rewritten (``rewrite_plan.rs:68-76``)."""
        return [rewrite_value(indexed[i], self) for i in self.reindex_mapping]

    def rewrite(self, index):
        """One process index remapped, of its own type
        (``rewrite_plan.rs:84-89``)."""
        return type(index)(self.rewrite_mapping[int(index)])


def rewrite_value(value: Any, plan: RewritePlan) -> Any:
    """``value`` with every ``Id`` in it rewritten by ``plan``
    (``rewrite.rs:24-120``). A type it does not know is returned as it is;
    an object may define ``__rewrite__(plan)``."""
    t = type(value)
    if t is Id:
        return plan.rewrite(value)
    if value is None or t in (bool, int, float, str, bytes) \
            or isinstance(value, Enum):
        return value
    if t is tuple:
        return tuple(rewrite_value(v, plan) for v in value)
    if t is list:
        return [rewrite_value(v, plan) for v in value]
    if t is frozenset or t is set:
        return t(rewrite_value(v, plan) for v in value)
    if t is dict:
        return {rewrite_value(k, plan): rewrite_value(v, plan)
                for k, v in value.items()}
    custom = getattr(value, "__rewrite__", None)
    if custom is not None:
        return custom(plan)
    if is_dataclass(value):
        return replace(value, **{
            f.name: rewrite_value(getattr(value, f.name), plan)
            for f in fields(value)})
    if isinstance(value, tuple):  # namedtuple
        return t(*(rewrite_value(v, plan) for v in value))
    return value


def actor_model_representative(state: ActorModelState) -> ActorModelState:
    """``state`` with its actor states sorted and the ids in its network,
    timers and history rewritten to match
    (``actor/model_state.rs:103-118``)."""
    plan = RewritePlan.from_values_to_sort(state.actor_states, key=sort_key)
    # The timer list grows on demand: pad it before permuting by actor.
    timers = list(state.is_timer_set)
    timers += [False] * (len(state.actor_states) - len(timers))
    return ActorModelState(
        actor_states=plan.reindex(state.actor_states),
        network=Network(rewrite_value(e, plan) for e in state.network),
        is_timer_set=plan.reindex(timers),
        history=rewrite_value(state.history, plan),
    )
