"""Modeling utility collections: ``VectorClock``, ``DenseNatMap``,
``HashableHashSet``, ``HashableHashMap``.

The port's copy of ``stateright_tpu/util.py`` (the reference's
``src/util/vector_clock.rs:11-106``, ``src/util/densenatmap.rs:75-216``
and ``src/util.rs:72-300``), for host states. ``set`` and ``dict`` are
not hashable, so a frozen-dataclass state that also wants ``hash()`` or
dict-key semantics holds these instead: mutable collections whose hash
does not depend on insertion order.

Each class keeps JAX's name and ``__fingerprint__``, so the port's
``fingerprint.py`` (which tags a ``__fingerprint__`` value by its class's
qualname) gives a state holding one the fingerprint JAX gives it; the
hashable pair fingerprint as a ``frozenset`` / ``dict`` does, through the
sorted digests of their elements. ``__rewrite__`` takes a
``symmetry.RewritePlan``: ``DenseNatMap`` reindexes its keys and the
hashable pair rewrite their elements, ids included. Nothing on the card
uses them.

- ``VectorClock`` is immutable (``incremented`` returns a new clock) and
  its identity ignores trailing zeros, as the reference's ``Hash``.
- ``DenseNatMap`` keeps a key constructor (``Id``, say), so iteration
  yields typed keys.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

__all__ = ["VectorClock", "DenseNatMap", "HashableHashSet",
           "HashableHashMap"]


class VectorClock:
    """A vector clock: a partial causal order on events
    (`vector_clock.rs:11-106`). Components beyond the stored length are
    implicitly zero, and all comparisons/identity ignore trailing zeros.

    >>> a = VectorClock().incremented(0)        # process 0 acts
    >>> b = VectorClock().incremented(1)        # process 1 acts
    >>> a.partial_cmp(b) is None                # concurrent
    True
    >>> merged = VectorClock.merge_max(a, b).incremented(1)
    >>> a < merged and b < merged
    True
    >>> VectorClock([1, 0, 0]) == VectorClock([1])  # padding-insensitive
    True
    """

    __slots__ = ("_v",)

    def __init__(self, components: Iterable[int] = ()):
        self._v: Tuple[int, ...] = tuple(int(x) for x in components)
        if any(x < 0 for x in self._v):
            raise ValueError("vector clock components are nonnegative")

    # -- Accessors --------------------------------------------------------

    def get(self, index: int) -> int:
        """The component at ``index`` (0 beyond the stored length)."""
        return self._v[index] if index < len(self._v) else 0

    def components(self) -> Tuple[int, ...]:
        return self._v

    # -- Operations (vector_clock.rs:21-40) -------------------------------

    @staticmethod
    def merge_max(c1: "VectorClock", c2: "VectorClock") -> "VectorClock":
        """Elementwise maximum of two clocks."""
        n = max(len(c1._v), len(c2._v))
        return VectorClock(max(c1.get(i), c2.get(i)) for i in range(n))

    def incremented(self, index: int) -> "VectorClock":
        """A new clock with component ``index`` incremented (padding with
        zeros as needed)."""
        v = list(self._v) + [0] * (index + 1 - len(self._v))
        v[index] += 1
        return VectorClock(v)

    # -- Identity: trailing zeros are insignificant -----------------------

    def _trimmed(self) -> Tuple[int, ...]:
        v = self._v
        n = len(v)
        while n and v[n - 1] == 0:
            n -= 1
        return v[:n]

    def __eq__(self, other) -> bool:
        if not isinstance(other, VectorClock):
            return NotImplemented
        return self._trimmed() == other._trimmed()

    def __hash__(self) -> int:
        return hash(self._trimmed())

    def __fingerprint__(self):
        return self._trimmed()

    # -- Partial order (vector_clock.rs:83-106) ---------------------------

    def partial_cmp(self, other: "VectorClock") -> Optional[int]:
        """-1 / 0 / +1 when comparable, ``None`` for concurrent clocks."""
        expected = 0
        for i in range(max(len(self._v), len(other._v))):
            a, b = self.get(i), other.get(i)
            ordering = (a > b) - (a < b)
            if expected == 0:
                expected = ordering
            elif ordering not in (0, expected):
                return None
        return expected

    def __lt__(self, other) -> bool:
        return self.partial_cmp(other) == -1

    def __le__(self, other) -> bool:
        return self.partial_cmp(other) in (-1, 0)

    def __gt__(self, other) -> bool:
        return self.partial_cmp(other) == 1

    def __ge__(self, other) -> bool:
        return self.partial_cmp(other) in (0, 1)

    def __repr__(self) -> str:
        return f"VectorClock({list(self._v)!r})"

    def __str__(self) -> str:
        # Display parity with the reference: "<1, 2, ...>"; equal clocks
        # need not display identically (trailing zeros show).
        return "<" + "".join(f"{c}, " for c in self._v) + "...>"


class DenseNatMap:
    """A map whose keys densely cover ``0..len``, stored as a flat list
    (`densenatmap.rs:75-216`). Safer than a bare list in model state:
    lookups are by *typed* key (e.g. actor ``Id``), inserts must stay
    dense, and symmetry rewrites reindex keys while rewriting values.
    """

    __slots__ = ("_values", "_key")

    def __init__(self, values: Iterable = (), key: Callable[[int], object] = int):
        self._values = list(values)
        self._key = key

    @classmethod
    def from_pairs(cls, pairs: Iterable[Tuple[object, object]],
                   key: Callable[[int], object] = int) -> "DenseNatMap":
        """Builds from (key, value) pairs in any order; raises ``ValueError``
        if the keys do not densely cover ``0..n`` (densenatmap.rs
        ``FromIterator``)."""
        indexed = sorted(((int(k), v) for k, v in pairs), key=lambda kv: kv[0])
        for expected, (i, _) in enumerate(indexed):
            if i != expected:
                raise ValueError(
                    f"invalid key at index: index={i}, "
                    f"expected_index={expected}")
        return cls((v for _, v in indexed), key=key)

    # -- Map surface (densenatmap.rs:84-130) ------------------------------

    def get(self, key) -> Optional[object]:
        """The value for ``key``, or ``None`` if out of range."""
        index = int(key)
        return self._values[index] if 0 <= index < len(self._values) else None

    def insert(self, key, value) -> Optional[object]:
        """Overwrites an existing key (returning the previous value) or
        appends at exactly ``len`` (returning ``None``); anything sparser
        raises ``IndexError`` (densenatmap.rs:95-109)."""
        index = int(key)
        if index > len(self._values):
            raise IndexError(
                f"out of bounds: index={index}, len={len(self._values)}")
        if index == len(self._values):
            self._values.append(value)
            return None
        previous = self._values[index]
        self._values[index] = value
        return previous

    def __getitem__(self, key):
        return self._values[int(key)]

    def __setitem__(self, key, value):
        self.insert(key, value)

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self):
        return iter(self.items())

    def items(self):
        return [(self._key(i), v) for i, v in enumerate(self._values)]

    def values(self):
        return list(self._values)

    # -- Identity / symmetry ----------------------------------------------

    def __eq__(self, other) -> bool:
        if not isinstance(other, DenseNatMap):
            return NotImplemented
        return self._values == other._values

    def __hash__(self) -> int:
        return hash(tuple(self._values))

    def __fingerprint__(self):
        return tuple(self._values)

    def __rewrite__(self, plan) -> "DenseNatMap":
        """Symmetry rewrite: keys reindex through the plan, values rewrite
        structurally (the reference's ``Rewrite`` impl,
        densenatmap.rs:202-216)."""
        from .symmetry import rewrite_value

        return DenseNatMap.from_pairs(
            ((plan.rewrite_mapping[i], rewrite_value(v, plan))
             for i, v in enumerate(self._values)),
            key=self._key)

    def __repr__(self) -> str:
        return f"DenseNatMap({self._values!r})"


class HashableHashSet:
    """A mutable hash set with a stable, order-insensitive ``hash()``
    (`util.rs:72-208`): same elements => same hash regardless of
    insertion order, computed from sorted element digests."""

    __slots__ = ("_items",)

    def __init__(self, items: Iterable = ()):
        self._items = set(items)

    def add(self, item) -> None:
        self._items.add(item)

    def discard(self, item) -> None:
        self._items.discard(item)

    def remove(self, item) -> None:
        self._items.remove(item)

    def __contains__(self, item) -> bool:
        return item in self._items

    def __iter__(self):
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __eq__(self, other) -> bool:
        if isinstance(other, HashableHashSet):
            return self._items == other._items
        if isinstance(other, (set, frozenset)):
            return self._items == other
        return NotImplemented

    def __hash__(self) -> int:
        # frozenset hashing is already order-insensitive, cheap, and —
        # because __eq__ equates us with set/frozenset — the only hash
        # that keeps the eq/hash contract across those types. (Stable
        # cross-process identity is the fingerprint layer's job, via
        # __fingerprint__.)
        return hash(frozenset(self._items))

    def __fingerprint__(self):
        return frozenset(self._items)

    def __rewrite__(self, plan) -> "HashableHashSet":
        from .symmetry import rewrite_value

        return HashableHashSet(
            rewrite_value(x, plan) for x in self._items)

    def __repr__(self) -> str:
        inner = ", ".join(sorted(map(repr, self._items)))
        return f"HashableHashSet({{{inner}}})"


class HashableHashMap:
    """A mutable hash map with a stable, order-insensitive ``hash()``
    (`util.rs:226-327`), hashing sorted (key, value) entry digests."""

    __slots__ = ("_map",)

    def __init__(self, items=()):
        self._map = dict(items)

    def __getitem__(self, key):
        return self._map[key]

    def __setitem__(self, key, value) -> None:
        self._map[key] = value

    def __delitem__(self, key) -> None:
        del self._map[key]

    def get(self, key, default=None):
        return self._map.get(key, default)

    def __contains__(self, key) -> bool:
        return key in self._map

    def __iter__(self):
        return iter(self._map)

    def keys(self):
        return self._map.keys()

    def values(self):
        return self._map.values()

    def items(self):
        return self._map.items()

    def __len__(self) -> int:
        return len(self._map)

    def __eq__(self, other) -> bool:
        if isinstance(other, HashableHashMap):
            return self._map == other._map
        if isinstance(other, dict):
            return self._map == other
        return NotImplemented

    def __hash__(self) -> int:
        # Order-insensitive by construction; values must be hashable
        # (the reference requires V: Hash likewise, util.rs:278-300).
        return hash(frozenset(self._map.items()))

    def __fingerprint__(self):
        return dict(self._map)

    def __rewrite__(self, plan) -> "HashableHashMap":
        from .symmetry import rewrite_value

        return HashableHashMap(
            (rewrite_value(k, plan), rewrite_value(v, plan))
            for k, v in self._map.items())

    def __repr__(self) -> str:
        return f"HashableHashMap({self._map!r})"
