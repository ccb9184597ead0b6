"""The port's modeling collections (``stateright_tpu_torch/util.py``):
``VectorClock``, ``DenseNatMap``, ``HashableHashSet``,
``HashableHashMap``, the port arm of ``tests/test_util_collections.py``
and of the collection cases of ``tests/test_choice_and_hashable.py``
(each test of theirs here against the port's classes, ``Id``,
``RewritePlan`` and ``fingerprint``), then held to the JAX package's: on
the same contents a port collection's fingerprint is JAX's, whatever the
insertion order, as an element of a state, and after a symmetry rewrite
by each package's ``RewritePlan``. Exact everywhere.
"""

import random
from dataclasses import dataclass

import pytest

from stateright_tpu import util as ref_util
from stateright_tpu.actor import Id as RefId
from stateright_tpu.fingerprint import fingerprint as ref_fingerprint
from stateright_tpu.symmetry import RewritePlan as RefPlan
from stateright_tpu_torch import (DenseNatMap, HashableHashMap,
                                  HashableHashSet, VectorClock)
from stateright_tpu_torch.actor import Id
from stateright_tpu_torch.fingerprint import fingerprint
from stateright_tpu_torch.symmetry import RewritePlan


# -- VectorClock (JAX's tests/test_util_collections.py) --------------------

def test_clock_can_display():
    assert str(VectorClock([1, 2, 3, 4])) == "<1, 2, 3, 4, ...>"
    assert str(VectorClock()) == "<...>"
    assert str(VectorClock([0])) == "<0, ...>"


def test_clock_can_equate_ignoring_padding():
    assert VectorClock() == VectorClock([0, 0, 0])
    assert VectorClock([1, 2]) == VectorClock([1, 2, 0])
    assert VectorClock([1, 2]) != VectorClock([1, 2, 3])
    assert VectorClock([0, 1]) != VectorClock([1])


def test_clock_hash_and_fingerprint_ignore_padding():
    assert hash(VectorClock([1, 2])) == hash(VectorClock([1, 2, 0, 0]))
    assert fingerprint(VectorClock([1, 2])) == \
        fingerprint(VectorClock([1, 2, 0, 0]))
    assert fingerprint(VectorClock()) == fingerprint(VectorClock([0]))
    assert fingerprint(VectorClock([1])) != fingerprint(VectorClock([0, 1]))


def test_clock_can_increment():
    assert VectorClock().incremented(2) == VectorClock([0, 0, 1])
    assert VectorClock([1, 2]).incremented(0) == VectorClock([2, 2])
    c = VectorClock([1])
    assert c.incremented(0) == VectorClock([2])
    assert c == VectorClock([1])


def test_clock_can_merge():
    assert VectorClock.merge_max(
        VectorClock([1, 0, 3]), VectorClock([0, 2])) == VectorClock([1, 2, 3])
    assert VectorClock.merge_max(VectorClock(), VectorClock()) == \
        VectorClock()


def test_clock_partial_order():
    assert VectorClock([1, 2]).partial_cmp(VectorClock([1, 2, 0])) == 0
    assert VectorClock([1, 2]) <= VectorClock([1, 2])
    assert VectorClock([1, 2]) < VectorClock([1, 3])
    assert VectorClock([1, 2]) < VectorClock([2, 2, 1])
    assert VectorClock([2, 0]) > VectorClock([1])
    a, b = VectorClock([1, 0, 2]), VectorClock([0, 1, 2])
    assert a.partial_cmp(b) is None
    assert not a < b and not a <= b and not a > b and not a >= b


def test_clock_rejects_negative():
    with pytest.raises(ValueError):
        VectorClock([-1])


# -- DenseNatMap -------------------------------------------------------------

def test_densenatmap_insert_in_order_or_overwrite():
    m = DenseNatMap(key=Id)
    assert m.insert(Id(0), "first") is None
    assert m.insert(Id(1), "second") is None
    assert m.insert(Id(0), "FIRST") == "first"
    assert m.values() == ["FIRST", "second"]
    with pytest.raises(IndexError):
        m.insert(Id(5), "sparse")


def test_densenatmap_from_pairs_any_order():
    m = DenseNatMap.from_pairs([(Id(1), "second"), (Id(0), "first")], key=Id)
    assert m.values() == ["first", "second"]
    assert m[Id(1)] == "second"
    assert m.get(Id(7)) is None
    with pytest.raises(ValueError):
        DenseNatMap.from_pairs([(Id(0), "a"), (Id(2), "c")])


def test_densenatmap_iteration_yields_typed_keys():
    m = DenseNatMap(["a", "b"], key=Id)
    assert list(m) == [(Id(0), "a"), (Id(1), "b")]
    assert all(type(k) is Id for k, _ in m.items())
    assert len(m) == 2


def test_densenatmap_identity():
    assert DenseNatMap(["a", "b"]) == DenseNatMap(["a", "b"])
    assert DenseNatMap(["a"]) != DenseNatMap(["a", "b"])
    assert fingerprint(DenseNatMap(["a", "b"])) == \
        fingerprint(DenseNatMap(["a", "b"]))
    assert fingerprint(DenseNatMap(["a"])) != fingerprint(DenseNatMap(["b"]))


def test_densenatmap_symmetry_rewrite():
    plan = RewritePlan.from_values_to_sort(["b", "a"])
    m = DenseNatMap([Id(0), Id(1)], key=Id)
    assert m.__rewrite__(plan).values() == [Id(0), Id(1)]
    m2 = DenseNatMap(["x", "y"], key=Id)
    assert m2.__rewrite__(plan).values() == ["y", "x"]


# -- HashableHashSet / HashableHashMap (tests/test_choice_and_hashable.py) ----

def test_hashable_set_order_insensitive_hash():
    a = HashableHashSet([1, 2, 3])
    b = HashableHashSet([3, 1, 2])
    assert a == b
    assert hash(a) == hash(b)
    assert fingerprint(a) == fingerprint(b)
    b.add(4)
    assert a != b and hash(a) != hash(b)
    b.remove(4)
    assert hash(a) == hash(b)
    assert len({a, b}) == 1
    assert a == {1, 2, 3}


def test_hashable_map_order_insensitive_hash():
    a = HashableHashMap({"x": 1, "y": 2})
    b = HashableHashMap([("y", 2), ("x", 1)])
    assert a == b and hash(a) == hash(b)
    assert fingerprint(a) == fingerprint(b)
    b["z"] = 3
    assert hash(a) != hash(b)
    del b["z"]
    assert hash(a) == hash(b)
    assert a == {"x": 1, "y": 2}
    assert sorted(a.keys()) == ["x", "y"]


def test_hashable_collections_rewrite_ids():
    plan = RewritePlan.from_values_to_sort(["b", "a"])
    s = HashableHashSet([Id(0), Id(1)])
    assert s.__rewrite__(plan) == HashableHashSet([Id(1), Id(0)])
    m = HashableHashMap({Id(0): "v"})
    assert m.__rewrite__(plan) == HashableHashMap({Id(1): "v"})


# -- Against the JAX package -------------------------------------------------

@dataclass(frozen=True)
class Held:
    """A host state holding every collection (one class, so its qualname
    tags the same in both packages' encodings)."""
    peers: object
    votes: object
    clock: object
    slots: object


def _contents(seed: int):
    rng = random.Random(seed)
    ids = list(range(rng.randint(2, 5)))
    peers = rng.sample(ids, rng.randint(1, len(ids)))
    votes = [(i, rng.choice(["yes", "no", ("maybe", i)])) for i in ids]
    clock = [rng.randint(0, 3) for _ in range(rng.randint(0, 5))] + [0] * \
        rng.randint(0, 2)
    slots = [rng.randint(-2, 9) for _ in ids]
    return rng, ids, peers, votes, clock, slots


def _build(pkg, ident, rng, peers, votes, clock, slots):
    """The collections of one package from the contents, each unordered
    one filled in a shuffled order."""
    peers = [ident(p) for p in peers]
    votes = [(ident(i), v) for i, v in votes]
    rng.shuffle(peers)
    rng.shuffle(votes)
    s = pkg.HashableHashSet()
    for p in peers:
        s.add(p)
    m = pkg.HashableHashMap()
    for k, v in votes:
        m[k] = v
    pairs = [(ident(i), ident(v % len(slots)) if v >= 0 else v)
             for i, v in enumerate(slots)]
    rng.shuffle(pairs)
    return Held(s, m, pkg.VectorClock(clock),
                pkg.DenseNatMap.from_pairs(pairs, key=ident))


class _Port:
    HashableHashSet, HashableHashMap = HashableHashSet, HashableHashMap
    VectorClock, DenseNatMap = VectorClock, DenseNatMap


@pytest.mark.parametrize("seed", range(8))
def test_fingerprints_equal_jax_in_any_insertion_order(seed):
    rng, _, *contents = _contents(seed)
    port = _build(_Port, Id, random.Random(rng.random()), *contents)
    again = _build(_Port, Id, random.Random(rng.random()), *contents)
    ref = _build(ref_util, RefId, random.Random(rng.random()), *contents)
    assert port == again and hash(port) == hash(again)
    assert fingerprint(port) == fingerprint(again) == ref_fingerprint(ref)
    for name in ("peers", "votes", "clock", "slots"):
        assert fingerprint(getattr(port, name)) == \
            ref_fingerprint(getattr(ref, name)), name


@pytest.mark.parametrize("seed", range(8))
def test_rewritten_fingerprints_equal_jax(seed):
    """Each package's ``RewritePlan`` from the same values to sort,
    applied to its own collections: the ids move alike, so the rewritten
    states fingerprint alike."""
    from stateright_tpu.symmetry import rewrite_value as ref_rewrite
    from stateright_tpu_torch.symmetry import rewrite_value

    rng, ids, *contents = _contents(seed)
    order = [rng.random() for _ in ids]
    port = _build(_Port, Id, random.Random(seed), *contents)
    ref = _build(ref_util, RefId, random.Random(seed), *contents)
    got = rewrite_value(port, RewritePlan.from_values_to_sort(order))
    want = ref_rewrite(ref, RefPlan.from_values_to_sort(order))
    assert fingerprint(got) == ref_fingerprint(want)
    assert got.slots.values() == [
        v if not isinstance(v, RefId) else Id(v) for v in want.slots.values()]
    assert sorted(got.peers) == sorted(Id(p) for p in want.peers)
