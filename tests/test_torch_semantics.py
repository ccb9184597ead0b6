"""The port's consistency testers and reference objects against JAX's.

The port's ``semantics.py`` (``SequentialConsistencyTester``,
``LinearizabilityTester``, ``Register`` and ``VecSpec``) and JAX's
``stateright_tpu/semantics/``: every history of
``tests/test_semantics.py``'s vec, linearizability and sequential
consistency cases is played into a tester of each package, and the
serialized histories (reprs), the verdicts and the testers' fingerprints
are equal, and equal to what JAX's tests hold. Then the port's arms of
those tests as JAX writes them. Every comparison is exact.
"""

import pytest

import stateright_tpu.semantics as ref_sem
from stateright_tpu.fingerprint import fingerprint as ref_fingerprint
from stateright_tpu_torch import semantics as sem
from stateright_tpu_torch.fingerprint import fingerprint

# A history: (tester, spec, spec's argument, steps, JAX's serialization).
# A step is ("invoke", thread, op), ("return", thread, ret) or ("invret",
# thread, op, ret); an op or a ret is (class name, *arguments).
R, WO = ("Read",), ("WriteOk",)
HISTORIES = {
    "lin register in flight": (
        "LinearizabilityTester", "Register", "A",
        [("invoke", 0, ("Write", "B")),
         ("invret", 1, R, ("ReadOk", "A"))],
        [(R, ("ReadOk", "A"))]),
    "lin register read after write": (
        "LinearizabilityTester", "Register", "A",
        [("invoke", 0, R), ("invoke", 1, ("Write", "B")),
         ("return", 0, ("ReadOk", "B"))],
        [(("Write", "B"), WO), (R, ("ReadOk", "B"))]),
    "lin register bad read": (
        "LinearizabilityTester", "Register", "A",
        [("invret", 0, R, ("ReadOk", "B"))], None),
    "lin register sc only": (
        "LinearizabilityTester", "Register", "A",
        [("invret", 0, R, ("ReadOk", "B")), ("invoke", 1, ("Write", "B"))],
        None),
    "lin vec push in flight": (
        "LinearizabilityTester", "VecSpec", None,
        [("invoke", 0, ("Push", 10))], []),
    "lin vec pop empty": (
        "LinearizabilityTester", "VecSpec", None,
        [("invoke", 0, ("Push", 10)), ("invret", 1, ("Pop",), ("PopOk", None))],
        [(("Pop",), ("PopOk", None))]),
    "lin vec pop pushed": (
        "LinearizabilityTester", "VecSpec", None,
        [("invoke", 0, ("Push", 10)), ("invret", 1, ("Pop",), ("PopOk", 10))],
        [(("Push", 10), ("PushOk",)), (("Pop",), ("PopOk", 10))]),
    "lin vec len and pops": (
        "LinearizabilityTester", "VecSpec", None,
        [("invret", 0, ("Push", 10), ("PushOk",)),
         ("invoke", 0, ("Push", 20)),
         ("invret", 1, ("Len",), ("LenOk", 1)),
         ("invret", 1, ("Pop",), ("PopOk", 20)),
         ("invret", 1, ("Pop",), ("PopOk", 10))],
        [(("Push", 10), ("PushOk",)), (("Len",), ("LenOk", 1)),
         (("Push", 20), ("PushOk",)), (("Pop",), ("PopOk", 20)),
         (("Pop",), ("PopOk", 10))]),
    "lin vec len two": (
        "LinearizabilityTester", "VecSpec", None,
        [("invret", 0, ("Push", 10), ("PushOk",)), ("invoke", 1, ("Len",)),
         ("invoke", 0, ("Push", 20)), ("return", 1, ("LenOk", 2))],
        [(("Push", 10), ("PushOk",)), (("Push", 20), ("PushOk",)),
         (("Len",), ("LenOk", 2))]),
    "lin vec sc only": (
        "LinearizabilityTester", "VecSpec", None,
        [("invret", 0, ("Push", 10), ("PushOk",)),
         ("invret", 1, ("Pop",), ("PopOk", None))], None),
    "lin vec len zero": (
        "LinearizabilityTester", "VecSpec", None,
        [("invret", 0, ("Push", 10), ("PushOk",)), ("invoke", 1, ("Len",)),
         ("invoke", 0, ("Push", 20)), ("return", 1, ("LenOk", 0))], None),
    "lin vec pops out of order": (
        "LinearizabilityTester", "VecSpec", None,
        [("invret", 0, ("Push", 10), ("PushOk",)),
         ("invoke", 0, ("Push", 20)),
         ("invret", 1, ("Len",), ("LenOk", 2)),
         ("invret", 1, ("Pop",), ("PopOk", 10)),
         ("invret", 1, ("Pop",), ("PopOk", 20))], None),
    "sc register": (
        "SequentialConsistencyTester", "Register", "A",
        [("invret", 0, R, ("ReadOk", "B")), ("invoke", 1, ("Write", "B"))],
        [(("Write", "B"), WO), (R, ("ReadOk", "B"))]),
    "sc vec": (
        "SequentialConsistencyTester", "VecSpec", None,
        [("invret", 0, ("Push", 10), ("PushOk",)),
         ("invret", 1, ("Pop",), ("PopOk", None))],
        [(("Pop",), ("PopOk", None)), (("Push", 10), ("PushOk",))]),
    "sc register bad read": (
        "SequentialConsistencyTester", "Register", "A",
        [("invret", 0, R, ("ReadOk", "B"))], None),
    "sc vec three threads": (
        "SequentialConsistencyTester", "VecSpec", None,
        [("invret", 0, ("Push", 1), ("PushOk",)),
         ("invret", 1, ("Push", 2), ("PushOk",)),
         ("invret", 2, ("Pop",), ("PopOk", 1)),
         ("invret", 2, ("Len",), ("LenOk", 1)),
         ("invoke", 0, ("Pop",))],
        [(("Push", 1), ("PushOk",)), (("Pop",), ("PopOk", 1)),
         (("Pop",), ("PopOk", None)), (("Push", 2), ("PushOk",)),
         (("Len",), ("LenOk", 1))]),
}


def _value(pkg, spec):
    name, *args = spec
    return getattr(pkg, name)(*args)


def _play(pkg, tester, spec, arg, steps):
    t = getattr(pkg, tester)(getattr(pkg, spec)(
        *(() if arg is None else (arg,))))
    for kind, thread, *rest in steps:
        values = [_value(pkg, v) for v in rest]
        getattr(t, {"invoke": "on_invoke", "return": "on_return",
                    "invret": "on_invret"}[kind])(thread, *values)
    return t


@pytest.mark.parametrize("name", list(HISTORIES))
def test_tester_equals_jax(name):
    tester, spec, arg, steps, want = HISTORIES[name]
    ref = _play(ref_sem, tester, spec, arg, steps)
    got = _play(sem, tester, spec, arg, steps)
    assert repr(got.serialized_history()) == repr(ref.serialized_history())
    assert got.is_consistent() == ref.is_consistent() == (want is not None)
    if want is not None:
        assert got.serialized_history() == [
            (_value(sem, op), _value(sem, ret)) for op, ret in want]
    assert fingerprint(got) == ref_fingerprint(ref)
    assert repr(got) == repr(ref)


# -- tests/test_semantics.py, the port's arm (vec, SC, testers) ---------------


def test_vec_models_expected_semantics():
    v = sem.VecSpec(["A"])
    assert v.invoke(sem.Len()) == sem.LenOk(1)
    assert v.invoke(sem.Push("B")) == sem.PushOk()
    assert v.invoke(sem.Len()) == sem.LenOk(2)
    assert v.invoke(sem.Pop()) == sem.PopOk("B")
    assert v.invoke(sem.Pop()) == sem.PopOk("A")
    assert v.invoke(sem.Pop()) == sem.PopOk(None)


def test_vec_histories():
    Push, Pop, Len = sem.Push, sem.Pop, sem.Len
    PushOk, PopOk, LenOk = sem.PushOk, sem.PopOk, sem.LenOk
    assert sem.VecSpec().is_valid_history([])
    assert sem.VecSpec().is_valid_history([
        (Push(10), PushOk()), (Push(20), PushOk()), (Len(), LenOk(2)),
        (Pop(), PopOk(20)), (Len(), LenOk(1)), (Pop(), PopOk(10)),
        (Len(), LenOk(0)), (Pop(), PopOk(None))])
    assert not sem.VecSpec().is_valid_history([
        (Push(10), PushOk()), (Push(20), PushOk()), (Len(), LenOk(1)),
        (Push(30), PushOk())])
    assert not sem.VecSpec().is_valid_history([
        (Push(10), PushOk()), (Push(20), PushOk()), (Pop(), PopOk(10))])


def test_register_histories():
    Read, ReadOk, Write, WriteOk = sem.Read, sem.ReadOk, sem.Write, sem.WriteOk
    assert sem.Register("A").is_valid_history([
        (Read(), ReadOk("A")), (Write("B"), WriteOk()),
        (Read(), ReadOk("B"))])
    assert not sem.Register("A").is_valid_history([
        (Write("B"), WriteOk()), (Read(), ReadOk("A"))])


@pytest.mark.parametrize("tester", ["LinearizabilityTester",
                                    "SequentialConsistencyTester"])
def test_rejects_invalid_history(tester):
    cls = getattr(sem, tester)
    t = cls(sem.Register("A"))
    t.on_invoke(99, sem.Write("B"))
    with pytest.raises(ValueError, match="already has an operation"):
        t.on_invoke(99, sem.Write("C"))
    t = cls(sem.Register("A"))
    t.on_invret(99, sem.Write("B"), sem.WriteOk())
    t.on_invret(99, sem.Write("C"), sem.WriteOk())
    with pytest.raises(ValueError, match="no in-flight invocation"):
        t.on_return(99, sem.WriteOk())
    assert not t.is_consistent()


@pytest.mark.parametrize("tester", ["LinearizabilityTester",
                                    "SequentialConsistencyTester"])
def test_testers_are_cloneable_and_hashable(tester):
    t = getattr(sem, tester)(sem.Register("A"))
    t.on_invoke(0, sem.Write("B"))
    c = t.clone()
    assert t == c and hash(t) == hash(c)
    c.on_return(0, sem.WriteOk())
    assert t != c
    assert 0 in t.in_flight_by_thread


def test_testers_rewrite_their_threads_as_jax():
    """A symmetry plan renames a tester's actor-id threads
    (``__rewrite__``), as JAX's does."""
    from stateright_tpu.actor import Id as RefId
    from stateright_tpu.symmetry import RewritePlan as RefPlan
    from stateright_tpu.symmetry import rewrite_value as ref_rewrite
    from stateright_tpu_torch.actor import Id
    from stateright_tpu_torch.symmetry import RewritePlan, rewrite_value

    def tester(pkg, ident):
        t = pkg.SequentialConsistencyTester(pkg.VecSpec())
        t.on_invret(ident(1), pkg.Push(1), pkg.PushOk())
        t.on_invoke(ident(2), pkg.Pop())
        return t

    ref = ref_rewrite(tester(ref_sem, RefId), RefPlan([2, 0, 1]))
    got = rewrite_value(tester(sem, Id), RewritePlan([2, 0, 1]))
    assert repr(got) == repr(ref)
    assert fingerprint(got) == ref_fingerprint(ref)
    # reindex [2, 0, 1]: thread 1 becomes 2 and thread 2 becomes 0
    assert set(got.history_by_thread) == {Id(2), Id(0)}
    assert set(got.in_flight_by_thread) == {Id(0)}
