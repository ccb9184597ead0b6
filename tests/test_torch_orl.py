"""The port's ordered reliable link and ``Choice`` against JAX's.

``ActorWrapper`` and ``Choice`` of ``stateright_tpu_torch/actor.py`` and
JAX's ``actor/ordered_reliable_link.py`` and ``actor/choice.py``: the
same systems on each package's host engines give the same fingerprint
sets, counts, discoveries and discovery chains; then the port's arms of
``tests/test_ordered_reliable_link.py`` (after the reference's
``ordered_reliable_link.rs:141-236``, the "delivered" discovery's exact
actions among them) and the ``Choice`` cases of
``tests/test_choice_and_hashable.py``. Every comparison is exact.
"""

from dataclasses import dataclass

import pytest

import stateright_tpu.actor as ref_actor
from stateright_tpu import Expectation as RefExpectation
from stateright_tpu.actor.ordered_reliable_link import (
    ActorWrapper as RefWrapper)
from stateright_tpu_torch import Expectation
from stateright_tpu_torch import actor
from stateright_tpu_torch.fingerprint import fingerprint


@dataclass(frozen=True)
class OrlTestMsg:
    value: int

    def __repr__(self):
        return f"OrlTestMsg({self.value})"


def _orl_model(pkg, wrapper, expectation):
    """Two wrapped actors: the sender sends 42 and 43 on start, the
    receiver records what it gets, on a lossy duplicating network."""

    class Sender(pkg.Actor):
        def on_start(self, id, o):
            o.send(pkg.Id(1), OrlTestMsg(42))
            o.send(pkg.Id(1), OrlTestMsg(43))
            return ()

        def on_msg(self, id, state, src, msg, o):
            return state + ((src, msg),)

    class Receiver(pkg.Actor):
        def on_start(self, id, o):
            return ()

        def on_msg(self, id, state, src, msg, o):
            return state + ((src, msg),)

    def received(state):
        return state.actor_states[1].wrapped_state

    def values(state):
        return [m.value for _, m in received(state)]

    return (pkg.ActorModel(cfg=None, init_history=None)
            .actor(wrapper(Sender()))
            .actor(wrapper(Receiver()))
            .with_duplicating_network(True)
            .with_lossy_network(True)
            .property(expectation.ALWAYS, "no redelivery", lambda _, s:
                      values(s).count(42) < 2 and values(s).count(43) < 2)
            .property(expectation.ALWAYS, "ordered", lambda _, s:
                      values(s) == sorted(values(s)))
            .property(expectation.SOMETIMES, "delivered", lambda _, s:
                      received(s) == ((pkg.Id(0), OrlTestMsg(42)),
                                      (pkg.Id(0), OrlTestMsg(43))))
            .with_boundary(lambda _, s: all(
                len(a.wrapped_state) < 4 for a in s.actor_states)))


def _bouncer(pkg, starter: bool, limit: int = 2):
    """An actor that replies to any message with its count, then counts,
    up to ``limit``; the starter kicks the exchange off
    (``tests/test_choice_and_hashable.py``'s ``Bouncer`` and
    ``Starter``)."""

    class Bouncer(pkg.Actor):
        def on_start(self, id, o):
            if starter:
                o.send(pkg.Id(1), ("go", 0))
            return 0

        def on_msg(self, id, state, src, msg, o):
            if state >= limit:
                return None
            o.send(src, ("ack", state))
            return state + 1

    return Bouncer()


def _choice_model(pkg, expectation):
    return (pkg.ActorModel()
            .with_actors([pkg.Choice(0, _bouncer(pkg, True)),
                          pkg.Choice(1, _bouncer(pkg, False))])
            .with_duplicating_network(False)
            .property(expectation.SOMETIMES, "exchange",
                      lambda m, s: any(st.state >= 2
                                       for st in s.actor_states)))


SYSTEMS = {
    "orl": (lambda: _orl_model(ref_actor, RefWrapper, RefExpectation),
            lambda: _orl_model(actor, actor.ActorWrapper, Expectation)),
    "choice": (lambda: _choice_model(ref_actor, RefExpectation),
               lambda: _choice_model(actor, Expectation)),
}


def _summary(c):
    return (c.state_count(), c.unique_state_count(),
            {name: (p.encode(), [repr(s) for s in p.into_states()],
                    [repr(a) for a in p.into_actions()])
             for name, p in c.discoveries().items()})


@pytest.mark.parametrize("spawn", ["spawn_bfs", "spawn_dfs"])
@pytest.mark.parametrize("system", list(SYSTEMS))
def test_system_equals_jax(system, spawn):
    ref_build, build = SYSTEMS[system]
    ref = getattr(ref_build().checker(), spawn)().join()
    got = getattr(build().checker(), spawn)().join()
    assert set(got._generated) == set(ref._generated)
    assert _summary(got) == _summary(ref)


# -- tests/test_ordered_reliable_link.py, the port's arm ----------------------


def _orl():
    return _orl_model(actor, actor.ActorWrapper, Expectation)


def test_messages_are_not_delivered_twice():
    _orl().checker().spawn_bfs().join().assert_no_discovery("no redelivery")


def test_messages_are_delivered_in_order():
    _orl().checker().spawn_bfs().join().assert_no_discovery("ordered")


def test_messages_are_eventually_delivered():
    checker = _orl().checker().spawn_bfs().join()
    checker.assert_discovery("delivered", [
        actor.DeliverAction(src=actor.Id(0), dst=actor.Id(1),
                            msg=actor.OrlDeliver(1, OrlTestMsg(42))),
        actor.DeliverAction(src=actor.Id(0), dst=actor.Id(1),
                            msg=actor.OrlDeliver(2, OrlTestMsg(43))),
    ])


def test_inner_timers_are_refused():
    class Timed(actor.Actor):
        def on_start(self, id, o):
            o.set_timer((0.0, 0.0))
            return 0

    with pytest.raises(NotImplementedError, match="inner timers"):
        actor.ActorWrapper(Timed()).on_start(actor.Id(0), actor.Out())


# -- tests/test_choice_and_hashable.py, the port's arm (Choice) ----------------


def test_choice_runs_under_checker():
    checker = _choice_model(actor, Expectation).checker().spawn_bfs().join()
    checker.assert_properties()
    final = checker.discovery("exchange").last_state()
    assert all(isinstance(s, actor.ChoiceState) for s in final.actor_states)
    assert [s.index for s in final.actor_states] == [0, 1]


def test_choice_variants_with_equal_inner_states_stay_distinct():
    ChoiceState = actor.ChoiceState
    assert ChoiceState(0, 7) != ChoiceState(1, 7)
    assert fingerprint(ChoiceState(0, 7)) != fingerprint(ChoiceState(1, 7))
    assert fingerprint(ChoiceState(0, 7)) == fingerprint(ChoiceState(0, 7))


def test_choice_rejects_mismatched_variant_state():
    c = actor.Choice(2, _bouncer(actor, False, 1))
    with pytest.raises(RuntimeError, match="variant"):
        c.on_msg(actor.Id(0), actor.ChoiceState(1, 0), actor.Id(1),
                 ("go", 0), actor.Out())
    with pytest.raises(ValueError, match="nonnegative"):
        actor.Choice(-1, _bouncer(actor, False))
