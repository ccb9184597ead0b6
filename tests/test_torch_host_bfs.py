"""The port's host BFS engine against the JAX package's.

The port's ``spawn_bfs()`` (``stateright_tpu_torch/bfs.py`` on the host
models of ``models/`` and ``test_util.py``) and JAX's (``checker/bfs.py``
on ``examples/`` and ``stateright_tpu/test_util.py``), one worker each:
the host fingerprints of every state generated are the same set (a port
state has JAX's classes' names and fields, so it has JAX's fingerprint),
and the counts, the discoveries, each discovery path's fingerprint chain
(``encode()``) and the reprs of its states and actions are equal. Then
the port arms of JAX's host-engine tests: ``tests/test_checker_bfs.py``,
the host cases of ``tests/test_path_and_report.py`` and the ping-pong and
``ActorModel`` cases of ``tests/test_actor_model.py``. Everything is
integers and reprs: every comparison is exact.
"""

import io
import os
import sys
import threading

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import linearizable_register as ref_abd  # noqa: E402
import paxos as ref_paxos  # noqa: E402
import single_copy_register as ref_sc  # noqa: E402
import two_phase_commit as ref_2pc  # noqa: E402
from stateright_tpu import Property as RefProperty  # noqa: E402
from stateright_tpu import test_util as ref_util  # noqa: E402
from stateright_tpu.actor.actor_test_util import PingPongCfg  # noqa: E402
from stateright_tpu_torch import Expectation, Model, Property  # noqa: E402
from stateright_tpu_torch import test_util  # noqa: E402
from stateright_tpu_torch.actor import (ActorModel, ActorModelState,  # noqa: E402,E501
                                        DropAction, Envelope, Id, Network)
from stateright_tpu_torch.bfs import BfsChecker  # noqa: E402
from stateright_tpu_torch.fingerprint import fingerprint  # noqa: E402
from stateright_tpu_torch.models.abd import AbdSys  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosSys  # noqa: E402
from stateright_tpu_torch.models.pingpong import Ping, PingPongSys, Pong  # noqa: E402,E501
from stateright_tpu_torch.models.single_copy import SingleCopySys  # noqa: E402,E501
from stateright_tpu_torch.models.twopc import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.path import NondeterminismError, Path  # noqa: E402
from stateright_tpu_torch.visitor import StateRecorder  # noqa: E402


def _graph(util, prop_cls):
    """A small graph with cycles, a join and terminal nodes, under an
    eventually property, built by either package's ``DGraph``."""
    prop = prop_cls.eventually("odd", lambda _, s: s % 2 == 1)
    return (util.DGraph.with_property(prop).with_path([0, 2, 4])
            .with_path([0, 1, 3]).with_path([2, 6, 2]).with_path([4, 8])
            .with_path([5, 6]))


def _fn(prev, out):
    if prev is None:
        out += [0, 1]
    else:
        out += [(prev * 2) % 7, (prev + 3) % 7]


#: each case's JAX and port models, built afresh; the first six also
#: hold the host fingerprint sets
CASES = {
    "2pc 3": (lambda: ref_2pc.TwoPhaseSys(3), lambda: TwoPhaseSys(3)),
    "paxos 1/3": (lambda: ref_paxos.PaxosModelCfg(1, 3).into_model(),
                  lambda: PaxosSys(1)),
    "single-copy 2/1": (lambda: ref_sc.SingleCopyModelCfg(2, 1).into_model(),
                        lambda: SingleCopySys(2, 1)),
    "abd 2/2": (lambda: ref_abd.AbdModelCfg(2, 2).into_model(),
                lambda: AbdSys(2, 2)),
    "ping-pong 3 lossy": (
        lambda: PingPongCfg(maintains_history=False, max_nat=3)
        .into_model().with_lossy_network(True),
        lambda: PingPongSys(3, lossy=True)),
    "ping-pong 2 lossy history": (
        lambda: PingPongCfg(maintains_history=True, max_nat=2)
        .into_model().with_lossy_network(True),
        lambda: PingPongSys(2, maintains_history=True, lossy=True)),
    "single-copy 2/2": (lambda: ref_sc.SingleCopyModelCfg(2, 2).into_model(),
                        lambda: SingleCopySys(2, 2)),
    "binary clock": (ref_util.BinaryClock, test_util.BinaryClock),
    "fn model": (lambda: ref_util.FnModel(_fn),
                 lambda: test_util.FnModel(_fn)),
    "dgraph": (lambda: _graph(ref_util, RefProperty),
               lambda: _graph(test_util, Property)),
    "linear equation": (lambda: ref_util.LinearEquation(2, 10, 14),
                        lambda: test_util.LinearEquation(2, 10, 14)),
}
FP_CASES = list(CASES)[:6]


def _summary(c):
    """Counts and, for each discovery, its chain and reprs."""
    return (c.state_count(), c.unique_state_count(),
            {name: (p.encode(), [repr(s) for s in p.into_states()],
                    [repr(a) for a in p.into_actions()])
             for name, p in c.discoveries().items()})


def _both(case):
    ref_build, build = CASES[case]
    ref = ref_build().checker().spawn_bfs().join()
    got = build().checker().spawn_bfs().join()
    assert type(got) is BfsChecker
    return ref, got


@pytest.mark.parametrize("case", FP_CASES)
def test_host_fingerprints_equal_jax(case):
    ref, got = _both(case)
    assert set(got._generated) == set(ref._generated)
    assert got._generated == ref._generated  # the parent links too


@pytest.mark.parametrize("case", list(CASES))
def test_counts_and_discoveries_equal_jax(case):
    ref, got = _both(case)
    assert _summary(got) == _summary(ref)
    assert got.is_done() == ref.is_done()


def test_linearizability_verdicts_equal_jax():
    """``is_consistent`` and ``serialized_history`` on the history of
    every state single-copy 2/2 visits (its "linearizable"
    counterexample among them), in JAX's visit order."""
    from stateright_tpu import StateRecorder as RefRecorder

    verdicts = []
    for recorder_cls, build in ((RefRecorder, CASES["single-copy 2/2"][0]),
                                (StateRecorder,
                                 CASES["single-copy 2/2"][1])):
        recorder, states = recorder_cls.new_with_accessor()
        build().checker().visitor(recorder).spawn_bfs().join()
        verdicts.append([(s.history.is_consistent(),
                          repr(s.history.serialized_history()))
                         for s in states()])
    assert verdicts[0] == verdicts[1]
    assert (False, "None") in verdicts[1]


def test_the_gate_counts():
    """2pc 3 and paxos 1 on the host: JAX's and the device engines'."""
    for build, want in ((lambda: TwoPhaseSys(3), (1146, 288)),
                        (lambda: PaxosSys(1), (482, 265))):
        c = build().checker().spawn_bfs().join()
        assert (c.state_count(), c.unique_state_count()) == want
        c.assert_properties()


def test_device_only_models_refuse_with_their_roadmap_item():
    from stateright_tpu_torch.models.increment import IncrementModel
    from stateright_tpu_torch.models.vsr import VsrSys

    for model in (VsrSys(2, 1), IncrementModel(2)):
        with pytest.raises(NotImplementedError, match="ROADMAP A16"):
            model.checker().spawn_bfs()
    with pytest.raises(NotImplementedError, match="no host transition"):
        Model().checker().spawn_bfs()


# -- tests/test_checker_bfs.py, the port's arm -------------------------------


def test_visits_states_in_bfs_order():
    recorder, accessor = StateRecorder.new_with_accessor()
    (test_util.LinearEquation(2, 10, 14).checker().visitor(recorder)
     .spawn_bfs().join())
    assert accessor() == [
        (0, 0),
        (1, 0), (0, 1),
        (2, 0), (1, 1), (0, 2),
        (3, 0), (2, 1),
    ]


def test_can_complete_by_enumerating_all_states():
    checker = test_util.LinearEquation(2, 4, 7).checker().spawn_bfs().join()
    assert checker.is_done()
    checker.assert_no_discovery("solvable")
    assert checker.unique_state_count() == 256 * 256


def test_can_complete_by_eliminating_properties():
    checker = test_util.LinearEquation(2, 10, 14).checker().spawn_bfs().join()
    checker.assert_properties()
    assert checker.unique_state_count() == 12
    Guess = test_util.Guess
    assert checker.discovery("solvable").into_actions() == [
        Guess.INCREASE_X, Guess.INCREASE_X, Guess.INCREASE_Y]
    checker.assert_discovery("solvable", [Guess.INCREASE_Y] * 27)


def test_exact_state_counts_on_early_exit():
    checker = test_util.LinearEquation(2, 10, 14).checker().spawn_bfs().join()
    assert checker.state_count() == 15
    assert checker.unique_state_count() == 12


def test_multithreaded_parity():
    checker = (test_util.LinearEquation(2, 4, 7).checker().threads(4)
               .spawn_bfs().join())
    assert checker.unique_state_count() == 256 * 256
    checker.assert_no_discovery("solvable")


def test_many_workers_with_frequent_switches():
    """More workers than cores, switching threads every 10 us: the
    visited map loses no state, every state is expanded, and ``join()``
    returns."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        checker = (test_util.LinearEquation(2, 4, 7).checker()
                   .threads(2 * (os.cpu_count() or 4)).spawn_bfs())
        joiner = threading.Thread(target=checker.join, daemon=True)
        joiner.start()
        joiner.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not joiner.is_alive()
    assert checker.is_done()
    assert checker.unique_state_count() == 256 * 256
    assert checker.state_count() >= 2 * 256 * 256 + 1
    checker.assert_no_discovery("solvable")


# -- tests/test_path_and_report.py, the port's arm (host cases) ----------------


def test_can_build_path_from_fingerprints():
    model = test_util.LinearEquation(2, 10, 14)
    fps = [fingerprint((0, 0)), fingerprint((0, 1)),
           fingerprint((1, 1)), fingerprint((2, 1))]
    path = Path.from_fingerprints(model, fps)
    assert path.last_state() == (2, 1)
    assert path.last_state() == Path.final_state(model, fps)


def test_raises_if_unable_to_reconstruct_init_state():
    def fn(prev_state, next_states):
        if prev_state is None:
            next_states.append("UNEXPECTED")

    with pytest.raises(NondeterminismError, match="No\ninit state"):
        Path.from_fingerprints(test_util.FnModel(fn),
                               [fingerprint("expected")])


def test_raises_if_unable_to_reconstruct_next_state():
    def fn(prev_state, next_states):
        if prev_state is None:
            next_states.append("expected")
        else:
            next_states.append("UNEXPECTED")

    with pytest.raises(NondeterminismError, match="no subsequent state"):
        Path.from_fingerprints(test_util.FnModel(fn),
                               [fingerprint("expected")] * 2)


def test_report_includes_property_names_and_paths():
    w = io.StringIO()
    (test_util.LinearEquation(2, 10, 14).checker().spawn_bfs().join()
     .report(w))
    output = w.getvalue()
    assert output.startswith("Done. states=15, unique=12, sec="), output
    assert output.endswith(
        'Discovered "solvable" example Path[3]:\n'
        "- INCREASE_X\n"
        "- INCREASE_X\n"
        "- INCREASE_Y\n"), output


def test_path_accessors():
    model = test_util.LinearEquation(2, 10, 14)
    fps = [fingerprint((0, 0)), fingerprint((1, 0))]
    path = Path.from_fingerprints(model, fps)
    assert len(path) == 2
    assert path.into_states() == [(0, 0), (1, 0)]
    assert len(path.into_actions()) == 1
    assert path.encode() == f"{fingerprint((0, 0))}/{fingerprint((1, 0))}"
    assert path.into_vec()[-1][1] is None


def test_path_from_actions_rejects_bad_input():
    model = test_util.LinearEquation(2, 10, 14)
    Guess = test_util.Guess
    assert Path.from_actions(model, (5, 5), [Guess.INCREASE_X]) is None
    ok = Path.from_actions(model, (0, 0), [Guess.INCREASE_X])
    assert ok is not None and ok.last_state() == (1, 0)


def test_target_state_count():
    checker = (test_util.LinearEquation(2, 4, 7).checker()
               .target_state_count(100).spawn_bfs().join())
    assert checker.state_count() >= 100
    assert not checker.is_done()


def test_target_state_count_multithreaded_join_terminates():
    """A worker that stops at the target releases the parked ones, or
    ``join()`` would hang (a chain: no work is ever shared)."""

    class Chain(Model):
        def init_states(self):
            return [0]

        def actions(self, s, a):
            a.append("step")

        def next_state(self, s, a):
            return s + 1

        def properties(self):
            return [Property.sometimes("never", lambda m, s: False)]

    checker = (Chain().checker().threads(2)
               .target_state_count(10).spawn_bfs().join())
    assert checker.state_count() >= 10
    assert not checker.is_done()


# -- tests/test_actor_model.py, the port's arm (ping-pong, ActorModel) ---------


def _states_and_network(states, envelopes):
    return ActorModelState(actor_states=list(states),
                           network=Network.from_iter(envelopes),
                           is_timer_set=[], history=(0, 0))


def test_visits_expected_states():
    recorder, accessor = StateRecorder.new_with_accessor()
    checker = (PingPongSys(1, lossy=True).checker().visitor(recorder)
               .spawn_bfs().join())
    assert checker.unique_state_count() == 14
    state_space = accessor()
    assert len(state_space) == 14
    e01_ping0 = Envelope(Id(0), Id(1), Ping(0))
    e10_pong0 = Envelope(Id(1), Id(0), Pong(0))
    e01_ping1 = Envelope(Id(0), Id(1), Ping(1))
    expected = [
        _states_and_network([0, 0], [e01_ping0]),
        _states_and_network([0, 1], [e01_ping0, e10_pong0]),
        _states_and_network([1, 1], [e01_ping0, e10_pong0, e01_ping1]),
        _states_and_network([0, 0], []),
        _states_and_network([0, 1], [e10_pong0]),
        _states_and_network([0, 1], [e01_ping0]),
        _states_and_network([0, 1], []),
        _states_and_network([1, 1], [e10_pong0, e01_ping1]),
        _states_and_network([1, 1], [e01_ping0, e01_ping1]),
        _states_and_network([1, 1], [e01_ping0, e10_pong0]),
        _states_and_network([1, 1], [e01_ping1]),
        _states_and_network([1, 1], [e10_pong0]),
        _states_and_network([1, 1], [e01_ping0]),
        _states_and_network([1, 1], []),
    ]
    assert set(state_space) == set(expected)


def test_maintains_fixed_delta_despite_lossy_duplicating_network():
    checker = PingPongSys(5, lossy=True).checker().spawn_bfs().join()
    assert checker.unique_state_count() == 4094
    checker.assert_no_discovery("delta within 1")
    # can lose the first message and get stuck, for example
    checker.assert_discovery("must reach max", [
        DropAction(Envelope(Id(0), Id(1), Ping(0)))])


@pytest.mark.parametrize("name, last", [("must reach max", None),
                                        ("can reach max", [4, 5]),
                                        ("must exceed max", [5, 5])])
def test_perfect_delivery_network(name, last):
    """``max_nat`` 5 on a network that neither loses nor duplicates:
    "must reach max" holds, "can reach max" reaches [4, 5], and "must
    exceed max" fails at [5, 5] (the boundary)."""
    checker = (PingPongSys(5, duplicating=False).checker().spawn_bfs()
               .join())
    assert checker.unique_state_count() == 11
    if last is None:
        checker.assert_no_discovery(name)
    else:
        assert checker.discovery(name).last_state().actor_states == last


def test_history_properties():
    checker = (PingPongSys(3, maintains_history=True).checker().spawn_bfs()
               .join())
    checker.assert_no_discovery("#in <= #out")
    checker.assert_no_discovery("#out <= #in + 1")


def test_handles_undeliverable_messages_and_resets_timers():
    from stateright_tpu_torch.actor import Actor

    class Noop(Actor):
        def on_start(self, id, o):
            return ()

    class Timer(Actor):
        def on_start(self, id, o):
            o.set_timer((0.0, 0.0))
            return ()

    checker = (ActorModel().actor(Noop())
               .property(Expectation.ALWAYS, "unused", lambda _, __: True)
               .with_init_network([Envelope(Id(0), Id(99), ())])
               .checker().spawn_bfs().join())
    assert checker.unique_state_count() == 1
    checker = (ActorModel().actor(Timer())
               .property(Expectation.ALWAYS, "unused", lambda _, __: True)
               .checker().spawn_bfs().join())
    assert checker.unique_state_count() == 2
