"""The port's host DFS engine and symmetry against the JAX package's.

The port's ``spawn_dfs()`` (``stateright_tpu_torch/dfs.py``, with
``symmetry()`` / ``symmetry_fn()`` through ``symmetry.py`` and the host
models' ``representative``) and JAX's (``checker/dfs.py`` on
``examples/`` and ``stateright_tpu/test_util.py``), one worker each: the
fingerprints the visited set holds are the same set (each the state's,
or with symmetry its representative's), and the counts, the discoveries,
each discovery path's fingerprint chain (``encode()``) and the reprs of
its states and actions are equal. Then the port arms of JAX's DFS tests:
``tests/test_checker_dfs.py``, the DFS half of
``tests/test_path_and_report.py``, the DFS and symmetry cases of
``tests/test_examples.py`` and the single-copy orbit gate of
``tests/test_paxos_symmetry.py``. Everything is integers and reprs: every
comparison is exact.
"""

import io
import os
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import increment as ref_inc  # noqa: E402
import increment_lock as ref_lock  # noqa: E402
import linearizable_register as ref_abd  # noqa: E402
import paxos as ref_paxos  # noqa: E402
import single_copy_register as ref_sc  # noqa: E402
import sliding_puzzle as ref_puzzle  # noqa: E402
import two_phase_commit as ref_2pc  # noqa: E402
from stateright_tpu import Model as RefModel  # noqa: E402
from stateright_tpu import Property as RefProperty  # noqa: E402
from stateright_tpu import test_util as ref_util  # noqa: E402
from stateright_tpu.actor.viewstamped import VsrCfg  # noqa: E402
from stateright_tpu_torch import Model, Property, test_util  # noqa: E402
from stateright_tpu_torch.dfs import DfsChecker  # noqa: E402
from stateright_tpu_torch.models.abd import AbdSys  # noqa: E402
from stateright_tpu_torch.models.increment import IncrementModel  # noqa: E402
from stateright_tpu_torch.models.increment_lock import (  # noqa: E402
    IncrementLockModel)
from stateright_tpu_torch.models.paxos import PaxosSys  # noqa: E402
from stateright_tpu_torch.models.single_copy import SingleCopySys  # noqa: E402,E501
from stateright_tpu_torch.models.sliding_puzzle import SlidingPuzzle  # noqa: E402,E501
from stateright_tpu_torch.models.twopc import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.models.vsr import VsrSys  # noqa: E402
from stateright_tpu_torch.visitor import PathRecorder, StateRecorder  # noqa: E402,E501


class _RefFullIncrement(ref_inc.IncrementModel):
    """JAX's increment with a property never met, so that a run goes to
    its end (``tests/test_examples.py::_FullIncrement``)."""

    def properties(self):
        return super().properties() + [
            RefProperty.sometimes("unreachable", lambda _m, _s: False)]


class _FullIncrement(IncrementModel):
    def properties(self):
        return super().properties() + [
            Property.sometimes("unreachable", lambda _m, _s: False)]


def _sys_pair():
    """JAX's and the port's ``Sys`` of ``tests/test_checker_dfs.py``: two
    processes, Loading -> Running <-> Paused, a representative that
    sorts them (the regression of ``dfs.rs:399-425``)."""
    from dataclasses import dataclass
    from typing import Tuple

    nxt = {"Loading": "Running", "Running": "Paused", "Paused": "Running"}

    def build(model_cls, prop_cls):
        @dataclass(frozen=True)
        class SysState:
            procs: Tuple[str, ...]

            def representative(self):
                return SysState(tuple(sorted(self.procs)))

        class Sys(model_cls):
            def init_states(self):
                return [SysState(("Loading", "Loading"))]

            def actions(self, state, actions):
                actions.extend([0, 1])

            def next_state(self, state, action):
                procs = list(state.procs)
                procs[action] = nxt[procs[action]]
                return SysState(tuple(procs))

            def properties(self):
                return [prop_cls.always("visit all states",
                                        lambda _, s: True),
                        prop_cls.sometimes("a process pauses",
                                           lambda _, s: "Paused" in s.procs)]

        return Sys()

    return build(RefModel, RefProperty), build(Model, Property)


def _sc_host_rep(model):
    return model.checker().symmetry_fn(model.device_model()
                                       .host_representative)


#: each case's JAX and port builders (a fresh model's ``checker()``,
#: configured); all run one worker
CASES = {
    "linear equation": (
        lambda: ref_util.LinearEquation(2, 10, 14).checker(),
        lambda: test_util.LinearEquation(2, 10, 14).checker()),
    "2pc 5": (lambda: ref_2pc.TwoPhaseSys(5).checker(),
              lambda: TwoPhaseSys(5).checker()),
    "2pc 5 symmetry": (lambda: ref_2pc.TwoPhaseSys(5).checker().symmetry(),
                       lambda: TwoPhaseSys(5).checker().symmetry()),
    "increment 2": (lambda: ref_inc.IncrementModel(2).checker(),
                    lambda: IncrementModel(2).checker()),
    "increment 2 symmetry": (
        lambda: ref_inc.IncrementModel(2).checker().symmetry(),
        lambda: IncrementModel(2).checker().symmetry()),
    "full increment 2": (lambda: _RefFullIncrement(2).checker(),
                         lambda: _FullIncrement(2).checker()),
    "full increment 2 symmetry": (
        lambda: _RefFullIncrement(2).checker().symmetry(),
        lambda: _FullIncrement(2).checker().symmetry()),
    "increment_lock 2": (lambda: ref_lock.IncrementLockModel(2).checker(),
                         lambda: IncrementLockModel(2).checker()),
    "increment_lock 3 symmetry": (
        lambda: ref_lock.IncrementLockModel(3).checker().symmetry(),
        lambda: IncrementLockModel(3).checker().symmetry()),
    "puzzle 2x3": (lambda: ref_puzzle.SlidingPuzzle(2, 3).checker(),
                   lambda: SlidingPuzzle(2, 3).checker()),
    "vsr 2/1": (lambda: VsrCfg(2, 1).into_model().checker(),
                lambda: VsrSys(2, 1).checker()),
    "single-copy 2/1": (
        lambda: ref_sc.SingleCopyModelCfg(2, 1).into_model().checker(),
        lambda: SingleCopySys(2, 1).checker()),
    "single-copy 2/1 host_representative": (
        lambda: _sc_host_rep(ref_sc.SingleCopyModelCfg(2, 1).into_model()),
        lambda: _sc_host_rep(SingleCopySys(2, 1))),
    "single-copy 2/1 symmetry": (
        lambda: ref_sc.SingleCopyModelCfg(2, 1).into_model().checker()
        .symmetry(),
        lambda: SingleCopySys(2, 1).checker().symmetry()),
    "single-copy 2/2": (
        lambda: ref_sc.SingleCopyModelCfg(2, 2).into_model().checker(),
        lambda: SingleCopySys(2, 2).checker()),
    "abd 2/2": (lambda: ref_abd.AbdModelCfg(2, 2).into_model().checker(),
                lambda: AbdSys(2, 2).checker()),
    "paxos 1/3 symmetry": (
        lambda: ref_paxos.PaxosModelCfg(1, 3).into_model().checker()
        .symmetry(),
        lambda: PaxosSys(1).checker().symmetry()),
    "sys symmetry": (lambda: _sys_pair()[0].checker().symmetry(),
                     lambda: _sys_pair()[1].checker().symmetry()),
}

#: the unique counts the reference's and JAX's tests hold
COUNTS = {"linear equation": 55, "2pc 5": 8_832, "2pc 5 symmetry": 665,
          "full increment 2": 13, "full increment 2 symmetry": 8,
          "single-copy 2/1": 93, "single-copy 2/1 host_representative": 47,
          "abd 2/2": 544, "vsr 2/1": 63, "puzzle 2x3": 360,
          "increment_lock 2": 17, "sys symmetry": 6}


def _summary(c):
    """Counts and, for each discovery, its chain and reprs."""
    return (c.state_count(), c.unique_state_count(),
            {name: (p.encode(), [repr(s) for s in p.into_states()],
                    [repr(a) for a in p.into_actions()])
             for name, p in c.discoveries().items()})


@pytest.mark.parametrize("case", list(CASES))
def test_dfs_equals_jax(case):
    ref_build, build = CASES[case]
    ref = ref_build().spawn_dfs().join()
    got = build().spawn_dfs().join()
    assert type(got) is DfsChecker
    assert got._generated == ref._generated
    assert _summary(got) == _summary(ref)
    assert got.is_done() == ref.is_done()
    if case in COUNTS:
        assert got.unique_state_count() == COUNTS[case]


def test_threads_parity_on_2pc_4():
    """Four workers enumerate 2pc 4 to JAX's one-worker counts."""
    ref = ref_2pc.TwoPhaseSys(4).checker().spawn_dfs().join()
    got = TwoPhaseSys(4).checker().threads(4).spawn_dfs().join()
    assert got.is_done()
    assert got._generated == ref._generated
    assert ((got.state_count(), got.unique_state_count())
            == (ref.state_count(), ref.unique_state_count()) == (8258, 1568))
    got.assert_properties()


# -- tests/test_checker_dfs.py, the port's arm --------------------------------


def test_visits_states_in_dfs_order():
    recorder, accessor = StateRecorder.new_with_accessor()
    (test_util.LinearEquation(2, 10, 14).checker().visitor(recorder)
     .spawn_dfs().join())
    assert accessor() == [(0, y) for y in range(28)]


@pytest.mark.slow
def test_can_complete_by_enumerating_all_states():
    checker = test_util.LinearEquation(2, 4, 7).checker().spawn_dfs().join()
    assert checker.is_done()
    checker.assert_no_discovery("solvable")
    assert checker.unique_state_count() == 256 * 256


def test_can_complete_by_eliminating_properties():
    checker = test_util.LinearEquation(2, 10, 14).checker().spawn_dfs().join()
    checker.assert_properties()
    assert checker.unique_state_count() == 55
    Guess = test_util.Guess
    assert checker.discovery("solvable").into_actions() == (
        [Guess.INCREASE_Y] * 27)
    checker.assert_discovery("solvable", [
        Guess.INCREASE_X, Guess.INCREASE_Y, Guess.INCREASE_X])


def test_exact_state_counts_on_early_exit():
    checker = test_util.LinearEquation(2, 10, 14).checker().spawn_dfs().join()
    assert (checker.state_count(), checker.unique_state_count()) == (55, 55)


def test_can_apply_symmetry_reduction():
    """9 states without symmetry on either host engine, 6 with it on the
    DFS, and every visited path replays (``PathRecorder`` rebuilds each
    one, which a path through a canonical member would break)."""
    model = _sys_pair()[1]
    assert model.checker().spawn_dfs().join().unique_state_count() == 9
    assert model.checker().spawn_bfs().join().unique_state_count() == 9
    visitor, paths = PathRecorder.new_with_accessor()
    checker = model.checker().symmetry().visitor(visitor).spawn_dfs().join()
    assert checker.unique_state_count() == 6
    assert len(paths()) == 6


# -- tests/test_path_and_report.py, the port's arm (the DFS half) --------------


def test_report_includes_property_names_and_paths():
    w = io.StringIO()
    (test_util.LinearEquation(2, 10, 14).checker().spawn_dfs().join()
     .report(w))
    output = w.getvalue()
    assert output.startswith("Done. states=55, unique=55, sec="), output
    assert output.endswith(
        'Discovered "solvable" example Path[27]:\n'
        + "- INCREASE_Y\n" * 27), output


# -- tests/test_examples.py, the port's arm (DFS and symmetry cases) -----------


def test_can_model_2pc():
    checker = TwoPhaseSys(5).checker().spawn_dfs().join()
    assert checker.unique_state_count() == 8832
    checker.assert_properties()
    checker = TwoPhaseSys(5).checker().symmetry().spawn_dfs().join()
    assert checker.unique_state_count() == 665
    checker.assert_properties()


def test_increment_finds_race():
    for builder in (IncrementModel(2).checker(),
                    IncrementModel(2).checker().symmetry()):
        assert builder.spawn_dfs().join().discovery("fin") is not None


def test_increment_exact_counts():
    checker = _FullIncrement(2).checker().spawn_bfs().join()
    assert checker.unique_state_count() == 13
    assert checker.discovery("fin") is not None
    checker = _FullIncrement(2).checker().symmetry().spawn_dfs().join()
    assert checker.unique_state_count() == 8


def test_increment_lock_holds():
    IncrementLockModel(2).checker().spawn_dfs().join().assert_properties()


def test_can_model_single_copy_register():
    checker = SingleCopySys(2, 1).checker().spawn_dfs().join()
    checker.assert_properties()
    assert checker.unique_state_count() == 93


def test_can_model_linearizable_register():
    for spawn in ("spawn_bfs", "spawn_dfs"):
        checker = getattr(AbdSys(2, 2).checker(), spawn)().join()
        checker.assert_properties()
        assert checker.unique_state_count() == 544


@pytest.mark.slow
def test_can_model_paxos():
    for spawn in ("spawn_bfs", "spawn_dfs"):
        checker = getattr(PaxosSys(2).checker(), spawn)().join()
        checker.assert_properties()
        assert checker.unique_state_count() == 16_668


# -- tests/test_paxos_symmetry.py, the port's arm -----------------------------


def test_single_copy_symmetry_47_orbits():
    """47 orbits of single-copy 2/1's 93 states, on the host DFS with the
    host representative and on the fused engine with the device one
    (the CPU here; the card in ``chip_smoke.py``)."""
    model = SingleCopySys(2, 1)
    host = _sc_host_rep(model).spawn_dfs().join()
    dev = model.checker().symmetry().spawn_cuda_bfs(
        device="cpu", wave_kernel=True).join()
    assert host.unique_state_count() == dev.unique_state_count() == 47
    host.assert_properties()
