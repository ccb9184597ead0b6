"""Cooperative preemption of the port's engines against JAX's.

``preempt()`` (``tpu/engine.py:1874-1884``) on the classic engine (polled
at each wave boundary, ``engine.py:1300-1307``: the wave in flight is
processed, then the loop stops) and the fused engine (polled at each
dispatch boundary, ``fused.py:641-647``: the dispatches in flight retire
in the epilogue). Each is preempted at a fixed wave on both sides: the
classic engine by a visitor that calls ``preempt()`` at its 40th row,
the fused one after its second retired dispatch. The end-of-run
checkpoint equals JAX's preempted at the same wave section for section,
byte for byte (``pack_arena=True``, as ``test_torch_checkpoint.py``
compares), and resumes to the unpreempted run's counts and discovery
chains. The sharded engines do not poll, as in JAX.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import stateright_tpu.tpu  # noqa: F401,E402  (enables x64)
import paxos as ref_paxos  # noqa: E402
import two_phase_commit as ref_twopc  # noqa: E402
from stateright_tpu.tpu.fused import FusedTpuBfsChecker  # noqa: E402
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
from stateright_tpu_torch.fused import FusedCudaBfsChecker  # noqa: E402
from stateright_tpu_torch.models import twopc  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosSys  # noqa: E402

torch.set_num_threads(2)

#: a model's JAX and port twins and its whole run's (unique, states)
MODELS = {"2pc 4": (lambda: ref_twopc.TwoPhaseSys(4),
                    lambda: twopc.TwoPhaseSys(4), (1568, 8258)),
          "paxos 1": (lambda: ref_paxos.PaxosModelCfg(1, 3).into_model(),
                      lambda: PaxosSys(1), (265, 482))}
#: the knobs both sides run with
KNOBS = dict(batch_size=16, checkpoint_every_waves=1)
FUSED = dict(KNOBS, waves_per_dispatch=2, inflight_dispatches=1)


def _sections(path):
    with np.load(path) as data:
        return {k: (data[k].dtype, data[k].shape, data[k].tobytes())
                for k in data.files}


def _chains(c):
    return {k: (p.fingerprints if hasattr(p, "fingerprints") else [
        host_fp64(np.asarray(c._dm.encode(s), np.uint32))
        for s in p.into_states()]) for k, p in c.discoveries().items()}


def _preempting_visitor(at: int):
    """A visitor that calls its checker's ``preempt()`` at its ``at``-th
    row, and the hand-over of the checker (the worker waits for it)."""
    box, ready, seen = {}, threading.Event(), [0]

    def visit(model, path):
        ready.wait(timeout=60)
        seen[0] += 1
        if seen[0] == at:
            box["checker"].preempt()

    def hand(checker):
        box["checker"] = checker
        ready.set()
        return checker.join()

    return visit, hand


def _full(name):
    return MODELS[name][1]().checker().spawn_cuda_bfs(
        device="cpu", fused=False, **KNOBS).join()


@pytest.mark.parametrize("name", list(MODELS))
def test_classic_preempted_by_a_visitor_equals_jax(tmp_path, name):
    ref_cls, cls, full = MODELS[name]
    rp, p = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    visit, hand = _preempting_visitor(40)
    ref = hand(ref_cls().checker().visitor(visit).spawn_tpu_bfs(
        fused=False, pack_arena=True, checkpoint_path=rp, **KNOBS))
    visit, hand = _preempting_visitor(40)
    ours = hand(cls().checker().visitor(visit).spawn_cuda_bfs(
        device="cpu", fused=False, checkpoint_path=p, **KNOBS))
    assert ref.preempted and ours.preempted
    assert len(ours.dispatch_log) == len(ref.dispatch_log) > 1
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    assert ours.unique_state_count() < full[0]
    want, got = _sections(rp), _sections(p)
    assert list(got) == list(want)
    for section in want:
        assert got[section] == want[section], section
    resumed = cls().checker().spawn_cuda_bfs(
        device="cpu", fused=False, resume_from=p, **KNOBS).join()
    whole = _full(name)
    assert not resumed.preempted
    assert (resumed.unique_state_count(), resumed.state_count()) == (
        whole.unique_state_count(), whole.state_count()) == full
    assert _chains(resumed) == _chains(whole)


def _preempt_after(monkeypatch, cls, hook: str, dispatches: int):
    """Makes every engine of ``cls`` preempt itself once ``dispatches``
    dispatches have retired (at ``hook``, the end of a retire)."""
    real = getattr(cls, hook)

    def hooked(self, *args):
        real(self, *args)
        if len(self.dispatch_log) == dispatches:
            self.preempt()

    monkeypatch.setattr(cls, hook, hooked)


@pytest.mark.parametrize("name", list(MODELS))
def test_fused_preempted_after_two_dispatches_equals_jax(monkeypatch,
                                                         tmp_path, name):
    ref_cls, cls, full = MODELS[name]
    rp, p = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    _preempt_after(monkeypatch, FusedTpuBfsChecker, "_service_sync", 2)
    _preempt_after(monkeypatch, FusedCudaBfsChecker, "_publish", 2)
    ref = ref_cls().checker().spawn_tpu_bfs(
        pack_arena=True, checkpoint_path=rp, **FUSED).join()
    ours = cls().checker().spawn_cuda_bfs(
        device="cpu", checkpoint_path=p, **FUSED).join()
    assert ref.preempted and ours.preempted
    assert len(ours.dispatch_log) == len(ref.dispatch_log) == 2
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    assert ours.unique_state_count() < full[0]
    want, got = _sections(rp), _sections(p)
    assert list(got) == list(want)
    for section in want:
        assert got[section] == want[section], section
    monkeypatch.undo()
    resumed = cls().checker().spawn_cuda_bfs(
        device="cpu", resume_from=p, **FUSED).join()
    whole = cls().checker().spawn_cuda_bfs(device="cpu", **FUSED).join()
    assert (resumed.unique_state_count(), resumed.state_count()) == (
        whole.unique_state_count(), whole.state_count()) == full
    assert _chains(resumed) == _chains(whole)


def test_preempt_after_the_end_and_on_the_sharded_engines_is_a_no_op():
    """A finished run ignores ``preempt()``; the sharded engines never
    poll it (JAX's sharded engines do not), so a run preempted before its
    first wave still runs to its end."""
    done = twopc.TwoPhaseSys(3).checker().spawn_cuda_bfs(
        device="cpu", batch_size=16).join()
    done.preempt()
    assert not done.preempted and done.unique_state_count() == 288
    for fused in (True, False):
        c = twopc.TwoPhaseSys(3).checker().spawn_cuda_bfs(
            mesh=["cpu"] * 2, batch_size=8, fused=fused)
        c.preempt()
        c.join()
        assert not c.preempted and c.unique_state_count() == 288
