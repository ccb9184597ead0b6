"""The port's host loop against JAX's: the bucket ladder, the in-flight
depth, and the dispatch graphs.

The ladder and ``pick_bucket`` equal JAX's (``tpu/engine.py:67-102``). The
port's engines on the CPU (``spawn_cuda_bfs(device="cpu")``, the kernels'
plain versions) are held to JAX ``spawn_tpu_bfs`` with the same knobs, on
the fused engine and on the sharded one (the conftest's 8-device mesh):
counts, discovery fingerprint chains, capacities, the bucket of every
dispatch and the number of dispatches, exact. ``DispatchGraphs`` runs on
the CPU through a stand-in for ``torch.cuda``'s graphs: the first dispatch
at a key eager, the second captured, every graph dropped at growth, and
the kernels' launch counts exact through captures and replays. The graphs
themselves, and the append kernel, run only on the card
(``chip_smoke.py``).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as RefMesh

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import stateright_tpu.tpu  # noqa: F401,E402  (enables x64)
import paxos as ref_paxos  # noqa: E402
import two_phase_commit as ref_model  # noqa: E402
from stateright_tpu.tpu import engine as ref_engine  # noqa: E402
from stateright_tpu_torch import engine, fused, graphs  # noqa: E402
from stateright_tpu_torch.models import twopc  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosSys  # noqa: E402
from stateright_tpu_torch.sharded_fused import (  # noqa: E402
    ShardedFusedCudaBfsChecker)

torch.set_num_threads(2)


def _chains(c):
    return {name: p.fingerprints for name, p in c.discoveries().items()}


def _ref_chains(c):
    from stateright_tpu.tpu.hashing import host_fp64

    dm = c._dm
    return {name: [host_fp64(np.asarray(dm.encode(s), np.uint32))
                   for s in p.into_states()]
            for name, p in c.discoveries().items()}


def _assert_same(ref, ours):
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    assert _chains(ours) == _ref_chains(ref)
    assert ours._capacity == ref._capacity
    assert ([e["bucket"] for e in ours.dispatch_log]
            == [e["bucket"] for e in ref.dispatch_log])
    assert ours.dispatches == len(ref.dispatch_log)
    assert ours.scheduler_stats()["dispatches"] == len(ref.dispatch_log)


def _ref_mesh(n):
    return RefMesh(np.array(jax.devices()[:n]), ("shard",))


# -- The ladder --------------------------------------------------------------


@pytest.mark.parametrize("base, top", [
    (1024, None), (1024, 1024), (1024, 16384), (64, 200), (16, 256),
    (3, 100), (1, 1), (100, 50), (17, 17 * 8), (4096, 16384)])
def test_bucket_ladder_matches_jax(base, top):
    ladder = engine.batch_bucket_ladder(base, top)
    assert ladder == ref_engine.batch_bucket_ladder(base, top)
    for width in (0, 1, base - 1, base, base + 1, ladder[-1],
                  ladder[-1] + 1, 10 ** 9):
        assert (engine.pick_bucket(ladder, width)
                == ref_engine.pick_bucket(ladder, width))


def test_adaptive_ladder_matches_jax():
    kw = dict(batch_size=16, max_batch_size=256, waves_per_dispatch=2,
              inflight_dispatches=2)
    ref = ref_model.TwoPhaseSys(4).checker().spawn_tpu_bfs(
        table_impl="pallas", **kw).join()
    ours = twopc.TwoPhaseSys(4).checker().spawn_cuda_bfs(
        device="cpu", **kw).join()
    _assert_same(ref, ours)
    stats = ours.scheduler_stats()
    assert stats["bucket_ladder"] == [16, 32, 64, 128, 256]
    assert len(stats["bucket_dispatches"]) >= 2, "the ladder should adapt"
    assert stats["bucket_dispatches"] == ref.scheduler_stats()[
        "bucket_dispatches"]
    assert stats["graphs"] is None


# -- The in-flight depth -----------------------------------------------------


_MODELS = {"2pc 4": (lambda: ref_model.TwoPhaseSys(4),
                     lambda: twopc.TwoPhaseSys(4), 64),
           "paxos 1": (lambda: ref_paxos.PaxosModelCfg(1, 3).into_model(),
                       lambda: PaxosSys(1), 32)}


@pytest.mark.parametrize("model", sorted(_MODELS))
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("waves", [1, 16])
def test_inflight_depth_matches_jax(model, depth, waves):
    ref_m, ours_m, batch = _MODELS[model]
    kw = dict(batch_size=batch, waves_per_dispatch=waves,
              inflight_dispatches=depth)
    ref = ref_m().checker().spawn_tpu_bfs(**kw).join()
    ours = ours_m().checker().spawn_cuda_bfs(device="cpu", **kw).join()
    _assert_same(ref, ours)
    got = ours.scheduler_stats()["max_inflight"]
    assert got == ref.scheduler_stats()["max_inflight"]
    if depth == 3:
        assert got >= 2


def test_target_count_with_a_ladder_at_depth_2_matches_jax():
    kw = dict(batch_size=16, max_batch_size=256, waves_per_dispatch=2,
              inflight_dispatches=2)
    ref = (ref_model.TwoPhaseSys(4).checker().target_state_count(1000)
           .spawn_tpu_bfs(**kw).join())
    ours = (twopc.TwoPhaseSys(4).checker().target_state_count(1000)
            .spawn_cuda_bfs(device="cpu", **kw).join())
    assert 1000 <= ours.state_count() < 8258
    _assert_same(ref, ours)


@pytest.mark.parametrize("n, depth, waves", [(3, 2, 2), (4, 3, 1)])
def test_sharded_ladder_and_depth_match_jax(n, depth, waves):
    kw = dict(batch_size=16, max_batch_size=128, waves_per_dispatch=waves,
              inflight_dispatches=depth)
    ref = ref_model.TwoPhaseSys(4).checker().spawn_tpu_bfs(
        sharded=True, mesh=_ref_mesh(n), **kw).join()
    ours = twopc.TwoPhaseSys(4).checker().spawn_cuda_bfs(
        mesh=["cpu"] * n, **kw).join()
    _assert_same(ref, ours)
    assert ours._ucap == ref._ucap
    assert len(ours.scheduler_stats()["bucket_dispatches"]) >= 2


def test_sharded_target_count_with_a_ladder_matches_jax():
    kw = dict(batch_size=16, max_batch_size=128, waves_per_dispatch=2,
              inflight_dispatches=2)
    ref = (ref_model.TwoPhaseSys(4).checker().target_state_count(1000)
           .spawn_tpu_bfs(sharded=True, mesh=_ref_mesh(3), **kw).join())
    ours = (twopc.TwoPhaseSys(4).checker().target_state_count(1000)
            .spawn_cuda_bfs(mesh=["cpu"] * 3, **kw).join())
    _assert_same(ref, ours)


def test_cuda_graph_on_the_cpu_raises():
    for spawn in (dict(device="cpu"), dict(mesh=["cpu"] * 2)):
        with pytest.raises(ValueError, match="cuda_graph=True"):
            twopc.TwoPhaseSys(3).checker().spawn_cuda_bfs(cuda_graph=True,
                                                          **spawn)
        c = twopc.TwoPhaseSys(3).checker().spawn_cuda_bfs(
            cuda_graph=False, **spawn).join()
        assert c._graphs is None and c.unique_state_count() == 288


# -- The dispatch graphs, through a stand-in ----------------------------------


class _Kernel:
    """A wrapper's launch counter."""

    launches = 0


class _StandIn:
    """Stands in for ``torch.cuda``'s graphs on the CPU, as a real capture
    behaves: ``capture`` runs the function's Python (every wrapper call,
    so every counter moves) but leaves the engine's tensors as they were,
    since a capture launches nothing; a graph's ``replay`` does the
    function's work, with ``replaying`` set (a real replay runs no
    Python, so no wrapper counts). ``events`` records each capture and
    replay."""

    def __init__(self):
        self.events = []
        self.engine = None
        self.replaying = False

    def graph(self):
        return _Graph(self)

    @staticmethod
    def pool():
        return object()

    def capture(self, graph, pool, fn):
        self.events.append("capture")
        eng = self.engine
        state = ([] if eng is None else
                 [eng._stats, eng._vecs, eng._fps, eng._par, eng._ebits,
                  eng._table])
        saved = [t.clone() for t in state]
        fn()
        for t, s in zip(state, saved):
            t.copy_(s)
        graph.fn = fn


class _Graph:
    def __init__(self, api):
        self.api, self.fn = api, None

    def replay(self):
        self.api.events.append("replay")
        self.api.replaying = True
        try:
            self.fn()
        finally:
            self.api.replaying = False


def test_graph_cache_captures_at_the_second_dispatch_and_counts_launches(
        monkeypatch):
    api = _StandIn()
    monkeypatch.setattr(graphs, "CUDA_GRAPHS", api)
    k1, k2 = _Kernel(), _Kernel()
    g = graphs.DispatchGraphs([k1, k2])
    runs = []

    def dispatch(tag):
        def fn():
            runs.append(tag)
            if not api.replaying:
                k1.launches += 3
                k2.launches += 1
        return fn

    assert g.run("a", dispatch("a")) is False      # eager warm-up
    assert api.events == [] and (k1.launches, k2.launches) == (3, 1)
    assert not g.has_graph("a") and len(g) == 0
    assert g.run("a", dispatch("a")) is True       # capture, then replay
    assert api.events == ["capture", "replay"]
    assert (k1.launches, k2.launches) == (6, 2)    # the capture adds none
    assert g.has_graph("a") and len(g) == 1
    assert g.run("a", dispatch("a")) is False      # replay
    assert api.events[-1] == "replay" and (k1.launches, k2.launches) == (9, 3)
    assert g.run("b", dispatch("b")) is False      # another key: eager
    assert (g.captures, g.replays) == (1, 2)
    assert runs == ["a", "a", "a", "a", "b"]       # fn, capture, 2 replays
    g.clear()
    assert len(g) == 0 and not g.has_graph("a")
    assert g.run("a", dispatch("a")) is False      # eager again
    assert api.events.count("capture") == 1


def test_a_failed_capture_raises(monkeypatch):
    class Broken(_StandIn):
        def capture(self, graph, pool, fn):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    monkeypatch.setattr(graphs, "CUDA_GRAPHS", Broken())
    g = graphs.DispatchGraphs([_Kernel()])
    g.run("a", lambda: None)
    with pytest.raises(RuntimeError, match="capturing"):
        g.run("a", lambda: None)
    assert not g.has_graph("a")


@pytest.mark.parametrize("sharded", [False, True])
def test_engine_graphs_through_a_stand_in(monkeypatch, sharded):
    """An engine on the CPU with its dispatches through the stand-in:
    results equal to the engine without graphs, the first dispatch at a
    key eager and the second captured, and every graph dropped at each
    growth."""
    api = _StandIn()
    monkeypatch.setattr(graphs, "CUDA_GRAPHS", api)
    outcomes = []
    run = graphs.DispatchGraphs.run

    def logged(self, key, dispatch):
        before = len(api.events)
        captured = run(self, key, dispatch)
        outcomes.append((key, "eager" if len(api.events) == before
                         else "capture" if captured else "replay"))
        return captured

    monkeypatch.setattr(graphs.DispatchGraphs, "run", logged)
    held = []
    cls = ShardedFusedCudaBfsChecker if sharded else fused.FusedCudaBfsChecker
    grow = cls._grow

    def logged_grow(self, bucket):
        if self._graphs is None:        # the run without graphs
            return grow(self, bucket)
        outcomes.append(("grow", len(self._graphs)))
        grow(self, bucket)
        held.append(len(self._graphs))

    monkeypatch.setattr(cls, "_grow", logged_grow)

    class Probe(cls):
        def __init__(self, *args, **kwargs):
            api.engine = self
            super().__init__(*args, **kwargs)

    kw = dict(batch_size=16, max_batch_size=64, waves_per_dispatch=1,
              table_capacity=1 << 12, arena_capacity=1 << 9)
    builder = twopc.TwoPhaseSys(4).checker()
    if sharded:
        from stateright_tpu_torch.mesh import Mesh
        c = Probe(builder, Mesh(["cpu"] * 3), cuda_graph=True, **kw).join()
        off = twopc.TwoPhaseSys(4).checker().spawn_cuda_bfs(
            mesh=["cpu"] * 3, **kw).join()
    else:
        c = Probe(builder, torch.device("cpu"), cuda_graph=True, **kw).join()
        off = twopc.TwoPhaseSys(4).checker().spawn_cuda_bfs(
            device="cpu", **kw).join()
    assert (c.unique_state_count(), c.state_count()) == (1568, 8258)
    assert (c.unique_state_count(), c.state_count(), _chains(c)) == (
        off.unique_state_count(), off.state_count(), _chains(off))
    assert ([e["bucket"] for e in c.dispatch_log]
            == [e["bucket"] for e in off.dispatch_log])
    assert c.rehashes + c.arena_grows > 0 and held and not any(held)
    # Between growths, each key's dispatches run eager, capture, replay...
    seen = {}
    for key, what in outcomes:
        if key == "grow":
            seen = {}
            continue
        n = seen[key] = seen.get(key, 0) + 1
        assert what == ("eager" if n == 1 else "capture" if n == 2
                        else "replay"), (key, n, what)
    stats = c.scheduler_stats()["graphs"]
    assert stats["captures"] == sum(w == "capture" for _, w in outcomes) > 0
    assert stats["replays"] == sum(w in ("capture", "replay")
                                   for _, w in outcomes)
    assert any(what == "replay" for _, what in outcomes)
    assert any(e["compiled"] for e in c.dispatch_log)
    assert c.scheduler_stats()["bucket_compiles"] == stats["captures"]
