"""The port's matmul expand against JAX's (``tpu/matmul_wave.py``).

``stateright_tpu_torch/matmul_wave.py`` classifies a model by probing the
port's own torch ``step`` with JAX's draws, in JAX's order: for every
model of JAX's ``service.default_registry()`` and the port's twin, and for
the test fixtures, the reason strings are equal, and where the model is
regular the plans are equal field by field (keys, strides, domains,
columns, float tables, constants, copies, MAC counts). ``matmul_expand``
on seeded random in-domain frontiers equals JAX's ``matmul_expand`` and
the port's own ``expand_frontier`` in all four returns. Then the engines:
2pc at 3 RMs, batch 48, on the fused, classic, sharded fused and classic
sharded engines, each with ``wave_matmul`` on, off, and as JAX with it
on: counts, discovery chains, parent maps, checkpoint sections byte for
byte, ``scheduler_stats()["wave_matmul"]`` (JAX's dict), the ``+matmul``
suffix and every dispatch's ``expand_impl``; with ``wave_kernel=True``
too (the plan form's plain versions, kernels 2 and 3) against both knobs
off; 2pc 5 with symmetry; a forced regather with the knob on, equal to
JAX's; the irregular gate (paxos: JAX's warning, once, and JAX's
counts); the environment knob. Everything is integers: the tolerance is
exact equality. The plan-form kernels' device code is held to
``matmul_expand`` in ``tests/test_torch_device_code.py``; on the card,
``chip_smoke.py`` phase 13.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as RefMesh

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import stateright_tpu.tpu  # noqa: F401,E402  (enables x64)
import increment as ref_inc  # noqa: E402
import increment_lock as ref_lock  # noqa: E402
import paxos as ref_paxos  # noqa: E402
import two_phase_commit as ref_twopc  # noqa: E402
from stateright_tpu import test_util as ref_util  # noqa: E402
from stateright_tpu.tpu import engine as ref_engine  # noqa: E402
from stateright_tpu.tpu import matmul_wave as ref_mw  # noqa: E402
from stateright_tpu.tpu.engine import TpuBfsChecker  # noqa: E402
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
from stateright_tpu_torch import carry, matmul_wave, test_util, wave  # noqa: E402,E501
from stateright_tpu_torch.classic import CudaBfsChecker  # noqa: E402
from stateright_tpu_torch.engine import expand_frontier  # noqa: E402
from stateright_tpu_torch.models import (abd, increment,  # noqa: E402
                                         increment_lock, paxos, pingpong,
                                         single_copy, sliding_puzzle, twopc,
                                         vsr)
from stateright_tpu_torch.packing import compile_layout  # noqa: E402

torch.set_num_threads(2)

#: the port's twin of each model of JAX's default registry, at the
#: registry's defaults (``stateright_tpu/service/registry.py`` :213-246)
PORT_REGISTRY = {
    "twopc": lambda: twopc.TwoPhaseSys(3),
    "paxos": lambda: paxos.PaxosSys(2),
    "increment": lambda: increment.IncrementModel(3),
    "increment_lock": lambda: increment_lock.IncrementLockModel(3),
    "single_copy": lambda: single_copy.SingleCopySys(2, 1),
    "abd": lambda: abd.AbdSys(2, 2),
    "pingpong": lambda: pingpong.PingPongSys(3),
    "sliding_puzzle": lambda: sliding_puzzle.SlidingPuzzle(2, 3),
    "vsr": lambda: vsr.VsrSys(3, 1)}

#: each regular configuration's JAX and port device models, by name
PLAN_MODELS = {
    "2pc 3": (lambda: ref_twopc.TwoPhaseSys(3), lambda: twopc.TwoPhaseSys(3)),
    "2pc 4": (lambda: ref_twopc.TwoPhaseSys(4), lambda: twopc.TwoPhaseSys(4)),
    "2pc 5": (lambda: ref_twopc.TwoPhaseSys(5), lambda: twopc.TwoPhaseSys(5)),
    "2pc 7": (lambda: ref_twopc.TwoPhaseSys(7), lambda: twopc.TwoPhaseSys(7)),
    "2pc 8": (lambda: ref_twopc.TwoPhaseSys(8), lambda: twopc.TwoPhaseSys(8)),
    "2pc 10": (lambda: ref_twopc.TwoPhaseSys(10),
               lambda: twopc.TwoPhaseSys(10)),
    "increment 2": (lambda: ref_inc.IncrementModel(2),
                    lambda: increment.IncrementModel(2)),
    "increment 4": (lambda: ref_inc.IncrementModel(4),
                    lambda: increment.IncrementModel(4)),
    "increment 8": (lambda: ref_inc.IncrementModel(8),
                    lambda: increment.IncrementModel(8)),
    "increment 16": (lambda: ref_inc.IncrementModel(16),
                     lambda: increment.IncrementModel(16)),
    "increment_lock 2": (lambda: ref_lock.IncrementLockModel(2),
                         lambda: increment_lock.IncrementLockModel(2)),
    "increment_lock 4": (lambda: ref_lock.IncrementLockModel(4),
                         lambda: increment_lock.IncrementLockModel(4)),
    "increment_lock 8": (lambda: ref_lock.IncrementLockModel(8),
                         lambda: increment_lock.IncrementLockModel(8))}


def _classify_both(name):
    ref, ours = PLAN_MODELS[name]
    return (ref_mw.classify(ref().device_model()),
            matmul_wave.classify(ours().device_model()))


def _assert_same_classification(ref, ours):
    assert ours.reason == ref.reason
    assert ours.regular == ref.regular
    assert (ours.plan is None) == (ref.plan is None)
    if ref.plan is None:
        return
    a, b = ref.plan, ours.plan
    for field in ("width", "fanout", "consts", "copies", "matmul_ops",
                  "table_bytes"):
        assert getattr(b, field) == getattr(a, field), field
    assert len(b.groups) == len(a.groups)
    for ga, gb in zip(a.groups, b.groups):
        assert (gb.keys, gb.strides, gb.domain, gb.cols) == (
            ga.keys, ga.strides, ga.domain, ga.cols)
        assert gb.table.dtype == ga.table.dtype
        assert np.array_equal(gb.table, ga.table)


# -- The gate and the plans ----------------------------------------------------


def test_registry_reasons_equal_jax():
    """Every model of JAX's default registry and the port's twin: the
    same verdict and reason string (and, for the regular ones, the same
    plan), and the fixtures with no ``lane_bits`` alike."""
    from stateright_tpu.service import default_registry

    r = default_registry()
    assert set(PORT_REGISTRY) == set(r.names())
    for name in r.names():
        model, _ = r.build(name)
        _assert_same_classification(
            ref_mw.classify(model.device_model()),
            matmul_wave.classify(PORT_REGISTRY[name]().device_model()))
    for ref, ours in (
            (ref_util.LinearEquation(2, 4, 7),
             test_util.LinearEquation(2, 4, 7)),
            (ref_util.DGraph.with_property(
                ref_util.Property.always("p", lambda m, s: True)).with_path(
                    [0, 3, 1]),
             test_util.DGraph.with_property(
                 test_util.Property.always("p")).with_path([0, 3, 1]))):
        want = ref_mw.classify(ref.device_model())
        got = matmul_wave.classify(ours.device_model())
        assert got.reason == want.reason == "undeclared lane_bits"
        assert (got.regular, got.plan) == (False, None)


@pytest.mark.parametrize("name", [
    "2pc 3", "2pc 5", "increment 2", "increment 4", "increment_lock 2",
    "increment_lock 4",
    pytest.param("2pc 7", marks=pytest.mark.slow),
    pytest.param("increment 8", marks=pytest.mark.slow),
    pytest.param("increment_lock 8", marks=pytest.mark.slow),
    pytest.param("2pc 8", marks=pytest.mark.slow),
    pytest.param("2pc 10", marks=pytest.mark.slow),
    pytest.param("increment 16", marks=pytest.mark.slow)])
def test_plans_equal_jax(name):
    """The verdict, the reason and the plan field by field, tables with
    ``np.array_equal``; 2pc 8 and 10 and increment 16 are JAX's probe
    budget refusals."""
    ref, ours = _classify_both(name)
    _assert_same_classification(ref, ours)
    if name in ("2pc 8", "2pc 10", "increment 16"):
        assert not ours.regular
    else:
        assert ours.regular, ours.reason


def test_classification_is_memoized_by_the_cuda_model():
    """The memo keys on the type and ``cuda_model()``'s params: the same
    object for the same model; a size with no CUDA instance classifies
    anew, with the same verdict."""
    a = matmul_wave.classify(twopc.TwoPhaseSys(3).device_model())
    assert a is matmul_wave.classify(twopc.TwoPhaseSys(3).device_model())
    b = matmul_wave.classify(increment.IncrementModel(3).device_model())
    assert b is matmul_wave.classify(increment.IncrementModel(3).device_model())
    # A graph of 41 nodes: past the 32 that csrc/wave_dgraph.cu holds.
    big = test_util.DGraph.with_property(
        test_util.Property.always("p")).with_path([0, 40])
    b = matmul_wave.classify(big.device_model())
    c = matmul_wave.classify(big.device_model())
    assert b is not c and b.reason == c.reason
    assert matmul_wave.plan_bytes(a.plan, 64) == (
        4 * 64 * max(g.domain for g in a.plan.groups) + a.plan.table_bytes)
    assert matmul_wave.plan_bytes(None, 64) == 0


def _random_frontier(rng, dm, n):
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    return np.stack([rng.integers(0, 1 << lane.bits, size=n,
                                  dtype=np.uint32)
                     for lane in layout.lanes], axis=1)


@pytest.mark.parametrize("name", ["2pc 3", "2pc 4", "2pc 5",
                                  "increment_lock 4"])
def test_matmul_expand_equals_jax_and_the_step(name):
    """Seeded random in-domain frontiers (some rows not valid): the port's
    ``matmul_expand`` equals JAX's ``matmul_expand`` in all four returns
    (successors, validity, count, terminal rows), every slot, and the
    port's ``expand_frontier`` likewise: the tables hold the step's own
    outputs, enabled or not."""
    ref_cls, cls = _classify_both(name)
    ref_dm = PLAN_MODELS[name][0]().device_model()
    dm = PLAN_MODELS[name][1]().device_model()
    j_mm = jax.jit(lambda v, m: ref_mw.matmul_expand(ref_dm, ref_cls.plan,
                                                     v, m))
    B = 64
    for seed in range(3):
        rng = np.random.default_rng(seed)
        rows = _random_frontier(rng, dm, B)
        valid = rng.random(B) < 0.9
        want = [np.asarray(a) for a in j_mm(jnp.asarray(rows),
                                            jnp.asarray(valid))]
        got = matmul_wave.matmul_expand(dm, cls.plan, carry.rows_in(rows),
                                        torch.from_numpy(valid))
        step = expand_frontier(dm, carry.rows_in(rows),
                               torch.from_numpy(valid))
        for out in (got, step):
            assert np.array_equal(carry.rows_out(out[0]), want[0]), seed
            assert np.array_equal(out[1].numpy(), want[1]), seed
            assert int(out[2]) == int(want[2]), seed
            assert np.array_equal(out[3].numpy(), want[3]), seed
        assert want[1].any() and not want[1].all()


def test_an_out_of_domain_key_reads_zero():
    """A key index past a group's table (a lane outside its declared
    domain) reads 0, as the reference's all-zero one-hot row does."""
    dm = twopc.TwoPhaseDevice(3)
    plan = matmul_wave.classify(dm).plan
    g = next(g for g in plan.groups if len(g.keys) == 1)
    rows = torch.zeros((1, dm.state_width), dtype=torch.int64)
    rows[0, g.keys[0]] = g.domain
    succ, sv, _, _ = matmul_wave.matmul_expand(
        dm, plan, rows, torch.ones(1, dtype=torch.bool))
    for a, o in g.cols:
        got = sv.reshape(dm.max_fanout)[a] if o == dm.state_width else \
            succ.reshape(dm.max_fanout, -1)[a, o]
        assert int(got) == 0


# -- The engines ---------------------------------------------------------------

ENGINES = ("fused", "classic", "sharded-fused", "sharded-classic")
#: the sharded engines' shards here, on both sides
N = 3


def _ref_spawn(model, engine, B, **kw):
    b = model.checker()
    if kw.pop("sym", False):
        b = b.symmetry()
    if engine in ("fused", "classic"):
        return b.spawn_tpu_bfs(batch_size=B, fused=engine == "fused",
                               pack_arena=True, inflight_dispatches=1, **kw)
    mesh = RefMesh(np.array(jax.devices()[:N]), ("shard",))
    return b.spawn_tpu_bfs(batch_size=B, sharded=True, mesh=mesh,
                           fused=engine == "sharded-fused", pack_arena=True,
                           inflight_dispatches=1, **kw)


def _spawn(model, engine, B, **kw):
    b = model.checker()
    if kw.pop("sym", False):
        b = b.symmetry()
    if engine in ("fused", "classic"):
        return b.spawn_cuda_bfs(device="cpu", batch_size=B,
                                fused=engine == "fused", **kw)
    return b.spawn_cuda_bfs(mesh=["cpu"] * N, batch_size=B,
                            fused=engine == "sharded-fused", **kw)


def _sections(path):
    with np.load(path) as data:
        return {k: (data[k].dtype, data[k].shape, data[k].tobytes())
                for k in data.files}


def _ref_chains(c):
    dm = c._dm
    return {name: [host_fp64(np.asarray(dm.encode(s), np.uint32))
                   for s in p.into_states()]
            for name, p in c.discoveries().items()}


def _chains(c):
    return {name: p.fingerprints for name, p in c.discoveries().items()}


def _parents(c):
    """The port's parent map: the classic engines' ``_parent_map()``, the
    fused engines' parent sections (JAX's ``_parent_map`` order, each
    child's first entry)."""
    if isinstance(c, CudaBfsChecker):
        return c._parent_map()
    child, parent, rooted = c._parent_sections()
    return {int(k): None if r else int(p)
            for k, p, r in zip(child, parent, rooted)}


def _run(ours, path):
    return ((ours.unique_state_count(), ours.state_count()), _chains(ours),
            _parents(ours), _sections(path))


#: the knobs of the engine runs: JAX's fused engines at one dispatch in
#: flight (the port's default), two waves a dispatch on both sides
KNOBS = {"fused": dict(waves_per_dispatch=2),
         "sharded-fused": dict(waves_per_dispatch=2)}


@pytest.mark.parametrize("engine", ENGINES)
def test_engines_agree_with_jax_three_ways(engine, tmp_path):
    """2pc 3 at batch 48 on each engine: the port with ``wave_matmul`` on
    equals the port with it off and JAX with it on in counts, discovery
    chains, parent maps and checkpoint sections (byte for byte); the
    ``wave_matmul`` stats equal JAX's dict; ``kernel_path()`` ends in
    ``+matmul`` and every dispatch says ``matmul`` exactly when on. Then
    ``wave_kernel=True`` with the knob on (the plan form's plain
    versions) against both knobs off."""
    kw = KNOBS.get(engine, {})
    rp = str(tmp_path / "ref.npz")
    ref = _ref_spawn(ref_twopc.TwoPhaseSys(3), engine, 48, wave_matmul=True,
                     checkpoint_path=rp, **kw).join()
    runs = {}
    for wave_kernel, on in ((False, True), (False, False), (True, True),
                            (True, False)):
        path = str(tmp_path / f"{wave_kernel}-{on}.npz")
        c = _spawn(twopc.TwoPhaseSys(3), engine, 48, wave_matmul=on,
                   wave_kernel=wave_kernel, checkpoint_path=path,
                   **kw).join()
        stats = c.scheduler_stats()["wave_matmul"]
        if on:
            assert stats == ref.scheduler_stats()["wave_matmul"]
            assert stats["reason"] == "regular (8 key groups, 1640 macs/row)"
        else:
            assert stats == {"enabled": False, "active": False,
                             "expand_impl": "step", "reason": None,
                             "matmul_ops": 0}
        assert c.kernel_path().endswith("+matmul") == on
        assert ref.kernel_path().endswith("+matmul")
        impl = "matmul" if on else "step"
        assert c.dispatch_log and all(e["expand_impl"] == impl
                                      for e in c.dispatch_log)
        runs[wave_kernel, on] = _run(c, path)
    want = ((ref.unique_state_count(), ref.state_count()), _ref_chains(ref),
            dict(ref._parent_map()), _sections(rp))
    assert want[0] == (288, 1146)
    for key, run in runs.items():
        for i, what in enumerate(("counts", "chains", "parents",
                                  "checkpoint")):
            assert run[i] == want[i], (key, what)


@pytest.mark.parametrize("engine", ENGINES)
def test_symmetry_with_the_plan_form(engine):
    """2pc 5 with symmetry on each engine's kernels' plain versions with
    the knob on: 314 unique, the knob-off run's counts and chains."""
    runs = [_spawn(twopc.TwoPhaseSys(5), engine, 64, sym=True,
                   wave_kernel=True, wave_matmul=on).join()
            for on in (True, False)]
    assert runs[0].unique_state_count() == 314
    assert (runs[0].state_count(), _chains(runs[0])) == (
        runs[1].state_count(), _chains(runs[1]))


@pytest.mark.parametrize("engine", ["classic", "sharded-classic"])
def test_forced_regather_with_the_knob_on_equals_jax(engine, monkeypatch):
    """Every wave after the ladder's history fills at a rung of 8 rows,
    so most waves regather through ``matmul_expand`` (the classic
    regathers, ``build_regather`` :2242 in JAX): the counts, chains,
    parent map and every wave's rung and overflow equal JAX's with the
    knob on, on the torch stages and the kernels' plain versions."""
    def forced(self, B):
        return 8 if self._succ_ladder_on else self._succ_full_rows(B)

    monkeypatch.setattr(TpuBfsChecker, "_pick_out_rows", forced)
    monkeypatch.setattr(CudaBfsChecker, "_pick_out_rows", forced)
    ref = _ref_spawn(ref_twopc.TwoPhaseSys(3), engine, 8,
                     wave_matmul=True).join()
    waves = [(e["out_rows"], e["overflow"], e["novel"])
             for e in ref.dispatch_log]
    assert sum(o for _, o, _ in waves) > 5
    for wave_kernel in (False, True):
        ours = _spawn(twopc.TwoPhaseSys(3), engine, 8, wave_matmul=True,
                      wave_kernel=wave_kernel).join()
        assert (ours.unique_state_count(), ours.state_count()) == (288, 1146)
        assert _chains(ours) == _ref_chains(ref)
        assert ours._parent_map() == ref._parent_map()
        assert [(e["out_rows"], e["overflow"], e["novel"])
                for e in ours.dispatch_log] == waves


def test_irregular_model_warns_once_and_keeps_its_step():
    """paxos with the knob on: one ``RuntimeWarning`` with JAX's text,
    the ``wave_matmul`` stats JAX's, no ``+matmul``, and JAX's counts;
    once per model type, not per spawn."""
    ref_engine._WAVE_MATMUL_GATE_WARNED.discard("PaxosDevice")
    matmul_wave._WAVE_MATMUL_GATE_WARNED.discard("PaxosDevice")
    with pytest.warns(RuntimeWarning) as ref_w:
        ref = ref_paxos.PaxosModelCfg(1, 3).into_model().checker() \
            .spawn_tpu_bfs(batch_size=64, fused=False,
                           wave_matmul=True).join()
    with pytest.warns(RuntimeWarning) as our_w:
        ours = paxos.PaxosSys(1).checker().spawn_cuda_bfs(
            device="cpu", batch_size=64, fused=False,
            wave_matmul=True).join()
    msgs = [[str(w.message) for w in ws if "wave_matmul" in str(w.message)]
            for ws in (ref_w, our_w)]
    assert msgs[0] == msgs[1] == [
        "wave_matmul requested but PaxosDevice is not matmul-regular "
        "(sentinel lane domains); using the vmapped step path"]
    stats = ours.scheduler_stats()["wave_matmul"]
    assert stats == ref.scheduler_stats()["wave_matmul"] == {
        "enabled": True, "active": False, "expand_impl": "step",
        "reason": "sentinel lane domains", "matmul_ops": 0}
    assert not ours.kernel_path().endswith("+matmul")
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count()) == (265, 482)
    assert sorted(ours.discoveries()) == sorted(ref.discoveries())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = paxos.PaxosSys(1).checker().spawn_cuda_bfs(
            device="cpu", batch_size=64, wave_matmul=True,
            wave_kernel=True).join()
    assert again.unique_state_count() == 265


def test_env_knob_and_the_card_refusals(monkeypatch):
    """``wave_matmul=None`` follows ``STpu_WAVE_MATMUL``; an explicit
    value wins. On the card a plan-form launch needs an entry point that
    holds it: 2pc, increment and increment_lock at 1 to 8 RMs or threads;
    another regular model raises (a size the CUDA code does not hold, or
    a plan past ``csrc/plan.cuh``'s capacities)."""
    monkeypatch.setenv("STpu_WAVE_MATMUL", "1")
    c = twopc.TwoPhaseSys(2).checker().spawn_cuda_bfs(
        device="cpu", batch_size=16, fused=False).join()
    assert c._wave_matmul_on and c._matmul_plan is not None
    c = twopc.TwoPhaseSys(2).checker().spawn_cuda_bfs(
        device="cpu", batch_size=16, wave_matmul=False).join()
    assert not c._wave_matmul_on and c._matmul_plan is None
    monkeypatch.setenv("STpu_WAVE_MATMUL", "0")
    c = twopc.TwoPhaseSys(2).checker().spawn_cuda_bfs(
        device="cpu", batch_size=16).join()
    assert not c._wave_matmul_on and c._matmul_plan is None
    for model in (twopc.TwoPhaseSys(4), increment.IncrementModel(2),
                  increment_lock.IncrementLockModel(4),
                  increment.IncrementModel(3)):
        dm = model.device_model()
        layout = compile_layout(dm.lane_bits(), dm.state_width)
        wave.cuda_plan(dm, layout, matmul_wave.classify(dm).plan)
    plan3 = matmul_wave.classify(increment.IncrementDevice(3)).plan
    dm = increment.IncrementModel(17).device_model()
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    with pytest.raises(NotImplementedError, match="no instance"):
        wave.cuda_plan(dm, layout, plan3)
    dm = increment.IncrementDevice(9)
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    with pytest.raises(NotImplementedError, match="no plan-form entry"):
        wave.cuda_plan(dm, layout, plan3)
    dm = twopc.TwoPhaseDevice(3)
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    plan = matmul_wave.classify(dm).plan
    big = matmul_wave.MatmulPlan(plan.width, plan.fanout,
                                 plan.groups * 5, plan.consts, plan.copies)
    with pytest.raises(NotImplementedError, match="does not fit"):
        wave.cuda_plan(dm, layout, big)


def test_wave_kernel_env_knob_on_every_engine(monkeypatch):
    """``wave_kernel=None`` (the default) follows ``STpu_WAVE_KERNEL`` by
    JAX's rule (``stateright_tpu/tpu/engine.py:278-281``): unset, empty or
    ``"0"`` off, anything else on, on all four engines (the sharded ones
    take the sender kernel); an explicit value wins. ``kernel_path()``
    says which path ran (the kernels' plain versions on the CPU)."""
    engines = {"fused": dict(device="cpu"),
               "classic": dict(device="cpu", fused=False),
               "sharded": dict(mesh=["cpu"] * 2),
               "sharded_classic": dict(mesh=["cpu"] * 2, fused=False)}
    on = {"fused": "megakernel_plain", "classic": "megakernel_plain",
          "sharded": "sender_plain", "sharded_classic": "sender_plain"}

    def path(**kw):
        c = twopc.TwoPhaseSys(2).checker().spawn_cuda_bfs(
            batch_size=16, **kw).join()
        assert c.unique_state_count() == 56
        return c.kernel_path()

    monkeypatch.delenv("STpu_WAVE_KERNEL", raising=False)
    for engine, kw in engines.items():
        assert on[engine] not in path(**kw), engine
    for value in ("1", "yes"):
        monkeypatch.setenv("STpu_WAVE_KERNEL", value)
        for engine, kw in engines.items():
            assert on[engine] in path(**kw), (engine, value)
        assert on["fused"] not in path(wave_kernel=False, device="cpu")
    for value in ("0", ""):
        monkeypatch.setenv("STpu_WAVE_KERNEL", value)
        assert on["fused"] not in path(device="cpu")
        assert on["sharded"] not in path(mesh=["cpu"] * 2)
        assert on["fused"] in path(wave_kernel=True, device="cpu")


def test_plan_instances_match_the_cuda_sources():
    """``CUDA_PLAN_INSTANCES`` lists what each source's plan form holds:
    ``wave_twopc.cu`` at 4 and 8 RMs (every count up to 8), the shared
    counters' on their capacities of 2, 4 and 8 threads (every count up to
    8: the instances past 8 have no plan form)."""
    import re

    src = os.path.join(os.path.dirname(wave.__file__), "csrc")

    def read(name):
        return open(os.path.join(src, name)).read()

    assert sorted(int(k) for k in re.findall(
        r"with_plan\(sr::TwoPhase<(\d+)>", read("wave_twopc.cu"))) == [4, 8]
    assert twopc.TwoPhaseDevice.CUDA_PLAN_INSTANCES == tuple(range(1, 9))
    for name, cls in (("increment", increment.IncrementDevice),
                      ("increment_lock", increment_lock.IncrementLockDevice)):
        text = read(f"wave_{name}.cu")
        assert re.search(r"if constexpr \(std::decay_t<decltype\(m\)>::kMaxT "
                         r"> 8\)\n\s+return \(int\)cudaErrorInvalidValue;",
                         text)
        caps = [int(k) for k in re.findall(r"if \(threads <= (\d+)\)",
                                           read(f"models/{name}.cuh"))]
        assert cls.CUDA_PLAN_INSTANCES == tuple(
            range(1, max(c for c in caps if c <= 8) + 1)) == tuple(
            range(1, 9))
