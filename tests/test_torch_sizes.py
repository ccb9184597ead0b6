"""Kernels 2 and 3 at every model size JAX's kernels take.

The port's entry points hold each model over a range of sizes, with
instances a capacity and the size at run time (``csrc/models/*.cuh``'s
dispatch): increment and increment_lock at 1 to 16 threads and their plan
forms at 1 to 8, the puzzle on every board of 2 to 16 cells, single-copy
at its 22 (clients, servers) pairs and ABD at its 16, ping-pong and VSR
(1 to 4 replicas) at up to 64 network slots. On the CPU:

- ``cuda_model()`` and ``wave.cuda_plan()`` walk each range: every size
  is admitted, and the first size past each range is refused with a
  message that names the range held (the card raises there rather than
  fall back), a register workload's network past its default slots
  too;
- the registry's defaults, increment and increment_lock at 3 threads,
  with ``wave_kernel=True`` (the kernels' plain versions) against JAX's
  ``spawn_tpu_bfs(wave_kernel=True)`` (its Pallas kernels in interpret
  mode, as JAX's own tests run them) on the four engines: counts,
  capacities, discovery chains and ``kernel_path()``.

Past the held sizes the port keeps JAX's contract (its kernels trace
any size, and above their VMEM gate JAX drops to its XLA path, never
raising): ``wave.wave_kernel_fits`` refuses the first size past each
range with the reason, and an engine spawned there with
``wave_kernel=True`` warns once and runs the torch stages with kernel 1,
to JAX's counts and chains. Only that gate moves the path: with kernel
1's or kernel 2's loader failing, the spawn's ``wave.spawn_program``
raises at every size.

The device code of every size is held to the port's step by
``tests/test_torch_device_code.py``; the card's runs are
``chip_smoke.py``'s phases 14 and 19.
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
import increment as ref_inc  # noqa: E402
import increment_lock as ref_lock  # noqa: E402
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
import warnings  # noqa: E402

from stateright_tpu_torch import fused, matmul_wave, table, test_util, wave  # noqa: E402,E501
from stateright_tpu_torch.device_model import DeviceModel  # noqa: E402
from stateright_tpu_torch.model import Model, Property  # noqa: E402
from stateright_tpu_torch.models import (  # noqa: E402
    abd, increment, increment_lock, paxos, pingpong, single_copy,
    sliding_puzzle, vsr)
from stateright_tpu_torch.packing import compile_layout  # noqa: E402

torch.set_num_threads(2)


def _admits(dm) -> bool:
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    try:
        wave.cuda_model(dm, layout)
    except NotImplementedError as e:
        assert "wave_kernel=False" in str(e)
        return False
    return True


def _refused(dm, held: str) -> bool:
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    with pytest.raises(NotImplementedError, match=held):
        wave.cuda_model(dm, layout)
    return True


@pytest.mark.parametrize("cls", [increment.IncrementDevice,
                                 increment_lock.IncrementLockDevice])
def test_thread_counts_1_to_16_are_held(cls):
    assert all(_admits(cls(t)) for t in range(1, 17))
    assert _refused(cls(17), "it holds 1 to 16")


def test_every_board_of_2_to_16_cells_is_held():
    boards = [(r, c) for r in range(1, 17) for c in range(1, 17)
              if 2 <= r * c <= 16]
    assert all(_admits(sliding_puzzle.PuzzleDevice(r, c)) for r, c in boards)
    assert len(boards) == len(sliding_puzzle.PuzzleDevice.CUDA_INSTANCES)
    for r, c in ((1, 17), (3, 6), (4, 5), (17, 1)):
        assert _refused(sliding_puzzle.PuzzleDevice(r, c), "2 to 16 cells")


def test_every_register_pair_with_a_device_form_is_held():
    """Every (clients, servers) pair JAX's device form takes: 1 to 4
    clients, at most 7 servers and 8 actors (22 for single-copy); ABD
    less the pairs whose request ids collide (clients > servers), which
    keep raising ``DeviceFormUnavailable`` as in JAX (16)."""
    sc = [(c, s) for c in range(1, 5) for s in range(1, 8) if c + s <= 8]
    assert all(_admits(single_copy.SingleCopyDevice(c, s)) for c, s in sc)
    assert len(sc) == 22
    held = []
    for c, s in sc:
        try:
            dm = abd.AbdDevice(c, s)
        except abd.DeviceFormUnavailable:
            assert c > s
            continue
        assert _admits(dm)
        held.append((c, s))
    assert len(held) == 16 and all(c <= s for c, s in held)


def test_actor_models_up_to_64_slots_are_held():
    for e in (1, 16, 26, 27, 32, 64):
        assert _admits(pingpong.PingPongDevice(3, net_slots=e))
    assert _refused(pingpong.PingPongDevice(3, net_slots=65),
                    "holds 1 to 64")
    for n in range(1, 5):
        for e in (1, 8 * n, 41, 49, 64):
            assert _admits(vsr.VsrDevice(n, 1, net_slots=e))
        assert _refused(vsr.VsrDevice(n, 1, net_slots=65), "1 to 64 slots")


def test_register_networks_past_the_default_are_refused():
    """A register workload's entry points hold 1 to its default network
    slots (paxos's at 1 to 4 clients, single-copy's and ABD's at every
    pair): one slot more is refused, naming the range."""
    for dm in (paxos.PaxosDevice(2), single_copy.SingleCopyDevice(3, 2),
               abd.AbdDevice(2, 4)):
        assert _admits(dm)
        e = dm.default_slots
        cls = type(dm)
        args = (dm.C,) if cls is paxos.PaxosDevice else (dm.C, dm.S)
        assert _admits(cls(*args, net_slots=1))
        assert _refused(cls(*args, net_slots=e + 1), f"1 to {e} network")


def test_paxos_at_4_clients_builds_from_sources_of_its_own():
    """The entry points pick paxos's sources by its client count
    (``wave.SPLIT_SOURCES``): 4 clients ``csrc/wave_paxos4.cu`` and
    ``sender_paxos4.cu``, 1 to 3 ``wave_paxos.cu`` and ``sender_paxos.cu``;
    every other model its own name's, a DGraph's array params too."""
    from stateright_tpu_torch import test_util
    from stateright_tpu_torch.model import Property

    for c, want in ((1, "paxos"), (3, "paxos"), (4, "paxos4")):
        dm = paxos.PaxosDevice(c)
        name, params, _ = wave.cuda_model(
            dm, compile_layout(dm.lane_bits(), dm.state_width))
        assert wave._source(name, params) == want
        assert wave.SENDER_SOURCES[want] == "sender_" + want
        assert os.path.exists(os.path.join(
            os.path.dirname(wave.__file__), "csrc", f"wave_{want}.cu"))
    graph = test_util.DGraph.with_property(
        Property.always("p")).with_path([0, 3, 1])
    name, params, _ = wave.cuda_model(graph.device_model(),
                                      compile_layout(None, 1))
    assert wave._source(name, params) == "dgraph"
    dm = single_copy.SingleCopyDevice(4, 1)
    assert wave._source(*wave.cuda_model(
        dm, compile_layout(dm.lane_bits(), dm.state_width))[:2]) == (
        "single_copy")


@pytest.mark.parametrize("cls", [increment.IncrementDevice,
                                 increment_lock.IncrementLockDevice])
def test_plan_forms_1_to_8_are_held(cls):
    """Each count's own plan (the gate finds the shared counters regular
    at 1 to 8 threads) is taken by ``cuda_plan``; past 8 the entry points
    hold no plan form."""
    for t in range(1, 9):
        dm = cls(t)
        verdict = matmul_wave.classify(dm)
        assert verdict.plan is not None, verdict.reason
        layout = compile_layout(dm.lane_bits(), dm.state_width)
        wave.cuda_plan(dm, layout, verdict.plan)
    dm = cls(9)
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    with pytest.raises(NotImplementedError, match="1 to 8"):
        wave.cuda_plan(dm, layout, verdict.plan)


# -- The registry's defaults on the kernels, against JAX --------------------


#: each engine's knobs on both sides at 3 shards (the classic ones
#: without the successor ladder, whose rungs JAX compiles a program each)
ENGINES = {
    "fused": (dict(), dict(device="cpu")),
    "classic": (dict(fused=False, pack_arena=True, succ_ladder=False),
                dict(device="cpu", fused=False, succ_ladder=False)),
    "sharded": (dict(sharded=True), dict(mesh=["cpu"] * 3)),
    "sharded_classic": (dict(sharded=True, fused=False, pack_arena=True,
                             succ_ladder=False),
                        dict(mesh=["cpu"] * 3, fused=False,
                             succ_ladder=False))}
MODELS = {"increment": (ref_inc.IncrementModel, increment.IncrementModel,
                        ["fin"]),
          "increment_lock": (ref_lock.IncrementLockModel,
                             increment_lock.IncrementLockModel, [])}


def _ref_chains(c):
    dm = c._dm
    return {name: [host_fp64(np.asarray(dm.encode(s), np.uint32))
                   for s in path.into_states()]
            for name, path in c.discoveries().items()}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("name", list(MODELS))
def test_registry_default_on_the_kernels_matches_jax(name, engine):
    """The registry's and the examples' default, 3 threads, on the
    kernels' path (JAX's Pallas kernels in interpret mode, the port's
    plain versions): counts, capacities, discovery chains and the path
    each side names."""
    ref_cls, cls, found = MODELS[name]
    ref_kw, kw = ENGINES[engine]
    ref_kw = dict(ref_kw)
    if "sharded" in engine:
        ref_kw["mesh"] = RefMesh(np.array(jax.devices()[:3]), ("shard",))
    ref = ref_cls(3).checker().spawn_tpu_bfs(
        wave_kernel=True, batch_size=16, **ref_kw).join()
    ours = cls(3).checker().spawn_cuda_bfs(
        wave_kernel=True, batch_size=16, **kw).join()
    assert ref.kernel_path() == "interpret"
    assert ours.kernel_path() == ("sender_plain" if "sharded" in engine
                                  else "megakernel_plain")
    counts = (ours.unique_state_count(), ours.state_count())
    assert counts == (ref.unique_state_count(), ref.state_count())
    if name == "increment_lock":
        assert counts == (61, 61)
    assert ours._capacity == ref._capacity
    chains = {k: p.fingerprints for k, p in ours.discoveries().items()}
    assert sorted(chains) == found
    assert chains == _ref_chains(ref)


# -- Past the held sizes: the torch stages with kernel 1, as JAX's XLA path --


class _OwnDevice(DeviceModel):
    """A user's own device model (JAX's ``test_bring_your_own.py`` path):
    a counter mod 7 with no CUDA device code."""

    state_width, max_fanout = 1, 2

    def encode(self, state):
        return np.array([state], np.uint32)

    def decode(self, vec):
        return int(vec[0])

    def step(self, rows):
        succ = torch.stack([(rows + 1) % 7, (rows * 2) % 7], dim=1)
        return succ, torch.ones(succ.shape[:2], dtype=torch.bool)


class _Own(Model):
    def init_states(self):
        return [0]

    def properties(self):
        return [Property.always("small", lambda _, s: s < 7)]

    def device_model(self):
        return _OwnDevice()


def _plan(dm):
    verdict = matmul_wave.classify(dm)
    assert verdict.plan is not None, verdict.reason
    return verdict.plan


def _graph(nodes: int):
    edges = list(range(nodes))
    return test_util.DGraph.with_property(
        Property.always("p")).with_path(edges).device_model()


#: the first size past each held range: ``(device model, its matmul plan
#: or None, the reason's held range)``
PAST = {
    "increment 17": lambda: (increment.IncrementDevice(17), None,
                             "17 threads (it holds 1 to 16)"),
    "increment_lock 17": lambda: (increment_lock.IncrementLockDevice(17),
                                  None, "17 threads (it holds 1 to 16)"),
    "increment_lock 9 plan": lambda: (
        increment_lock.IncrementLockDevice(9),
        _plan(increment_lock.IncrementLockDevice(9)),
        "at (9,) (it holds 1 to 8)"),
    "puzzle 3x6": lambda: (sliding_puzzle.PuzzleDevice(3, 6), None,
                           "2 to 16 cells"),
    "pingpong 65 slots": lambda: (pingpong.PingPongDevice(3, net_slots=65),
                                  None, "holds 1 to 64"),
    "vsr 65 slots": lambda: (vsr.VsrDevice(2, 1, net_slots=65), None,
                             "1 to 64 slots"),
    "paxos past its slots": lambda: (
        paxos.PaxosDevice(2, net_slots=paxos.PaxosDevice(2).default_slots
                          + 1), None, "network"),
    "dgraph 33 nodes": lambda: (_graph(33), None, "at most 32 nodes"),
    "own model": lambda: (_OwnDevice(), None, "has no CUDA step")}


def _layout(dm):
    return compile_layout(dm.lane_bits(), dm.state_width)


@pytest.mark.parametrize("name", list(PAST))
def test_the_size_gate_refuses_past_each_range_with_the_reason(name):
    dm, plan, held = PAST[name]()
    ok, reason = wave.wave_kernel_fits(dm, _layout(dm), plan)
    assert not ok
    assert type(dm).__name__ in reason or "csrc/" in reason
    assert held in reason, reason
    if plan is not None:
        # The step form fits; the plan form does not.
        assert wave.wave_kernel_fits(dm, _layout(dm)) == (True, None)


class _LoadFailed(OSError):
    pass


@pytest.mark.parametrize("name", list(PAST) + ["increment 16 (held)"])
def test_a_failing_build_still_raises_at_spawn(monkeypatch, name):
    """With the kernels' loader failing, the spawn's resolution for the
    card raises at every size: past a range from kernel 1's library (the
    fallback's), inside one from kernel 2's. Nothing but the size gate
    moves the path."""
    if name in PAST:
        dm, plan, _ = PAST[name]()
    else:
        dm, plan = increment.IncrementDevice(16), None

    def fail(source):
        raise _LoadFailed(f"nvcc failed on {source}")

    monkeypatch.setattr(table, "build_and_load", fail)
    monkeypatch.setattr(wave, "build_and_load", fail)
    wave._entry.cache_clear()
    table._lib.cache_clear()
    cls = None if plan is None else matmul_wave.classify(dm)
    monkeypatch.setattr(matmul_wave, "gate", lambda dm, device: cls)
    card = torch.device("cuda", 0)
    with pytest.raises(_LoadFailed,
                       match="table" if name in PAST else "wave_increment"):
        wave.spawn_program(dm, _layout(dm), card, plan is not None, True,
                           False)
    wave._entry.cache_clear()
    table._lib.cache_clear()


HELD = {
    "increment 16 (held)": lambda: (increment.IncrementDevice(16), None),
    "increment_lock 8 plan (held)": lambda: (
        increment_lock.IncrementLockDevice(8),
        _plan(increment_lock.IncrementLockDevice(8)))}


@pytest.mark.parametrize("sender", [False, True])
@pytest.mark.parametrize("name", list(PAST) + list(HELD))
def test_the_card_spawn_decides_the_path_by_the_gate(monkeypatch, name,
                                                     sender):
    """``wave.spawn_program``'s own card branch, with the loaders stubbed:
    ``fits`` and ``reason`` are the size gate's; kernel 2's entry (kernel
    3's with ``sender``) is loaded only where the model fits, and kernel
    1's library at every size."""
    if name in PAST:
        dm, plan, held = PAST[name]()
    else:
        (dm, plan), held = HELD[name](), None
    loaded = []
    monkeypatch.setattr(wave, "load_library",
                        lambda: loaded.append("table"))

    def entry(kernel):
        return lambda name, kinds, *plan_form, source: loaded.append(
            (kernel, name, plan_form))

    monkeypatch.setattr(wave, "_entry", entry("wave"))
    monkeypatch.setattr(wave, "_sender_entry", entry("sender"))
    cls = None if plan is None else matmul_wave.classify(dm)
    monkeypatch.setattr(matmul_wave, "gate", lambda dm, device: cls)
    prog = wave.spawn_program(dm, _layout(dm), torch.device("cuda", 0),
                              plan is not None, True, sender)
    assert prog.classification is cls
    if held is not None:
        assert not prog.fits and held in prog.reason, prog.reason
        assert loaded == ["table"]
    else:
        assert prog.fits and prog.reason is None
        kernel, _, plan_form = loaded[0]
        assert kernel == ("sender" if sender else "wave")
        assert plan_form == (() if plan is None else (True,))
        assert loaded[1:] == ["table"]


def _card_gate(monkeypatch):
    """The engines' spawn as on the card, with nothing loaded: the size
    gate decides the path (``fits``) while the waves still run on the
    CPU, so the fallback's path is ``dedup_plain``."""
    real = wave.spawn_program

    def gated(dm, layout, device, wave_matmul, wave_kernel, sender):
        prog = real(dm, layout, device, wave_matmul, wave_kernel, sender)
        if not wave_kernel:
            return prog
        cls = prog.classification
        fits, reason = wave.wave_kernel_fits(
            dm, layout, None if cls is None else cls.plan)
        return prog._replace(fits=fits, reason=reason)

    monkeypatch.setattr(fused, "spawn_program", gated)


def _spawned_warned(spawn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        c = spawn()
    return c, [str(w.message) for w in caught
               if issubclass(w.category, RuntimeWarning)]


FALLBACK_RUNS = {
    "increment 17": (ref_inc.IncrementModel, increment.IncrementModel, 17,
                     dict(), "dedup_plain", "17 threads"),
    "increment_lock 9 plan": (ref_lock.IncrementLockModel,
                              increment_lock.IncrementLockModel, 9,
                              dict(wave_matmul=True), "dedup_plain+matmul",
                              "at (9,)")}


@pytest.mark.parametrize("engine", ["fused", "classic"])
@pytest.mark.parametrize("name", list(FALLBACK_RUNS))
def test_past_the_range_the_engine_falls_back_to_jax_counts(
        monkeypatch, name, engine):
    """On the card's gate, increment at 17 threads and increment_lock's
    plan at 9 with ``wave_kernel=True`` warn once (the model, its size and
    the sizes held), run the torch stages with kernel 1 (with the plan
    where one exists: ``+matmul``) and give the counts and chains of
    JAX's ``spawn_tpu_bfs(wave_kernel=True)`` at the same target."""
    ref_cls, cls, size, knobs, path, held = FALLBACK_RUNS[name]
    ref_kw, kw = ENGINES[engine]
    _card_gate(monkeypatch)
    ref = ref_cls(size).checker().target_state_count(2_000).spawn_tpu_bfs(
        wave_kernel=True, batch_size=16, **ref_kw, **knobs).join()
    ours, warned = _spawned_warned(
        lambda: cls(size).checker().target_state_count(2_000)
        .spawn_cuda_bfs(wave_kernel=True, batch_size=16, **kw, **knobs))
    ours.join()
    assert len(warned) == 1 and held in warned[0], warned
    assert "torch stages with kernel 1" in warned[0]
    assert ours.kernel_path() == path
    assert ours._wave_kernel_on and not ours._wave_kernel
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    assert {k: p.fingerprints for k, p in ours.discoveries().items()} == \
        _ref_chains(ref)


@pytest.mark.parametrize("engine", ["sharded", "sharded_classic"])
def test_the_sharded_engines_fall_back_to_the_torch_stages(monkeypatch,
                                                             engine):
    """The sharded engines past the range: the torch stages and the sort
    in place of kernel 3, one warning, the counts of their own torch
    stages' run and JAX's sharded ``wave_kernel=True`` run."""
    ref_kw, kw = ENGINES[engine]
    ref_kw = dict(ref_kw, mesh=RefMesh(np.array(jax.devices()[:3]),
                                       ("shard",)))
    _card_gate(monkeypatch)
    ref = ref_inc.IncrementModel(17).checker().target_state_count(
        2_000).spawn_tpu_bfs(wave_kernel=True, batch_size=16,
                             **ref_kw).join()
    ours, warned = _spawned_warned(
        lambda: increment.IncrementModel(17).checker().target_state_count(
            2_000).spawn_cuda_bfs(wave_kernel=True, batch_size=16, **kw))
    ours.join()
    staged = increment.IncrementModel(17).checker().target_state_count(
        2_000).spawn_cuda_bfs(wave_kernel=False, batch_size=16, **kw).join()
    assert len(warned) == 1 and "17 threads" in warned[0]
    assert ours.kernel_path() == staged.kernel_path() == "dedup_plain"
    counts = (ours.unique_state_count(), ours.state_count())
    assert counts == (staged.unique_state_count(), staged.state_count())
    assert counts == (ref.unique_state_count(), ref.state_count())
