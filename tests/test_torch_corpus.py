"""The port's plain device models against JAX's.

Same rows through the JAX package's device models and the port's:
``LinearEquation`` and ``DGraph`` (``stateright_tpu/test_util.py`` against
``stateright_tpu_torch/test_util.py``), increment and increment_lock
(``examples/increment.py``, ``examples/increment_lock.py`` and
``stateright_tpu/tpu/models/``, against ``stateright_tpu_torch/models/``)
and the sliding puzzle (``examples/sliding_puzzle.py`` against
``stateright_tpu_torch/models/sliding_puzzle.py``): the layout, the init
state and the codec, the batch-first ``step`` on JAX's reachable rows and
on adversarial ones (every successor, enabled or not), the properties and
the threads' ``representative``. Then the whole slice: each model through
``spawn_cuda_bfs(device="cpu")`` against JAX ``spawn_tpu_bfs`` at the same
batch, in counts, capacities and discovery chains, on the fused, classic
and ``mesh=["cpu"] * n`` engines, each on the torch stages and with
``wave_kernel=True`` (the wave and sender kernels' plain versions, the CPU
side of the kernels that run these models' CUDA steps on the card); and
checkpoints written byte-equal to JAX's. All of it is integer
arithmetic: every comparison is exact.
"""

import os
import re
import sys

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
import sliding_puzzle as ref_puzzle  # noqa: E402
from stateright_tpu import test_util as ref_util  # noqa: E402
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
from stateright_tpu_torch import carry, test_util, wave  # noqa: E402
from stateright_tpu_torch import checkpoint_format as ckpt  # noqa: E402
from stateright_tpu_torch.models import (  # noqa: E402
    increment, increment_lock, sliding_puzzle)
from stateright_tpu_torch.model import Property  # noqa: E402
from stateright_tpu_torch.packing import compile_layout  # noqa: E402

torch.set_num_threads(2)

#: each model's JAX and port twins, by a key's name and its size
MODELS = {
    "linear_equation": (lambda abc: ref_util.LinearEquation(*abc),
                        lambda abc: test_util.LinearEquation(*abc)),
    "increment": (ref_inc.IncrementModel, increment.IncrementModel),
    "increment_lock": (ref_lock.IncrementLockModel,
                       increment_lock.IncrementLockModel),
    "puzzle": (lambda rc: ref_puzzle.SlidingPuzzle(*rc),
               lambda rc: sliding_puzzle.SlidingPuzzle(*rc)),
}


def _pair(key):
    name, size = key
    ref, ours = MODELS[name]
    return ref(size), ours(size)


def _id(key):
    return f"{key[0]}-{key[1]}" if not isinstance(key[1], tuple) else (
        f"{key[0]}-" + "-".join(str(x) for x in key[1]))


def _levels(ref_model, levels=64, cap=None, seed=0, batch=64):
    """Rows ``ref_model``'s device model reaches level by level from
    init under ``jit(vmap(step))``, each level a seeded sample of at most
    ``cap`` rows (all of them without a cap): ``uint32[N, W]``."""
    dm = ref_model.device_model()
    step = jax.jit(jax.vmap(dm.step))
    rng = np.random.default_rng(seed)
    rows = np.stack([np.asarray(dm.encode(s), np.uint32)
                     for s in ref_model.init_states()])
    seen, out = {r.tobytes() for r in rows}, [rows]
    for _ in range(levels):
        nxt = []
        for i in range(0, len(rows), batch):
            part = rows[i:i + batch]
            pad = np.concatenate([part, np.repeat(part[:1], batch - len(part),
                                                  0)])
            succ, valid = (np.asarray(a) for a in step(jnp.asarray(pad)))
            for r in succ[:len(part)][valid[:len(part)]]:
                if r.tobytes() not in seen:
                    seen.add(r.tobytes())
                    nxt.append(r)
        if not nxt:
            break
        rows = np.stack(nxt)
        if cap is not None and len(rows) > cap:
            rows = rows[np.sort(rng.choice(len(rows), cap, replace=False))]
        out.append(rows)
    return np.concatenate(out)


def adversarial(dm, n, rng):
    """Seeded rows no run reaches: lanes of every size, most of them small
    (so that comparisons, pcs and cells go both ways), some at the top of
    the uint32 range (so that the increments wrap)."""
    w = dm.state_width
    rows = rng.integers(0, 1 << 32, (n, w), dtype=np.uint64)
    small = rng.random((n, w)) < 0.7
    rows[small] = rng.integers(0, 14, small.sum())
    top = rng.random((n, w)) < 0.05
    rows[top] = 0xFFFFFFFF - rng.integers(0, 3, top.sum())
    return rows.astype(np.uint32)


#: the models and sizes the row-level tests take, with their level cap
ROW_KEYS = [("linear_equation", (2, 4, 7)), ("increment", 2),
            ("increment", 3), ("increment", 16), ("increment_lock", 2),
            ("increment_lock", 3), ("increment_lock", 8), ("puzzle", (2, 3)),
            ("puzzle", (3, 3)), ("puzzle", (4, 3))]


@pytest.fixture(scope="module")
def rows():
    """Reachable rows of each model in ``ROW_KEYS``: every one of the
    small spaces, a seeded sample a level of the large ones."""
    out = {}
    for key in ROW_KEYS:
        ref_model, _ = _pair(key)
        small = key in (("increment", 2), ("increment", 3),
                        ("increment_lock", 2), ("increment_lock", 3),
                        ("puzzle", (2, 3)))
        out[key] = _levels(ref_model, levels=24 if not small else 64,
                           cap=None if small else 40, seed=len(out))
    assert len(out[("puzzle", (2, 3))]) == 360
    assert len(out[("increment", 2)]) == 13
    return out


# -- Layout, init state, codec ------------------------------------------------


@pytest.mark.parametrize("key", ROW_KEYS, ids=_id)
def test_layout_init_and_codec_match_jax(rows, key):
    ref_model, model = _pair(key)
    ref, dm = ref_model.device_model(), model.device_model()
    assert (dm.state_width, dm.max_fanout) == (ref.state_width,
                                               ref.max_fanout)
    # JAX's fixtures are not DeviceModel subclasses: no lane_bits there.
    assert dm.lane_bits() == getattr(ref, "lane_bits", lambda: None)()
    assert dm.error_lane is None and ref.error_lane is None
    init, ref_init = model.init_states(), ref_model.init_states()
    assert [repr(s) for s in init] == [repr(s) for s in ref_init]
    assert np.array_equal(dm.encode(init[0]), ref.encode(ref_init[0]))
    for r in rows[key]:
        state = dm.decode(r)
        assert repr(state) == repr(ref.decode(r))
        assert np.array_equal(dm.encode(state), r)
    assert [(p.name, p.expectation.value) for p in model.properties()] == [
        (p.name, p.expectation.value) for p in ref_model.properties()]
    # A checkpoint header names the model by its class: the same name.
    assert type(model).__name__ == type(ref_model).__name__


# -- The device functions -----------------------------------------------------


def _assert_step_equal(r_step, dm, part):
    succ, valid = dm.step(carry.rows_in(part))
    r_succ, r_valid = (np.asarray(a) for a in r_step(jnp.asarray(part)))
    assert np.array_equal(valid.numpy(), r_valid)
    assert np.array_equal(carry.rows_out(succ), r_succ)
    return int(r_valid.sum())


@pytest.mark.parametrize("key", ROW_KEYS, ids=_id)
def test_step_matches_jax(rows, key):
    """A ragged batch of 37 rows at a time, reachable ones, then
    adversarial: ``valid`` and every successor's lanes bit for bit (the
    invalid ones' too: the kernels store them)."""
    ref_model, model = _pair(key)
    ref, dm = ref_model.device_model(), model.device_model()
    r_step = jax.jit(jax.vmap(ref.step))
    rng = np.random.default_rng(len(rows[key]))
    n_valid = 0
    for part_rows in (rows[key], adversarial(dm, 370, rng)):
        for i in range(0, len(part_rows), 37):
            n_valid += _assert_step_equal(r_step, dm, part_rows[i:i + 37])
    assert 0 < n_valid < (len(rows[key]) + 370) * dm.max_fanout or (
        key[0] == "linear_equation")


@pytest.mark.parametrize("key", ROW_KEYS, ids=_id)
def test_properties_match_jax(rows, key):
    ref_model, model = _pair(key)
    ref, dm = ref_model.device_model(), model.device_model()
    r_props = ref.device_properties()
    # The reachable rows, adversarial ones, and the init state rotated
    # (the puzzle's solved board among them).
    init = dm.encode(model.init_states()[0])
    x = np.concatenate([rows[key], adversarial(dm, 200,
                                                np.random.default_rng(3)),
                        np.stack([np.roll(init, k) for k in range(3)]),
                        np.arange(dm.state_width, dtype=np.uint32)[None]])
    assert sorted(dm.device_properties()) == sorted(r_props)
    for name, fn in dm.device_properties().items():
        want = np.asarray(jax.vmap(r_props[name])(jnp.asarray(x)))
        got = fn(carry.rows_in(x)).numpy()
        assert np.array_equal(got, want), name
        # Both verdicts occur, but (2, 4, 7) has no solution at all.
        assert got.any() != (key[0] == "linear_equation"), name
        assert not got.all(), name


@pytest.mark.parametrize("key", [k for k in ROW_KEYS
                                 if k[0] in ("increment", "increment_lock")],
                         ids=_id)
def test_representative_matches_jax(rows, key):
    """The threads sorted by their (t, pc) pairs, as JAX's stable argsort
    sorts them, on reachable rows and on adversarial ones (pcs past the
    key's span and keys that wrap: equal keys of unequal pairs)."""
    ref_model, model = _pair(key)
    ref, dm = ref_model.device_model(), model.device_model()
    x = np.concatenate([rows[key], adversarial(dm, 400,
                                                np.random.default_rng(5))])
    got = carry.rows_out(dm.representative(carry.rows_in(x)))
    want = np.asarray(jax.jit(jax.vmap(ref.representative))(jnp.asarray(x)))
    assert np.array_equal(got, want)
    assert (got != x).any()


def test_puzzle_and_fixtures_have_no_symmetry():
    for model in (sliding_puzzle.SlidingPuzzle(2, 3),
                  test_util.LinearEquation(2, 4, 7)):
        assert model.device_model().representative(
            torch.zeros((1, model.device_model().state_width),
                        dtype=torch.int64)) is None
        with pytest.raises(NotImplementedError, match="representative"):
            model.checker().symmetry().spawn_cuda_bfs(device="cpu")


# -- CUDA device code: names and instances ------------------------------------


@pytest.mark.parametrize("dm, want", [
    (increment.IncrementDevice(4), ("increment", (4,))),
    (increment_lock.IncrementLockDevice(8), ("increment_lock", (8,))),
    (sliding_puzzle.PuzzleDevice(4, 3), ("sliding_puzzle", (4, 3))),
    (test_util.LinearEquation(2, 4, 7).device_model(),
     ("linear_equation", ()))],
    ids=["increment-4", "increment_lock-8", "puzzle-4x3", "linear_equation"])
def test_cuda_model_names_each_model(dm, want):
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    name, params, lanes = wave.cuda_model(dm, layout)
    assert (name, params) == want
    assert lanes.shape == (5 * dm.state_width,)


def test_dgraph_cuda_model_carries_its_table():
    """The graph's table goes to the entry point as a host int32 array:
    the node count, the fanout, each node's degree and the successors
    row by row; a graph past the device code's bound is refused."""
    graph = (test_util.DGraph.with_property(
        Property.always("p")).with_path([0, 3, 1])
        .with_path([3, 2]).with_path([3, 0]))
    dm = graph.device_model()
    layout = compile_layout(None, 1)
    name, (table,), _ = wave.cuda_model(dm, layout)
    assert name == "dgraph" and table.dtype == np.int32
    assert table.tolist() == [4, 3, 1, 0, 0, 3,
                              3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2]
    big = test_util.DGraph.with_property(
        Property.always("p")).with_path([0, 40])
    with pytest.raises(NotImplementedError, match="wave_kernel=False"):
        wave.cuda_model(big.device_model(), layout)


@pytest.mark.parametrize("dm", [increment.IncrementDevice(17),
                                increment_lock.IncrementLockDevice(17),
                                sliding_puzzle.PuzzleDevice(4, 5),
                                sliding_puzzle.PuzzleDevice(1, 17)],
                         ids=["increment-17", "increment_lock-17",
                              "puzzle-4x5", "puzzle-1x17"])
def test_cuda_model_refuses_sizes_with_no_instance(dm):
    """A size past every instance the entry point holds is refused when
    the wave kernel is set up, with the range it holds and the hint to run
    it on the torch stages."""
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    with pytest.raises(NotImplementedError, match="wave_kernel=False"):
        wave.cuda_model(dm, layout)
    with pytest.raises(NotImplementedError, match="1 to 16|2 to 16 cells"):
        wave.cuda_model(dm, layout)


@pytest.mark.parametrize("dm", [increment.IncrementDevice(3),
                                increment_lock.IncrementLockDevice(6),
                                sliding_puzzle.PuzzleDevice(2, 2),
                                sliding_puzzle.PuzzleDevice(3, 4)],
                         ids=["increment-3", "increment_lock-6", "puzzle-2x2",
                              "puzzle-3x4"])
def test_cuda_model_holds_sizes_the_fixed_instances_refused(dm):
    """Sizes the entry points once refused (they held fixed sizes): the
    registry's default of three threads, a count between two capacities,
    and boards other than 2x3, 3x3 and 4x3 now have an instance."""
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    name, params, lanes = wave.cuda_model(dm, layout)
    assert params == ((dm.thread_count,) if hasattr(dm, "thread_count")
                      else (dm.rows, dm.cols))
    assert lanes.shape == (5 * dm.state_width,)


def _instances(name):
    src = os.path.join(os.path.dirname(wave.__file__), "csrc",
                       f"{name}.cuh")
    with open(src) as f:
        return f.read()


@pytest.mark.parametrize("name, cls", [
    ("increment", increment.IncrementDevice),
    ("increment_lock", increment_lock.IncrementLockDevice)])
def test_thread_instances_match_the_entry_point(name, cls):
    """``CUDA_INSTANCES`` lists exactly the thread counts that the dispatch
    of ``csrc/models/<name>.cuh`` (which ``csrc/wave_<name>.cu`` calls)
    holds: each capacity from one past the last to its own."""
    found = re.findall(r"if \(threads <= (\d+)\) return fn\(\w+<(\d+)>"
                       r"\{threads\}\)", _instances("models/" + name))
    assert found and all(a == b for a, b in found)
    caps = [int(a) for a, _ in found]
    assert caps == sorted(caps)
    assert "if (threads < 1) return none;" in _instances("models/" + name)
    assert tuple(range(1, caps[-1] + 1)) == tuple(cls.CUDA_INSTANCES)


def test_puzzle_instances_match_the_entry_point():
    """``CUDA_INSTANCES`` lists exactly the boards the dispatch of
    ``csrc/models/sliding_puzzle.cuh`` holds: every board of 2 cells up to
    its largest capacity."""
    text = _instances("models/sliding_puzzle")
    found = re.findall(r"if \(n <= (\d+)\) return fn\(SlidingPuzzle<(\d+)>"
                       r"::make\(rows, cols\)\)", text)
    assert found and all(a == b for a, b in found)
    assert "if (n < 2) return none;" in text
    most = max(int(a) for a, _ in found)
    boards = {(r, c) for r in range(1, most + 1) for c in range(1, most + 1)
              if 2 <= r * c <= most}
    assert set(sliding_puzzle.PuzzleDevice.CUDA_INSTANCES) == boards
    assert len(sliding_puzzle.PuzzleDevice.CUDA_INSTANCES) == len(boards)


class _OwnStep(increment.IncrementDevice):
    """Changes the step, so increment's device code no longer computes
    it."""

    def step(self, rows):
        succ, valid = super().step(rows)
        return succ, valid & (rows[:, :1] < 2)


def test_wave_kernel_refuses_a_subclass_with_its_own_step():
    """On a CUDA device ``wave_kernel=True`` raises at spawn for a model
    whose step its device code does not compute (no card is needed to
    reach it); on the CPU it runs the plain version."""

    class Sys(increment.IncrementModel):
        def device_model(self):
            return _OwnStep(self.thread_count)

    for spawn in (dict(device="cuda:0"), dict(mesh=["cuda:0"] * 2)):
        with pytest.raises(NotImplementedError,
                           match=r"_OwnStep has no CUDA.*'step'"):
            Sys(2).checker().spawn_cuda_bfs(wave_kernel=True, **spawn)
    c = Sys(2).checker().spawn_cuda_bfs(device="cpu", wave_kernel=True,
                                        batch_size=64).join()
    assert c.kernel_path() == "megakernel_plain"


# -- The whole slice ----------------------------------------------------------


def _ref_chains(c):
    dm = c._dm
    return {name: ([host_fp64(np.asarray(dm.encode(s), np.uint32))
                    for s in p.into_states()],
                   [repr(a) for a in p.into_actions()])
            for name, p in c.discoveries().items()}


def _chains(c):
    return {name: (p.fingerprints, [repr(a) for a in p.into_actions()])
            for name, p in c.discoveries().items()}


#: the engines both sides run: JAX's spawn knobs, the port's (the classic
#: engine without the successor ladder, whose rungs JAX compiles a program
#: each)
ENGINES = {"fused": (dict(), dict(device="cpu")),
           "classic": (dict(fused=False, pack_arena=True, succ_ladder=False),
                       dict(device="cpu", fused=False, succ_ladder=False)),
           "sharded": (dict(sharded=True), dict())}


def _spawn_pair(key, engine, sym=False, n=3, **kw):
    ref_model, model = _pair(key)
    rb, b = ref_model.checker(), model.checker()
    if sym:
        rb, b = rb.symmetry(), b.symmetry()
    ref_kw, kw_ = ENGINES[engine]
    ref_kw, kw_ = dict(ref_kw, **kw), dict(kw_, **kw)
    if engine == "sharded":
        ref_kw["mesh"] = RefMesh(np.array(jax.devices()[:n]), ("shard",))
        kw_["mesh"] = ["cpu"] * n
    return (lambda: rb.spawn_tpu_bfs(**ref_kw).join(),
            lambda **k: b.spawn_cuda_bfs(**kw_, **k).join())


def assert_engine_matches_jax(key, engine, sym, want, found, batch=64):
    """The port on ``engine``, on the torch stages and with
    ``wave_kernel=True``, against JAX's run of the same engine at the same
    batch: counts, capacities and discovery chains (fingerprints and
    actions); each chain replays to a state that has its property's
    verdict."""
    ref_spawn, spawn = _spawn_pair(key, engine, sym, batch_size=batch)
    ref = ref_spawn()
    counts = (ref.unique_state_count(), ref.state_count())
    if want is not None:
        assert counts == want
    chains = _ref_chains(ref)
    assert sorted(chains) == found
    paths = {"fused": ("dedup_plain", "megakernel_plain"),
             "classic": ("dedup_plain", "megakernel_plain"),
             "sharded": ("dedup_plain", "sender_plain")}[engine]
    for wave_kernel, path in zip((False, True), paths):
        ours = spawn(wave_kernel=wave_kernel)
        assert ours.kernel_path() == path
        assert (ours.unique_state_count(), ours.state_count()) == counts
        assert ours._capacity == ref._capacity
        if getattr(ref, "_ucap", None) is not None:
            assert ours._ucap == ref._ucap
        assert _chains(ours) == chains
        for name, path_ in ours.discoveries().items():
            assert [repr(s) for s in path_.into_states()] == [
                repr(s) for s in ref.discovery(name).into_states()]


#: (key, symmetry, counts, discoveries, batch); the early-exit runs'
#: counts depend on the batch, so those are JAX's at the same batch
CASES = [
    (("linear_equation", (2, 4, 7)), False, (65536, 131073), [], 1024),
    (("linear_equation", (2, 10, 14)), False, None, ["solvable"], 64),
    (("increment", 2), False, (13, 15), ["fin"], 64),
    (("increment", 2), True, (8, 10), ["fin"], 64),
    (("increment_lock", 2), False, (17, 17), [], 64),
    (("increment_lock", 2), True, (9, 10), [], 64),
    (("puzzle", (2, 3)), False, (360, 841), ["solved"], 64)]


@pytest.mark.parametrize("engine", ["fused", "classic", "sharded"])
@pytest.mark.parametrize("case", CASES, ids=[
    _id(c[0]) + ("-sym" if c[1] else "") for c in CASES])
def test_each_engine_matches_jax(case, engine):
    key, sym, want, found, batch = case
    assert_engine_matches_jax(key, engine, sym, want, found, batch)


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["fused", "classic", "sharded"])
@pytest.mark.parametrize("case", [
    (("puzzle", (3, 3)), False, (181440, 483841), ["solved"], 4096),
    (("increment", 16), False, None, ["fin"], 1024),
    (("increment", 16), True, None, ["fin"], 1024),
    (("increment_lock", 8), False, (438401, 438401), [], 4096),
    (("increment_lock", 8), True, (33, 61), [], 1024)],
    ids=["puzzle-3x3", "increment-16", "increment-16-sym",
         "increment_lock-8", "increment_lock-8-sym"])
def test_larger_sizes_match_jax(case, engine):
    key, sym, want, found, batch = case
    assert_engine_matches_jax(key, engine, sym, want, found, batch)


@pytest.mark.parametrize("key, sym", [(("puzzle", (2, 3)), False),
                                      (("increment_lock", 3), True),
                                      (("linear_equation", (2, 4, 7)), False)],
                         ids=["puzzle-2-3", "increment_lock-3-sym",
                              "linear_equation-2-4-7"])
def test_full_enumerations_agree_across_engines(key, sym):
    """A run to its end has the same counts on every engine and at every
    batch, and the classic engine's discovery chains are the fused
    engine's: the card's classic runs of a full enumeration are held to
    the fused engine's CPU run, and without discoveries the sharded
    engine's too."""
    _, model = _pair(key)
    b = model.checker().symmetry() if sym else model.checker()
    want = b.spawn_cuda_bfs(device="cpu", batch_size=64).join()
    runs = [b.spawn_cuda_bfs(device="cpu", batch_size=batch,
                             fused=False).join() for batch in (16, 1024)]
    runs += [b.spawn_cuda_bfs(mesh=["cpu"] * 3, batch_size=16).join()]
    for c in runs:
        assert (c.unique_state_count(), c.state_count()) == (
            want.unique_state_count(), want.state_count())
        assert sorted(c.discoveries()) == sorted(want.discoveries())
    for c in runs[:2]:
        assert _chains(c) == _chains(want)


# -- Checkpoints --------------------------------------------------------------


def _sections(path):
    with np.load(path) as data:
        return {k: (data[k].dtype, data[k].shape, data[k].tobytes())
                for k in data.files}


#: the knobs both sides checkpoint with, by engine: JAX's, the port's
CKPT_KNOBS = {
    "fused": (dict(waves_per_dispatch=2, inflight_dispatches=1),
              dict(waves_per_dispatch=2, inflight_dispatches=1)),
    "classic": (dict(fused=False), dict(fused=False)),
    "sharded": (dict(sharded=True, waves_per_dispatch=2,
                     inflight_dispatches=1),
                dict(waves_per_dispatch=2, inflight_dispatches=1))}


def _ckpt_spawns(model, ref_model, engine, n=3):
    """``(JAX's spawn, the port's spawn)`` on ``engine``, each taking a
    builder and knobs."""
    ref_kw, kw = CKPT_KNOBS[engine]
    ref_kw = dict(ref_kw, pack_arena=True)
    if engine == "sharded":
        ref_kw["mesh"] = RefMesh(np.array(jax.devices()[:n]), ("shard",))
        kw = dict(kw, mesh=["cpu"] * n)
    else:
        kw = dict(kw, device="cpu")
    return (lambda b, **k: b.spawn_tpu_bfs(**ref_kw, **k).join(),
            lambda b, **k: b.spawn_cuda_bfs(**kw, **k).join())


@pytest.mark.parametrize("engine", ["fused", "classic", "sharded"])
@pytest.mark.parametrize("key, target, full", [
    (("puzzle", (2, 3)), 200, (360, 841)),
    (("increment_lock", 3), 60, None)], ids=["puzzle-2-3", "increment_lock-3"])
def test_checkpoint_is_jax_byte_for_byte_and_resumes(tmp_path, key, target,
                                                     full, engine):
    """A run stopped at ``target`` states with a checkpoint at every wave:
    every section of the last generation and of its ``.prev`` equal to
    JAX's on the same engine (the puzzle's rows unpacked,
    increment_lock's packed), and each package resumes the other's file
    to the full run's counts and chains."""
    ref_model, model = _pair(key)
    ref_spawn, spawn = _ckpt_spawns(model, ref_model, engine)
    mine, theirs = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    knobs = dict(batch_size=16, checkpoint_every_waves=1)
    ref = ref_spawn(ref_model.checker().target_state_count(target),
                    checkpoint_path=theirs, **knobs)
    ours = spawn(model.checker().target_state_count(target),
                 checkpoint_path=mine, **knobs)
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    assert ours.checkpoints >= 3
    for suffix in ("", ckpt.PREV_SUFFIX):
        want, got = _sections(theirs + suffix), _sections(mine + suffix)
        assert list(got) == list(want)
        for name in want:
            assert got[name] == want[name], (suffix, name)
    assert ckpt.verify_file(mine)["model"] == type(model).__name__
    whole = ref_spawn(ref_model.checker(), batch_size=64)
    from_ours = ref_spawn(ref_model.checker(), resume_from=mine,
                          batch_size=64)
    from_theirs = spawn(model.checker(), resume_from=theirs, batch_size=64)
    counts = (whole.unique_state_count(), whole.state_count())
    if full is not None:
        assert counts == full
    for c in (from_ours, from_theirs):
        assert (c.unique_state_count(), c.state_count()) == counts
    assert _chains(from_theirs) == _ref_chains(from_ours)
