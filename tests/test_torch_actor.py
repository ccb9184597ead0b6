"""The port's ping-pong, and the actor layer's network forms, against JAX's.

Same rows through the JAX package's device model
(``stateright_tpu/tpu/models/pingpong.py`` on
``stateright_tpu/tpu/actor_device.py``, the host model from
``stateright_tpu/actor/actor_test_util.py``) and the port's
(``stateright_tpu_torch/models/pingpong.py`` on
``stateright_tpu_torch/actor_device.py``), in each of the eight forms
(history or not, a lossy network or not, a duplicating one or not): the
layout, the init state and the codec, the batch-first ``step`` on JAX's
reachable rows and on adversarial rows (every action, enabled or not:
Drop and Deliver slots), the boundary and the properties. Then the whole
slice: the reference's counts (14 at ``max_nat`` 1 lossy, 4,094 at 5 lossy
and duplicating, 11 at 5 on a perfect network, ``actor/model.rs:547, 629,
660``) and the history form, through ``spawn_cuda_bfs(device="cpu")``
against JAX ``spawn_tpu_bfs`` at the same batch, in counts, capacities and
discovery chains with their action labels (Drop and Deliver), on the
fused, classic and ``mesh=["cpu"] * n`` engines, each on the torch stages
and with ``wave_kernel=True`` (the plain versions of the kernels that run
ping-pong's CUDA step on the card); the overflow lane raising on each
engine; and a checkpoint written byte-equal to JAX's and resumed across the
packages. All of it is integer arithmetic: every comparison is exact.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as RefMesh

import stateright_tpu.tpu  # noqa: F401  (enables x64)
import stateright_tpu.actor.actor_test_util as ppmod
from stateright_tpu.actor.actor_test_util import PingPongCfg
from stateright_tpu.tpu.hashing import host_fp64
from stateright_tpu.tpu.models.pingpong import PingPongDevice as RefDevice
from stateright_tpu_torch import carry, wave
from stateright_tpu_torch import checkpoint_format as ckpt
from stateright_tpu_torch.actor_device import EMPTY_ENV
from stateright_tpu_torch.models.pingpong import PingPongDevice, PingPongSys
from stateright_tpu_torch.packing import compile_layout

torch.set_num_threads(2)

#: (maintains_history, lossy, duplicating)
FORMS = [(h, lo, d) for h in (False, True) for lo in (False, True)
         for d in (False, True)]


def _form_id(form):
    h, lo, d = form
    return f"h{int(h)}-l{int(lo)}-d{int(d)}"


def _pair(max_nat, form, net_slots=16):
    """``(JAX model, JAX device model, the port's system)`` of a form."""
    h, lossy, dup = form
    cfg = PingPongCfg(maintains_history=h, max_nat=max_nat)
    ref_model = (cfg.into_model().with_lossy_network(lossy)
                 .with_duplicating_network(dup))
    ref_dm = RefDevice(cfg, ppmod, net_slots=net_slots, duplicating=dup,
                       lossy=lossy)
    return ref_model, ref_dm, PingPongSys(max_nat, h, lossy=lossy,
                                          duplicating=dup,
                                          net_slots=net_slots)


def levels(ref_dm, init, n=64, cap=None, seed=0, batch=64):
    """Rows JAX's device step reaches level by level from ``init`` inside
    its boundary under ``jit(vmap(step))``, each level a seeded sample of
    at most ``cap`` rows (all of them without a cap): ``uint32[N, W]``."""
    step = jax.jit(jax.vmap(ref_dm.step))
    inside = jax.jit(jax.vmap(ref_dm.boundary))
    rng = np.random.default_rng(seed)
    rows = np.asarray(init, np.uint32)[None]
    seen, out = {rows[0].tobytes()}, [rows]
    for _ in range(n):
        nxt = []
        for i in range(0, len(rows), batch):
            part = rows[i:i + batch]
            pad = np.concatenate([part, np.repeat(part[:1], batch - len(part),
                                                  0)])
            succ, valid = (np.asarray(a) for a in step(jnp.asarray(pad)))
            succ, valid = succ[:len(part)], valid[:len(part)]
            flat = succ.reshape(-1, succ.shape[-1])
            keep = valid.reshape(-1) & np.asarray(inside(jnp.asarray(flat)))
            for r in flat[keep]:
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


def adversarial(dm, n, rng, env_bits=12):
    """Seeded rows no run reaches: lanes of every size (most of them small,
    so that counts and values compare both ways; some at the top of the
    uint32 range, so that they wrap) and networks of envelopes of random
    fields, garbage and empty ones, half of them sorted."""
    w, off, e = dm.state_width, dm.net_offset, dm.net_slots
    rows = rng.integers(0, 1 << 32, (n, w), dtype=np.uint64)
    small = rng.random((n, w)) < 0.7
    rows[small] = rng.integers(0, 8, small.sum())
    top = rng.random((n, w)) < 0.05
    rows[top] = 0xFFFFFFFF - rng.integers(0, 3, top.sum())
    env = rng.integers(0, 1 << env_bits, (n, e), dtype=np.uint64)
    wide = rng.random((n, e)) < 0.1
    env[wide] = rng.integers(0, 1 << 32, wide.sum(), dtype=np.uint64)
    env[rng.random((n, e)) < 0.3] = EMPTY_ENV
    ordered = rng.random(n) < 0.5
    env[ordered] = np.sort(env[ordered], axis=1)
    rows[:, off:off + e] = env
    return rows.astype(np.uint32)


def assert_rows_match_jax(ref_dm, dm, rows, chunk=37):
    """``step`` (every successor, enabled or not), the boundary of each
    successor and every property, bit for bit, a ragged chunk at a time.
    Returns the valid bits."""
    r_step = jax.jit(jax.vmap(ref_dm.step))
    r_inside = jax.jit(jax.vmap(ref_dm.boundary))
    r_props = ref_dm.device_properties()
    assert sorted(dm.device_properties()) == sorted(r_props)
    valids = []
    for i in range(0, len(rows), chunk):
        part = rows[i:i + chunk]
        succ, valid = dm.step(carry.rows_in(part))
        r_succ, r_valid = (np.asarray(a) for a in r_step(jnp.asarray(part)))
        assert np.array_equal(valid.numpy(), r_valid)
        assert np.array_equal(carry.rows_out(succ), r_succ)
        flat = r_succ.reshape(-1, r_succ.shape[-1])
        assert np.array_equal(
            dm.boundary(carry.rows_in(flat)).numpy(),
            np.asarray(r_inside(jnp.asarray(flat))))
        for name, fn in dm.device_properties().items():
            want = np.asarray(jax.vmap(r_props[name])(jnp.asarray(part)))
            assert np.array_equal(fn(carry.rows_in(part)).numpy(), want), name
        valids.append(r_valid)
    return np.concatenate(valids)


# -- Layout, init state, codec, step ------------------------------------------


@pytest.mark.parametrize("form", FORMS, ids=_form_id)
def test_layout_init_and_codec_match_jax(form):
    ref_model, ref_dm, sys_ = _pair(3, form)
    dm = sys_.device_model()
    assert (dm.state_width, dm.max_fanout, dm.error_lane, dm.net_offset) == (
        ref_dm.state_width, ref_dm.max_fanout, ref_dm.error_lane,
        ref_dm.net_offset)
    assert dm.lane_bits() is None and ref_dm.lane_bits() is None
    init, ref_init = sys_.init_states(), ref_model.init_states()
    assert [repr(s) for s in init] == [repr(s) for s in ref_init]
    assert np.array_equal(dm.encode(init[0]), ref_dm.encode(ref_init[0]))
    for r in levels(ref_dm, ref_dm.encode(ref_init[0])):
        state = dm.decode(r)
        assert repr(state) == repr(ref_dm.decode(r))
        assert np.array_equal(dm.encode(state), r)
    assert [(p.name, p.expectation.value) for p in sys_.properties()] == [
        (p.name, p.expectation.value) for p in ref_model.properties()]


@pytest.mark.parametrize("form", FORMS, ids=_form_id)
def test_step_matches_jax(form):
    """Every reachable row at ``max_nat`` 4 (all of them), then 370
    adversarial ones and the same at 3 network slots (whose inserts
    overflow): each action's successor, its validity, the boundary and the
    properties, bit for bit. On a lossy network the Drop slots (even) and
    the Deliver slots (odd) are each enabled somewhere."""
    ref_model, ref_dm, sys_ = _pair(4, form)
    dm = sys_.device_model()
    rows = levels(ref_dm, ref_dm.encode(ref_model.init_states()[0]))
    rng = np.random.default_rng(sum(form) + 4 * form[0])
    valid = assert_rows_match_jax(ref_dm, dm, rows)
    assert_rows_match_jax(ref_dm, dm, adversarial(dm, 370, rng))
    _, ref3, sys3 = _pair(4, form, net_slots=3)
    assert_rows_match_jax(ref3, sys3.device_model(),
                          adversarial(sys3.device_model(), 200, rng))
    if form[1]:
        assert valid[:, 0::2].any() and valid[:, 1::2].any()


# -- CUDA device code: names and instances ------------------------------------


@pytest.mark.parametrize("form", FORMS, ids=_form_id)
def test_cuda_model_names_each_form(form):
    dm = _pair(5, form, net_slots=26)[2].device_model()
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    name, params, lanes = wave.cuda_model(dm, layout)
    assert (name, params) == ("pingpong", (*(int(x) for x in form), 5, 26))
    assert lanes.shape == (5 * dm.state_width,)
    assert layout.packed_width == dm.state_width == 31


def test_cuda_model_refuses_more_slots_than_its_instance():
    """Past the largest instance's 64 slots the wave kernel's setup
    refuses, naming the range held; 27 slots, past the earlier instance's
    26, now run on the instance of 64."""
    dm = PingPongDevice(5, net_slots=65)
    layout = compile_layout(None, dm.state_width)
    with pytest.raises(NotImplementedError, match="wave_kernel=False"):
        wave.cuda_model(dm, layout)
    with pytest.raises(NotImplementedError, match="holds 1 to 64"):
        wave.cuda_model(dm, layout)
    dm = PingPongDevice(5, net_slots=27)
    name, params, _ = wave.cuda_model(dm, compile_layout(None,
                                                         dm.state_width))
    assert (name, params[-1]) == ("pingpong", 27)


def test_cuda_instance_matches_the_entry_point():
    """``CUDA_INSTANCES`` are the instances the dispatch of
    ``csrc/models/pingpong.cuh`` (which ``csrc/wave_pingpong.cu`` calls)
    picks from, smaller first (the form is runtime there: all eight
    forms), and ``CUDA_MAX_SLOTS`` the larger."""
    src = os.path.join(os.path.dirname(wave.__file__), "csrc", "models",
                       "pingpong.cuh")
    with open(src) as f:
        found = re.findall(r"if \(e <= (\d+)\) return fn\(PingPong<(\d+)>",
                           f.read())
    assert found and all(a == b for a, b in found)
    assert tuple(int(a) for a, _ in found) == PingPongDevice.CUDA_INSTANCES
    assert PingPongDevice.CUDA_MAX_SLOTS == 64


class _OwnDelivery(PingPongDevice):
    """Changes the delivery, so ping-pong's device code no longer
    computes it."""

    def deliver(self, body, env):
        new_body, handled, outs = super().deliver(body, env)
        return new_body, handled & (env < 64), outs


def test_wave_kernel_refuses_a_subclass_with_its_own_delivery():
    class Sys(PingPongSys):
        def device_model(self):
            return _OwnDelivery(self.max_nat, lossy=True)

    for spawn in (dict(device="cuda:0"), dict(mesh=["cuda:0"] * 2)):
        with pytest.raises(NotImplementedError,
                           match=r"_OwnDelivery has no CUDA.*'deliver'"):
            Sys(5, lossy=True).checker().spawn_cuda_bfs(wave_kernel=True,
                                                        **spawn)


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


def _state(s):
    """An actor-model state as its parts' reprs, the network as a set (a
    JAX path replays the host model, whose set keeps the order of its
    inserts; the port's decodes the sorted list)."""
    return (repr(s.actor_states), frozenset(repr(e) for e in s.network),
            repr(s.is_timer_set), repr(s.history))


def _ref_mesh(n):
    return RefMesh(np.array(jax.devices()[:n]), ("shard",))


#: the engines both sides run: JAX's spawn knobs, the port's (the classic
#: engine without the successor ladder, whose rungs JAX compiles a program
#: each)
ENGINES = {"fused": (dict(), dict(device="cpu")),
           "classic": (dict(fused=False, pack_arena=True, succ_ladder=False),
                       dict(device="cpu", fused=False, succ_ladder=False)),
           "sharded": (dict(sharded=True), dict())}
PATHS = {"fused": ("dedup_plain", "megakernel_plain"),
         "classic": ("dedup_plain", "megakernel_plain"),
         "sharded": ("dedup_plain", "sender_plain")}


def spawn_pair(ref_model, ref_dm, sys_, engine, n=3, **kw):
    """``(JAX's spawn, the port's spawn)`` of one model on ``engine`` with
    the same knobs."""
    ref_kw, kw_ = ENGINES[engine]
    ref_kw, kw_ = dict(ref_kw, **kw), dict(kw_, **kw)
    if engine == "sharded":
        ref_kw["mesh"], kw_["mesh"] = _ref_mesh(n), ["cpu"] * n
    return (lambda: ref_model.checker().spawn_tpu_bfs(
                device_model=ref_dm, **ref_kw).join(),
            lambda **k: sys_.checker().spawn_cuda_bfs(**kw_, **k).join())


def assert_engine_matches_jax(ref_spawn, spawn, engine, want, found):
    """The port on ``engine``, on the torch stages and with
    ``wave_kernel=True``, against JAX's run of the same engine: counts,
    capacities and discovery chains (fingerprints and action labels), each
    chain's states decoded as JAX's (``_state``). Returns the port's
    torch-stage run."""
    ref = ref_spawn()
    counts = (ref.unique_state_count(), ref.state_count())
    if want is not None:
        assert counts == want
    chains = _ref_chains(ref)
    assert sorted(chains) == found
    runs = []
    for wave_kernel, path in zip((False, True), PATHS[engine]):
        ours = spawn(wave_kernel=wave_kernel)
        assert ours.kernel_path() == path
        assert (ours.unique_state_count(), ours.state_count()) == counts
        assert ours._capacity == ref._capacity
        if getattr(ref, "_ucap", None) is not None:
            assert ours._ucap == ref._ucap
        assert _chains(ours) == chains
        for name, p in ours.discoveries().items():
            assert [_state(s) for s in p.into_states()] == [
                _state(s) for s in ref.discovery(name).into_states()]
        runs.append(ours)
    return runs[0]


FOUND = ["can reach max", "must exceed max", "must reach max"]
#: (max_nat, form, counts, discoveries, batch): the reference's three
#: counts and the history form
CASES = [(1, (False, True, True), (14, 21), FOUND, 64),
         (5, (False, True, True), (4094, 21505), FOUND, 256),
         (5, (False, False, False), (11, 11),
          ["can reach max", "must exceed max"], 64),
         (3, (True, True, True), (254, 833), FOUND, 256)]


@pytest.mark.parametrize("engine", ["fused", "classic", "sharded"])
@pytest.mark.parametrize("case", CASES, ids=["lossy-14", "lossy-dup-4094",
                                             "perfect-11", "history-3"])
def test_each_engine_matches_jax(case, engine):
    max_nat, form, want, found, batch = case
    ref_spawn, spawn = spawn_pair(*_pair(max_nat, form), engine,
                                  batch_size=batch)
    ours = assert_engine_matches_jax(ref_spawn, spawn, engine, want, found)
    if form == (False, True, True):
        # Losing the first message gets stuck: a Drop.
        assert _chains(ours)["must reach max"][1] == [
            "Drop(Envelope { src: Id(0), dst: Id(1), msg: Ping(0) })"]
    if form == (False, False, False):
        # The perfect network's terminal state: both counts at 5.
        assert ours.discovery("must exceed max").last_state(
        ).actor_states == [5, 5]
    assert ours.discovery("delta within 1") is None
    assert ours.discovery("#in <= #out") is None


@pytest.mark.parametrize("engine", ["fused", "classic", "sharded"])
@pytest.mark.parametrize("wave_kernel", [False, True],
                         ids=["torch", "kernel"])
def test_network_overflow_raises(engine, wave_kernel):
    """The overflow lane raises on every engine and path, as JAX's
    (``tests/test_tpu_actor.py``): a bounded network is the device
    encoding's limit, so silence would mean states missed."""
    sys_ = PingPongSys(5, lossy=True, net_slots=4)
    _, kw = ENGINES[engine]
    if engine == "sharded":
        kw = dict(kw, mesh=["cpu"] * 3)
    with pytest.raises(RuntimeError, match="error lane"):
        sys_.checker().spawn_cuda_bfs(batch_size=32, wave_kernel=wave_kernel,
                                      **kw).join()


@pytest.mark.parametrize("engine", ["fused", "classic", "sharded"])
def test_discovery_chains_do_not_depend_on_the_batch(engine):
    """An engine's counts and chains are the same at every batch, and the
    classic engine's are the fused one's: the card's full-width runs are
    held to runs at another batch, and to each other."""
    sys_ = PingPongSys(5, lossy=True)
    _, kw = ENGINES[engine]
    if engine == "sharded":
        kw = dict(kw, mesh=["cpu"] * 3)
    want = sys_.checker().spawn_cuda_bfs(device="cpu", batch_size=64).join()
    runs = [sys_.checker().spawn_cuda_bfs(batch_size=b, **kw).join()
            for b in (16, 1024)]
    for c in runs:
        assert (c.unique_state_count(), c.state_count()) == (4094, 21505)
        assert _chains(c) == _chains(runs[0])
    if engine != "sharded":
        assert _chains(runs[0]) == _chains(want)


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["fused", "sharded"])
def test_max_nat_9_matches_jax(engine):
    """``max_nat`` 9, lossy and duplicating, on 22 slots: 1,048,574 /
    9,699,329 (2^20 - 2 and 2^20 x 9.25 + 1, the pattern the card's
    ``max_nat`` 11 is read against)."""
    ref_spawn, spawn = spawn_pair(*_pair(9, (False, True, True),
                                         net_slots=22), engine,
                                  batch_size=4096)
    assert_engine_matches_jax(ref_spawn, spawn, engine,
                              (1_048_574, 9_699_329), FOUND)


# -- Checkpoints --------------------------------------------------------------


def _sections(path):
    with np.load(path) as data:
        return {k: (data[k].dtype, data[k].shape, data[k].tobytes())
                for k in data.files}


#: the knobs both sides checkpoint with
KNOBS = dict(batch_size=16, waves_per_dispatch=2, inflight_dispatches=1,
             checkpoint_every_waves=1)


def test_checkpoint_is_jax_byte_for_byte_and_resumes(tmp_path):
    """Ping-pong 5, lossy and duplicating, stopped at 3,000 states: every
    section of the last generation and of its ``.prev`` equal to JAX's
    (rows unpacked: no ``lane_bits``), and each package resumes the
    other's file to the full run's counts and chains."""
    ref_model, ref_dm, sys_ = _pair(5, (False, True, True))
    mine, theirs = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    ref = ref_model.checker().target_state_count(3000).spawn_tpu_bfs(
        device_model=ref_dm, pack_arena=True, checkpoint_path=theirs,
        **KNOBS).join()
    ours = sys_.checker().target_state_count(3000).spawn_cuda_bfs(
        device="cpu", checkpoint_path=mine, **KNOBS).join()
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    assert ours.state_count() < 21505 and ours.checkpoints >= 3
    for suffix in ("", ckpt.PREV_SUFFIX):
        want, got = _sections(theirs + suffix), _sections(mine + suffix)
        assert list(got) == list(want)
        for name in want:
            assert got[name] == want[name], (suffix, name)
    assert ckpt.verify_file(mine)["model"] == "ActorModel"
    knobs = dict(batch_size=256, inflight_dispatches=1)
    from_ours = ref_model.checker().spawn_tpu_bfs(
        device_model=ref_dm, pack_arena=True, resume_from=mine,
        **knobs).join()
    from_theirs = sys_.checker().spawn_cuda_bfs(
        device="cpu", resume_from=theirs, **knobs).join()
    for c in (from_ours, from_theirs):
        assert (c.unique_state_count(), c.state_count()) == (4094, 21505)
    assert _chains(from_theirs) == _ref_chains(from_ours)
    assert sorted(_chains(from_theirs)) == FOUND
