"""The port's viewstamped replication against JAX's.

Same rows through the JAX package's device model
(``stateright_tpu/tpu/models/vsr.py``, the host model from
``stateright_tpu/actor/viewstamped.py``) and the port's
(``stateright_tpu_torch/models/vsr.py``): the layout, the init state and
the codec at 2 to 4 replicas, the batch-first ``step`` (every Deliver, Drop
and Timeout, enabled or not, on the duplicating network and on the lossy
and non-duplicating forms) on JAX's reachable rows and on adversarial
rows, the boundary and the properties. Then the whole slice: 2 replicas
at ``max_view`` 1 (63 / 169, its three sometimes witnesses; the host
BFS's counts, ``tests/test_vsr.py``) through ``spawn_cuda_bfs(device=
"cpu")`` against JAX ``spawn_tpu_bfs`` in counts, capacities and discovery
chains with their action labels (Timeouts among them), on the fused,
classic and ``mesh=["cpu"] * n`` engines, each on the torch stages and
with ``wave_kernel=True``; the overflow lane; and a checkpoint written
byte-equal to JAX's and resumed across the packages. Under ``-m slow``:
3 replicas at ``max_view`` 1 (5,531 / 32,006) and at 2 on 40 slots
(291,761 / 1,859,959), and the lossy form.
"""

import os
import re

import numpy as np
import pytest

from stateright_tpu.actor.viewstamped import VsrCfg
from stateright_tpu.tpu.models.vsr import VsrDevice as RefDevice
from stateright_tpu_torch import checkpoint_format as ckpt
from stateright_tpu_torch import wave
from stateright_tpu_torch.models.vsr import VsrDevice, VsrSys
from stateright_tpu_torch.packing import compile_layout

from test_torch_actor import (ENGINES, _chains, _ref_chains, _sections,
                              adversarial, assert_engine_matches_jax,
                              assert_rows_match_jax, levels, spawn_pair)

SOMETIMES = ["can commit", "commit survives view change",
             "view change completes"]


def _pair(n, max_view=1, lossy=False, duplicating=True, net_slots=None):
    """``(JAX model, JAX device model, the port's system)``."""
    cfg = VsrCfg(n=n, max_view=max_view, lossy=lossy,
                 duplicating=duplicating)
    return (cfg.into_model(), RefDevice(cfg, net_slots=net_slots),
            VsrSys(n, max_view, lossy=lossy, duplicating=duplicating,
                   net_slots=net_slots))


#: (replicas, max_view, lossy, duplicating)
KEYS = [(2, 1, False, True), (2, 1, True, True), (2, 1, False, False),
        (3, 1, False, True), (3, 2, True, False), (4, 1, False, True)]


def _key_id(key):
    n, mv, lossy, dup = key
    return f"n{n}-v{mv}-l{int(lossy)}-d{int(dup)}"


@pytest.fixture(scope="module")
def rows():
    """Rows JAX's step reaches level by level from init inside the
    boundary: every one at 2 replicas, a seeded sample of 40 a level at 3
    and 4."""
    out = {}
    for key in KEYS:
        ref_model, ref_dm, _ = _pair(*key)
        init = ref_dm.encode(ref_model.init_states()[0])
        out[key] = levels(ref_dm, init, cap=None if key[0] == 2 else 40,
                          seed=len(out))
    assert len(out[2, 1, False, True]) == 63
    return out


@pytest.mark.parametrize("key", KEYS, ids=_key_id)
def test_layout_init_and_codec_match_jax(rows, key):
    ref_model, ref_dm, sys_ = _pair(*key)
    dm = sys_.device_model()
    assert (dm.state_width, dm.max_fanout, dm.error_lane, dm.net_offset,
            dm.timer_offset, dm.n_timers, dm.max_out) == (
        ref_dm.state_width, ref_dm.max_fanout, ref_dm.error_lane,
        ref_dm.net_offset, ref_dm.timer_offset, ref_dm.n_timers,
        ref_dm.max_out)
    assert dm.lane_bits() is None and ref_dm.lane_bits() is None
    init, ref_init = sys_.init_states(), ref_model.init_states()
    assert [repr(s) for s in init] == [repr(s) for s in ref_init]
    assert np.array_equal(dm.encode(init[0]), ref_dm.encode(ref_init[0]))
    for r in rows[key]:
        state = dm.decode(r)
        assert repr(state) == repr(ref_dm.decode(r))
        assert np.array_equal(dm.encode(state), r)
    assert [(p.name, p.expectation.value) for p in sys_.properties()] == [
        (p.name, p.expectation.value) for p in ref_model.properties()]


@pytest.mark.parametrize("key", KEYS, ids=_key_id)
def test_step_matches_jax(rows, key):
    """Reachable rows, then 370 adversarial ones (envelopes to replicas
    past the group, where JAX's gather clamps and its scatter drops) and
    200 at 4 network slots (whose inserts overflow): every action's
    successor, its validity, the boundary and the properties, bit for
    bit. Deliveries and Timeouts are each enabled somewhere, Drops too on
    a lossy network."""
    ref_model, ref_dm, sys_ = _pair(*key)
    dm = sys_.device_model()
    rng = np.random.default_rng(sum(key))
    valid = assert_rows_match_jax(ref_dm, dm, rows[key])
    assert_rows_match_jax(ref_dm, dm, adversarial(dm, 370, rng, 15))
    _, ref4, sys4 = _pair(*key, net_slots=4)
    assert_rows_match_jax(ref4, sys4.device_model(),
                          adversarial(sys4.device_model(), 200, rng, 15))
    e, lossy = dm.net_slots, int(dm.lossy)
    assert valid[:, e * (1 + lossy):].any()
    assert valid[:, lossy:e * (1 + lossy):1 + lossy].any()
    if lossy:
        assert valid[:, 0:2 * e:2].any()


# -- CUDA device code: names and instances ------------------------------------


@pytest.mark.parametrize("n, net_slots", [(2, None), (3, 40), (4, 48)])
def test_cuda_model_names_each_instance(n, net_slots):
    dm = VsrDevice(n, 1, lossy=True, duplicating=False, net_slots=net_slots)
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    name, params, lanes = wave.cuda_model(dm, layout)
    assert (name, params) == ("vsr", (n, 1, 0, 1, dm.net_slots))
    assert layout.packed_width == dm.state_width
    assert lanes.shape == (5 * dm.state_width,)


@pytest.mark.parametrize("n, net_slots", [(1, 65), (2, 65), (3, 65),
                                          (4, 65)])
def test_cuda_model_refuses_what_no_instance_holds(n, net_slots):
    """Past the largest instance's 64 slots the wave kernel's setup
    refuses, naming the range held."""
    dm = VsrDevice(n, 1, net_slots=net_slots)
    with pytest.raises(NotImplementedError, match="wave_kernel=False"):
        wave.cuda_model(dm, compile_layout(None, dm.state_width))
    with pytest.raises(NotImplementedError, match="at 1 to 64 slots"):
        wave.cuda_model(dm, compile_layout(None, dm.state_width))


@pytest.mark.parametrize("n, net_slots", [(1, None), (2, 17), (3, 41),
                                          (4, 49)])
def test_cuda_model_holds_what_the_fixed_instances_refused(n, net_slots):
    """One replica, and the first slot count past each earlier instance,
    now run on the instance of 64 slots."""
    dm = VsrDevice(n, 1, net_slots=net_slots)
    name, params, _ = wave.cuda_model(dm, compile_layout(None,
                                                         dm.state_width))
    assert (name, params[0], params[-1]) == ("vsr", n, dm.net_slots)


def test_cuda_instances_match_the_entry_point():
    """``CUDA_INSTANCES`` lists exactly the (replicas, slots) instances
    that the dispatch of ``csrc/models/vsr.cuh`` (which ``wave_vsr.cu``
    and ``sender_vsr.cu`` call) picks from, smallest first."""
    src = os.path.join(os.path.dirname(wave.__file__), "csrc", "models",
                       "vsr.cuh")
    with open(src) as f:
        text = f.read()
    found = {}
    for n, block in re.findall(r"case (\d):\n(.*?)break;", text, re.S):
        caps = re.findall(r"if \(e <= (\d+)\) return fn\(Vsr<(\d), (\d+)>",
                          block)
        assert caps and all(a == c and b == n for a, b, c in caps)
        found[int(n)] = tuple(int(a) for a, _, _ in caps)
    assert found == VsrDevice.CUDA_INSTANCES
    assert all(list(v) == sorted(v) for v in found.values())


# -- The whole slice ----------------------------------------------------------


@pytest.mark.parametrize("engine", ["fused", "classic", "sharded"])
def test_each_engine_matches_jax(engine):
    """2 replicas: 63 / 169 and the three sometimes witnesses on every
    engine and path, the chains' labels with Timeouts, no "agreement"
    counterexample."""
    ref_spawn, spawn = spawn_pair(*_pair(2), engine, batch_size=32)
    ours = assert_engine_matches_jax(ref_spawn, spawn, engine, (63, 169),
                                     SOMETIMES)
    labels = [a for _, acts in _chains(ours).values() for a in acts]
    assert "Timeout(Id(0))" in labels
    assert ours.discovery("agreement") is None


@pytest.mark.parametrize("engine", ["fused", "classic", "sharded"])
def test_network_overflow_raises(engine):
    """The overflow lane raises on every engine and path."""
    sys_ = VsrSys(2, 1, net_slots=2)
    _, kw = ENGINES[engine]
    if engine == "sharded":
        kw = dict(kw, mesh=["cpu"] * 3)
    for wave_kernel in (False, True):
        with pytest.raises(RuntimeError, match="error lane"):
            sys_.checker().spawn_cuda_bfs(batch_size=32,
                                          wave_kernel=wave_kernel,
                                          **kw).join()


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["fused", "classic", "sharded"])
def test_three_replicas_match_jax(engine):
    ref_spawn, spawn = spawn_pair(*_pair(3), engine, batch_size=512)
    assert_engine_matches_jax(ref_spawn, spawn, engine, (5_531, 32_006),
                              SOMETIMES)


@pytest.mark.slow
def test_three_replicas_two_views_match_jax():
    """3 replicas at ``max_view`` 2 overflow the default 24 slots; on 40:
    291,761 / 1,859,959."""
    ref_spawn, spawn = spawn_pair(*_pair(3, 2, net_slots=40), "fused",
                                  batch_size=4096)
    assert_engine_matches_jax(ref_spawn, spawn, "fused",
                              (291_761, 1_859_959), SOMETIMES)


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["fused", "sharded"])
def test_lossy_form_matches_jax(engine):
    ref_spawn, spawn = spawn_pair(*_pair(2, lossy=True), engine,
                                  batch_size=64)
    assert_engine_matches_jax(ref_spawn, spawn, engine, None, SOMETIMES)


# -- Checkpoints --------------------------------------------------------------


def test_checkpoint_is_jax_byte_for_byte_and_resumes(tmp_path):
    """VSR 2 stopped at 100 states: every section of the last generation
    and of its ``.prev`` equal to JAX's, and each package resumes the
    other's file to 63 / 169 and the same chains."""
    ref_model, ref_dm, sys_ = _pair(2)
    knobs = dict(batch_size=4, waves_per_dispatch=2, inflight_dispatches=1,
                 checkpoint_every_waves=1)
    mine, theirs = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    ref = ref_model.checker().target_state_count(100).spawn_tpu_bfs(
        device_model=ref_dm, pack_arena=True, checkpoint_path=theirs,
        **knobs).join()
    ours = sys_.checker().target_state_count(100).spawn_cuda_bfs(
        device="cpu", checkpoint_path=mine, **knobs).join()
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    assert ours.state_count() < 169 and ours.checkpoints >= 3
    for suffix in ("", ckpt.PREV_SUFFIX):
        want, got = _sections(theirs + suffix), _sections(mine + suffix)
        assert list(got) == list(want)
        for name in want:
            assert got[name] == want[name], (suffix, name)
    assert ckpt.verify_file(mine)["model"] == "ActorModel"
    knobs = dict(batch_size=32, inflight_dispatches=1)
    from_ours = ref_model.checker().spawn_tpu_bfs(
        device_model=ref_dm, pack_arena=True, resume_from=mine,
        **knobs).join()
    from_theirs = sys_.checker().spawn_cuda_bfs(
        device="cpu", resume_from=theirs, **knobs).join()
    for c in (from_ours, from_theirs):
        assert (c.unique_state_count(), c.state_count()) == (63, 169)
    assert _chains(from_theirs) == _ref_chains(from_ours)
    assert sorted(_chains(from_theirs)) == SOMETIMES
