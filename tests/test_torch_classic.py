"""The port's classic per-wave engine against JAX's ``TpuBfsChecker``.

``classic.classic_wave`` and ``classic_regather`` on CPU tensors (the
kernels' plain versions) are held to ``build_wave`` and
``build_regather`` (the Pallas megakernel in interpret mode where
``wave_kernel=True``) on one seeded batch of 2pc at 4 RMs and of paxos at
1 client, with the output rung full and forced small: every output equal,
the tables equal as sets. The engine on the CPU
(``spawn_cuda_bfs(device="cpu", fused=False)``) is held to JAX
``spawn_tpu_bfs(fused=False)`` with the same knobs: counts, discovery
fingerprint chains, ``_parent_map()``, and every wave's ``bucket``,
``rows``, ``out_rows``, ``novel``, ``overflow`` and ``inflight``, with
``pipeline``, ``succ_ladder``, a bucket ladder, a target, symmetry,
growth, a forced overflow on every wave, visitors and host properties;
and checkpoint sections byte for byte at the same rest point, resumed
across packages and engines. Everything here is integers: the tolerance
is exact equality. The graphs and pinned slots of the card's path run in
``chip_smoke.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import stateright_tpu.tpu  # noqa: F401,E402  (enables x64)
import paxos as ref_paxos  # noqa: E402
import two_phase_commit as ref_model  # noqa: E402
from stateright_tpu import Property as RefProperty  # noqa: E402
from stateright_tpu.checker.visitor import StateRecorder as RefRecorder  # noqa: E402,E501
from stateright_tpu.tpu import engine as ref_engine  # noqa: E402
from stateright_tpu.tpu.engine import TpuBfsChecker  # noqa: E402
from stateright_tpu.tpu.hashing import SENTINEL, host_fp64  # noqa: E402
from stateright_tpu.tpu.packing import compile_layout as ref_layout  # noqa: E402,E501
from stateright_tpu_torch import Property, carry, classic, engine  # noqa: E402
from stateright_tpu_torch import checkpoint_format as ckpt  # noqa: E402
from stateright_tpu_torch import wave  # noqa: E402
from jax.sharding import Mesh as RefMesh  # noqa: E402
from stateright_tpu_torch.classic import CudaBfsChecker  # noqa: E402
from stateright_tpu_torch.fused import (FusedCudaBfsChecker,  # noqa: E402
                                        FusedUnsupported)
from stateright_tpu_torch.models import twopc  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosDevice, PaxosSys  # noqa: E402,E501
from stateright_tpu_torch.packing import compile_layout  # noqa: E402
from stateright_tpu_torch.sharded import ShardedCudaBfsChecker  # noqa: E402
from stateright_tpu_torch.visitor import StateRecorder, as_visitor  # noqa: E402,E501
from test_torch_checkpoint import _RefTwoEventually, _TwoEventually  # noqa: E402,E501

torch.set_num_threads(2)

CAP = 1 << 13
#: a model's JAX and port twins
MODELS = {
    "2pc 3": (lambda: ref_model.TwoPhaseSys(3), lambda: twopc.TwoPhaseSys(3)),
    "2pc 4": (lambda: ref_model.TwoPhaseSys(4), lambda: twopc.TwoPhaseSys(4)),
    "2pc 5": (lambda: ref_model.TwoPhaseSys(5), lambda: twopc.TwoPhaseSys(5)),
    "paxos 1": (lambda: ref_paxos.PaxosModelCfg(1, 3).into_model(),
                lambda: PaxosSys(1)),
    "paxos 1 liveness": (
        lambda: ref_paxos.PaxosModelCfg(1, 3, liveness=True).into_model(),
        lambda: PaxosSys(1, liveness=True)),
    # two eventually properties with counterexamples (test_torch_fused's)
    "2pc 3 eventually": (lambda: _RefTwoEventually(3),
                         lambda: _TwoEventually(3))}
#: the per-wave fields of the dispatch logs that must be equal
WAVE_FIELDS = ("bucket", "rows", "out_rows", "novel", "overflow",
               "inflight", "successors", "candidates")


def _as_set(a):
    return set(a[a != SENTINEL].tolist())


def _reachable(rdm, model):
    """Every reachable row of ``model``, level by level through JAX's
    step: ``uint32[N, W]``."""
    step = jax.jit(jax.vmap(rdm.step))
    rows = np.stack([np.asarray(rdm.encode(s), np.uint32)
                     for s in model.init_states()])
    seen = {r.tobytes() for r in rows}
    out = [rows]
    while len(rows):
        nxt = []
        for i in range(0, len(rows), 256):
            part = rows[i:i + 256]
            pad = np.concatenate([part, np.repeat(part[:1], 256 - len(part),
                                                  0)])
            succ, valid = (np.asarray(a) for a in step(jnp.asarray(pad)))
            for r in succ[:len(part)][valid[:len(part)]]:
                if r.tobytes() not in seen:
                    seen.add(r.tobytes())
                    nxt.append(r)
        rows = np.stack(nxt) if nxt else rows[:0]
        out.append(rows)
    return np.concatenate(out)


_ROWS = {}


def _batch(name, B, seed):
    """A seeded batch of ``B`` reachable rows (repeats and invalid holes
    included) and a table of ``CAP`` slots holding a seeded half of the
    reachable rows' fingerprints, so that the wave meets revisits."""
    if name not in _ROWS:
        model = MODELS[name][0]()
        _ROWS[name] = _reachable(model.device_model(), model)
    rows = _ROWS[name]
    rng = np.random.default_rng(seed)
    batch = rows[rng.integers(0, len(rows), B)]
    valid = rng.random(B) < 0.9
    table = np.full(CAP, SENTINEL, np.uint64)
    known = rows[rng.random(len(rows)) < 0.5]
    ref_engine.host_table_insert(table, np.array(
        [host_fp64(r) for r in known], np.uint64))
    return batch, valid, table


def _twins(name):
    rmodel, model = (f() for f in MODELS[name])
    rdm, dm = rmodel.device_model(), model.device_model()
    W = dm.state_width
    return (rmodel, rdm, ref_layout(rdm.lane_bits(), W), model, dm,
            compile_layout(dm.lane_bits(), W))


@pytest.mark.parametrize("name, out_rows", [
    ("2pc 4", None), ("2pc 4", 8), ("paxos 1", 8)],
    ids=["2pc4-full", "2pc4-rung-8", "paxos1-rung-8"])
def test_classic_wave_and_regather_match_jax(name, out_rows):
    """Both successor paths of ``classic_wave`` against JAX's ladder
    (``build_wave`` with ``wave_kernel=False``, which the JAX tests hold
    to its megakernel bit for bit)."""
    B = 64
    rmodel, rdm, rlay, model, dm, lay = _twins(name)
    batch, valid, table = _batch(name, B, seed=10)
    packed = lay.pack_np(batch)
    assert np.array_equal(packed, rlay.pack_np(batch))
    rprops = rdm.device_properties()
    ref = ref_engine.build_wave(
        rdm, B, CAP, [rprops.get(p.name) for p in rmodel.properties()],
        out_rows=out_rows, layout=rlay)(
        jnp.asarray(packed), jnp.asarray(valid), jnp.asarray(table))
    (r_conds, r_succ, r_cand, r_term, r_new, r_vecs, r_fps, r_parent,
     r_mask, r_over, r_table) = ref
    vecs, valid_t = carry.words_in(packed), torch.from_numpy(valid)
    props = dm.device_properties()
    for wave_kernel in (False, True):
        t = carry.u64_in(table)
        (conds, succ_count, cand_count, terminal, new_count, new_vecs,
         new_fps, new_parent, new_mask, overflow, full) = \
            classic.classic_wave(
                dm, vecs, valid_t, t, lay,
                [props.get(p.name) for p in model.properties()],
                out_rows=out_rows, wave_kernel=wave_kernel)
        assert len(conds) == len(r_conds) == len(model.properties())
        for a, b in zip(conds, r_conds):
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert int(succ_count) == int(r_succ)
        assert int(cand_count) == int(r_cand)
        assert np.array_equal(terminal.numpy(), np.asarray(r_term))
        assert int(new_count) == int(r_new) > 8
        assert np.array_equal(carry.words_out(new_vecs), np.asarray(r_vecs))
        assert np.array_equal(carry.u64_out(new_fps), np.asarray(r_fps))
        assert np.array_equal(new_parent.numpy(), np.asarray(r_parent))
        assert new_parent.dtype == torch.int32
        assert np.array_equal(new_mask.numpy(), np.asarray(r_mask))
        assert bool(overflow) == bool(r_over) == (out_rows is not None)
        assert not bool(full)
        assert _as_set(carry.u64_out(t)) == _as_set(np.asarray(r_table))
    if out_rows is None:
        return
    # The regather at the least rung that holds the wave's new rows.
    k = int(new_count)
    k2 = ref_engine.pick_bucket(ref_engine.succ_bucket_ladder(
        B * dm.max_fanout), k)
    assert k2 < B * dm.max_fanout
    r_re = ref_engine.build_regather(rdm, B, k2, layout=rlay)(
        jnp.asarray(packed), jnp.asarray(valid), r_mask)
    re = classic.classic_regather(dm, vecs, valid_t, new_mask, k2, lay)
    for a, b in zip(re, r_re):
        assert np.array_equal(a.numpy().view(np.asarray(b).dtype),
                              np.asarray(b))


def test_wave_kernel_forced_overflow_parity():
    """``test_megakernel_forced_overflow_parity`` of the JAX tests, on the
    port: an output rung smaller than the wave's new rows; the truncated
    outputs, the novelty mask, the overflow flag and the table equal the
    torch stages' and JAX's, the kernel through its plain version on the
    CPU (no launch)."""
    rmodel, rdm, rlay, model, dm, lay = _twins("2pc 4")
    B, W = 64, dm.state_width
    init = np.stack([np.asarray(rdm.encode(s), np.uint32)
                     for s in rmodel.init_states()])
    batch = np.zeros((B, W), np.uint32)
    batch[:len(init)] = init
    valid = np.arange(B) < len(init)
    packed = lay.pack_np(batch)
    ref = ref_engine.build_wave(rdm, B, CAP, out_rows=8, layout=rlay,
                                wave_kernel=True)(
        jnp.asarray(packed), jnp.asarray(valid),
        jnp.full((CAP,), jnp.uint64(SENTINEL)))
    launches = wave.wave_megakernel.launches
    outs = [classic.classic_wave(
        dm, carry.words_in(packed), torch.from_numpy(valid),
        carry.u64_in(np.full(CAP, SENTINEL, np.uint64)), lay, out_rows=8,
        wave_kernel=wk) for wk in (True, False)]
    assert wave.wave_megakernel.launches == launches
    assert bool(outs[0][9]) and bool(ref[9]), "the rung must overflow"
    for i in range(1, 10):
        want = np.asarray(ref[i])
        for out in outs:
            got = out[i].numpy()
            assert np.array_equal(got.view(want.dtype) if got.dtype.itemsize
                                  == want.dtype.itemsize else got, want), i


@pytest.mark.parametrize("full, base", [
    (1, 256), (255, 256), (256, 256), (257, 256), (851_968, 256),
    (16_384 * 18, 256), (64 * 22, 256), (100, 8)])
def test_succ_bucket_ladder_matches_jax(full, base):
    ladder = engine.succ_bucket_ladder(full, base)
    assert ladder == ref_engine.succ_bucket_ladder(full, base)
    assert ladder[-1] == full


# -- Engine runs -------------------------------------------------------------


_REFS = {}


def _ref(name, **kw):
    """JAX's classic run with these knobs, made once: ``wave_kernel``
    left out, since JAX's kernel and ladder give the same run."""
    kw.pop("wave_kernel", None)
    key = (name, tuple(sorted(kw.items())))
    if key not in _REFS:
        _REFS[key] = _ref_run(name, **kw)
    return _REFS[key]


def _ref_run(name, sym=False, target=None, visitor=None, **kw):
    b = MODELS[name][0]().checker()
    if sym:
        b = b.symmetry()
    if target:
        b = b.target_state_count(target)
    if visitor is not None:
        b = b.visitor(visitor)
    return b.spawn_tpu_bfs(fused=False, pack_arena=True, **kw).join()


def _run(name, sym=False, target=None, visitor=None, **kw):
    b = MODELS[name][1]().checker()
    if sym:
        b = b.symmetry()
    if target:
        b = b.target_state_count(target)
    if visitor is not None:
        b = b.visitor(visitor)
    return b.spawn_cuda_bfs(device="cpu", fused=False, **kw).join()


def _ref_chains(c):
    dm = c._dm
    return {name: [host_fp64(np.asarray(dm.encode(s), np.uint32))
                   for s in p.into_states()]
            for name, p in c.discoveries().items()}


def _chains(c):
    return {name: p.fingerprints for name, p in c.discoveries().items()}


def _waves(c):
    return [tuple(e[f] for f in WAVE_FIELDS) for e in c.dispatch_log]


def _assert_same(ref, ours):
    assert isinstance(ours, CudaBfsChecker)
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    assert _chains(ours) == _ref_chains(ref)
    assert _waves(ours) == _waves(ref)
    assert ours._capacity == ref._capacity
    if ours._visitor is None:
        # The chains above were walked through the log, not the dict.
        assert ours._parents == {}
    assert ours._parent_map() == ref._parent_map()
    assert _chains(ours) == _ref_chains(ref)
    stats, rstats = ours.scheduler_stats(), ref.scheduler_stats()
    for key in ("bucket_dispatches", "max_inflight"):
        assert stats[key] == rstats[key], key
    for key in ("out_rows_dispatches", "overflow_redispatches",
                "occupancy"):
        assert stats["succ_ladder"][key] == rstats["succ_ladder"][key], key
    assert stats["local_dedup"] == rstats["local_dedup"]


@pytest.mark.parametrize("name, kw", [
    ("2pc 4", dict(batch_size=32)),
    ("2pc 4", dict(batch_size=32, pipeline=True)),
    ("2pc 4", dict(batch_size=32, succ_ladder=False)),
    ("2pc 4", dict(batch_size=32, wave_kernel=True)),
    ("2pc 4", dict(batch_size=32, max_batch_size=64, pipeline=True)),
    ("2pc 4", dict(batch_size=32, target=1000)),
    ("2pc 5", dict(batch_size=64, sym=True)),
    ("2pc 4", dict(batch_size=32, table_capacity=1 << 12)),
    ("2pc 3 eventually", dict(batch_size=16)),
    ("paxos 1", dict(batch_size=32)),
    ("paxos 1", dict(batch_size=32, wave_kernel=True)),
    ("paxos 1 liveness", dict(batch_size=64, succ_ladder=False))],
    ids=["2pc4", "2pc4-pipeline", "2pc4-ladder-off", "2pc4-wave-kernel",
         "2pc4-buckets", "2pc4-target", "2pc5-symmetry", "2pc4-growth",
         "2pc3-eventually", "paxos1", "paxos1-wave-kernel",
         "paxos1-liveness"])
def test_engine_matches_jax_classic(name, kw):
    ref, ours = _ref(name, **kw), _run(name, **kw)
    _assert_same(ref, ours)
    assert ours.kernel_path() == ("megakernel_plain" if kw.get("wave_kernel")
                                  else "dedup_plain")
    if "table_capacity" in kw:
        assert ours.rehashes > 0
    if name.startswith("2pc 3"):
        for prop in ("all committed", "rm 0 prepared"):
            assert ours.discovery_classification(prop) == "counterexample"
    elif "target" not in kw:
        ours.assert_properties()


def test_forced_overflow_parity(monkeypatch):
    """``tests/test_local_dedup.py``'s forced overflow, on both sides and
    both successor paths: every wave at a rung of 8 rows, so the regather
    runs on most waves; the counts, chains and parent map equal the
    ladder-off run's and JAX's."""
    off = _run("2pc 4", batch_size=64, succ_ladder=False)

    def forced(self, B):
        return 8 if self._succ_ladder_on else B * self._F

    monkeypatch.setattr(TpuBfsChecker, "_pick_out_rows", forced)
    monkeypatch.setattr(CudaBfsChecker, "_pick_out_rows", forced)
    ref = _ref_run("2pc 4", batch_size=64)
    for wk in (False, True):
        ours = _run("2pc 4", batch_size=64, wave_kernel=wk)
        stats = ours.scheduler_stats()["succ_ladder"]
        assert stats["overflow_redispatches"] > 0
        _assert_same(ref, ours)
        assert ours._parent_map() == off._parent_map()
        assert (ours.unique_state_count(), ours.state_count()) == (
            off.unique_state_count(), off.state_count()) == (1568, 8258)


def test_visitor_runs_on_the_classic_engine():
    """``tests/test_fused.py``'s visitor fallback: the spawn is the
    classic engine, every state is visited once, in JAX's order, and
    ``fused=True`` refuses; a sharded spawn that needs the classic engine
    gets the classic sharded engine, equal to JAX's (``pipeline=True``
    raises, as in JAX)."""
    rrec, rstates = RefRecorder.new_with_accessor()
    rec, states = StateRecorder.new_with_accessor()
    ref = (ref_model.TwoPhaseSys(3).checker().visitor(rrec)
           .spawn_tpu_bfs(batch_size=64).join())
    c = (twopc.TwoPhaseSys(3).checker().visitor(rec)
         .spawn_cuda_bfs(device="cpu", batch_size=64).join())
    assert not isinstance(c, FusedCudaBfsChecker)
    assert isinstance(c, CudaBfsChecker)
    _assert_same(ref, c)
    assert len(states()) == len(rstates()) == 288
    dm, rdm = c._dm, ref._dm
    assert [dm.encode(s).tolist() for s in states()] == [
        np.asarray(rdm.encode(s)).tolist() for s in rstates()]
    with pytest.raises(FusedUnsupported):
        (twopc.TwoPhaseSys(3).checker().visitor(rec)
         .spawn_cuda_bfs(device="cpu", batch_size=64, fused=True))
    rrec, rstates = RefRecorder.new_with_accessor()
    ref = (ref_model.TwoPhaseSys(3).checker().visitor(rrec)
           .spawn_tpu_bfs(sharded=True, batch_size=16,
                          mesh=RefMesh(np.array(jax.devices()[:2]),
                                       ("shard",))).join())
    want = [np.asarray(rdm.encode(s)).tolist() for s in rstates()]
    for kw in (dict(), dict(fused=False)):
        rec, states = StateRecorder.new_with_accessor()
        c = (twopc.TwoPhaseSys(3).checker().visitor(rec)
             .spawn_cuda_bfs(mesh=["cpu"] * 2, batch_size=16, **kw).join())
        assert isinstance(c, ShardedCudaBfsChecker)
        assert (c.unique_state_count(), c.state_count()) == (
            ref.unique_state_count(), ref.state_count()) == (288, 1146)
        assert _chains(c) == _ref_chains(ref)
        assert c._parent_map() == ref._parent_map()
        assert [dm.encode(s).tolist() for s in states()] == want
    with pytest.raises(NotImplementedError, match="pipeline"):
        (twopc.TwoPhaseSys(3).checker().visitor(rec)
         .spawn_cuda_bfs(mesh=["cpu"] * 2, pipeline=True))
    seen = []
    c = (twopc.TwoPhaseSys(3).checker()
         .visitor(lambda model, path: seen.append(len(path.fingerprints)))
         .spawn_cuda_bfs(device="cpu", batch_size=64).join())
    assert len(seen) == 288 and max(seen) > 1
    with pytest.raises(TypeError):
        as_visitor(3)


class _HybridRef(ref_model.TwoPhaseSys):
    def properties(self):
        def all_aborted(model, s):
            return all(r is ref_model.RmState.ABORTED for r in s.rm_state)

        return super().properties() + [
            RefProperty.sometimes("host-only abort", all_aborted)]


class _Hybrid(twopc.TwoPhaseSys):
    checkpoint_name = "_HybridRef"

    def properties(self):
        def all_aborted(model, s):
            return all(r is twopc.RmState.ABORTED for r in s.rm_state)

        return super().properties() + [
            Property.sometimes("host-only abort", all_aborted)]


def test_host_property_falls_back_with_a_warning():
    """``tests/test_tpu_engine.py``'s host-property fallback: the spawn
    warns and runs the classic engine, the host condition is found with
    JAX's chain; ``fused=True`` refuses; a property with neither a
    device predicate nor a condition raises, naming it."""
    with pytest.warns(UserWarning, match="host-only abort"):
        ref = _HybridRef(3).checker().spawn_tpu_bfs(batch_size=64).join()
    with pytest.warns(UserWarning, match="host-only abort"):
        c = _Hybrid(3).checker().spawn_cuda_bfs(device="cpu",
                                                batch_size=64).join()
    assert isinstance(c, CudaBfsChecker)
    assert c.unique_state_count() == 288
    assert c.discovery("host-only abort") is not None
    _assert_same(ref, c)
    with pytest.raises(FusedUnsupported):
        _Hybrid(3).checker().spawn_cuda_bfs(device="cpu", fused=True)

    class _Nameless(twopc.TwoPhaseSys):
        def properties(self):
            return super().properties() + [Property.always("no predicate")]

    for kw in (dict(), dict(fused=False)):
        with pytest.raises(ValueError, match="no predicate"):
            _Nameless(3).checker().spawn_cuda_bfs(device="cpu", **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        twopc.TwoPhaseSys(3).checker().spawn_cuda_bfs(
            device="cpu", fused=True, pipeline=True)


@pytest.mark.parametrize("wave_kernel", [False, True],
                         ids=["stages", "wave-kernel"])
def test_network_overflow_raises_on_the_classic_engine(wave_kernel):
    """Two network slots overflow paxos's list: the error lane of a new
    row, read on the host from the wave's packed outputs, stops the run
    (``tests/test_torch_paxos.py``'s case on the classic engine)."""

    class Sys(PaxosSys):
        def device_model(self):
            return PaxosDevice(1, net_slots=2)

    lane = PaxosDevice(1, net_slots=2).error_lane
    with pytest.raises(RuntimeError, match=f"error lane {lane} "):
        Sys(1).checker().spawn_cuda_bfs(
            device="cpu", fused=False, wave_kernel=wave_kernel,
            batch_size=128).join()


def test_the_fused_knobs_are_dropped_on_the_way():
    c = twopc.TwoPhaseSys(3).checker().spawn_cuda_bfs(
        device="cpu", fused=False, waves_per_dispatch=2,
        arena_capacity=1 << 10, inflight_dispatches=3, batch_size=64).join()
    assert isinstance(c, CudaBfsChecker)
    assert (c.unique_state_count(), c.state_count()) == (288, 1146)
    c = twopc.TwoPhaseSys(3).checker().spawn_cuda_bfs(
        device="cpu", pipeline=True, batch_size=16).join()
    assert isinstance(c, CudaBfsChecker) and c._pipeline
    assert c.scheduler_stats()["max_inflight"] == 1
    c = twopc.TwoPhaseSys(3).checker().spawn_cuda_bfs(device="cpu").join()
    assert isinstance(c, FusedCudaBfsChecker)
    c = (twopc.TwoPhaseSys(5).checker().symmetry_fn(lambda s: s)
         .spawn_cuda_bfs(device="cpu", fused=False, batch_size=64).join())
    assert c.unique_state_count() == 314


# -- Checkpoints -------------------------------------------------------------


def _sections(path):
    with np.load(path) as data:
        return {k: (data[k].dtype, data[k].shape, data[k].tobytes())
                for k in data.files}


@pytest.mark.parametrize("name, sym, target", [
    ("2pc 4", False, 1000), ("2pc 5", True, 1000), ("paxos 1", False, 300)],
    ids=["2pc4", "2pc5-symmetry", "paxos1"])
def test_checkpoint_sections_equal_jax_classic(tmp_path, name, sym, target):
    """JAX's classic engine with ``pack_arena=True`` and the port's, at a
    checkpoint every wave and stopped at a target: the last generation
    and its ``.prev`` equal section by section, byte for byte."""
    kw = dict(batch_size=16, checkpoint_every_waves=1)
    rp, p = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    ref = _ref_run(name, sym, target, checkpoint_path=rp, **kw)
    ours = _run(name, sym, target, checkpoint_path=p, **kw)
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    assert ours.checkpoints >= 3
    for suffix in ("", ckpt.PREV_SUFFIX):
        want, got = _sections(rp + suffix), _sections(p + suffix)
        assert list(got) == list(want)
        for section in want:
            assert got[section] == want[section], (suffix, section)


@pytest.mark.parametrize("writer, reader", [
    ("jax classic", "port classic"), ("port classic", "jax classic"),
    ("port classic", "port fused"), ("port fused", "port classic"),
    ("port sharded", "port classic")])
def test_resume_across_packages_and_engines(tmp_path, writer, reader):
    """A mid-run file of 2pc 4 resumes to the full counts, with the chains
    JAX's engine of the reader's kind gives after resuming it."""
    path = str(tmp_path / "c.npz")
    knobs = dict(batch_size=32, target=1000, checkpoint_path=path)
    if writer == "port classic":
        _run("2pc 4", **knobs)
    elif writer == "jax classic":
        _ref_run("2pc 4", **knobs)
    else:
        where = (dict(mesh=["cpu"] * 3) if writer == "port sharded"
                 else dict(device="cpu"))
        (twopc.TwoPhaseSys(4).checker().target_state_count(1000)
         .spawn_cuda_bfs(batch_size=32, checkpoint_path=path, **where)
         .join())
    assert ckpt.verify_file(path)["unique_count"] < 1568
    fused = reader.endswith("fused")
    ref = (ref_model.TwoPhaseSys(4).checker().spawn_tpu_bfs(
        batch_size=32, resume_from=path).join()
        if fused else _ref_run("2pc 4", batch_size=32, resume_from=path))
    if reader.startswith("jax"):
        ours = ref
    elif fused:
        ours = twopc.TwoPhaseSys(4).checker().spawn_cuda_bfs(
            device="cpu", batch_size=32, resume_from=path).join()
        assert isinstance(ours, FusedCudaBfsChecker)
    else:
        ours = _run("2pc 4", batch_size=32, resume_from=path)
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count()) == (1568, 8258)
    want = _ref_chains(ref)
    assert (_chains(ours) if not reader.startswith("jax")
            else _ref_chains(ours)) == want
    if reader == "port classic":
        _assert_same(ref, ours)


def test_restart_from_after_a_failed_wave(tmp_path, monkeypatch):
    path = str(tmp_path / "c.npz")
    process = CudaBfsChecker._process_wave
    calls = []

    def failing(self, w):
        calls.append(1)
        if len(calls) == 6:
            raise RuntimeError("injected wave failure")
        process(self, w)

    monkeypatch.setattr(CudaBfsChecker, "_process_wave", failing)
    c = twopc.TwoPhaseSys(4).checker().spawn_cuda_bfs(
        device="cpu", fused=False, batch_size=32, checkpoint_path=path,
        checkpoint_every_waves=1)
    with pytest.raises(RuntimeError, match="injected"):
        c.join()
    with pytest.raises(RuntimeError, match="after a failed run"):
        c.checkpoint(str(tmp_path / "torn.npz"))
    c.restart_from(path).join()
    ref = _ref("2pc 4", batch_size=32)
    assert (c.unique_state_count(), c.state_count()) == (1568, 8258)
    assert _chains(c) == _ref_chains(ref)
    c.checkpoint(str(tmp_path / "after.npz"))
    assert ckpt.verify_file(str(tmp_path / "after.npz"))[
        "unique_count"] == 1568
