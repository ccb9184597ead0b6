"""The port's classic sharded engine against JAX's ``ShardedTpuBfsChecker``.

The port's ``ShardedCudaBfsChecker`` on ``mesh=["cpu"] * n`` (the kernels'
plain versions: the torch stages, or with ``wave_kernel=True`` the sender
kernel's) is held to JAX ``spawn_tpu_bfs(sharded=True, fused=False,
pack_arena=True)`` on the first ``n`` devices of the 8-device test mesh,
with the same knobs (JAX's ladder path, which the JAX tests hold to its
sender kernel bit for bit): the unique and total counts, the discoveries'
fingerprint chains, ``_parent_map()``, every wave's log fields (``bucket``,
``rows``, ``out_rows``, ``novel``, ``overflow``, ``successors``,
``candidates``, ``capacity``, the fullest shard's ``load_factor`` and
``epoch``) and the table's capacity; at n = 2, 3 and 4 and batch 4 to 64,
with growth, symmetry, an eventually property, ``exchange_novel_only=False``,
a visitor and host properties, the output ladder forced to overflow, a
target, checkpoint sections byte for byte and resumes across packages and
engines; and the refusals and the exchange integrity check. Everything
here is integers: the tolerance is exact equality. The card's graphs and
pinned slot run in ``chip_smoke.py`` (phase 12).
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
from stateright_tpu.checker.visitor import StateRecorder as RefRecorder  # noqa: E402,E501
from stateright_tpu.model import Expectation as RefExpectation  # noqa: E402
from stateright_tpu.tpu.engine import TpuBfsChecker  # noqa: E402
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
from stateright_tpu.tpu.sharded import ShardedTpuBfsChecker  # noqa: E402
from stateright_tpu_torch import Property  # noqa: E402
from stateright_tpu_torch import checkpoint_format as ckpt  # noqa: E402
from stateright_tpu_torch.classic import CudaBfsChecker  # noqa: E402
from stateright_tpu_torch.fused import (FusedCudaBfsChecker,  # noqa: E402
                                        FusedUnsupported)
from stateright_tpu_torch.models import twopc  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosSys  # noqa: E402
from stateright_tpu_torch.sharded import (ExchangeIntegrityError,  # noqa: E402,E501
                                          ShardedCudaBfsChecker)
from stateright_tpu_torch.sharded_fused import ShardedFusedCudaBfsChecker  # noqa: E402,E501
from stateright_tpu_torch.visitor import StateRecorder  # noqa: E402
from test_torch_checkpoint import _RefTwoEventually, _TwoEventually  # noqa: E402,E501
from test_torch_classic import _Hybrid, _HybridRef  # noqa: E402

torch.set_num_threads(2)


class _PaxosHostRef:
    """JAX's paxos at 1 client with a property the host evaluates (it
    always holds, so every popped row is decoded and the run goes to its
    end)."""

    def __new__(cls):
        return ref_paxos.PaxosModelCfg(1, 3).into_model().property(
            RefExpectation.ALWAYS, "host-only true", lambda m, s: True)


class _PaxosHost(PaxosSys):
    def __init__(self):
        super().__init__(1)

    def properties(self):
        return super().properties() + [
            Property.always("host-only true", lambda m, s: True)]


#: a model's JAX and port twins
MODELS = {
    "2pc 3": (lambda: ref_model.TwoPhaseSys(3), lambda: twopc.TwoPhaseSys(3)),
    "2pc 4": (lambda: ref_model.TwoPhaseSys(4), lambda: twopc.TwoPhaseSys(4)),
    "2pc 5": (lambda: ref_model.TwoPhaseSys(5), lambda: twopc.TwoPhaseSys(5)),
    "2pc 3 host": (lambda: _HybridRef(3), lambda: _Hybrid(3)),
    "paxos 1 host": (_PaxosHostRef, _PaxosHost),
    "2pc 3 eventually": (lambda: _RefTwoEventually(3),
                         lambda: _TwoEventually(3))}
#: the per-wave fields of the dispatch logs that must be equal
WAVE_FIELDS = ("bucket", "rows", "out_rows", "novel", "overflow",
               "inflight", "successors", "candidates", "capacity",
               "load_factor", "epoch")


def _ref_mesh(n):
    return RefMesh(np.array(jax.devices()[:n]), ("shard",))


def _builder(model, sym=False, target=None, visitor=None):
    b = model.checker()
    if sym:
        b = b.symmetry()
    if target:
        b = b.target_state_count(target)
    if visitor is not None:
        b = b.visitor(visitor)
    return b


_REFS = {}


def _ref(name, n, **kw):
    """JAX's run with these knobs, made once (``wave_kernel`` left out:
    JAX's sender kernel and its ladder give the same run)."""
    kw.pop("wave_kernel", None)
    key = (name, n, tuple(sorted(kw.items())))
    if key not in _REFS:
        _REFS[key] = _ref_run(name, n, **kw)
    return _REFS[key]


def _ref_run(name, n, sym=False, target=None, visitor=None, **kw):
    c = _builder(MODELS[name][0](), sym, target, visitor).spawn_tpu_bfs(
        sharded=True, fused=False, mesh=_ref_mesh(n), pack_arena=True,
        **kw).join()
    assert isinstance(c, ShardedTpuBfsChecker) and c._n_shards == n
    return c


def _run(name, n, sym=False, target=None, visitor=None, **kw):
    kw.setdefault("fused", False)
    c = _builder(MODELS[name][1](), sym, target, visitor).spawn_cuda_bfs(
        mesh=["cpu"] * n, **kw).join()
    assert isinstance(c, ShardedCudaBfsChecker) and c._n == n
    return c


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
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    assert _chains(ours) == _ref_chains(ref)
    assert _waves(ours) == _waves(ref)
    assert ours._capacity == ref._capacity
    assert ours._shard_counts == ref._shard_counts
    if ours._visitor is None:
        # The chains above were walked through the log, not the dict.
        assert ours._parents == {}
    assert ours._parent_map() == ref._parent_map()
    stats, rstats = ours.scheduler_stats(), ref.scheduler_stats()
    assert stats["bucket_dispatches"] == rstats["bucket_dispatches"]
    for key in ("out_rows_dispatches", "overflow_redispatches",
                "occupancy"):
        assert stats["succ_ladder"][key] == rstats["succ_ladder"][key], key
    assert stats["local_dedup"] == rstats["local_dedup"]


# One case keeps the ladder on, as does ``test_forced_overflow_parity``;
# the others turn it off on both sides, which spares JAX a compile for
# each output rung and its regather.
CASES = {
    "2pc3-n2-b8": ("2pc 3", 2, dict(batch_size=8)),
    "2pc3-n3-b4-send-all": ("2pc 3", 3, dict(
        batch_size=4, exchange_novel_only=False, succ_ladder=False)),
    "2pc4-n4-b32": ("2pc 4", 4, dict(batch_size=32, succ_ladder=False)),
    "2pc4-n3-b16": ("2pc 4", 3, dict(batch_size=16, succ_ladder=False)),
    "2pc4-n2-b32-growth": ("2pc 4", 2, dict(
        batch_size=32, table_capacity=1 << 12, succ_ladder=False)),
    "2pc5-n4-b64-symmetry": ("2pc 5", 4, dict(batch_size=64, sym=True,
                                              succ_ladder=False)),
    "2pc3-n2-b8-eventually": ("2pc 3 eventually", 2, dict(
        batch_size=8, succ_ladder=False))}


@pytest.mark.parametrize("wave_kernel", [False, True],
                         ids=["stages", "sender"])
@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_sharded_classic(case, wave_kernel):
    name, n, kw = CASES[case]
    ref = _ref(name, n, **kw)
    ours = _run(name, n, wave_kernel=wave_kernel, **kw)
    _assert_same(ref, ours)
    assert ours.kernel_path() == ("sender_plain" if wave_kernel
                                  else "dedup_plain")
    assert all(e["kernel_path"] == ours.kernel_path()
               for e in ours.dispatch_log)
    if case.endswith("growth"):
        assert ours.rehashes > 0 and ours._capacity > 1 << 12
    if name == "2pc 5":
        assert (ours.unique_state_count(), ours.state_count()) == (314,
                                                                    2048)
    elif name == "2pc 3 eventually":
        assert "rm 0 prepared" in ours.discoveries()
    else:
        ours.assert_properties()


@pytest.mark.parametrize("name, n", [("2pc 3 host", 4), ("paxos 1 host", 3)],
                         ids=["2pc3-host-property", "paxos1-host-visitor"])
def test_host_properties_and_visitors_fall_back_to_it(name, n):
    """A visitor or a property the host evaluates: the sharded spawn
    falls back from the sharded fused engine to this one, as JAX's does
    (with the host property's warning), and equals JAX's run; the
    visitor sees every popped state in JAX's order. A path's replay is
    slow on paxos, so its sender-kernel run has no visitor."""
    rrec, rstates = RefRecorder.new_with_accessor()
    rec, states = StateRecorder.new_with_accessor()
    with pytest.warns(UserWarning, match="host-only"):
        ref = _builder(MODELS[name][0](), visitor=rrec).spawn_tpu_bfs(
            sharded=True, mesh=_ref_mesh(n), batch_size=16,
            succ_ladder=False, pack_arena=True).join()
    assert isinstance(ref, ShardedTpuBfsChecker)
    for wave_kernel in (False, True):
        visitor = None if wave_kernel and name.startswith("paxos") else rec
        with pytest.warns(UserWarning, match="host-only"):
            ours = _run(name, n, visitor=visitor, batch_size=16,
                        succ_ladder=False, wave_kernel=wave_kernel,
                        fused=None)
        _assert_same(ref, ours)
    got = states()
    visits = 1 if name.startswith("paxos") else 2
    assert len(got) == visits * len(rstates()) == (
        visits * ref.unique_state_count())
    dm, rdm = ours._dm, ref._dm
    want = [np.asarray(rdm.encode(s)).tolist() for s in rstates()]
    assert [dm.encode(s).tolist() for s in got] == want * visits
    if name == "2pc 3 host":
        assert ours.discovery("host-only abort") is not None
    else:
        assert (ours.unique_state_count(), ours.state_count()) == (265, 482)
        assert "host-only true" not in ours.discoveries()


def test_forced_overflow_parity(monkeypatch):
    """``tests/test_local_dedup.py``'s forced overflow (``slow`` on the JAX
    side), small: every wave after the ladder's history fills at a rung
    of 8 rows, so most waves regather; the counts, chains and parent map
    equal the ladder-off run's and JAX's, on both paths."""
    kw = dict(batch_size=8)
    off = _run("2pc 3", 3, succ_ladder=False, **kw)

    def forced(self, B):
        return 8 if self._succ_ladder_on else self._succ_full_rows(B)

    monkeypatch.setattr(TpuBfsChecker, "_pick_out_rows", forced)
    monkeypatch.setattr(CudaBfsChecker, "_pick_out_rows", forced)
    ref = _ref_run("2pc 3", 3, **kw)
    for wave_kernel in (False, True):
        ours = _run("2pc 3", 3, wave_kernel=wave_kernel, **kw)
        assert ours.scheduler_stats()["succ_ladder"][
            "overflow_redispatches"] > 0
        _assert_same(ref, ours)
        assert ours._parent_map() == off._parent_map()
        assert (ours.unique_state_count(), ours.state_count()) == (
            off.unique_state_count(), off.state_count()) == (288, 1146)


def _sections(path):
    with np.load(path) as data:
        return {k: (data[k].dtype, data[k].shape, data[k].tobytes())
                for k in data.files}


@pytest.mark.parametrize("name, full", [
    ("2pc 4", (1568, 8258)), ("2pc 3 eventually", None)],
    ids=["2pc4", "2pc3-eventually"])
def test_checkpoints_equal_jax_and_resume_anywhere(tmp_path, name, full):
    """A target with a checkpoint at every wave: the last generation and
    its ``.prev`` equal JAX's section by section, byte for byte. JAX's
    engine resumes the port's file and the port's resumes JAX's, equal;
    the port's fused, classic and sharded fused engines resume the
    port's file to the same counts and discoveries."""
    n = 3
    kw = dict(batch_size=8, target=300, checkpoint_every_waves=1,
              succ_ladder=False)
    rp, p = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    ref = _ref_run(name, n, checkpoint_path=rp, **kw)
    ours = _run(name, n, checkpoint_path=p, **kw)
    _assert_same(ref, ours)
    assert ref.state_count() >= 300 and ours.checkpoints >= 3
    for suffix in ("", ckpt.PREV_SUFFIX):
        want, got = _sections(rp + suffix), _sections(p + suffix)
        assert list(got) == list(want)
        for section in want:
            assert got[section] == want[section], (suffix, section)
    assert ckpt.verify_file(p)["unique_count"] == ours.unique_state_count()
    ref_resumed = _ref_run(name, n, batch_size=8, succ_ladder=False,
                           resume_from=p)
    resumed = _run(name, n, batch_size=8, succ_ladder=False,
                   resume_from=rp)
    _assert_same(ref_resumed, resumed)
    if full:
        assert (resumed.unique_state_count(), resumed.state_count()) == full
    # An eventually run stops at its discoveries, at a count that
    # depends on the engine: there the other engines resume and go on.
    port = MODELS[name][1]
    for spawn, engine in ((dict(device="cpu"), FusedCudaBfsChecker),
                          (dict(device="cpu", fused=False), CudaBfsChecker),
                          (dict(mesh=["cpu"] * 2), ShardedFusedCudaBfsChecker)):
        c = port().checker().spawn_cuda_bfs(batch_size=8, resume_from=p,
                                            **spawn).join()
        assert type(c) is engine
        if full:
            assert (c.unique_state_count(), c.state_count(),
                    sorted(c.discoveries())) == (
                        *full, sorted(resumed.discoveries())), engine
        else:
            assert c.state_count() > ours.state_count(), engine.__name__


def test_restart_from_after_a_failed_wave(tmp_path, monkeypatch):
    """``restart_from`` drops the failed run's shard queues and resumes
    its last periodic generation to the uninterrupted run's counts and
    chains."""
    path = str(tmp_path / "c.npz")
    process = ShardedCudaBfsChecker._process_wave
    calls = []

    def failing(self, wave):
        calls.append(1)
        if len(calls) == 6:
            raise RuntimeError("injected wave failure")
        process(self, wave)

    monkeypatch.setattr(ShardedCudaBfsChecker, "_process_wave", failing)
    c = twopc.TwoPhaseSys(4).checker().spawn_cuda_bfs(
        mesh=["cpu"] * 3, fused=False, batch_size=16, checkpoint_path=path,
        checkpoint_every_waves=1)
    with pytest.raises(RuntimeError, match="injected"):
        c.join()
    c.restart_from(path).join()
    whole = _run("2pc 4", 3, batch_size=16)
    assert (c.unique_state_count(), c.state_count()) == (1568, 8258)
    assert _chains(c) == _chains(whole)


@pytest.mark.parametrize("damage", ["short", "sentinel"])
def test_the_exchange_integrity_check_raises(monkeypatch, damage):
    """JAX's ``a2a_short`` and ``a2a_corrupt`` faults, made by hand on the
    blocks the wave delivered: a shard's block one row short of its new
    count, or a sentinel fingerprint in it, raises
    ``ExchangeIntegrityError`` naming the shard."""
    blocks_of = ShardedCudaBfsChecker._shard_blocks

    def damaged(self, *args):
        blocks = blocks_of(self, *args)
        i = next(i for i, b in enumerate(blocks) if len(b[1]))
        vecs, fps, parents = blocks[i]
        if damage == "short":
            blocks[i] = (vecs[:-1], fps[:-1], parents[:-1])
        else:
            fps[-1] = np.uint64(0xFFFFFFFFFFFFFFFF)
        return blocks

    monkeypatch.setattr(ShardedCudaBfsChecker, "_shard_blocks", damaged)
    match = "short exchange" if damage == "short" else "sentinel"
    with pytest.raises(ExchangeIntegrityError, match=match):
        _run("2pc 3", 2, batch_size=8)


def test_the_builder_picks_it_and_its_refusals():
    """JAX's rules: ``fused=False`` and the fused engine's
    ``FusedUnsupported`` give this engine; ``fused=True`` with a visitor
    raises ``FusedUnsupported``; ``pipeline=True`` and an eventually
    property with no device predicate raise ``NotImplementedError``, on
    both sides."""
    b = twopc.TwoPhaseSys(3).checker()
    assert isinstance(b.spawn_cuda_bfs(mesh=["cpu"] * 2).join(),
                      ShardedFusedCudaBfsChecker)
    c = b.spawn_cuda_bfs(mesh=["cpu"] * 2, fused=False, batch_size=8,
                         waves_per_dispatch=2, arena_capacity=1 << 10,
                         inflight_dispatches=3).join()
    assert isinstance(c, ShardedCudaBfsChecker)
    assert (c.unique_state_count(), c.state_count()) == (288, 1146)
    assert c.scheduler_stats()["max_inflight"] == 0
    rec, _ = StateRecorder.new_with_accessor()
    with pytest.raises(FusedUnsupported):
        twopc.TwoPhaseSys(3).checker().visitor(rec).spawn_cuda_bfs(
            mesh=["cpu"] * 2, fused=True)
    for kw in (dict(pipeline=True), dict(fused=False, pipeline=True)):
        with pytest.raises(NotImplementedError, match="pipeline"):
            b.spawn_cuda_bfs(mesh=["cpu"] * 2, **kw)
        with pytest.raises(NotImplementedError, match="pipeline"):
            ref_model.TwoPhaseSys(3).checker().spawn_tpu_bfs(
                sharded=True, mesh=_ref_mesh(2), **kw)

    class _HostEventually(twopc.TwoPhaseSys):
        def properties(self):
            return super().properties() + [Property.eventually(
                "host-only eventually", lambda m, s: True)]

    for kw in (dict(), dict(fused=False)):
        with pytest.raises(NotImplementedError,
                           match="host-only eventually"):
            _HostEventually(3).checker().spawn_cuda_bfs(mesh=["cpu"] * 2,
                                                        **kw)
    # Unsharded, the same property runs on the classic engine.
    with pytest.warns(UserWarning, match="host-only eventually"):
        c = _HostEventually(3).checker().spawn_cuda_bfs(device="cpu")
    assert isinstance(c.join(), CudaBfsChecker)
