"""The port's fused device BFS against the JAX fused engine.

Both sides run 2pc; the JAX side as ``spawn_tpu_bfs(table_impl="pallas")``
(the Pallas probe kernel, interpret mode on the CPU), the port as
``spawn_cuda_bfs(device="cpu")`` (the kernel's plain version). Counts,
discovery names, and discovery paths (as fingerprint chains and as
encoded states) must be equal: 288 / 1,146 and 8,832 / 58,146, 314
with symmetry, under forced growth of table and arena, at a target
state count, and with an EVENTUALLY property that has a counterexample.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import stateright_tpu.tpu  # noqa: F401,E402  (enables x64)
import two_phase_commit as ref_model  # noqa: E402
from stateright_tpu import Property as RefProperty  # noqa: E402
from stateright_tpu.tpu import engine as ref_engine  # noqa: E402
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
from stateright_tpu.tpu.models.twopc import TwoPhaseDevice as RefDevice  # noqa: E402,E501
from stateright_tpu.tpu.pallas_table import dedup_and_insert_pallas  # noqa: E402,E501
from stateright_tpu_torch import Property, carry, engine, fused, table  # noqa: E402,E501
from stateright_tpu_torch.models import twopc  # noqa: E402

torch.set_num_threads(2)


def _ref_run(model, sym=False, **kw):
    b = model.checker()
    if sym:
        b = b.symmetry()
    c = b.spawn_tpu_bfs(table_impl="pallas", **kw).join()
    assert c.kernel_path() == "pallas_probe"
    return c


def _run(model, sym=False, **kw):
    b = model.checker()
    if sym:
        b = b.symmetry()
    return b.spawn_cuda_bfs(device="cpu", **kw).join()


def _ref_paths(c):
    dm = c._dm
    out = {}
    for name, path in c.discoveries().items():
        vecs = [np.asarray(dm.encode(s), np.uint32)
                for s in path.into_states()]
        out[name] = ([host_fp64(v) for v in vecs], vecs,
                     path.into_actions())
    return out


def _paths(c):
    return {name: (p.fingerprints, p.vecs, p.into_actions())
            for name, p in c.discoveries().items()}


def _assert_same(ref, ours):
    assert ours.unique_state_count() == ref.unique_state_count()
    assert ours.state_count() == ref.state_count()
    want, got = _ref_paths(ref), _paths(ours)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name][0] == want[name][0], name
        assert all(np.array_equal(a, b)
                   for a, b in zip(got[name][1], want[name][1])), name
        assert len(got[name][1]) == len(want[name][1])
        assert got[name][2] == want[name][2], name


@pytest.mark.parametrize("rm, unique, states, sym", [
    (3, 288, 1146, False), (5, 8832, 58146, False), (5, 314, 2048, True)])
def test_matches_jax_fused_engine(rm, unique, states, sym):
    ref = _ref_run(ref_model.TwoPhaseSys(rm), sym, batch_size=256)
    ours = _run(twopc.TwoPhaseSys(rm), sym, batch_size=256)
    assert (ours.unique_state_count(), ours.state_count()) == (unique,
                                                                states)
    _assert_same(ref, ours)
    ours.assert_any_discovery("abort agreement")
    ours.assert_properties()


def test_growth_of_table_and_arena():
    kw = dict(batch_size=32, table_capacity=1 << 12, arena_capacity=1 << 9,
              waves_per_dispatch=2)
    ref = _ref_run(ref_model.TwoPhaseSys(4), **kw)
    ours = _run(twopc.TwoPhaseSys(4), **kw)
    assert ours.rehashes > 0 and ours.arena_grows > 0
    assert ours._capacity == ref._capacity
    _assert_same(ref, ours)


def test_target_state_count_and_dispatch_depth():
    rb = ref_model.TwoPhaseSys(4).checker().target_state_count(500)
    ref = rb.spawn_tpu_bfs(table_impl="pallas", batch_size=32).join()
    ours = (twopc.TwoPhaseSys(4).checker().target_state_count(500)
            .spawn_cuda_bfs(device="cpu", batch_size=32).join())
    assert 500 <= ours.state_count() < 1000
    _assert_same(ref, ours)
    k1 = _run(twopc.TwoPhaseSys(5), batch_size=128, waves_per_dispatch=1)
    k16 = _run(twopc.TwoPhaseSys(5), batch_size=128, waves_per_dispatch=16)
    assert k1.dispatches > k16.dispatches
    assert (k1.unique_state_count(), k1.state_count()) == (
        k16.unique_state_count(), k16.state_count()) == (8832, 58146)
    assert ({n: p[0] for n, p in _paths(k1).items()}
            == {n: p[0] for n, p in _paths(k16).items()})


# -- An EVENTUALLY property with a counterexample, on both sides ---------
#
# 2pc has no terminal state (a decided TM's message re-delivers forever),
# so this variant drops the re-deliveries that change nothing: a state
# where the TM decided and every RM holds the decision is then terminal,
# and "eventually all committed" fails on the all-aborted ones.

def _ref_no_redelivery(dm):
    n = dm.rm_count
    step = dm.step

    def new_step(vec):
        succ, valid = step(vec)
        keep = jnp.ones_like(valid)
        for i in range(n):
            keep = keep.at[2 + 5 * i + 3].set(vec[i] != 2)
            keep = keep.at[2 + 5 * i + 4].set(vec[i] != 3)
        return succ, valid & keep
    return new_step


class _RefDevice(RefDevice):
    def step(self, vec):
        return _ref_no_redelivery(RefDevice(self.rm_count, self._host))(vec)

    def device_properties(self):
        props = super().device_properties()
        props["all committed"] = lambda v: jnp.all(v[:self.rm_count] == 2)
        return props


class _RefSys(ref_model.TwoPhaseSys):
    def device_model(self):
        return _RefDevice(self.rm_count, ref_model)

    def next_states(self, state):  # replay follows the device step
        return [s for s in super().next_states(state) if s != state]

    def next_steps(self, state):
        return [(a, s) for a, s in super().next_steps(state) if s != state]

    def properties(self):
        return super().properties() + [RefProperty.eventually(
            "all committed", lambda _, s: all(
                r is ref_model.RmState.COMMITTED for r in s.rm_state))]


class _Device(twopc.TwoPhaseDevice):
    def step(self, rows):
        succ, valid = super().step(rows)
        n = self.rm_count
        i = torch.arange(n)
        valid[:, 2 + 5 * i + 3] &= rows[:, :n] != 2
        valid[:, 2 + 5 * i + 4] &= rows[:, :n] != 3
        return succ, valid

    def device_properties(self):
        props = super().device_properties()
        props["all committed"] = lambda r: (r[:, :self.rm_count] == 2).all(1)
        return props


class _Sys(twopc.TwoPhaseSys):
    def device_model(self):
        return _Device(self.rm_count)

    def properties(self):
        return super().properties() + [Property.eventually("all committed")]


def test_eventually_property_counterexample():
    ref = _ref_run(_RefSys(3), batch_size=64)
    ours = _run(_Sys(3), batch_size=64)
    assert "all committed" in ours.discoveries()
    assert ours.discovery_classification("all committed") == "counterexample"
    _assert_same(ref, ours)


def test_jax_mid_run_state_carries_into_the_port():
    """A JAX engine's mid-run table and frontier, moved in through
    ``carry``, give the port the same next wave and the same dedup."""
    ref = (ref_model.TwoPhaseSys(5).checker().target_state_count(3000)
           .spawn_tpu_bfs(table_impl="pallas", batch_size=64).join())
    vecs_a, fps_a, _, _ = ref._arena
    head, cap = ref._head, ref._capacity
    rows = np.asarray(vecs_a)[head:head + 64]
    visited = np.asarray(ref._visited)
    assert not ref._pack_on and rows.shape[1] == 8
    assert ref._arena_tail - head >= 64  # a real frontier, mid-run

    rdm = ref._dm
    valid = jnp.ones(len(rows), bool)
    succ, sflat, _, _ = ref_engine.expand_frontier(rdm, jnp.asarray(rows),
                                                   valid)
    r_fps, _ = ref_engine.fingerprint_successors(rdm, succ, sflat, False)
    r_new, r_n, r_cand, r_table = dedup_and_insert_pallas(
        r_fps, jnp.asarray(visited), cap)

    dm = twopc.TwoPhaseDevice(5)
    o_succ, o_sflat, _, _ = engine.expand_frontier(
        dm, carry.rows_in(rows), torch.ones(len(rows), dtype=torch.bool))
    o_fps, _ = engine.fingerprint_successors(dm, o_succ, o_sflat, False)
    assert np.array_equal(carry.u64_out(o_fps), np.asarray(r_fps))
    t = carry.u64_in(visited)
    new, cand, n_new, n_cand, _ = table.dedup_and_insert(o_fps, t)
    assert np.array_equal(new.numpy(), np.asarray(r_new))
    assert (int(n_new), int(n_cand)) == (int(r_n), int(r_cand))
    sent = np.uint64(0xFFFFFFFFFFFFFFFF)
    got, want = carry.u64_out(t), np.asarray(r_table)
    assert set(got[got != sent].tolist()) == set(want[want != sent].tolist())
    assert np.array_equal(carry.u64_out(carry.u64_in(np.asarray(fps_a))),
                          np.asarray(fps_a))


def test_error_lane_stops_the_run_on_both_sides():
    """A generated state with the error lane set ends the run with an
    error on both engines (here RM 0's lane, set by the first wave)."""

    class RefErr(RefDevice):
        error_lane = 0

    class Err(twopc.TwoPhaseDevice):
        error_lane = 0

    class RefSys(ref_model.TwoPhaseSys):
        def device_model(self):
            return RefErr(self.rm_count, ref_model)

    class Sys(twopc.TwoPhaseSys):
        def device_model(self):
            return Err(self.rm_count)

    with pytest.raises(RuntimeError, match="error lane"):
        RefSys(3).checker().spawn_tpu_bfs(table_impl="pallas",
                                          batch_size=64).join()
    with pytest.raises(RuntimeError, match="error lane 0"):
        Sys(3).checker().spawn_cuda_bfs(device="cpu", batch_size=64).join()
    # The single-kernel wave reads the lane from the packed successors.
    with pytest.raises(RuntimeError, match="error lane"):
        RefSys(3).checker().spawn_tpu_bfs(
            wave_kernel=True, pack_arena=True, batch_size=64).join()
    with pytest.raises(RuntimeError, match="error lane 0"):
        Sys(3).checker().spawn_cuda_bfs(device="cpu", batch_size=64,
                                        wave_kernel=True).join()


# -- The rehash goes through the engine's scratch, in chunks -----------------


def test_rehash_past_2_30_slots_takes_the_engines_scratch(monkeypatch):
    """The grow from 2^30 to 2^31 slots, on tables that allocate nothing
    (the meta device) and with the insert stubbed: every call gets the
    engine's own scratch and at most its rows, and the calls (a power of
    two of them) cover the old table once. A one-call rehash would need a
    fresh scratch for 2^30 rows, which ``DedupScratch`` refuses."""
    c = twopc.TwoPhaseSys(3).checker().spawn_cuda_bfs(
        device="cpu", batch_size=1 << 14).join()
    rows = c._scratch_shape()[0]
    calls, scratch, C = [], object(), 1 << 30

    def insert(fps, new, scratch=None):
        calls.append((fps.shape[0], new.shape[0], scratch))
        return (None,) * 4 + (torch.zeros((), dtype=torch.bool),)

    monkeypatch.setattr(fused, "dedup_and_insert", insert)
    c._table = torch.empty(C, dtype=torch.int64, device="meta")
    c._capacity, c._occ, c._scratch = C, C // 2 - rows + 1, scratch
    rehashes = c.rehashes
    c._grow(c._B)
    assert (c._capacity, c.rehashes) == (2 * C, rehashes + 1)
    assert c._table.shape == (2 * C,) and c._table.device.type == "meta"
    assert len(calls) == fused._pow2(-(-C // rows))
    assert sum(n for n, _, _ in calls) == C
    assert all(n <= rows and cap == 2 * C and s is scratch
               for n, cap, s in calls)
    with pytest.raises(ValueError, match="int32 row index"):
        table.DedupScratch(C, "meta")


def test_chunked_rehash_equals_one_call_as_a_set():
    """A real rehash on the CPU, in chunks of a wave's rows, holds the
    same keys as one call over the whole old table, and as many."""
    c = twopc.TwoPhaseSys(5).checker().spawn_cuda_bfs(
        device="cpu", batch_size=64).join()
    old = c._table.clone()
    assert old.shape[0] > 4 * c._scratch_shape()[0]  # several chunks
    one = torch.full((2 * old.shape[0],), -1, dtype=torch.int64)
    assert not bool(table.dedup_and_insert(old, one)[4])
    c._occ = c._capacity // 2
    c._grow(c._B)
    assert c._capacity == 2 * old.shape[0]
    got, want = c._table, one
    assert int((got != -1).sum()) == int((want != -1).sum()) == int(
        (old != -1).sum())
    assert torch.equal(got.sort().values, want.sort().values)
