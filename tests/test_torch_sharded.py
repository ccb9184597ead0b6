"""The port's sharded fused engine and its sender kernel against JAX's.

``stateright_tpu_torch.wave.sender_megakernel`` on CPU tensors runs its
plain version, ``sender_megakernel_plain``; it is held to the Pallas
``build_sender_megakernel`` (interpret mode, as the JAX tests run it)
shard by shard on packed rows of 2pc's reachable states, bit for bit
(tolerance: exact). The port's ``ShardedFusedCudaBfsChecker`` on
``mesh=["cpu"] * n`` is held to JAX ``ShardedFusedTpuBfsChecker`` on the
8-device test mesh and on an explicit 2-device mesh, with each knob:
counts, capacities, discovery fingerprint chains, vectors and actions
exact. JAX references are computed once per module. The CUDA kernel
itself is held to the same plain version on the card by
``chip_smoke.py``.
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
import two_phase_commit as ref_model  # noqa: E402
from stateright_tpu.resilience.membership import OwnerMap as RefOwnerMap  # noqa: E402,E501
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
from stateright_tpu.tpu.packing import compile_layout as ref_layout  # noqa: E402,E501
from stateright_tpu.tpu.pallas_table import build_sender_megakernel  # noqa: E402,E501
from stateright_tpu.tpu.sharded_fused import ShardedFusedTpuBfsChecker  # noqa: E402,E501
from stateright_tpu_torch import carry, fused, table, wave  # noqa: E402
from stateright_tpu_torch.engine import scratch_slots  # noqa: E402
from stateright_tpu_torch.hashing import SENTINEL, to_i64  # noqa: E402
from stateright_tpu_torch.membership import OwnerMap  # noqa: E402
from stateright_tpu_torch.mesh import Mesh  # noqa: E402
from stateright_tpu_torch.models import twopc  # noqa: E402
from stateright_tpu_torch.packing import compile_layout  # noqa: E402
from stateright_tpu_torch.sharded_fused import (  # noqa: E402
    ShardedFusedCudaBfsChecker, _umod)

torch.set_num_threads(2)

B = 32  # rows a shard for the kernel checks


# -- The sender kernel -----------------------------------------------------


@pytest.fixture(scope="module")
def packed_rows():
    """Packed rows of 2pc's reachable states at 3 and 5 RMs (the port's
    fused arena on the CPU), uint32."""
    out = {}
    for rm in (3, 5):
        c = twopc.TwoPhaseSys(rm).checker().spawn_cuda_bfs(
            device="cpu", batch_size=256).join()
        out[rm] = carry.words_out(c._vecs[:c._tail])
    return out


def _batches(rows, rm):
    """Four shards' batches from a numpy seed: reachable rows with holes
    (uint32[4, B, Wp], bool[4, B])."""
    rng = np.random.default_rng(rm)
    store = rows[rng.integers(0, len(rows), (4, B))]
    store[2, B // 2:] = store[2, :B // 2]  # repeats within a shard
    valid = rng.random((4, B)) >= 0.1
    return store, valid


_REF_SENDER = {}


def _ref_sender(rm, use_sym, local_dedup, store, valid):
    """JAX's sender kernel on each shard's batch, cached."""
    key = (rm, use_sym, local_dedup)
    if key not in _REF_SENDER:
        rdm = ref_model.TwoPhaseSys(rm).device_model()
        sender = build_sender_megakernel(
            rdm, B, use_sym=use_sym,
            layout=ref_layout(rdm.lane_bits(), rdm.state_width),
            local_dedup=local_dedup, interpret=True)
        _REF_SENDER[key] = [[np.asarray(a) for a in sender(
            jax.numpy.asarray(store[k]), jax.numpy.asarray(valid[k]))]
            for k in range(len(store))]
    return _REF_SENDER[key]


def _port_shard(out, k):
    succ, dfp, pfp, sflat, send = (t[k] for t in out)
    return [carry.words_out(succ), carry.u64_out(dfp), carry.u64_out(pfp),
            sflat.numpy(), send.numpy()]


@pytest.mark.parametrize("local_dedup", [True, False],
                         ids=["local_dedup", "no_local_dedup"])
@pytest.mark.parametrize("use_sym", [False, True], ids=["plain", "sym"])
@pytest.mark.parametrize("rm", [3, 5])
def test_sender_plain_matches_jax_sender_kernel(packed_rows, rm, use_sym,
                                                local_dedup):
    dm = twopc.TwoPhaseDevice(rm)
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    store, valid = _batches(packed_rows[rm], rm)
    ref = _ref_sender(rm, use_sym, local_dedup, store, valid)
    if local_dedup:  # shard 2 does not send its repeats
        assert ref[2][4].sum() < ref[2][3].sum()
    else:
        assert np.array_equal(ref[2][4], ref[2][3])
    launches = wave.sender_megakernel.launches
    for n in (1, 2, 4):
        args = (dm, carry.words_in(store[:n]), torch.from_numpy(valid[:n]),
                use_sym, layout, local_dedup)
        outs = [wave.sender_megakernel_plain(*args),
                wave.sender_megakernel(*args)]
        for out in outs:
            assert out[0].shape == (n, B * dm.max_fanout,
                                    layout.packed_width)
            for k in range(n):
                for got, want in zip(_port_shard(out, k), ref[k]):
                    assert got.dtype == want.dtype
                    assert np.array_equal(got, want), (n, k)
    # Shard k's outputs do not depend on the other shards' rows: with
    # every shard holding shard 2's batch, each equals shard 2's alone.
    same = (dm, carry.words_in(np.stack([store[2]] * 4)),
            torch.from_numpy(np.stack([valid[2]] * 4)), use_sym, layout,
            local_dedup)
    out = wave.sender_megakernel_plain(*same)
    for k in range(4):
        for got, want in zip(_port_shard(out, k), ref[2]):
            assert np.array_equal(got, want), k
    # The CPU path runs the plain version and launches nothing.
    assert wave.sender_megakernel.launches == launches


def test_sender_wrapper_refuses_mixed_devices():
    dm = twopc.TwoPhaseDevice(2)
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    with pytest.raises(ValueError, match="one CUDA device"):
        wave.sender_megakernel(dm, torch.zeros((2, 4, 1), dtype=torch.int32),
                               torch.ones((2, 4), dtype=torch.bool,
                                          device="meta"), False, layout, True)


@pytest.mark.parametrize("n", range(1, 9))
def test_sender_regions_fit_the_engines_scratch(n):
    """The engine's scratch (``DedupScratch(n * S, dev, shards=n)``, sized
    by ``table.scratch_bits``) holds the sender kernel's ``n`` regions,
    each of at least ``scratch_slots(S)`` slots, apart, and the
    owner-side inserts' ``scratch_slots(n * S)``; a scratch sized for one
    shard raises where it does not hold them."""
    assert _run(twopc.TwoPhaseSys(2), n, batch_size=8)._scratch_shape() \
        == (n * 8 * 12, n)
    for B in (1, 7, 100, 256, 4095, 4096, 16384):
        for F in (12, 17, 27, 52):
            S = B * F
            m_bits, region_bits = table.scratch_bits(n * S, n)
            assert 1 << region_bits >= scratch_slots(S)
            regions = [(k << region_bits, (k + 1) << region_bits)
                       for k in range(n)]
            assert regions[-1][1] <= 1 << m_bits
            assert all(a[1] <= b[0] for a, b in zip(regions, regions[1:]))
            assert 1 << m_bits >= scratch_slots(n * S)
            assert 1 << m_bits < 2 * max(scratch_slots(n * S),
                                         regions[-1][1])
    S = 130  # just past a power of two: the regions' worst case
    one = table.DedupScratch(n * S, torch.device("cpu"))
    fits = table.scratch_bits(n * S, n)[0] <= one.m_bits
    assert fits == (n & (n - 1) == 0)
    if fits:
        assert table.DedupScratch.for_call(one, n * S, one.slots.device,
                                           shards=n) is one
    else:
        with pytest.raises(ValueError, match="the scratch takes"):
            table.DedupScratch.for_call(one, n * S, one.slots.device,
                                        shards=n)
    eng = table.DedupScratch(n * S, torch.device("cpu"), shards=n)
    assert eng.is_clean() and eng.m_bits == table.scratch_bits(n * S, n)[0]


# -- Mesh and ownership ------------------------------------------------------


def test_all_to_all_is_the_tiled_block_transpose():
    n, cap = 4, 3
    mesh = Mesh(["cpu"] * n)
    x = torch.arange(n * n * cap * 2).reshape(n, n * cap, 2)
    y = mesh.all_to_all(x)
    for src in range(n):
        for dst in range(n):
            assert torch.equal(y[dst, src * cap:(src + 1) * cap],
                               x[src, dst * cap:(dst + 1) * cap])
    assert torch.equal(mesh.psum(x), x.sum(0))
    assert torch.equal(mesh.pmax(x), x.amax(0))
    assert torch.equal(mesh.all_gather(x), x)


def test_owner_map_and_unsigned_modulo_match_jax():
    rng = np.random.default_rng(3)
    fps = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    fps[:3] = [0, (1 << 64) - 1, 1 << 63]
    for n in (1, 2, 3, 4, 7, 8):
        ref, ours = RefOwnerMap.identity(n), OwnerMap.identity(n)
        assert ours.is_identity and ref.is_identity
        assert ours.assignment() == ref.assignment()
        assert ours.epoch == ref.epoch == 0
        want = fps % np.uint64(n)
        got = _umod(carry.u64_in(fps), n).numpy()
        assert np.array_equal(got, want.astype(np.int64)), n
        assert [ours.owner(int(f)) for f in fps[:64]] == [
            ref.owner(int(f)) for f in fps[:64]]


# -- The engine against JAX's ------------------------------------------------


def _ref_mesh(n):
    """The 8-device test mesh, or the first ``n`` of its devices."""
    return None if n == 8 else RefMesh(np.array(jax.devices()[:n]),
                                       ("shard",))


def _ref_run(model, n, sym=False, **kw):
    b = model.checker()
    if sym:
        b = b.symmetry()
    c = b.spawn_tpu_bfs(sharded=True, mesh=_ref_mesh(n), **kw).join()
    assert isinstance(c, ShardedFusedTpuBfsChecker) and c._n == n
    return c


def _run(model, n, sym=False, **kw):
    b = model.checker()
    if sym:
        b = b.symmetry()
    c = b.spawn_cuda_bfs(device="cpu", mesh=["cpu"] * n, **kw).join()
    assert isinstance(c, ShardedFusedCudaBfsChecker) and c._n == n
    return c


def _ref_paths(c):
    dm = c._dm
    out = {}
    for name, path in c.discoveries().items():
        vecs = [np.asarray(dm.encode(s), np.uint32)
                for s in path.into_states()]
        out[name] = ([host_fp64(v) for v in vecs], vecs,
                     path.into_actions())
    return out


def _assert_same(ref, ours):
    assert ours.unique_state_count() == ref.unique_state_count()
    assert ours.state_count() == ref.state_count()
    assert (ours._capacity, ours._ucap) == (ref._capacity, ref._ucap)
    want = _ref_paths(ref)
    got = {name: (p.fingerprints, p.vecs, p.into_actions())
           for name, p in ours.discoveries().items()}
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name][0] == want[name][0], name
        assert len(got[name][1]) == len(want[name][1])
        assert all(np.array_equal(a, b)
                   for a, b in zip(got[name][1], want[name][1])), name
        assert got[name][2] == want[name][2], name


@pytest.mark.parametrize("exchange_novel_only", [True, False],
                         ids=["novel", "all"])
@pytest.mark.parametrize("wave_kernel", [False, True],
                         ids=["stages", "sender"])
@pytest.mark.parametrize("n", [8, 2])
@pytest.mark.parametrize("rm, unique, states", [(3, 288, 1146),
                                                (4, 1568, 8258)])
def test_sharded_engine_matches_jax(rm, unique, states, n, wave_kernel,
                                   exchange_novel_only):
    kw = dict(batch_size=16, wave_kernel=wave_kernel,
              exchange_novel_only=exchange_novel_only)
    ref = _ref_run(ref_model.TwoPhaseSys(rm), n, **kw)
    ours = _run(twopc.TwoPhaseSys(rm), n, **kw)
    assert (ours.unique_state_count(), ours.state_count()) == (unique,
                                                                states)
    _assert_same(ref, ours)
    assert ours.kernel_path() == ("sender_plain" if wave_kernel
                                  else "dedup_plain")
    ours.assert_properties()


@pytest.mark.parametrize("wave_kernel", [False, True],
                         ids=["stages", "sender"])
def test_symmetry_matches_jax(wave_kernel):
    kw = dict(batch_size=16, wave_kernel=wave_kernel)
    ref = _ref_run(ref_model.TwoPhaseSys(4), 8, sym=True, **kw)
    ours = _run(twopc.TwoPhaseSys(4), 8, sym=True, **kw)
    assert ours.unique_state_count() < 1568
    _assert_same(ref, ours)


@pytest.mark.slow  # the JAX sharded symmetry gate is slow too
def test_symmetry_314_at_5():
    ref = _ref_run(ref_model.TwoPhaseSys(5), 8, sym=True, batch_size=64)
    for wave_kernel in (False, True):
        ours = _run(twopc.TwoPhaseSys(5), 8, sym=True, batch_size=64,
                    wave_kernel=wave_kernel)
        assert (ours.unique_state_count(), ours.state_count()) == (314, 2048)
        _assert_same(ref, ours)


def test_growth_of_tables_and_arenas():
    kw = dict(batch_size=8, table_capacity=1 << 12, arena_capacity=1 << 10,
              waves_per_dispatch=2)
    ref = _ref_run(ref_model.TwoPhaseSys(5), 4, **kw)
    ours = _run(twopc.TwoPhaseSys(5), 4, **kw)
    assert ours.rehashes > 0 and ours.arena_grows > 0
    _assert_same(ref, ours)
    # The sender kernel's path leaves the same state, bit for bit.
    sender = _run(twopc.TwoPhaseSys(5), 4, wave_kernel=True, **kw)
    assert sender.candidates == ours.candidates
    tails = ours._tails
    assert np.array_equal(sender._tails, tails)
    for name in ("_vecs", "_fps", "_par", "_ebits", "_table"):
        a, b = getattr(sender, name), getattr(ours, name)
        if name == "_table":
            a, b = a.sort(dim=1).values, b.sort(dim=1).values
        else:
            a, b = a[:, :int(tails.max())], b[:, :int(tails.max())]
        assert torch.equal(a, b), name


def test_rehash_past_2_30_slots_takes_the_engines_scratch(monkeypatch):
    """As the unsharded engine's test: every slice's grow from 2^30 to
    2^31 slots, on the meta device with the insert stubbed, goes through
    the engine's scratch in calls of at most its rows."""
    n = 3
    c = twopc.TwoPhaseSys(3).checker().spawn_cuda_bfs(
        device="cpu", mesh=["cpu"] * n, batch_size=1 << 12).join()
    rows = c._scratch_shape()[0]
    calls, scratch, C = [], object(), 1 << 30

    def insert(fps, new, scratch=None):
        calls.append((fps.shape[0], new.shape[0], scratch))
        return (None,) * 4 + (torch.zeros((), dtype=torch.bool),)

    monkeypatch.setattr(fused, "dedup_and_insert", insert)
    c._table = torch.empty((n, C), dtype=torch.int64, device="meta")
    c._capacity, c._scratch = C, scratch
    c._occs = np.full(n, C // 2 - rows + 1)
    c._grow(c._B)
    assert c._capacity == 2 * C and c._table.shape == (n, 2 * C)
    assert len(calls) == n * fused._pow2(-(-C // rows))
    assert sum(k for k, _, _ in calls) == n * C
    assert all(k <= rows and cap == 2 * C and s is scratch
               for k, cap, s in calls)


def test_chunked_rehash_equals_one_call_as_a_set():
    c = _run(twopc.TwoPhaseSys(5), 4, batch_size=16)
    old = c._table.clone()
    assert old.shape[1] > 2 * c._scratch_shape()[0]  # several chunks
    c._occs[:] = c._capacity // 2
    c._grow(c._B)
    for k in range(4):
        one = torch.full((2 * old.shape[1],), SENTINEL, dtype=torch.int64)
        assert not bool(table.dedup_and_insert(old[k], one)[4])
        got = c._table[k]
        assert int((got != SENTINEL).sum()) == int((old[k] != SENTINEL).sum())
        assert torch.equal(got.sort().values, one.sort().values)


def test_target_state_count():
    rb = ref_model.TwoPhaseSys(4).checker().target_state_count(500)
    ref = rb.spawn_tpu_bfs(sharded=True, batch_size=8).join()
    ours = (twopc.TwoPhaseSys(4).checker().target_state_count(500)
            .spawn_cuda_bfs(device="cpu", mesh=["cpu"] * 8,
                            batch_size=8).join())
    assert 500 <= ours.state_count() < 8258
    _assert_same(ref, ours)


def test_jax_mid_run_state_carries_into_the_port():
    """A JAX sharded engine's mid-run tables, arenas and queues, moved in
    through ``carry``, let the port finish the run: the same counts,
    discoveries and, shard by shard, the same arena rows as the JAX run
    that never stopped."""
    n, kw = 2, dict(batch_size=16, waves_per_dispatch=2)
    mid = (ref_model.TwoPhaseSys(4).checker().target_state_count(2000)
           .spawn_tpu_bfs(sharded=True, mesh=_ref_mesh(n), **kw).join())
    full = _ref_run(ref_model.TwoPhaseSys(4), n, **kw)
    heads, tails = mid._shard_heads.copy(), mid._shard_tails.copy()
    assert (tails > heads).any() and mid.state_count() < 8258

    ours = (twopc.TwoPhaseSys(4).checker().target_state_count(1)
            .spawn_cuda_bfs(device="cpu", mesh=["cpu"] * n, **kw).join())
    assert ours.dispatches == 0
    layout = ours._layout
    vecs_a, fps_a, par_a, eb_a = (np.asarray(a) for a in mid._arena)
    visited = np.asarray(mid._visited)
    ours._table = carry.sharded_table_in(visited, n)
    ours._capacity = mid._capacity
    ours._vecs = carry.sharded_arena_in(vecs_a, n, layout=layout)
    ours._fps = carry.sharded_arena_in(fps_a, n)
    ours._par = carry.sharded_arena_in(par_a, n)
    ours._ebits = carry.sharded_arena_in(eb_a, n)
    ours._ucap = mid._ucap
    occs = (ours._table != SENTINEL).sum(dim=1).numpy()
    ours._heads, ours._tails, ours._occs = heads, tails, occs
    ours._unique_count = mid.unique_state_count()
    ours._state_count = mid.state_count()
    ours._discoveries = dict(mid._discoveries)
    ours._target = None
    P = len(ours._properties)
    st = np.zeros((n, 8 + P), np.int64)
    st[:, 0], st[:, 1], st[:, 2] = heads, tails, occs
    st[:, 3] = mid.state_count() - 1
    st[:, 5] = 1 << 62
    st[:, 8:] = SENTINEL
    for i, p in enumerate(ours._properties):
        if p.name in mid._discoveries:
            st[:, 8 + i] = to_i64(mid._discoveries[p.name])
    ours._stats = torch.from_numpy(st)
    ours._run_waves()

    assert (ours.unique_state_count(), ours.state_count()) == (1568, 8258)
    _assert_same(full, ours)
    f_vecs, f_fps, f_par, f_eb = (np.asarray(a) for a in full._arena)
    u = full._ucap
    assert np.array_equal(ours._tails, full._shard_tails)
    for k in range(n):
        t = int(full._shard_tails[k])
        rows = layout.unpack_np(carry.words_out(ours._vecs[k, :t]))
        assert np.array_equal(rows, f_vecs[k * u:k * u + t])
        assert np.array_equal(carry.u64_out(ours._fps[k, :t]),
                              f_fps[k * u:k * u + t])
        assert np.array_equal(carry.u64_out(ours._par[k, :t]),
                              f_par[k * u:k * u + t])
        assert np.array_equal(carry.words_out(ours._ebits[k, :t]),
                              f_eb[k * u:k * u + t])


# -- Knobs, paths and refusals -----------------------------------------------


def test_kernel_path_names_the_plain_versions_on_the_cpu():
    b = twopc.TwoPhaseSys(2).checker()
    assert b.spawn_cuda_bfs(device="cpu", mesh=["cpu"] * 2,
                            wave_kernel=True).join().kernel_path() \
        == "sender_plain"
    assert b.spawn_cuda_bfs(mesh=["cpu"] * 2).join().kernel_path() \
        == "dedup_plain"


def test_one_shard_equals_the_unsharded_engine():
    one = _run(twopc.TwoPhaseSys(4), 1, batch_size=64)
    flat = twopc.TwoPhaseSys(4).checker().spawn_cuda_bfs(
        device="cpu", batch_size=64).join()
    assert (one.unique_state_count(), one.state_count()) == (
        flat.unique_state_count(), flat.state_count()) == (1568, 8258)
    assert ({k: p.fingerprints for k, p in one.discoveries().items()}
            == {k: p.fingerprints for k, p in flat.discoveries().items()})


@pytest.mark.parametrize("mesh", [["cuda:0", "cuda:1"], ["cpu", "cuda:0"]])
def test_a_mesh_over_distinct_devices_raises(mesh):
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        twopc.TwoPhaseSys(2).checker().spawn_cuda_bfs(mesh=mesh)


class _NoCode(twopc.TwoPhaseDevice):
    def cuda_model(self):
        return None


def test_sender_kernel_on_the_card_never_falls_back(monkeypatch):
    """Without device code for the model, ``wave_kernel=True`` on a CUDA
    mesh falls back neither to the CPU nor to the host: the size gate
    refuses the model before any device work, and the engine warns once
    and runs the torch stages and the sort in place of the sender kernel
    (the card's gate run here on the CPU's plain versions); on the CPU
    the same model runs the plain version."""
    from test_torch_sizes import _card_gate

    class Sys(twopc.TwoPhaseSys):
        def device_model(self):
            return _NoCode(self.rm_count)

    _card_gate(monkeypatch)
    with pytest.warns(RuntimeWarning, match="_NoCode has no CUDA"):
        c = Sys(2).checker().spawn_cuda_bfs(mesh=["cpu"] * 2,
                                            wave_kernel=True)
    assert c.join().kernel_path() == "dedup_plain"
    assert c.unique_state_count() == 56
    monkeypatch.undo()
    c = Sys(2).checker().spawn_cuda_bfs(mesh=["cpu"] * 2, wave_kernel=True)
    assert c.join().kernel_path() == "sender_plain"


def test_knobs_that_need_a_card_or_a_mesh():
    b = twopc.TwoPhaseSys(2).checker()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            b.spawn_cuda_bfs(sharded=True)
    with pytest.raises(ValueError, match="sharded"):
        b.spawn_cuda_bfs(device="cpu", exchange_novel_only=False)
    with pytest.raises(ValueError, match="mesh"):
        b.spawn_cuda_bfs(device="cpu", sharded=True)
