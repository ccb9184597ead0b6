"""The port's paxos, its register workload and actor layer, against JAX's.

Same rows through the JAX package's device model and the port's: layout
and tables at 1 to 4 clients, the codec, the batch-first ``step``, the
four properties (and the linearizability predicate on an adversarial
enumeration of histories), the client-symmetry ``representative`` at 4
clients, and the network's sorted insert and removal. Then the whole
slice: ``PaxosSys`` through ``spawn_cuda_bfs(device="cpu")`` against JAX
``spawn_tpu_bfs`` in counts, capacities and discovery paths, fused and
on ``mesh=["cpu"] * n``, each on the torch stages and with
``wave_kernel=True`` (the wave and sender kernels' plain versions, the
CPU side of the kernels that run paxos's CUDA step on the card). All of it
is integer arithmetic: every comparison is exact.
"""

import itertools
import os
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
import paxos as ref_paxos  # noqa: E402
from stateright_tpu.tpu import register_workload as ref_rw  # noqa: E402
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
from stateright_tpu.tpu.models.paxos import PaxosDevice as RefPaxosDevice  # noqa: E402,E501
from stateright_tpu_torch import carry, register_workload, wave  # noqa: E402,E501
from stateright_tpu_torch.actor_device import (EMPTY_ENV, net_insert,  # noqa: E402,E501
                                               net_remove_at)
from stateright_tpu_torch.device_model import DeviceFormUnavailable  # noqa: E402,E501
from stateright_tpu_torch.models.paxos import PaxosDevice, PaxosSys  # noqa: E402,E501
from stateright_tpu_torch.packing import compile_layout  # noqa: E402

torch.set_num_threads(2)


def _ref(c, liveness=False):
    return ref_paxos.PaxosModelCfg(c, 3, liveness=liveness).into_model()


def _levels(c, levels, cap=None, seed=0, batch=64):
    """Rows reached level by level from init by JAX's step under
    ``jit(vmap)``, each level a seeded sample of at most ``cap`` rows
    (all of them without a cap): ``uint32[N, W]``."""
    model = _ref(c)
    dm = model.device_model()
    step = jax.jit(jax.vmap(dm.step))
    rng = np.random.default_rng(seed)
    rows = np.asarray(dm.encode(model.init_states()[0]), np.uint32)[None]
    seen, out = {rows[0].tobytes()}, [rows]
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


@pytest.fixture(scope="module")
def rows():
    """Every reachable row at 1 client (265), and a seeded sample of the
    rows at 2 clients."""
    one = _levels(1, 64)
    assert len(one) == 265
    return {1: one, 2: _levels(2, 14, cap=40)}


# -- Layout, tables, codec ---------------------------------------------------


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_layout_and_init_state_match_jax(c):
    ref_model = _ref(c)
    ref = ref_model.device_model()
    dm = PaxosDevice(c)
    for name in ("state_width", "max_fanout", "net_offset", "net_slots",
                 "error_lane", "phase_off", "hist_off", "extra_shift"):
        assert getattr(dm, name) == getattr(ref, name), name
    assert dm.lane_bits() == ref.lane_bits()
    assert dm.extra_bits() == ref.extra_bits()
    init, ref_init = PaxosSys(c).init_states(), ref_model.init_states()
    assert len(init) == len(ref_init) == 1
    assert np.array_equal(dm.encode(init[0]), ref.encode(ref_init[0]))
    assert repr(init[0]) == repr(ref_init[0])
    assert [(p.name, p.expectation.value) for p in PaxosSys(c).properties()
            ] == [(p.name, p.expectation.value)
                  for p in ref_model.properties()]


@pytest.mark.parametrize("c", [1, 2, 3])
def test_tables_match_jax(c):
    for a, b in zip(register_workload.perm_tables(c),
                    ref_rw.perm_tables(c)):
        assert np.array_equal(a, b)
    for a, b in zip(register_workload.observation_tables(c),
                    ref_rw.observation_tables(c)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(register_workload.packed_observation_tables(c),
                    ref_rw.packed_observation_tables(c)):
        assert np.array_equal(carry.u64_in(a).numpy(),
                              carry.u64_in(np.asarray(b)).numpy())
    for a, b in zip(register_workload.serialization_tables(c),
                    ref_rw.serialization_tables(c)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("c", [1, 2])
def test_codec_round_trips_and_decodes_as_jax(rows, c):
    dm, ref = PaxosDevice(c), _ref(c).device_model()
    for r in rows[c]:
        state = dm.decode(r)
        assert np.array_equal(dm.encode(state), r)
        assert repr(state) == repr(ref.decode(r))


# -- The device functions -----------------------------------------------------


@pytest.mark.parametrize("c", [1, 2])
def test_step_matches_jax(rows, c):
    """A ragged batch of 37 rows at a time: ``valid`` and every valid
    successor's lanes bit for bit."""
    dm, ref = PaxosDevice(c), _ref(c).device_model()
    r_step = jax.jit(jax.vmap(ref.step))
    n_valid = 0
    for i in range(0, len(rows[c]), 37):
        part = rows[c][i:i + 37]
        succ, valid = dm.step(carry.rows_in(part))
        r_succ, r_valid = (np.asarray(a) for a in r_step(jnp.asarray(part)))
        assert np.array_equal(valid.numpy(), r_valid)
        assert np.array_equal(carry.rows_out(succ)[r_valid], r_succ[r_valid])
        n_valid += int(r_valid.sum())
    assert n_valid > len(rows[c])


@pytest.mark.parametrize("c", [1, 2])
def test_properties_match_jax(rows, c):
    dm, ref = PaxosDevice(c), _ref(c).device_model()
    r_props = ref.device_properties()
    x = carry.rows_in(rows[c])
    assert sorted(dm.device_properties()) == sorted(r_props)
    for name, fn in dm.device_properties().items():
        want = np.asarray(jax.vmap(r_props[name])(jnp.asarray(rows[c])))
        assert np.array_equal(fn(x).numpy(), want), name
    assert dm.device_properties()["value chosen"](x).any()


def test_linearizability_predicate_on_adversarial_histories():
    """The enumeration of ``tests/test_tpu_paxos.py::
    test_device_linearizability_predicate_vs_host_tester`` at 2 clients:
    every well-formed history-lane combination, the non-linearizable
    ones included; the port's predicate equals JAX's and the host
    tester's verdict."""
    c = 2
    model = _ref(c)
    ref = model.device_model()
    r_pred = jax.jit(jax.vmap(ref.device_properties()["linearizable"]))
    pred = PaxosDevice(c).device_properties()["linearizable"]
    base = ref.encode(model.init_states()[0])
    vecs = []
    for status in itertools.product(range(1, 5), repeat=c):
        completed = [1 if s in (2, 3) else (2 if s == 4 else 0)
                     for s in status]
        rets = [range(c + 1) if s == 4 else [0] for s in status]
        hbs = []
        for k in range(c):
            if status[k] >= 3:
                peer_ranges = [range(0, completed[j] + 1) if j != k else [0]
                               for j in range(c)]
                hbs.append([sum(e << (2 * j) for j, e in enumerate(combo))
                            for combo in itertools.product(*peer_ranges)])
            else:
                hbs.append([0])
        for ret in itertools.product(*rets):
            for hb in itertools.product(*hbs):
                vec = base.copy()
                for k in range(c):
                    b = ref.hist_off + 3 * k
                    vec[b:b + 3] = (status[k], ret[k], hb[k])
                vecs.append(vec)
    vecs = np.stack(vecs)
    host = np.array([ref.decode(v).history.serialized_history() is not None
                     for v in vecs])
    got = pred(carry.rows_in(vecs)).numpy()
    assert len(vecs) > 100 and 0 < host.sum() < len(vecs)
    assert np.array_equal(got, np.asarray(r_pred(jnp.asarray(vecs))))
    assert np.array_equal(got, host)


def test_representative_matches_jax_at_4_clients():
    """The client-permutation group is first nontrivial at 4 clients (3
    servers): {id, swap(client 0, client 3)}."""
    dm, ref = PaxosDevice(4), _ref(4).device_model()
    assert dm.client_permutations() == ref.client_permutations() == [
        (3, 1, 2, 0)]
    rows = _levels(4, 6, cap=48, seed=4)
    rep = carry.rows_out(dm.representative(carry.rows_in(rows)))
    want = np.asarray(jax.jit(jax.vmap(ref.representative))(
        jnp.asarray(rows)))
    assert np.array_equal(rep, want)
    assert (rep != rows).any()  # some rows are not their class's least
    x = torch.zeros((2, PaxosDevice(3).state_width), dtype=torch.int64)
    assert PaxosDevice(3).representative(x) is x  # a trivial group


@pytest.mark.parametrize("remove", [True, False], ids=["remove", "keep"])
def test_network_insert_and_removal_match_jax(remove):
    """The sorted slot list's delivery effect on seeded random lists:
    removal of the delivered slot (or, for the insert alone, none), then
    up to three sends, with duplicates, empty sends and full lists
    (overflow)."""
    ref = _ref(2).device_model()
    e, rng = ref.net_slots, np.random.default_rng(3)
    n = 256
    nets = np.full((n, e), EMPTY_ENV, np.uint32)
    for i in range(n):
        k = rng.integers(0, e + 1)
        nets[i, :k] = np.sort(rng.choice(1 << 12, k, replace=False))
    outs = rng.integers(0, 1 << 12, (n, 3)).astype(np.uint32)
    outs[rng.random((n, 3)) < 0.3] = EMPTY_ENV
    dup = rng.random(n) < 0.3
    outs[dup, 1] = np.where(nets[dup, 0] != EMPTY_ENV, nets[dup, 0],
                            outs[dup, 1])
    slot = rng.integers(0, e, n)

    def ref_effect(net, out, s):
        return ref._net_effect(net, out, s if remove else None)

    r_net, r_over = (np.asarray(a) for a in jax.vmap(ref_effect)(
        jnp.asarray(nets), jnp.asarray(outs), jnp.asarray(slot)))
    net = carry.rows_in(nets)
    if remove:
        net = net_remove_at(net, torch.from_numpy(slot))
    got, over = net_insert(net, carry.rows_in(outs))
    assert np.array_equal(carry.rows_out(got), r_net)
    assert np.array_equal(over.numpy(), r_over)
    assert r_over.any() and not r_over.all()


# -- The whole slice ----------------------------------------------------------


def _ref_paths(c):
    dm = c._dm
    out = {}
    for name, path in c.discoveries().items():
        vecs = [np.asarray(dm.encode(s), np.uint32)
                for s in path.into_states()]
        out[name] = ([host_fp64(v) for v in vecs], vecs,
                     [repr(a) for a in path.into_actions()])
    return out


def _assert_same(ref, ours):
    assert ours.unique_state_count() == ref.unique_state_count()
    assert ours.state_count() == ref.state_count()
    assert ours._capacity == ref._capacity
    want = _ref_paths(ref)
    got = {name: (p.fingerprints, p.vecs,
                  [repr(a) for a in p.into_actions()])
           for name, p in ours.discoveries().items()}
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name][0] == want[name][0], name
        assert len(got[name][1]) == len(want[name][1])
        assert all(np.array_equal(a, b)
                   for a, b in zip(got[name][1], want[name][1])), name
        assert got[name][2] == want[name][2], name


def _ref_mesh(n):
    return RefMesh(np.array(jax.devices()[:n]), ("shard",))


def test_one_client_matches_jax_fused_engine():
    ref = _ref(1).checker().spawn_tpu_bfs(batch_size=128).join()
    ours = PaxosSys(1).checker().spawn_cuda_bfs(device="cpu",
                                                batch_size=128).join()
    assert (ours.unique_state_count(), ours.state_count()) == (265, 482)
    assert sorted(ours.discoveries()) == ["value chosen"]
    ours.assert_properties()
    _assert_same(ref, ours)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_one_client_matches_jax_sharded_engine(n):
    ref = _ref(1).checker().spawn_tpu_bfs(
        sharded=True, mesh=_ref_mesh(n), batch_size=128).join()
    ours = PaxosSys(1).checker().spawn_cuda_bfs(
        device="cpu", mesh=["cpu"] * n, batch_size=128).join()
    assert (ours.unique_state_count(), ours.state_count()) == (265, 482)
    assert ours._ucap == ref._ucap
    _assert_same(ref, ours)
    assert ours.discovery("linearizable") is None


@pytest.mark.slow
def test_two_clients_16668_fused_and_sharded():
    ref = _ref(2).checker().spawn_tpu_bfs(batch_size=512).join()
    ours = PaxosSys(2).checker().spawn_cuda_bfs(device="cpu",
                                                batch_size=512).join()
    assert ours.unique_state_count() == 16668
    _assert_same(ref, ours)
    ref = _ref(2).checker().spawn_tpu_bfs(
        sharded=True, mesh=_ref_mesh(4), batch_size=256).join()
    ours = PaxosSys(2).checker().spawn_cuda_bfs(
        device="cpu", mesh=["cpu"] * 4, batch_size=256).join()
    assert ours.unique_state_count() == 16668
    _assert_same(ref, ours)
    ours.assert_properties()


@pytest.mark.slow
def test_liveness_matches_jax():
    ref = _ref(1, liveness=True).checker().spawn_tpu_bfs(
        batch_size=128).join()
    ours = PaxosSys(1, liveness=True).checker().spawn_cuda_bfs(
        device="cpu", batch_size=128).join()
    _assert_same(ref, ours)
    ours.assert_no_discovery("eventually chosen")
    ours.assert_properties()


# -- Errors ------------------------------------------------------------------


def test_network_overflow_raises_on_both_sides():
    """With two network slots a delivery's sends overflow the list: the
    error lane stops the run on both engines."""

    ref_model = _ref(1)
    ref_model.device_model = lambda: RefPaxosDevice(1, 3, ref_paxos,
                                                    net_slots=2)

    class Sys(PaxosSys):
        def device_model(self):
            return PaxosDevice(1, net_slots=2)

    with pytest.raises(RuntimeError, match="error lane"):
        ref_model.checker().spawn_tpu_bfs(batch_size=128).join()
    lane = PaxosDevice(1, net_slots=2).error_lane
    with pytest.raises(RuntimeError, match=f"error lane {lane} "):
        Sys(1).checker().spawn_cuda_bfs(device="cpu", batch_size=128).join()
    with pytest.raises(RuntimeError, match="error lane"):
        Sys(1).checker().spawn_cuda_bfs(mesh=["cpu"] * 2,
                                        batch_size=128).join()


def test_unsupported_configurations_raise():
    # As in JAX, the model exists at any server count and its device form
    # refuses (``spawn_cuda_bfs`` then falls back to the host BFS).
    with pytest.raises(DeviceFormUnavailable, match="3 servers"):
        PaxosSys(1, 4).device_model()
    with pytest.raises(DeviceFormUnavailable, match="3 servers"):
        PaxosDevice(1, 4)
    with pytest.raises(DeviceFormUnavailable, match="1 to 4 clients"):
        PaxosDevice(5)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_cuda_model_resolves_paxos_with_its_sentinel_lanes(c):
    """paxos's CUDA device code is ``csrc/models/paxos.cuh`` at its client
    count and network size, and the lanes table the kernels take flags
    each network lane as a sentinel lane holding ``EMPTY_ENV``: the
    packed layout, five rows of W."""
    for net_slots in (0, 3):
        dm = PaxosDevice(c, net_slots=net_slots)
        layout = compile_layout(dm.lane_bits(), dm.state_width)
        name, params, lanes = wave.cuda_model(dm, layout)
        assert (name, params) == ("paxos", (c, dm.net_slots))
        w, off, e = dm.state_width, dm.net_offset, dm.net_slots
        table = lanes.view(np.uint32).reshape(5, w)
        assert [list(r) for r in table[:3]] == [
            [lane.word for lane in layout.lanes],
            [lane.offset for lane in layout.lanes],
            [lane.bits for lane in layout.lanes]]
        flags = np.zeros(w, bool)
        flags[off:off + e] = True
        assert np.array_equal(table[3] != 0, flags)
        assert (table[4][flags] == EMPTY_ENV).all()
        assert (table[4][~flags] == [lane.mask for lane in layout.lanes
                                     if lane.sentinel is None]).all()


class _OwnServer(PaxosDevice):
    """Changes the delivery, so paxos's device code no longer computes
    its step."""

    def server_deliver(self, lanes, f):
        new_lanes, handled, outs = super().server_deliver(lanes, f)
        return new_lanes, handled & (f.kind != 1), outs


@pytest.mark.parametrize("spawn", [dict(device="cuda:0"),
                                   dict(mesh=["cuda:0"] * 2)],
                         ids=["wave", "sender"])
def test_wave_kernel_refuses_a_paxos_subclass_with_its_own_delivery(spawn):
    """A ``PaxosDevice`` subclass that overrides ``server_deliver``
    without its own ``cuda_model`` has no CUDA step: ``wave_kernel=True``
    on a CUDA device raises at spawn, before any device work (so no card
    is needed), and never falls back to the torch stages; on the CPU it
    runs the plain versions."""

    class Sys(PaxosSys):
        def device_model(self):
            return _OwnServer(self.client_count)

    with pytest.raises(NotImplementedError,
                       match=r"_OwnServer has no CUDA.*\['server_deliver'\]"):
        Sys(1).checker().spawn_cuda_bfs(wave_kernel=True, **spawn)
    c = Sys(1).checker().spawn_cuda_bfs(device="cpu", wave_kernel=True,
                                        batch_size=128).join()
    assert c.kernel_path() == "megakernel_plain"
    assert c.unique_state_count() < 265


# -- The whole check on the kernels' path -------------------------------------


@pytest.mark.parametrize("n", [None, 1, 3, 4],
                         ids=["fused", "n=1", "n=3", "n=4"])
def test_one_client_on_the_wave_kernel_path_matches_jax(n):
    """``wave_kernel=True`` on the CPU runs the wave kernel's plain version
    (fused) or the sender kernel's (sharded), the functions the card's
    kernels are held to: counts, capacities and discovery paths equal to
    JAX's engines."""
    if n is None:
        ref = _ref(1).checker().spawn_tpu_bfs(batch_size=128).join()
        ours = PaxosSys(1).checker().spawn_cuda_bfs(
            device="cpu", wave_kernel=True, batch_size=128).join()
        assert ours.kernel_path() == "megakernel_plain"
    else:
        ref = _ref(1).checker().spawn_tpu_bfs(
            sharded=True, mesh=_ref_mesh(n), batch_size=128).join()
        ours = PaxosSys(1).checker().spawn_cuda_bfs(
            mesh=["cpu"] * n, wave_kernel=True, batch_size=128).join()
        assert ours.kernel_path() == "sender_plain"
        assert ours._ucap == ref._ucap
    assert (ours.unique_state_count(), ours.state_count()) == (265, 482)
    _assert_same(ref, ours)
    ours.assert_properties()


def test_liveness_on_the_wave_kernel_path_matches_jax():
    ref = _ref(1, liveness=True).checker().spawn_tpu_bfs(
        batch_size=128).join()
    ours = PaxosSys(1, liveness=True).checker().spawn_cuda_bfs(
        device="cpu", wave_kernel=True, batch_size=128).join()
    assert ours.kernel_path() == "megakernel_plain"
    _assert_same(ref, ours)
    ours.assert_no_discovery("eventually chosen")
    ours.assert_properties()


def test_network_overflow_raises_on_the_wave_kernel_path():
    """Two network slots overflow: the error lane, read from the packed
    successors, stops the run fused and sharded."""

    class Sys(PaxosSys):
        def device_model(self):
            return PaxosDevice(1, net_slots=2)

    lane = PaxosDevice(1, net_slots=2).error_lane
    for spawn in (dict(device="cpu"), dict(mesh=["cpu"] * 2)):
        with pytest.raises(RuntimeError, match=f"error lane {lane} "):
            Sys(1).checker().spawn_cuda_bfs(wave_kernel=True, batch_size=128,
                                            **spawn).join()


@pytest.mark.slow
def test_two_clients_16668_on_the_wave_kernel_path():
    ref = _ref(2).checker().spawn_tpu_bfs(batch_size=512).join()
    ours = PaxosSys(2).checker().spawn_cuda_bfs(
        device="cpu", wave_kernel=True, batch_size=512).join()
    assert ours.unique_state_count() == 16668
    _assert_same(ref, ours)
    ref = _ref(2).checker().spawn_tpu_bfs(
        sharded=True, mesh=_ref_mesh(4), batch_size=256).join()
    ours = PaxosSys(2).checker().spawn_cuda_bfs(
        mesh=["cpu"] * 4, wave_kernel=True, batch_size=256).join()
    assert ours.unique_state_count() == 16668
    _assert_same(ref, ours)
    ours.assert_properties()
