"""The port's register corpus, single-copy and ABD, against JAX's.

Same rows through the JAX package's device models
(``stateright_tpu/tpu/models/single_copy.py`` and ``abd.py``, built by
``examples/single_copy_register.py`` and ``linearizable_register.py``)
and the port's (``stateright_tpu_torch/models/single_copy.py`` and
``abd.py``): the layout and init state at 1 to 4 clients, the codec, the
batch-first ``step`` on JAX's reachable rows and on adversarial rows, the
properties, the client-symmetry ``representative`` at 3 and 4 clients,
``compact_envs`` and ABD's request-id collision guard. Then the whole
slice: each model through ``spawn_cuda_bfs(device="cpu")`` against JAX
``spawn_tpu_bfs`` in counts, capacities and discovery chains, on the
fused, classic and ``mesh=["cpu"] * n`` engines, each on the torch stages
and with ``wave_kernel=True`` (the wave and sender kernels' plain
versions, the CPU side of the kernels that run these models' CUDA steps
on the card); and a checkpoint of single-copy 3 written byte-equal to
JAX's and resumed across the packages. All of it is integer arithmetic:
every comparison is exact.
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
import linearizable_register as ref_abd  # noqa: E402
import single_copy_register as ref_sc  # noqa: E402
from stateright_tpu.tpu import actor_device as ref_actor_device  # noqa: E402,E501
from stateright_tpu.tpu.device_model import \
    DeviceFormUnavailable as RefUnavailable  # noqa: E402
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
from stateright_tpu_torch import carry, wave  # noqa: E402
from stateright_tpu_torch import checkpoint_format as ckpt  # noqa: E402
from stateright_tpu_torch.actor_device import EMPTY_ENV, compact_envs  # noqa: E402,E501
from stateright_tpu_torch.device_model import DeviceFormUnavailable  # noqa: E402,E501
from stateright_tpu_torch.models.abd import AbdDevice, AbdSys  # noqa: E402
from stateright_tpu_torch.models.single_copy import (  # noqa: E402
    SingleCopyDevice, SingleCopySys)
from stateright_tpu_torch.packing import compile_layout  # noqa: E402

torch.set_num_threads(2)

#: each model's JAX and port twins at (clients, servers)
MODELS = {
    "single_copy": (
        lambda c, s: ref_sc.SingleCopyModelCfg(c, s).into_model(),
        SingleCopySys),
    "abd": (lambda c, s: ref_abd.AbdModelCfg(c, s).into_model(), AbdSys)}


def _levels(ref_model, levels=64, cap=None, seed=0, batch=64):
    """Rows ``ref_model``'s device model reaches level by level from
    init under ``jit(vmap(step))``, each level a seeded sample of at most
    ``cap`` rows (all of them without a cap): ``uint32[N, W]``."""
    dm = ref_model.device_model()
    step = jax.jit(jax.vmap(dm.step))
    rng = np.random.default_rng(seed)
    rows = np.asarray(dm.encode(ref_model.init_states()[0]), np.uint32)[None]
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


def _adversarial(dm, n, rng):
    """Seeded rows no run reaches: random lanes (most of them small, so
    comparisons go both ways), networks of random and empty envelopes
    built from random fields (every kind and destination, extra bits in
    and past their range), half of them unsorted."""
    w, off, e = dm.state_width, dm.net_offset, dm.net_slots
    rows = rng.integers(0, 1 << 32, (n, w), dtype=np.uint64)
    small = rng.random((n, w)) < 0.6
    rows[small] = rng.integers(0, 12, small.sum())
    env = (rng.integers(0, 8, (n, e)) | rng.integers(0, 8, (n, e)) << 3
           | rng.integers(0, 16, (n, e)) << 6
           | rng.integers(0, 8, (n, e)) << 10
           | rng.integers(0, 8, (n, e)) << 13
           | rng.integers(0, 1 << 12, (n, e)) << dm.extra_shift) & 0xFFFFFFFF
    narrow = rng.random((n, e)) < 0.5
    env[narrow] &= (1 << (dm.extra_shift + 4)) - 1
    net = rows[:, off:off + e]
    keep = rng.random((n, e)) < 0.3
    net[:] = np.where(keep, net, env)
    net[rng.random((n, e)) < 0.3] = EMPTY_ENV
    ordered = rng.random(n) < 0.5
    net[ordered] = np.sort(net[ordered], axis=1)
    return rows.astype(np.uint32)


def _perturbed(rows, dm, n, rng):
    """``n`` seeded rows near reachable ones: each a reachable row with two
    lanes before the network set to small values and two network slots
    set to envelopes of the model's own actors, kinds and small fields,
    the network sorted again in most: they reach the protocols' deeper
    branches (quorums, phases, matching requests) that uniform garbage
    rarely does."""
    out = rows[rng.integers(0, len(rows), n)].astype(np.uint64)
    off, e = dm.net_offset, dm.net_slots
    kinds = 4 + len(dm.INTERNAL_KINDS)
    for r in out:
        r[rng.integers(0, off, 2)] = rng.integers(0, 8, 2)
        env = (rng.integers(0, dm.S + dm.C, 2)
               | rng.integers(0, dm.S + dm.C, 2) << 3
               | rng.integers(0, kinds, 2) << 6
               | rng.integers(0, 8, 2) << 10
               | rng.integers(0, dm.C + 1, 2) << 13
               | rng.integers(0, 16, 2) << dm.extra_shift)
        r[off + rng.integers(0, e, 2)] = env
        if rng.random() < 0.8:
            r[off:off + e] = np.sort(r[off:off + e])
    return out.astype(np.uint32)


@pytest.fixture(scope="module")
def rows():
    """Every reachable row of single-copy 2/1 (93), 2/2 (62) and ABD 2/2
    (544), and a seeded sample of single-copy 3/1's and 4/1's and of ABD
    2/3's (its broadcasts have two sends)."""
    out = {("single_copy", 2, 1): _levels(MODELS["single_copy"][0](2, 1)),
           ("single_copy", 2, 2): _levels(MODELS["single_copy"][0](2, 2)),
           ("abd", 2, 2): _levels(MODELS["abd"][0](2, 2)),
           ("single_copy", 3, 1): _levels(MODELS["single_copy"][0](3, 1),
                                          cap=60, seed=3),
           ("single_copy", 4, 1): _levels(MODELS["single_copy"][0](4, 1),
                                          cap=30, seed=4),
           ("abd", 2, 3): _levels(MODELS["abd"][0](2, 3), levels=14,
                                  cap=30, seed=5)}
    assert [len(out[k]) for k in list(out)[:3]] == [93, 62, 544]
    return out


def _pair(key):
    name, c, s = key
    ref_model = MODELS[name][0](c, s)
    return ref_model, MODELS[name][1](c, s)


# -- Layout, init state, codec -------------------------------------------------


@pytest.mark.parametrize("key", [("single_copy", c, s) for s in (1, 2)
                                 for c in (1, 2, 3, 4)]
                         + [("abd", c, s) for c, s in ((1, 1), (1, 2), (2, 2),
                                                       (2, 3), (3, 3), (4, 4))],
                         ids=lambda k: f"{k[0]}-{k[1]}-{k[2]}")
def test_layout_and_init_state_match_jax(key):
    ref_model, sys_ = _pair(key)
    ref, dm = ref_model.device_model(), sys_.device_model()
    for name in ("state_width", "max_fanout", "net_offset", "net_slots",
                 "error_lane", "phase_off", "hist_off", "extra_shift",
                 "max_out", "SERVER_LANES", "INTERNAL_KINDS"):
        assert getattr(dm, name) == getattr(ref, name), name
    assert dm.lane_bits() == ref.lane_bits()
    assert dm.extra_bits() == ref.extra_bits()
    init, ref_init = sys_.init_states(), ref_model.init_states()
    assert len(init) == len(ref_init) == 1
    assert np.array_equal(dm.encode(init[0]), ref.encode(ref_init[0]))
    assert repr(init[0]) == repr(ref_init[0])
    assert [(p.name, p.expectation.value) for p in sys_.properties()] == [
        (p.name, p.expectation.value) for p in ref_model.properties()]
    assert sys_.checkpoint_name == type(ref_model).__name__


@pytest.mark.parametrize("key", [("single_copy", 2, 1), ("single_copy", 2, 2),
                                 ("abd", 2, 2), ("single_copy", 4, 1)],
                         ids=lambda k: f"{k[0]}-{k[1]}-{k[2]}")
def test_codec_round_trips_and_decodes_as_jax(rows, key):
    ref_model, sys_ = _pair(key)
    ref, dm = ref_model.device_model(), sys_.device_model()
    for r in rows[key]:
        state = dm.decode(r)
        assert np.array_equal(dm.encode(state), r)
        assert repr(state) == repr(ref.decode(r))


# -- The device functions -----------------------------------------------------


@pytest.mark.parametrize("key", [("single_copy", 2, 1), ("single_copy", 2, 2),
                                 ("abd", 2, 2), ("single_copy", 3, 1),
                                 ("single_copy", 4, 1), ("abd", 2, 3)],
                         ids=lambda k: f"{k[0]}-{k[1]}-{k[2]}")
def test_step_matches_jax(rows, key):
    """A ragged batch of 37 rows at a time, reachable, then near
    reachable ones, then adversarial: ``valid`` and every successor's
    lanes bit for bit (the invalid ones' too: the kernels store them)."""
    ref_model, sys_ = _pair(key)
    ref, dm = ref_model.device_model(), sys_.device_model()
    r_step = jax.jit(jax.vmap(ref.step))
    rng = np.random.default_rng(len(rows[key]))
    n_valid = 0
    for part_rows in (rows[key], _perturbed(rows[key], dm, 592, rng),
                      _adversarial(dm, 296, rng)):
        for i in range(0, len(part_rows), 37):
            part = part_rows[i:i + 37]
            succ, valid = dm.step(carry.rows_in(part))
            r_succ, r_valid = (np.asarray(a) for a in r_step(
                jnp.asarray(part)))
            assert np.array_equal(valid.numpy(), r_valid)
            assert np.array_equal(carry.rows_out(succ), r_succ)
            n_valid += int(r_valid.sum())
    assert n_valid > len(rows[key])


@pytest.mark.parametrize("key", [("single_copy", 2, 1), ("single_copy", 2, 2),
                                 ("abd", 2, 2)],
                         ids=lambda k: f"{k[0]}-{k[1]}-{k[2]}")
def test_properties_match_jax(rows, key):
    ref_model, sys_ = _pair(key)
    ref, dm = ref_model.device_model(), sys_.device_model()
    r_props = ref.device_properties()
    x = carry.rows_in(rows[key])
    assert sorted(dm.device_properties()) == sorted(r_props)
    for name, fn in dm.device_properties().items():
        want = np.asarray(jax.vmap(r_props[name])(jnp.asarray(rows[key])))
        assert np.array_equal(fn(x).numpy(), want), name
    lin = dm.device_properties()["linearizable"](x)
    assert bool(lin.all()) == (key != ("single_copy", 2, 2))
    assert dm.device_properties()["value chosen"](x).any()


@pytest.mark.parametrize("c", [3, 4])
def test_single_copy_representative_matches_jax(rows, c):
    """At one server every client shares residue class 0: the whole
    symmetric group, on reachable rows (all of them at 2 clients) and on
    adversarial ones (which reach the value map's clamp)."""
    key = ("single_copy", c, 1)
    ref_model, sys_ = _pair(key)
    ref, dm = ref_model.device_model(), sys_.device_model()
    assert len(dm.client_permutations()) == len(
        ref.client_permutations()) == np.prod(range(1, c + 1)) - 1
    x = np.concatenate([rows[key], _adversarial(dm, 200, np.random.default_rng(
        c))])
    rep = carry.rows_out(dm.representative(carry.rows_in(x)))
    want = np.asarray(jax.jit(jax.vmap(ref.representative))(jnp.asarray(x)))
    assert np.array_equal(rep, want)
    assert (rep != x).any()  # some rows are not their class's least


def test_representative_is_the_row_on_a_trivial_group(rows):
    """ABD's group is trivial on every configuration with a device form,
    and single-copy's at 2 clients on 2 servers (each client its own
    residue class)."""
    for key in (("abd", 2, 2), ("single_copy", 2, 2)):
        ref_model, sys_ = _pair(key)
        dm = sys_.device_model()
        assert dm.client_permutations() == [] == (
            ref_model.device_model().client_permutations())
        x = carry.rows_in(rows[key])
        assert dm.representative(x) is x


def test_compact_envs_matches_jax():
    """The first k envelopes that are not empty, in their order, on seeded
    rows of every fill, k from 1 to past the row's width."""
    rng = np.random.default_rng(11)
    n, m = 300, 5
    envs = rng.integers(0, 1 << 20, (n, m)).astype(np.uint32)
    envs[rng.random((n, m)) < 0.45] = EMPTY_ENV
    envs[:3] = EMPTY_ENV
    envs[3:6] = envs[3:6] | 1
    for k in (1, 2, 3, 5, 7):
        want = np.asarray(jax.vmap(lambda e: ref_actor_device.compact_envs(
            e, k))(jnp.asarray(envs)))
        got = carry.rows_out(compact_envs(carry.rows_in(envs), k))
        assert got.shape == (n, k)
        assert np.array_equal(got, want), k


@pytest.mark.parametrize("c, s", [(c, s) for s in (1, 2, 3, 4)
                                  for c in (1, 2, 3, 4) if c + s <= 8])
def test_abd_collision_guard_matches_jax(c, s):
    """ABD's device form exists exactly where JAX's does: where no two
    clients' ops give the same request id (op * actor)."""
    try:
        MODELS["abd"][0](c, s).device_model()
        ref_ok = True
    except RefUnavailable:
        ref_ok = False
    if ref_ok:
        AbdDevice(c, s)
    else:
        with pytest.raises(DeviceFormUnavailable, match="collide"):
            AbdDevice(c, s)
        # As JAX's spawn_tpu_bfs, the spawn falls back to the host BFS.
        with pytest.warns(RuntimeWarning, match="collide"):
            checker = (AbdSys(c, s).checker().target_state_count(50)
                       .spawn_cuda_bfs(device="cpu").join())
        assert type(checker).__name__ == "BfsChecker"
    assert ref_ok == (c <= s)


@pytest.mark.parametrize("dm", [SingleCopyDevice(4, 1), SingleCopyDevice(2, 2),
                                AbdDevice(2, 2), AbdDevice(2, 3, net_slots=5)],
                         ids=["single_copy-4-1", "single_copy-2-2", "abd-2-2",
                              "abd-2-3-5-slots"])
def test_cuda_model_names_each_model_with_its_sentinel_lanes(dm):
    """Each model's CUDA device code is named by ``cuda_model()`` with its
    client and server counts and its network size, and its network lanes
    are sentinel lanes holding ``EMPTY_ENV``."""
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    name, params, lanes = wave.cuda_model(dm, layout)
    assert (name, params) == (
        "single_copy" if isinstance(dm, SingleCopyDevice) else "abd",
        (dm.C, dm.S, dm.net_slots))
    table = lanes.view(np.uint32).reshape(5, dm.state_width)
    flags = np.zeros(dm.state_width, bool)
    flags[dm.net_offset:dm.net_offset + dm.net_slots] = True
    assert np.array_equal(table[3] != 0, flags)
    assert (table[4][flags] == EMPTY_ENV).all()


@pytest.mark.parametrize("dm", [SingleCopyDevice(3, 2), SingleCopyDevice(1, 1),
                                AbdDevice(3, 3), AbdDevice(1, 1)],
                         ids=["single_copy-3-2", "single_copy-1-1", "abd-3-3",
                              "abd-1-1"])
def test_cuda_model_holds_counts_the_fixed_instances_refused(dm):
    """Client and server counts the entry points once refused (they held
    four and two fixed pairs) now have an instance: each names its model
    with its counts and network size."""
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    name, params, lanes = wave.cuda_model(dm, layout)
    assert params == (dm.C, dm.S, dm.net_slots)
    assert lanes.shape == (5 * dm.state_width,)


def _held_pairs(text: str, fn: str):
    """The (clients, servers) pairs the dispatch ``fn`` of a model header
    holds: each ``case c:`` block's exact instances (``if (s == k)``) and
    its instance with the servers at run time (``<c, most, least>``),
    within the function's own guards."""
    body = text[text.index(f"long long {fn}("):]
    body = body[:body.index("\n}\n")]
    pairs = set()
    for c, block in re.findall(r"case (\d):\n(.*?)(?=\n    case |\n  \})",
                               body, re.S):
        for kc, ks, least in re.findall(
                r"<\w+<(\d), (\d)(?:, (\d))?(?:, true)?>>", block):
            assert kc == c
            pairs |= {(int(c), s)
                      for s in range(int(least or ks), int(ks) + 1)}
    return pairs


@pytest.mark.parametrize("name, fn, cls", [
    ("single_copy", "with_single_copy", SingleCopyDevice),
    ("abd", "with_abd", AbdDevice)])
def test_cuda_instances_match_the_entry_point(name, fn, cls):
    """``CUDA_INSTANCES`` lists exactly the (clients, servers) pairs that
    the dispatch of ``csrc/models/<name>.cuh`` (which ``csrc/wave_<name>.cu``
    and ``sender_<name>.cu`` call) holds: 22 for single-copy, 16 for ABD
    (no pair whose request ids collide)."""
    src = os.path.join(os.path.dirname(wave.__file__), "csrc", "models",
                       f"{name}.cuh")
    with open(src) as f:
        text = f.read()
    assert _held_pairs(text, fn) == set(cls.CUDA_INSTANCES)
    assert len(cls.CUDA_INSTANCES) == {"single_copy": 22, "abd": 16}[name]
    for c, s in cls.CUDA_INSTANCES:
        cls(c, s)  # every pair has a device form


class _OwnServer(SingleCopyDevice):
    """Changes the delivery, so single-copy's device code no longer
    computes its step."""

    def server_deliver(self, lanes, f):
        new_lanes, handled, outs = super().server_deliver(lanes, f)
        return new_lanes, handled & (f.kind != 1), outs


def test_wave_kernel_refuses_a_subclass_with_its_own_delivery():
    """On a CUDA device ``wave_kernel=True`` raises at spawn for a model
    whose delivery its device code does not compute (no card is needed
    to reach it); on the CPU it runs the plain version."""

    class Sys(SingleCopySys):
        def device_model(self):
            return _OwnServer(self.client_count, self.server_count)

    for spawn in (dict(device="cuda:0"), dict(mesh=["cuda:0"] * 2)):
        with pytest.raises(NotImplementedError,
                           match=r"_OwnServer has no CUDA.*server_deliver"):
            Sys(2).checker().spawn_cuda_bfs(wave_kernel=True, **spawn)
    c = Sys(2).checker().spawn_cuda_bfs(device="cpu", wave_kernel=True,
                                        batch_size=64).join()
    assert c.kernel_path() == "megakernel_plain"
    assert c.unique_state_count() < 93


# -- The whole slice ------------------------------------------------------------


def _ref_chains(c):
    dm = c._dm
    return {name: ([host_fp64(np.asarray(dm.encode(s), np.uint32))
                    for s in p.into_states()],
                   [repr(a) for a in p.into_actions()])
            for name, p in c.discoveries().items()}


def _chains(c):
    return {name: (p.fingerprints, [repr(a) for a in p.into_actions()])
            for name, p in c.discoveries().items()}


def _ref_mesh(n):
    return RefMesh(np.array(jax.devices()[:n]), ("shard",))


#: the engines both sides run: JAX's spawn knobs, the port's (the classic
#: engine without the successor ladder, whose rungs JAX compiles a program
#: each; ``test_torch_classic.py`` holds the ladder)
ENGINES = {"fused": (dict(), dict(device="cpu")),
           "classic": (dict(fused=False, pack_arena=True, succ_ladder=False),
                       dict(device="cpu", fused=False, succ_ladder=False)),
           "sharded": (dict(sharded=True), dict())}


def _spawn_pair(key, engine, sym=False, n=3, **kw):
    """``(JAX builder's spawn, the port builder's spawn)`` of ``key`` on
    ``engine`` with the same knobs."""
    ref_model, sys_ = _pair(key)
    rb, b = ref_model.checker(), sys_.checker()
    if sym:
        rb, b = rb.symmetry(), b.symmetry()
    ref_kw, kw_ = ENGINES[engine]
    ref_kw, kw_ = dict(ref_kw, **kw), dict(kw_, **kw)
    if engine == "sharded":
        ref_kw["mesh"], kw_["mesh"] = _ref_mesh(n), ["cpu"] * n
    return (lambda: rb.spawn_tpu_bfs(**ref_kw).join(),
            lambda **k: b.spawn_cuda_bfs(**kw_, **k).join())


_REF = {}


def _assert_engine_matches_jax(key, engine, sym, want, found, batch=64):
    """The port on ``engine``, on the torch stages and with
    ``wave_kernel=True``, against JAX's run of the same engine: counts,
    capacities and discovery chains (fingerprints and actions)."""
    ref_spawn, spawn = _spawn_pair(key, engine, sym, batch_size=batch)
    rkey = (key, engine, sym, batch)
    if rkey not in _REF:
        ref = ref_spawn()
        _REF[rkey] = ((ref.unique_state_count(), ref.state_count()),
                      ref._capacity, getattr(ref, "_ucap", None),
                      _ref_chains(ref))
    counts, cap, ucap, chains = _REF[rkey]
    if want is not None:
        assert counts == want
    paths = {"fused": ("dedup_plain", "megakernel_plain"),
             "classic": ("dedup_plain", "megakernel_plain"),
             "sharded": ("dedup_plain", "sender_plain")}[engine]
    for wave_kernel, path in zip((False, True), paths):
        ours = spawn(wave_kernel=wave_kernel)
        assert ours.kernel_path() == path
        assert (ours.unique_state_count(), ours.state_count()) == counts
        assert ours._capacity == cap
        if ucap is not None:
            assert ours._ucap == ucap
        assert _chains(ours) == chains
        assert sorted(chains) == found
        if "linearizable" not in found:
            ours.assert_properties()


@pytest.mark.parametrize("engine", ["fused", "classic", "sharded"])
@pytest.mark.parametrize("case", [
    (("single_copy", 2, 1), False, (93, 121), ["value chosen"]),
    (("single_copy", 2, 1), True, (47, 62), ["value chosen"]),
    (("single_copy", 2, 2), False, None, ["linearizable", "value chosen"]),
    (("abd", 2, 2), False, (544, 875), ["value chosen"])],
    ids=["single_copy-2-1", "single_copy-2-1-sym", "single_copy-2-2",
         "abd-2-2"])
def test_each_engine_matches_jax(case, engine):
    key, sym, want, found = case
    _assert_engine_matches_jax(key, engine, sym, want, found)


@pytest.mark.parametrize("engine", ["fused", "classic", "sharded"])
@pytest.mark.parametrize("key, sym", [(("single_copy", 2, 2), False),
                                      (("single_copy", 2, 1), True)],
                         ids=["single_copy-2-2", "single_copy-2-1-sym"])
def test_discovery_chains_do_not_depend_on_the_batch(key, sym, engine):
    """An engine's counts and discovery chains are the same at every batch
    size, and the classic engine's are the fused one's: the card's
    full-width runs are held to CPU runs at a smaller batch."""
    _, spawn = _spawn_pair(key, engine, sym)
    _, fused = _spawn_pair(key, "fused", sym)
    want = fused(batch_size=64)
    runs = [spawn(batch_size=b) for b in (16, 64, 1024)]
    for c in runs:
        assert (c.unique_state_count(), c.state_count()) == (
            want.unique_state_count(), want.state_count())
        assert _chains(c) == _chains(runs[0])
    if engine != "sharded":
        assert _chains(runs[0]) == _chains(want)


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["fused", "classic", "sharded"])
@pytest.mark.parametrize("sym", [False, True], ids=["plain", "sym"])
def test_single_copy_3_matches_jax(engine, sym):
    _assert_engine_matches_jax(("single_copy", 3, 1), engine, sym,
                               (712, 1144) if sym else (4243, 6778),
                               ["value chosen"], batch=512)


@pytest.mark.slow
@pytest.mark.parametrize("sym", [False, True], ids=["plain", "sym"])
def test_single_copy_4_matches_jax(sym):
    _assert_engine_matches_jax(("single_copy", 4, 1), "fused", sym,
                               (16726, 30657) if sym else (400233, 731789),
                               ["value chosen"], batch=4096)


# -- Checkpoints ----------------------------------------------------------------


def _sections(path):
    with np.load(path) as data:
        return {k: (data[k].dtype, data[k].shape, data[k].tobytes())
                for k in data.files}


#: the knobs both sides checkpoint with
KNOBS = dict(batch_size=16, waves_per_dispatch=2, inflight_dispatches=1,
             checkpoint_every_waves=1)


def test_single_copy_3_checkpoint_is_jax_byte_for_byte_and_resumes(tmp_path):
    """Single-copy 3/1 stopped at 800 states: every section of the last
    generation and of its ``.prev`` equal to JAX's, and each package
    resumes the other's file to the full run's counts and chains."""
    key = ("single_copy", 3, 1)
    ref_model, sys_ = _pair(key)
    mine, theirs = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    ref = ref_model.checker().target_state_count(800).spawn_tpu_bfs(
        pack_arena=True, checkpoint_path=theirs, **KNOBS).join()
    ours = sys_.checker().target_state_count(800).spawn_cuda_bfs(
        device="cpu", checkpoint_path=mine, **KNOBS).join()
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    assert ours.unique_state_count() < 4243 and ours.checkpoints >= 3
    for suffix in ("", ckpt.PREV_SUFFIX):
        want, got = _sections(theirs + suffix), _sections(mine + suffix)
        assert list(got) == list(want)
        for name in want:
            assert got[name] == want[name], (suffix, name)
    assert ckpt.verify_file(mine)["model"] == "ActorModel"
    knobs = dict(batch_size=256, inflight_dispatches=1)
    from_ours = ref_model.checker().spawn_tpu_bfs(
        pack_arena=True, resume_from=mine, **knobs).join()
    from_theirs = sys_.checker().spawn_cuda_bfs(
        device="cpu", resume_from=theirs, **knobs).join()
    for c in (from_ours, from_theirs):
        assert (c.unique_state_count(), c.state_count()) == (4243, 6778)
    assert _chains(from_theirs) == _ref_chains(from_ours)
    assert sorted(_chains(from_theirs)) == ["value chosen"]
