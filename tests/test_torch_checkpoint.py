"""Checkpoints and resume of the port against the JAX package's.

The port's ``checkpoint_format`` is held to ``stateright_tpu/
checkpoint_format.py`` (header bytes, refusals, CRCs, torn files,
rotation, pre-v3 files). Its engines on the CPU (the kernels' plain
versions) are held to JAX ``spawn_tpu_bfs(pack_arena=True)`` with the
same batch, waves a dispatch, in-flight depth and checkpoint knobs: every
section of the last generation and of its ``.prev`` equal byte for byte
(tolerance: exact), on the fused and the sharded engine; and each
package resumes the other's file, and each engine the other engine's, to
the full run's counts with JAX's discovery chains after JAX's own resume.
Then the refusals, ``restart_from`` after a failed dispatch, the
sections a resume cannot take, and the background writer.
"""

import json
import os
import sys
import threading

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
from stateright_tpu import checkpoint_format as ref_ckpt  # noqa: E402
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
from stateright_tpu_torch import checkpoint_format as ckpt  # noqa: E402
from stateright_tpu_torch import fused  # noqa: E402
from stateright_tpu_torch.fused import _u32  # noqa: E402
from stateright_tpu_torch.engine import host_table_insert  # noqa: E402
from stateright_tpu_torch.io import async_io  # noqa: E402
from stateright_tpu_torch.models import twopc  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosSys  # noqa: E402
from stateright_tpu_torch.sharded_fused import ShardedFusedCudaBfsChecker  # noqa: E402,E501
from stateright_tpu import Property as RefProperty  # noqa: E402
from stateright_tpu_torch import Property  # noqa: E402
from test_torch_fused import _Device, _RefDevice, _RefSys, _Sys  # noqa: E402,E501

torch.set_num_threads(2)


# 2pc with no re-delivery (``test_torch_fused``'s, where "all committed"
# fails on the all-aborted ends) and a second eventually property, "RM 0
# prepared", which many paths satisfy half-way and the paths where RM 0
# aborts first never do: the queue's rows then hold eventually bits that
# their paths cleared, which a resume must keep.


class _RefDeviceTwo(_RefDevice):
    def device_properties(self):
        props = super().device_properties()
        props["rm 0 prepared"] = lambda v: v[0] == 1
        return props


class _RefTwoEventually(_RefSys):
    def device_model(self):
        return _RefDeviceTwo(self.rm_count, ref_model)

    def properties(self):
        return super().properties() + [RefProperty.eventually(
            "rm 0 prepared",
            lambda _, s: s.rm_state[0] is ref_model.RmState.PREPARED)]


class _DeviceTwo(_Device):
    def device_properties(self):
        props = super().device_properties()
        props["rm 0 prepared"] = lambda r: r[:, 0] == 1
        return props


class _TwoEventually(_Sys):
    #: the JAX twin's name, which its checkpoints carry
    checkpoint_name = "_RefTwoEventually"

    def device_model(self):
        return _DeviceTwo(self.rm_count)

    def properties(self):
        return super().properties() + [Property.eventually("rm 0 prepared")]


SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
#: a model's JAX and port twins, the size and the target at which its
#: runs stop mid-way
MODELS = {
    "2pc 4": (lambda: ref_model.TwoPhaseSys(4),
              lambda: twopc.TwoPhaseSys(4), (1568, 8258), 1000),
    "2pc 5": (lambda: ref_model.TwoPhaseSys(5),
              lambda: twopc.TwoPhaseSys(5), (314, 2048), 1000),
    "paxos 1": (lambda: ref_paxos.PaxosModelCfg(1, 3).into_model(),
                lambda: PaxosSys(1), (265, 482), 300),
    "2pc 3 eventually": (lambda: _RefTwoEventually(3),
                         lambda: _TwoEventually(3), None, 150)}
#: the knobs both sides run with
KNOBS = dict(batch_size=16, waves_per_dispatch=2, inflight_dispatches=1)


def _ref(model, n=None, sym=False, target=None, **kw):
    b = MODELS[model][0]().checker()
    if sym:
        b = b.symmetry()
    if target:
        b = b.target_state_count(target)
    if n:
        kw.update(sharded=True, mesh=RefMesh(np.array(jax.devices()[:n]),
                                             ("shard",)))
    return b.spawn_tpu_bfs(**{**KNOBS, "pack_arena": True, **kw}).join()


def _port(model, n=None, sym=False, target=None, **kw):
    b = MODELS[model][1]().checker()
    if sym:
        b = b.symmetry()
    if target:
        b = b.target_state_count(target)
    where = dict(mesh=["cpu"] * n) if n else dict(device="cpu")
    return b.spawn_cuda_bfs(**where, **{**KNOBS, **kw}).join()


def _chains(c):
    return {name: p.fingerprints if hasattr(p, "fingerprints") else [
        host_fp64(np.asarray(c._dm.encode(s), np.uint32))
        for s in p.into_states()] for name, p in c.discoveries().items()}


def _sections(path):
    with np.load(path) as data:
        return {k: (data[k].dtype, data[k].shape, data[k].tobytes())
                for k in data.files}


# -- The format ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(model_name="TwoPhaseSys", state_width=7, state_count=436,
         unique_count=170, use_symmetry=False, discoveries={}),
    dict(model_name="ActorModel", state_width=37, state_count=303,
         unique_count=173, use_symmetry=True,
         discoveries={"value chosen": 2 ** 64 - 2, "linearizable": 17},
         row_format="packed", lane_bits=[2, (3, 2 ** 32 - 1), 32, [4, 15]],
         packed_width=2)], ids=["u32", "packed"])
def test_header_bytes_equal_jax(kw):
    assert ckpt.make_header(**kw).tobytes() == ref_ckpt.make_header(
        **kw).tobytes()
    assert ckpt.CKPT_VERSION == ref_ckpt.CKPT_VERSION == 5
    assert ckpt.PREV_SUFFIX == ref_ckpt.PREV_SUFFIX


def _payload(version=5, **header):
    h = dict(version=version, model="TwoPhaseSys", state_width=7,
             state_count=1, unique_count=1, use_symmetry=False,
             discoveries={}, row_format="u32")
    h.update(header)
    return dict(header=np.frombuffer(json.dumps(h).encode(), np.uint8),
                visited=np.arange(1, 5, dtype=np.uint64),
                pending_vecs=np.zeros((0, 7), np.uint32),
                pending_fps=np.zeros(0, np.uint64),
                pending_ebits=np.zeros(0, np.uint32),
                parent_child=np.arange(1, 5, dtype=np.uint64),
                parent_parent=np.zeros(4, np.uint64),
                parent_rooted=np.ones(4, bool))


@pytest.mark.parametrize("change, match", [
    (dict(model_name="ActorModel"), "from model 'TwoPhaseSys'"),
    (dict(state_width=8), "state_width 7"),
    (dict(use_symmetry=True), "symmetry"),
    (dict(version=6), "newer than this build")],
    ids=["model", "width", "symmetry", "version"])
def test_validate_header_refuses_what_jax_refuses(tmp_path, change, match):
    path = str(tmp_path / "c.npz")
    ckpt.write_atomic(path, _payload(version=change.pop("version", 5)))
    want = dict(model_name="TwoPhaseSys", state_width=7, use_symmetry=False)
    want.update(change)
    for mod in (ckpt, ref_ckpt):
        with mod.load_checkpoint(path) as data:
            with pytest.raises(ValueError, match=match):
                mod.validate_header(data, **want)


@pytest.mark.parametrize("damage", ["crc", "torn"])
def test_a_damaged_file_is_refused(tmp_path, damage):
    path = str(tmp_path / "c.npz")
    payload = _payload()
    if damage == "crc":  # a section changed after its CRC was taken
        payload["crcs"] = ckpt._crcs_of(payload)
        payload["visited"] = payload["visited"] ^ np.uint64(1)
        np.savez_compressed(path, **payload)
        match = "section 'visited' failed its CRC32 check"
    else:  # a truncated write
        ckpt.write_atomic(path, payload)
        blob = open(path, "rb").read()
        open(path, "wb").write(blob[:len(blob) // 3])
        match = "unreadable"
    for mod in (ckpt, ref_ckpt):
        with pytest.raises(ValueError, match=match):
            mod.verify_file(path)
    with pytest.raises(ValueError, match=match):
        twopc.TwoPhaseSys(5).checker().spawn_cuda_bfs(device="cpu",
                                                      resume_from=path)


def test_keep_last_two_generations(tmp_path):
    path = str(tmp_path / "c.npz")
    for gen in (1, 2, 3):
        ckpt.write_atomic(path, _payload(state_count=gen))
    gens = [ckpt.verify_file(p)["state_count"]
            for p in (path, path + ckpt.PREV_SUFFIX)]
    assert gens == [3, 2]
    # A torn current file never rotates over the good previous one.
    open(path, "wb").write(b"PK\x03\x04torn")
    ckpt.write_atomic(path, _payload(state_count=4))
    gens = [ckpt.verify_file(p)["state_count"]
            for p in (path, path + ckpt.PREV_SUFFIX)]
    assert gens == [4, 2]
    assert sorted(os.listdir(tmp_path)) == ["c.npz", "c.npz.prev"]


def test_a_pre_v3_file_with_no_crcs_resumes(tmp_path):
    """A v2 file (no CRC table) from a port run resumes to the counts."""
    path = str(tmp_path / "c.npz")
    _port("2pc 4", target=1000, checkpoint_path=path)
    with np.load(path) as data:
        old = {k: data[k] for k in data.files if k != "crcs"}
    h = json.loads(old["header"].tobytes())
    h["version"] = 2
    old["header"] = np.frombuffer(json.dumps(h).encode(), np.uint8)
    np.savez_compressed(path, **old)
    c = twopc.TwoPhaseSys(4).checker().spawn_cuda_bfs(
        device="cpu", resume_from=path, **KNOBS).join()
    assert (c.unique_state_count(), c.state_count()) == MODELS["2pc 4"][2]


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "u32"])
def test_pending_rows_unpack_as_jax(tmp_path, packed):
    path = str(tmp_path / "j.npz")
    _ref("paxos 1", target=300, pack_arena=packed, checkpoint_path=path)
    with np.load(path) as data:
        header = json.loads(data["header"].tobytes())
        assert header["row_format"] == ("packed" if packed else "u32")
        got = ckpt.pending_rows(data, header, 37)
        want = ref_ckpt.pending_rows(data, header, 37)
    assert got.dtype == np.uint32 and len(got) and np.array_equal(got, want)


# -- Sections byte-equal to JAX's ---------------------------------------------


_REF_FILES = {}


def _ref_file(tmp_path_factory, model, n, sym):
    """JAX's run stopped at the model's target with a checkpoint every
    dispatch (batch 16): the path of its last generation, made once."""
    key = (model, n, sym)
    if key not in _REF_FILES:
        path = str(tmp_path_factory.mktemp("ref") / "j.npz")
        c = _ref(model, n, sym, MODELS[model][3], checkpoint_path=path,
                 checkpoint_every_waves=1)
        _REF_FILES[key] = (path, c.unique_state_count(), c.state_count())
    return _REF_FILES[key]


@pytest.mark.parametrize("model, n, sym, wave_kernel", [
    ("2pc 4", None, False, False), ("2pc 4", None, False, True),
    ("2pc 5", None, True, False), ("paxos 1", None, False, True),
    ("2pc 4", 3, False, False), ("2pc 4", 3, False, True)],
    ids=["2pc4", "2pc4-wave-kernel", "2pc5-symmetry", "paxos1-wave-kernel",
         "2pc4-sharded3", "2pc4-sharded3-sender"])
def test_sections_equal_jax_byte_for_byte(tmp_path, tmp_path_factory, model,
                                          n, sym, wave_kernel):
    ref_path, unique, states = _ref_file(tmp_path_factory, model, n, sym)
    path = str(tmp_path / "p.npz")
    c = _port(model, n, sym, MODELS[model][3], checkpoint_path=path,
              checkpoint_every_waves=1, wave_kernel=wave_kernel)
    assert (c.unique_state_count(), c.state_count()) == (unique, states)
    assert c.checkpoints >= 3  # periodic generations before the end's
    for suffix in ("", ckpt.PREV_SUFFIX):
        want, got = _sections(ref_path + suffix), _sections(path + suffix)
        assert list(got) == list(want)
        for name in want:
            assert got[name] == want[name], (suffix, name)
    header = ckpt.verify_file(path)
    assert header["model"] == ("ActorModel" if model == "paxos 1"
                               else "TwoPhaseSys")
    assert header["row_format"] == "packed"


# -- Resume in every direction ------------------------------------------------


_FULL = {}


def _full(model, n):
    """JAX's full run's counts and chains (the fused engine, or the
    sharded one at ``n``)."""
    if (model, n) not in _FULL:
        ref = _ref(model, n)
        _FULL[model, n] = (ref.unique_state_count(), ref.state_count(),
                           _chains(ref))
    return _FULL[model, n]


@pytest.mark.parametrize("writer, reader", [
    ("port", "port"), ("jax", "port"), ("port", "jax"),
    ("port", "port sharded"), ("port sharded", "port"),
    ("jax u32", "port"), ("jax sharded", "port sharded"),
    ("port sharded", "jax sharded")])
def test_resume_in_every_direction(tmp_path, writer, reader):
    """A mid-run file resumes to the full run's counts, with the chains
    JAX's own engine of the reader's kind gives after resuming it."""
    model, n = "2pc 4", 3
    path = str(tmp_path / "c.npz")
    writers = {"port": lambda: _port(model, target=1000,
                                     checkpoint_path=path),
               "port sharded": lambda: _port(model, n, target=1000,
                                             checkpoint_path=path),
               "jax": lambda: _ref(model, target=1000,
                                   checkpoint_path=path),
               "jax u32": lambda: _ref(model, target=1000, pack_arena=False,
                                       checkpoint_path=path),
               "jax sharded": lambda: _ref(model, n, target=1000,
                                           checkpoint_path=path)}
    partial = writers[writer]()
    assert partial.unique_state_count() < MODELS[model][2][0]
    rn = n if "sharded" in reader else None
    ref = _ref(model, rn, resume_from=path)
    ours = (ref if reader.startswith("jax")
            else _port(model, rn, resume_from=path))
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count()) == MODELS[model][2]
    assert _chains(ours) == _chains(ref)
    full = _full(model, rn)
    assert sorted(_chains(ours)) == sorted(full[2])


@pytest.mark.parametrize("n", [None, 3], ids=["fused", "sharded3"])
def test_resumed_table_is_the_visited_set_at_jax_capacity(tmp_path, n):
    """Resumed with a target already met, so no wave runs: the table
    holds the file's visited set, as ``host_table_insert`` would, at
    JAX's capacity and occupancy."""
    path = str(tmp_path / "c.npz")
    _port("2pc 5", target=3000, checkpoint_path=path)
    kw = dict(target=1, resume_from=path, table_capacity=1 << 12)
    ref, ours = _ref("2pc 5", n, **kw), _port("2pc 5", n, **kw)
    assert ours.dispatches == 0 and ours._capacity == ref._capacity
    with np.load(path) as data:
        visited = data["visited"]
    tables = (ours._table.reshape(-1, ours._capacity).numpy()
              .view(np.uint64))
    if n is None:
        assert ours._occ == ref._resident == len(visited)
        want = np.full(ours._capacity, SENT, np.uint64)
        host_table_insert(want, visited)
        wants = [want]
    else:
        assert list(ours._occs) == list(ref._seed_occ)
        wants = []
        for i in range(n):
            want = np.full(ours._capacity, SENT, np.uint64)
            host_table_insert(want, visited[visited % np.uint64(n) == i])
            wants.append(want)
    for got, want in zip(tables, wants):
        assert np.array_equal(np.sort(got), np.sort(want))


@pytest.mark.parametrize("n", [None, 3], ids=["fused", "sharded3"])
def test_pending_eventually_bits_survive_a_resume(tmp_path, n):
    """The queue's rows go into the file with the eventually bits their
    paths cleared, and come back with them: after the resume every arena
    row's bits equal JAX's, and both eventually counterexamples are found
    with JAX's chains."""
    path = str(tmp_path / "c.npz")
    partial = _port("2pc 3 eventually", n, target=150, checkpoint_path=path)
    assert not {"all committed", "rm 0 prepared"} & set(partial.discoveries())
    with np.load(path) as data:
        assert (data["pending_ebits"] != partial._ebits_all).any()
    ref = _ref("2pc 3 eventually", n, resume_from=path)
    ours = _port("2pc 3 eventually", n, resume_from=path)
    for name in ("all committed", "rm 0 prepared"):
        assert ours.discovery_classification(name) == "counterexample"
    assert _chains(ours) == _chains(ref)
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    eb = np.asarray(ref._arena[3])
    if n is None:
        tail = ours._tail
        assert np.array_equal(_u32(ours._ebits[:tail]), eb[:tail])
    else:
        eb = eb.reshape(n, -1)
        for i, tail in enumerate(ours._tails):
            assert np.array_equal(_u32(ours._ebits[i, :tail]), eb[i, :tail])


# -- Refusals and restart -----------------------------------------------------


def test_checkpoint_while_running_raises(tmp_path, monkeypatch):
    gate = threading.Event()
    run = fused.FusedCudaBfsChecker._run_waves

    def held(self):
        gate.wait(30)
        run(self)

    monkeypatch.setattr(fused.FusedCudaBfsChecker, "_run_waves", held)
    c = twopc.TwoPhaseSys(3).checker().spawn_cuda_bfs(device="cpu")
    with pytest.raises(RuntimeError, match="while the checker is running"):
        c.checkpoint(str(tmp_path / "racy.npz"))
    with pytest.raises(RuntimeError, match="while the checker is running"):
        c.restart_from(str(tmp_path / "racy.npz"))
    gate.set()
    c.join()
    c.checkpoint(str(tmp_path / "done.npz"))
    assert ckpt.verify_file(str(tmp_path / "done.npz"))["unique_count"] == 288


@pytest.mark.parametrize("n", [None, 3], ids=["fused", "sharded3"])
def test_restart_from_the_periodic_file_after_a_failed_dispatch(
        tmp_path, monkeypatch, n):
    path = str(tmp_path / "c.npz")
    process = (ShardedFusedCudaBfsChecker if n
               else fused.FusedCudaBfsChecker)._process
    calls = []

    def failing(self, st):
        calls.append(1)
        if len(calls) == 4:
            raise RuntimeError("injected dispatch failure")
        process(self, st)

    monkeypatch.setattr(ShardedFusedCudaBfsChecker if n
                        else fused.FusedCudaBfsChecker, "_process", failing)
    b = twopc.TwoPhaseSys(4).checker()
    where = dict(mesh=["cpu"] * n) if n else dict(device="cpu")
    c = b.spawn_cuda_bfs(**where, checkpoint_path=path,
                         checkpoint_every_waves=1, **KNOBS)
    with pytest.raises(RuntimeError, match="injected"):
        c.join()
    with pytest.raises(RuntimeError, match="after a failed run"):
        c.checkpoint(str(tmp_path / "torn.npz"))
    assert ckpt.verify_file(path)["unique_count"] < 1568
    c.restart_from(path).join()
    full = _full("2pc 4", n)
    assert (c.unique_state_count(), c.state_count()) == full[:2]
    assert _chains(c) == full[2]
    c.checkpoint(str(tmp_path / "after.npz"))  # the flag is clear again


@pytest.mark.parametrize("section", [
    ("store", {"segment_dir": "s", "cold": [{"partition": 0, "file": "f",
                                              "sha": "0", "rows": 1}]}),
    ("shard", {"index": 0, "of": 2, "round": 1, "epoch": 0}),
    ("elastic", {"round": 1, "epoch": 0, "partitions": 2, "workers": 2})],
    ids=["store", "shard", "elastic"])
def test_sections_of_unported_modules_raise(tmp_path, section):
    path = str(tmp_path / "c.npz")
    _port("2pc 4", target=1000, checkpoint_path=path)
    with np.load(path) as data:
        payload = {k: data[k] for k in data.files if k != "crcs"}
    h = json.loads(payload["header"].tobytes())
    h[section[0]] = section[1]
    payload["header"] = np.frombuffer(json.dumps(h).encode(), np.uint8)
    ckpt.write_atomic(path, payload)
    for where in (dict(device="cpu"), dict(mesh=["cpu"] * 2)):
        with pytest.raises(NotImplementedError, match=section[0]):
            twopc.TwoPhaseSys(4).checker().spawn_cuda_bfs(resume_from=path,
                                                          **where)


def test_async_writes_are_the_sync_bytes_and_raise_at_join(tmp_path,
                                                           monkeypatch):
    paths = [str(tmp_path / f"{k}.npz") for k in ("sync", "async")]
    for path, knob in zip(paths, (False, True)):
        c = _port("2pc 4", target=1000, checkpoint_path=path,
                  checkpoint_every_waves=1, async_io=knob)
        assert c._aio.enabled is knob and c.checkpoints >= 3
    for suffix in ("", ckpt.PREV_SUFFIX):
        assert _sections(paths[0] + suffix) == _sections(paths[1] + suffix)
    monkeypatch.setenv(async_io.ASYNC_IO_ENV, "1")
    assert async_io.writer_from_config(None).enabled

    def failing(path, payload):
        raise OSError("injected: no space left on device")

    monkeypatch.setattr(fused, "write_atomic", failing)
    c = twopc.TwoPhaseSys(3).checker().spawn_cuda_bfs(
        device="cpu", checkpoint_path=str(tmp_path / "x.npz"))
    assert c._aio.enabled
    with pytest.raises(OSError, match="injected"):
        c.join()
