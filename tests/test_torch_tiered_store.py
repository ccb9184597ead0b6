"""The port's tiered store (``stateright_tpu_torch/store/tiered.py``) and
its hooks in the four engines, held to the JAX package's
(``stateright_tpu/store/tiered.py``, ``tests/test_tiered_store.py``).

- **Store units**: the factory and ``_parse_bytes``; whole-partition
  round-robin ``spill_mask`` (the same masks as JAX's store); a cold
  segment is a checkpoint shard, which each package's ``verify_file`` and
  ``map_segment_visited`` read, header bytes equal to JAX's; a segment
  that lands torn (the port's writer patched to truncate it) falls back
  to its predecessor with no fingerprint lost; refs keep their inherited
  directories; ``attach_refs`` falls back to the ``.prev`` generation.
- **Engine parity** on 2pc 4 at JAX's ``TIER_CFGS`` on the CPU: each
  engine's capped run gives JAX's capped run's and JAX's clean run's
  totals and discoveries, with spills (host and disk on the classic
  engine, arena spans on the fused one), and ``store_stats()`` equal to
  JAX's (the segment directory aside).
- **Resume across the packages**: the port resumes JAX's spilled
  checkpoint with a store and without one, JAX resumes the port's, and
  the final logical visited set (hot and cold) is the clean run's.
- **The fused roll** under symmetry: the checkpoint after a capped run
  is byte-equal to JAX's capped run's, section by section.

Tolerance: exact everywhere. The large arms (the sharded classic parity,
the sharded fused span drill on 2pc 6, paxos 16,668, a resume in a fresh
process) are ``-m slow``, as JAX's are.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import stateright_tpu.tpu  # noqa: F401,E402  (enables x64)
import two_phase_commit as ref_model  # noqa: E402
from stateright_tpu import checkpoint_format as ref_ckpt  # noqa: E402
from stateright_tpu.store import tiered as ref_tiered  # noqa: E402
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
from stateright_tpu_torch import checkpoint_format as ckpt  # noqa: E402
from stateright_tpu_torch.models import twopc  # noqa: E402
from stateright_tpu_torch.store import tiered  # noqa: E402
from stateright_tpu_torch.store.tiered import (  # noqa: E402
    NULL_STORE, TieredStore, _parse_bytes, load_cold_refs,
    map_segment_visited, store_from_config)

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: JAX's ``tests/test_tiered_store.py`` knob sets on 2pc 4 (1,568 unique /
#: 8,258 states); ``sharded`` means JAX's 8-device mesh and the port's
#: 8 stacked CPU shards
TIER_CFGS = {
    "classic": dict(fused=False, batch_size=32, table_capacity=4096,
                    tier_device_bytes=4096 * 8, tier_host_bytes=4096),
    "fused": dict(batch_size=32, table_capacity=4096,
                  arena_capacity=1024, tier_device_bytes=100_000,
                  tier_host_bytes=1 << 20),
    "sharded-classic": dict(sharded=True, fused=False, batch_size=32,
                            table_capacity=2048,
                            tier_device_bytes=2048 * 8 * 8,
                            tier_host_bytes=4096),
    "sharded-fused": dict(sharded=True, batch_size=32,
                          table_capacity=2048, arena_capacity=256,
                          tier_device_bytes=300_000,
                          tier_host_bytes=1 << 20),
}
#: both packages' host loops at one dispatch in flight
_REF_KNOBS = dict(pack_arena=True, inflight_dispatches=1)


def _base(engine):
    return {k: v for k, v in TIER_CFGS[engine].items()
            if not k.startswith("tier_") and k != "arena_capacity"}


def _totals(c):
    return (c.state_count(), c.unique_state_count(),
            tuple(sorted(c.discoveries())))


def _ref(rms, cfg, builder=None, **kw):
    """JAX's run of 2pc at ``rms`` RMs with the knobs ``cfg``."""
    cfg = dict(cfg, **kw)
    if not cfg.get("fused", True):
        cfg.pop("inflight_dispatches", None)
    b = builder or ref_model.TwoPhaseSys(rms).checker()
    return b.spawn_tpu_bfs(**{**_REF_KNOBS, **cfg}).join()


def _port(rms, cfg, builder=None, **kw):
    """The port's run with the same knobs, on the CPU."""
    cfg = dict(cfg, **kw)
    if cfg.pop("sharded", False):
        cfg["mesh"] = ["cpu"] * 8
    else:
        cfg["device"] = "cpu"
    if cfg.get("fused", True):
        cfg.setdefault("inflight_dispatches", 1)
    b = builder or twopc.TwoPhaseSys(rms).checker()
    return b.spawn_cuda_bfs(**cfg).join()


_CLEAN = {}


def _clean(engine):
    """JAX's uncapped run's totals at ``engine``'s knobs, made once."""
    if engine not in _CLEAN:
        _CLEAN[engine] = _totals(_ref(4, _base(engine)))
    return _CLEAN[engine]


def _chains(c):
    """Each discovery's path as the fingerprints of its states."""
    return {name: [host_fp64(np.asarray(c._dm.encode(s), np.uint32))
                   for s in p.into_states()]
            for name, p in c.discoveries().items()}


def _comparable(stats):
    """``store_stats()`` without the segment directory, which differs."""
    return {k: v for k, v in stats.items() if k != "segment_dir"}


# -- Store units ----------------------------------------------------------


def test_parse_bytes_and_factory(tmp_path, monkeypatch):
    for text in ("4096", "64k", "1.5MiB", "2g", None, "0", "12 m"):
        assert _parse_bytes(text) == ref_tiered._parse_bytes(text)
    assert _parse_bytes("1.5MiB") == (3 << 20) // 2
    for var in (tiered.TIER_DEVICE_ENV, tiered.TIER_HOST_ENV,
                tiered.TIER_DIR_ENV):
        monkeypatch.delenv(var, raising=False)
    assert store_from_config() is NULL_STORE
    assert not NULL_STORE.active and NULL_STORE.stats() == {"enabled": False}
    monkeypatch.setenv("STpu_TIER_HOST_BYTES", "64k")
    s = store_from_config(segment_dir=str(tmp_path))
    assert s.active and s.host_budget == 64 * 1024
    assert s.segment_dir == str(tmp_path) and s.device_budget is None
    # An explicit keyword wins over its variable.
    assert store_from_config(host_bytes=100).host_budget == 100
    assert s.stats().keys() == ref_tiered.TieredStore(
        n_partitions=16).stats().keys()


def test_spill_mask_takes_whole_partitions_round_robin():
    fps = np.random.default_rng(5).integers(
        0, 2 ** 63, 200, dtype=np.int64).astype(np.uint64)
    mine, ref = TieredStore(n_partitions=4), ref_tiered.TieredStore(
        n_partitions=4)
    for limit in (150, 120, 0, 190):
        got = mine.spill_mask(fps, lambda keep: len(keep) <= limit)
        want = ref.spill_mask(fps, lambda keep: len(keep) <= limit)
        assert np.array_equal(got, want)
        assert len(set((fps[got] % np.uint64(4)).tolist())) <= 4
    s = TieredStore(n_partitions=4)
    mask = s.spill_mask(np.arange(64, dtype=np.uint64),
                        lambda keep: len(keep) <= 48)
    assert mask.sum() == 16  # exactly one whole fp % 4 partition
    assert TieredStore(n_partitions=4).spill_mask(
        np.arange(64, dtype=np.uint64), lambda keep: False).all()


_META = {"model_name": "M", "state_width": 3, "use_symmetry": False}


def test_cold_segment_is_a_checkpoint_shard_of_either_package(tmp_path):
    fps = np.arange(0, 100, 2, dtype=np.uint64)  # one partition of two
    segs = {}
    for name, cls in (("port", TieredStore), ("jax", ref_tiered.TieredStore)):
        s = cls(host_budget=64, segment_dir=str(tmp_path / name),
                n_partitions=2, meta=_META)
        s.spill_visited(fps)
        st = s.stats()
        assert st["disk"]["rows"] == 50 and st["disk"]["segments"] == 1
        (part,) = s._cold.values()
        segs[name] = part
        assert s.probe(fps).all()
        assert not s.probe(np.arange(1, 99, 2, dtype=np.uint64)).any()
    assert segs["port"].sha == segs["jax"].sha == ckpt.content_hash(fps)
    assert ckpt.content_hash(fps) == ref_ckpt.content_hash(fps)
    for part in segs.values():
        for verify, mmap in ((ckpt.verify_file, map_segment_visited),
                             (ref_ckpt.verify_file,
                              ref_tiered.map_segment_visited)):
            header = verify(part.path)
            assert header["version"] == 5
            assert header["store_segment"] == {"partition": 0, "rows": 50,
                                               "sha": part.sha}
            got = mmap(part.path)
            assert isinstance(got, np.memmap)
            assert np.array_equal(got, fps)
    with np.load(segs["port"].path) as a, np.load(segs["jax"].path) as b:
        assert a.files == b.files
        for key in a.files:
            assert a[key].tobytes() == b[key].tobytes(), key


@pytest.mark.parametrize("rows", [0, 1, 7, 4099])
def test_uncompressed_members_are_aligned_savez_members(tmp_path, rows):
    """An uncompressed file (a cold segment) holds ``np.savez``'s members
    byte for byte, each member's data 64-byte aligned in the file, so the
    ``visited`` section memory-maps as an aligned array (an unaligned map
    makes numpy copy the partition on every search); both packages'
    ``verify_file`` and ``map_segment_visited`` read it."""
    fps = np.sort(np.random.default_rng(rows).integers(
        0, 2 ** 63, rows, dtype=np.int64).astype(np.uint64))
    header = ckpt.make_header(
        model_name="M", state_width=3, state_count=rows, unique_count=rows,
        use_symmetry=False, discoveries={},
        store_segment={"partition": 0, "rows": rows,
                       "sha": ckpt.content_hash(fps)})
    payload = {"header": header, "visited": fps,
               "odd": np.arange(5, dtype=np.int32).reshape(5, 1)}
    path, plain = str(tmp_path / "seg.npz"), str(tmp_path / "plain.npz")
    ckpt.write_atomic(path, payload, compress=False)
    np.savez(plain, **payload, crcs=ckpt._crcs_of(payload))
    import zipfile
    with zipfile.ZipFile(path) as a, zipfile.ZipFile(plain) as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
            info = a.getinfo(name)
            with open(path, "rb") as f:
                f.seek(info.header_offset)
                local = f.read(30)
            start = (info.header_offset + 30
                     + int.from_bytes(local[26:28], "little")
                     + int.from_bytes(local[28:30], "little"))
            head = a.read(name)
            npy = len(head) - int(np.load(path)[name[:-4]].nbytes)
            assert (start + npy) % 64 == 0, name
    for verify, mmap in ((ckpt.verify_file, map_segment_visited),
                         (ref_ckpt.verify_file,
                          ref_tiered.map_segment_visited)):
        assert verify(path)["store_segment"]["rows"] == rows
        got = mmap(path)
        assert isinstance(got, np.memmap) and np.array_equal(got, fps)
    if rows:
        assert map_segment_visited(path).flags.aligned


def test_torn_cold_segment_falls_back_no_loss(tmp_path, monkeypatch):
    """A segment that lands torn (the writer patched to truncate its
    second landing) fails the store's re-read; the predecessor comes back
    and the pushed rows stay warm, then the next landing holds all."""
    s = TieredStore(host_budget=64, segment_dir=str(tmp_path),
                    n_partitions=2)
    s.spill_visited(np.arange(0, 100, 2, dtype=np.uint64))
    assert s.stats()["disk"]["rows"] == 50
    landed = []
    real = tiered.write_atomic

    def torn(path, payload, compress=True):
        real(path, payload, compress=compress)
        if not landed:
            with open(path, "rb") as f:
                blob = f.read()
            with open(path, "wb") as f:
                f.write(blob[:max(8, len(blob) // 3)])
        landed.append(path)

    monkeypatch.setattr(tiered, "write_atomic", torn)
    s.spill_visited(np.arange(100, 200, 2, dtype=np.uint64))
    assert len(landed) == 2
    assert s.probe(np.arange(0, 200, 2, dtype=np.uint64)).all()
    assert s.stats()["disk"]["rows"] == 100


def test_the_probe_filter_is_exact_and_inside_the_host_budget(
        tmp_path, monkeypatch):
    """The probe's filter (made past ``_FILTER_KEYS`` spilled keys, here
    64) changes no answer: each probe equals JAX's store's, which has no
    filter. It grows to its cap, half the host budget, and its bytes
    count in the host tier, which stays inside the budget; a reset drops
    it."""
    monkeypatch.setattr(tiered, "_FILTER_KEYS", 64)
    rng = np.random.default_rng(3)
    budget = 1 << 20
    mine = TieredStore(host_budget=budget, segment_dir=str(tmp_path / "p"),
                       n_partitions=4)
    ref = ref_tiered.TieredStore(host_budget=budget,
                                 segment_dir=str(tmp_path / "j"),
                                 n_partitions=4)
    spilled = []
    for _ in range(8):
        fps = rng.integers(0, 2 ** 63, 12_000, dtype=np.int64).astype(
            np.uint64)
        mine.spill_visited(fps)
        ref.spill_visited(fps)
        spilled.append(fps)
        probe = np.concatenate([np.concatenate(spilled)[::5], rng.integers(
            0, 2 ** 63, 5_000, dtype=np.int64).astype(np.uint64)])
        assert np.array_equal(mine.probe(probe), ref.probe(probe))
        st = mine.stats()
        assert 0 < mine._filter.nbytes <= budget // 2
        assert st["host"]["bytes"] == (8 * st["host"]["rows"]
                                       + mine._filter.nbytes) <= budget
    assert mine._filter.nbytes == budget // 2
    assert mine.stats()["disk"]["segments"] > 0
    assert mine.stats()["probe_hits"] == ref.stats()["probe_hits"]
    mine.reset()
    assert mine._filter.nbytes == 0 and mine.stats()["host"]["bytes"] == 0


def test_checkpoint_refs_keep_inherited_segment_dirs(tmp_path):
    dir_a, dir_b = tmp_path / "a", tmp_path / "b"
    dir_b.mkdir()
    s1 = TieredStore(host_budget=64, segment_dir=str(dir_a), n_partitions=2)
    fps = np.arange(0, 100, 2, dtype=np.uint64)
    s1.spill_visited(fps)
    refs1 = s1.checkpoint_refs()
    s2 = TieredStore(segment_dir=str(dir_b), n_partitions=2)
    assert s2.attach_refs(refs1) == 50
    refs2 = s2.checkpoint_refs()
    assert refs2["segment_dir"] == str(dir_b)
    assert all(r["dir"] == str(dir_a) for r in refs2["cold"])
    s3 = TieredStore(segment_dir=str(dir_b), n_partitions=2)
    assert s3.attach_refs(refs2) == 50 and s3.probe(fps).all()
    # JAX's store takes the port's refs, and the port's JAX's.
    assert ref_tiered.TieredStore(n_partitions=2).attach_refs(refs2) == 50
    s4 = ref_tiered.TieredStore(host_budget=64, segment_dir=str(tmp_path / "j"),
                                n_partitions=2)
    s4.spill_visited(fps)
    assert TieredStore(n_partitions=2).attach_refs(s4.checkpoint_refs()) == 50


def test_attach_refs_falls_back_to_rotation_predecessor(tmp_path):
    import shutil

    s = TieredStore(host_budget=64, segment_dir=str(tmp_path), n_partitions=2)
    s.spill_visited(np.arange(0, 100, 2, dtype=np.uint64))
    refs = s.checkpoint_refs()
    (part,) = s._cold.values()
    shutil.copy(part.path, part.path + ckpt.PREV_SUFFIX)
    with open(part.path, "r+b") as f:
        f.truncate(64)
    fresh = TieredStore(segment_dir=str(tmp_path), n_partitions=2)
    assert fresh.attach_refs(refs) == 50
    assert fresh.probe(np.arange(0, 100, 2, dtype=np.uint64)).all()
    assert len(load_cold_refs(refs)) == 50
    bad = {"segment_dir": str(tmp_path),
           "cold": [{"partition": 0, "file": "missing.npz", "sha": "0" * 16,
                     "rows": 1}]}
    with pytest.raises(ValueError, match="missing or corrupt"):
        fresh.attach_refs(bad)


def test_partition_surface_equals_jax(tmp_path):
    """The partition-by-partition surface (JAX's elastic workers' use it;
    no engine of the port does yet) answers as JAX's store does: single
    partitions spilled warm, then cold under the host budget, probed one
    partition at a time, read back whole, and one of them dropped; the
    counters equal too."""
    rng = np.random.default_rng(7)
    blocks = [(p % 4, rng.integers(0, 2 ** 60, 40, dtype=np.int64).astype(
        np.uint64) * np.uint64(4) + np.uint64(p % 4)) for p in range(7)]
    vals = np.concatenate([b for _, b in blocks[::2]] + [rng.integers(
        0, 2 ** 62, 50, dtype=np.int64).astype(np.uint64)])
    seen = {}
    for name, cls in (("port", TieredStore), ("jax", ref_tiered.TieredStore)):
        s = cls(host_budget=1024, segment_dir=str(tmp_path / name),
                n_partitions=4, meta=_META)
        got = []
        for p, fps in blocks:
            s.spill_partition_rows(p, fps)
            got += [s.probe_partition(q, vals) for q in range(4)]
        got += [s.partition_fps(q) for q in range(4)]
        s.drop_partition(1)
        got += [s.partition_fps(q) for q in range(4)] + [s.probe(vals)]
        seen[name] = got, _comparable(s.stats())
    (port, port_stats), (jax, jax_stats) = seen["port"], seen["jax"]
    assert len(port) == len(jax)
    for a, b in zip(port, jax):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert port_stats == jax_stats
    assert port_stats["disk"]["segments"] > 0
    assert port[-1].any() and port[-2].size


# -- Engine parity under memory pressure ---------------------------------


@pytest.mark.parametrize("engine", ["classic", "fused", "sharded-fused"])
def test_capped_runs_equal_jax(tmp_path, engine):
    """The capped run equals JAX's capped run and JAX's clean run, the
    spills fire where JAX's do, and the store's counters are JAX's."""
    port = _port(4, TIER_CFGS[engine], tier_dir=str(tmp_path / "p"))
    ref = _ref(4, TIER_CFGS[engine], tier_dir=str(tmp_path / "j"))
    assert _totals(port) == _totals(ref) == _clean(engine)
    st = port.scheduler_stats()["store"]
    assert st == port.store_stats()
    assert _comparable(st) == _comparable(ref.store_stats())
    assert st["device"]["budget"] == TIER_CFGS[engine]["tier_device_bytes"]
    if engine == "classic":
        assert st["spills"]["host"] > 0 and st["disk"]["segments"] > 0
        assert st["probes"] > 0 and st["probe_hits"] > 0
        assert 0 < st["resident_ratio"] < 1
        assert port.dispatch_log[-1]["tier_disk_rows"] > 0
    elif engine == "fused":
        assert st["arena_spans"]["spills"] > 0 and port.rolls > 0
        assert _chains(port) == _chains(ref)
        _same_checkpoints(port, ref, tmp_path)
    else:
        # 2pc 4 never refills the sharded arena floor (JAX's fast arm).
        assert port._store.pressure_notes > 0


def test_the_spill_reads_the_table_in_chunks(tmp_path, monkeypatch):
    """The classic engine's spill with its table read 256 slots at a time
    and its refill in chunks of at most 100 keys (so the kept keys'
    buffers carry sentinel padding): still JAX's capped run, with JAX's
    counters and chains."""
    from stateright_tpu_torch import classic
    from stateright_tpu_torch.fused import _pow2

    monkeypatch.setattr(classic, "_SPILL_CHUNK", 256)
    monkeypatch.setattr(classic.CudaBfsChecker, "_chunks",
                        lambda self, n: _pow2(-(-n // 100)))
    pads, refill = [], classic.CudaBfsChecker._refill_table

    def padded(self, kept, counts):
        pads.append(kept[0].numel() - int(counts[0]))
        refill(self, kept, counts)

    monkeypatch.setattr(classic.CudaBfsChecker, "_refill_table", padded)
    port = _port(4, TIER_CFGS["classic"], tier_dir=str(tmp_path / "p"))
    ref = _ref(4, TIER_CFGS["classic"], tier_dir=str(tmp_path / "j"))
    assert _totals(port) == _totals(ref)
    st = port.store_stats()
    assert _comparable(st) == _comparable(ref.store_stats())
    assert st["spills"]["host"] > 1 and max(pads) > 0 and min(pads) >= 0
    assert _chains(port) == _chains(ref)


@pytest.mark.slow
def test_sharded_classic_capped_parity(tmp_path):
    port = _port(4, TIER_CFGS["sharded-classic"], tier_dir=str(tmp_path / "p"))
    ref = _ref(4, TIER_CFGS["sharded-classic"], tier_dir=str(tmp_path / "j"))
    assert _totals(port) == _totals(ref) == _clean("sharded-classic")
    st = port.scheduler_stats()["store"]
    assert st["spills"]["host"] > 0 and st["probes"] > 0
    assert _comparable(st) == _comparable(ref.store_stats())


def test_the_environment_arms_the_store(tmp_path, monkeypatch):
    """``STpu_TIER_*`` arm every engine's store where no keyword is given
    (the classic engine here), and a keyword wins."""
    cfg = _base("classic")
    monkeypatch.setenv("STpu_TIER_DEVICE_BYTES", "32k")
    monkeypatch.setenv("STpu_TIER_HOST_BYTES", "4k")
    monkeypatch.setenv("STpu_TIER_DIR", str(tmp_path))
    c = _port(4, cfg)
    assert _totals(c) == _clean("classic")
    st = c.store_stats()
    assert st["device_budget"] == 32 * 1024 and st["disk"]["segments"] > 0
    assert _port(4, cfg, tier_host_bytes=1 << 30).store_stats()[
        "host_budget"] == 1 << 30


def test_the_host_fallback_drops_the_tier_knobs():
    from stateright_tpu_torch.models.paxos import PaxosSys

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        c = (PaxosSys(2, server_count=5).checker().target_state_count(100)
             .spawn_cuda_bfs(tier_device_bytes=4096, tier_dir="unused"))
        c.join()
    (w,) = [w for w in caught if issubclass(w.category, RuntimeWarning)]
    assert "'tier_device_bytes'" in str(w.message)
    assert "'tier_dir'" in str(w.message)
    assert not os.path.exists("unused")


# -- Checkpoints across the packages -------------------------------------


def _spilled_checkpoint(tmp_path, package):
    """A mid-run checkpoint of a spilled classic run of ``package``: cold
    segments on disk, v5 refs in the header."""
    path = str(tmp_path / f"{package}.ckpt.npz")
    cfg = dict(TIER_CFGS["classic"], tier_dir=str(tmp_path / package),
               checkpoint_path=path, checkpoint_every_waves=4)
    run = _port if package == "port" else _ref
    builder = (twopc if package == "port" else ref_model).TwoPhaseSys(
        4).checker().target_state_count(5000)
    c = run(4, cfg, builder=builder)
    st = c.store_stats()
    assert st["spills"]["host"] > 0 and st["disk"]["segments"] > 0
    c.checkpoint(path)
    header = ckpt.verify_file(path)
    assert header["version"] == 5
    assert len(header["store"]["cold"]) == st["disk"]["segments"]
    return path, header


def _final_visited(c, path):
    """The final checkpoint's counts and logical visited set (hot, and
    cold materialized)."""
    c.checkpoint(path)
    with np.load(path) as data:
        header = json.loads(bytes(np.asarray(data["header"])))
        visited = np.asarray(data["visited"], np.uint64)
    if header.get("store"):
        visited = np.concatenate([visited, load_cold_refs(header["store"])])
    return header["state_count"], header["unique_count"], np.unique(visited)


_CLEAN_PAYLOAD = {}


def _clean_payload(tmp_path):
    if not _CLEAN_PAYLOAD:
        c = _port(4, _base("classic"))
        _CLEAN_PAYLOAD["v"] = _final_visited(c, str(tmp_path / "clean.npz"))
    return _CLEAN_PAYLOAD["v"]


def _same_payload(got, want):
    assert got[:2] == want[:2]
    assert np.array_equal(got[2], want[2])


def test_the_port_resumes_a_spilled_jax_checkpoint(tmp_path):
    path, header = _spilled_checkpoint(tmp_path, "jax")
    for (seg_path,) in [[os.path.join(r.get("dir", header["store"][
            "segment_dir"]), r["file"])] for r in header["store"]["cold"]]:
        ckpt.verify_file(seg_path)
        assert np.array_equal(map_segment_visited(seg_path),
                              ref_tiered.map_segment_visited(seg_path))
    want = _clean_payload(tmp_path)
    with_store = _port(4, TIER_CFGS["classic"], resume_from=path,
                       tier_dir=str(tmp_path / "resume"))
    assert _totals(with_store) == _clean("classic")
    assert with_store.store_stats()["disk"]["segments"] > 0
    _same_payload(_final_visited(with_store, str(tmp_path / "w.npz")), want)
    storeless = _port(4, _base("classic"), resume_from=path)
    assert _totals(storeless) == _clean("classic")
    _same_payload(_final_visited(storeless, str(tmp_path / "s.npz")), want)
    # The fused engine cannot evict visited rows: it reads the cold ones.
    fused = _port(4, TIER_CFGS["fused"], resume_from=path,
                  tier_dir=str(tmp_path / "fused"))
    assert _totals(fused) == _clean("fused")


def test_jax_resumes_a_spilled_port_checkpoint(tmp_path):
    path, header = _spilled_checkpoint(tmp_path, "port")
    for r in header["store"]["cold"]:
        seg = os.path.join(header["store"]["segment_dir"], r["file"])
        assert ref_ckpt.verify_file(seg)["store_segment"]["sha"] == r["sha"]
        assert ref_ckpt.content_hash(
            np.asarray(ref_tiered.map_segment_visited(seg))) == r["sha"]
    want = _clean_payload(tmp_path)
    ref = _ref(4, TIER_CFGS["classic"], resume_from=path,
               tier_dir=str(tmp_path / "resume"))
    assert _totals(ref) == _clean("classic")
    got = _final_visited(ref, str(tmp_path / "r.npz"))
    _same_payload(got, want)


def test_restart_from_resets_the_store(tmp_path):
    path, _ = _spilled_checkpoint(tmp_path, "port")
    c = _port(4, TIER_CFGS["classic"], tier_dir=str(tmp_path / "r"))
    assert _totals(c) == _clean("classic")
    c.restart_from(path).join()
    assert _totals(c) == _clean("classic")
    _same_payload(_final_visited(c, str(tmp_path / "x.npz")),
                  _clean_payload(tmp_path))


# -- The fused roll --------------------------------------------------------


def _sections(path):
    with np.load(path) as data:
        return {k: data[k].tobytes() for k in data.files}


def _same_checkpoints(port, ref, tmp_path):
    """Each run's checkpoint, section by section, byte for byte (the
    parent sections the rolls moved to the host among them)."""
    files = {name: str(tmp_path / f"{name}.npz") for name in ("p", "j")}
    port.checkpoint(files["p"])
    ref.checkpoint(files["j"])
    want, got = _sections(files["j"]), _sections(files["p"])
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key


def test_fused_roll_under_symmetry_equals_jax(tmp_path):
    """A capped fused run of 2pc 5 with symmetry whose arena rolls, at two
    waves a dispatch: the same totals, chains and spans as JAX's, and its
    checkpoint byte-equal to JAX's (the plain form is the fused arm of
    ``test_capped_runs_equal_jax``)."""
    cfg = dict(TIER_CFGS["fused"], waves_per_dispatch=2, arena_capacity=256,
               tier_device_bytes=60_000)
    port = _port(5, cfg, builder=twopc.TwoPhaseSys(5).checker().symmetry(),
                 tier_dir=str(tmp_path / "p"))
    ref = _ref(5, cfg, builder=ref_model.TwoPhaseSys(5).checker().symmetry(),
               tier_dir=str(tmp_path / "j"))
    assert _totals(port) == _totals(ref)
    assert port.store_stats()["arena_spans"] == \
        ref.store_stats()["arena_spans"]
    assert port.store_stats()["arena_spans"]["spills"] > 0
    assert _chains(port) == _chains(ref)
    _same_checkpoints(port, ref, tmp_path)


@pytest.mark.parametrize("engine", ["fused", "sharded-fused"])
def test_a_walk_that_meets_a_roll_keeps_every_link(tmp_path, monkeypatch,
                                                    engine):
    """A walk of the parent links that read the host blocks before a roll
    moved the arena's rows to them (the roll made here, once, where the
    walk's search of its blocks first misses, just before it searches the
    arena) reads them again, so each discovery's chain is the one walked
    before the roll."""
    port = _port(4, TIER_CFGS[engine], tier_dir=str(tmp_path))
    want = _chains(port)
    assert want and all(len(c) > 2 for c in want.values())
    rolls, real = port.rolls, port._moved_parent

    def moved_parent(blocks, key):
        got = real(blocks, key)
        if got is None and port.rolls == rolls:
            port._roll_span()
        return got

    monkeypatch.setattr(port, "_moved_parent", moved_parent)
    assert _chains(port) == want
    assert port.rolls == rolls + 1


# -- The slow arms -----------------------------------------------------------


@pytest.mark.slow
def test_sharded_fused_arena_span_parity_slow(tmp_path):
    """2pc 6 on 8 shards with a 512-row arena a shard under 300 KB: each
    shard's roll fires and the totals are JAX's (the tails-sum baseline
    moves with the tails)."""
    cfg = dict(sharded=True, batch_size=8, table_capacity=4096)
    capped = dict(cfg, arena_capacity=512, tier_device_bytes=300_000,
                  tier_host_bytes=1 << 20)
    base = _ref(6, cfg)
    port = _port(6, capped, tier_dir=str(tmp_path / "p"))
    assert _totals(port) == _totals(base)
    assert port.store_stats()["arena_spans"]["spills"] > 0
    ref = _ref(6, capped, tier_dir=str(tmp_path / "j"))
    assert port.store_stats()["arena_spans"] == \
        ref.store_stats()["arena_spans"]


@pytest.mark.slow
def test_paxos_capped_parity_slow(tmp_path):
    from stateright_tpu_torch.models.paxos import PaxosSys

    c = PaxosSys(2).checker().spawn_cuda_bfs(
        device="cpu", fused=False, batch_size=64, table_capacity=8192,
        tier_device_bytes=8192 * 8, tier_host_bytes=64 * 1024,
        tier_dir=str(tmp_path)).join()
    assert (c.unique_state_count(), c.state_count()) == (16668, 32971)
    assert set(c.discoveries()) == {"value chosen"}
    assert c.store_stats()["spill_bytes"] > 0


@pytest.mark.slow
def test_spilled_resume_in_fresh_process(tmp_path):
    path, _ = _spilled_checkpoint(tmp_path, "port")
    cfg = dict(TIER_CFGS["classic"])
    del cfg["fused"]
    script = f"""
from stateright_tpu_torch.models.twopc import TwoPhaseSys
c = TwoPhaseSys(4).checker().spawn_cuda_bfs(
    device="cpu", fused=False, resume_from={path!r},
    tier_dir={str(tmp_path / "fresh")!r}, **{cfg!r}).join()
print("TOTALS", c.state_count(), c.unique_state_count(),
      sorted(c.discoveries()))
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("STpu_")}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env=env, cwd=_REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    want = _clean("classic")
    assert f"TOTALS {want[0]} {want[1]} {list(want[2])}" in out.stdout
    assert "jax" not in out.stderr
