"""The port's fault injection and supervised recovery
(``stateright_tpu_torch/resilience``), the port arm of
``tests/test_resilience.py``.

Each case arms one ``STpu_FAULTS`` spec, runs the port's engine on the
CPU under the port's ``Supervisor`` (or leans on the in-engine OOM
degrade), and holds the recovered run to JAX's clean run of the same
configuration and to the port's own clean run: ``state_count``,
``unique_state_count``, the discovery names and each discovery's path as
state fingerprints, all exact. Both packages read the one environment
variable, so the JAX reference runs are made before a spec is armed, and
the fixture clears both packages' plan caches.

Also: the spec grammar, the window and seeded ``p``, the same spec
firing at the same hits in both packages' plans, the plan cache,
``strip_point``, ``newest_valid_checkpoint`` falling back to ``.prev``
(a torn file, a ``ckpt_crc`` lying disk), the first attempt resuming an
existing checkpoint, ``restart_from`` clearing the failed-run flag, retry
exhaustion, ``abort`` with the store's ``tiers``, ``degrade`` with
``requested >= kept > 0``, a non-OOM failure at a growth site raising
unchanged, ``is_oom`` on the card's ``torch.OutOfMemoryError`` and on
every case JAX's takes, a writer-thread failure raising at the next
join, the backoff's jitter, a preempted run not retried, and a faulted
run's ``STpu_TRACE`` stream linting clean under ``tools/trace_lint.py``.

As in JAX's file: 2pc 3 and 4 on the classic and fused engines are the
fast set; the sharded arms (but ``a2a_short``) and the paxos 2 matrix
are ``-m slow``.
"""

import json
import os
import random
import sys
import warnings

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "examples"))
sys.path.insert(0, os.path.join(_REPO, "tools"))

import stateright_tpu.tpu  # noqa: F401,E402  (enables x64)
import two_phase_commit as ref_model  # noqa: E402
from stateright_tpu.resilience import faults as ref_faults  # noqa: E402
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
from stateright_tpu_torch import checkpoint_format as ckpt  # noqa: E402
from stateright_tpu_torch.io.async_io import AsyncWriter  # noqa: E402
from stateright_tpu_torch.models import twopc  # noqa: E402
from stateright_tpu_torch.resilience import (  # noqa: E402
    FAULT_POINTS, FAULTS_ENV, NULL_PLAN, FaultPlan, InjectedFault,
    InjectedOom, Supervisor, fault_plan_from_env, is_oom,
    newest_valid_checkpoint, reset_fault_plans, strip_point)

torch.set_num_threads(2)

#: the port's knobs a JAX ``ENGINE_CFGS`` entry stands for (JAX's
#: sharded engines on the conftest's 8-device mesh, the port's on 8
#: stacked CPU shards)
ENGINE_CFGS = {
    "classic": dict(fused=False),
    "fused": dict(),
    "sharded-classic": dict(sharded=True, fused=False),
    "sharded-fused": dict(sharded=True),
}
ENGINES = list(ENGINE_CFGS)
ENGINES_SHARDED_SLOW = [
    e if not e.startswith("sharded")
    else pytest.param(e, marks=pytest.mark.slow) for e in ENGINES]

_REF_CLEAN: dict = {}
_PORT_CLEAN: dict = {}


def _port_cfg(engine, **kw):
    cfg = dict(ENGINE_CFGS[engine], **kw)
    if cfg.pop("sharded", False):
        cfg["mesh"] = ["cpu"] * 8
    else:
        cfg["device"] = "cpu"
    return cfg


def _spawn(rms, engine, **kw):
    """The port's spawn of 2pc at ``rms`` RMs at batch 32 (JAX's)."""
    return twopc.TwoPhaseSys(rms).checker().spawn_cuda_bfs(
        batch_size=32, **_port_cfg(engine, **kw))


def _chains(c):
    """Each discovery's path as its states' fingerprints (JAX's
    ``host_fp64`` of each encoded state)."""
    return tuple(sorted(
        (name, tuple(host_fp64(np.asarray(c._dm.encode(s), np.uint32))
                     for s in p.into_states()))
        for name, p in c.discoveries().items()))


def _totals(c):
    return (c.state_count(), c.unique_state_count(),
            tuple(sorted(c.discoveries())), _chains(c))


def _ref_clean(rms, engine):
    """JAX's clean run of the configuration, made once (before any spec
    is armed)."""
    key = (rms, engine)
    if key not in _REF_CLEAN:
        cfg = dict(ENGINE_CFGS[engine])
        _REF_CLEAN[key] = _totals(ref_model.TwoPhaseSys(rms).checker()
                                  .spawn_tpu_bfs(batch_size=32, **cfg)
                                  .join())
    return _REF_CLEAN[key]


def _port_clean(rms, engine):
    key = (rms, engine)
    if key not in _PORT_CLEAN:
        _PORT_CLEAN[key] = _totals(_spawn(rms, engine).join())
    return _PORT_CLEAN[key]


def _clean(rms, engine):
    """Both clean runs, equal to each other; the port's totals."""
    want = _ref_clean(rms, engine)
    assert _port_clean(rms, engine) == want
    return want


@pytest.fixture
def arm(monkeypatch):
    """Sets ``STpu_FAULTS`` with fresh counters in both packages' plan
    caches; disarms and clears them at teardown."""
    def _arm(spec):
        monkeypatch.setenv(FAULTS_ENV, spec)
        reset_fault_plans()
        ref_faults.reset_fault_plans()
    yield _arm
    monkeypatch.delenv(FAULTS_ENV, raising=False)
    reset_fault_plans()
    ref_faults.reset_fault_plans()


def _supervised(rms, engine, spec, arm, tmp_path, spawn_kwargs=None,
                **sup_kwargs):
    ckpt_path = str(tmp_path / f"{engine}.ckpt.npz")
    want = _clean(rms, engine)  # before the spec is armed
    arm(spec)

    def factory(resume_from=None):
        # Two waves a dispatch, so the fused engines reach several rest
        # points on this small space (JAX's test's knob).
        return _spawn(rms, engine, checkpoint_path=ckpt_path,
                      checkpoint_every_waves=1, waves_per_dispatch=2,
                      resume_from=resume_from, **(spawn_kwargs or {}))

    sup = Supervisor(factory, checkpoint_path=ckpt_path, backoff_s=0.001,
                     **sup_kwargs)
    return sup, sup.run(), want


# -- The crash matrix ---------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES_SHARDED_SLOW)
def test_wave_crash_supervised_bit_identical(engine, arm, tmp_path):
    sup, c, want = _supervised(3, engine, "wave_crash@n=2", arm, tmp_path)
    assert _totals(c) == want
    assert len(sup.recoveries) == 1
    # The second dispatch's processing, JAX's hit.
    assert sup.recoveries[0]["error"] == (
        "InjectedFault: injected crash at fault point 'wave_crash' (hit 2)")


@pytest.mark.parametrize("engine", [
    "classic", "fused",
    pytest.param("sharded-classic", marks=pytest.mark.slow),
    pytest.param("sharded-fused", marks=pytest.mark.slow)])
def test_torn_checkpoint_falls_back_one_generation(engine, arm, tmp_path):
    sup, c, want = _supervised(3, engine, "torn_ckpt@n=2", arm, tmp_path)
    assert _totals(c) == want
    assert len(sup.recoveries) == 1
    resumed = sup.recoveries[0]["resumed_from"]
    assert resumed is not None and resumed.endswith(ckpt.PREV_SUFFIX)


@pytest.mark.parametrize("fault", [
    "a2a_short", pytest.param("a2a_corrupt", marks=pytest.mark.slow)])
def test_sharded_exchange_corruption_recovers(fault, arm, tmp_path):
    sup, c, want = _supervised(3, "sharded-classic", f"{fault}@n=2", arm,
                               tmp_path)
    assert _totals(c) == want
    assert len(sup.recoveries) == 1
    assert "exchange" in sup.recoveries[0]["error"].lower()
    assert sup.recoveries[0]["error"].startswith("ExchangeIntegrityError")


#: JAX's ``_TIER``: classic caps that drive visited spills through warm to
#: cold on 2pc 4
_TIER = dict(tier_device_bytes=4096 * 8, tier_host_bytes=4096)


@pytest.mark.parametrize("fault", [
    "spill_fail@n=2", "disk_full@n=1", "page_in_torn@n=1"])
def test_tiered_store_faults_supervised_bit_identical(fault, arm,
                                                      tmp_path):
    sup, c, want = _supervised(
        4, "classic", fault, arm, tmp_path,
        spawn_kwargs=dict(table_capacity=4096, tier_dir=str(tmp_path),
                          **_TIER))
    assert _totals(c) == want
    st = c.scheduler_stats()["store"]
    assert st["enabled"] and st["spill_bytes"] > 0
    # JAX's run of this spec recovers once, from the same hit (page_in_torn
    # first fires at a frontier block's read back, a raise).
    point, _, n = fault.partition("@n=")
    assert [r["error"] for r in sup.recoveries] == [
        f"InjectedFault: injected crash at fault point {point!r} "
        f"(hit {n})"]


def test_disk_full_on_the_writer_thread_surfaces_at_join(arm, tmp_path):
    """With ``async_io`` the cold segment writes run on the engine's
    writer thread: ``disk_full`` fires there, raises at the engine's next
    join, and the supervised run still ends exact."""
    sup, c, want = _supervised(
        4, "classic", "disk_full@n=1", arm, tmp_path,
        spawn_kwargs=dict(table_capacity=4096, tier_dir=str(tmp_path),
                          async_io=True, **_TIER))
    assert _totals(c) == want
    assert c.scheduler_stats()["store"]["spill_bytes"] > 0
    assert [r["error"] for r in sup.recoveries] == [
        "InjectedFault: injected crash at fault point 'disk_full' (hit 1)"]


def test_torn_segment_falls_back_in_store(arm, tmp_path, monkeypatch):
    """A cold segment that lands torn: the partition's ``.prev``
    generation stays its cold view, the rows that were to go cold stay
    warm, no fingerprint is lost, and a ``recover`` pairs the fault."""
    from stateright_tpu_torch.store.tiered import TieredStore

    trace = str(tmp_path / "seg.jsonl")
    monkeypatch.setenv("STpu_TRACE", trace)
    arm("page_in_torn@n=2")

    class Owner:
        from stateright_tpu_torch.obs import tracer_from_env
        _tracer = tracer_from_env("classic")
        _flight = None

    owner = Owner()
    store = TieredStore(segment_dir=str(tmp_path / "seg"), n_partitions=1,
                        owner=owner)
    first = np.arange(0, 64, dtype=np.uint64)
    second = np.arange(64, 96, dtype=np.uint64)
    store.spill_visited(first)
    store._spill_partition_to_disk(0)
    store.spill_visited(second)
    store._spill_partition_to_disk(0)  # lands torn
    assert store._cold[0].path.endswith(ckpt.PREV_SUFFIX)
    assert store.probe(np.concatenate([first, second])).all()
    assert np.array_equal(store._warm[0], second)
    owner._tracer.close()
    assert [e["kind"] for e in _events(trace, "recover")] == [
        "cold_segment_prev"]
    assert [(e["point"], e["mode"]) for e in _events(trace, "fault")] == [
        ("page_in_torn", "torn")]


def _events(path, etype):
    return [json.loads(line) for line in open(path)
            if json.loads(line)["type"] == etype]


def test_tiered_abort_records_high_water(arm, tmp_path, monkeypatch):
    trace = str(tmp_path / "abort.trace.jsonl")
    monkeypatch.setenv("STpu_TRACE", trace)
    arm("spill_fail@n=1@times=0")

    def factory(resume_from=None):
        return _spawn(4, "classic", table_capacity=4096,
                      tier_dir=str(tmp_path), resume_from=resume_from,
                      **_TIER)

    sup = Supervisor(factory, max_retries=1, backoff_s=0.001)
    with pytest.raises(InjectedFault):
        sup.run()
    aborts = _events(trace, "abort")
    assert aborts and aborts[-1]["tiers"] is not None
    assert aborts[-1]["tiers"]["host_budget"] == _TIER["tier_host_bytes"]
    assert "spill_fail" in aborts[-1]["reason"]


def test_degrade_event_records_requested_vs_kept(arm, tmp_path,
                                                 monkeypatch):
    want = _clean(4, "classic")
    trace = str(tmp_path / "degrade.trace.jsonl")
    monkeypatch.setenv("STpu_TRACE", trace)
    arm("grow_oom@n=1")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        c = _spawn(4, "classic", table_capacity=4096,
                   max_batch_size=128).join()
    assert _totals(c) == want
    degrades = _events(trace, "degrade")
    assert degrades
    for d in degrades:
        assert d["requested"] >= d["kept"] > 0
        assert d["new"] < d["old"]
    recovers = _events(trace, "recover")
    assert [r["kind"] for r in recovers] == ["grow_degrade"] * len(degrades)


@pytest.mark.parametrize("engine", ENGINES_SHARDED_SLOW)
def test_grow_oom_degrades_and_completes(engine, arm):
    want = _clean(4, engine)
    arm("grow_oom@n=1")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        c = _spawn(4, engine, table_capacity=4096,
                   max_batch_size=128).join()
    assert _totals(c) == want
    assert c._B_max < 128 and c._buckets[-1] == c._B_max
    assert any("degrading the dispatch bucket ladder" in str(w.message)
               for w in caught)


def test_grow_oom_exhaustion_aborts_supervision(arm):
    arm("grow_oom@n=1@times=0")
    made = []

    def factory(resume_from=None):
        made.append(resume_from)
        return _spawn(4, "classic", table_capacity=4096, max_batch_size=64,
                      resume_from=resume_from)

    sup = Supervisor(factory, max_retries=1, backoff_s=0.001)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(MemoryError) as info:
            sup.run()
    assert isinstance(info.value, InjectedOom)
    assert len(sup.recoveries) == 1 and made == [None, None]


@pytest.mark.parametrize("engine", ["classic", "fused"])
def test_non_oom_failure_at_a_growth_site_raises_unchanged(engine, arm,
                                                           monkeypatch):
    """A growth that fails for a reason other than memory raises as it
    was raised, with the ladder whole."""
    from stateright_tpu_torch import classic, fused

    boom = ValueError("not an allocation failure")

    def broken(*args, **kw):
        raise boom

    monkeypatch.setattr(classic.CudaBfsChecker, "_rehash_grown", broken)
    monkeypatch.setattr(fused.FusedCudaBfsChecker, "_grow_at", broken)
    c = _spawn(4, engine, table_capacity=4096, max_batch_size=128)
    with pytest.raises(ValueError) as info:
        c.join()
    assert info.value is boom
    assert c._B_max == 128


def test_host_bfs_crash_supervised_bit_identical(arm):
    model = twopc.TwoPhaseSys(3)
    ref = ref_model.TwoPhaseSys(3).checker().spawn_bfs().join()
    want = (ref.state_count(), ref.unique_state_count(),
            tuple(sorted(ref.discoveries())))
    arm("host_crash@n=1")
    sup = Supervisor(lambda resume_from=None: model.checker().spawn_bfs(),
                     backoff_s=0.001)
    c = sup.run()
    assert (c.state_count(), c.unique_state_count(),
            tuple(sorted(c.discoveries()))) == want
    assert set(c._generated) == set(ref._generated)
    assert len(sup.recoveries) == 1
    assert "host_crash" in sup.recoveries[0]["error"]


# -- restart_from: the failed-run flag ---------------------------------------

def test_restart_from_clears_failed_flag(arm, tmp_path):
    want = _clean(3, "classic")
    path = str(tmp_path / "r.npz")
    arm("wave_crash@n=3")
    c = _spawn(3, "classic", checkpoint_path=path, checkpoint_every_waves=1)
    with pytest.raises(RuntimeError):
        c.join()
    with pytest.raises(RuntimeError, match="torn frontier"):
        c.checkpoint(str(tmp_path / "never.npz"))
    c.restart_from(path).join()
    assert _totals(c) == want
    after = str(tmp_path / "after.npz")
    c.checkpoint(after)
    assert os.path.exists(after)
    assert _totals(_spawn(3, "classic", resume_from=after).join()) == want


# -- Obs events and the lint ------------------------------------------------

def test_faulted_run_trace_lints_clean(arm, tmp_path, monkeypatch):
    import trace_lint

    want = _clean(3, "classic")
    trace = str(tmp_path / "t.jsonl")
    monkeypatch.setenv("STpu_TRACE", trace)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        sup, c, _ = _supervised(
            3, "classic", "wave_crash@n=2,grow_oom@n=1", arm, tmp_path,
            spawn_kwargs=dict(table_capacity=4096, max_batch_size=128))
    assert _totals(c) == want
    counts, errors = trace_lint.lint_file(trace)
    assert not errors, errors[:5]
    assert counts.get("fault", 0) >= 2
    assert counts.get("retry", 0) >= 1
    assert counts.get("recover", 0) >= 1
    assert counts.get("degrade", 0) >= 1
    assert sup.recoveries and "jitter_s" in sup.recoveries[0]
    faults = _events(trace, "fault")
    assert {f["point"] for f in faults} == {"wave_crash", "grow_oom"}
    assert [f["mode"] for f in faults if f["point"] == "grow_oom"] == ["oom"]


# -- The spec grammar, in both packages ---------------------------------------

def test_fault_spec_parsing_and_window():
    plan = FaultPlan("wave_crash@n=3@times=2")
    assert [plan.fires("wave_crash") for _ in range(6)] == \
        [False, False, True, True, False, False]
    always = FaultPlan("grow_oom@wave=2@times=0")
    assert [always.fires("grow_oom") for _ in range(4)] == \
        [False, True, True, True]
    with pytest.raises(ValueError, match="unknown fault point"):
        FaultPlan("wave_crashh@n=1")
    with pytest.raises(ValueError, match="unknown fault key"):
        FaultPlan("wave_crash@frequency=2")
    with pytest.raises(ValueError, match="n must be >= 1"):
        FaultPlan("wave_crash@n=0")
    assert FAULT_POINTS.keys() == ref_faults.FAULT_POINTS.keys()
    assert len(FAULT_POINTS) == 14
    # The points whose hooks come later parse as in JAX.
    FaultPlan("worker_crash@n=2,admit_fault,preempt_wedge@times=0,"
              "child_death@p=0.5@seed=3")


def test_fault_spec_seeded_probability_replays():
    a_plan = FaultPlan("wave_crash@p=0.5@seed=7@times=0")
    a = [a_plan.fires("wave_crash") for _ in range(32)]
    b_plan = FaultPlan("wave_crash@p=0.5@seed=7@times=0")
    assert a == [b_plan.fires("wave_crash") for _ in range(32)]
    assert any(a) and not all(a)
    c_plan = FaultPlan("wave_crash@p=0.5@seed=8@times=0")
    assert a != [c_plan.fires("wave_crash") for _ in range(32)]


@pytest.mark.parametrize("spec", [
    "wave_crash@n=3@times=2",
    "grow_oom@n=2@times=0",
    "a2a_short@p=0.3@seed=11@times=0,a2a_corrupt@p=0.6@seed=11@times=3",
    "spill_fail@wave=5,disk_full@p=0.5,page_in_torn@n=2@times=4"])
def test_same_spec_fires_at_the_same_hits_in_both_packages(spec):
    """Hit for hit, interleaving the points, both packages' plans fire
    alike: ``fires`` and ``crash`` (with its exception types)."""
    points = [e.split("@")[0] for e in spec.split(",")]
    mine, theirs = FaultPlan(spec), ref_faults.FaultPlan(spec)
    rng = random.Random(spec)
    for _ in range(96):
        point = rng.choice(points)
        if rng.random() < 0.5:
            assert mine.fires(point) == theirs.fires(point)
            continue
        got = want = None
        try:
            mine.crash(point)
        except InjectedFault as e:
            got = (type(e).__name__, str(e))
        try:
            theirs.crash(point)
        except ref_faults.InjectedFault as e:
            want = (type(e).__name__, str(e))
        assert got == want


def test_plan_cache_is_per_spec(monkeypatch):
    monkeypatch.setenv(FAULTS_ENV, "wave_crash@n=1")
    reset_fault_plans()
    p1 = fault_plan_from_env()
    assert fault_plan_from_env() is p1
    assert fault_plan_from_env("grow_oom@n=1") is not p1
    reset_fault_plans()
    assert fault_plan_from_env() is not p1
    monkeypatch.delenv(FAULTS_ENV)
    assert fault_plan_from_env() is NULL_PLAN
    assert not NULL_PLAN.active and not NULL_PLAN.fires("wave_crash")
    reset_fault_plans()


def test_strip_point():
    spec = "child_death@n=2, wave_crash@n=3,child_death@p=0.1,grow_oom"
    assert strip_point(spec, "child_death") == \
        ref_faults.strip_point(spec, "child_death")
    assert strip_point(spec, "child_death") == " wave_crash@n=3,grow_oom"
    assert strip_point("grow_oom", "grow_oom") == ""


def test_is_oom():
    """The card's allocation failure, and every case JAX's takes."""
    card = torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")
    assert isinstance(card, RuntimeError) and not isinstance(card,
                                                             MemoryError)
    assert is_oom(card)
    assert not ref_faults.is_oom(card)  # the finding: JAX's misses it
    cases = [MemoryError("x"), InjectedOom("x"),
             ref_faults.InjectedOom("x"),
             RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying"),
             RuntimeError("XlaRuntimeError: RESOURCE_EXHAUSTED"),
             ValueError("Out of memory allocating 8 bytes")]
    for err in cases:
        assert ref_faults.is_oom(err) and is_oom(err), err
    for err in (RuntimeError("boom"), ValueError("memory"),
                InjectedFault("wave_crash"), KeyError("oom")):
        assert not is_oom(err) and not ref_faults.is_oom(err), err


# -- Checkpoints and the supervisor -------------------------------------------

def _payload():
    return dict(header=np.frombuffer(b'{"version": 3}', np.uint8),
                visited=np.arange(4, dtype=np.uint64))


def test_newest_valid_checkpoint_fallback(tmp_path):
    path = str(tmp_path / "g.npz")
    ckpt.write_atomic(path, _payload())
    ckpt.write_atomic(path, _payload())
    assert os.path.exists(path + ckpt.PREV_SUFFIX)
    assert newest_valid_checkpoint(path) == path
    with open(path, "r+b") as f:
        f.truncate(40)
    assert newest_valid_checkpoint(path) == path + ckpt.PREV_SUFFIX
    with open(path + ckpt.PREV_SUFFIX, "r+b") as f:
        f.truncate(40)
    assert newest_valid_checkpoint(path) is None
    assert newest_valid_checkpoint(None) is None


def test_lying_disk_falls_back_to_prev(arm, tmp_path):
    """``ckpt_crc`` changes one visited byte after the CRCs: the file
    reads, its CRC check fails, and the previous generation is chosen."""
    path = str(tmp_path / "crc.npz")
    arm("ckpt_crc@n=2")
    ckpt.write_atomic(path, _payload())
    ckpt.write_atomic(path, _payload())
    with pytest.raises(ValueError):
        ckpt.verify_file(path)
    assert newest_valid_checkpoint(path) == path + ckpt.PREV_SUFFIX


def test_torn_write_on_the_writer_thread_raises_at_join(arm, tmp_path):
    """A ``torn_ckpt`` on the background writer fails nothing until the
    owner joins; the join raises it, once."""
    path = str(tmp_path / "w.npz")
    ckpt.write_atomic(path, _payload())
    arm("torn_ckpt@n=1")
    writer = AsyncWriter()
    writer.submit(lambda: ckpt.write_atomic(path, _payload()))
    with pytest.raises(InjectedFault, match="torn_ckpt"):
        writer.join()
    writer.join()
    assert newest_valid_checkpoint(path) == path + ckpt.PREV_SUFFIX


def test_async_writer_torn_checkpoint_supervised(arm, tmp_path):
    """The engine's writer thread tears a generation; the supervisor sees
    it through the engine's join and resumes from ``.prev``."""
    sup, c, want = _supervised(3, "classic", "torn_ckpt@n=2", arm, tmp_path,
                               spawn_kwargs=dict(async_io=True))
    assert _totals(c) == want
    assert len(sup.recoveries) == 1
    assert sup.recoveries[0]["resumed_from"].endswith(ckpt.PREV_SUFFIX)


def test_supervisor_first_attempt_resumes_existing_checkpoint(tmp_path):
    want = _clean(3, "classic")
    path = str(tmp_path / "pre.npz")
    twopc.TwoPhaseSys(3).checker().target_state_count(300).spawn_cuda_bfs(
        device="cpu", batch_size=32, fused=False,
        checkpoint_path=path).join()
    seen = []

    def factory(resume_from=None):
        seen.append(resume_from)
        return _spawn(3, "classic", resume_from=resume_from)

    c = Supervisor(factory, checkpoint_path=path).run()
    assert seen == [path]
    assert _totals(c) == want


def test_backoff_jitter_and_preempted_runs():
    """The delays are JAX's schedule with the drawn jitter recorded; a
    preempted checker returns at once and is never retried."""
    slept = []

    class Failing:
        attempts = 0

        def join(self):
            Failing.attempts += 1
            raise RuntimeError(f"attempt {Failing.attempts}")

    sup = Supervisor(lambda resume_from=None: Failing(), max_retries=3,
                     backoff_s=0.5, backoff_factor=2.0, max_backoff_s=1.5,
                     jitter_frac=0.5, rng=random.Random(1),
                     sleep=slept.append)
    with pytest.raises(RuntimeError, match="attempt 4"):
        sup.run()
    draws = random.Random(1)
    want = []
    for base in (0.5, 1.0, 1.5):
        jitter = base * 0.5 * draws.random()
        want.append(base + jitter)
        assert jitter >= 0
    assert slept == pytest.approx(want)
    assert [r["backoff_s"] for r in sup.recoveries] == [0.5, 1.0, 1.5]
    assert all(r["resumed_from"] is None for r in sup.recoveries)

    class Preempted:
        preempted = True

        def join(self):
            return self

    made = []
    sup = Supervisor(lambda resume_from=None: made.append(1) or Preempted(),
                     sleep=slept.append)
    assert sup.run().preempted and made == [1] and not sup.recoveries


# -- The paxos matrix (slow) --------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("engine", ENGINES)
def test_wave_crash_supervised_paxos(engine, arm, tmp_path):
    from stateright_tpu_torch.models.paxos import PaxosSys

    path = str(tmp_path / f"{engine}.npz")
    arm("wave_crash@n=6")

    def factory(resume_from=None):
        return PaxosSys(2).checker().spawn_cuda_bfs(
            batch_size=256, checkpoint_path=path, checkpoint_every_waves=2,
            waves_per_dispatch=2, resume_from=resume_from,
            **_port_cfg(engine))

    sup = Supervisor(factory, checkpoint_path=path, backoff_s=0.001)
    c = sup.run()
    assert c.unique_state_count() == 16668
    assert c.state_count() == 32971
    assert set(c.discoveries()) == {"value chosen"}
    assert len(sup.recoveries) == 1
