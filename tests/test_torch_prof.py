"""The port's wave profiler (``stateright_tpu_torch/obs/prof.py``) and the
kernels' declared costs, on the CPU.

- **Declared costs.** ``table.dedup_cost``, ``wave.wave_cost``,
  ``wave.sender_cost`` and ``append.append_cost`` at the shapes
  ``PERF.md`` §6 measured give the bounds its table prints (the same
  functions ``chip_smoke.py`` calls for its Bound column).
- **Armed engines.** With ``STpu_PROF=1`` and cadence 1 each device
  engine stamps the wave fields ``cost_flops`` / ``cost_bytes`` /
  ``cost_ratio`` on every wave, its dispatch programs' records are the
  sums of their kernels' declared costs, every program key has a
  ``profile_snapshot`` (which lints clean), and arming changes no result.
- **Disarmed is free**: the shared ``NULL_PROF``, never called.
- **JAX's cadence**: the same dispatch sequence samples the same set, and
  the same stats give the same ``stpu_prof_*`` lines.
"""

import math
import os
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))

import trace_lint  # noqa: E402
from stateright_tpu.obs import prof as ref_prof  # noqa: E402
from stateright_tpu_torch import append, table, wave  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosDevice  # noqa: E402
from stateright_tpu_torch.models.single_copy import SingleCopySys  # noqa: E402,E501
from stateright_tpu_torch.models.twopc import TwoPhaseDevice  # noqa: E402
from stateright_tpu_torch.obs import prof  # noqa: E402
from stateright_tpu_torch.obs.prof import (NULL_PROF,  # noqa: E402
                                           NullWaveProfiler, WaveProfiler,
                                           clear_program_records,
                                           prof_from_env,
                                           prometheus_prof_lines, roofline)
from stateright_tpu_torch.obs.schema import WAVE_FIELDS  # noqa: E402
from test_torch_obs_trace import DEVICE, _events, _port, _two_pc  # noqa: E402,E501


@pytest.fixture(autouse=True)
def _fresh_cost_table():
    # The static cost table is process-wide by design; isolate tests.
    clear_program_records()
    yield
    clear_program_records()


def _bound_ms(cost):
    return round(max(cost["bytes"] / prof.HBM_BYTES_PER_S,
                     cost["ops"] / prof.OPS_PER_S) * 1e3, 4)


#: ``PERF.md`` §6's shapes and the bounds its rows print, in ms
def _perf_rows():
    twopc = TwoPhaseDevice(10)
    paxos = PaxosDevice(3)
    sc4 = SingleCopySys(4, 1).device_model()
    return [
        # kernel 1: the synthetic stream, the mid-run waves, the rehash
        ("dedup synthetic", table.dedup_cost(851_968, 665_165), 0.0089),
        ("dedup 2pc wave", table.dedup_cost(851_968, 86_817), 0.0034),
        ("dedup paxos wave", table.dedup_cost(294_912, 24_678), 0.0011),
        ("dedup sharded classic paxos",
         table.dedup_cost(294_912, 8_043), 0.0010),
        # kernel 2 (2pc 10 Wp = 2, paxos 3 Wp = 20, single-copy 4 Wp =
        # 15 with symmetry: the operations' bound)
        ("wave 2pc", wave.wave_cost(twopc, 16_384, 2, cand=86_817), 0.0057),
        ("wave paxos", wave.wave_cost(paxos, 16_384, 20, cand=24_678),
         0.0086),
        ("wave single-copy 4 sym",
         wave.wave_cost(sc4, 16_384, 15, True, n_valid=41_508,
                        cand=4_766), 0.0248),
        # kernel 3 at 4 x 4,096
        ("sender 2pc", wave.sender_cost(twopc, 4, 4_096, 2), 0.0067),
        ("sender paxos", wave.sender_cost(paxos, 4, 4_096, 20), 0.0090),
        # the append kernel (its row prints six places)
        ("append 2pc", append.append_cost(2, 36_213, 12_680), 0.0006),
        ("append paxos", append.append_cost(20, 24_655, 12_418), 0.0015),
        ("append all new", append.append_cost(2, 851_968, 16_384), 0.0133),
    ]


def test_declared_costs_give_the_bounds_perf_prints():
    """Each kernel's declared cost at a shape of ``PERF.md`` §6 gives the
    bound that table prints for it, and the bytes decide all but
    single-copy 4's with symmetry, whose operations do (its row says
    "operations")."""
    for name, cost, want in _perf_rows():
        assert _bound_ms(cost) == want, (name, cost)
        by_ops = cost["ops"] / prof.OPS_PER_S > cost["bytes"] / \
            prof.HBM_BYTES_PER_S
        assert by_ops == (name == "wave single-copy 4 sym"), name
    # The append rows print six places: exact there too.
    assert round(append.append_cost(2, 36_213, 12_680)["bytes"]
                 / prof.HBM_BYTES_PER_S * 1e3, 6) == 0.000608
    assert round(append.append_cost(2, 851_968, 16_384)["bytes"]
                 / prof.HBM_BYTES_PER_S * 1e3, 6) == 0.013283
    # A full shape's default: every slot valid and a candidate.
    assert wave.wave_cost(TwoPhaseDevice(3), 32, 1) == wave.wave_cost(
        TwoPhaseDevice(3), 32, 1, n_valid=32 * TwoPhaseDevice(3).max_fanout,
        cand=32 * TwoPhaseDevice(3).max_fanout)


def test_roofline_share_against_the_card_peaks():
    """``roofline`` adds the bound at the peaks ``chip_smoke.py`` uses
    and the share of it a measured run reached; JAX's gauges are the
    same numbers."""
    rec = prof.cost_record({"bytes": 3.35e9, "ops": 6.7e9})
    got = roofline(rec, 2e-3)
    assert got["bound_s"] == pytest.approx(1e-3)
    assert got["share"] == pytest.approx(0.5)
    ref = ref_prof.roofline(rec, 2e-3)
    assert {k: got[k] for k in ref} == ref
    assert roofline(prof.cost_record(None), 1.0)["share"] is None


@pytest.mark.parametrize("engine", DEVICE)
def test_armed_engines_stamp_declared_costs(tmp_path, monkeypatch, engine):
    """Armed at cadence 1: every wave carries the declared cost and a
    ratio, each program's record is its kernels' summed declared costs,
    every program key has a snapshot, the trace lints clean, and the
    counts are the disarmed run's."""
    path = tmp_path / "t.jsonl"
    monkeypatch.setenv("STpu_TRACE", str(path))
    monkeypatch.setenv("STpu_PROF", "1")
    monkeypatch.setenv("STpu_PROF_SAMPLE", "1")
    c = _port(engine, _two_pc(3, True), wave_kernel=True)
    monkeypatch.delenv("STpu_TRACE")
    assert (c.unique_state_count(), c.state_count()) == (288, 1146)
    _, errors = trace_lint.lint_file(str(path))
    assert errors == [], errors[:3]
    events = _events(path)
    waves = [e for e in events if e["type"] == "wave"]
    snaps = [e for e in events if e["type"] == "profile_snapshot"]
    assert {frozenset(w) for w in waves} == {frozenset(WAVE_FIELDS)}
    for w in waves:
        assert w["cost_bytes"] > 0 and w["cost_flops"] > 0
        assert math.isfinite(w["cost_ratio"]) and w["cost_ratio"] > 0
    stats = c.scheduler_stats()["prof"]
    assert stats["sampled"] == len(snaps) == len(waves)
    assert set(stats["programs"]) == {s["key"] for s in snaps}
    records = prof.program_records(engine + "|")
    assert set(records) == set(stats["programs"])
    for key, rec in records.items():
        assert rec["kernel_path"] == c.kernel_path()
        B = eval(key.split("|")[2])[0 if engine in ("classic", "sharded")
                                    else 1]
        costs = (c._wave_costs(B) if engine in ("classic", "sharded")
                 else c._dispatch_costs(B))
        want = prof.sum_costs(costs)
        assert (rec["bytes"], rec["flops"]) == (want["bytes"], want["ops"])
    for s in snaps:
        assert s["share"] is not None and s["bound_s"] > 0
        assert s["intensity"] == pytest.approx(s["flops"] / s["bytes"],
                                               rel=1e-3)
    lines = prometheus_prof_lines(stats, engine)
    assert any(line.startswith("stpu_prof_bytes{") for line in lines)


def test_torch_stage_programs_record_their_kernel_1():
    """On the torch stages a classic wave's record is kernel 1's declared
    cost (no operations), never null: the torch stages around it
    declare nothing."""
    p = WaveProfiler("classic", 1)
    p.capture("k", prof.sum_costs([table.dedup_cost(64)]))
    entry = {"kernel_path": "dedup_plain"}
    p.wave(entry, "k", 1e-3)
    assert entry["cost_bytes"] == table.dedup_cost(64)["bytes"]
    assert entry["cost_flops"] == 0.0 and entry["cost_ratio"] == 1.0
    p.capture("none", prof.sum_costs([]))
    entry = {}
    p.wave(entry, "none", 1e-3)
    assert entry["cost_bytes"] is None and entry["cost_flops"] is None


def test_disarmed_prof_is_shared_null_and_never_called(monkeypatch):
    """``STpu_PROF`` unset: every engine holds ``NULL_PROF`` and never
    calls it (its methods are poisoned)."""
    monkeypatch.delenv("STpu_PROF", raising=False)
    assert prof_from_env("classic") is NULL_PROF

    def _boom(name):
        def poisoned(self, *a, **k):
            raise AssertionError(f"NullWaveProfiler.{name} called with "
                                 "profiling disarmed")
        return poisoned

    for name in ("capture", "should_sample", "wave", "stats", "close"):
        monkeypatch.setattr(NullWaveProfiler, name, _boom(name))
    for engine in DEVICE:
        c = _port(engine, _two_pc(3, True))
        assert c._prof is NULL_PROF
        assert c.scheduler_stats()["prof"] is None
        assert all(e.get("cost_flops") is None for e in c.dispatch_log)


@pytest.mark.parametrize("every", [1, 3, 4, 32])
def test_sampling_cadence_deterministic(every):
    """The sampled set of a dispatch sequence is JAX's: every Nth
    dispatch and the first of each new program key."""
    seq = ["k1"] * 6 + ["k2"] + ["k1"] * 5 + ["k3"] * 40 + ["k2"] * 9
    ours, ref = WaveProfiler("a", every), ref_prof.WaveProfiler("a", every)
    got = [ours.should_sample(k) for k in seq]
    assert got == [ref.should_sample(k) for k in seq]
    if every == 4:
        assert got[:12] == [i % 4 == 0 or i == 6 for i in range(12)]
    assert ours.stats()["dispatches"] == len(seq)


def test_snapshots_and_exposition_equal_jax():
    """The same records and samples through both profilers: the same
    stamped fields, JAX's snapshot gauges, and the same ``stpu_prof_*``
    lines."""
    ours, ref = WaveProfiler("classic", 2), ref_prof.WaveProfiler(
        "classic", 2)
    rec = {"flops": 193085.0, "bytes": 1494572.0, "peak_bytes": 1109737,
           "kernel_path": None}
    ref_prof._COST_RECORDS["classic|aa|(64,)"] = dict(rec)
    ours.capture("classic|aa|(64,)", {"bytes": 1494572, "ops": 193085},
                 1109737)
    for i, s in enumerate((0.002, 0.003, 0.0025, 0.004)):
        a, b = {"kernel_path": "xla"}, {"kernel_path": "xla"}
        ours.wave(a, "classic|aa|(64,)", s if i % 2 == 0 else None)
        ref.wave(b, "classic|aa|(64,)", s if i % 2 == 0 else None)
        assert a == b
    got, want = ours.stats(), ref.stats()
    for snap in got["programs"].values():
        snap.pop("bound_s"), snap.pop("share")
    assert got == dict(want, captured=1)
    assert (prometheus_prof_lines(got, "classic")
            == ref_prof.prometheus_prof_lines(want, "classic"))
    ref_prof.clear_program_records()
