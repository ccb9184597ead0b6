"""The port's histograms, SLOs, slow-wave detector and flight recorder
(``stateright_tpu_torch/obs``) against JAX's, on the CPU.

- **The same numbers.** ``WaveObs``, ``SloTracker`` and
  ``SlowWaveDetector`` of both packages fed the same entries give the
  same quantiles, snapshots, breaches, verdicts and ``prometheus_*_lines``
  text; the environment's overrides parse alike.
- **Armed engines.** With ``STpu_HIST`` / ``STpu_SLO`` / ``STpu_ANOMALY``
  set, every device engine and the host BFS hold an armed facade, its
  ``hist_snapshot`` events lint clean, and ``scheduler_stats()`` carries
  ``slo`` and ``anomalies``.
- **Postmortems.** A port run that raises (paxos's error lane on two
  network slots) dumps its flight ring, every line of which JAX's
  ``validate_line`` accepts, names it ``flight_dump``, and the dump ends
  with the final histogram snapshot.
"""

import json
import os
import random
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))

import trace_lint  # noqa: E402
from stateright_tpu.obs import anomaly as ref_anomaly  # noqa: E402
from stateright_tpu.obs import hist as ref_hist  # noqa: E402
from stateright_tpu.obs import slo as ref_slo  # noqa: E402
from stateright_tpu.obs.schema import validate_line as jax_validate  # noqa: E402,E501
from stateright_tpu_torch.models.paxos import PaxosDevice, PaxosSys  # noqa: E402,E501
from stateright_tpu_torch.obs import (NULL_OBS, anomaly, hist,  # noqa: E402
                                      slo, validate_line)
from stateright_tpu_torch.obs.flight import (FlightRecorder,  # noqa: E402
                                             postmortem_path)
from test_torch_obs_trace import DEVICE, _events, _port, _two_pc  # noqa: E402,E501


def _entries(seed=0, n=200):
    """Wave entries with latency gaps, overflow flags, I/O stalls, tier
    growth and sampled cost ratios: every attribution of the detector."""
    rng = random.Random(seed)
    out, t, host = [], 100.0, 0
    for i in range(n):
        slow = i > 20 and rng.random() < 0.08
        t += (0.25 if slow else 0.01) + rng.random() * 0.002
        entry = {"t": t, "kernel_path": rng.choice(["dedup_plain", None]),
                 "overflow": rng.random() < 0.02,
                 "io_stall_s": (0.2 if slow and rng.random() < 0.3
                                else 0.0),
                 "compiled": slow and rng.random() < 0.2,
                 "tier_host_bytes": host, "tier_disk_bytes": None,
                 "cost_ratio": (2.5 if slow and rng.random() < 0.3
                                else 1.0), "wave": i}
        if slow and rng.random() < 0.3:
            host += 4096
        out.append(entry)
    return out


class _Tracer:
    enabled = True

    def __init__(self):
        self.events = []

    def event(self, etype, **fields):
        self.events.append((etype, fields))


def _feed(mod, slo_mod, anomaly_mod, entries):
    obs = mod.WaveObs("classic", hist=mod.HistogramSet(),
                      slo=slo_mod.SloTracker(window_s=1e9),
                      anomaly=anomaly_mod.SlowWaveDetector(),
                      snap_s=1e9)
    tr = _Tracer()
    for e in entries:
        obs.wave(dict(e), tracer=tr)
    obs.job(queue_s=0.3, run_s=1.0, total_s=1.3, tracer=tr)
    obs.job(queue_s=0.9, run_s=2.5, total_s=3.4, ok=False, tracer=tr)
    obs.close(tr)
    return obs, tr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wave_obs_equal_jax(seed):
    """One stream of entries through both facades: the same histogram
    snapshots, quantiles, SLO status and breaches, anomaly verdicts, and
    exposition lines."""
    entries = _entries(seed)
    ours, tr = _feed(hist, slo, anomaly, entries)
    ref, ref_tr = _feed(ref_hist, ref_slo, ref_anomaly, entries)
    assert ours.hist.snapshot() == ref.hist.snapshot()
    for q in (0.5, 0.9, 0.99):
        got = ours.hist.quantile("wave_latency_seconds", q,
                                 engine="classic", kernel_path="none")
        assert got == ref.hist.quantile("wave_latency_seconds", q,
                                        engine="classic", kernel_path="none")
    assert ours.slo_status() == ref.slo_status()
    assert [v for k, v in tr.events if k == "slo_breach"] == [
        v for k, v in ref_tr.events if k == "slo_breach"]
    verdicts = [v for k, v in tr.events if k == "anomaly"]
    assert verdicts == [v for k, v in ref_tr.events if k == "anomaly"]
    assert verdicts and {v["cause"] for v in verdicts} <= {
        "compile", "io_stall", "spill", "cost_model", "unknown"}
    strip = [{k: v for k, v in a.items() if k != "at"}
             for a in ours.anomalies()]
    assert strip == [{k: v for k, v in a.items() if k != "at"}
                     for a in ref.anomalies()]
    assert (hist.prometheus_hist_lines(ours.hist.snapshot())
            == ref_hist.prometheus_hist_lines(ref.hist.snapshot()))
    assert (slo.prometheus_slo_lines(ours.slo_status())
            == ref_slo.prometheus_slo_lines(ref.slo_status()))
    assert [k for k, _ in tr.events] == [k for k, _ in ref_tr.events]


def test_histogram_units_equal_jax():
    """Buckets, merge, quantiles and series keys, value for value."""
    rng = random.Random(7)
    values = [rng.lognormvariate(-6, 2) for _ in range(500)] + [0.0, 100.0]
    a, b = hist.Histogram(), ref_hist.Histogram()
    for v in values:
        a.observe(v)
        b.observe(v)
    assert a.snapshot() == b.snapshot()
    assert hist.BUCKET_BOUNDS == ref_hist.BUCKET_BOUNDS
    for q in (0.0, 0.1, 0.5, 0.99, 1.0):
        assert a.quantile(q) == b.quantile(q)
    a.merge(a)
    b.merge(b)
    assert a.snapshot() == b.snapshot()
    key = hist.series_key("x", {"b": "2", "a": "1"})
    assert key == ref_hist.series_key("x", {"b": "2", "a": "1"})
    assert hist.parse_series_key(key) == ref_hist.parse_series_key(key)


@pytest.mark.parametrize("raw", ["1", "job_latency=0.25,window=30",
                                 "wave_success=0.9999,queue_wait=0.1,x=1"])
def test_slo_from_env_equal_jax(monkeypatch, raw):
    monkeypatch.setenv("STpu_SLO", raw)
    assert slo.slo_from_env().status() == ref_slo.slo_from_env().status()


@pytest.mark.parametrize("raw", ["1", "k=2,warmup=3", "alpha=0.5,floor=0"])
def test_detector_from_env_equal_jax(monkeypatch, raw):
    monkeypatch.setenv("STpu_ANOMALY", raw)
    ours, ref = anomaly.detector_from_env(), ref_anomaly.detector_from_env()
    assert (ours.k, ours.warmup, ours.alpha, ours.floor) == (
        ref.k, ref.warmup, ref.alpha, ref.floor)


def _disarm(monkeypatch):
    for var in ("STpu_TRACE", "STpu_HIST", "STpu_SLO", "STpu_ANOMALY",
                "STpu_PROF"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("engine", DEVICE + ("host_bfs",))
def test_armed_engines_snapshot_and_lint(tmp_path, monkeypatch, engine):
    """Every variable armed (snapshots at the 0.05 s floor): the facade
    is armed, its snapshots sum their buckets to their counts and lint
    clean, and a device engine's stats carry ``slo`` and
    ``anomalies``."""
    _disarm(monkeypatch)
    path = tmp_path / "t.jsonl"
    for var, val in (("STpu_TRACE", str(path)), ("STpu_HIST", "1"),
                     ("STpu_SLO", "1"), ("STpu_ANOMALY", "1"),
                     ("STpu_HIST_SNAP_S", "0.05")):
        monkeypatch.setenv(var, val)
    c = _port(engine, _two_pc(4, True), table_capacity=1 << 12) \
        if engine != "host_bfs" else _port(engine, _two_pc(4, True))
    assert c._wave_obs is not NULL_OBS
    assert c.unique_state_count() == 1568
    events = _events(path)
    snaps = [e for e in events if e["type"] == "hist_snapshot"]
    # A latency is the gap between two waves: one wave observes none.
    assert snaps or sum(e["type"] == "wave" for e in events) == 1
    for s in snaps:
        for data in s["hists"].values():
            assert sum(data["buckets"]) == data["count"]
    _, errors = trace_lint.lint_file(str(path))
    assert errors == [], errors[:3]
    if engine != "host_bfs":
        stats = c.scheduler_stats()
        assert stats["slo"]["objectives"]["wave_success"]["good"] > 0
        assert isinstance(stats["anomalies"], list)


class _Overflowing(PaxosSys):
    """Paxos at 1 client on two network slots: a delivery's sends
    overflow, and the error lane stops the run."""

    def device_model(self):
        return PaxosDevice(1, net_slots=2)


@pytest.mark.parametrize("spawn", [dict(device="cpu", waves_per_dispatch=1),
                                   dict(device="cpu", fused=False),
                                   dict(mesh=["cpu"] * 2,
                                        waves_per_dispatch=1)])
def test_failed_run_dumps_a_valid_postmortem(tmp_path, monkeypatch, spawn):
    """The run raises; its engine dumps its flight ring (on by default)
    under ``STpu_FLIGHT_DIR`` and names it ``flight_dump``; every line
    validates under JAX's schema and the port's, the lint accepts the
    dump, and with ``STpu_HIST`` set it ends with the final snapshot."""
    _disarm(monkeypatch)
    monkeypatch.delenv("STpu_FLIGHT", raising=False)
    monkeypatch.setenv("STpu_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("STpu_HIST", "1")
    c = _Overflowing(1).checker().spawn_cuda_bfs(batch_size=8, **spawn)
    with pytest.raises(RuntimeError, match="error lane"):
        c.join()
    assert c.flight_dump and os.path.dirname(c.flight_dump) == str(tmp_path)
    assert c.flight_dump.startswith(postmortem_path(
        f"{c._ENGINE_ID}-{os.getpid()}", str(tmp_path))[:-len(".jsonl")])
    lines = open(c.flight_dump, encoding="utf-8").read().splitlines()
    for line in lines:
        assert jax_validate(line) == [], line
        assert validate_line(line) == [], line
    events = [json.loads(line) for line in lines]
    assert events[0]["type"] == "postmortem"
    assert "error lane" in events[0]["reason"]
    assert any(e["type"] == "wave" for e in events[1:])
    assert events[-1]["type"] == "hist_snapshot"
    _, errors = trace_lint.lint_file(c.flight_dump)
    assert errors == [], errors[:3]


def test_flight_ring_is_bounded_and_stamped(tmp_path):
    """A ring of 4 keeps the last 4 entries, stamped as ``flight`` waves
    with every wave field at dump time; a second dump at the same name
    does not overwrite the first."""
    fr = FlightRecorder("classic", capacity=4, directory=str(tmp_path))
    for i in range(10):
        fr.record({"t": float(i), "states": i, "unique": i, "bucket": 1,
                   "waves": 1, "inflight": 0, "compiled": False,
                   "successors": 1, "candidates": 1, "novel": 1,
                   "out_rows": None, "capacity": None, "load_factor": None,
                   "overflow": False, "bytes_per_state": None,
                   "arena_bytes": None, "table_bytes": None})
    first, second = fr.dump("a"), fr.dump("b")
    assert first != second and os.path.exists(first)
    events = _events(second)
    assert [e["states"] for e in events[1:]] == [6, 7, 8, 9]
    for line in open(second, encoding="utf-8"):
        assert jax_validate(line) == [] and validate_line(line) == []
