"""The port's run telemetry (``stateright_tpu_torch/obs``) against JAX's.

Pinned here, on the CPU:

- **The same stream.** Each of the six engines (the host BFS and DFS,
  the classic, fused, classic sharded and sharded fused device engines)
  runs the same model in JAX and in the port with ``STpu_TRACE`` set on
  both sides. Every port line passes JAX's ``validate_line`` and the
  port's copy, ``tools/trace_lint.py`` lints the port's file clean, the
  wave events equal JAX's field for field but for the clock fields
  (``_CLOCK``) and ``kernel_path`` (held to ``KERNEL_PATHS`` instead),
  and the other events equal JAX's in type, order and every field that
  is not a clock reading or a path.
- **Every event of the engines** (``test_torch_obs_events.py``):
  ``grow``, ``overflow_redispatch``, ``ckpt_begin`` / ``ckpt_done``, the
  ``matmul_ops`` gauge, and the tiered store's ``spill`` / ``page_in`` /
  ``pressure`` under JAX's ``TIER_CFGS``.
- **Disarmed is free**: with no variable set every engine holds the
  shared null tracer, wave-obs facade and profiler (and, under
  ``STpu_FLIGHT=0``, the null recorder), whose methods are poisoned.
"""

import json
import os
import subprocess
import sys

import pytest

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "examples"))
sys.path.insert(0, os.path.join(_REPO, "tools"))

import stateright_tpu.tpu  # noqa: F401,E402  (enables x64)
import paxos as ref_paxos  # noqa: E402
import trace_lint  # noqa: E402
import two_phase_commit as ref_model  # noqa: E402
from stateright_tpu.obs.schema import validate_line as jax_validate  # noqa: E402,E501
from stateright_tpu_torch.models import twopc  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosSys  # noqa: E402
from stateright_tpu_torch.obs import (NULL_OBS, NULL_PROF,  # noqa: E402
                                      NULL_RECORDER, NULL_TRACER,
                                      SCHEMA_VERSION, WAVE_FIELDS,
                                      NullTracer, RunTracer, validate_event,
                                      validate_line)
from stateright_tpu_torch.obs.flight import NullFlightRecorder  # noqa: E402
from stateright_tpu_torch.obs.hist import NullWaveObs  # noqa: E402
from stateright_tpu_torch.obs.prof import NullWaveProfiler  # noqa: E402

ENGINES = ("host_bfs", "host_dfs", "classic", "fused", "sharded",
           "sharded_fused")
DEVICE = ("classic", "fused", "sharded", "sharded_fused")

#: the wave fields that read a clock or a run's identity, or that only
#: one side can fill: the run id, the time, a compile (JAX) or a graph
#: capture (the port), the loop's I/O stall, and the profiler's costs
#: (XLA's cost model in JAX, the kernels' declared costs in the port)
_CLOCK = {"t", "run", "compiled", "io_stall_s", "cost_flops", "cost_bytes",
          "cost_ratio"}

#: ``kernel_path``'s vocabulary on the CPU, JAX's
#: (``tpu/engine.py:908-948``) against the port's (``fused.py:550-560``,
#: ``sharded.py``, ``sharded_fused.py``): JAX's op ladder is the port's
#: torch stages around kernel 1's plain version; JAX's interpret-mode
#: megakernel is the port's plain version of kernel 2, or of kernel 3 on
#: the sharded engines. ``+matmul`` rides either.
KERNEL_PATHS = {("xla", False): "dedup_plain", ("xla", True): "dedup_plain",
                ("interpret", False): "megakernel_plain",
                ("interpret", True): "sender_plain"}

#: the non-wave events' fields that read a clock or name a file
_EVENT_CLOCK = {"t", "run", "engine", "schema_version", "meta", "dur",
                "counters", "unix_t", "path", "write_s"}


def _events(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _jax(engine, build, **kw):
    """JAX's run of ``engine`` on the checker builder ``build()``."""
    b = build()
    if engine == "host_bfs":
        return b.spawn_bfs().join()
    if engine == "host_dfs":
        return b.spawn_dfs().join()
    kw = dict(pack_arena=True, batch_size=32, **kw)
    if engine in ("classic", "sharded"):
        kw["fused"] = False
    else:
        kw["inflight_dispatches"] = 1
    if engine.startswith("sharded"):
        kw["sharded"] = True
    return b.spawn_tpu_bfs(**kw).join()


def _port(engine, build, **kw):
    """The port's run of ``engine`` with the same knobs, on the CPU (the
    sharded engines on 8 stacked shards, JAX's 8 host devices)."""
    b = build()
    if engine == "host_bfs":
        return b.spawn_bfs().join()
    if engine == "host_dfs":
        return b.spawn_dfs().join()
    kw = dict(batch_size=32, **kw)
    if engine in ("classic", "sharded"):
        kw["fused"] = False
    else:
        kw["inflight_dispatches"] = 1
    if engine.startswith("sharded"):
        kw["mesh"] = ["cpu"] * 8
    else:
        kw["device"] = "cpu"
    return b.spawn_cuda_bfs(**kw).join()


def _traced(monkeypatch, path, run, *args, **kw):
    monkeypatch.setenv("STpu_TRACE", str(path))
    try:
        c = run(*args, **kw)
    finally:
        monkeypatch.delenv("STpu_TRACE")
    return c, _events(path)


def _same_streams(engine, ref, ours, port_path):
    """The port's stream against JAX's, as the module docstring says;
    returns the non-wave event types in order."""
    lines = open(port_path, encoding="utf-8").read().splitlines()
    for line in lines:
        assert jax_validate(line) == [], line
        assert validate_line(line) == [], line
    counts, errors = trace_lint.lint_file(str(port_path))
    assert errors == [], errors[:3]
    assert all(e["engine"] == engine for e in ours)
    waves_ref = [e for e in ref if e["type"] == "wave"]
    waves = [e for e in ours if e["type"] == "wave"]
    assert waves and len(waves) == len(waves_ref)
    sharded = engine.startswith("sharded")
    for w, r in zip(waves, waves_ref):
        assert set(w) == set(WAVE_FIELDS)
        assert ({k: v for k, v in w.items() if k not in _CLOCK
                 and k != "kernel_path"}
                == {k: v for k, v in r.items() if k not in _CLOCK
                    and k != "kernel_path"})
        if r["kernel_path"] is None:
            assert w["kernel_path"] is None
        else:
            base, plus, suffix = r["kernel_path"].partition("+")
            assert w["kernel_path"] == (KERNEL_PATHS[base, sharded]
                                        + plus + suffix)
    rest_ref = [{k: v for k, v in e.items() if k not in _EVENT_CLOCK}
                for e in ref if e["type"] != "wave"]
    rest = [{k: v for k, v in e.items() if k not in _EVENT_CLOCK}
            for e in ours if e["type"] != "wave"]
    assert rest == rest_ref
    return [e["type"] for e in rest]


def _two_pc(rms, port):
    return (lambda: (twopc if port else ref_model).TwoPhaseSys(rms)
            .checker())


@pytest.mark.parametrize("engine", ENGINES)
def test_streams_equal_jax_2pc(tmp_path, monkeypatch, engine):
    """2pc at 3 RMs: the same counts, and the port's stream is JAX's."""
    ref_c, ref = _traced(monkeypatch, tmp_path / "jax.jsonl", _jax, engine,
                         _two_pc(3, False))
    c, ours = _traced(monkeypatch, tmp_path / "port.jsonl", _port, engine,
                      _two_pc(3, True))
    assert ((c.unique_state_count(), c.state_count())
            == (ref_c.unique_state_count(), ref_c.state_count())
            == (288, 1146))
    types = _same_streams(engine, ref, ours, tmp_path / "port.jsonl")
    assert types[0] == "run_start" and types[-1] == "run_end"
    waves = [e for e in ours if e["type"] == "wave"]
    assert waves[-1]["unique"] == 288 and waves[-1]["states"] == 1146
    assert sum(w["novel"] for w in waves) == 287
    assert sum(w["successors"] for w in waves) == 1145


@pytest.mark.parametrize("engine", ["classic", "fused"])
def test_streams_equal_jax_paxos(tmp_path, monkeypatch, engine):
    """Paxos at 1 client (3 servers): the stream is JAX's."""
    ref_c, ref = _traced(
        monkeypatch, tmp_path / "jax.jsonl", _jax, engine,
        lambda: ref_paxos.PaxosModelCfg(1, 3).into_model().checker())
    c, ours = _traced(monkeypatch, tmp_path / "port.jsonl", _port, engine,
                      lambda: PaxosSys(1).checker())
    assert c.unique_state_count() == ref_c.unique_state_count() == 265
    _same_streams(engine, ref, ours, tmp_path / "port.jsonl")


@pytest.mark.parametrize("engine", DEVICE)
def test_wave_kernel_streams_equal_jax(tmp_path, monkeypatch, engine):
    """``wave_kernel=True`` (JAX's interpret-mode kernels against the
    port's plain versions of kernels 2 and 3): the stream is JAX's, its
    ``kernel_path`` mapped."""
    _, ref = _traced(monkeypatch, tmp_path / "jax.jsonl", _jax, engine,
                     _two_pc(3, False), wave_kernel=True)
    _, ours = _traced(monkeypatch, tmp_path / "port.jsonl", _port, engine,
                      _two_pc(3, True), wave_kernel=True)
    _same_streams(engine, ref, ours, tmp_path / "port.jsonl")
    assert {e["kernel_path"] for e in ours if e["type"] == "wave"} == {
        "sender_plain" if engine.startswith("sharded")
        else "megakernel_plain"}


def test_trace_lint_cli_on_a_port_trace(tmp_path, monkeypatch):
    """``tools/trace_lint.py`` as a program exits 0 on a port trace of
    every engine, appended to one file as ``STpu_TRACE`` allows."""
    path = tmp_path / "all.jsonl"
    monkeypatch.setenv("STpu_TRACE", str(path))
    for engine in ENGINES:
        _port(engine, _two_pc(3, True))
    monkeypatch.delenv("STpu_TRACE")
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, "tools", "trace_lint.py"),
         str(path)], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=_REPO, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")
    assert {e["engine"] for e in _events(path)} == set(ENGINES)


def _poison(monkeypatch, cls, names, what):
    def boom(name):
        def poisoned(self, *a, **k):
            raise AssertionError(f"{cls.__name__}.{name} called with "
                                 f"{what} disarmed")
        return poisoned

    for name in names:
        monkeypatch.setattr(cls, name, boom(name))


@pytest.mark.parametrize("engine", ENGINES)
def test_trace_disabled_zero_events_zero_allocations(monkeypatch, engine):
    """No variable set and ``STpu_FLIGHT=0``: every engine holds the
    shared null tracer, wave-obs facade, profiler and recorder, and its
    loop never calls into them (every null method is poisoned)."""
    for var in ("STpu_TRACE", "STpu_PROF", "STpu_HIST", "STpu_SLO",
                "STpu_ANOMALY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("STpu_FLIGHT", "0")
    _poison(monkeypatch, NullTracer,
            ("wave", "event", "counter", "gauge", "span_event"), "tracing")
    _poison(monkeypatch, NullWaveObs, ("wave", "job", "maybe_snapshot"),
            "the wave-obs facade")
    _poison(monkeypatch, NullWaveProfiler,
            ("capture", "should_sample", "wave", "stats"), "profiling")
    _poison(monkeypatch, NullFlightRecorder,
            ("record", "record_event", "dump"), "the flight recorder")
    c = _port(engine, _two_pc(3, True))
    assert c.unique_state_count() == 288
    assert c._tracer is NULL_TRACER and c._wave_obs is NULL_OBS
    if engine in DEVICE:
        assert c._prof is NULL_PROF and c._flight is NULL_RECORDER
        stats = c.scheduler_stats()
        assert stats["prof"] is None and stats["slo"] is None
        assert stats["anomalies"] == []
        assert all(e.get("cost_flops") is None for e in c.dispatch_log)


def test_tracer_spans_counters_nested(tmp_path):
    """The port's ``RunTracer``: nested spans, accumulating counters,
    gauges, an idempotent close with the counter totals in ``run_end``."""
    tr = RunTracer(str(tmp_path / "t.jsonl"), "classic", meta={"k": 1})
    with tr.span("outer"):
        with tr.span("inner", detail="x"):
            pass
    tr.counter("widgets", 2)
    tr.counter("widgets", 3)
    tr.gauge("pressure", 0.5)
    tr.close()
    tr.close()
    events = _events(tmp_path / "t.jsonl")
    assert [e["type"] for e in events] == [
        "run_start", "span", "span", "counter", "counter", "gauge",
        "run_end"]
    for e in events:
        assert validate_event(e) == [] and e["schema_version"] == 14
    inner, outer = events[1], events[2]
    assert (inner["name"], inner["depth"]) == ("inner", 1)
    assert (outer["name"], outer["depth"]) == ("outer", 0)
    assert inner["attrs"] == {"detail": "x"}
    assert events[4]["value"] == 5
    assert events[-1]["counters"] == {"widgets": 5}


def test_the_schema_is_jax_s():
    """The port's schema is JAX's, field for field and version for
    version."""
    from stateright_tpu.obs import schema as ref
    from stateright_tpu_torch.obs import schema as ours

    assert ours.SCHEMA_VERSION == ref.SCHEMA_VERSION == SCHEMA_VERSION
    assert ours.WAVE_FIELDS == ref.WAVE_FIELDS
    assert ours.EVENT_TYPES == ref.EVENT_TYPES
    assert ours.ENGINE_IDS == ref.ENGINE_IDS
    assert ours.SHED_REASONS == ref.SHED_REASONS
    assert ours._WAVE_FIELDS_BY_VERSION == ref._WAVE_FIELDS_BY_VERSION
    assert jax.devices()  # the reference side ran on the conftest's mesh
