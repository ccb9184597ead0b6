"""Deterministic latency histograms and the ``WaveObs`` facade.

The port's copy of ``stateright_tpu/obs/hist.py``: fixed power-of-two
bucket histograms (``BUCKET_BOUNDS``, mergeable by element-wise addition,
the same counts for the same observations), and :class:`WaveObs`, which
bundles them with the SLO tracker (``slo.py``) and the slow-wave
detector (``anomaly.py``), fed from the dispatch-log entries the engines
already build.

- **Disarmed is free.** ``wave_obs_from_env`` returns the shared
  :data:`NULL_OBS` when none of ``STpu_HIST`` / ``STpu_SLO`` /
  ``STpu_ANOMALY`` is set; engines guard with ``.enabled``.
- **Wave latency** is the gap between consecutive wave events of one
  producer.
- **Snapshots**: armed and traced, the facade emits a ``hist_snapshot``
  event at most every ``STpu_HIST_SNAP_S`` seconds (default 2), counts
  cumulative since the run's start, and one more at the end of the run;
  the flight recorder's dump appends the final snapshot.

Dependency-free beyond the sibling obs modules.
"""

from __future__ import annotations

import os
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional

from .schema import SCHEMA_VERSION

__all__ = [
    "HIST_ENV", "SNAP_ENV", "BUCKET_BOUNDS", "Histogram", "HistogramSet",
    "WaveObs", "NullWaveObs", "NULL_OBS", "wave_obs_from_env",
    "series_key", "parse_series_key", "bucket_quantile",
    "prometheus_hist_lines",
]

#: Environment knob: ``STpu_HIST=1`` arms the latency histograms.
#: Unset/``0`` contributes nothing to ``wave_obs_from_env``'s decision.
HIST_ENV = "STpu_HIST"

#: Environment knob: ``hist_snapshot`` emission cadence in seconds
#: (default 2.0). Snapshots only ever ride an enabled tracer — the
#: cadence bounds stream growth, not hot-loop cost.
SNAP_ENV = "STpu_HIST_SNAP_S"

_SNAP_DEFAULT_S = 2.0

#: Fixed log-bucket upper bounds (seconds): the power-of-two ladder
#: 2^-20 (~1 us) .. 2^6 (64 s), 27 finite buckets + implicit +Inf.
#: Fixed so histograms are deterministic and merge by element-wise
#: addition; wide enough that a sub-microsecond host wave and a
#: minute-long cold-compile dispatch both land in a real bucket.
BUCKET_BOUNDS: tuple = tuple(2.0 ** e for e in range(-20, 7))

#: Prometheus ``le`` label values for the finite bounds (exact, since
#: powers of two round-trip through float formatting losslessly).
_LE_LABELS: tuple = tuple(format(b, ".12g") for b in BUCKET_BOUNDS)


class Histogram:
    """One series: per-bucket counts (NOT cumulative — the snapshot
    invariant ``sum(buckets) == count`` stays a plain sum), plus the
    running sum and count. Not thread-safe on its own; the owning
    :class:`HistogramSet` serializes access."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self):
        self.counts: List[int] = [0] * (len(BUCKET_BOUNDS) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect_left(BUCKET_BOUNDS, value)] += 1
        self.sum += value
        self.count += 1

    def merge(self, other: "Histogram") -> None:
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count

    def quantile(self, q: float) -> Optional[float]:
        return bucket_quantile(self.counts, self.count, q)

    def snapshot(self) -> dict:
        return {"buckets": list(self.counts),
                "sum": round(self.sum, 9), "count": self.count}


def bucket_quantile(buckets: List[int], count: int,
                    q: float) -> Optional[float]:
    """The bucket-upper-bound quantile estimate for a (non-cumulative)
    bucket list over :data:`BUCKET_BOUNDS` — what trace_summary's
    p50/p99 columns print. None when empty; the +Inf bucket reports
    the last finite bound (the estimate saturates, it never invents)."""
    if count <= 0 or not buckets:
        return None
    rank = q * count
    cum = 0
    for i, c in enumerate(buckets):
        cum += c
        if cum >= rank and c:
            return BUCKET_BOUNDS[min(i, len(BUCKET_BOUNDS) - 1)]
    return BUCKET_BOUNDS[-1]


def series_key(name: str, labels: Dict[str, str]) -> str:
    """Prometheus-style series identity: ``name{k="v",...}`` with
    sorted label keys — one deterministic string both the snapshot
    event and the exporters key on."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_series_key(key: str):
    """``(name, labels)`` back out of :func:`series_key`'s format."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels: Dict[str, str] = {}
    for part in rest.rstrip("}").split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            labels[k] = v.strip('"')
    return name, labels


class HistogramSet:
    """A thread-safe registry of named, labeled histogram series."""

    def __init__(self):
        self._series: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def observe(self, name: str, value: float, **labels) -> None:
        key = series_key(name, labels)
        with self._lock:
            hist = self._series.get(key)
            if hist is None:
                hist = self._series[key] = Histogram()
            hist.observe(float(value))

    def snapshot(self) -> Dict[str, dict]:
        """``{series_key: {"buckets", "sum", "count"}}`` — the
        ``hist_snapshot`` payload. Sorted keys: deterministic JSON."""
        with self._lock:
            return {k: self._series[k].snapshot()
                    for k in sorted(self._series)}

    def quantile(self, name: str, q: float, **labels) -> Optional[float]:
        with self._lock:
            hist = self._series.get(series_key(name, labels))
            return hist.quantile(q) if hist is not None else None


def prometheus_hist_lines(snapshot: Dict[str, dict],
                          prefix: str = "stpu_") -> List[str]:
    """Prometheus exposition lines (``_bucket``/``_sum``/``_count``,
    cumulative ``le`` buckets) for one snapshot payload — shared by
    ``tools/trace_export.py`` and the live ``GET /.metrics``."""
    lines: List[str] = []
    typed = set()
    for key in sorted(snapshot):
        name, labels = parse_series_key(key)
        data = snapshot[key]
        buckets = data.get("buckets") or []
        family = f"{prefix}{name}"
        if family not in typed:
            typed.add(family)
            lines.append(f"# TYPE {family} histogram")
        base = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        sep = "," if base else ""
        cum = 0
        for i, le in enumerate(_LE_LABELS):
            cum += buckets[i] if i < len(buckets) else 0
            lines.append(f'{family}_bucket{{{base}{sep}le="{le}"}} {cum}')
        cum += buckets[len(_LE_LABELS)] if len(buckets) > len(_LE_LABELS) \
            else 0
        lines.append(f'{family}_bucket{{{base}{sep}le="+Inf"}} {cum}')
        suffix = f"{{{base}}}" if base else ""
        lines.append(f"{family}_sum{suffix} {data.get('sum', 0)}")
        lines.append(f"{family}_count{suffix} {data.get('count', 0)}")
    return lines


class NullWaveObs:
    """The disarmed facade: every method a no-op, ``enabled`` False.
    Hot paths must check ``enabled`` BEFORE calling ``wave`` — the
    disarmed-cost test poisons these methods, so a stray call (= a
    stray per-wave cost with the subsystem off) fails the suite."""

    __slots__ = ()
    enabled = False
    hist = None
    slo = None
    anomaly = None

    def wave(self, entry, tracer=None, flight=None, wait_s=None) -> None:
        pass

    def job(self, queue_s, run_s, total_s, ok=True, engine="service",
            tracer=None, flight=None) -> None:
        pass

    def elastic_report(self, worker, compute_s, wait_s) -> None:
        pass

    def maybe_snapshot(self, tracer, now=None) -> None:
        pass

    def final_snapshot_event(self) -> Optional[dict]:
        return None

    def close(self, tracer=None) -> None:
        pass

    def slo_status(self) -> Optional[dict]:
        return None

    def anomalies(self) -> list:
        return []

    @property
    def healthy(self) -> bool:
        return True


#: The shared disarmed facade (``wave_obs_from_env`` returns this very
#: object when no observability knob is set — identity-testable).
NULL_OBS = NullWaveObs()


class WaveObs:
    """Per-producer service-observability bundle: histograms + SLO
    tracker + anomaly detector, fed from the wave entries (and job
    timestamps) the producer already builds.

    Each armed component is optional — ``STpu_HIST`` / ``STpu_SLO`` /
    ``STpu_ANOMALY`` arm them independently; the facade exists iff at
    least one is set. One instance per producer (engine, service, mux
    group, elastic worker/coordinator); never shared across engines,
    so the wave-gap latency is per producer by construction.
    """

    enabled = True

    def __init__(self, producer: str, hist: Optional[HistogramSet] = None,
                 slo=None, anomaly=None, snap_s: float = _SNAP_DEFAULT_S):
        self.producer = str(producer)
        self.hist = hist
        self.slo = slo
        self.anomaly = anomaly
        self.snap_s = max(0.05, float(snap_s))
        self._lock = threading.Lock()
        self._last_t: Optional[float] = None
        self._last_snap = time.monotonic()
        self._snap = 0

    # -- Observation points ------------------------------------------------

    def wave(self, entry: dict, tracer=None, flight=None,
             wait_s: Optional[float] = None) -> None:
        """One wave event's worth of observations. ``entry`` is the
        producer's dispatch-log dict (the same one the tracer and the
        flight ring get); dispatch latency is the gap to the previous
        wave of THIS producer — trace_export's slice semantic."""
        now = entry.get("t")
        if not isinstance(now, (int, float)):
            now = time.monotonic()
        with self._lock:
            prev, self._last_t = self._last_t, now
        dur = now - prev if (prev is not None and now >= prev) else None
        kp = entry.get("kernel_path") or "none"
        if self.hist is not None:
            if dur is not None:
                self.hist.observe("wave_latency_seconds", dur,
                                  engine=self.producer, kernel_path=kp)
            io = entry.get("io_stall_s")
            if isinstance(io, (int, float)) and io > 0:
                self.hist.observe("io_stall_seconds", float(io),
                                  engine=self.producer)
        if self.slo is not None:
            breach = self.slo.observe(
                "wave_success", ok=not bool(entry.get("overflow")), t=now)
            self._emit_breach(breach, tracer, flight)
        if self.anomaly is not None and dur is not None:
            evt = self.anomaly.observe(f"{self.producer}|{kp}", dur,
                                       entry, wait_s=wait_s)
            if evt is not None:
                if tracer is not None and tracer.enabled:
                    tracer.event("anomaly", **evt)
                if flight is not None and flight.armed:
                    flight.record_event("anomaly", **evt)
        self.maybe_snapshot(tracer, now=None)

    def job(self, queue_s: float, run_s: float, total_s: float,
            ok: bool = True, engine: str = "service",
            tracer=None, flight=None) -> None:
        """One finished/aborted job's worth of observations (the
        service's ``_finish`` path — cold relative to waves)."""
        if self.hist is not None:
            self.hist.observe("job_queue_seconds", queue_s, engine=engine)
            self.hist.observe("job_run_seconds", run_s, engine=engine)
            self.hist.observe("job_latency_seconds", total_s,
                              engine=engine)
        if self.slo is not None:
            self._emit_breach(
                self.slo.observe("queue_wait", value=queue_s),
                tracer, flight)
            self._emit_breach(
                self.slo.observe("job_latency",
                                 value=total_s if ok else float("inf")),
                tracer, flight)
        self.maybe_snapshot(tracer)

    def elastic_report(self, worker: str, compute_s: float,
                       wait_s: float) -> None:
        """One worker-round segment from the straggler attribution
        (``obs/collect.py``) — the compute-vs-wait distribution."""
        if self.hist is not None:
            self.hist.observe("elastic_compute_seconds", compute_s,
                              worker=str(worker))
            self.hist.observe("elastic_wait_seconds", wait_s,
                              worker=str(worker))

    # -- Snapshots ---------------------------------------------------------

    def maybe_snapshot(self, tracer, now: Optional[float] = None) -> None:
        """Emits a ``hist_snapshot`` through an enabled tracer at the
        bounded cadence. Wall-clock gated (not event-count gated), so
        a fast producer cannot flood the stream."""
        if self.hist is None or tracer is None or not tracer.enabled:
            return
        now = time.monotonic() if now is None else now
        with self._lock:
            if now - self._last_snap < self.snap_s:
                return
            self._last_snap = now
            self._snap += 1
            snap = self._snap
        hists = self.hist.snapshot()
        if hists:
            tracer.event("hist_snapshot", hists=hists, snap=snap)

    def final_snapshot_event(self) -> Optional[dict]:
        """A fully-stamped ``hist_snapshot`` for consumers with no
        tracer in hand — the flight recorder's dump hook, so a
        postmortem carries the distribution at time of death."""
        if self.hist is None:
            return None
        hists = self.hist.snapshot()
        if not hists:
            return None
        with self._lock:
            self._snap += 1
            snap = self._snap
        return {"type": "hist_snapshot", "schema_version": SCHEMA_VERSION,
                "engine": self.producer, "run": f"hist-{self.producer}",
                "t": round(time.monotonic(), 6), "hists": hists,
                "snap": snap}

    def close(self, tracer=None) -> None:
        """Final snapshot at producer teardown (cold path), so a short
        run that never crossed the cadence still lands one."""
        if self.hist is None or tracer is None or not tracer.enabled:
            return
        hists = self.hist.snapshot()
        if not hists:
            return
        with self._lock:
            self._snap += 1
            snap = self._snap
        tracer.event("hist_snapshot", hists=hists, snap=snap)

    # -- Surfaces ----------------------------------------------------------

    def _emit_breach(self, breach: Optional[dict], tracer, flight) -> None:
        if breach is None:
            return
        if tracer is not None and tracer.enabled:
            tracer.event("slo_breach", **breach)
        if flight is not None and flight.armed:
            flight.record_event("slo_breach", **breach)

    def slo_status(self) -> Optional[dict]:
        return self.slo.status() if self.slo is not None else None

    def anomalies(self) -> list:
        return self.anomaly.recent() if self.anomaly is not None else []

    @property
    def healthy(self) -> bool:
        return self.slo.healthy if self.slo is not None else True


def wave_obs_from_env(producer: str):
    """The facade factory every producer uses: the shared
    :data:`NULL_OBS` when no knob is set (no allocation, one attribute
    check per wave); an armed :class:`WaveObs` otherwise, with exactly
    the components whose knobs are set."""
    hist_on = os.environ.get(HIST_ENV, "") not in ("", "0")
    from .anomaly import detector_from_env
    from .slo import slo_from_env

    slo = slo_from_env()
    anomaly = detector_from_env()
    if not hist_on and slo is None and anomaly is None:
        return NULL_OBS
    try:
        snap_s = float(os.environ.get(SNAP_ENV, "") or _SNAP_DEFAULT_S)
    except ValueError:
        snap_s = _SNAP_DEFAULT_S
    return WaveObs(producer, hist=HistogramSet() if hist_on else None,
                   slo=slo, anomaly=anomaly, snap_s=snap_s)
