"""Continuous wave profiler: declared kernel costs and roofline gauges.

The port's copy of ``stateright_tpu/obs/prof.py``, with one change of
design. A compiled XLA program has a ``cost_analysis()``; a CUDA graph
has nothing like it. So each kernel wrapper declares its work instead
(``table.dedup_cost``, ``wave.wave_cost``, ``wave.sender_cost``,
``append.append_cost``: the bytes the kernel must move and the 32-bit
integer operations it does at its shapes), and an engine's program
record is built from them:

1. **Static cost records.** A dispatch graph's record is the sum of the
   declared costs of the kernels it launches, at the shape's full work
   (every row valid, every successor a candidate: the most the shape can
   move). A program of torch stages alone records ``null`` flops and
   bytes, as JAX records a program that never AOT-compiled.
   ``peak_bytes`` is the growth of ``torch.cuda.max_memory_allocated()``
   over the program's first run (``null`` on the CPU). Records live in a
   process-wide table keyed by the canonical program key, as in JAX.
   The schema's ``flops`` fields hold the integer operations.
2. **Sampled timing.** Every Nth dispatch (``STpu_PROF_SAMPLE``, default
   32) and the first dispatch of every program key is timed: on the card
   by CUDA events recorded around its launch or replay (``mark``), read
   at the engine's next stats read, which waits for the dispatch anyway,
   so no synchronisation is added; on the CPU by ``time.perf_counter``
   around the call. The measured seconds against the record give the
   roofline gauges of a ``profile_snapshot`` event and the wave fields
   ``cost_flops`` / ``cost_bytes`` / ``cost_ratio``.
3. **Roofline share.** ``roofline`` adds ``bound_s``, the least time the
   card could take for the record's work (the larger of its bytes over
   :data:`HBM_BYTES_PER_S` and its operations over :data:`OPS_PER_S`,
   an H100 SXM's data sheet rates), and ``share``, ``bound_s`` over the
   measured seconds. A dispatch's measured time includes its torch
   stages and launch gaps, so the share is that of the whole program.

``cost_ratio`` is the sampled seconds over the program key's own first
sample: 1.0 at the baseline, rising when the same program gets slower.

Disarmed (``STpu_PROF`` unset): ``prof_from_env`` returns the shared
:data:`NULL_PROF` and an engine pays one attribute check a dispatch.

Dependency-free but for ``mark``/``elapsed_s``, which import torch when
given a CUDA device.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "PROF_ENV", "PROF_SAMPLE_ENV", "HBM_BYTES_PER_S", "OPS_PER_S",
    "WaveProfiler", "NullWaveProfiler", "NULL_PROF", "prof_from_env",
    "cost_record", "sum_costs", "roofline", "program_records",
    "clear_program_records", "prometheus_prof_lines", "mark", "elapsed_s",
]

#: Environment knob: ``STpu_PROF=1`` arms the continuous profiler.
#: Unset/``0`` means the shared null profiler — one attribute check
#: per dispatch.
PROF_ENV = "STpu_PROF"

#: Environment knob: sample every Nth dispatch (default 32). ``1``
#: times every dispatch; the first dispatch of each program key is
#: always sampled regardless.
PROF_SAMPLE_ENV = "STpu_PROF_SAMPLE"

_SAMPLE_DEFAULT = 32

#: The card's memory rate and its 32-bit integer issue rate (H100 SXM,
#: NVIDIA's data sheet: 3.35 TB/s; 67 T float32 operations a second
#: outside the tensor cores, which bounds the integer rate too).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

#: Process-wide static cost records: canonical program key ->
#: ``{"flops", "bytes", "peak_bytes", "kernel_path"}``.
_COST_LOCK = threading.Lock()
_COST_RECORDS: Dict[str, dict] = {}


def sum_costs(costs) -> Optional[dict]:
    """The sum of declared kernel costs (each ``{"bytes", "ops"}``), or
    None when there are none (a program of torch stages alone)."""
    costs = [c for c in costs if c is not None]
    if not costs:
        return None
    return {"bytes": sum(int(c["bytes"]) for c in costs),
            "ops": sum(int(c["ops"]) for c in costs)}


def cost_record(cost, peak_bytes: Optional[int] = None) -> dict:
    """A program's static record from its declared cost
    (``{"bytes", "ops"}`` or None): ``{"flops", "bytes", "peak_bytes",
    "kernel_path": None}``, with null flops and bytes for None."""
    if cost is None:
        return {"flops": None, "bytes": None, "peak_bytes": peak_bytes,
                "kernel_path": None}
    return {"flops": float(cost["ops"]), "bytes": float(cost["bytes"]),
            "peak_bytes": peak_bytes, "kernel_path": None}


def roofline(rec: Optional[dict], measured_s: float) -> dict:
    """The roofline gauges of one measured run of a program with the
    static record ``rec``: achieved operations and bytes a second,
    intensity (operations a byte), the bound ``bound_s`` at the card's
    peaks and the ``share`` of it the run reached. All None without a
    record."""
    out = {"flops": None, "bytes": None, "peak_bytes": None,
           "flops_per_s": None, "bytes_per_s": None, "intensity": None,
           "bound_s": None, "share": None}
    if not rec:
        return out
    flops, byts = rec.get("flops"), rec.get("bytes")
    out["flops"], out["bytes"] = flops, byts
    out["peak_bytes"] = rec.get("peak_bytes")
    if isinstance(flops, (int, float)) and measured_s > 0:
        out["flops_per_s"] = round(flops / measured_s, 3)
    if isinstance(byts, (int, float)) and measured_s > 0:
        out["bytes_per_s"] = round(byts / measured_s, 3)
    if isinstance(flops, (int, float)) and isinstance(byts, (int, float)) \
            and byts > 0:
        out["intensity"] = round(flops / byts, 6)
    if isinstance(flops, (int, float)) and isinstance(byts, (int, float)):
        bound = max(byts / HBM_BYTES_PER_S, flops / OPS_PER_S)
        out["bound_s"] = round(bound, 9)
        if measured_s > 0:
            out["share"] = round(bound / measured_s, 6)
    return out


def mark(device):
    """A timing mark for a dispatch about to launch (or just launched)
    on ``device``: a recorded CUDA event on the card (no
    synchronisation), ``time.perf_counter()`` elsewhere."""
    if getattr(device, "type", None) == "cuda":
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def elapsed_s(start, end) -> float:
    """Seconds between two ``mark``s. On the card the end event must
    have completed: the engines read it after their stats read, which
    waited for the dispatch."""
    if isinstance(start, float):
        return end - start
    return start.elapsed_time(end) / 1e3


def program_records(prefix: Optional[str] = None) -> Dict[str, dict]:
    """A copy of the process-wide cost-record table, optionally
    filtered to keys starting with ``prefix``."""
    with _COST_LOCK:
        return {k: dict(v) for k in sorted(_COST_RECORDS)
                if prefix is None or k.startswith(prefix)
                for v in (_COST_RECORDS[k],)}


def clear_program_records() -> None:
    """Drops every static record (tests only)."""
    with _COST_LOCK:
        _COST_RECORDS.clear()


def has_record(key: str) -> bool:
    with _COST_LOCK:
        return key in _COST_RECORDS


class NullWaveProfiler:
    """The disarmed profiler: every method a no-op, ``enabled`` False.
    Hot paths check ``enabled`` before calling anything."""

    __slots__ = ()
    enabled = False
    armed = False

    def capture(self, key, cost, peak_bytes=None) -> None:
        pass

    def should_sample(self, key=None) -> bool:
        return False

    def wave(self, entry, key=None, measured_s=None, tracer=None,
             flight=None) -> None:
        pass

    def stats(self) -> dict:
        return {}

    def close(self, tracer=None) -> None:
        pass


#: The shared disarmed profiler (``prof_from_env`` returns this very
#: object when ``STpu_PROF`` is unset — identity-testable).
NULL_PROF = NullWaveProfiler()


class WaveProfiler:
    """Per-producer continuous profiler: capture a program's declared
    cost once, sample at dispatch, stamp at the wave event. The sampling
    cadence and the snapshot ordinal are per producer; the cost table is
    process-wide."""

    enabled = True
    armed = True

    def __init__(self, producer: str, sample_every: int = _SAMPLE_DEFAULT):
        self.producer = str(producer)
        self.sample_every = max(1, int(sample_every))
        self._lock = threading.Lock()
        self._dispatches = 0
        self._sampled = 0
        self._snap = 0
        self._captured = 0
        #: per-key first sampled seconds — the cost_ratio denominator.
        self._baseline: Dict[str, float] = {}
        #: per-key latest snapshot payload.
        self._last: Dict[str, dict] = {}
        #: keys that have had at least one sampled dispatch.
        self._seen: set = set()

    def capture(self, key: str, cost, peak_bytes: Optional[int] = None
                ) -> None:
        """Records the declared ``cost`` (``{"bytes", "ops"}``, or None
        for a program of torch stages) under ``key`` if no record exists
        yet."""
        with _COST_LOCK:
            if key in _COST_RECORDS:
                return
            _COST_RECORDS[key] = cost_record(cost, peak_bytes)
        with self._lock:
            self._captured += 1

    def should_sample(self, key: Optional[str] = None) -> bool:
        """One call per dispatch (armed paths only). True every
        ``sample_every``-th dispatch, and always on the first dispatch
        of a new program key. Deterministic."""
        with self._lock:
            n = self._dispatches
            self._dispatches += 1
            first = key is not None and key not in self._seen
            if key is not None:
                self._seen.add(key)
        return first or n % self.sample_every == 0

    def wave(self, entry: dict, key: Optional[str] = None,
             measured_s: Optional[float] = None, tracer=None,
             flight=None) -> None:
        """Stamps the cost fields onto one dispatch-log entry and, when
        the dispatch was sampled (``measured_s`` set), emits a
        ``profile_snapshot`` event with the roofline gauges."""
        rec = None
        if key is not None:
            with _COST_LOCK:
                rec = _COST_RECORDS.get(key)
            if rec is not None and rec.get("kernel_path") is None:
                kp = entry.get("kernel_path")
                if kp is not None:
                    with _COST_LOCK:
                        rec["kernel_path"] = kp
        entry["cost_flops"] = rec.get("flops") if rec else None
        entry["cost_bytes"] = rec.get("bytes") if rec else None
        ratio = None
        if measured_s is not None and key is not None:
            measured_s = max(float(measured_s), 1e-9)
            if math.isfinite(measured_s):
                with self._lock:
                    base = self._baseline.get(key)
                    if base is None:
                        base = self._baseline[key] = measured_s
                    self._sampled += 1
                    self._snap += 1
                    snap = self._snap
                ratio = round(measured_s / base, 6)
                evt = dict(roofline(rec, measured_s), key=key,
                           kernel_path=entry.get("kernel_path"),
                           expand_impl=entry.get("expand_impl"),
                           snap=snap, measured_s=round(measured_s, 6),
                           cost_ratio=ratio)
                with self._lock:
                    self._last[key] = dict(evt)
                if tracer is not None and tracer.enabled:
                    tracer.event("profile_snapshot", **evt)
                if flight is not None and flight.armed:
                    flight.record_event("profile_snapshot", **evt)
        entry["cost_ratio"] = ratio

    def stats(self) -> dict:
        """The aggregated view ``scheduler_stats()["prof"]`` shows."""
        with self._lock:
            last = {k: dict(self._last[k]) for k in sorted(self._last)}
            return {"dispatches": self._dispatches,
                    "sampled": self._sampled,
                    "sample_every": self.sample_every,
                    "captured": self._captured,
                    "programs": last}

    def close(self, tracer=None) -> None:
        """Nothing is held back: snapshots are emitted per sample."""


def prometheus_prof_lines(stats: dict, producer: str,
                          prefix: str = "stpu_") -> List[str]:
    """Prometheus exposition lines for one profiler's ``stats()``
    payload — the ``stpu_prof_*`` families."""
    if not stats:
        return []
    esc = str(producer).replace('"', "'")
    lines = [
        f'{prefix}prof_dispatches_total{{engine="{esc}"}} '
        f'{int(stats.get("dispatches") or 0)}',
        f'{prefix}prof_sampled_total{{engine="{esc}"}} '
        f'{int(stats.get("sampled") or 0)}',
        f'{prefix}prof_programs{{engine="{esc}"}} '
        f'{len(stats.get("programs") or {})}',
    ]
    for key, snap in sorted((stats.get("programs") or {}).items()):
        kesc = str(key).replace('"', "'")
        base = f'engine="{esc}",key="{kesc}"'
        for field, family in (("flops", "prof_flops"),
                              ("bytes", "prof_bytes"),
                              ("flops_per_s", "prof_flops_per_s"),
                              ("bytes_per_s", "prof_bytes_per_s"),
                              ("intensity", "prof_intensity"),
                              ("cost_ratio", "prof_cost_ratio"),
                              ("measured_s", "prof_measured_seconds")):
            val = snap.get(field)
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                lines.append(f"{prefix}{family}{{{base}}} {val}")
    return lines


def prof_from_env(producer: str):
    """The profiler factory every producer uses: the shared
    :data:`NULL_PROF` when ``STpu_PROF`` is unset/``0``; an armed
    :class:`WaveProfiler` otherwise, with the ``STpu_PROF_SAMPLE``
    cadence."""
    if os.environ.get(PROF_ENV, "") in ("", "0"):
        return NULL_PROF
    try:
        sample = int(os.environ.get(PROF_SAMPLE_ENV, "")
                     or _SAMPLE_DEFAULT)
    except ValueError:
        sample = _SAMPLE_DEFAULT
    return WaveProfiler(producer, sample_every=sample)
