"""Service-level objectives: rolling error-budget burn over a run.

The port's copy of ``stateright_tpu/obs/slo.py``. An objective is a
ratio over a rolling window: at least ``target`` of the events of the
last ``window_s`` seconds must be good. A latency objective judges an
event good at or under its threshold; ``wave_success`` counts a dispatch
that paid an overflow regather as bad. The burn rate is
``bad_fraction / (1 - target)``; ``burn > 1`` is a breach.

``STpu_SLO=1`` arms the defaults (``job_latency`` 2.0 s at 0.99,
``queue_wait`` 0.5 s at 0.99, ``wave_success`` at 0.999); ``k=v`` pairs
retune them (``job_latency=0.25``, ``queue_wait=0.1``,
``wave_success=0.9999``, ``window=30``), unknown keys ignored. A window
judges nothing before :data:`MIN_SAMPLES` events; the healthy to
breaching transition returns one ``slo_breach`` payload (edge-triggered),
and ``status()`` shows the level. Unset, ``slo_from_env`` returns
``None``. Dependency-free.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Optional

__all__ = ["SLO_ENV", "MIN_SAMPLES", "DEFAULT_OBJECTIVES", "SloTracker",
           "slo_from_env", "prometheus_slo_lines"]

#: Environment knob: ``STpu_SLO=1`` arms the default objectives;
#: ``k=v`` pairs override (see the module docstring).
SLO_ENV = "STpu_SLO"

#: A window judges nothing until it holds this many events — a single
#: bad first event must not 503 the service.
MIN_SAMPLES = 10

_WINDOW_DEFAULT_S = 60.0

#: name -> (latency threshold seconds or None, target good-ratio).
DEFAULT_OBJECTIVES: Dict[str, tuple] = {
    "job_latency": (2.0, 0.99),
    "queue_wait": (0.5, 0.99),
    "wave_success": (None, 0.999),
}


class SloTracker:
    """Rolling-window good/bad accounting for a fixed objective set."""

    enabled = True

    def __init__(self, objectives: Optional[Dict[str, tuple]] = None,
                 window_s: float = _WINDOW_DEFAULT_S):
        self.window_s = max(1.0, float(window_s))
        self._lock = threading.Lock()
        self._objs: Dict[str, dict] = {}
        for name, (threshold, target) in (
                objectives or DEFAULT_OBJECTIVES).items():
            self._objs[name] = {
                "threshold": threshold,
                "target": float(target),
                # rolling (t, ok) events; pruned against window_s on
                # every observe — bounded by the producer's own rate.
                "events": deque(),
                "bad": 0,
                "breaching": False,
                "breaches": 0,
            }

    def observe(self, name: str, ok: Optional[bool] = None,
                value: Optional[float] = None,
                t: Optional[float] = None) -> Optional[dict]:
        """Records one event; returns an ``slo_breach`` payload on the
        healthy->breaching transition, else None."""
        obj = self._objs.get(name)
        if obj is None:
            return None
        if ok is None:
            thr = obj["threshold"]
            ok = thr is None or (value is not None and value <= thr)
        t = time.monotonic() if t is None else float(t)
        with self._lock:
            events = obj["events"]
            events.append((t, ok))
            if not ok:
                obj["bad"] += 1
            horizon = t - self.window_s
            while events and events[0][0] < horizon:
                _, old_ok = events.popleft()
                if not old_ok:
                    obj["bad"] -= 1
            total = len(events)
            bad = obj["bad"]
            ratio = (total - bad) / total if total else 1.0
            breaching = total >= MIN_SAMPLES and ratio < obj["target"]
            transition = breaching and not obj["breaching"]
            if transition:
                obj["breaches"] += 1
            obj["breaching"] = breaching
            if not transition:
                return None
            budget = 1.0 - obj["target"]
            burn = (bad / total) / budget if budget > 0 else float(bad)
            return {"objective": name, "target": obj["target"],
                    "burn": round(burn, 4),
                    "window_s": self.window_s,
                    "good": total - bad, "bad": bad}

    def status(self) -> dict:
        """The live SLO surface (``scheduler_stats()["slo"]``,
        ``GET /.healthz`` detail, the explorer ops panel)."""
        with self._lock:
            objectives = {}
            for name, obj in sorted(self._objs.items()):
                total = len(obj["events"])
                bad = obj["bad"]
                ratio = (total - bad) / total if total else 1.0
                budget = 1.0 - obj["target"]
                objectives[name] = {
                    "threshold": obj["threshold"],
                    "target": obj["target"],
                    "window_s": self.window_s,
                    "good": total - bad,
                    "bad": bad,
                    "ratio": round(ratio, 6),
                    "burn": round((bad / total) / budget, 4)
                    if total and budget > 0 else 0.0,
                    "breaching": obj["breaching"],
                    "breaches": obj["breaches"],
                }
            return {"healthy": not any(o["breaching"]
                                       for o in objectives.values()),
                    "objectives": objectives}

    @property
    def healthy(self) -> bool:
        with self._lock:
            return not any(o["breaching"] for o in self._objs.values())


def prometheus_slo_lines(status: dict) -> list:
    """The ``stpu_slo_*`` exposition families for one
    :meth:`SloTracker.status` payload — shared by the service metrics
    and the explorer's checker-mode ``GET /.metrics``."""
    lines = ["# TYPE stpu_slo_healthy gauge",
             f"stpu_slo_healthy {int(status['healthy'])}",
             "# TYPE stpu_slo_burn gauge"]
    objectives = sorted(status["objectives"].items())
    lines += [f'stpu_slo_burn{{objective="{name}"}} {obj["burn"]}'
              for name, obj in objectives]
    lines.append("# TYPE stpu_slo_breaches_total counter")
    lines += [f'stpu_slo_breaches_total{{objective="{name}"}} '
              f'{obj["breaches"]}' for name, obj in objectives]
    return lines


def slo_from_env() -> Optional[SloTracker]:
    """``None`` when ``STpu_SLO`` is unset/``0`` (the facade stays
    cost-free); a configured tracker otherwise."""
    raw = os.environ.get(SLO_ENV, "")
    if raw in ("", "0"):
        return None
    objectives = {k: list(v) for k, v in DEFAULT_OBJECTIVES.items()}
    window_s = _WINDOW_DEFAULT_S
    for part in raw.split(","):
        if "=" not in part:
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        try:
            num = float(val)
        except ValueError:
            continue
        if key == "window":
            window_s = num
        elif key == "wave_success":
            objectives[key][1] = num
        elif key in objectives:
            objectives[key][0] = num
    return SloTracker({k: tuple(v) for k, v in objectives.items()},
                      window_s=window_s)
