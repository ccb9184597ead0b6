"""Online slow-wave detection with cause attribution.

The port's copy of ``stateright_tpu/obs/anomaly.py``. For each program
key (``producer|kernel_path``) it keeps an EWMA of the wave latency and
an EWMA of its absolute deviation (scaled by 1.4826, the online stand-in
for MAD). Once ``warmup`` waves are in, a wave slower than ``ewma + k *
max(1.4826 * dev, floor)`` is an anomaly, and its cause is read from the
wave entry's own gauges: ``compile`` (the entry's ``compiled`` flag),
``io_stall`` (``io_stall_s`` covers half the excess), ``straggler`` (a
caller's wait hint covers half the excess), ``spill`` (a host or disk
tier gauge grew), ``cost_model`` (a sampled ``cost_ratio`` at least
``_COST_DRIFT`` times the key's ratio history), else ``unknown``. The
baseline takes every wave, anomalous or not. Deterministic.

``STpu_ANOMALY=1`` arms the defaults; ``k=v`` overrides ``k`` (4),
``warmup`` (8), ``alpha`` (0.2) and ``floor`` (0.001 s). Unset,
``detector_from_env`` returns ``None``. Dependency-free.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Dict, Optional

__all__ = ["ANOMALY_ENV", "SlowWaveDetector", "detector_from_env"]

#: Environment knob: ``STpu_ANOMALY=1`` arms the detector (optionally
#: with ``k=v`` overrides — module docstring).
ANOMALY_ENV = "STpu_ANOMALY"

#: Normal-consistency constant: MAD * 1.4826 estimates sigma.
_MAD_SIGMA = 1.4826

#: ``cost_model`` attribution threshold: the sampled ``cost_ratio``
#: must reach this multiple of the key's own ratio EWMA. Generous on
#: purpose — the latency gate (``ewma + k*scale``) already fired, this
#: only decides the label.
_COST_DRIFT = 1.5


class SlowWaveDetector:
    """Per-program-key EWMA+MAD baseline over wave dispatch latency."""

    def __init__(self, k: float = 4.0, warmup: int = 8,
                 alpha: float = 0.2, floor: float = 0.001,
                 keep: int = 64):
        self.k = float(k)
        self.warmup = max(1, int(warmup))
        self.alpha = min(1.0, max(0.01, float(alpha)))
        self.floor = max(0.0, float(floor))
        self._lock = threading.Lock()
        self._keys: Dict[str, dict] = {}
        #: recent anomalies for the ops panel / scheduler_stats — a
        #: bounded window, oldest dropped.
        self._recent: deque = deque(maxlen=max(1, int(keep)))
        self.total = 0

    def observe(self, key: str, dur: float, entry: dict,
                wait_s: Optional[float] = None) -> Optional[dict]:
        """Judges one wave latency against its key's baseline; returns
        an ``anomaly`` event payload when it trips, else None. Always
        updates the baseline (a change detector, not a level one)."""
        dur = float(dur)
        with self._lock:
            st = self._keys.get(key)
            if st is None:
                st = self._keys[key] = {
                    "ewma": dur, "dev": 0.0, "n": 0,
                    "host_bytes": None, "disk_bytes": None,
                    "cost_ratio": None}
            verdict = None
            if st["n"] >= self.warmup:
                base = st["ewma"]
                scale = max(_MAD_SIGMA * st["dev"], self.floor)
                if dur > base + self.k * scale:
                    cause = self._attribute(st, dur, base, entry, wait_s)
                    verdict = {"cause": cause, "key": key,
                               "dur_s": round(dur, 6),
                               "baseline_s": round(base, 6),
                               "dev_s": round(scale, 6)}
                    self.total += 1
                    self._recent.append(dict(
                        verdict, at=round(time.monotonic(), 3),
                        wave=entry.get("wave")))
            a = self.alpha
            st["ewma"] += a * (dur - st["ewma"])
            st["dev"] += a * (abs(dur - st["ewma"]) - st["dev"])
            st["n"] += 1
            # Track tier growth per key for the spill attribution.
            for field, slot in (("tier_host_bytes", "host_bytes"),
                                ("tier_disk_bytes", "disk_bytes")):
                val = entry.get(field)
                if isinstance(val, int):
                    st[slot] = val
            # Track the sampled cost_ratio per key (v13) for the
            # cost_model attribution: an EWMA of the ratio history so
            # a drift is judged against the key's own normal, not the
            # absolute 1.0 anchor.
            ratio = entry.get("cost_ratio")
            if isinstance(ratio, (int, float)) \
                    and not isinstance(ratio, bool) \
                    and math.isfinite(ratio):
                prev = st["cost_ratio"]
                st["cost_ratio"] = (ratio if prev is None
                                    else prev + a * (ratio - prev))
            return verdict

    def _attribute(self, st: dict, dur: float, base: float,
                   entry: dict, wait_s: Optional[float]) -> str:
        excess = max(dur - base, 1e-9)
        if entry.get("compiled"):
            return "compile"
        io = entry.get("io_stall_s")
        if isinstance(io, (int, float)) and io >= 0.5 * excess:
            return "io_stall"
        if isinstance(wait_s, (int, float)) and wait_s >= 0.5 * excess:
            return "straggler"
        for field, slot in (("tier_host_bytes", "host_bytes"),
                            ("tier_disk_bytes", "disk_bytes")):
            val = entry.get(field)
            prev = st[slot]
            if isinstance(val, int) and isinstance(prev, int) \
                    and val > prev:
                return "spill"
        # v13: the wave carried a sampled cost_ratio that drifted past
        # the key's ratio history — the program itself regressed.
        ratio = entry.get("cost_ratio")
        prev = st.get("cost_ratio")
        if isinstance(ratio, (int, float)) \
                and not isinstance(ratio, bool) \
                and math.isfinite(ratio) \
                and isinstance(prev, (int, float)) and prev > 0 \
                and ratio >= _COST_DRIFT * prev:
            return "cost_model"
        return "unknown"

    def recent(self) -> list:
        """The bounded recent-anomaly window, oldest first."""
        with self._lock:
            return list(self._recent)

    def stats(self) -> dict:
        with self._lock:
            return {"total": self.total, "keys": len(self._keys),
                    "recent": list(self._recent)}


def detector_from_env() -> Optional[SlowWaveDetector]:
    """``None`` when ``STpu_ANOMALY`` is unset/``0``; a configured
    detector otherwise."""
    raw = os.environ.get(ANOMALY_ENV, "")
    if raw in ("", "0"):
        return None
    kwargs: Dict[str, float] = {}
    for part in raw.split(","):
        if "=" not in part:
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        if key not in ("k", "warmup", "alpha", "floor"):
            continue
        try:
            kwargs[key] = int(val) if key == "warmup" else float(val)
        except ValueError:
            continue
    return SlowWaveDetector(**kwargs)
