"""The always-on flight recorder: a bounded ring of recent events.

The port's copy of ``stateright_tpu/obs/flight.py``. Every device engine
keeps its last ``capacity`` dispatch-log entries in a ring even when
tracing is off, and a run that raises dumps the ring to a small JSONL
postmortem (``postmortem_path``), whose path the engine keeps as
``flight_dump``.

- **Recording is an append of a dict the engine has already built**: a
  reference in a ``deque(maxlen=N)``, no copy. Stamping to schema-valid
  events happens once, at dump time.
- **Disarmed is one attribute check.** ``STpu_FLIGHT=0`` gives the
  shared :data:`NULL_RECORDER`; engines guard with ``.armed``.
- ``recorder_from_env`` registers each armed ring for ``dump_all`` and
  installs SIGTERM/SIGINT handlers (once, from the main thread) that dump
  every live ring before the process dies as it would have.

A dump file starts with one ``postmortem`` header event, then the
recorded events, so the schema's validators accept it line by line.
Dependency-free beyond ``obs.schema``.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import tempfile
import threading
import time
import weakref
from collections import deque
from typing import Optional

from .schema import SCHEMA_VERSION

__all__ = [
    "FLIGHT_ENV", "FLIGHT_DIR_ENV", "FLIGHT_CAPACITY", "FlightRecorder",
    "NullFlightRecorder", "NULL_RECORDER", "recorder_from_env",
    "postmortem_path", "dump_all", "install_signal_handlers",
]

#: Environment knob: ring capacity (events). ``0`` disarms the
#: recorder entirely (the shared null recorder — one attribute check);
#: unset means the default capacity. Unlike ``STpu_TRACE`` this
#: subsystem defaults ON: it allocates nothing per event beyond the
#: dicts its producers already build.
FLIGHT_ENV = "STpu_FLIGHT"

#: Where postmortem dumps land. Unset: the system temp directory.
FLIGHT_DIR_ENV = "STpu_FLIGHT_DIR"

#: Default ring capacity: enough waves to see the run's last seconds
#: at any realistic cadence, small enough to never matter in memory.
FLIGHT_CAPACITY = 256

_DUMP_SEQ = itertools.count()


def postmortem_path(name: str, directory: Optional[str] = None) -> str:
    """The dump path for producer ``name``: deterministic per name so
    a test or a bench drill can find a specific casualty's postmortem
    without parsing anything."""
    directory = (directory or os.environ.get(FLIGHT_DIR_ENV)
                 or tempfile.gettempdir())
    safe = "".join(c if c.isalnum() or c in "-_." else "_"
                   for c in str(name))
    return os.path.join(directory, f"stpu-postmortem-{safe}.jsonl")


class NullFlightRecorder:
    """The disarmed recorder: every method a no-op, ``armed`` False.
    Hot paths must check ``armed`` BEFORE calling ``record`` — the
    disarmed-cost test poisons these methods, so a stray call (= a
    stray per-wave cost with the subsystem off) fails the suite."""

    __slots__ = ()
    armed = False

    def record(self, evt) -> None:
        pass

    def record_event(self, etype, **fields) -> None:
        pass

    def dump(self, reason, name=None) -> Optional[str]:
        return None

    def snapshot(self) -> list:
        return []

    def set_hist_source(self, fn) -> None:
        pass


#: The shared disarmed recorder (``recorder_from_env`` returns this
#: very object under ``STpu_FLIGHT=0`` — identity-testable).
NULL_RECORDER = NullFlightRecorder()


class FlightRecorder:
    """A bounded ring of the last ``capacity`` events for one producer.

    ``name`` identifies the producer in dump headers and default dump
    paths (an engine id, a worker name, the elastic coordinator).
    ``record`` takes any dict the producer already has in hand —
    dispatch-log entries, relay-stamped trace events, lifecycle
    records; heterogeneity is fine because stamping to schema-valid
    lines happens at dump time.
    """

    armed = True

    def __init__(self, name: str, capacity: int = FLIGHT_CAPACITY,
                 directory: Optional[str] = None):
        self.name = str(name)
        self.capacity = max(1, int(capacity))
        self.directory = directory
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        #: the most recent dump's path (None until a dump happens) —
        #: what the Supervisor attaches to its retry/abort events.
        self.last_dump: Optional[str] = None
        #: optional zero-arg callable returning a stamped
        #: ``hist_snapshot`` event (or None) — ``dump`` appends it so a
        #: postmortem carries the producer's latency distribution at
        #: time of death, not just the event ring.
        self._hist_source = None

    def set_hist_source(self, fn) -> None:
        """Registers the final-histogram hook (``WaveObs.
        final_snapshot_event`` — obs/hist.py). Cold path; the ring's
        hot ``record`` never touches it."""
        self._hist_source = fn

    def record(self, evt: dict) -> None:
        """Appends one event reference to the ring. deque.append with
        maxlen is atomic under the GIL; no lock on the hot path."""
        self._ring.append(evt)

    def record_event(self, etype: str, **fields) -> None:
        """Builds and records a stamped event (cold paths only — a
        fault about to kill the process, a lifecycle transition)."""
        evt = {"type": etype, "schema_version": SCHEMA_VERSION,
               "engine": "flight", "run": f"flight-{self.name}",
               "t": round(time.monotonic(), 6)}
        evt.update(fields)
        self._ring.append(evt)

    def snapshot(self) -> list:
        """The ring's current contents, oldest first (stamped)."""
        with self._lock:
            return [self._stamp(e, i) for i, e in enumerate(self._ring)]

    def _stamp(self, evt: dict, i: int) -> dict:
        """A schema-valid copy of one recorded event. Producers that
        ran untraced recorded bare dispatch-log entries — those become
        ``wave`` events stamped with the flight producer's identity
        and ring-ordinal wave numbering (contiguous per dump, which is
        all the lint's per-run invariant needs)."""
        if "type" in evt:
            return dict(evt)
        out = {"type": "wave", "schema_version": SCHEMA_VERSION,
               "engine": "flight", "run": f"flight-{self.name}",
               "wave": i}
        out.update(evt)
        for key in ("worker", "seq", "epoch", "round",
                    # v6 tier gauges: null outside a tiered-store run.
                    "tier_device_rows", "tier_device_bytes",
                    "tier_host_rows", "tier_host_bytes",
                    "tier_disk_rows", "tier_disk_bytes",
                    "kernel_path", "rows",
                    # v9 mux attribution: null outside a mux group.
                    "job_id", "jobs_in_wave",
                    # v10 async-I/O stall gauge: null where not tracked.
                    "io_stall_s",
                    # v12 expand-stage attribution: null on producers
                    # without a device wave.
                    "expand_impl",
                    # v13 cost attribution: null when the profiler is
                    # disarmed / the program has no cost model /
                    # the dispatch was not sampled.
                    "cost_flops", "cost_bytes", "cost_ratio"):
            out.setdefault(key, None)
        return out

    def dump(self, reason: str, name: Optional[str] = None
             ) -> Optional[str]:
        """Writes the ring to a postmortem JSONL file and returns its
        path (one ``postmortem`` header event, then the recorded
        events oldest-first). ``name`` overrides the path identity —
        the coordinator dumps its own ring once per LOST worker, named
        for the casualty. Never raises: a postmortem must not turn a
        failure into a worse failure."""
        with self._lock:
            events = [self._stamp(e, i)
                      for i, e in enumerate(self._ring)]
        path = postmortem_path(name or self.name, self.directory)
        # Deterministic base name for findability, but never clobber an
        # earlier dump: a supervised engine fails once per ATTEMPT at
        # the same name, and each attempt's retry record must keep
        # naming the file that actually describes it.
        if os.path.exists(path):
            stem, ext = os.path.splitext(path)
            for n in range(2, 100):
                candidate = f"{stem}.{n}{ext}"
                if not os.path.exists(candidate):
                    path = candidate
                    break
            else:
                return None  # 99 postmortems at one name: stop digging
        header = {"type": "postmortem",
                  "schema_version": SCHEMA_VERSION, "engine": "flight",
                  "run": f"flight-{self.name}-{next(_DUMP_SEQ)}",
                  "t": round(time.monotonic(), 6),
                  "unix_t": round(time.time(), 3),
                  "reason": str(reason)[:500], "name": self.name,
                  "events": len(events)}
        final_hist = None
        if self._hist_source is not None:
            try:
                final_hist = self._hist_source()
            except Exception:
                final_hist = None  # a postmortem must never get worse
        try:
            with open(path, "w", encoding="utf-8") as f:
                f.write(json.dumps(header, separators=(",", ":"),
                                   default=_best_effort) + "\n")
                for evt in events:
                    f.write(json.dumps(evt, separators=(",", ":"),
                                       default=_best_effort) + "\n")
                if final_hist is not None:
                    f.write(json.dumps(final_hist, separators=(",", ":"),
                                       default=_best_effort) + "\n")
        except OSError:
            return None
        self.last_dump = path
        return path


def _best_effort(obj):
    """Ring contents are whatever the producer had in hand (numpy
    scalars ride along in engine telemetry); a postmortem writer must
    never raise, so unknowns degrade to repr."""
    fn = getattr(obj, "item", None)
    if callable(fn):
        return fn()
    return repr(obj)


# -- Signal-driven dumps ----------------------------------------------------
#
# A crash dumps its ring through the failure paths (Supervisor,
# coordinator, engine abort) — but a PREEMPTED run (SIGTERM from a
# scheduler, Ctrl-C from an operator) used to exit with its rings full
# and unwritten, which is exactly backwards: the cancelled soak is the
# one whose last seconds someone wants to see. ``recorder_from_env``
# therefore registers every armed ring in a process-wide weak set and
# installs (once, main thread only) SIGTERM/SIGINT handlers that dump
# every live ring before chaining to the previous disposition — the
# process still dies the way it would have, it just leaves postmortems
# first.

_SIGNAL_LOCK = threading.Lock()
_LIVE_RECORDERS: "weakref.WeakSet" = weakref.WeakSet()
_PREV_HANDLERS: dict = {}
_HANDLERS_INSTALLED = False


def dump_all(reason: str) -> list:
    """Dumps every live armed ring; returns the written paths. Never
    raises — the signal-handler path must not turn a shutdown into a
    traceback."""
    paths = []
    for rec in list(_LIVE_RECORDERS):
        try:
            path = rec.dump(reason)
        except Exception:
            path = None
        if path:
            paths.append(path)
    return paths


def _on_signal(signum, frame):
    try:
        name = signal.Signals(signum).name
    except ValueError:
        name = str(signum)
    dump_all(f"signal-{name}")
    prev = _PREV_HANDLERS.get(signum)
    if callable(prev):
        prev(signum, frame)  # e.g. default_int_handler -> KeyboardInterrupt
    elif prev != signal.SIG_IGN:
        # SIG_DFL: re-deliver under the default disposition so the
        # process still dies with the right termination status.
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def install_signal_handlers() -> bool:
    """Installs the SIGTERM/SIGINT dump handlers once per process.
    Returns True when installed (now or earlier); False when it cannot
    be (not the main thread — engines spawned from worker threads
    simply leave dispositions alone)."""
    global _HANDLERS_INSTALLED
    with _SIGNAL_LOCK:
        if _HANDLERS_INSTALLED:
            return True
        try:
            for signum in (signal.SIGTERM, signal.SIGINT):
                prev = signal.getsignal(signum)
                signal.signal(signum, _on_signal)
                _PREV_HANDLERS[signum] = prev
        except ValueError:
            return False
        _HANDLERS_INSTALLED = True
        return True


def recorder_from_env(name: str, directory: Optional[str] = None,
                      capacity: Optional[int] = None):
    """The recorder factory every producer uses: armed by default
    (``STpu_FLIGHT`` unset or a positive capacity), the shared
    :data:`NULL_RECORDER` under ``STpu_FLIGHT=0``. Armed recorders
    join the signal-dump registry (weakly — a collected engine's ring
    drops out on its own)."""
    if capacity is None:
        raw = os.environ.get(FLIGHT_ENV, "")
        try:
            capacity = int(raw) if raw else FLIGHT_CAPACITY
        except ValueError:
            capacity = FLIGHT_CAPACITY
    if capacity <= 0:
        return NULL_RECORDER
    rec = FlightRecorder(name, capacity=capacity, directory=directory)
    _LIVE_RECORDERS.add(rec)
    install_signal_handlers()
    return rec
