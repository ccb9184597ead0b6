"""``RunTracer``: the run-telemetry writer behind ``STpu_TRACE``.

The port's copy of ``stateright_tpu/obs/tracer.py``. Its constraints, in
order:

1. **The disabled path is free.** Every engine guards emission with
   ``if self._tracer.enabled:``; with ``STpu_TRACE`` unset,
   ``tracer_from_env`` returns the shared ``NULL_TRACER`` and a dispatch
   pays one attribute check: no event dict, no formatting.
2. **One stream, many producers.** Several tracers may append to one
   file; each stamps its events with a ``run`` id of its own and writes
   whole lines under a lock.
3. **Durable enough, cheap enough.** Writes are buffered and flushed
   every ``_FLUSH_EVERY`` events or ``_FLUSH_S`` seconds, and at run
   boundaries; a daemon thread flushes the buffered tail every
   ``_FLUSH_S`` even when the producer has gone silent (a stuck dispatch
   is when the last events matter most).

Spans nest per thread (``depth``); counters accumulate per tracer and
land in the ``run_end`` event.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

from .schema import SCHEMA_VERSION, TRACE_ENV

__all__ = ["RunTracer", "NullTracer", "NULL_TRACER", "tracer_from_env"]

_RUN_SEQ = itertools.count()


class NullTracer:
    """The disabled tracer: every method is a no-op, ``enabled`` is
    False. Hot paths must check ``enabled`` BEFORE building event
    payloads — the null methods exist only so cold paths (close, span
    around a growth rehash) need no guard."""

    __slots__ = ()
    enabled = False

    def wave(self, fields) -> None:
        pass

    def event(self, etype, **fields) -> None:
        pass

    def counter(self, name, inc=1) -> None:
        pass

    def gauge(self, name, value) -> None:
        pass

    def span_event(self, name, start, dur, depth=0, **attrs) -> None:
        pass

    def emit_raw(self, evt) -> None:
        pass

    @contextmanager
    def span(self, name, **attrs):
        yield

    def close(self) -> None:
        pass


#: The shared disabled tracer (``tracer_from_env`` returns this very
#: object when ``STpu_TRACE`` is unset — identity-testable).
NULL_TRACER = NullTracer()


class RunTracer:
    """Writes one JSONL event stream for one checker/tool run."""

    enabled = True

    #: flush cadence: whichever of these trips first (see the module
    #: docstring's durability/cost trade).
    _FLUSH_EVERY = 32
    _FLUSH_S = 0.5

    def __init__(self, path: str, engine: str, meta: Optional[dict] = None):
        self.path = path
        self.engine = engine
        self.run = f"{os.getpid():x}-{next(_RUN_SEQ)}"
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._local = threading.local()
        self._t0 = time.monotonic()
        self._wave_index = 0
        self._counters: dict = {}
        self._closed = False
        self._closing = False
        self._unflushed = 0
        self._last_flush = self._t0
        self._write({"type": "run_start", "t": self._t0,
                     "unix_t": round(time.time(), 3),
                     "meta": dict(meta or {})}, flush=True)
        # Background sweep: flush the buffered tail even when the
        # producer goes silent (a wedged dispatch, an imminent external
        # kill) — the trailing events are the ones a post-mortem needs.
        self._flush_stop = threading.Event()
        self._flusher = threading.Thread(target=self._flush_loop,
                                         daemon=True)
        self._flusher.start()

    def _flush_loop(self) -> None:
        while not self._flush_stop.wait(self._FLUSH_S):
            with self._lock:
                if self._closed:
                    return
                if self._unflushed:
                    self._f.flush()
                    self._unflushed = 0
                    self._last_flush = time.monotonic()

    # -- Plumbing --------------------------------------------------------

    def _write(self, fields: dict, number_wave: bool = False,
               flush: bool = False, final: bool = False) -> None:
        evt = {"schema_version": SCHEMA_VERSION, "engine": self.engine,
               "run": self.run}
        evt.update(fields)
        with self._lock:
            # Once a closer owns ``_closing``, only its own run_end
            # (``final``) may still land — a racing emitter that lost
            # the close race must not write AFTER run_end.
            if self._closed or (self._closing and not final):
                return
            if number_wave:
                # Numbered and written under ONE lock hold, so
                # concurrent emitters (the host engines' worker
                # threads) cannot write indices out of order — the
                # lint's contiguity check depends on this.
                evt["wave"] = self._wave_index
                self._wave_index += 1
            now = time.monotonic()
            evt["t"] = round(evt.get("t", now), 6)
            self._f.write(json.dumps(evt, separators=(",", ":"),
                                     default=_jsonable) + "\n")
            self._unflushed += 1
            if (flush or self._unflushed >= self._FLUSH_EVERY
                    or now - self._last_flush >= self._FLUSH_S):
                self._f.flush()
                self._unflushed = 0
                self._last_flush = now

    # -- Emitters --------------------------------------------------------

    def wave(self, fields: dict) -> None:
        """Emits one wave event. ``fields`` is the engine's unified
        dispatch-log entry (see ``schema.WAVE_FIELDS``); the tracer
        stamps type/version/engine/run, numbers the wave, and defaults
        the v5 attribution keys — one stamping site instead of four
        per-engine field-set edits (engines that HAVE a value, the
        elastic runtime, set it in their entry)."""
        evt = dict(fields, type="wave")
        for key in ("worker", "seq", "epoch", "round",
                    # v6 tier gauges: null outside a tiered-store run.
                    "tier_device_rows", "tier_device_bytes",
                    "tier_host_rows", "tier_host_bytes",
                    "tier_disk_rows", "tier_disk_bytes",
                    # v8 kernel-path keys: null on producers without a
                    # device wave (host checkers, elastic coordinator).
                    "kernel_path", "rows",
                    # v9 mux attribution: null on solo-engine waves.
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
            evt.setdefault(key, None)
        self._write(evt, number_wave=True)

    def event(self, etype: str, **fields) -> None:
        # _flush=True forces the line out immediately — for emitters
        # about to hard-exit the process (injected child death).
        flush = bool(fields.pop("_flush", False))
        self._write(dict(fields, type=etype), flush=flush)

    def counter(self, name: str, inc=1) -> None:
        with self._lock:
            total = self._counters.get(name, 0) + inc
            self._counters[name] = total
        self._write({"type": "counter", "name": name, "value": total,
                     "inc": inc})

    def gauge(self, name: str, value) -> None:
        self._write({"type": "gauge", "name": name, "value": value})

    def emit_raw(self, evt: dict) -> None:
        """Writes one already-stamped event (no restamping, no wave
        numbering) — the ``TraceCollector``'s funnel for merged
        per-worker events, which arrive fully stamped by the worker's
        own relay tracer (``obs/collect.py``) and must keep their
        original run/worker/seq identity. ``_write``'s stamps are
        defaults the caller's fields override, so delegation preserves
        the foreign identity while sharing the one flush policy."""
        self._write(evt)

    def span_event(self, name: str, start: float, dur: float,
                   depth: int = 0, **attrs) -> None:
        """A pre-measured span (profiling.py times its stages itself)."""
        evt = {"type": "span", "name": name, "t": start,
               "dur": round(dur, 6), "depth": depth}
        if attrs:
            evt["attrs"] = attrs
        self._write(evt)

    @contextmanager
    def span(self, name: str, **attrs):
        """Measures a nested span: monotonic start/end, per-thread
        depth."""
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        start = time.monotonic()
        try:
            yield
        finally:
            self._local.depth = depth
            self.span_event(name, start, time.monotonic() - start,
                            depth=depth, **attrs)

    def close(self) -> None:
        """Writes ``run_end`` (with counter totals) and closes the
        stream. Idempotent — including against a concurrent close from
        a second thread (the async-I/O writer joins while the wave loop
        tears down): exactly one caller wins the ``_closing`` flag and
        writes ``run_end``; later emits become no-ops."""
        with self._lock:
            if self._closed or self._closing:
                return
            self._closing = True
            counters = dict(self._counters)
        self._write({"type": "run_end",
                     "dur": round(time.monotonic() - self._t0, 6),
                     "counters": counters}, flush=True, final=True)
        self._flush_stop.set()
        with self._lock:
            self._closed = True
            self._f.close()


def _jsonable(obj):
    """numpy scalars ride along in engine telemetry; coerce them."""
    for attr in ("item",):
        fn = getattr(obj, attr, None)
        if callable(fn):
            return fn()
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")


def tracer_from_env(engine: str, meta: Optional[dict] = None,
                    path: Optional[str] = None):
    """The tracer factory every producer uses: ``STpu_TRACE`` set means
    a live ``RunTracer`` appending there; unset means the shared
    ``NULL_TRACER`` (no allocation, no file)."""
    path = path or os.environ.get(TRACE_ENV)
    if not path:
        return NULL_TRACER
    return RunTracer(path, engine, meta)
