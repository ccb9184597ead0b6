"""Run telemetry for the port: the wave-event stream, the flight recorder,
latency histograms, SLOs, slow-wave detection and the wave profiler.

The port's copy of ``stateright_tpu/obs`` (schema v14), wired into all
six engines (the fused, classic, sharded fused and classic sharded device
engines, the host BFS and DFS). Each knob is JAX's:

- ``STpu_TRACE=path`` streams every engine's per-dispatch wave events,
  spans, counters and the ``grow`` / ``overflow_redispatch`` /
  ``ckpt_begin`` / ``ckpt_done`` / ``spill`` / ``page_in`` /
  ``pressure`` events as JSONL (``tracer.py``);
- ``STpu_FLIGHT`` (default on; ``0`` disarms) keeps each device engine's
  last dispatch-log entries in a ring dumped to a postmortem when a run
  raises, under ``STpu_FLIGHT_DIR`` (``flight.py``);
- ``STpu_HIST``, ``STpu_SLO`` and ``STpu_ANOMALY`` arm the latency
  histograms, the error-budget objectives and the slow-wave detector
  (``hist.py``, ``slo.py``, ``anomaly.py``);
- ``STpu_PROF`` (and ``STpu_PROF_SAMPLE``) arms the wave profiler on the
  kernels' declared costs (``prof.py``).

Unset, each is a shared null object and an engine pays one attribute
check a dispatch. A port trace validates under ``schema.validate_line``
here, and under JAX's schema and ``tools/trace_lint.py`` where the JAX
package is installed.

The resilience family comes from ``resilience/``: ``fault`` from the
fault plan's firings, ``degrade`` and ``recover`` (``kind``
``grow_degrade``) from the device engines' OOM degrade, ``recover``
(``cold_segment_prev``) from the tiered store's torn-segment fallback,
and ``retry`` and ``abort`` from the ``Supervisor``.

Not ported: ``obs/collect.py`` (``RelayTracer``, ``TraceCollector``),
which serves the elastic workers (ROADMAP A13 (c)), and with them the
``worker_lost`` / ``migrate_done`` / ``rebalance`` events; the job, mux
and control event families (A10, A13 (b)); the explorer's ``/.metrics``
(A19).
"""

from .anomaly import ANOMALY_ENV, SlowWaveDetector, detector_from_env
from .flight import (FLIGHT_DIR_ENV, FLIGHT_ENV, FlightRecorder,
                     NULL_RECORDER, NullFlightRecorder, postmortem_path,
                     recorder_from_env)
from .hist import (BUCKET_BOUNDS, HIST_ENV, Histogram, HistogramSet,
                   NULL_OBS, NullWaveObs, SNAP_ENV, WaveObs,
                   prometheus_hist_lines, wave_obs_from_env)
from .prof import (NULL_PROF, NullWaveProfiler, PROF_ENV,
                   PROF_SAMPLE_ENV, WaveProfiler, cost_record,
                   prof_from_env, program_records,
                   prometheus_prof_lines, roofline)
from .schema import (ENGINE_IDS, EVENT_TYPES, SCHEMA_VERSION, TRACE_ENV,
                     WAVE_FIELDS, WAVE_FIELDS_V1, WAVE_FIELDS_V2,
                     validate_event, validate_line)
from .slo import SLO_ENV, SloTracker, prometheus_slo_lines, slo_from_env
from .tracer import NULL_TRACER, NullTracer, RunTracer, tracer_from_env

__all__ = [
    "ANOMALY_ENV", "BUCKET_BOUNDS", "ENGINE_IDS", "EVENT_TYPES",
    "FLIGHT_DIR_ENV", "FLIGHT_ENV", "FlightRecorder", "HIST_ENV",
    "Histogram", "HistogramSet", "NULL_OBS", "NULL_PROF", "NULL_RECORDER",
    "NULL_TRACER", "NullFlightRecorder", "NullTracer", "NullWaveObs",
    "NullWaveProfiler", "PROF_ENV", "PROF_SAMPLE_ENV", "RunTracer",
    "SCHEMA_VERSION", "SLO_ENV", "SNAP_ENV", "SloTracker",
    "SlowWaveDetector", "TRACE_ENV", "WAVE_FIELDS", "WAVE_FIELDS_V1",
    "WAVE_FIELDS_V2", "WaveObs", "WaveProfiler", "cost_record",
    "detector_from_env", "postmortem_path", "prof_from_env",
    "program_records", "prometheus_hist_lines", "prometheus_prof_lines",
    "prometheus_slo_lines", "recorder_from_env", "roofline", "slo_from_env",
    "tracer_from_env", "validate_event", "validate_line",
    "wave_obs_from_env",
]
