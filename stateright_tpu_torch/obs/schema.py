"""The versioned run-telemetry event schema, for the port.

The port's copy of ``stateright_tpu/obs/schema.py``, kept field for field
(``SCHEMA_VERSION`` 14, every version's wave field set, the event types
and the producer ids), so that a trace the port writes validates under
either copy. The card's machine has no JAX, so this copy is what checks a
trace there; on a machine with the JAX package, ``tools/trace_lint.py``
checks one as well.

Two event families share a stream: trace events carry a ``type`` key
(``run_start``, ``wave``, ``span``, ``counter``, ``gauge``, ``grow``, ...,
``run_end``), each stamped with ``schema_version``, ``engine``, ``run``
and ``t``; session events carry an ``event`` key. The wave event is
field-exact: every engine emits every key of ``WAVE_FIELDS``, with
``null`` where it has no value.

Dependency-free (no torch, no numpy).
"""

from __future__ import annotations

from typing import Dict, List

__all__ = [
    "SCHEMA_VERSION", "TRACE_ENV", "EVENT_TYPES", "ENGINE_IDS",
    "SHED_REASONS",
    "WAVE_FIELDS", "WAVE_FIELDS_V1", "WAVE_FIELDS_V2",
    "WAVE_FIELDS_V5", "WAVE_FIELDS_V6", "WAVE_FIELDS_V8",
    "WAVE_FIELDS_V9", "WAVE_FIELDS_V11", "WAVE_FIELDS_V12",
    "validate_event", "validate_line",
]

#: v14: the closed vocabulary a ``shed`` event's ``reason`` must come
#: from — lives HERE (not in service/control.py) so the jax-free
#: consumers (``tools/trace_lint.py``) can validate it without pulling
#: the service package: ``slo_burn`` (admission gate engaged, priority
#: below the protected floor), ``brownout`` (the ladder raised the
#: floor over this priority), ``retry_budget`` (per-tenant token
#: bucket empty), ``queue_full`` (the bounded queue itself overflowed).
SHED_REASONS = ("slo_burn", "brownout", "retry_budget", "queue_full")

#: Bump on any field addition/removal/retyping; consumers gate on it.
#: What each version added: v2 the wave events' bandwidth gauges
#: ``bytes_per_state`` / ``arena_bytes`` / ``table_bytes``; v3 the
#: resilience events ``fault`` / ``recover`` / ``degrade`` / ``abort``;
#: v4 the membership events and the ``elastic`` producer; v5 the wave
#: attribution keys ``worker`` / ``seq`` / ``epoch`` / ``round`` and the
#: ``straggler`` and ``postmortem`` events; v6 the wave tier gauges
#: ``tier_*`` and the ``spill`` / ``page_in`` / ``pressure`` events; v7 the
#: job events; v8 the wave keys ``kernel_path`` and ``rows``; v9 the wave
#: keys ``job_id`` and ``jobs_in_wave``; v10 the wave key ``io_stall_s``
#: and the ``ckpt_begin`` / ``ckpt_done`` events; v11 the
#: ``hist_snapshot``, ``slo_breach`` and ``anomaly`` events; v12 the wave
#: key ``expand_impl`` and the ``matmul_ops`` gauge; v13 the wave keys
#: ``cost_flops`` / ``cost_bytes`` / ``cost_ratio`` and the
#: ``profile_snapshot`` event (and the ``cost_model`` anomaly cause); v14
#: the overload-control events ``admit`` / ``shed`` / ``park`` /
#: ``resume`` / ``controller``. Older streams validate against their
#: version's field set; a stream newer than this validator is rejected
#: with one clear message.
SCHEMA_VERSION = 14

#: Environment knob: set to a file path to stream JSONL events there.
#: Unset means the null tracer — the hot loop pays one attribute check.
TRACE_ENV = "STpu_TRACE"

#: Producers that emit wave events (``engine`` field values). Spans and
#: counters may additionally come from the meta-producers below.
#: ``elastic`` is the multi-worker coordinator (one wave event per
#: coordinated round, plus the membership lifecycle events);
#: ``elastic_worker`` is one elastic worker's relayed stream (schema
#: v5 — per-worker wave events, merged into the coordinator's file by
#: ``obs/collect.py``).
#: ``flight`` is the dump-time stamp on ring-buffer events whose
#: producer ran untraced (``obs/flight.py``) — postmortem files are
#: full citizens of the schema.
#: ``mux`` is the cross-job wave multiplexer (service/mux.py) — one
#: shared engine whose dispatches batch several jobs' frontiers.
ENGINE_IDS = ("classic", "fused", "sharded", "sharded_fused",
              "host_bfs", "host_dfs", "elastic", "elastic_worker",
              "flight", "mux")

#: Non-engine producers sharing the stream (spans/counters/resilience
#: events only). ``supervisor`` emits recover/abort, ``faults`` is the
#: injection registry's fallback producer for sites without an engine
#: tracer (the checkpoint writer, the bench device child).
#: ``service`` is the multi-tenant job service 
#: — it emits the v7 job lifecycle family into each job's trace.
META_PRODUCERS = ("profiling", "bench", "explorer", "supervisor",
                  "faults", "service")

_NULL = type(None)
_INT = (int,)            # bool is excluded explicitly in _typecheck
_NUM = (int, float)
_STR = (str,)
_BOOL = (bool,)

#: The per-dispatch wave event: field -> allowed types. EVERY engine
#: emits EVERY key. Count fields are per-dispatch deltas except
#: ``states``/``unique`` (cumulative, so a truncated trace still ends
#: on the right totals).
WAVE_FIELDS: Dict[str, tuple] = {
    "type": _STR,                  # == "wave"
    "schema_version": _INT,
    "engine": _STR,                # one of ENGINE_IDS
    "run": _STR,                   # tracer id: one checker run
    "wave": _INT,                  # dispatch index within the run
    "t": _NUM,                     # monotonic seconds at processing
    "states": _INT,                # cumulative generated states
    "unique": _INT,                # cumulative unique states
    "bucket": _INT,                # dispatch batch width B
    "waves": _INT,                 # BFS levels in this dispatch (fused >1)
    "inflight": _INT,              # pipeline depth at launch
    "compiled": _BOOL,             # interval carried a compile or capture
    "successors": _INT,            # valid successors generated (delta)
    "candidates": _INT,            # distinct candidates probed (delta)
    "novel": _INT,                 # new unique states appended (delta)
    "out_rows": _INT + (_NULL,),   # successor-ladder rung K (null: n/a)
    "capacity": _INT + (_NULL,),   # visited-table capacity (null: host)
    "load_factor": _NUM + (_NULL,),  # occupancy/capacity after dispatch
    "overflow": _BOOL,             # dispatch paid an overflow regather
    # v2: packed-arena bandwidth gauges. bytes_per_state is
    # the STORED row width in bytes (packed when the model declares
    # lane_bits); arena/table bytes are device-resident footprints
    # (null where an engine has no such structure — host engines, or
    # the per-wave engines' host-side frontier).
    "bytes_per_state": _INT + (_NULL,),
    "arena_bytes": _INT + (_NULL,),
    "table_bytes": _INT + (_NULL,),
    # v5: distributed-attribution keys. ``null`` outside the elastic
    # runtime (the tracer stamps the defaults so no engine needs a
    # per-engine field set). ``seq`` is the worker's per-process
    # emission counter — it never resets across the migration tracer
    # rotation, so the collector's merge order and the lint's
    # per-worker monotonicity survive run-id rotation.
    "worker": _STR + (_NULL,),
    "seq": _INT + (_NULL,),
    "epoch": _INT + (_NULL,),
    "round": _INT + (_NULL,),
    # v6: tiered-state-store occupancy gauges (rows/bytes resident per
    # tier after the dispatch). ``null`` when the store is disarmed —
    # the tracer stamps the defaults, so no engine needs a per-engine
    # field set.
    "tier_device_rows": _INT + (_NULL,),
    "tier_device_bytes": _INT + (_NULL,),
    "tier_host_rows": _INT + (_NULL,),
    "tier_host_bytes": _INT + (_NULL,),
    "tier_disk_rows": _INT + (_NULL,),
    "tier_disk_bytes": _INT + (_NULL,),
    # v8: single-kernel-wave attribution. ``kernel_path`` names the
    # successor-path implementation the dispatch executed; ``rows`` is
    # the valid frontier rows it consumed (occupancy numerator). Both
    # ``null`` on producers without a device wave.
    "kernel_path": _STR + (_NULL,),
    "rows": _INT + (_NULL,),
    # v9: cross-job multiplexing attribution. ``job_id`` names the
    # service job a per-job wave line belongs to (``null`` on solo
    # waves and on the mux total line); ``jobs_in_wave`` is the tenant
    # count of the shared dispatch (``null`` outside the multiplexer).
    "job_id": _STR + (_NULL,),
    "jobs_in_wave": _INT + (_NULL,),
    # v10: asynchronous host I/O. Seconds the wave loop spent blocked
    # on host I/O since the previous wave event (safe-point joins on
    # the background writer + synchronous write time). ``null`` where
    # not tracked (meta-producers, relayed historical streams).
    "io_stall_s": _NUM + (_NULL,),
    # v12: which expand-stage implementation the dispatch's wave
    # program embeds: "matmul" (the transition-table form) or "step"
    # (the model's own step). ``null`` on
    # producers without a device wave.
    "expand_impl": _STR + (_NULL,),
    # v13: continuous-profiler cost attribution (obs/prof.py). The
    # executed program's static cost record (``null`` when the
    # profiler is disarmed or the program declares no cost), and — on sampled dispatches
    # only — the measured-vs-own-baseline ``cost_ratio`` (finite by
    # construction; ``null`` on unsampled dispatches).
    "cost_flops": _NUM + (_NULL,),
    "cost_bytes": _NUM + (_NULL,),
    "cost_ratio": _NUM + (_NULL,),
}

#: v5 attribution keys (absent from v2-v4 wave events).
_WAVE_V5_KEYS = ("worker", "seq", "epoch", "round")

#: v6 tier gauges (absent from v1-v5 wave events).
_WAVE_V6_KEYS = ("tier_device_rows", "tier_device_bytes",
                 "tier_host_rows", "tier_host_bytes",
                 "tier_disk_rows", "tier_disk_bytes")

#: v8 single-kernel-wave keys (absent from v1-v7 wave events).
_WAVE_V8_KEYS = ("kernel_path", "rows")

#: v9 multiplexing keys (absent from v1-v8 wave events).
_WAVE_V9_KEYS = ("job_id", "jobs_in_wave")

#: v10 async-I/O keys (absent from v1-v9 wave events).
_WAVE_V10_KEYS = ("io_stall_s",)

#: v12 expand-stage attribution (absent from v1-v11 wave events).
_WAVE_V12_KEYS = ("expand_impl",)

#: v13 cost-attribution keys (absent from v1-v12 wave events).
_WAVE_V13_KEYS = ("cost_flops", "cost_bytes", "cost_ratio")

#: The v1 wave field set (no bandwidth gauges) — v1 captures validate
#: against this exactly.
WAVE_FIELDS_V1: Dict[str, tuple] = {
    k: v for k, v in WAVE_FIELDS.items()
    if k not in ("bytes_per_state", "arena_bytes", "table_bytes")
    + _WAVE_V5_KEYS + _WAVE_V6_KEYS + _WAVE_V8_KEYS + _WAVE_V9_KEYS
    + _WAVE_V10_KEYS + _WAVE_V12_KEYS + _WAVE_V13_KEYS}

#: The v2-v4 wave field set (bandwidth gauges, no attribution keys).
WAVE_FIELDS_V2: Dict[str, tuple] = {
    k: v for k, v in WAVE_FIELDS.items()
    if k not in _WAVE_V5_KEYS + _WAVE_V6_KEYS + _WAVE_V8_KEYS
    + _WAVE_V9_KEYS + _WAVE_V10_KEYS + _WAVE_V12_KEYS
    + _WAVE_V13_KEYS}

#: The v5 wave field set (attribution keys, no tier gauges).
WAVE_FIELDS_V5: Dict[str, tuple] = {
    k: v for k, v in WAVE_FIELDS.items()
    if k not in _WAVE_V6_KEYS + _WAVE_V8_KEYS + _WAVE_V9_KEYS
    + _WAVE_V10_KEYS + _WAVE_V12_KEYS + _WAVE_V13_KEYS}

#: The v6-v7 wave field set (tier gauges, no kernel-path keys).
WAVE_FIELDS_V6: Dict[str, tuple] = {
    k: v for k, v in WAVE_FIELDS.items()
    if k not in _WAVE_V8_KEYS + _WAVE_V9_KEYS + _WAVE_V10_KEYS
    + _WAVE_V12_KEYS + _WAVE_V13_KEYS}

#: The v8 wave field set (kernel-path keys, no mux attribution).
WAVE_FIELDS_V8: Dict[str, tuple] = {
    k: v for k, v in WAVE_FIELDS.items()
    if k not in _WAVE_V9_KEYS + _WAVE_V10_KEYS + _WAVE_V12_KEYS
    + _WAVE_V13_KEYS}

#: The v9 wave field set (mux attribution, no async-I/O gauge).
WAVE_FIELDS_V9: Dict[str, tuple] = {
    k: v for k, v in WAVE_FIELDS.items()
    if k not in _WAVE_V10_KEYS + _WAVE_V12_KEYS + _WAVE_V13_KEYS}

#: The v10-v11 wave field set (async-I/O gauge, no expand_impl).
WAVE_FIELDS_V11: Dict[str, tuple] = {
    k: v for k, v in WAVE_FIELDS.items()
    if k not in _WAVE_V12_KEYS + _WAVE_V13_KEYS}

#: The v12 wave field set (expand_impl, no cost attribution).
WAVE_FIELDS_V12: Dict[str, tuple] = {
    k: v for k, v in WAVE_FIELDS.items() if k not in _WAVE_V13_KEYS}

_WAVE_FIELDS_BY_VERSION = {1: WAVE_FIELDS_V1, 2: WAVE_FIELDS_V2,
                           3: WAVE_FIELDS_V2, 4: WAVE_FIELDS_V2,
                           5: WAVE_FIELDS_V5, 6: WAVE_FIELDS_V6,
                           7: WAVE_FIELDS_V6, 8: WAVE_FIELDS_V8,
                           9: WAVE_FIELDS_V9, 10: WAVE_FIELDS_V11,
                           # v11 added event types only; its wave
                           # field set matches v10.
                           11: WAVE_FIELDS_V11, 12: WAVE_FIELDS_V12,
                           # v14 added event types only; its wave
                           # field set matches v13.
                           13: WAVE_FIELDS, 14: WAVE_FIELDS}

#: Required fields per trace event type (beyond the stamped
#: schema_version/engine/run/t, which every event carries).
EVENT_TYPES: Dict[str, Dict[str, tuple]] = {
    "run_start": {"unix_t": _NUM, "meta": (dict,)},
    "wave": {},  # checked field-exactly against WAVE_FIELDS instead
    "span": {"name": _STR, "dur": _NUM, "depth": _INT},
    "counter": {"name": _STR, "value": _NUM, "inc": _NUM},
    "gauge": {"name": _STR, "value": _NUM},
    "grow": {"kind": _STR, "old": _INT, "new": _INT},
    "overflow_redispatch": {"bucket": _INT, "out_rows": _INT,
                            "novel": _INT},
    "run_end": {"dur": _NUM, "counters": (dict,)},
    # v3: the resilience family. trace_lint additionally asserts every
    # fault is eventually followed by a recover or a terminal abort.
    "fault": {"point": _STR, "hit": _INT, "mode": _STR},
    "recover": {"attempt": _INT, "backoff_s": _NUM,
                "resumed_from": _STR + (_NULL,)},
    "degrade": {"kind": _STR, "old": _INT, "new": _INT},
    "abort": {"reason": _STR, "attempts": _INT},
    # v4: the membership/elasticity family. trace_lint additionally
    # asserts every worker_lost is eventually followed by a
    # migrate_done or a terminal abort (the membership invariant), and
    # counts retry like recover for the fault pairing.
    "worker_lost": {"worker": _STR, "epoch": _INT},
    "worker_join": {"worker": _STR, "epoch": _INT},
    "migrate_done": {"partitions": _INT, "to": _STR, "epoch": _INT},
    "rebalance": {"partitions": _INT, "to": _STR, "epoch": _INT},
    "retry": {"attempt": _INT, "backoff_s": _NUM, "jitter_s": _NUM,
              "resumed_from": _STR + (_NULL,)},
    # v5: the distributed-observability family. ``straggler`` is the
    # coordinator's per-round attribution record — ``workers`` maps
    # each worker to its segment timings ({compute_s, exchange_s,
    # wait_s, states_s, load_share}); ``wait_share`` is the fraction
    # of worker-time the round spent idle at the barrier.
    # ``postmortem`` heads a flight-recorder dump file (obs/flight.py)
    # and is followed by the ring's recorded events verbatim.
    "straggler": {"round": _INT, "epoch": _INT,
                  "slowest": _STR + (_NULL,), "wait_share": _NUM,
                  "workers": (dict,)},
    "postmortem": {"reason": _STR, "name": _STR, "events": _INT},
    # v6: the tiered-state-store family. ``spill`` records rows moving
    # DOWN a tier (``tier`` is the destination: "host" or "disk";
    # ``kind`` is what moved: "visited" / "frontier" / "arena_span"),
    # ``page_in`` a paged-out frontier block returning ahead of
    # dispatch, and ``pressure`` a tier crossing or resetting against
    # its byte budget (trace_lint's monotonicity window marker).
    "spill": {"tier": _STR, "kind": _STR, "rows": _INT, "bytes": _INT},
    "page_in": {"tier": _STR, "kind": _STR, "rows": _INT,
                "bytes": _INT},
    "pressure": {"tier": _STR, "used": _INT, "budget": _INT},
    # v7: the job-service family. ``job`` is the service-assigned job
    # id — the lint's pairing key (every submit eventually paired with
    # a done or abort for the SAME id). ``job_done`` carries the final
    # cumulative counters so a per-job summary never needs to fold the
    # wave stream; ``job_abort``'s reason distinguishes a preemption
    # (checkpointed, resumable) from a terminal failure.
    "job_submit": {"job": _STR, "model": _STR, "job_engine": _STR},
    "job_done": {"job": _STR, "states": _INT, "unique": _INT},
    "job_abort": {"job": _STR, "reason": _STR},
    # v10: the async-I/O checkpoint lifecycle. ``gen`` is the writer's
    # per-run generation counter (monotone; rotation keeps gen-1 as
    # ``.prev``); ``async`` records whether the write ran on the
    # background writer thread or inline. ``ckpt_done`` is emitted by
    # whichever thread finished the write — trace_lint pairs begin/done
    # oldest-first per run and lets a ``fault``/``abort`` explain a
    # begin whose write died mid-flight.
    "ckpt_begin": {"gen": _INT, "path": _STR, "async": _BOOL},
    "ckpt_done": {"gen": _INT, "path": _STR, "write_s": _NUM},
    # v11: the service-observability family. ``hist_snapshot`` is one
    # producer's cumulative latency histograms at a bounded cadence
    # (``hists``: series key -> {"buckets", "sum", "count"}; ``snap``:
    # the producer's emission ordinal — trace_lint asserts per-series
    # monotonicity and sum/count consistency). ``slo_breach`` is the
    # edge-triggered healthy->breaching transition of one rolling
    # error-budget objective. ``anomaly`` is one slow-wave verdict
    # with its attributed cause (compile / io_stall / straggler /
    # spill / unknown).
    "hist_snapshot": {"hists": (dict,), "snap": _INT},
    "slo_breach": {"objective": _STR, "target": _NUM, "burn": _NUM,
                   "window_s": _NUM, "good": _INT, "bad": _INT},
    # v13: the ``anomaly`` cause vocabulary additionally includes
    # ``cost_model`` (obs/anomaly.py — a program whose measured time
    # drifts from its own cost-normalized history).
    "anomaly": {"cause": _STR, "key": _STR, "dur_s": _NUM,
                "baseline_s": _NUM, "dev_s": _NUM},
    # v13: one sampled dispatch's roofline gauges (obs/prof.py).
    # ``key`` is the canonical program key the static cost record is
    # filed under; ``snap`` is the producer's sample ordinal (strictly
    # increasing per run — the lint invariant); ``measured_s`` the
    # rest-point-timed dispatch seconds; ``cost_ratio`` measured
    # seconds over the program's own first sampled baseline (finite by
    # construction). The flops/bytes gauges are ``null`` for programs
    # with no AOT cost analysis.
    "profile_snapshot": {"key": _STR, "kernel_path": _STR + (_NULL,),
                         "expand_impl": _STR + (_NULL,), "snap": _INT,
                         "measured_s": _NUM, "cost_ratio": _NUM,
                         "flops": _NUM + (_NULL,),
                         "bytes": _NUM + (_NULL,),
                         "peak_bytes": _INT + (_NULL,),
                         "flops_per_s": _NUM + (_NULL,),
                         "bytes_per_s": _NUM + (_NULL,),
                         "intensity": _NUM + (_NULL,)},
    # v14: the overload-control family (service/control.py). ``admit``
    # is one submission let through while the admission gate was
    # engaged; ``shed`` one rejected at the door — ``reason`` is
    # mandatory and machine-readable (slo_burn / queue_full /
    # retry_budget / brownout) and ``retry_after_s`` is what the 429
    # told the client, derived from the observed drain rate. ``park``
    # / ``resume`` bracket a controller preemption: the lint pairs
    # them by exact job id (a park not eventually resumed or
    # terminally aborted lost work). ``controller`` is one
    # brownout-ladder transition — edge-triggered per run (the rung
    # must change), with requested/kept honesty.
    "admit": {"job": _STR, "tenant": _STR, "priority": _INT,
              "queue_depth": _INT},
    "shed": {"tenant": _STR, "priority": _INT, "reason": _STR,
             "retry_after_s": _NUM},
    "park": {"job": _STR, "reason": _STR},
    "resume": {"job": _STR, "resumed_as": _STR},
    "controller": {"rung": _INT, "action": _STR, "requested": _INT,
                   "kept": _INT},
}

_STAMPED = {"type": _STR, "schema_version": _INT, "engine": _STR,
            "run": _STR, "t": _NUM}

#: Required fields of a device_session stdout event (the rest of the
#: payload is event-specific and unconstrained).
SESSION_FIELDS = {"event": _STR, "schema_version": _INT, "t": _NUM,
                  "unix_t": _NUM}


def _typecheck(value, types) -> bool:
    # bool subclasses int: a field typed int/float must not accept True.
    if isinstance(value, bool):
        return bool in types
    return isinstance(value, tuple(t for t in types if t is not bool))


def _check_fields(obj: dict, fields: Dict[str, tuple],
                  where: str) -> List[str]:
    errors = []
    for name, types in fields.items():
        if name not in obj:
            errors.append(f"{where}: missing field {name!r}")
        elif not _typecheck(obj[name], types):
            errors.append(
                f"{where}: field {name!r} has type "
                f"{type(obj[name]).__name__}, expected "
                f"{'/'.join(t.__name__ for t in types)}")
    return errors


def validate_event(obj) -> List[str]:
    """Validates one decoded event (trace or session family); returns a
    list of error strings (empty = valid)."""
    if not isinstance(obj, dict):
        return ["event is not a JSON object"]
    if "event" in obj and "type" not in obj:
        where = f"session event {obj.get('event')!r}"
        errors = _check_fields(obj, SESSION_FIELDS, where)
        if (isinstance(obj.get("schema_version"), int)
                and obj["schema_version"] > SCHEMA_VERSION):
            errors.append(f"{where}: schema_version "
                          f"{obj['schema_version']} is newer than this "
                          f"validator ({SCHEMA_VERSION})")
        return errors
    etype = obj.get("type")
    where = f"trace event {etype!r}"
    if etype not in EVENT_TYPES:
        return [f"{where}: unknown type (expected one of "
                f"{sorted(EVENT_TYPES)})"]
    errors = _check_fields(obj, _STAMPED, where)
    ver = obj.get("schema_version")
    if isinstance(ver, int) and ver > SCHEMA_VERSION:
        # A capture from a NEWER build: one clear message, no cascade
        # of field-set mismatches the reader cannot act on.
        errors.append(
            f"{where}: schema_version {ver} is newer than this "
            f"validator ({SCHEMA_VERSION}); upgrade the tools to lint "
            "this capture")
        return errors
    if etype == "wave":
        # Older captures validate against THEIR version's exact field
        # set (v1 predates the bandwidth gauges).
        fields = _WAVE_FIELDS_BY_VERSION.get(
            ver if isinstance(ver, int) else SCHEMA_VERSION,
            WAVE_FIELDS)
        errors += _check_fields(obj, fields, where)
        extras = set(obj) - set(fields)
        if extras:
            # Exact field set: one schema for every engine, no
            # per-engine riders — additions go through a version bump.
            errors.append(f"{where}: unexpected fields "
                          f"{sorted(extras)}")
        if ("engine" in obj and obj.get("engine") not in ENGINE_IDS):
            errors.append(f"{where}: engine {obj.get('engine')!r} not in "
                          f"{ENGINE_IDS}")
    else:
        errors += _check_fields(obj, EVENT_TYPES[etype], where)
    return errors


def validate_line(line: str) -> List[str]:
    """Validates one raw JSONL line (blank lines are skipped)."""
    import json

    line = line.strip()
    if not line:
        return []
    try:
        obj = json.loads(line)
    except ValueError as e:
        return [f"invalid JSON: {e}"]
    return validate_event(obj)
