"""Wave-time attribution: each stage of a BFS wave timed on its own.

The port's copy of ``stateright_tpu/tpu/profiling.py::
measure_wave_breakdown``. It drives a real BFS frontier for a few waves,
running each stage of the wave as a call of its own and timing it: on
the card between two CUDA events, waited for before the next stage; on
the CPU by ``time.perf_counter``. The stages, JAX's names:

- ``unpack``: packed storage rows to lanes (zero without a packing);
- ``properties``: the device property predicates on the batch;
- ``expand``: the model's step with boundary pruning;
- ``matmul_expand``: the same expand in its transition-table form
  (``matmul_wave.matmul_expand``), timed on the same batches; zero when
  the model is not matmul-regular;
- ``fingerprint``: the successors' fingerprints;
- ``local_dedup``: the first occurrence of each fingerprint in the wave,
  in the torch form the port's sender side runs
  (``engine.first_occurrence_sorted``);
- ``dedup_insert``: kernel 1 (``table.dedup_and_insert``) on the wave's
  fingerprints, with a scratch of its own, against the staged table. The
  kernel finds the first occurrences itself, so this stage holds that
  pass again;
- ``compact``: the new rows' compaction order and gathers;
- ``pack``: the new rows re-packed (zero without a packing);
- ``wave_kernel``: kernel 2 (``wave.wave_megakernel``), the whole
  successor path in one launch on the packed batch, against a table copy
  of its own; read its share against the sum of the stages it replaces;
- ``host``: the host's time between the stages.

``fused_wave_sec`` times the port's production wave
(``classic.classic_wave`` on the torch stages and kernel 1) on the same
batches, against its own table copy, and ``fused_wave_ladder_sec`` the
same wave at the output rung that holds the wave's new rows. A bucket's
first wave (its kernels' builds and loads, the allocator's first sizes)
is left out of every sum, as JAX leaves out its compiles. ``deadline_s``
bounds the whole measurement, checked at every stage boundary.

Every staged call is a sample of an always-armed wave profiler
(``obs/prof.py``, cadence 1): kernel 1's and kernel 2's stages carry
their declared costs (``table.dedup_cost``, ``wave.wave_cost``), the
torch stages null ones, and the result's ``roofline`` gives each
stage's last snapshot. With ``STpu_TRACE`` set, every stage is a span of
the trace and the sums land as gauges.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .classic import classic_wave
from .engine import (batch_bucket_ladder, compaction_order, eval_properties,
                     expand_frontier, fingerprint_successors,
                     first_occurrence_sorted, pick_bucket,
                     succ_bucket_ladder)
from .hashing import host_fp64
from .matmul_wave import classify, matmul_expand
from .model import property_predicates
from .obs import tracer_from_env
from .obs.prof import WaveProfiler
from .packing import compile_layout
from .table import DedupScratch, dedup_and_insert, dedup_cost
from .wave import wave_cost, wave_megakernel

__all__ = ["measure_wave_breakdown", "STAGES"]

#: the stages, JAX's names and order
STAGES = ("unpack", "properties", "expand", "matmul_expand", "fingerprint",
          "local_dedup", "dedup_insert", "compact", "pack", "wave_kernel",
          "host")


class _DeadlineHit(Exception):
    """Raised between stages once ``deadline_s`` is past."""


def _resolve(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "measure_wave_breakdown() needs a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def measure_wave_breakdown(model, device_model=None, batch_size: int = 1024,
                           table_capacity: int = 1 << 20,
                           max_waves: int = 12,
                           deadline_s: Optional[float] = None,
                           max_batch_size: Optional[int] = None,
                           device=None) -> Dict:
    """Runs up to ``max_waves`` BFS waves of ``model`` with each stage
    timed on its own; returns JAX's keys: ``stages_sec``,
    ``stages_share``, ``per_state_us``, ``fused_wave_sec``,
    ``fused_wave_ladder_sec``, ``staged_total_sec``, ``waves``,
    ``states``, ``batch_size``, ``bucket_ladder``, ``bucket_waves``,
    ``ladder_rows_waves``, ``local_dedup_collapse_ratio`` and
    ``roofline`` (by stage). ``max_batch_size`` picks each wave's width
    from the live frontier over the engines' bucket ladder. ``device``
    is the card unless the caller asks for the CPU."""
    dev = _resolve(device)
    on_card = dev.type == "cuda"
    dm = model.device_model() if device_model is None else device_model
    F, W = dm.max_fanout, dm.state_width
    ladder = batch_bucket_ladder(batch_size, max_batch_size)
    prop_fns = [fn for fn in property_predicates(model.properties(), dm)
                if fn is not None]
    layout = compile_layout(dm.lane_bits(), W)
    packs, wp = layout.packs, layout.packed_width
    tracer = tracer_from_env("profiling", meta={
        "model": type(model).__name__, "batch_size": batch_size,
        "table_capacity": table_capacity, "max_waves": max_waves})
    # Always armed at cadence 1: every staged call is a sample.
    prof = WaveProfiler("profiling", sample_every=1)
    mm = classify(dm, dev)
    plan = mm.plan if mm.regular else None
    scratch = (DedupScratch(ladder[-1] * F, dev) if on_card else None)

    init = np.stack([np.asarray(dm.encode(s), np.uint32)
                     for s in model.init_states()
                     if model.within_boundary(s)])
    frontier = init
    seen = {host_fp64(r) for r in init}

    def table():
        return torch.full((table_capacity,), -1, dtype=torch.int64,
                          device=dev)

    visited, visited_f, visited_l, visited_k = (table(), table(), table(),
                                                table())

    stages = {k: 0.0 for k in STAGES}
    bucket_waves: Dict[int, int] = {}
    ladder_waves: Dict[int, int] = {}
    warm_buckets: set = set()
    warm_ladder: set = set()
    fused_sec = fused_ladder_sec = 0.0
    succ_total = cand_total = states = waves = 0
    t_start = time.perf_counter()
    t_host = t_start

    def over() -> bool:
        return (deadline_s is not None
                and time.perf_counter() - t_start > deadline_s)

    def run_timed(fn, *args):
        """``fn(*args)`` and its seconds, the host's perf_counter at its
        start, and the host's at its end."""
        t0 = time.perf_counter()
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3
        else:
            out = fn(*args)
            sec = time.perf_counter() - t0
        return out, sec, t0, time.perf_counter()

    while frontier.shape[0] and waves < max_waves and not over():
        B = pick_bucket(ladder, frontier.shape[0])
        S = B * F
        warmed = B in warm_buckets
        n = min(B, frontier.shape[0])
        batch = np.zeros((B, W), np.uint32)
        batch[:n] = frontier[:n]
        frontier = frontier[n:]
        valid = np.zeros((B,), bool)
        valid[:n] = True
        store = torch.from_numpy(layout.pack_np(batch).view(np.int32)).to(dev)
        d_valid = torch.from_numpy(valid).to(dev)
        wave_stages = {k: 0.0 for k in STAGES}
        costs = {"dedup_insert": lambda: dedup_cost(S),
                 "wave_kernel": lambda: wave_cost(dm, B, wp)}

        def timed(name, fn, *args):
            nonlocal t_host
            pkey = f"profiling|{name}|({B},)"
            cost = costs.get(name)
            prof.capture(pkey, None if cost is None else cost())
            out, sec, t0, t_host_now = run_timed(fn, *args)
            wave_stages["host"] += t0 - t_host
            wave_stages[name] += sec
            t_host = t_host_now
            prof.should_sample(pkey)
            prof.wave({"kernel_path": ("megakernel" if on_card
                                       else "megakernel_plain")
                       if name == "wave_kernel" else None,
                       "expand_impl": {"expand": "step",
                                       "matmul_expand": "matmul"}.get(name)},
                      pkey, sec, tracer, None)
            if tracer.enabled:
                tracer.span_event(name, t0, sec, depth=1, bucket=B)
            if over():
                raise _DeadlineHit
            return out

        try:
            rows = (timed("unpack", layout.unpack, store) if packs
                    else layout.unpack(store))
            timed("properties", eval_properties, prop_fns, rows)
            succ, sval, succ_count, _ = timed("expand", expand_frontier, dm,
                                              rows, d_valid)
            if plan is not None:
                timed("matmul_expand", matmul_expand, dm, plan, rows, d_valid)
            dedup_fps, path_fps = timed("fingerprint", fingerprint_successors,
                                        dm, succ, sval, False)
            timed("local_dedup", first_occurrence_sorted, dedup_fps)
            new_mask, cand_mask, new_count, _, _ = timed(
                "dedup_insert", dedup_and_insert, dedup_fps, visited, scratch)

            def compact(mask, succ, path_fps):
                comp = compaction_order(mask)
                return succ[comp], path_fps[comp]

            new_vecs, new_fps = timed("compact", compact, new_mask, succ,
                                      path_fps)
            if packs:
                timed("pack", layout.pack, new_vecs)
            timed("wave_kernel", wave_megakernel, dm, store, d_valid,
                  visited_k, False, layout, scratch)
        except _DeadlineHit:
            break

        # The production wave on the same batch, its own table copy.
        _, wave_fused, t0, t_host = run_timed(
            classic_wave, dm, store, d_valid, visited_f, layout, prop_fns,
            False, None, False, scratch)
        if tracer.enabled:
            tracer.span_event("fused_wave", t0, wave_fused, depth=1,
                              bucket=B)
        if over():
            break
        k = int(new_count)
        # At the rung that holds this wave's new rows.
        K = pick_bucket(succ_bucket_ladder(S), max(k, 1))
        ladder_warm = (B, K) in warm_ladder
        _, wave_ladder, t0, t_host = run_timed(
            classic_wave, dm, store, d_valid, visited_l, layout, prop_fns,
            False, K, False, scratch)
        if tracer.enabled:
            tracer.span_event("fused_wave_ladder", t0, wave_ladder, depth=1,
                              bucket=B, out_rows=K)

        unpacked = new_vecs[:k].cpu().numpy().astype(np.uint32)
        fps_k = new_fps[:k].cpu().numpy().view(np.uint64)
        fresh = [v for v, f in zip(unpacked, fps_k.tolist())
                 if f not in seen and not seen.add(f)]
        if fresh:
            frontier = (np.concatenate([frontier, np.stack(fresh)])
                        if frontier.shape[0] else np.stack(fresh))
        if warmed and ladder_warm:
            for name in STAGES:
                stages[name] += wave_stages[name]
            fused_sec += wave_fused
            fused_ladder_sec += wave_ladder
            bucket_waves[B] = bucket_waves.get(B, 0) + 1
            ladder_waves[K] = ladder_waves.get(K, 0) + 1
            succ_total += int(succ_count)
            cand_total += int(cand_mask.sum())
            states += int(succ_count)
            waves += 1
        else:
            warm_buckets.add(B)
            warm_ladder.add((B, K))

    # Each stage's last snapshot: the declared costs of its kernel (null
    # for a torch stage) against its measured seconds.
    roofline_by_stage: Dict[str, dict] = {}
    for key, snap in prof.stats()["programs"].items():
        roofline_by_stage[key.split("|")[1]] = {
            f: snap.get(f) for f in ("flops", "bytes", "peak_bytes",
                                     "flops_per_s", "bytes_per_s",
                                     "intensity", "measured_s", "bound_s",
                                     "share")}

    staged_total = sum(stages.values())
    if tracer.enabled:
        for name, sec in stages.items():
            tracer.gauge(f"profiling_stage_sec.{name}", round(sec, 6))
        tracer.gauge("profiling_fused_wave_sec", round(fused_sec, 6))
        tracer.gauge("profiling_waves", waves)
        tracer.gauge("profiling_states", states)
    tracer.close()
    return {
        "stages_sec": {k: round(v, 4) for k, v in stages.items()},
        "stages_share": {k: round(v / max(staged_total, 1e-9), 3)
                         for k, v in stages.items()},
        "per_state_us": {k: round(1e6 * v / max(states, 1), 2)
                         for k, v in stages.items()},
        "fused_wave_sec": round(fused_sec, 4),
        "fused_wave_ladder_sec": round(fused_ladder_sec, 4),
        "staged_total_sec": round(staged_total, 4),
        "waves": waves,
        "states": states,
        "batch_size": batch_size,
        "bucket_ladder": list(ladder),
        "bucket_waves": {str(b): c for b, c in sorted(bucket_waves.items())},
        "ladder_rows_waves": {str(k): c
                              for k, c in sorted(ladder_waves.items())},
        "local_dedup_collapse_ratio": round(
            1.0 - cand_total / max(succ_total, 1), 4) if succ_total
        else 0.0,
        "roofline": roofline_by_stage,
    }
