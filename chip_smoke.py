#!/usr/bin/env python3
"""Builds the port's kernels and drives the port on one CUDA card.

Usage, from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. build ``stateright_tpu_torch/csrc/table.cu`` and ``wave_twopc.cu``
   for ``sm_90a``, one ``nvcc`` each, both at once, and print each build
   time with ptxas' register and spill report, and the card's name and
   power limit;
2. hold the dedup kernel against its plain torch version at the shape of
   a full-width wave (S = 16,384 x 52 = 851,968 fingerprints against a
   2^27-slot table filled to 30%): masks and counts equal, tables equal
   as sets; time both;
3. hold the wave kernel against its plain version at full width: 16,384
   packed rows of 2pc at 10 RMs from a mid-run arena against a 2^27-slot
   table filled to 30%, plain and with symmetry: all five outputs and
   the counts equal, tables equal as sets; time both;
4. 2pc at 3 and 5 RMs on the card, and 5 with symmetry: 288 / 1,146,
   8,832 / 58,146 and 314 / 2,048, with the same discovery fingerprint
   chains as the same run on the CPU (the plain path), each with the
   dedup kernel and with the wave kernel;
5. full width, 2pc at 10 RMs with batch 16,384, once with each path:
   exactly 61,515,776 unique / 817,760,258 states, with the kernels'
   launch counts beside the waves and rehashes; then dispatches of a
   mid-run checker: one under ``torch.cuda.set_sync_debug_mode("error")``,
   four timed plain for the steady pace a wave, and one under
   ``torch.profiler`` (kernel time by kernel), which together give the
   card's idle share;
6. the kernels line, the card line and the result line.

It imports neither JAX nor ``stateright_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# The data sheet's float32 rate outside the tensor cores; it has none for
# 32-bit integer operations, which Hopper issues at most at that rate.
OPS_PER_S = 67e12
FULL_UNIQUE, FULL_STATES = 61_515_776, 817_760_258
BATCH = 16_384


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _time_ms(torch, fn, reps: int, setup=None) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, CUDA events around
    each call only (``setup`` runs outside the timed window)."""
    total = 0.0
    for _ in range(reps):
        args = setup() if setup is not None else ()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _device_ms(torch, fn, reps: int, setup) -> float:
    """Mean device time of ``fn`` a call: the summed time of the device
    work (kernels and memsets) it launches, from ``torch.profiler``. A
    CUDA-event window around one call also holds the gaps while the host
    launches, which at a fraction of a millisecond is most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = [setup() for _ in range(reps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in args:
            fn(*a)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us == 0:
        raise AssertionError("the profiler saw no device time")
    return us / 1e3 / reps


def _filled_table(torch, engine, gen, C):
    """A ``C``-slot table 30% full of random keys, filled through the
    plain version in chunks: ``(table, resident keys)``."""
    dev = torch.device("cuda")
    resident = torch.randint(1, 1 << 62, (int(0.3 * C),), generator=gen,
                             device=dev)
    table = torch.full((C,), -1, dtype=torch.int64, device=dev)
    for chunk in resident.split(1 << 22):
        engine.global_insert(chunk, torch.ones_like(chunk, dtype=torch.bool),
                             table)
    return table, resident


def phase_kernel(torch, table_mod, engine):
    """The kernel against its plain version at the full-width shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    S, C = BATCH * 52, 1 << 27

    def rand(n):
        return torch.randint(1, 1 << 62, (n,), generator=gen, device=dev)

    table, resident = _filled_table(torch, engine, gen, C)
    # The reference tests' stream: duplicates, sentinels, revisits.
    fresh = rand(S)
    fps = fresh.clone()
    u = torch.rand(S, generator=gen, device=dev)
    dup = u < 0.3
    fps = torch.where(dup, fresh[torch.randint(0, S, (S,), generator=gen,
                                               device=dev)], fps)
    rev = torch.rand(S, generator=gen, device=dev) < 0.2
    fps = torch.where(rev, resident[torch.randint(
        0, resident.numel(), (S,), generator=gen, device=dev)], fps)
    fps = torch.where(torch.rand(S, generator=gen, device=dev) < 0.1,
                      torch.full_like(fps, -1), fps)

    t_k, t_p = table.clone(), table.clone()
    out_k = table_mod.dedup_and_insert(fps, t_k)
    out_p = table_mod.dedup_and_insert_plain(fps, t_p)
    torch.cuda.synchronize()
    errs = [int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            for a, b in zip(out_k, out_p)]
    max_err = max(errs)
    if max_err != 0:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"per-output max abs err {errs}")
    if not torch.equal(torch.sort(t_k).values, torch.sort(t_p).values):
        raise AssertionError("kernel's table differs from the plain "
                             "version's as a set")
    new, cand = int(out_k[2]), int(out_k[3])
    valid = int((fps != -1).sum())
    _log(f"kernel == plain at S={S}, C=2^27: new={new} cand={cand} "
         f"valid={valid}")

    call_ms = _time_ms(torch, table_mod.dedup_and_insert, 5,
                       lambda: (fps, table.clone()))
    ms = _device_ms(torch, table_mod.dedup_and_insert, 5,
                    lambda: (fps, table.clone()))
    plain_ms = _time_ms(torch, table_mod.dedup_and_insert_plain, 3,
                        lambda: (fps, table.clone()))
    # Bound: the bytes of the function itself, each once: the fps read,
    # the two masks written, and one 32-byte sector a candidate in the
    # visited table. The kernel's scratch table is neither input nor
    # output (at 12 B x 2^21 slots it can stay in the 50 MB L2).
    nbytes = 8 * S + 2 * S + 32 * cand
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    _log(f"dedup kernel {ms:.4f} ms on the card ({call_ms:.4f} ms a call "
         f"between CUDA events, the host's launches included), plain "
         f"{plain_ms:.4f} ms, bound "
         f"{bound_ms:.4f} ms ({nbytes} B over HBM)")
    del table, t_k, t_p, resident
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms)


def phase_wave_kernel(torch, wave_mod, engine, TwoPhaseSys):
    """The wave kernel against its plain version at the full-width shape:
    ``B`` packed rows of a mid-run arena of 2pc at 10 RMs."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    C = 1 << 27
    mid = (TwoPhaseSys(10).checker().target_state_count(3_000_000)
           .spawn_cuda_bfs(batch_size=BATCH, wave_kernel=True).join())
    if mid._tail - mid._head < BATCH:
        raise AssertionError(f"mid-run frontier of {mid._tail - mid._head} "
                             f"rows is narrower than {BATCH}")
    dm, layout = mid._dm, mid._layout
    store = mid._vecs[mid._head:mid._head + BATCH].clone()
    valid = torch.ones(BATCH, dtype=torch.bool, device="cuda")
    # 30% random keys plus every state the run has seen, so the wave's
    # successors revisit as they would in the run.
    table, resident = _filled_table(torch, engine, gen, C)
    seen = mid._table[mid._table != -1]
    engine.global_insert(seen, torch.ones_like(seen, dtype=torch.bool),
                         table)
    del mid, resident
    S, W, wp = BATCH * dm.max_fanout, dm.state_width, layout.packed_width
    names = ("succ_store", "path_fps", "sflat", "new_mask", "cand_mask",
             "new_count", "cand_count", "full")
    out = {}
    for use_sym in (False, True):
        t_k, t_p = table.clone(), table.clone()
        got = wave_mod.wave_megakernel(dm, store, valid, t_k, use_sym, layout)
        want = wave_mod.wave_megakernel_plain(dm, store, valid, t_p, use_sym,
                                              layout)
        torch.cuda.synchronize()
        for name, a, b in zip(names, got, want):
            if not torch.equal(a, b):
                err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                raise AssertionError(f"wave kernel (sym={use_sym}) disagrees "
                                     f"with its plain version on {name}: "
                                     f"max abs err {err}")
        if not torch.equal(torch.sort(t_k).values, torch.sort(t_p).values):
            raise AssertionError(f"wave kernel's table (sym={use_sym}) "
                                 "differs from the plain version's as a set")
        n_valid, new, cand = int(got[2].sum()), int(got[5]), int(got[6])
        del t_k, t_p, got, want

        def setup():
            return dm, store, valid, table.clone(), use_sym, layout

        call_ms = _time_ms(torch, wave_mod.wave_megakernel, 5, setup)
        ms = _device_ms(torch, wave_mod.wave_megakernel, 5, setup)
        plain_ms = _time_ms(torch, wave_mod.wave_megakernel_plain, 3, setup)
        # Bound: the function's own bytes, each once: the packed batch and
        # valid read, the packed successors, path fingerprints and three
        # byte masks written, and one 32-byte sector a candidate in the
        # visited table. The dedup fingerprints and the scratch table are
        # neither input nor output. Operations: 32-bit integer ops of the
        # path fingerprint, unpack, step and re-pack of every slot, and of
        # the representative's sort and fingerprint of each valid slot
        # under symmetry.
        nbytes = 4 * BATCH * wp + BATCH + 4 * S * wp + 8 * S + 3 * S \
            + 32 * cand
        fp_ops = 2 * (6 * W + 9) + 4
        ops = S * (fp_ops + 8 * W)
        if use_sym:
            n = dm.rm_count
            ops += n_valid * (fp_ops + 2 * n * n)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        tag = "sym" if use_sym else "plain"
        _log(f"wave kernel == plain ({tag}) at B={BATCH}, S={S}, C=2^27: "
             f"valid={n_valid} cand={cand} new={new}; kernel {ms:.4f} ms on "
             f"the card ({call_ms:.4f} ms a call between CUDA events), plain "
             f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B over "
             f"HBM: {bytes_ms:.4f} ms; {ops} ops: {ops_ms:.4f} ms)")
        out[tag] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms,
                        bound_by="bytes" if bytes_ms >= ops_ms
                        else "operations")
    del table
    return out


def _chains(c):
    return {name: p.fingerprints for name, p in c.discoveries().items()}


def phase_small(TwoPhaseSys):
    for n, unique, states, sym in ((3, 288, 1146, False),
                                   (5, 8832, 58146, False),
                                   (5, 314, 2048, True)):
        def spawn(**kw):
            b = TwoPhaseSys(n).checker()
            return (b.symmetry() if sym else b).spawn_cuda_bfs(
                batch_size=1024, **kw).join()

        cpu = spawn(device="cpu")
        for wave_kernel, path in ((False, "dedup_kernel"),
                                  (True, "megakernel")):
            gpu = spawn(wave_kernel=wave_kernel)
            got = (gpu.unique_state_count(), gpu.state_count())
            tag = f"2pc {n}{' sym' if sym else ''} {path}"
            if got != (unique, states):
                raise AssertionError(f"{tag}: {got} != {(unique, states)}")
            if gpu.kernel_path() != path:
                raise AssertionError(f"{tag}: kernel_path() is "
                                     f"{gpu.kernel_path()}")
            if _chains(gpu) != _chains(cpu) or len(_chains(gpu)) != 2:
                raise AssertionError(f"{tag}: discovery chains differ from "
                                     "the CPU run")
            _log(f"{tag}: unique={got[0]} states={got[1]}, discoveries "
                 f"{sorted(_chains(gpu))} equal to the CPU run's")


def phase_full(torch, table_mod, wave_mod, fused, TwoPhaseSys, wave_kernel):
    torch.cuda.reset_peak_memory_stats()
    table_mod.dedup_and_insert.launches = 0
    wave_mod.wave_megakernel.launches = 0
    t0 = time.monotonic()
    c = TwoPhaseSys(10).checker().spawn_cuda_bfs(
        batch_size=BATCH, wave_kernel=wave_kernel).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = table_mod.dedup_and_insert.launches
    wave_launches = wave_mod.wave_megakernel.launches
    unique, states = c.unique_state_count(), c.state_count()
    _log(f"2pc 10 ({c.kernel_path()}): unique={unique} states={states} "
         f"sec={sec:.3f} states/s={states / sec:.1f} waves={c.waves} "
         f"dispatches={c.dispatches} rehashes={c.rehashes} "
         f"arena_grows={c.arena_grows} candidates={c.candidates} "
         f"dedup_launches={launches} wave_launches={wave_launches} "
         f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    if (unique, states) != (FULL_UNIQUE, FULL_STATES):
        raise AssertionError(f"2pc 10: {(unique, states)} != "
                             f"{(FULL_UNIQUE, FULL_STATES)}")
    found = c.discoveries()
    if sorted(found) != ["abort agreement", "commit agreement"]:
        raise AssertionError(f"2pc 10 discoveries: {sorted(found)}")
    c.assert_properties()
    c_waves, c_dispatches = c.waves, c.dispatches
    # Every dispatch launches K waves, also those past a rest point.
    if wave_kernel and (wave_launches != c._K * c.dispatches
                        or launches != c.rehashes):
        raise AssertionError(
            f"{wave_launches} wave kernel launches for {c._K} x "
            f"{c.dispatches} launched waves, {launches} dedup kernel "
            f"launches for {c.rehashes} rehashes")
    if not wave_kernel and (wave_launches != 0 or launches == 0
                            or launches < c.waves + c.rehashes):
        raise AssertionError(f"{launches} kernel launches for {c.waves} "
                             f"waves and {c.rehashes} rehashes")
    del c

    # Dispatches of a mid-run checker, each timed alone with its rest
    # point's growth outside the window: the first with every
    # synchronisation an error (nothing inside a dispatch may wait for
    # the card), then a few plain ones for the steady pace, then one
    # under torch.profiler for the kernel time.
    mid = (TwoPhaseSys(10).checker().target_state_count(20_000_000)
           .spawn_cuda_bfs(batch_size=BATCH, wave_kernel=wave_kernel).join())
    mid._stats[fused.ST_TARGET] = 1 << 62
    waves, dev_ms, wall_ms = _timed_dispatch(torch, fused, mid,
                                             sync_check=True)
    if waves == 0:
        raise AssertionError("the sync-checked dispatch ran no wave")
    _log(f"one dispatch under set_sync_debug_mode('error'): {waves} waves, "
         f"no synchronisation, {dev_ms:.3f} ms on the card, "
         f"{wall_ms:.3f} ms wall")
    # Every dispatch launches K waves' work, also those past a rest
    # point (no-ops with no valid row), so the pace is per launched wave.
    K = mid._K
    steady = [_timed_dispatch(torch, fused, mid) for _ in range(4)]
    for w, d, h in steady:
        _log(f"steady dispatch: {w} of {K} waves expanded rows, {d:.3f} ms "
             f"on the card, {h:.3f} ms wall, {h / K:.3f} ms a launched wave")
    wave_ms = sum(h for _, _, h in steady) / (K * len(steady))
    _log(f"steady pace: {wave_ms:.3f} ms a launched wave over "
         f"{K * len(steady)} (the full run: {sec * 1e3 / c_waves:.3f} ms a "
         f"wave that expanded rows, {sec * 1e3 / (K * c_dispatches):.3f} "
         "ms a launched wave, rest points included)")
    busy_ms, launches_pw = phase_profile(torch, fused, mid)
    _log(f"card busy {busy_ms:.3f} ms a launched wave: {busy_ms / wave_ms:.1%}"
         f" of the steady pace, idle {1 - busy_ms / wave_ms:.1%}; host time "
         f"an op {wave_ms / launches_pw * 1e3:.2f} us ({launches_pw:.1f} "
         "kernel launches a launched wave)")
    return wave_launches if wave_kernel else launches


def _timed_dispatch(torch, fused, mid, sync_check=False):
    """Grows ``mid`` if at a rest point, then runs one dispatch timed by
    CUDA events and the host clock: ``(waves, device ms, wall ms)``."""
    mid._grow()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    if sync_check:
        torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        stats = mid._dispatch()
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    mid._stats = stats
    mid._process(stats.cpu().numpy())
    return int(stats[fused.ST_WAVES]), start.elapsed_time(end), wall_ms


def phase_profile(torch, fused, mid):
    """Device time of the next dispatch, by kernel (torch.profiler):
    ``(kernel ms, kernel launches)`` a launched wave."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mid._grow()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats = mid._dispatch()
        torch.cuda.synchronize()
    waves = int(stats[fused.ST_WAVES])
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda e: -e.self_device_time_total)
    total_ms = sum(e.self_device_time_total for e in kern) / 1e3
    port_ms = sum(e.self_device_time_total for e in kern
                  if "claim" in e.key or "wave_front" in e.key) / 1e3
    n_launch = sum(e.count for e in kern)
    _log(f"profiled dispatch: {waves} waves, {n_launch} kernel launches, "
         f"{total_ms:.3f} ms of kernel time, the port's kernels "
         f"{port_ms:.3f} ms")
    for e in kern[:8]:
        _log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
             f"{e.key[:90]}")
    if waves == 0:
        raise AssertionError("the profiled dispatch ran no wave")
    return total_ms / mid._K, n_launch / mid._K


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stateright_tpu_torch import _build, engine, fused
    from stateright_tpu_torch import table as table_mod
    from stateright_tpu_torch import wave as wave_mod
    from stateright_tpu_torch.models.twopc import TwoPhaseSys

    def build(name, load):
        t0 = time.monotonic()
        load()
        return name, time.monotonic() - t0

    # One nvcc a source, all started together.
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(build, "table", table_mod._lib),
                  pool.submit(build, "wave_twopc",
                              lambda: wave_mod._entry("twopc", 1))]
        for fut in builds:
            name, sec = fut.result()
            _log(f"built csrc/{name}.cu in {sec:.2f} s")
            with open(os.path.join(_build.BUILD_DIR, name + ".log")) as f:
                _log(f.read().strip())
    card = _card_line()
    _log(f"card: {card}")

    k = phase_kernel(torch, table_mod, engine)
    w = phase_wave_kernel(torch, wave_mod, engine, TwoPhaseSys)
    phase_small(TwoPhaseSys)
    launches = phase_full(torch, table_mod, wave_mod, fused, TwoPhaseSys,
                          wave_kernel=False)
    wave_launches = phase_full(torch, table_mod, wave_mod, fused,
                               TwoPhaseSys, wave_kernel=True)

    wk = w["plain"]
    print(json.dumps({"kernels": [{
        "name": "dedup_and_insert", "route": "cuda",
        "source": "stateright_tpu_torch/csrc/table.cu",
        "replaces": "stateright_tpu/tpu/pallas_table.py:256",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": "bytes",
        "library_ms": None}, {
        "name": "wave_megakernel", "route": "cuda",
        "source": "stateright_tpu_torch/csrc/wave_twopc.cu",
        "replaces": "stateright_tpu/tpu/pallas_table.py:380",
        "launches": wave_launches,
        "max_abs_err": max(v["max_abs_err"] for v in w.values()),
        "ms": wk["ms"], "plain_ms": wk["plain_ms"],
        "bound_ms": wk["bound_ms"], "bound_by": wk["bound_by"],
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except BaseException:  # any phase's failure fails the run
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
