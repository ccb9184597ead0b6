#!/usr/bin/env python3
"""Builds the port's kernels and drives the port on one CUDA card.

Usage, from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. build ``stateright_tpu_torch/csrc/table.cu`` and ``wave_twopc.cu``
   (the wave kernel's and the sender kernel's entry points) for
   ``sm_90a``, one ``nvcc`` each, both at once, and print each build
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
4. hold the sender kernel against its plain version at full width: the
   same rows as 4 shards of 4,096 (n * S = 851,968 slots), with symmetry
   and local dedup each on and off: all five outputs equal; time both;
5. 2pc at 3 and 5 RMs on the card, and 5 with symmetry: 288 / 1,146,
   8,832 / 58,146 and 314 / 2,048, with the same discovery fingerprint
   chains as the same run on the CPU (the plain path), each with the
   dedup kernel and with the wave kernel; then the same sharded on
   ``mesh=[cuda:0] * n`` at n = 1 and 4, with each path, against the
   CPU run at the same n; a mesh over distinct devices, and either
   kernel for a model without CUDA device code, raise on the card;
6. full width, 2pc at 10 RMs: batch 16,384 once with each path, and
   sharded at n = 4 with 4,096 rows a shard and the sender kernel:
   exactly 61,515,776 unique / 817,760,258 states, with the kernels'
   launch counts beside the waves and rehashes; then for each run,
   dispatches of a mid-run checker: one under
   ``torch.cuda.set_sync_debug_mode("error")``, four timed plain for the
   steady pace a wave, and one under ``torch.profiler`` (kernel time by
   kernel), which together give the card's idle share;
7. the kernels line, the card line and the result line.

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
SHARDS = 4


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


def _profiled(torch, run, prepare=lambda: None, tries: int = 3):
    """``(device events, result)`` of ``run(prepare())`` under
    ``torch.profiler``, ``prepare()`` outside the profiled window: the
    kernels and memsets ``run`` launched, by name. A profile that
    records no device time at all (seen once on the card, after an
    earlier profile in the same process) is taken again, ``tries`` times
    at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        arg = prepare()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = run(arg)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if sum(e.self_device_time_total for e in kern) > 0:
            return kern, out
        _log("the profiler saw no device time; profiling again")
    raise AssertionError(f"the profiler saw no device time in {tries} "
                         "profiles")


def _device_ms(torch, fn, reps: int, setup) -> float:
    """Mean device time of ``fn`` a call: the summed time of the device
    work (kernels and memsets) it launches, from ``torch.profiler``. A
    CUDA-event window around one call also holds the gaps while the host
    launches, which at a fraction of a millisecond is most of it."""
    def run(args):
        for a in args:
            fn(*a)

    kern, _ = _profiled(torch, run, lambda: [setup() for _ in range(reps)])
    return sum(e.self_device_time_total for e in kern) / 1e3 / reps


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
    return out, (dm, store, layout)


def phase_sender_kernel(torch, wave_mod, dm, store, layout):
    """The sender kernel against its plain version at the full-width
    shape: ``store``'s packed rows as ``SHARDS`` shards' batches."""
    B, wp = BATCH // SHARDS, layout.packed_width
    store = store.reshape(SHARDS, B, wp).contiguous()
    valid = torch.ones((SHARDS, B), dtype=torch.bool, device="cuda")
    W, n = dm.state_width, SHARDS
    S = B * dm.max_fanout
    names = ("succ_store", "dedup_fps", "path_fps", "sflat", "send_mask")
    out = {}
    for use_sym in (False, True):
        for local_dedup in (True, False):
            args = (dm, store, valid, use_sym, layout, local_dedup)
            got = wave_mod.sender_megakernel(*args)
            want = wave_mod.sender_megakernel_plain(*args)
            torch.cuda.synchronize()
            for name, a, b in zip(names, got, want):
                if not torch.equal(a, b):
                    err = int((a.to(torch.int64) - b.to(torch.int64))
                              .abs().max())
                    raise AssertionError(
                        f"sender kernel (sym={use_sym}, local_dedup="
                        f"{local_dedup}) disagrees with its plain version "
                        f"on {name}: max abs err {err}")
            n_valid, n_send = int(got[3].sum()), int(got[4].sum())
            del got, want
            ms = _device_ms(torch, wave_mod.sender_megakernel, 5,
                            lambda: args)
            call_ms = _time_ms(torch, wave_mod.sender_megakernel, 5,
                               lambda: args)
            plain_ms = _time_ms(torch, wave_mod.sender_megakernel_plain, 3,
                                lambda: args)
            # Bound: the function's own bytes, each once: the packed
            # batch and valid read; the packed successors, two
            # fingerprint arrays and two byte masks written. The scratch
            # is neither input nor output. Operations as the wave
            # kernel's: path fingerprint, unpack, step and re-pack of
            # every slot, and the representative of each valid slot
            # under symmetry.
            nbytes = (4 * n * B * wp + n * B + 4 * n * S * wp + 16 * n * S
                      + 2 * n * S)
            fp_ops = 2 * (6 * W + 9) + 4
            ops = n * S * (fp_ops + 8 * W)
            if use_sym:
                ops += n_valid * (fp_ops + 2 * dm.rm_count ** 2)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / OPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            tag = (f"{'sym' if use_sym else 'plain'}"
                   f"{'' if local_dedup else ', no local dedup'}")
            _log(f"sender kernel == plain ({tag}) at n={n} x B={B}, "
                 f"n*S={n * S}: valid={n_valid} sent={n_send}; kernel "
                 f"{ms:.4f} ms on the card ({call_ms:.4f} ms a call between "
                 f"CUDA events), plain {plain_ms:.4f} ms, bound "
                 f"{bound_ms:.4f} ms ({nbytes} B over HBM: {bytes_ms:.4f} ms; "
                 f"{ops} ops: {ops_ms:.4f} ms)")
            out[(use_sym, local_dedup)] = dict(
                max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
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


def phase_sharded_small(torch, fused, TwoPhaseSys):
    """The sharded engine on the card at n = 1 and ``SHARDS`` against its
    CPU run at the same n."""
    for n, unique, states, sym in ((3, 288, 1146, False),
                                   (5, 8832, 58146, False),
                                   (5, 314, 2048, True)):
        for shards in (1, SHARDS):
            def spawn(device, **kw):
                b = TwoPhaseSys(n).checker()
                return (b.symmetry() if sym else b).spawn_cuda_bfs(
                    mesh=[device] * shards, batch_size=256, **kw).join()

            cpu = spawn("cpu")
            for wave_kernel, path in ((False, "dedup_kernel"),
                                      (True, "sender_kernel")):
                gpu = spawn("cuda:0", wave_kernel=wave_kernel)
                got = (gpu.unique_state_count(), gpu.state_count())
                tag = f"2pc {n}{' sym' if sym else ''} n={shards} {path}"
                if got != (unique, states) or got != (
                        cpu.unique_state_count(), cpu.state_count()):
                    raise AssertionError(f"{tag}: {got} != "
                                         f"{(unique, states)}")
                if gpu.kernel_path() != path:
                    raise AssertionError(f"{tag}: kernel_path() is "
                                         f"{gpu.kernel_path()}")
                if _chains(gpu) != _chains(cpu) or len(_chains(gpu)) != 2:
                    raise AssertionError(f"{tag}: discovery chains differ "
                                         "from the CPU run")
                _log(f"{tag}: unique={got[0]} states={got[1]}, discoveries "
                     f"{sorted(_chains(gpu))} equal to the CPU run's")
    # The torch stages' sender side, sync-free too (the sender kernel's
    # path is checked at full width).
    mid = (TwoPhaseSys(5).checker().target_state_count(20_000)
           .spawn_cuda_bfs(mesh=["cuda:0"] * SHARDS, batch_size=256).join())
    mid._stats[..., fused.ST_TARGET] = 1 << 62
    waves = _timed_dispatch(torch, fused, mid, sync_check=True)[0]
    if waves == 0:
        raise AssertionError("the sync-checked dispatch ran no wave")
    _log(f"2pc 5 n={SHARDS} dedup_kernel: one dispatch under "
         f"set_sync_debug_mode('error'), {waves} waves, no synchronisation")


def phase_refusals(TwoPhaseSys, TwoPhaseDevice):
    """On the card, what the port lacks raises and never runs elsewhere:
    a mesh over distinct devices, and the kernels of a model without CUDA
    device code."""

    class NoCode(TwoPhaseDevice):
        def cuda_model(self):
            return None

    class NoCodeSys(TwoPhaseSys):
        def device_model(self):
            return NoCode(self.rm_count)

    for what, spawn in (
            ("a mesh over cuda:0 and the CPU", lambda: TwoPhaseSys(
                3).checker().spawn_cuda_bfs(mesh=["cuda:0", "cpu"])),
            ("the sender kernel without device code", lambda: NoCodeSys(
                3).checker().spawn_cuda_bfs(mesh=["cuda:0"] * SHARDS,
                                            wave_kernel=True)),
            ("the wave kernel without device code", lambda: NoCodeSys(
                3).checker().spawn_cuda_bfs(wave_kernel=True))):
        try:
            spawn().join()
        except NotImplementedError as e:
            _log(f"{what} raises: {e}")
        else:
            raise AssertionError(f"{what} ran instead of raising")


def phase_full(torch, kernels, fused, TwoPhaseSys, **spawn):
    """2pc at 10 RMs to its end through ``spawn_cuda_bfs(**spawn)``, with
    every kernel's launch count set to 0 just before and read just after;
    then the dispatches of a mid-run checker. Returns the launch counts
    by kernel name."""
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.monotonic()
    c = TwoPhaseSys(10).checker().spawn_cuda_bfs(**spawn).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    unique, states = c.unique_state_count(), c.state_count()
    n = getattr(c, "_n", 1)
    _log(f"2pc 10 ({c.kernel_path()}, {n} shard(s)): unique={unique} "
         f"states={states} sec={sec:.3f} states/s={states / sec:.1f} "
         f"waves={c.waves} dispatches={c.dispatches} rehashes={c.rehashes} "
         f"arena_grows={c.arena_grows} candidates={c.candidates} "
         f"launches={launches} "
         f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    if (unique, states) != (FULL_UNIQUE, FULL_STATES):
        raise AssertionError(f"2pc 10: {(unique, states)} != "
                             f"{(FULL_UNIQUE, FULL_STATES)}")
    found = c.discoveries()
    if sorted(found) != ["abort agreement", "commit agreement"]:
        raise AssertionError(f"2pc 10 discoveries: {sorted(found)}")
    c.assert_properties()
    c_waves, c_dispatches = c.waves, c.dispatches
    # Every dispatch launches K waves, also those past a rest point. A
    # wave and a rehash run the dedup kernel once a shard, unless the
    # single-kernel wave does the wave's dedup itself.
    launched = c._K * c.dispatches
    wave_kernel = spawn.get("wave_kernel", False)
    sharded = "mesh" in spawn
    want = {
        "dedup_and_insert": n * (c.rehashes + (
            launched if sharded or not wave_kernel else 0)),
        "wave_megakernel": launched if wave_kernel and not sharded else 0,
        "sender_megakernel": launched if wave_kernel and sharded else 0}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want} "
                             f"for {c._K} x {c.dispatches} launched waves "
                             f"and {c.rehashes} rehashes on {n} shard(s)")
    del c

    # Dispatches of a mid-run checker, each timed alone with its rest
    # point's growth outside the window: the first with every
    # synchronisation an error (nothing inside a dispatch may wait for
    # the card), then a few plain ones for the steady pace, then one
    # under torch.profiler for the kernel time.
    mid = (TwoPhaseSys(10).checker().target_state_count(20_000_000)
           .spawn_cuda_bfs(**spawn).join())
    mid._stats[..., fused.ST_TARGET] = 1 << 62
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
    return launches


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
    return _waves(fused, stats), start.elapsed_time(end), wall_ms


def _waves(fused, stats) -> int:
    """Waves that expanded rows, from one dispatch's stats (one row, or
    one a shard)."""
    return int(stats[..., fused.ST_WAVES].reshape(-1)[0])


def phase_profile(torch, fused, mid):
    """Device time of the next dispatch, by kernel (torch.profiler):
    ``(kernel ms, kernel launches)`` a launched wave."""
    def run(_):
        stats = mid._dispatch()
        mid._stats = stats
        mid._process(stats.cpu().numpy())
        return stats

    kern, stats = _profiled(torch, run, mid._grow)
    waves = _waves(fused, stats)
    kern.sort(key=lambda e: -e.self_device_time_total)
    total_ms = sum(e.self_device_time_total for e in kern) / 1e3
    port_ms = sum(e.self_device_time_total for e in kern
                  if any(k in e.key for k in ("claim", "wave_front",
                                              "sender_mask"))) / 1e3
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
    from stateright_tpu_torch.models.twopc import TwoPhaseDevice, TwoPhaseSys

    def build(name, load):
        t0 = time.monotonic()
        load()
        return name, time.monotonic() - t0

    # One nvcc a source, all started together.
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(build, "table", table_mod._lib),
                  pool.submit(build, "wave_twopc",
                              lambda: (wave_mod._entry("twopc", 1),
                                       wave_mod._sender_entry("twopc", 1)))]
        for fut in builds:
            name, sec = fut.result()
            _log(f"built csrc/{name}.cu in {sec:.2f} s")
            with open(os.path.join(_build.BUILD_DIR, name + ".log")) as f:
                _log(f.read().strip())
    card = _card_line()
    _log(f"card: {card}")

    k = phase_kernel(torch, table_mod, engine)
    w, rows = phase_wave_kernel(torch, wave_mod, engine, TwoPhaseSys)
    sk = phase_sender_kernel(torch, wave_mod, *rows)
    del rows
    phase_small(TwoPhaseSys)
    phase_sharded_small(torch, fused, TwoPhaseSys)
    phase_refusals(TwoPhaseSys, TwoPhaseDevice)
    kernels = {"dedup_and_insert": table_mod.dedup_and_insert,
               "wave_megakernel": wave_mod.wave_megakernel,
               "sender_megakernel": wave_mod.sender_megakernel}
    # Each path's run reads its own kernels' launches.
    launches = phase_full(torch, kernels, fused, TwoPhaseSys,
                          batch_size=BATCH)["dedup_and_insert"]
    wave_launches = phase_full(torch, kernels, fused, TwoPhaseSys,
                               batch_size=BATCH,
                               wave_kernel=True)["wave_megakernel"]
    sender_launches = phase_full(
        torch, kernels, fused, TwoPhaseSys, batch_size=BATCH // SHARDS,
        mesh=["cuda:0"] * SHARDS, wave_kernel=True)["sender_megakernel"]

    wk, sd = w["plain"], sk[(False, True)]
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
        "library_ms": None}, {
        "name": "sender_megakernel", "route": "cuda",
        "source": "stateright_tpu_torch/csrc/wave_twopc.cu",
        "replaces": "stateright_tpu/tpu/pallas_table.py:451",
        "launches": sender_launches,
        "max_abs_err": max(v["max_abs_err"] for v in sk.values()),
        "ms": sd["ms"], "plain_ms": sd["plain_ms"],
        "bound_ms": sd["bound_ms"], "bound_by": sd["bound_by"],
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
