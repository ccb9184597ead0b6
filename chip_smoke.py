#!/usr/bin/env python3
"""Builds the port's kernels and drives the port on one CUDA card.

Usage, from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --rehash   # phase 1, then the rehash case of 3

``--rehash`` calls only ``table.dedup_and_insert(fps, table)``, the call
every rehash makes, so a copy of this script beside an older port times
that port's kernel on the same input.

Phases, in order; any failure exits non-zero and prints no result line:

1. build ``stateright_tpu_torch/csrc/table.cu`` and ``wave_twopc.cu``
   (the wave kernel's and the sender kernel's entry points) for
   ``sm_90a``, one ``nvcc`` each, both at once, and print each build time
   with ptxas' register and spill report, and the card's name and power
   limit;
2. hold the wave kernel against its plain version at full width: 16,384
   packed rows of 2pc at 10 RMs from a mid-run arena against a 2^27-slot
   table filled to 30% plus the run's states, plain and with symmetry:
   all outputs and the counts equal, tables equal as sets, the
   caller-owned scratch handed back clean; time both, by kernel and
   memset (``torch.profiler``);
3. the same for the dedup kernel at the shape of a full-width wave (S =
   16,384 x 52 = 851,968 fingerprints): a synthetic stream (duplicates,
   sentinels, revisits) against a 2^27-slot table filled to 30%, the
   same kind of stream against a 2^21-slot table (whose walks leave most
   of the 50 MB L2 to the scratch), and the mid-run wave's own dedup
   fingerprints against its table (the default path's input); then at
   the shape of the full run's last rehash, a 2^26-slot table about half
   full into an empty one of 2^27 slots, called as the rehash calls it
   (no caller's scratch);
4. hold the sender kernel against its plain version at full width: the
   same rows as 4 shards of 4,096 (n * S = 851,968 slots), with symmetry
   and local dedup each on and off: all five outputs equal, the
   caller-owned scratch (the engine's, for 4 shards) handed back clean;
   time both, by kernel and memset; then at a ragged shape (3 shards of
   4,095 rows: a shard count that is not a power of two, and each
   shard's last tile part full) the same checks;
5. 2pc at 3 and 5 RMs on the card, and 5 with symmetry: 288 / 1,146,
   8,832 / 58,146 and 314 / 2,048, with the same discovery fingerprint
   chains as the same run on the CPU (the plain path), each with the
   dedup kernel and with the wave kernel; then the same sharded on
   ``mesh=[cuda:0] * n`` at n = 1 and 4, with each path, against the
   CPU run at the same n, and 5 RMs at n = 3 with 255 rows a shard (an
   odd S = 6,885 slots a shard, so shards start off 16 bytes) through
   the sender kernel with and without local dedup; a mesh over distinct
   devices, and either kernel for a model without CUDA device code, raise
   on the card;
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

import functools
import json
import math
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


def _breakdown(torch, fn, reps: int, setup):
    """``(ms, parts)``: the mean device time of ``fn`` a call, the summed
    time of the device work (kernels and memsets) it launches, from
    ``torch.profiler``, and that work by name as ``(name, ms a call,
    launches a call)``, slowest first. A CUDA-event window around one
    call also holds the gaps while the host launches, which at a fraction
    of a millisecond is most of it. A name's ms a call is its mean a
    launch times its launches a call."""
    def run(args):
        for a in args:
            fn(*a)

    # The profiler has been seen to drop some or all of one kernel's
    # events in a run: two profiles, and each name from the one that
    # recorded more of its launches.
    best = {}
    for _ in range(2):
        kern, _ = _profiled(torch, run,
                            lambda: [setup() for _ in range(reps)])
        for e in kern:
            if e.count > best.get(e.key, (0, 0.0))[0]:
                best[e.key] = (e.count, e.self_device_time_total)
    parts = []
    for name, (count, total_us) in best.items():
        per_call = math.ceil(count / reps)
        parts.append((name, total_us / 1e3 / count * per_call, per_call))
    parts.sort(key=lambda p: -p[1])
    return sum(p[1] for p in parts), parts


def _log_parts(parts) -> None:
    for name, ms, count in parts:
        _log(f"    {ms:9.4f} ms {count}x {name[:100]}")


def _scratch(torch, table_mod, fn, n: int, shards: int = 1):
    """``(fn, scratch)``: ``fn`` with a caller-owned scratch for ``n``
    rows in ``shards`` shards bound, as the engines call the kernels."""
    scratch = table_mod.DedupScratch(n, torch.device("cuda"), shards)
    return functools.partial(fn, scratch=scratch), scratch


def _check_clean(torch, scratch, what: str) -> None:
    """The kernels hand a caller-owned scratch back clean."""
    if scratch is None:
        return
    torch.cuda.synchronize()
    if not scratch.is_clean():
        raise AssertionError(f"{what} left its scratch dirty")


def _filled_table(torch, engine, gen, C, load=0.3):
    """A ``C``-slot table ``load`` full of random keys, filled through
    the plain version in chunks: ``(table, resident keys)``."""
    dev = torch.device("cuda")
    resident = torch.randint(1, 1 << 62, (int(load * C),), generator=gen,
                             device=dev)
    table = torch.full((C,), -1, dtype=torch.int64, device=dev)
    for chunk in resident.split(1 << 22):
        engine.global_insert(chunk, torch.ones_like(chunk, dtype=torch.bool),
                             table)
    return table, resident


def _dedup_case(torch, table_mod, fps, table, tag: str, engine_scratch=True):
    """The dedup kernel against its plain version on ``fps`` and a copy
    of ``table``: masks and counts equal, tables equal as sets; then its
    time by kernel and memset, beside the plain version's and the bound.
    With ``engine_scratch`` the kernel gets a caller-owned scratch, as the
    engines' waves call it; without, the wrapper makes its own, as a
    rehash calls it."""
    S = fps.shape[0]
    fn, scratch = table_mod.dedup_and_insert, None
    if engine_scratch:
        fn, scratch = _scratch(torch, table_mod, fn, S)
    t_k, t_p = table.clone(), table.clone()
    out_k = fn(fps, t_k)
    out_p = table_mod.dedup_and_insert_plain(fps, t_p)
    torch.cuda.synchronize()
    errs = [int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            for a, b in zip(out_k, out_p)]
    max_err = max(errs)
    if max_err != 0:
        raise AssertionError(f"kernel ({tag}) disagrees with its plain "
                             f"version: per-output max abs err {errs}")
    if not torch.equal(torch.sort(t_k).values, torch.sort(t_p).values):
        raise AssertionError(f"kernel's table ({tag}) differs from the "
                             "plain version's as a set")
    _check_clean(torch, scratch, f"the dedup kernel ({tag})")
    new, cand = int(out_k[2]), int(out_k[3])
    valid = int((fps != -1).sum())
    del t_k, t_p, out_k, out_p

    def setup():
        return fps, table.clone()

    call_ms = _time_ms(torch, fn, 5, setup)
    ms, parts = _breakdown(torch, fn, 5, setup)
    plain_ms = _time_ms(torch, table_mod.dedup_and_insert_plain, 3, setup)
    # Bound: the bytes of the function itself, each once: the fps read,
    # the two masks written, and one 32-byte sector a candidate in the
    # visited table. The kernel's scratch table is neither input nor
    # output.
    nbytes = 8 * S + 2 * S + 32 * cand
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    _log(f"dedup kernel == plain ({tag}) at S={S}, C=2^"
         f"{table.shape[0].bit_length() - 1}: new={new} cand={cand} "
         f"valid={valid}; kernel {ms:.4f} ms on the card ({call_ms:.4f} ms "
         f"a call between CUDA events, the host's launches included), "
         f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B "
         "over HBM); by kernel and memset, a call:")
    _log_parts(parts)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, parts=parts, cand=cand)


def _stream(torch, gen, S, resident):
    """The reference tests' stream of ``S`` fingerprints: duplicates,
    sentinels, and revisits of ``resident``."""
    dev = torch.device("cuda")
    fresh = torch.randint(1, 1 << 62, (S,), generator=gen, device=dev)
    fps = fresh.clone()
    dup = torch.rand(S, generator=gen, device=dev) < 0.3
    fps = torch.where(dup, fresh[torch.randint(0, S, (S,), generator=gen,
                                               device=dev)], fps)
    rev = torch.rand(S, generator=gen, device=dev) < 0.2
    fps = torch.where(rev, resident[torch.randint(
        0, resident.numel(), (S,), generator=gen, device=dev)], fps)
    return torch.where(torch.rand(S, generator=gen, device=dev) < 0.1,
                       torch.full_like(fps, -1), fps)


def phase_kernel(torch, table_mod, engine, wave_case):
    """The dedup kernel against its plain version: at the full-width
    shape, a synthetic stream against a large table and against a small
    one, then the dedup fingerprints of a mid-run 10-RM wave against its
    table (``wave_case``); then the rehash case."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    S = BATCH * 52
    out = {}
    for key, bits, tag in (("stream", 27, "synthetic stream"),
                           ("small", 21, "synthetic stream, small table")):
        table, resident = _filled_table(torch, engine, gen, 1 << bits)
        fps = _stream(torch, gen, S, resident)
        del resident
        out[key] = _dedup_case(torch, table_mod, fps, table, tag)
        del table, fps
    out["wave"] = _dedup_case(torch, table_mod, *wave_case,
                              "mid-run 10-RM wave")
    out["rehash"] = phase_rehash(torch, table_mod, engine)
    return out


def phase_rehash(torch, table_mod, engine):
    """The dedup kernel at the shape of the full 10-RM run's last rehash:
    its table of 2^26 slots, about half full (a rehash runs once the
    next dispatch could pass half load), into an empty one of 2^27, as
    the rehash calls it."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    C = 1 << 26
    old, _ = _filled_table(torch, engine, gen, C,
                           load=0.5 - BATCH * 52 / C)
    new = torch.full((2 * C,), -1, dtype=torch.int64, device="cuda")
    return _dedup_case(torch, table_mod, old, new, "rehash",
                       engine_scratch=False)


def phase_wave_kernel(torch, wave_mod, table_mod, engine, TwoPhaseSys):
    """The wave kernel against its plain version at the full-width shape:
    ``B`` packed rows of a mid-run arena of 2pc at 10 RMs. Also returns
    that wave's dedup fingerprints and table, the dedup kernel's input on
    the default path, and the rows for the sender kernel."""
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
    out = {tag: _wave_case(torch, wave_mod, table_mod, dm, store, valid,
                           layout, table, use_sym, tag)
           for tag, use_sym in (("plain", False), ("sym", True))}
    # The same wave through the torch stages: the dedup kernel's input on
    # the default path (wave_kernel=False).
    succ, sflat, _, _ = engine.expand_frontier(dm, layout.unpack(store),
                                               valid)
    dedup_fps = engine.fingerprint_successors(dm, succ, sflat, False)[0]
    del succ, sflat
    return out, (dm, store, layout), (dedup_fps, table)


def _wave_case(torch, wave_mod, table_mod, dm, store, valid, layout, table,
               use_sym, tag):
    """The wave kernel against its plain version on ``store`` and a copy
    of ``table``: all outputs equal, tables equal as sets; then its time
    with a caller-owned scratch, by kernel and memset, beside the plain
    version's and the bound."""
    B = store.shape[0]
    S, W, wp = B * dm.max_fanout, dm.state_width, layout.packed_width
    names = ("succ_store", "path_fps", "sflat", "new_mask", "cand_mask",
             "new_count", "cand_count", "full")
    fn, scratch = _scratch(torch, table_mod, wave_mod.wave_megakernel, S)
    t_k, t_p = table.clone(), table.clone()
    got = fn(dm, store, valid, t_k, use_sym, layout)
    want = wave_mod.wave_megakernel_plain(dm, store, valid, t_p, use_sym,
                                          layout)
    torch.cuda.synchronize()
    for name, a, b in zip(names, got, want):
        if not torch.equal(a, b):
            err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            raise AssertionError(f"wave kernel ({tag}) disagrees with its "
                                 f"plain version on {name}: max abs err "
                                 f"{err}")
    if not torch.equal(torch.sort(t_k).values, torch.sort(t_p).values):
        raise AssertionError(f"wave kernel's table ({tag}) differs from the "
                             "plain version's as a set")
    _check_clean(torch, scratch, f"the wave kernel ({tag})")
    n_valid, new, cand = int(got[2].sum()), int(got[5]), int(got[6])
    del t_k, t_p, got, want

    def setup():
        return dm, store, valid, table.clone(), use_sym, layout

    call_ms = _time_ms(torch, fn, 5, setup)
    ms, parts = _breakdown(torch, fn, 5, setup)
    plain_ms = _time_ms(torch, wave_mod.wave_megakernel_plain, 3, setup)
    # Bound: the function's own bytes, each once: the packed batch and
    # valid read, the packed successors, path fingerprints and three byte
    # masks written, and one 32-byte sector a candidate in the visited
    # table. The dedup fingerprints and the scratch table are neither input
    # nor output. Operations: 32-bit integer ops of the path fingerprint,
    # unpack, step and re-pack of every slot, and of the representative's
    # sort and fingerprint of each valid slot under symmetry.
    nbytes = 4 * B * wp + B + 4 * S * wp + 8 * S + 3 * S + 32 * cand
    fp_ops = 2 * (6 * W + 9) + 4
    ops = S * (fp_ops + 8 * W)
    if use_sym:
        n = dm.rm_count
        ops += n_valid * (fp_ops + 2 * n * n)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    _log(f"wave kernel == plain ({tag}) at B={B}, S={S}, C=2^"
         f"{table.shape[0].bit_length() - 1}: valid={n_valid} cand={cand} "
         f"new={new}; kernel {ms:.4f} ms on the card ({call_ms:.4f} ms a "
         f"call between CUDA events), plain {plain_ms:.4f} ms, bound "
         f"{bound_ms:.4f} ms ({nbytes} B over HBM: {bytes_ms:.4f} ms; {ops} "
         f"ops: {ops_ms:.4f} ms); by kernel and memset, a call:")
    _log_parts(parts)
    return dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                parts=parts,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _sender_equal(torch, wave_mod, fn, scratch, args, tag):
    """The sender kernel (``fn``) against its plain version on ``args``:
    all five outputs equal, the scratch handed back clean. Returns
    ``(valid, sent)``."""
    names = ("succ_store", "dedup_fps", "path_fps", "sflat", "send_mask")
    got = fn(*args)
    want = wave_mod.sender_megakernel_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(names, got, want):
        if not torch.equal(a, b):
            err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            raise AssertionError(f"sender kernel ({tag}) disagrees with its "
                                 f"plain version on {name}: max abs err "
                                 f"{err}")
    _check_clean(torch, scratch, f"the sender kernel ({tag})")
    return int(got[3].sum()), int(got[4].sum())


def phase_sender_kernel(torch, wave_mod, table_mod, dm, store, layout):
    """The sender kernel against its plain version at the full-width
    shape: ``store``'s packed rows as ``SHARDS`` shards' batches, with
    the engine's scratch; then at a ragged shape."""
    B, wp = BATCH // SHARDS, layout.packed_width
    rows = store
    store = rows.reshape(SHARDS, B, wp).contiguous()
    valid = torch.ones((SHARDS, B), dtype=torch.bool, device="cuda")
    W, n = dm.state_width, SHARDS
    S = B * dm.max_fanout
    fn, scratch = _scratch(torch, table_mod, wave_mod.sender_megakernel,
                           n * S, n)
    out = {}
    for use_sym in (False, True):
        for local_dedup in (True, False):
            args = (dm, store, valid, use_sym, layout, local_dedup)
            tag = (f"{'sym' if use_sym else 'plain'}"
                   f"{'' if local_dedup else ', no local dedup'}")
            n_valid, n_send = _sender_equal(torch, wave_mod, fn, scratch,
                                            args, tag)
            ms, parts = _breakdown(torch, fn, 5, lambda: args)
            call_ms = _time_ms(torch, fn, 5, lambda: args)
            _check_clean(torch, scratch, f"the sender kernel ({tag}, timed)")
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
            _log(f"sender kernel == plain ({tag}) at n={n} x B={B}, "
                 f"n*S={n * S}: valid={n_valid} sent={n_send}; kernel "
                 f"{ms:.4f} ms on the card ({call_ms:.4f} ms a call between "
                 f"CUDA events), plain {plain_ms:.4f} ms, bound "
                 f"{bound_ms:.4f} ms ({nbytes} B over HBM: {bytes_ms:.4f} ms; "
                 f"{ops} ops: {ops_ms:.4f} ms); by kernel and memset, a "
                 "call:")
            _log_parts(parts)
            out[(use_sym, local_dedup)] = dict(
                max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                parts=parts,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    del fn, scratch
    # Ragged: 3 shards of 4,095 rows, the last 100 of shard 2 not valid.
    n, B = 3, 4_095
    store = rows[:n * B].reshape(n, B, wp).contiguous()
    valid = torch.ones((n, B), dtype=torch.bool, device="cuda")
    valid[2, -100:] = False
    S = B * dm.max_fanout
    fn, scratch = _scratch(torch, table_mod, wave_mod.sender_megakernel,
                           n * S, n)
    for local_dedup in (True, False):
        tag = f"ragged{'' if local_dedup else ', no local dedup'}"
        n_valid, n_send = _sender_equal(
            torch, wave_mod, fn, scratch,
            (dm, store, valid, False, layout, local_dedup), tag)
        _log(f"sender kernel == plain ({tag}) at n={n} x B={B}, S={S} "
             f"({S % 256} slots in each shard's last tile): valid={n_valid} "
             f"sent={n_send}, scratch clean")
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
    # An odd S a shard, on a shard count that is not a power of two.
    for novel in (True, False):
        def spawn3(device, **kw):
            return TwoPhaseSys(5).checker().spawn_cuda_bfs(
                mesh=[device] * 3, batch_size=255,
                exchange_novel_only=novel, **kw).join()

        cpu, gpu = spawn3("cpu", wave_kernel=True), spawn3(
            "cuda:0", wave_kernel=True)
        got = (gpu.unique_state_count(), gpu.state_count())
        tag = f"2pc 5 n=3 B=255 sender_kernel, exchange_novel_only={novel}"
        if got != (8832, 58146) or got != (cpu.unique_state_count(),
                                           cpu.state_count()):
            raise AssertionError(f"{tag}: {got} != (8832, 58146)")
        if gpu.kernel_path() != "sender_kernel" or _chains(gpu) != _chains(
                cpu):
            raise AssertionError(f"{tag}: {gpu.kernel_path()}, or discovery "
                                 "chains differ from the CPU run")
        _log(f"{tag}: unique={got[0]} states={got[1]}, equal to the CPU "
             "run's")
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
                  if any(k in e.key for k in ("claim_rows", "resolve_rows",
                                              "tile_front", "send_rows"))
                  ) / 1e3
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


def _modules():
    """The port's modules, from the checkout beside this script."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stateright_tpu_torch import _build, engine, fused
    from stateright_tpu_torch import table as table_mod
    from stateright_tpu_torch import wave as wave_mod
    from stateright_tpu_torch.models.twopc import TwoPhaseDevice, TwoPhaseSys
    return (_build, engine, fused, table_mod, wave_mod, TwoPhaseDevice,
            TwoPhaseSys)


def phase_build(_build, table_mod, wave_mod) -> None:
    def build(name, load):
        t0 = time.monotonic()
        load()
        return name, time.monotonic() - t0

    # One nvcc a source, both started together.
    jobs = [("table", table_mod._lib),
            ("wave_twopc", lambda: (wave_mod._entry("twopc", 1),
                                    wave_mod._sender_entry("twopc", 1)))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        builds = [pool.submit(build, name, load) for name, load in jobs]
        for fut in builds:
            name, sec = fut.result()
            _log(f"built {name} in {sec:.2f} s")
            with open(os.path.join(_build.BUILD_DIR, name + ".log")) as f:
                _log(f.read().strip())


def _kernel_row(name, source, replaces, launches, max_abs_err, r):
    """One kernel's entry of the kernels line from its phase's result
    ``r``."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r.get("bound_by", "bytes"), "library_ms": None}


def main(argv) -> int:
    if argv not in ([], ["--rehash"]):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    (_build, engine, fused, table_mod, wave_mod, TwoPhaseDevice,
     TwoPhaseSys) = _modules()
    phase_build(_build, table_mod, wave_mod)
    card = _card_line()
    _log(f"card: {card}")
    if argv:
        r = phase_rehash(torch, table_mod, engine)
        print(json.dumps({"rehash": {
            key: r[key] for key in ("ms", "plain_ms", "bound_ms", "parts")}}))
        return 0

    # Each kernel against its plain version at full width, timed.
    w, rows, wave_case = phase_wave_kernel(torch, wave_mod, table_mod, engine,
                                           TwoPhaseSys)
    k = phase_kernel(torch, table_mod, engine, wave_case)
    del wave_case
    sk = phase_sender_kernel(torch, wave_mod, table_mod, *rows)
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

    # Kernel 1 on the synthetic stream, and on the default path's input,
    # the mid-run wave's dedup fingerprints.
    src = "stateright_tpu_torch/csrc/"
    pallas = "stateright_tpu/tpu/pallas_table.py:"
    k_err = max(v["max_abs_err"] for v in k.values())
    print(json.dumps({"kernels": [
        _kernel_row("dedup_and_insert", src + "table.cu", pallas + "256",
                    launches, k_err, k["stream"]),
        _kernel_row("dedup_and_insert[mid-run wave]", src + "table.cu",
                    pallas + "256", launches, k_err, k["wave"]),
        _kernel_row("wave_megakernel", src + "wave_twopc.cu", pallas + "380",
                    wave_launches,
                    max(v["max_abs_err"] for v in w.values()), w["plain"]),
        _kernel_row("sender_megakernel", src + "wave_twopc.cu",
                    pallas + "451", sender_launches,
                    max(v["max_abs_err"] for v in sk.values()),
                    sk[(False, True)])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except BaseException:  # any phase's failure fails the run
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
