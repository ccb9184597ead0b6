#!/usr/bin/env python3
"""Builds the port's kernels and drives the port on one CUDA card.

Usage, from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --rehash   # phase 1, then the rehash case of 3

Phases, in order; any failure exits non-zero and prints no result line:

1. build ``stateright_tpu_torch/csrc/table.cu``, ``wave_twopc.cu`` and
   ``wave_paxos.cu`` (the wave kernel's and the sender kernel's entry
   points for 2pc and for paxos) for ``sm_90a``, one ``nvcc`` each, all
   at once, and print each build time with ptxas' register and spill
   report, and the card's name and power limit;
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
   fingerprints against its table (the default path's input); the next
   wave of ``paxos check 3`` stopped mid-run at a rest point (S = 16,384
   x 18 = 294,912), against its engine's table with its engine's
   scratch; then at the shape of the full 2pc run's last rehash, a
   2^26-slot table about half full into an empty one of 2^27 slots,
   through an engine's chunked rehash (strided chunks of at most its
   scratch rows) against the plain version, timed with its peak memory
   beside chunks of adjacent slots and one call with no scratch (the
   earlier form);
4. hold the sender kernel against its plain version at full width: the
   same rows as 4 shards of 4,096 (n * S = 851,968 slots), with symmetry
   and local dedup each on and off: all five outputs equal, the
   caller-owned scratch (the engine's, for 4 shards) handed back clean;
   time both, by kernel and memset; then at a ragged shape (3 shards of
   4,095 rows: a shard count that is not a power of two, and each
   shard's last tile part full) the same checks; then kernels 2 and 3 on
   paxos (its CUDA step, sentinel lanes in the packed rows): the wave
   kernel on the 16,384 rows of phase 3's mid-run ``paxos check 3``
   arena against its engine's table with its engine's scratch, plain and
   with symmetry, and the sender kernel on the same rows as 4 shards of
   4,096 and ragged, each checked and timed as above;
5. 2pc at 3 and 5 RMs on the card, and 5 with symmetry: 288 / 1,146,
   8,832 / 58,146 and 314 / 2,048, with the same discovery fingerprint
   chains as the same run on the CPU (the plain path), each with the
   dedup kernel and with the wave kernel; then the same sharded on
   ``mesh=[cuda:0] * n`` at n = 1 and 4, with each path, against the
   CPU run at the same n, and 5 RMs at n = 3 with 255 rows a shard (an
   odd S = 6,885 slots a shard, so shards start off 16 bytes) through
   the sender kernel with and without local dedup; paxos at 1 and 2
   clients, unsharded and at n = 4, on the dedup kernel's path and on the
   kernels' (``wave_kernel=True``), against the CPU run: 265 / 482 and
   16,668 / 32,971; paxos at 4 clients with symmetry to 20,000 states and
   at 1 client with liveness and with 5 network slots (fewer than the
   default 8: smaller tiles) on the kernels, against the CPU run; two
   network slots raise paxos's overflow error on the kernels, unsharded
   and sharded; a mesh over distinct devices and either kernel for a
   model without CUDA device code raise on the card;
6. full width, 2pc at 10 RMs: batch 16,384 once with each path, and
   sharded at n = 4 with 4,096 rows a shard and the sender kernel:
   exactly 61,515,776 unique / 817,760,258 states; then ``paxos check
   3`` on the dedup kernel's path and on the kernels' (the wave kernel
   unsharded, the sender kernel sharded), batch 16,384 and sharded at n
   = 4 with 4,096 rows a shard: exactly 1,194,428 unique / 2,420,477
   states, "value chosen" found, no "linearizable" counterexample. Each
   run with the kernels' launch counts beside the waves and rehashes;
   then for each run, dispatches of a mid-run checker: one under
   ``torch.cuda.set_sync_debug_mode("error")``, a few timed plain for
   the steady pace a wave, and one under ``torch.profiler`` (kernel time
   and launches by kernel), which together give the card's idle share;
7. the kernels line, the script's running time, the card line and the
   result line.

It imports neither JAX nor ``stateright_tpu``.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import re
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
PAXOS_UNIQUE, PAXOS_STATES = 1_194_428, 2_420_477
#: the states a paxos 3 checker runs to before its next wave's dedup
#: fingerprints are read (about 150,000 unique, a frontier far wider than
#: a batch), and before its dispatches are timed: the whole run is about
#: 90 waves at 16,384 rows, so the timed dispatches start early
PAXOS_WAVE_AT, PAXOS_MID = 240_000, 50_000
#: the states paxos at 4 clients with symmetry runs to on the card and on
#: the CPU (its whole space is far larger)
PAXOS4_TARGET = 20_000
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


def _dedup_case(torch, table_mod, fps, table, tag: str, scratch=None):
    """The dedup kernel against its plain version on ``fps`` and a copy
    of ``table``: masks and counts equal, tables equal as sets, the
    caller-owned scratch handed back clean; then its time by kernel and
    memset, beside the plain version's and the bound. The kernel gets
    ``scratch`` (an engine's), or a caller-owned one of its own, as the
    engines call it."""
    S = fps.shape[0]
    if scratch is None:
        fn, scratch = _scratch(torch, table_mod, table_mod.dedup_and_insert,
                               S)
    else:
        fn = functools.partial(table_mod.dedup_and_insert, scratch=scratch)
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


def phase_kernel(torch, table_mod, engine, fused, wave_case, TwoPhaseSys,
                 paxos_mid):
    """The dedup kernel against its plain version: at the full-width
    shape, a synthetic stream against a large table and against a small
    one, then the dedup fingerprints of a mid-run 10-RM wave against its
    table (``wave_case``) and of a mid-run paxos 3 wave (``paxos_mid``'s
    next) against its engine's table, with that engine's scratch; then the
    rehash case."""
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
    fps = _paxos_wave(torch, engine, paxos_mid)
    out["paxos"] = _dedup_case(torch, table_mod, fps, paxos_mid._table,
                               "mid-run paxos 3 wave", paxos_mid._scratch)
    del fps
    out["rehash"] = phase_rehash(torch, table_mod, engine, fused,
                                 TwoPhaseSys)
    return out


def _paxos_mid(PaxosSys):
    """A ``paxos check 3`` checker on the default path stopped mid-run, at
    its rest point, with a frontier of at least a batch."""
    mid = (PaxosSys(3).checker().target_state_count(PAXOS_WAVE_AT)
           .spawn_cuda_bfs(batch_size=BATCH).join())
    if mid._tail - mid._head < BATCH:
        raise AssertionError(f"mid-run paxos frontier of "
                             f"{mid._tail - mid._head} rows is narrower "
                             f"than {BATCH}")
    return mid


def _paxos_wave(torch, engine, mid):
    """The dedup fingerprints of ``mid``'s next wave: the default path's
    input to the dedup kernel."""
    rows = mid._layout.unpack(mid._vecs[mid._head:mid._head + BATCH])
    valid = torch.ones(BATCH, dtype=torch.bool, device="cuda")
    succ, sflat, _, _ = engine.expand_frontier(mid._dm, rows, valid)
    return engine.fingerprint_successors(mid._dm, succ, sflat, False)[0]


def phase_paxos_kernels(torch, wave_mod, table_mod, mid):
    """Kernels 2 and 3 on paxos (``csrc/models/paxos.cuh``, sentinel lanes
    in the packed rows) against their plain versions at full width: the
    next batch of the mid-run ``paxos check 3`` arena of ``mid``, against
    its engine's table and with its engine's scratch, plain and with
    symmetry; then the same rows as ``SHARDS`` shards, and ragged."""
    dm, layout = mid._dm, mid._layout
    store = mid._vecs[mid._head:mid._head + BATCH].clone()
    valid = torch.ones(BATCH, dtype=torch.bool, device="cuda")
    w = {tag: _wave_case(torch, wave_mod, table_mod, dm, store, valid,
                         layout, mid._table, use_sym, f"paxos 3, {tag}",
                         scratch=mid._scratch)
         for tag, use_sym in (("plain", False), ("sym", True))}
    sk = phase_sender_kernel(torch, wave_mod, table_mod, dm, store, layout,
                             "paxos 3")
    return w, sk


def phase_rehash(torch, table_mod, engine, fused, TwoPhaseSys):
    """The rehash at the shape of the full 10-RM run's last: its table of
    2^26 slots, about half full (a rehash runs once the next dispatch
    could pass half load), into an empty one of 2^27, through a 10-RM
    engine's own ``_rehash`` (128 strided chunks of 524,288 rows, at most
    its 851,968 scratch rows, with its scratch), against the plain
    version's one call: the tables equal
    as sets, no key without a slot, the scratch handed back clean. Then
    its time and its peak of device memory beside those of chunks that
    are runs of adjacent slots (the form ``_rehash`` avoids: their keys
    share their hash's high bits, which also pick their scratch slots),
    and of one kernel call over all 2^26 rows with no scratch (the earlier
    form, which builds a scratch of 2 x 2^26 slots of 16 bytes)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    C = 1 << 26
    old, _ = _filled_table(torch, engine, gen, C,
                           load=0.5 - BATCH * 52 / C)
    eng = (TwoPhaseSys(10).checker().target_state_count(1)
           .spawn_cuda_bfs(batch_size=BATCH).join())
    rows = eng._scratch_shape()[0]

    def chunked(new):
        return eng._rehash(old, new)

    def runs(new):
        return torch.stack([table_mod.dedup_and_insert(
            chunk, new, scratch=eng._scratch)[4]
            for chunk in old.split(rows)]).any()

    def one_call(new):
        return table_mod.dedup_and_insert(old, new)[4]

    def setup():
        return (torch.full((2 * C,), -1, dtype=torch.int64, device="cuda"),)

    (t_k,), (t_p,) = setup(), setup()
    full = chunked(t_k)
    table_mod.dedup_and_insert_plain(old, t_p)
    torch.cuda.synchronize()
    if bool(full) or not torch.equal(torch.sort(t_k).values,
                                     torch.sort(t_p).values):
        raise AssertionError("the chunked rehash differs from the plain "
                             "version's as a set")
    _check_clean(torch, eng._scratch, "the chunked rehash")
    cand = int((old != -1).sum())
    del t_k, t_p
    out = {}
    for key, fn in (("chunked", chunked), ("runs", runs),
                    ("one call", one_call)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(*setup())
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        call_ms = _time_ms(torch, fn, 3, setup)
        ms, parts = _breakdown(torch, fn, 3, setup)
        out[key] = dict(ms=ms, call_ms=call_ms, peak=peak, parts=parts)
        how = {"chunked": f"{fused._pow2(-(-C // rows))} strided chunks "
                          f"of at most {rows} rows",
               "runs": f"{-(-C // rows)} runs of {rows} adjacent slots",
               "one call": "no scratch"}[key]
        _log(f"rehash 2^26 -> 2^27 ({key}, {how}): "
             f"{ms:.4f} ms on the card ({call_ms:.4f} ms between CUDA "
             f"events), peak device memory {peak} B over the old table "
             "(the new table included); by kernel and memset:")
        _log_parts(parts)
        _check_clean(torch, eng._scratch, f"the rehash ({key})")
    plain_ms = _time_ms(torch, table_mod.dedup_and_insert_plain, 1,
                        lambda: (old,) + setup())
    # Bound: the function's bytes, each once: the old table read, two
    # masks written, one 32-byte sector a key in the new table.
    nbytes = 8 * C + 2 * C + 32 * cand
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    _log(f"rehash: {cand} keys, chunked {out['chunked']['ms']:.4f} ms "
         f"against runs {out['runs']['ms']:.4f} ms and one call "
         f"{out['one call']['ms']:.4f} ms in this run, peak "
         f"{out['chunked']['peak']} against "
         f"{out['one call']['peak']} B for one call; plain one call "
         f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B over HBM)")
    return dict(max_abs_err=0, ms=out["chunked"]["ms"], plain_ms=plain_ms,
                bound_ms=bound_ms, parts=out["chunked"]["parts"],
                peak=out["chunked"]["peak"], runs=out["runs"],
                one_call=out["one call"])


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


def _sym_ops(dm) -> int:
    """32-bit integer operations of one representative beyond its
    fingerprint: 2pc's sort network over its RMs' keys; paxos's network
    re-sorted at 4 clients (3 servers: the group is trivial below)."""
    if hasattr(dm, "rm_count"):
        return 2 * dm.rm_count ** 2
    return 2 * dm.net_slots ** 2 + 8 * dm.state_width if dm.C == 4 else 0


def _front_ops(dm, slots: int, n_valid: int, use_sym: bool) -> int:
    """32-bit integer operations of the kernels' front: the path
    fingerprint, unpack, step and re-pack of every slot, and the
    representative and its fingerprint of each valid slot under
    symmetry."""
    W = dm.state_width
    fp_ops = 2 * (6 * W + 9) + 4
    ops = slots * (fp_ops + 8 * W)
    if use_sym:
        ops += n_valid * (fp_ops + _sym_ops(dm))
    return ops


def _wave_case(torch, wave_mod, table_mod, dm, store, valid, layout, table,
               use_sym, tag, scratch=None):
    """The wave kernel against its plain version on ``store`` and a copy
    of ``table``: all outputs equal, tables equal as sets; then its time
    with a caller-owned scratch (``scratch``, an engine's, or one of its
    own), by kernel and memset, beside the plain version's and the
    bound."""
    B = store.shape[0]
    S, wp = B * dm.max_fanout, layout.packed_width
    names = ("succ_store", "path_fps", "sflat", "new_mask", "cand_mask",
             "new_count", "cand_count", "full")
    if scratch is None:
        fn, scratch = _scratch(torch, table_mod, wave_mod.wave_megakernel, S)
    else:
        fn = functools.partial(wave_mod.wave_megakernel, scratch=scratch)
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
    # nor output. Operations: _front_ops.
    nbytes = 4 * B * wp + B + 4 * S * wp + 8 * S + 3 * S + 32 * cand
    ops = _front_ops(dm, S, n_valid, use_sym)
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


def phase_sender_kernel(torch, wave_mod, table_mod, dm, store, layout,
                        model="2pc 10"):
    """The sender kernel against its plain version at the full-width
    shape: ``store``'s packed rows (of ``model``) as ``SHARDS`` shards'
    batches, with the engine's scratch; then at a ragged shape."""
    B, wp = BATCH // SHARDS, layout.packed_width
    rows = store
    store = rows.reshape(SHARDS, B, wp).contiguous()
    valid = torch.ones((SHARDS, B), dtype=torch.bool, device="cuda")
    n = SHARDS
    S = B * dm.max_fanout
    fn, scratch = _scratch(torch, table_mod, wave_mod.sender_megakernel,
                           n * S, n)
    out = {}
    for use_sym in (False, True):
        for local_dedup in (True, False):
            args = (dm, store, valid, use_sym, layout, local_dedup)
            tag = (f"{model}, {'sym' if use_sym else 'plain'}"
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
            # kernel's (_front_ops).
            nbytes = (4 * n * B * wp + n * B + 4 * n * S * wp + 16 * n * S
                      + 2 * n * S)
            ops = _front_ops(dm, n * S, n_valid, use_sym)
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
        tag = f"{model}, ragged{'' if local_dedup else ', no local dedup'}"
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


def _paxos_against_cpu(checker, want, path, found, **spawn):
    """``checker()``'s run on the card through ``spawn_cuda_bfs(**spawn)``
    (a ``mesh`` of ``cuda:0`` for the sharded engine) against the same run
    on the CPU: the counts (and ``want``, where given), the kernel path,
    the discoveries ``found`` (where given) and their chains."""
    cpu_spawn = (dict(spawn, mesh=["cpu"] * len(spawn["mesh"]))
                 if "mesh" in spawn else dict(spawn, device="cpu"))
    cpu = checker().spawn_cuda_bfs(**cpu_spawn).join()
    gpu = checker().spawn_cuda_bfs(**spawn).join()
    got = (gpu.unique_state_count(), gpu.state_count())
    tag = f"n={getattr(gpu, '_n', 1)} {gpu.kernel_path()}"
    if got != (cpu.unique_state_count(), cpu.state_count()) or (
            want is not None and got != want):
        raise AssertionError(f"{tag}: {got}, the CPU run "
                             f"{(cpu.unique_state_count(), cpu.state_count())}"
                             f", expected {want}")
    if gpu.kernel_path() != path:
        raise AssertionError(f"{tag}: kernel_path() is {gpu.kernel_path()}")
    if _chains(gpu) != _chains(cpu) or (found is not None
                                        and sorted(_chains(gpu)) != found):
        raise AssertionError(f"{tag}: discoveries {sorted(_chains(gpu))}, "
                             "or their chains differ from the CPU run")
    return gpu, f"{tag}: unique={got[0]} states={got[1]}, discoveries " \
        f"{sorted(_chains(gpu))} equal to the CPU run's"


def phase_paxos_small(PaxosSys, PaxosDevice):
    """paxos on the card against the same run on the CPU, each path
    unsharded and sharded on ``mesh=[cuda:0] * SHARDS``: at 1 and 2
    clients (265 / 482 and 16,668 / 32,971 states) on the dedup kernel's
    path and on the kernels' (``wave_kernel=True``: paxos's CUDA step in
    the wave and sender kernels); at 4 clients with symmetry to a target
    (the representative's nontrivial group), at 1 client with liveness
    and with 5 network slots (below the default, so the kernels' tiles
    shrink); then a network too small for the run raises the error lane's
    error on the card, as on the CPU."""
    for clients, want in ((1, (265, 482)), (2, (16_668, 32_971))):
        for wave_kernel, paths in ((False, ("dedup_kernel", "dedup_kernel")),
                                   (True, ("megakernel", "sender_kernel"))):
            for path, spawn in zip(paths, (
                    dict(batch_size=1024),
                    dict(batch_size=256, mesh=["cuda:0"] * SHARDS))):
                _, line = _paxos_against_cpu(
                    PaxosSys(clients).checker, want, path, ["value chosen"],
                    wave_kernel=wave_kernel, **spawn)
                _log(f"paxos {clients} {line}")
    for path, spawn in (("megakernel", dict(batch_size=1024)),
                        ("sender_kernel", dict(batch_size=256,
                                               mesh=["cuda:0"] * SHARDS))):
        gpu, line = _paxos_against_cpu(
            lambda: PaxosSys(4).checker().symmetry().target_state_count(
                PAXOS4_TARGET), None, path, None, wave_kernel=True, **spawn)
        if gpu.state_count() < PAXOS4_TARGET:
            raise AssertionError(f"paxos 4 sym {line}: stopped short of "
                                 f"{PAXOS4_TARGET} states")
        _log(f"paxos 4 sym to {PAXOS4_TARGET} states {line}")
    _, line = _paxos_against_cpu(
        PaxosSys(1, liveness=True).checker, (265, 482), "megakernel",
        ["value chosen"], wave_kernel=True, batch_size=1024)
    _log(f"paxos 1 liveness {line}, no 'eventually chosen' counterexample")

    def slots(net_slots):
        class Sys(PaxosSys):
            def device_model(self):
                return PaxosDevice(1, net_slots=net_slots)
        return Sys(1)

    # Five slots, fewer than the default 8 (the kernels' tiles hold 165
    # slots, not 256), hold the whole run; two overflow.
    for path, spawn in (("megakernel", dict(batch_size=1024)),
                        ("sender_kernel", dict(batch_size=256,
                                               mesh=["cuda:0"] * SHARDS))):
        _, line = _paxos_against_cpu(slots(5).checker, (265, 482), path,
                                     ["value chosen"], wave_kernel=True,
                                     **spawn)
        _log(f"paxos 1 with 5 network slots {line}")
    lane = PaxosDevice(1, net_slots=2).error_lane
    for spawn in (dict(), dict(mesh=["cuda:0"] * SHARDS)):
        try:
            slots(2).checker().spawn_cuda_bfs(wave_kernel=True,
                                              batch_size=128, **spawn).join()
        except RuntimeError as e:
            if f"error lane {lane} " not in str(e):
                raise
            _log(f"paxos 1 with 2 network slots on the kernels "
                 f"({'sharded' if spawn else 'fused'}) raises: {e}")
        else:
            raise AssertionError("paxos 1 with 2 network slots ran on the "
                                 "card without its overflow error")


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


def phase_full(torch, kernels, fused, config, model, want_counts,
               want_found, mid_target, steady_dispatches, **spawn):
    """``model()`` (``config`` names it) to its end through
    ``spawn_cuda_bfs(**spawn)``, with every kernel's launch count set to
    0 just before and read just after: exactly ``want_counts`` (unique,
    states), the discoveries ``want_found``, no counterexample; then the
    dispatches of a checker stopped at ``mid_target`` states, with
    ``steady_dispatches`` timed plain. Returns the launch counts by
    kernel name and the run's numbers."""
    gc.collect()  # what earlier phases left in reference cycles goes first
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.monotonic()
    c = model().checker().spawn_cuda_bfs(**spawn).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    unique, states = c.unique_state_count(), c.state_count()
    n = getattr(c, "_n", 1)
    peak = torch.cuda.max_memory_allocated()
    _log(f"{config} ({c.kernel_path()}, {n} shard(s)): unique={unique} "
         f"states={states} sec={sec:.3f} states/s={states / sec:.1f} "
         f"waves={c.waves} dispatches={c.dispatches} rehashes={c.rehashes} "
         f"arena_grows={c.arena_grows} candidates={c.candidates} "
         f"launches={launches} max_memory_allocated={peak}")
    if (unique, states) != want_counts:
        raise AssertionError(f"{config}: {(unique, states)} != "
                             f"{want_counts}")
    found = c.discoveries()
    if sorted(found) != want_found:
        raise AssertionError(f"{config} discoveries: {sorted(found)}")
    c.assert_properties()
    c_waves, c_dispatches, c_rehashes = c.waves, c.dispatches, c.rehashes
    # Every dispatch launches K waves, also those past a rest point. A
    # wave runs the dedup kernel once a shard, unless the single-kernel
    # wave does the wave's dedup itself; a rehash runs it once a chunk of
    # each old table slice: the least power of two of chunks of at most
    # the engine's scratch rows.
    launched = c._K * c.dispatches
    rows = c._scratch_shape()[0]
    chunks = sum(fused._pow2(-(-(c._capacity >> i) // rows))
                 for i in range(1, c.rehashes + 1))
    wave_kernel = spawn.get("wave_kernel", False)
    sharded = "mesh" in spawn
    want = {
        "dedup_and_insert": n * (chunks + (
            launched if sharded or not wave_kernel else 0)),
        "wave_megakernel": launched if wave_kernel and not sharded else 0,
        "sender_megakernel": launched if wave_kernel and sharded else 0}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want} "
                             f"for {c._K} x {c.dispatches} launched waves "
                             f"and {c.rehashes} rehashes ({chunks} chunks) "
                             f"on {n} shard(s)")
    del c

    # Dispatches of a mid-run checker, each timed alone with its rest
    # point's growth outside the window: the first with every
    # synchronisation an error (nothing inside a dispatch may wait for
    # the card), then a few plain ones for the steady pace, then one
    # under torch.profiler for the kernel time.
    mid = (model().checker().target_state_count(mid_target)
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
    steady = [_timed_dispatch(torch, fused, mid)
              for _ in range(steady_dispatches)]
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
    return launches, dict(sec=sec, peak=peak, wave_ms=wave_ms,
                          busy_ms=busy_ms, launches_pw=launches_pw,
                          rehashes=c_rehashes, chunks=chunks)


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
    """Device time and launches of the next dispatch, by kernel
    (torch.profiler): ``(kernel ms, kernel launches)`` a launched
    wave."""
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
    _log("  by launches:")
    for e in sorted(kern, key=lambda e: -e.count)[:10]:
        _log(f"  {e.count:6d}x {e.self_device_time_total / 1e3:9.3f} ms "
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
    from stateright_tpu_torch.models.paxos import PaxosDevice, PaxosSys
    from stateright_tpu_torch.models.twopc import TwoPhaseDevice, TwoPhaseSys
    return (_build, engine, fused, table_mod, wave_mod, TwoPhaseDevice,
            TwoPhaseSys, PaxosDevice, PaxosSys)


def _log_ptxas(log: str) -> None:
    """ptxas' report (``-Xptxas -v``), a line a kernel: its registers,
    shared memory, stack frame and spills."""
    kernel, frame = None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            fn = re.search(r"\d(tile_front|send_rows|resolve_rows|claim_rows)",
                           mangled)
            model = re.search(r"(TwoPhase|Paxos)ILi(\d+)E", mangled)
            tail = re.search(r"(WaveTail|SenderTail)", mangled)
            kernel = ((fn.group(1) if fn else mangled)
                      + (f"<{model.group(1)}<{model.group(2)}>, "
                         f"{tail.group(1)}>" if model and tail else ""))
        elif "stack frame" in line:
            frame = line.strip()
        elif "Used" in line and kernel:
            _log(f"  {kernel}: {line.split(':', 1)[1].strip()}; {frame}")
            kernel, frame = None, ""


def phase_build(_build, table_mod, wave_mod) -> None:
    def build(name, load):
        t0 = time.monotonic()
        load()
        return name, time.monotonic() - t0

    # One nvcc a source, all started together.
    jobs = [("table", table_mod._lib),
            ("wave_twopc", lambda: (wave_mod._entry("twopc", 1),
                                    wave_mod._sender_entry("twopc", 1))),
            ("wave_paxos", lambda: (wave_mod._entry("paxos", 2),
                                    wave_mod._sender_entry("paxos", 2)))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        builds = [pool.submit(build, name, load) for name, load in jobs]
        for fut in builds:
            name, sec = fut.result()
            _log(f"built {name} in {sec:.2f} s")
            with open(os.path.join(_build.BUILD_DIR, name + ".log")) as f:
                _log_ptxas(f.read())


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
     TwoPhaseSys, PaxosDevice, PaxosSys) = _modules()
    t_start = time.monotonic()
    phase_build(_build, table_mod, wave_mod)
    card = _card_line()
    _log(f"card: {card}")
    if argv:
        r = phase_rehash(torch, table_mod, engine, fused, TwoPhaseSys)
        print(json.dumps({"rehash": {
            key: r[key] for key in ("ms", "plain_ms", "bound_ms", "parts",
                                    "peak", "runs", "one_call")}}))
        return 0

    # Each kernel against its plain version at full width, timed.
    w, rows, wave_case = phase_wave_kernel(torch, wave_mod, table_mod, engine,
                                           TwoPhaseSys)
    paxos_mid = _paxos_mid(PaxosSys)
    k = phase_kernel(torch, table_mod, engine, fused, wave_case, TwoPhaseSys,
                     paxos_mid)
    del wave_case
    sk = phase_sender_kernel(torch, wave_mod, table_mod, *rows)
    del rows
    pw, psk = phase_paxos_kernels(torch, wave_mod, table_mod, paxos_mid)
    del paxos_mid
    phase_small(TwoPhaseSys)
    phase_sharded_small(torch, fused, TwoPhaseSys)
    phase_paxos_small(PaxosSys, PaxosDevice)
    phase_refusals(TwoPhaseSys, TwoPhaseDevice)
    kernels = {"dedup_and_insert": table_mod.dedup_and_insert,
               "wave_megakernel": wave_mod.wave_megakernel,
               "sender_megakernel": wave_mod.sender_megakernel}
    # Each path's run reads its own kernels' launches: 2pc at 10 RMs on
    # the three paths, then paxos check 3 on the same three paths,
    # unsharded and sharded, the torch stages beside the kernels.
    twopc = ("2pc 10", functools.partial(TwoPhaseSys, 10),
             (FULL_UNIQUE, FULL_STATES),
             ["abort agreement", "commit agreement"], 20_000_000, 4)
    launches = phase_full(torch, kernels, fused, *twopc,
                          batch_size=BATCH)[0]["dedup_and_insert"]
    wave_launches = phase_full(torch, kernels, fused, *twopc,
                               batch_size=BATCH,
                               wave_kernel=True)[0]["wave_megakernel"]
    sender_launches = phase_full(
        torch, kernels, fused, *twopc, batch_size=BATCH // SHARDS,
        mesh=["cuda:0"] * SHARDS, wave_kernel=True)[0]["sender_megakernel"]
    paxos = ("paxos 3", functools.partial(PaxosSys, 3),
             (PAXOS_UNIQUE, PAXOS_STATES), ["value chosen"], PAXOS_MID, 2)
    sharded = dict(batch_size=BATCH // SHARDS, mesh=["cuda:0"] * SHARDS)
    runs = {}
    for tag, spawn in (("fused", dict(batch_size=BATCH)),
                       ("sharded", sharded),
                       ("fused, wave kernel", dict(batch_size=BATCH,
                                                   wave_kernel=True)),
                       ("sharded, sender kernel", dict(sharded,
                                                       wave_kernel=True))):
        runs[tag] = dict(zip(("launches", "run"), phase_full(
            torch, kernels, fused, *paxos, **spawn)))
    for tag, r in runs.items():
        run = r["run"]
        _log(f"paxos 3 {tag}: {run['sec']:.3f} s, {run['launches_pw']:.1f} "
             f"torch launches a launched wave, {run['busy_ms']:.3f} ms card "
             f"time a launched wave of {run['wave_ms']:.3f}, idle "
             f"{1 - run['busy_ms'] / run['wave_ms']:.1%}, peak device memory "
             f"{run['peak']} B, {run['rehashes']} rehashes in "
             f"{run['chunks']} chunks a slice, kernel launches "
             f"{r['launches']}")

    # Kernel 1 on the synthetic stream, on the default path's input of
    # each model (a mid-run wave's dedup fingerprints), and at the
    # rehash; kernels 2 and 3 on each model's mid-run rows.
    src = "stateright_tpu_torch/csrc/"
    pallas = "stateright_tpu/tpu/pallas_table.py:"
    k_err = max(v["max_abs_err"] for v in k.values())
    w_err = max(v["max_abs_err"] for v in (*w.values(), *pw.values()))
    s_err = max(v["max_abs_err"] for v in (*sk.values(), *psk.values()))
    print(json.dumps({"kernels": [
        _kernel_row("dedup_and_insert", src + "table.cu", pallas + "256",
                    launches, k_err, k["stream"]),
        _kernel_row("dedup_and_insert[mid-run wave]", src + "table.cu",
                    pallas + "256", launches, k_err, k["wave"]),
        _kernel_row("dedup_and_insert[paxos 3 wave]", src + "table.cu",
                    pallas + "256",
                    runs["fused"]["launches"]["dedup_and_insert"], k_err,
                    k["paxos"]),
        _kernel_row("dedup_and_insert[rehash]", src + "table.cu",
                    pallas + "256", launches, k_err, k["rehash"]),
        _kernel_row("wave_megakernel", src + "wave_twopc.cu", pallas + "380",
                    wave_launches, w_err, w["plain"]),
        _kernel_row("sender_megakernel", src + "wave_twopc.cu",
                    pallas + "451", sender_launches, s_err,
                    sk[(False, True)]),
        _kernel_row("wave_megakernel[paxos 3]", src + "wave_paxos.cu",
                    pallas + "380",
                    runs["fused, wave kernel"]["launches"]["wave_megakernel"],
                    w_err, pw["plain"]),
        _kernel_row("sender_megakernel[paxos 3]", src + "wave_paxos.cu",
                    pallas + "451",
                    runs["sharded, sender kernel"]["launches"][
                        "sender_megakernel"], s_err, psk[(False, True)])]}))
    _log(f"chip_smoke ran {time.monotonic() - t_start:.1f} s")
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
