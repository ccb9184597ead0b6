#!/usr/bin/env python3
"""Builds the port's kernels and drives the port on one CUDA card.

Usage, from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --rehash   # phase 1, then the rehash case of 3

Phases, in order; any failure exits non-zero and prints no result line:

1. build ``stateright_tpu_torch/csrc/table.cu``, ``wave_twopc.cu``,
   ``wave_paxos.cu`` (the wave kernel's and the sender kernel's entry
   points for 2pc and for paxos) and ``append.cu`` for ``sm_90a``, one
   ``nvcc`` each, all at once, and print each build time with ptxas'
   register and spill report, and the card's name and power limit;
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
   4,096 and ragged, each checked and timed as above; then the append
   kernel against its plain version on the outputs of those waves: the
   mid-run 2pc 10 wave (16,384 rows), the mid-run paxos 3 wave (16,384),
   the sharded shape (4 shards of 4,096, every shard's received rows,
   unequal tails), and the 2pc wave with no row new and with every row
   new: arena rows ``[0, tail + new_count)`` equal in all four arrays,
   no other row written; timed by kernel, beside the plain version and
   the bound;
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
   model without CUDA device code raise on the card. Then the on/off
   gates of the host loop: 2pc 5 and paxos 2, fused and at n = 4, on the
   kernels at 2 waves a dispatch (so that dispatches replay), with the
   defaults (graphs on, one dispatch in flight, no ladder) against ``cuda_graph=False``, ``inflight_dispatches=2`` and a
   ladder of 5 rungs: equal counts, tables equal as sets, and equal
   discovery chains and arena rows ``[0, tail)``, except the sharded
   ladder's, whose shards' row order follows the buckets (as in JAX):
   those equal the CPU run with the same knobs;
6. full width, 2pc at 10 RMs: batch 16,384 once with each path, and
   sharded at n = 4 with 4,096 rows a shard and the sender kernel:
   exactly 61,515,776 unique / 817,760,258 states; then ``paxos check
   3`` on the dedup kernel's path and on the kernels' (the wave kernel
   unsharded, the sender kernel sharded), batch 16,384 and sharded at n
   = 4 with 4,096 rows a shard: exactly 1,194,428 unique / 2,420,477
   states, "value chosen" found, no "linearizable" counterexample. Every
   run on the defaults: one CUDA graph a dispatch, one dispatch in
   flight, the append kernel. Each run with the kernels' launch counts
   (the replays' included) beside the waves and rehashes, and its graph
   captures, replays and capture seconds and deepest pipelining; the
   three kernel paths (2pc 10 on the wave kernel, paxos 3 on the wave
   kernel and sharded on the sender kernel) again with
   ``cuda_graph=False``, side by side; 2pc 10 on
   the wave kernel with graphs on at one dispatch in flight and at two,
   alternately, twice each (the in-flight depth's own effect); and
   ``paxos check 3`` on a ladder from 1,024 to 16,384 rows, exact. Then
   for each run but the ladder's, dispatches of a mid-run checker through
   the engine's own launch (a replay once its key is captured): one
   under ``torch.cuda.set_sync_debug_mode("error")``, a few timed alone
   for the host's µs a dispatch and the steady pace a wave, and one
   under ``torch.profiler`` (kernel time and launches by kernel, which
   are the graph's nodes), which together give the card's idle share;
7. checkpoints and resume: 2pc 5 and paxos 2, fused on the wave kernel
   and on 4 stacked shards on the sender kernel, stopped at a target with
   a checkpoint at every rest point, against the CPU run with the same
   knobs: every section of the last generation and of its ``.prev`` equal
   byte for byte; each file resumed on the card by each engine to the
   full counts and discovery chains; ``paxos check 3`` at full width
   (batch 16,384 fused on the wave kernel, 4 x 4,096 on the sender
   kernel) stopped at 1,000,000 states after periodic generations, each
   file resumed on both engines to exactly 1,194,428 / 2,420,477 with
   "value chosen" replayed and no counterexample, and one
   ``restart_from`` of a periodic generation; 2pc at 10 RMs on the wave
   kernel stopped at 200,000,000 states, its snapshot timed in parts, its
   compressed write timed with the file's bytes, the file resumed to
   exactly 61,515,776 / 817,760,258 with every kernel's launches exact
   (the resumed table's chunks of the dedup kernel included), and the
   resumed table's build held to the plain version and timed beside the
   host's insert and upload (the JAX package's way) and its bound;
8. the classic per-wave engine (``spawn_cuda_bfs(fused=False)``,
   ``classic.py``) on the card against the same run on the CPU: 2pc 3, 5
   and 5 with symmetry and paxos 1 and 2 on both successor paths (counts,
   discovery chains, parent maps and every wave's bucket, rows, output
   rung, new rows and overflow); 2pc 3 with a visitor (288 states
   recorded, the classic engine spawned, ``fused=True`` refused) and with
   a property the host evaluates (warned, found); 2pc 4 with every wave
   at an output rung of 8 rows, so that the regather runs, on both paths,
   against the ladder off; the pipeline on against off; a checkpoint of
   2pc 5 equal to the CPU's section by section and resumed on the fused
   and the classic engine. Then, none cut, at batch 16,384 with graphs on,
   ``paxos check 3`` and 2pc at 10 RMs on both paths, exactly 1,194,428 /
   2,420,477 and 61,515,776 / 817,760,258, the kernels' launches exact
   (one a wave, plus the rehash chunks); each run's seconds, waves,
   captures and replays, output rungs and regathers, host us a wave
   (launch, processing, waiting), bytes down a wave, peak device memory
   and the host parent log's bytes, beside the fused run of phase 6; and
   waves of a mid-run checker from one point: one replay under
   ``set_sync_debug_mode("error")``, a few timed, one under
   ``torch.profiler`` (the card's time a wave, and its idle share of the
   run's pace);
9. the kernels line, the script's running time, the card line and the
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
    kernels and memsets ``run`` launched, by name (a replayed graph's
    nodes too). A profile that records no device time at all (seen once
    on the card, after an earlier profile in the same process) is taken
    again, ``tries`` times at most, then raises."""
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


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _append_case(torch, engine, append_mod, tag, src, new_mask, div, tails):
    """The append kernel against its plain version: the new rows
    (``new_mask [n, R]``) of one wave's outputs ``src`` (``vecs [n, R, Wp],
    fps [n, R], par and ebits [n, R / div]``), into an arena of random rows
    with shard k's tail at ``tails[k]``: arena rows ``[0, tail +
    new_count)`` equal in all four arrays, and no other row written by the
    kernel (the dump row included); then its time by kernel, beside the
    plain version's and the bound."""
    dev = torch.device("cuda")
    n, R = new_mask.shape
    wp = src[0].shape[2]
    gen = torch.Generator(device="cuda").manual_seed(17)
    U = _pow2(max(tails) + R) + 1

    def rand(shape, dtype):
        return torch.randint(-(1 << 62), 1 << 62, shape, generator=gen,
                             device=dev).to(dtype)

    arena = (rand((n, U, wp), torch.int32), rand((n, U), torch.int64),
             rand((n, U), torch.int64), rand((n, U), torch.int32))
    comp = engine.compaction_order(new_mask)
    new_count = new_mask.sum(1)
    tail = torch.tensor(tails, dtype=torch.int64, device=dev)
    got = tuple(a.clone() for a in arena)
    want = tuple(a.clone() for a in arena)
    append_mod.append_rows(got, src, comp, new_count, tail, div)
    append_mod.append_rows_plain(want, src, comp, new_count, tail, div)
    torch.cuda.synchronize()
    for k in range(n):
        end = tails[k] + int(new_count[k])
        for name, g, w, a in zip(("vecs", "fps", "par", "ebits"), got, want,
                                 arena):
            if not torch.equal(g[k, :end], w[k, :end]):
                raise AssertionError(f"append kernel ({tag}) disagrees with "
                                     f"its plain version on {name}, shard "
                                     f"{k}")
            if not torch.equal(g[k, end:], a[k, end:]):
                raise AssertionError(f"append kernel ({tag}) wrote {name} "
                                     f"past row {end} of shard {k}")
    new = int(new_count.sum())
    del got, want
    args = (arena, src, comp, new_count, tail, div)
    ms, parts = _breakdown(torch, append_mod.append_rows, 5, lambda: args)
    call_ms = _time_ms(torch, append_mod.append_rows, 5, lambda: args)
    plain_ms = _time_ms(torch, append_mod.append_rows_plain, 3,
                        lambda: args)
    # Bound: the function's own bytes, each once: a new row's compaction
    # index (8 B) and source row read (4 Wp + 8 B: the packed words and
    # its fingerprint), its arena row written (4 Wp + 20 B: those, its
    # parent's fingerprint and eventually bits), and the parent's 12 B
    # read once a distinct parent of the new rows (siblings share one).
    parents = sum(int(torch.unique(comp[k, :int(new_count[k])] // div)
                      .numel()) for k in range(n))
    nbytes = new * (2 * (4 * wp + 8) + 8 + 12) + 12 * parents
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    _log(f"append kernel == plain ({tag}) at n={n} x R={R}, Wp={wp}: "
         f"new={new} of {n * R} from {parents} parents, tails {tails}, no "
         f"other row written; "
         f"kernel {ms:.4f} ms on the card ({call_ms:.4f} ms a call between "
         f"CUDA events), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
         f"({nbytes} B over HBM); by kernel, a call:")
    _log_parts(parts)
    return dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                parts=parts, new=new)


def phase_append(torch, engine, wave_mod, table_mod, append_mod, rows,
                 table, paxos_mid):
    """The append kernel against its plain version on the outputs of the
    mid-run waves: 2pc 10's 16,384 rows (``rows``, against ``table``)
    through the wave kernel, with no row new and with every row new too;
    paxos 3's next 16,384 rows of ``paxos_mid``, against its engine's
    table with its engine's scratch; and the sharded shape, the 2pc rows
    as ``SHARDS`` shards of 4,096 through the sender kernel, each shard's
    received rows (every sender's rows that it owns) at its own tail."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(19)
    out = {}

    def wave(dm, store, layout, tbl, scratch):
        valid = torch.ones(store.shape[0], dtype=torch.bool, device=dev)
        got = wave_mod.wave_megakernel(dm, store, valid, tbl.clone(), False,
                                       layout, scratch=scratch)
        B = store.shape[0]
        # The parents' fingerprints and eventually bits: random, as the
        # kernel only copies them.
        par = torch.randint(-(1 << 62), 1 << 62, (1, B), generator=gen,
                            device=dev)
        ebits = torch.randint(0, 1 << 30, (1, B), generator=gen, device=dev,
                              dtype=torch.int64).to(torch.int32)
        return (got[0][None], got[1][None], par, ebits), got[3][None]

    dm, store, layout = rows
    S = store.shape[0] * dm.max_fanout
    scratch = table_mod.DedupScratch(S, dev)
    src, new_mask = wave(dm, store, layout, table, scratch)
    out["2pc"] = _append_case(torch, engine, append_mod,
                              "mid-run 2pc 10 wave", src, new_mask,
                              dm.max_fanout, [2 * S])
    out["none"] = _append_case(torch, engine, append_mod,
                               "2pc 10 wave, no row new", src,
                               torch.zeros_like(new_mask), dm.max_fanout,
                               [2 * S])
    out["all"] = _append_case(torch, engine, append_mod,
                              "2pc 10 wave, every row new", src,
                              torch.ones_like(new_mask), dm.max_fanout,
                              [2 * S])
    del src, new_mask, scratch
    pstore = paxos_mid._vecs[paxos_mid._head:paxos_mid._head + BATCH].clone()
    psrc, pmask = wave(paxos_mid._dm, pstore, paxos_mid._layout,
                       paxos_mid._table, paxos_mid._scratch)
    out["paxos"] = _append_case(
        torch, engine, append_mod, "mid-run paxos 3 wave", psrc, pmask,
        paxos_mid._dm.max_fanout, [paxos_mid._tail])
    del psrc, pmask, pstore
    # The sharded shape: shard k receives every sender's rows and appends
    # those it owns that its sender sent (``send_mask``).
    n, B, wp = SHARDS, BATCH // SHARDS, layout.packed_width
    sS = B * dm.max_fanout
    sscratch = table_mod.DedupScratch(n * sS, dev, n)
    succ, dedup, path, _, send = wave_mod.sender_megakernel(
        dm, store.reshape(n, B, wp).contiguous(),
        torch.ones((n, B), dtype=torch.bool, device=dev), False, layout,
        True, scratch=sscratch)
    R = n * sS
    owner = dedup.reshape(R) % n
    owner = torch.where(dedup.reshape(R) < 0, (owner + (1 << 64) % n) % n,
                        owner)
    new_mask = torch.stack([send.reshape(R) & (owner == k)
                            for k in range(n)])
    recv = (succ.reshape(1, R, wp).expand(n, R, wp).contiguous(),
            path.reshape(1, R).expand(n, R).contiguous(),
            torch.randint(-(1 << 62), 1 << 62, (n, R), generator=gen,
                          device=dev),
            torch.randint(0, 1 << 30, (n, R), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32))
    out["sharded"] = _append_case(
        torch, engine, append_mod, f"sharded {n} x {B}", recv, new_mask, 1,
        [sS, sS + 1_000, sS + 5, sS + 77_777])
    return out


def phase_rehash(torch, table_mod, engine, fused, TwoPhaseSys):
    """The rehash at the shape of the full 10-RM run's last: its table of
    2^26 slots, about half full (a rehash runs once the next dispatch
    could pass half load), into an empty one of 2^27, through a 10-RM
    engine's own ``_insert_chunked`` (128 strided chunks of 524,288 rows,
    at most its 851,968 scratch rows, with its scratch), against the
    plain version's one call: the tables equal as sets, no key without a
    slot, the scratch handed back clean. Then its time and its peak of
    device memory beside those of chunks that are runs of adjacent slots
    (the form ``_insert_chunked`` avoids: their keys share their hash's
    high bits, which also pick their scratch slots),
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
        return eng._insert_chunked(old, new)

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
    point = _Point(torch, fused, mid)
    waves, _, _, _, replay = _timed_dispatch(torch, point, sync_check=True)
    if waves == 0 or not replay:
        raise AssertionError(f"the sync-checked dispatch ran {waves} waves "
                             f"(a replay: {replay})")
    _log(f"2pc 5 n={SHARDS} dedup_kernel: one replayed dispatch under "
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


def _state(c):
    """``(arena, table)`` of checker ``c`` on the host: each shard's arena
    rows ``[0, tail)`` (vecs, fps, par, ebits), and each table slice's keys
    sorted (the table as a set), a tuple a shard."""
    cols = (c._vecs, c._fps, c._par, c._ebits)
    if hasattr(c, "_tails"):
        arena = [tuple(a[k, :int(c._tails[k])].cpu() for a in cols)
                 for k in range(c._n)]
        tables = [(t[t != -1].sort().values.cpu(),) for t in c._table]
    else:
        arena = [tuple(a[:c._tail].cpu() for a in cols)]
        tables = [(c._table[c._table != -1].sort().values.cpu(),)]
    return arena, tables


def _same(torch, a, b) -> bool:
    return len(a) == len(b) and all(
        all(torch.equal(x, y) for x, y in zip(p, q)) for p, q in zip(a, b))


def phase_gates(torch, TwoPhaseSys, PaxosSys):
    """The host loop's knobs on the card, each against the defaults (one
    graph a dispatch, one dispatch in flight, no ladder): 2pc 5 and
    paxos 2, fused and on ``SHARDS`` stacked shards, on the kernels, at 2
    waves a dispatch (at 16 these runs take 2 or 3 dispatches, and no
    bucket is dispatched twice between growths: nothing would replay). Each
    pair gives equal counts and tables equal as sets, and equal discovery
    chains and arena rows ``[0, tail)``, except a sharded run on a ladder:
    each shard appends a wave's rows sender by sender, so its row order
    (and the first discoverer of a state) follows the buckets, in JAX as
    here; its chains and arena rows equal the CPU run with the same
    knobs."""
    for name, model in (("2pc 5", functools.partial(TwoPhaseSys, 5)),
                        ("paxos 2", functools.partial(PaxosSys, 2))):
        for engine, base, low, spawn in (
                ("fused", 1024, 64, {}),
                (f"n={SHARDS}", 256, 16, dict(mesh=["cuda:0"] * SHARDS))):
            def knobs(**kw):
                return dict(dict(spawn, batch_size=base, wave_kernel=True,
                                 waves_per_dispatch=2), **kw)

            def run(**kw):
                return model().checker().spawn_cuda_bfs(**knobs(**kw)).join()

            on = run()
            want = (on.unique_state_count(), on.state_count(), _chains(on),
                    _state(on))
            g = on.scheduler_stats()["graphs"]
            if not g or not g["replays"]:
                raise AssertionError(f"{name} {engine}: no dispatch was a "
                                     f"replay ({g})")
            _log(f"{name} {engine} on the defaults: unique={want[0]} "
                 f"states={want[1]}, {on.dispatches} dispatches, graphs {g}, "
                 f"max_inflight {on.scheduler_stats()['max_inflight']}")
            for what, kw in (
                    ("cuda_graph=False", dict(cuda_graph=False)),
                    ("inflight_dispatches=2", dict(inflight_dispatches=2)),
                    ("a 5-rung ladder", dict(batch_size=low,
                                             max_batch_size=base))):
                c = run(**kw)
                got = (c.unique_state_count(), c.state_count(), _chains(c),
                       _state(c))
                tag = f"{name} {engine}, {what}"
                if got[:2] != want[:2] or not _same(torch, got[3][1],
                                                    want[3][1]):
                    raise AssertionError(f"{tag}: counts {got[:2]} against "
                                         f"{want[:2]}, or the tables differ "
                                         "as sets")
                stats = c.scheduler_stats()
                if kw.get("cuda_graph", True) and not stats["graphs"][
                        "replays"]:
                    raise AssertionError(f"{tag}: no dispatch was a replay")
                if "max_batch_size" in kw:
                    if len(stats["bucket_ladder"]) != 5 or len(
                            stats["bucket_dispatches"]) < 2:
                        raise AssertionError(f"{tag}: the ladder did not "
                                             f"adapt ({stats})")
                if "max_batch_size" in kw and spawn:
                    cpu = model().checker().spawn_cuda_bfs(**dict(
                        knobs(**kw), mesh=["cpu"] * SHARDS)).join()
                    ref, against = (_chains(cpu), _state(cpu)), "the CPU run"
                else:
                    ref, against = (want[2], want[3]), "the defaults"
                if got[2] != ref[0] or not _same(torch, got[3][0],
                                                 ref[1][0]):
                    raise AssertionError(f"{tag}: discovery chains or arena "
                                         f"rows differ from {against}")
                _log(f"{tag}: equal to {against} in counts, chains, arena "
                     f"rows [0, tail) and the table as a set; "
                     f"{c.dispatches} dispatches, buckets "
                     f"{stats['bucket_dispatches']}, max_inflight "
                     f"{stats['max_inflight']}, graphs {stats['graphs']}")


def phase_full(torch, kernels, fused, config, model, want_counts,
               want_found, mid_target, steady_dispatches, **spawn):
    """``model()`` (``config`` names it) to its end through
    ``spawn_cuda_bfs(**spawn)``, with every kernel's launch count set to
    0 just before and read just after: exactly ``want_counts`` (unique,
    states), the discoveries ``want_found``, no counterexample, the
    launches exact; then, unless ``steady_dispatches`` is 0, the
    dispatches of a checker stopped at ``mid_target`` states, through its
    own launch, ``steady_dispatches`` of them timed alone. Returns the
    launch counts by kernel name and the run's numbers."""
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
    sched = c.scheduler_stats()
    graphs = sched["graphs"] or {"captures": 0, "replays": 0,
                                 "capture_sec": 0.0}
    knobs = {k: v for k, v in spawn.items() if k in (
        "cuda_graph", "inflight_dispatches", "max_batch_size")}
    config = f"{config}{' ' + str(knobs) if knobs else ''}"
    _log(f"{config} ({c.kernel_path()}, {n} shard(s)): unique={unique} "
         f"states={states} sec={sec:.3f} states/s={states / sec:.1f} "
         f"waves={c.waves} dispatches={c.dispatches} rehashes={c.rehashes} "
         f"arena_grows={c.arena_grows} candidates={c.candidates} "
         f"launches={launches} max_memory_allocated={peak} "
         f"captures={graphs['captures']} replays={graphs['replays']} "
         f"capture_sec={graphs['capture_sec']:.3f} "
         f"max_inflight={sched['max_inflight']} "
         f"buckets={sched['bucket_dispatches']}")
    if (unique, states) != want_counts:
        raise AssertionError(f"{config}: {(unique, states)} != "
                             f"{want_counts}")
    found = c.discoveries()
    if sorted(found) != want_found:
        raise AssertionError(f"{config} discoveries: {sorted(found)}")
    c.assert_properties()
    if spawn.get("cuda_graph", True) and not graphs["replays"]:
        raise AssertionError(f"{config}: no dispatch was a replay")
    c_waves, c_dispatches, c_rehashes = c.waves, c.dispatches, c.rehashes
    # Every dispatch launches K waves, also those past a rest point, and
    # a replay counts its captured launches. A wave runs the dedup kernel
    # once a shard, unless the single-kernel wave does the wave's dedup
    # itself, and the append kernel once; a rehash runs the dedup kernel
    # once a chunk of each old table slice: the least power of two of
    # chunks of at most the engine's scratch rows.
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
        "sender_megakernel": launched if wave_kernel and sharded else 0,
        "append_rows": launched}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want} "
                             f"for {c._K} x {c.dispatches} launched waves "
                             f"and {c.rehashes} rehashes ({chunks} chunks) "
                             f"on {n} shard(s)")
    run = dict(sec=sec, peak=peak, rehashes=c_rehashes, chunks=chunks,
               captures=graphs["captures"], replays=graphs["replays"],
               capture_sec=graphs["capture_sec"],
               max_inflight=sched["max_inflight"],
               buckets=sched["bucket_dispatches"], dispatches=c_dispatches)
    del c
    if not steady_dispatches:
        return launches, run

    # Dispatches of a mid-run checker through its own launch, each from
    # the same point of its run (the script puts its device state back
    # after each), once the dispatch at that point is a replay (graphs
    # on): the first with every synchronisation an error (nothing inside
    # a dispatch may wait for the card), then a few for the host's time a
    # dispatch and the steady pace, then one under torch.profiler for the
    # kernel time.
    mid = (model().checker().target_state_count(mid_target)
           .spawn_cuda_bfs(**spawn).join())
    mid._stats[..., fused.ST_TARGET] = 1 << 62
    point = _Point(torch, fused, mid)
    waves, dev_ms, wall_ms, host_us, replay = _timed_dispatch(
        torch, point, sync_check=True)
    if waves == 0:
        raise AssertionError("the sync-checked dispatch ran no wave")
    _log(f"one dispatch{' (a replay)' if replay else ''} under "
         f"set_sync_debug_mode('error'): {waves} waves, no synchronisation, "
         f"{dev_ms:.3f} ms on the card, {wall_ms:.3f} ms wall, "
         f"{host_us:.1f} us in the host's launch")
    # Every dispatch launches K waves' work, also those past a rest
    # point (no-ops with no valid row), so the pace is per launched wave.
    K = mid._K
    steady = [_timed_dispatch(torch, point)
              for _ in range(steady_dispatches)]
    for w, d, h, us, rep in steady:
        _log(f"steady dispatch{' (a replay)' if rep else ''}: {w} of {K} "
             f"waves expanded rows, {d:.3f} ms on the card, {h:.3f} ms "
             f"wall, {h / K:.3f} ms a launched wave, {us:.1f} us in the "
             "host's launch")
    wave_ms = sum(s[2] for s in steady) / (K * len(steady))
    host_us = sum(s[3] for s in steady) / len(steady)
    _log(f"steady pace: {wave_ms:.3f} ms a launched wave over "
         f"{K * len(steady)}, {host_us:.1f} us of host time a dispatch's "
         f"launch (the full run: {sec * 1e3 / c_waves:.3f} ms a "
         f"wave that expanded rows, {sec * 1e3 / (K * c_dispatches):.3f} "
         "ms a launched wave, rest points included)")
    busy_ms, launches_pw = phase_profile(torch, point)
    _log(f"card busy {busy_ms:.3f} ms a launched wave (torch.profiler): "
         f"{busy_ms / wave_ms:.1%} of the steady pace, idle "
         f"{1 - busy_ms / wave_ms:.1%}; {launches_pw:.1f} kernel launches "
         f"a launched wave{' (graph nodes)' if mid._graphs else ''}, host "
         f"time an op {wave_ms / launches_pw * 1e3:.2f} us")
    run.update(wave_ms=wave_ms, busy_ms=busy_ms, launches_pw=launches_pw,
               host_us=host_us)
    return launches, run


class _Point:
    """A point of a mid-run checker's run to time dispatches from: the
    checker ``mid`` grown if its next dispatch needs it, that dispatch's
    ``bucket``, and a copy of its device state (stats, arena, table).
    ``launch`` runs one dispatch from the point through the checker's own
    launch, reads its waves and puts the device state back in place, so
    every dispatch from it expands the same waves, no rest point comes,
    and a dispatch graph, which holds those tensors, stays valid. The
    host's view of the run never moves. The first dispatch from the
    point warms its key up and the second captures (graphs on); both run
    in ``__init__``, so every later one is a replay."""

    def __init__(self, torch, fused, mid):
        self.torch, self.fused, self.mid = torch, fused, mid
        self.bucket = mid._pick_bucket()
        if mid._needs_growth(self.bucket):
            mid._grow(self.bucket)
        self._state = [mid._stats, mid._vecs, mid._fps, mid._par,
                       mid._ebits, mid._table]
        self._saved = [t.clone() for t in self._state]
        for _ in range(2):
            if self.replays():
                break
            self.launch()
        if mid._graphs is not None and not self.replays():
            raise AssertionError("no dispatch graph after two dispatches")

    def replays(self) -> bool:
        """Whether the next dispatch from the point is a graph's replay."""
        g = self.mid._graphs
        return g is not None and g.has_graph(self.bucket)

    def launch(self):
        """``(waves, entry)`` of one dispatch from the point, the device
        state put back after it."""
        entry = self.mid._launch(self.bucket)
        host, copied, _ = entry
        if copied is not None:
            copied.synchronize()
        waves = int(host.numpy()[..., self.fused.ST_WAVES].reshape(-1)[0])
        self.rewind()
        return waves, entry

    def rewind(self) -> None:
        for t, s in zip(self._state, self._saved):
            t.copy_(s)
        self.torch.cuda.synchronize()


def _timed_dispatch(torch, point, sync_check=False):
    """One dispatch from ``point``, timed by CUDA events, by the host clock
    to the end, and by the host clock over the launch call: ``(waves,
    device ms, wall ms, host us of the launch, replayed)``."""
    replay = point.replays()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    mid = point.mid
    t0 = time.perf_counter()
    if sync_check:
        torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        entry = mid._launch(point.bucket)
        host_us = (time.perf_counter() - t0) * 1e6
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    host, copied, _ = entry
    if copied is not None:
        copied.synchronize()
    waves = int(host.numpy()[..., point.fused.ST_WAVES].reshape(-1)[0])
    point.rewind()
    return waves, start.elapsed_time(end), wall_ms, host_us, replay


def phase_profile(torch, point):
    """Device time and launches of one dispatch from ``point``, by kernel
    (``torch.profiler``): ``(kernel ms, kernel launches)`` a launched
    wave. With graphs on the dispatch is a replay, whose launches are the
    graph's nodes."""
    mid = point.mid

    def run(_):
        return point.launch()[0]

    kern, waves = _profiled(torch, run, point.rewind)
    kern.sort(key=lambda e: -e.self_device_time_total)
    total_ms = sum(e.self_device_time_total for e in kern) / 1e3
    port_ms = sum(e.self_device_time_total for e in kern
                  if any(k in e.key for k in ("claim_rows", "resolve_rows",
                                              "tile_front", "send_rows",
                                              "append_rows"))
                  ) / 1e3
    n_launch = sum(e.count for e in kern)
    _log(f"profiled dispatch{' (a replay)' if point.replays() else ''}: "
         f"{waves} waves, {n_launch} kernel launches, {total_ms:.3f} ms of "
         f"kernel time, the port's kernels {port_ms:.3f} ms")
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


# -- Checkpoints and resume ------------------------------------------------


def _sections(path):
    """A checkpoint file's sections: name -> (dtype, shape, bytes)."""
    import numpy as np

    with np.load(path) as data:
        return {k: (str(data[k].dtype), data[k].shape, data[k].tobytes())
                for k in data.files}


def _same_files(ckpt_mod, a: str, b: str, tag: str) -> None:
    """Every section of ``a`` and of ``b`` equal byte for byte, in the
    last generation and in its ``.prev``."""
    for suffix in ("", ckpt_mod.PREV_SUFFIX):
        sa, sb = _sections(a + suffix), _sections(b + suffix)
        bad = sorted(k for k in set(sa) | set(sb) if sa.get(k) != sb.get(k))
        if bad:
            raise AssertionError(f"{tag}: sections {bad} of "
                                 f"{suffix or 'the last generation'} "
                                 "differ from the CPU run's")


def phase_checkpoint_small(ckpt_mod, TwoPhaseSys, PaxosSys, workdir,
                           device="cuda:0"):
    """Checkpoints of 2pc 5 and paxos 2 on ``device``, fused on the wave
    kernel and on ``SHARDS`` stacked shards on the sender kernel, at 2
    waves a dispatch with a checkpoint due at every rest point and a
    target, against the CPU run with the same knobs: every section of the
    last generation and of its ``.prev`` equal byte for byte. Then each
    file resumed on ``device`` by each engine: the full run's counts; the
    full run's discovery chains on the writer's own engine, and on the
    other those of the CPU run resuming the same file on that engine (a
    property found before the checkpoint keeps the writer's chain)."""
    for name, model, target, base in (
            ("2pc 5", functools.partial(TwoPhaseSys, 5), 20_000, 256),
            ("paxos 2", functools.partial(PaxosSys, 2), 15_000, 256)):
        def engines(dev):
            return {"fused": dict(device=dev, batch_size=base),
                    f"n={SHARDS}": dict(mesh=[dev] * SHARDS,
                                        batch_size=base // SHARDS)}

        def spawn(b, **kw):
            return b.spawn_cuda_bfs(wave_kernel=True, waves_per_dispatch=2,
                                    **kw).join()

        full, files = {}, {}
        for engine, kw in engines(device).items():
            full[engine] = spawn(model().checker(), **kw)
            paths = [os.path.join(workdir, f"{name}-{engine}-{where}.npz")
                     for where in ("card", "cpu")]
            for path, spawn_kw in zip(paths, (kw, engines("cpu")[engine])):
                c = spawn(model().checker().target_state_count(target),
                          checkpoint_path=path, checkpoint_every_waves=1,
                          **spawn_kw)
                if c.checkpoints < 3:
                    raise AssertionError(f"{name} {engine}: {c.checkpoints} "
                                         "checkpoints")
            _same_files(ckpt_mod, *paths, f"{name} {engine}")
            files[engine] = paths[0]
            _log(f"{name} {engine}: stopped at unique="
                 f"{c.unique_state_count()} states={c.state_count()} after "
                 f"{c.checkpoints} checkpoints; the last two generations "
                 "equal the CPU run's, section by section, byte for byte")
        want = (full["fused"].unique_state_count(),
                full["fused"].state_count())
        for writer, path in files.items():
            for reader, kw in engines(device).items():
                c = spawn(model().checker(), resume_from=path, **kw)
                tag = f"{name}: {writer}'s file resumed on {reader}"
                got = (c.unique_state_count(), c.state_count())
                if got != want:
                    raise AssertionError(f"{tag}: {got} != {want}")
                if writer == reader:
                    ref, against = full[reader], "the full run's"
                else:
                    ref = spawn(model().checker(), resume_from=path,
                                **engines("cpu")[reader])
                    against = "those of the CPU run resuming the file"
                if _chains(c) != _chains(ref) or not _chains(c):
                    raise AssertionError(f"{tag}: discovery chains differ "
                                         f"from {against}")
                _log(f"{tag}: unique={got[0]} states={got[1]}, discovery "
                     f"chains {sorted(_chains(c))} equal to {against}")


def _resume_exact(c, want, found, tag):
    """A resumed run's counts, discoveries and properties."""
    got = (c.unique_state_count(), c.state_count())
    if got != want:
        raise AssertionError(f"{tag}: {got} != {want}")
    if sorted(c.discoveries()) != found:
        raise AssertionError(f"{tag}: discoveries {sorted(c.discoveries())}")
    c.assert_properties()  # the paths replay; no counterexample


def phase_checkpoint_paxos(ckpt_mod, PaxosSys, workdir, device="cuda:0",
                           batch=BATCH, clients=3,
                           want=(PAXOS_UNIQUE, PAXOS_STATES),
                           target=1_000_000, waves=8):
    """``paxos check 3`` at full width, fused on the wave kernel (batch
    16,384) and sharded ``SHARDS`` x 4,096 on the sender kernel, 8 waves a
    dispatch, stopped at ``target`` states with a checkpoint due at every
    rest point before it; each file resumed on its own engine and on the
    other to exactly the full counts, "value chosen" found and its path
    replayed, no "linearizable" counterexample; then ``restart_from`` of
    the fused file's periodic generation (its ``.prev``) on a finished
    checker. Returns each run's seconds."""
    engines = {"fused": dict(device=device, batch_size=batch),
               f"n={SHARDS}": dict(mesh=[device] * SHARDS,
                                   batch_size=batch // SHARDS)}
    spawn = dict(wave_kernel=True, waves_per_dispatch=waves)
    files, out, finished = {}, {}, {}
    for engine, kw in engines.items():
        path = os.path.join(workdir, f"paxos{clients}-{engine}.npz")
        t0 = time.monotonic()
        c = (PaxosSys(clients).checker().target_state_count(target)
             .spawn_cuda_bfs(checkpoint_path=path, checkpoint_every_waves=1,
                             **spawn, **kw).join())
        sec = time.monotonic() - t0
        if c.checkpoints < 3:
            raise AssertionError(f"paxos {clients} {engine}: only "
                                 f"{c.checkpoints - 1} periodic checkpoints "
                                 "before the target")
        head = ckpt_mod.verify_file(path)
        prev = ckpt_mod.verify_file(path + ckpt_mod.PREV_SUFFIX)
        _log(f"paxos {clients} {engine}: stopped at unique="
             f"{c.unique_state_count()} states={c.state_count()} in "
             f"{sec:.3f} s, {c.checkpoints} checkpoints ({c.checkpoints - 1} "
             f"periodic); the file's header {head['unique_count']} / "
             f"{head['state_count']}, its .prev {prev['unique_count']} / "
             f"{prev['state_count']}")
        files[engine] = path
        out[f"{engine} to {target}"] = sec
    for writer, path in files.items():
        for reader, kw in engines.items():
            t0 = time.monotonic()
            c = PaxosSys(clients).checker().spawn_cuda_bfs(
                resume_from=path, **spawn, **kw).join()
            sec = time.monotonic() - t0
            tag = f"paxos {clients}: {writer}'s file resumed on {reader}"
            _resume_exact(c, want, ["value chosen"], tag)
            out[f"{writer} on {reader}"] = sec
            finished[reader] = c
            _log(f"{tag}: unique={want[0]} states={want[1]} in {sec:.3f} s, "
                 "'value chosen' found and replayed, no counterexample")
    c = finished["fused"]
    t0 = time.monotonic()
    c.restart_from(files["fused"] + ckpt_mod.PREV_SUFFIX).join()
    sec = time.monotonic() - t0
    _resume_exact(c, want, ["value chosen"],
                  f"paxos {clients}: restart_from the periodic file")
    out["restart_from"] = sec
    _log(f"paxos {clients}: restart_from the fused run's periodic "
         f"generation (its .prev) on a finished fused checker: "
         f"unique={want[0]} states={want[1]} in {sec:.3f} s")
    return out


def _seed_case(torch, table_mod, engine, eng, visited, cap):
    """The resumed table's build of ``visited`` into ``cap`` slots, as
    the engine ``eng`` builds it (kernel 1 in strided chunks with its
    scratch, ``_insert_chunked``), against
    the plain version's one call as sets, the scratch clean; its time by
    kernel, the plain version's, and the host's insert plus upload (the
    JAX package's way, ``engine.host_table_insert``), with kernel 1's
    bound by bytes."""
    import numpy as np

    dev = eng._device
    keys = torch.from_numpy(visited.view(np.int64)).to(dev)

    def setup():
        return (torch.full((cap,), -1, dtype=torch.int64, device=dev),)

    (t_k,), (t_p,) = setup(), setup()
    full = eng._insert_chunked(keys, t_k)
    table_mod.dedup_and_insert_plain(keys, t_p)
    torch.cuda.synchronize()
    if bool(full) or not torch.equal(torch.sort(t_k).values,
                                     torch.sort(t_p).values):
        raise AssertionError("the resumed table built by the dedup kernel "
                             "differs from the plain version's as a set")
    _check_clean(torch, eng._scratch, "the resumed table's build")
    n = len(visited)
    del t_k, t_p

    def chunked(table):
        return eng._insert_chunked(keys, table)

    call_ms = _time_ms(torch, chunked, 3, setup)
    ms, parts = _breakdown(torch, chunked, 3, setup)
    plain_ms = _time_ms(torch, table_mod.dedup_and_insert_plain, 1,
                        lambda: (keys,) + setup())
    t0 = time.monotonic()
    host = np.full(cap, np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    engine.host_table_insert(host, visited)
    t1 = time.monotonic()
    torch.from_numpy(host.view(np.int64)).to(dev)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    # Bound: the function's bytes, each once: the keys read, two masks
    # written, one 32-byte sector a key in the table.
    nbytes = 8 * n + 2 * n + 32 * n
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chunks = eng._chunks(n)
    _log(f"resumed table's build: {n} keys into 2^{cap.bit_length() - 1} "
         f"slots, {chunks} strided chunks of kernel 1, {ms:.4f} ms on the "
         f"card ({call_ms:.4f} ms between CUDA events), plain one call "
         f"{plain_ms:.4f} ms, host_table_insert {(t1 - t0) * 1e3:.1f} ms "
         f"plus its upload {(t2 - t1) * 1e3:.1f} ms, bound {bound_ms:.4f} ms "
         f"({nbytes} B over HBM); by kernel and memset:")
    _log_parts(parts)
    return dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                parts=parts, host_ms=(t1 - t0) * 1e3,
                upload_ms=(t2 - t1) * 1e3, chunks=chunks, keys=n)


def phase_checkpoint_2pc(torch, kernels, fused, table_mod, engine, ckpt_mod,
                         TwoPhaseSys, workdir, device="cuda:0", rm=10,
                         batch=BATCH, target=200_000_000,
                         want=(FULL_UNIQUE, FULL_STATES)):
    """2pc at 10 RMs on the wave kernel, batch 16,384, stopped at
    ``target`` states: its snapshot timed in parts (the queue's rows read
    from the card, the visited set sorted on the card and read, the
    parent sections), then ``write_atomic`` (compressed, as in JAX) timed
    with the file's bytes; the file resumed on the wave kernel to exactly
    the full counts, with every kernel's launches set to 0 just before the
    spawn and read after it (the seed's chunks, the rehashes' and the
    waves' launches exact), and the file's load timed alone; and the
    resumed table's build timed."""
    import numpy as np

    spawn = dict(device=device, batch_size=batch, wave_kernel=True)
    t0 = time.monotonic()
    c = (TwoPhaseSys(rm).checker().target_state_count(target)
         .spawn_cuda_bfs(**spawn).join())
    stop_sec = time.monotonic() - t0
    torch.cuda.synchronize()
    times = {}
    t0 = time.monotonic()
    blocks = c._pending_blocks()
    times["queue rows"] = time.monotonic() - t0
    t0 = time.monotonic()
    visited = c._visited_sorted()
    times["visited sort"] = time.monotonic() - t0
    t0 = time.monotonic()
    parents = c._parent_sections()
    times["parent sections"] = time.monotonic() - t0
    t0 = time.monotonic()
    payload = c._snapshot()
    snap_sec = time.monotonic() - t0
    if not (np.array_equal(payload["visited"], visited)
            and np.array_equal(payload["parent_child"], parents[0])
            and np.array_equal(payload["pending_fps"], blocks[0][1])):
        raise AssertionError("the snapshot's parts differ from its whole")
    path = os.path.join(workdir, f"2pc{rm}.npz")
    t0 = time.monotonic()
    ckpt_mod.write_atomic(path, payload)
    write_sec = time.monotonic() - t0
    nbytes = os.path.getsize(path)
    raw = sum(np.asarray(v).nbytes for v in payload.values())
    unique, states = c.unique_state_count(), c.state_count()
    _log(f"2pc {rm} stopped at unique={unique} states={states} in "
         f"{stop_sec:.3f} s; snapshot {snap_sec:.3f} s ("
         + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
         + f"): {len(visited)} visited, {len(blocks[0][1])} queued, "
         f"{len(parents[0])} parents, {raw} B raw; write_atomic "
         f"{write_sec:.3f} s, {nbytes} B on disk")
    del payload, blocks, parents, c
    gc.collect()

    for fn in kernels.values():
        fn.launches = 0
    t0 = time.monotonic()
    r = TwoPhaseSys(rm).checker().spawn_cuda_bfs(resume_from=path,
                                                 **spawn).join()
    torch.cuda.synchronize()
    resume_sec = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    _resume_exact(r, want, ["abort agreement", "commit agreement"],
                  f"2pc {rm} resumed")
    seed_chunks = r._chunks(len(visited))
    rows = r._scratch_shape()[0]
    chunks = sum(fused._pow2(-(-(r._capacity >> i) // rows))
                 for i in range(1, r.rehashes + 1))
    launched = r._K * r.dispatches
    expect = {"dedup_and_insert": seed_chunks + chunks,
              "wave_megakernel": launched, "sender_megakernel": 0,
              "append_rows": launched}
    expect = {k: v for k, v in expect.items() if k in kernels}
    if launches != expect:
        raise AssertionError(f"2pc {rm} resumed: kernel launches {launches}, "
                             f"expected {expect}")
    # The file's load alone, as the resume ran it (the finished checker's
    # counts are not read after this).
    t0 = time.monotonic()
    r._load_checkpoint(path)
    load_sec = time.monotonic() - t0
    _log(f"2pc {rm} resumed on the wave kernel: unique={want[0]} "
         f"states={want[1]} in {resume_sec:.3f} s (load, seed and run; the "
         f"load alone {load_sec:.3f} s), {r.dispatches} dispatches, "
         f"{r.rehashes} rehashes; kernel launches {launches} "
         f"({seed_chunks} the seed's chunks)")
    # The resumed table's capacity: the rule from the default's 2^16.
    cap = 1 << 16
    while cap < 4 * len(visited) + 2 * batch * r._F:
        cap *= 2
    seed = _seed_case(torch, table_mod, engine, r, visited, cap)
    return dict(seed, launches=seed_chunks, stop_sec=stop_sec,
                snap_sec=snap_sec, parts_sec=times, write_sec=write_sec,
                file_bytes=nbytes, raw_bytes=raw, resume_sec=resume_sec,
                load_sec=load_sec, unique=unique, states=states)


def phase_checkpoint(torch, kernels, fused, table_mod, engine, ckpt_mod,
                     TwoPhaseSys, PaxosSys):
    """The three checkpoint phases in a directory of their own beside
    this script, removed after them."""
    import shutil

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "_ckpt_tmp")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        t0 = time.monotonic()
        phase_checkpoint_small(ckpt_mod, TwoPhaseSys, PaxosSys, workdir)
        t1 = time.monotonic()
        paxos = phase_checkpoint_paxos(ckpt_mod, PaxosSys, workdir)
        t2 = time.monotonic()
        twopc = phase_checkpoint_2pc(torch, kernels, fused, table_mod, engine,
                                     ckpt_mod, TwoPhaseSys, workdir)
        t3 = time.monotonic()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    _log(f"checkpoint phases: small gates {t1 - t0:.1f} s, paxos 3 "
         f"{t2 - t1:.1f} s, 2pc 10 {t3 - t2:.1f} s")
    return dict(twopc, paxos=paxos, sec=(t1 - t0, t2 - t1, t3 - t2))



# -- The classic engine ------------------------------------------------------


def _classic_same(a, b, tag: str,
                  fields=("bucket", "rows", "out_rows", "novel", "overflow")
                  ) -> None:
    """Two classic runs equal in counts, discovery chains, parent maps and
    every wave's ``fields``."""
    got = (a.unique_state_count(), a.state_count(), _chains(a))
    want = (b.unique_state_count(), b.state_count(), _chains(b))
    if got != want:
        raise AssertionError(f"{tag}: {got[:2]} / {sorted(got[2])} differ "
                             f"from {want[:2]} / {sorted(want[2])}")
    if a._parent_map() != b._parent_map():
        raise AssertionError(f"{tag}: the parent maps differ")
    waves = [[tuple(e[f] for f in fields) for e in c.dispatch_log]
             for c in (a, b)]
    if waves[0] != waves[1]:
        raise AssertionError(f"{tag}: the waves' {fields} differ")


def phase_classic_small(torch, ckpt_mod, TwoPhaseSys, PaxosSys, workdir,
                        device="cuda:0"):
    """The classic engine (``fused=False``) on ``device`` against the
    same run on the CPU: 2pc 3, 5 and 5 with symmetry and paxos 1 and 2 on
    both successor paths; 2pc 3 with a visitor (every state recorded, the
    classic engine spawned, ``fused=True`` refused) and with a property
    the host evaluates; 2pc 4 with every wave at an output rung of 8 rows
    (regathers) against the ladder off, on both paths; the pipeline on
    against off; a checkpoint of 2pc 5 equal to the CPU's section by
    section, resumed on the fused and on the classic engine."""
    from stateright_tpu_torch import Property
    from stateright_tpu_torch.classic import CudaBfsChecker
    from stateright_tpu_torch.fused import FusedUnsupported
    from stateright_tpu_torch.models.twopc import RmState
    from stateright_tpu_torch.visitor import StateRecorder

    def run(model, dev, **kw):
        # The pipeline is on by default on the card and off on the CPU;
        # a wave launched ahead picks its output rung from a history one
        # wave older, so the CPU run is pipelined too.
        kw.setdefault("pipeline", True)
        c = model.spawn_cuda_bfs(device=dev, fused=False, **kw).join()
        if not isinstance(c, CudaBfsChecker):
            raise AssertionError(f"{type(c).__name__} is not the classic "
                                 "engine")
        return c

    def against_cpu(tag, model, want, **kw):
        cpu = run(model(), "cpu", **kw)
        for wave_kernel in (False, True):
            c = run(model(), device, wave_kernel=wave_kernel, **kw)
            t = f"{tag} classic {c.kernel_path()}"
            if want and (c.unique_state_count(), c.state_count()) != want:
                raise AssertionError(f"{t}: {c.unique_state_count()}, "
                                     f"{c.state_count()} != {want}")
            _classic_same(c, cpu, t)
            s = c.scheduler_stats()
            _log(f"{t}: unique={c.unique_state_count()} states="
                 f"{c.state_count()}, {c.waves} waves, rungs "
                 f"{s['succ_ladder']['out_rows_dispatches']}, "
                 f"max_inflight {s['max_inflight']}, graphs {s['graphs']}; "
                 "chains, parent map and waves equal to the CPU run's")

    for n, sym, want in ((3, False, (288, 1146)), (5, False, (8832, 58146)),
                         (5, True, (314, 2048))):
        def model(n=n, sym=sym):
            b = TwoPhaseSys(n).checker()
            return b.symmetry() if sym else b
        against_cpu(f"2pc {n}{' sym' if sym else ''}", model, want,
                    batch_size=64)
    against_cpu("paxos 1", lambda: PaxosSys(1).checker(), (265, 482),
                batch_size=64)
    against_cpu("paxos 2", lambda: PaxosSys(2).checker(), (16_668, 32_971),
                batch_size=1024)

    rec, states = StateRecorder.new_with_accessor()
    c = (TwoPhaseSys(3).checker().visitor(rec)
         .spawn_cuda_bfs(device=device, batch_size=64).join())
    if not isinstance(c, CudaBfsChecker) or len(states()) != 288:
        raise AssertionError(f"2pc 3 with a visitor: {type(c).__name__}, "
                             f"{len(states())} states recorded")
    try:
        TwoPhaseSys(3).checker().visitor(rec).spawn_cuda_bfs(
            device=device, fused=True)
    except FusedUnsupported as e:
        _log(f"2pc 3 with a visitor: the classic engine, {len(states())} "
             f"states recorded; fused=True raises FusedUnsupported: {e}")
    else:
        raise AssertionError("fused=True with a visitor did not raise")

    class Hybrid(TwoPhaseSys):
        def properties(self):
            return super().properties() + [Property.sometimes(
                "host-only abort", lambda _, s: all(
                    r is RmState.ABORTED for r in s.rm_state))]

    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cards = [Hybrid(3).checker().spawn_cuda_bfs(
            device=dev, batch_size=64, **kw).join()
            for dev, kw in ((device, {}), ("cpu", dict(pipeline=True)))]
    if not any("host-only abort" in str(w.message) for w in caught):
        raise AssertionError("the host property raised no warning")
    if "host-only abort" not in _chains(cards[0]):
        raise AssertionError("the host property was not found")
    _classic_same(*cards, "2pc 3 with a host property")
    _log("2pc 3 with a host-only property: warned, the classic engine, "
         "found, the chain equal to the CPU run's")

    forced_8 = CudaBfsChecker._pick_out_rows
    off = run(TwoPhaseSys(4).checker(), device, batch_size=64,
              succ_ladder=False)
    CudaBfsChecker._pick_out_rows = lambda self, B: (
        8 if self._succ_ladder_on else B * self._F)
    try:
        for wave_kernel in (False, True):
            c = run(TwoPhaseSys(4).checker(), device, batch_size=64,
                    wave_kernel=wave_kernel)
            regathers = c.scheduler_stats()["succ_ladder"][
                "overflow_redispatches"]
            if not regathers or c._parent_map() != off._parent_map() or (
                    c.unique_state_count(), c.state_count()) != (1568, 8258):
                raise AssertionError(f"2pc 4 at rung 8 ({c.kernel_path()}): "
                                     f"{regathers} regathers")
            _log(f"2pc 4 with every wave at a rung of 8 rows "
                 f"({c.kernel_path()}): {regathers} regathers of "
                 f"{c.waves} waves, counts and parent map equal to the "
                 "ladder-off run's")
    finally:
        CudaBfsChecker._pick_out_rows = forced_8

    on, off = (run(TwoPhaseSys(5).checker(), device, batch_size=64,
                   max_batch_size=256, pipeline=p) for p in (True, False))
    depth = [c.scheduler_stats()["max_inflight"] for c in (on, off)]
    if depth != [1, 0]:
        raise AssertionError(f"pipeline on/off reached depths {depth}")
    # A wave launched ahead picks its output rung before the last wave's
    # count is in the history, so only the rungs may differ.
    _classic_same(on, off, "2pc 5 pipeline on against off",
                  fields=("bucket", "rows", "novel"))
    _log(f"2pc 5 on a ladder of 64 to 256 rows, pipeline on against off: "
         f"equal counts, chains, parent maps and waves, max_inflight "
         f"{depth}")

    paths = [os.path.join(workdir, f"classic-2pc5-{w}.npz")
             for w in ("card", "cpu")]
    for path, dev in zip(paths, (device, "cpu")):
        c = run(TwoPhaseSys(5).checker().target_state_count(20_000), dev,
                batch_size=64, checkpoint_path=path,
                checkpoint_every_waves=1)
        if c.checkpoints < 3:
            raise AssertionError(f"classic 2pc 5: {c.checkpoints} "
                                 "checkpoints")
    _same_files(ckpt_mod, *paths, "classic 2pc 5")
    full = run(TwoPhaseSys(5).checker(), "cpu", batch_size=64)
    for engine in ("fused", "classic"):
        r = TwoPhaseSys(5).checker().spawn_cuda_bfs(
            device=device, batch_size=64, resume_from=paths[0],
            fused=engine == "fused").join()
        if ((r.unique_state_count(), r.state_count()) != (8832, 58146)
                or _chains(r) != _chains(full)):
            raise AssertionError(f"classic 2pc 5's file resumed on the "
                                 f"{engine} engine: {r.unique_state_count()}"
                                 f", {r.state_count()}")
    _log(f"classic 2pc 5 stopped at {c.state_count()} states: both "
         "generations equal the CPU run's section by section; resumed on "
         "the card's fused and classic engines to 8,832 / 58,146 with the "
         "full run's chains")


class _ClassicPoint:
    """A point of a mid-run classic checker to time waves from: the next
    wave's batch, the queue and a copy of the table. ``wave`` launches
    one wave from the point through the checker's own launch, waits for
    its outputs on its slot's event and puts the queue and the table
    back, never processing them; the first two launches (a warm-up and a
    capture) run in ``__init__``, so every later one is a replay."""

    def __init__(self, torch, mid):
        self.torch, self.mid = torch, mid
        if mid._needs_growth():
            mid._grow_table()
        self.bucket = mid._buckets[-1]
        queued = sum(len(b[1]) for b in mid._pending)
        if queued < self.bucket:
            raise AssertionError(f"the point's queue holds {queued} rows")
        self._queue = list(mid._pending)
        self._table = mid._table.clone()
        for _ in range(2):
            self.wave()

    def replays(self) -> bool:
        mid = self.mid
        key = (self.bucket, mid._capacity, mid._pick_out_rows(self.bucket))
        return mid._graphs is not None and mid._graphs.has_graph(key)

    def launch(self):
        return self.mid._dispatch_wave(self.bucket, 0)

    def wait(self, wave):
        out = self.mid._fetch(wave)
        self.rewind()
        return int(out[1][2])

    def wave(self):
        return self.wait(self.launch())

    def rewind(self) -> None:
        mid = self.mid
        mid._pending.clear()
        mid._pending.extend(self._queue)
        mid._table.copy_(self._table)
        self.torch.cuda.synchronize()


def phase_classic_full(torch, kernels, config, model, want_counts,
                       want_found, mid_target, **spawn):
    """``model()`` to its end on the classic engine
    (``spawn_cuda_bfs(fused=False, **spawn)``), the kernels' launch counts
    set to 0 just before and read just after: exactly ``want_counts``,
    the discoveries ``want_found`` and no counterexample, the launches
    exact (the dedup kernel once a wave on the torch stages, the wave
    kernel once a wave on the kernel, and the dedup kernel once a chunk
    of every rehash); the run's pace, host time a wave, readback, rungs
    and memory. Then waves of a checker stopped at ``mid_target`` states
    from one point: one replay under ``set_sync_debug_mode("error")``, a
    few timed, one under ``torch.profiler``."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.monotonic()
    c = model().checker().spawn_cuda_bfs(fused=False, **spawn).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    unique, states = c.unique_state_count(), c.state_count()
    s = c.scheduler_stats()
    g = s["graphs"] or {"captures": 0, "replays": 0, "capture_sec": 0.0}
    ladder = s["succ_ladder"]
    waves = c.waves
    down = [e["bytes_down"] for e in c.dispatch_log]
    host = {k: v * 1e6 / waves for k, v in c.host_sec.items()}
    log_bytes = c.parent_log_bytes()
    wave_kernel = spawn.get("wave_kernel", False)
    run = dict(sec=sec, waves=waves, captures=g["captures"],
               replays=g["replays"], capture_sec=g["capture_sec"],
               rungs=ladder["out_rows_dispatches"],
               regathers=ladder["overflow_redispatches"],
               host_us=host, bytes_down=sum(down) / waves,
               bytes_down_max=max(down), peak=peak, log_bytes=log_bytes,
               rehashes=c.rehashes, chunks=c.rehash_chunks,
               max_inflight=s["max_inflight"])
    _log(f"{config} classic ({c.kernel_path()}): unique={unique} states="
         f"{states} sec={sec:.3f} states/s={states / sec:.1f} waves={waves} "
         f"rehashes={c.rehashes} ({c.rehash_chunks} chunks) "
         f"launches={launches} captures={g['captures']} replays="
         f"{g['replays']} capture_sec={g['capture_sec']:.3f} max_inflight="
         f"{s['max_inflight']} rungs={ladder['out_rows_dispatches']} "
         f"regathers={ladder['overflow_redispatches']}; host us a wave: "
         f"launch {host['launch']:.1f}, processing {host['process']:.1f}, "
         f"waiting {host['wait']:.1f}; bytes down a wave "
         f"{run['bytes_down']:.0f} (most {max(down)}); peak device memory "
         f"{peak} B; host parent log {log_bytes} B")
    if (unique, states) != want_counts:
        raise AssertionError(f"{config} classic: {(unique, states)} != "
                             f"{want_counts}")
    if sorted(c.discoveries()) != want_found:
        raise AssertionError(f"{config} classic discoveries: "
                             f"{sorted(c.discoveries())}")
    c.assert_properties()
    want = {"dedup_and_insert": c.rehash_chunks + (0 if wave_kernel
                                                   else waves),
            "wave_megakernel": waves if wave_kernel else 0,
            "sender_megakernel": 0, "append_rows": 0}
    if launches != want:
        raise AssertionError(f"{config} classic: kernel launches "
                             f"{launches}, expected {want}")
    if not g["replays"]:
        raise AssertionError(f"{config} classic: no wave was a replay")
    del c

    mid = (model().checker().target_state_count(mid_target)
           .spawn_cuda_bfs(fused=False, **spawn).join())
    point = _ClassicPoint(torch, mid)
    if not point.replays():
        raise AssertionError("no wave graph after two waves")
    torch.cuda.set_sync_debug_mode("error")
    try:
        wave = point.launch()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    new = point.wait(wave)
    _log(f"one replayed classic wave of {point.bucket} rows under "
         f"set_sync_debug_mode('error'): no synchronisation, {new} new rows")
    steady = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave = point.launch()
        t1 = time.perf_counter()
        point.wait(wave)
        steady.append(((t1 - t0) * 1e6, (time.perf_counter() - t0) * 1e3))
    kern, _ = _profiled(torch, lambda _: point.wave(), point.rewind)
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    nodes = sum(e.count for e in kern)
    pace = sec * 1e3 / waves
    run.update(busy_ms=busy, nodes=nodes, pace_ms=pace,
               wave_ms=sum(w for _, w in steady) / len(steady),
               launch_us=sum(u for u, _ in steady) / len(steady))
    _log(f"{config} classic steady wave from a point at {mid_target} "
         f"states: launch {run['launch_us']:.1f} us, launch to outputs on "
         f"the host {run['wave_ms']:.3f} ms; card busy {busy:.3f} ms a "
         f"wave ({nodes} kernels and memsets, torch.profiler); the full "
         f"run's pace {pace:.3f} ms a wave, so the card idles "
         f"{1 - busy / pace:.1%} of it")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        _log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
             f"{e.key[:90]}")
    return launches, run


def phase_classic(torch, kernels, ckpt_mod, TwoPhaseSys, PaxosSys, fused_runs):
    """Phase 8: the classic engine's small gates against the CPU, in a
    directory of their own beside this script (removed after), then its
    full runs: ``paxos check 3`` and 2pc at 10 RMs with ``fused=False`` on
    both successor paths, none cut, batch 16,384, graphs on; each beside
    the fused engine's run of the same configuration (``fused_runs``,
    phase 6)."""
    import shutil

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "_ckpt_tmp")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.monotonic()
    try:
        phase_classic_small(torch, ckpt_mod, TwoPhaseSys, PaxosSys, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    t1 = time.monotonic()
    twopc = ("2pc 10", functools.partial(TwoPhaseSys, 10),
             (FULL_UNIQUE, FULL_STATES),
             ["abort agreement", "commit agreement"], 20_000_000)
    paxos = ("paxos 3", functools.partial(PaxosSys, 3),
             (PAXOS_UNIQUE, PAXOS_STATES), ["value chosen"], PAXOS_MID)
    out = {}
    for cfg, wave_kernel, fused_tag in (
            (paxos, False, "paxos 3"), (paxos, True, "paxos 3, wave kernel"),
            (twopc, False, "2pc 10"), (twopc, True, "2pc 10, wave kernel")):
        tag = f"{cfg[0]}{', wave kernel' if wave_kernel else ''}"
        launches, run = phase_classic_full(torch, kernels, *cfg,
                                           batch_size=BATCH,
                                           wave_kernel=wave_kernel)
        out[tag] = dict(launches=launches, run=run)
        f = fused_runs[fused_tag]["run"]
        _log(f"{tag}: classic {run['sec']:.3f} s ({run['waves']} waves) "
             f"against fused {f['sec']:.3f} s ({f['dispatches']} "
             f"dispatches); peak {run['peak']} B against {f['peak']} B")
    _log(f"classic phase: small gates {t1 - t0:.1f} s, full runs "
         f"{time.monotonic() - t1:.1f} s")
    return out


def _modules():
    """The port's modules, from the checkout beside this script."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stateright_tpu_torch import _build, engine, fused
    from stateright_tpu_torch import append as append_mod
    from stateright_tpu_torch import checkpoint_format as ckpt_mod
    from stateright_tpu_torch import table as table_mod
    from stateright_tpu_torch import wave as wave_mod
    from stateright_tpu_torch.models.paxos import PaxosDevice, PaxosSys
    from stateright_tpu_torch.models.twopc import TwoPhaseDevice, TwoPhaseSys
    return (_build, engine, fused, table_mod, wave_mod, append_mod,
            ckpt_mod, TwoPhaseDevice, TwoPhaseSys, PaxosDevice, PaxosSys)


def _log_ptxas(log: str) -> None:
    """ptxas' report (``-Xptxas -v``), a line a kernel: its registers,
    shared memory, stack frame and spills."""
    kernel, frame = None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            fn = re.search(r"\d(tile_front|send_rows|resolve_rows|claim_rows"
                           r"|append_rows)", mangled)
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


def phase_build(_build, table_mod, wave_mod, append_mod) -> None:
    def build(name, load):
        t0 = time.monotonic()
        load()
        return name, time.monotonic() - t0

    # One nvcc a source, all started together.
    jobs = [("table", table_mod._lib),
            ("wave_twopc", lambda: (wave_mod._entry("twopc", 1),
                                    wave_mod._sender_entry("twopc", 1))),
            ("wave_paxos", lambda: (wave_mod._entry("paxos", 2),
                                    wave_mod._sender_entry("paxos", 2))),
            ("append", append_mod._lib)]
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
    (_build, engine, fused, table_mod, wave_mod, append_mod, ckpt_mod,
     TwoPhaseDevice, TwoPhaseSys, PaxosDevice, PaxosSys) = _modules()
    t_start = time.monotonic()
    phase_build(_build, table_mod, wave_mod, append_mod)
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
    ap = phase_append(torch, engine, wave_mod, table_mod, append_mod, rows,
                      wave_case[1], paxos_mid)
    del wave_case
    sk = phase_sender_kernel(torch, wave_mod, table_mod, *rows)
    del rows
    pw, psk = phase_paxos_kernels(torch, wave_mod, table_mod, paxos_mid)
    del paxos_mid
    phase_small(TwoPhaseSys)
    phase_sharded_small(torch, fused, TwoPhaseSys)
    phase_paxos_small(PaxosSys, PaxosDevice)
    phase_refusals(TwoPhaseSys, TwoPhaseDevice)
    phase_gates(torch, TwoPhaseSys, PaxosSys)
    kernels = {fn.__name__: fn for fn in fused.KERNELS}
    # Each path's run reads its own kernels' launches: 2pc at 10 RMs on
    # the three paths, then paxos check 3 on the same three paths,
    # unsharded and sharded, the torch stages beside the kernels; all on
    # the defaults, and the kernel paths again with graphs off, next to
    # their run on the defaults.
    twopc = ("2pc 10", functools.partial(TwoPhaseSys, 10),
             (FULL_UNIQUE, FULL_STATES),
             ["abort agreement", "commit agreement"], 20_000_000, 4)
    paxos = ("paxos 3", functools.partial(PaxosSys, 3),
             (PAXOS_UNIQUE, PAXOS_STATES), ["value chosen"], PAXOS_MID, 2)
    off = dict(cuda_graph=False)
    sharded = dict(batch_size=BATCH // SHARDS, mesh=["cuda:0"] * SHARDS)
    full = {}
    for tag, cfg, spawn in (
            ("2pc 10", twopc, dict(batch_size=BATCH)),
            ("2pc 10, wave kernel", twopc, dict(batch_size=BATCH,
                                                wave_kernel=True)),
            ("2pc 10, wave kernel, off", twopc, dict(
                batch_size=BATCH, wave_kernel=True, **off)),
            *((f"2pc 10, wave kernel, depth {d} ({turn})", twopc[:5] + (0,),
               dict(batch_size=BATCH, wave_kernel=True,
                    inflight_dispatches=d))
              for turn in ("a", "b") for d in (1, 2)),
            ("2pc 10, sharded, sender kernel", twopc, dict(
                sharded, wave_kernel=True)),
            ("paxos 3", paxos, dict(batch_size=BATCH)),
            ("paxos 3, sharded", paxos, sharded),
            ("paxos 3, wave kernel", paxos, dict(batch_size=BATCH,
                                                 wave_kernel=True)),
            ("paxos 3, wave kernel, off", paxos, dict(
                batch_size=BATCH, wave_kernel=True, **off)),
            ("paxos 3, sharded, sender kernel", paxos, dict(
                sharded, wave_kernel=True)),
            ("paxos 3, sharded, sender kernel, off", paxos, dict(
                sharded, wave_kernel=True, **off)),
            ("paxos 3, ladder", paxos[:5] + (0,), dict(
                batch_size=1024, max_batch_size=BATCH, wave_kernel=True))):
        full[tag] = dict(zip(("launches", "run"), phase_full(
            torch, kernels, fused, *cfg, **spawn)))
    for tag, r in full.items():
        run = r["run"]
        line = (f"{tag}: {run['sec']:.3f} s, {run['dispatches']} dispatches "
                f"({run['captures']} captures in {run['capture_sec']:.3f} s, "
                f"{run['replays']} replays, max_inflight "
                f"{run['max_inflight']}, buckets {run['buckets']}), peak "
                f"device memory {run['peak']} B, {run['rehashes']} rehashes "
                f"in {run['chunks']} chunks a slice, kernel launches "
                f"{r['launches']}")
        if "wave_ms" in run:
            line += (f"; {run['host_us']:.1f} us of host time a dispatch, "
                     f"{run['launches_pw']:.1f} launches a launched wave, "
                     f"{run['busy_ms']:.3f} ms card time a launched wave of "
                     f"{run['wave_ms']:.3f}, idle "
                     f"{1 - run['busy_ms'] / run['wave_ms']:.1%}")
        _log(line)
    depth_sec = {d: [full[f"2pc 10, wave kernel, depth {d} ({turn})"]
                     ["run"]["sec"] for turn in ("a", "b")] for d in (1, 2)}
    _log(f"2pc 10 on the wave kernel, graphs on, the in-flight depth alone: "
         f"depth 1 {depth_sec[1]} s, depth 2 {depth_sec[2]} s (turns a, b)")
    buckets = full["paxos 3, ladder"]["run"]["buckets"]
    if len(buckets) < 2:
        raise AssertionError(f"paxos 3 on a ladder used one bucket: "
                             f"{buckets}")
    # Checkpoints and resume: the small gates against the CPU, paxos 3
    # and 2pc 10 at full width, the resumed table's build.
    ck = phase_checkpoint(torch, kernels, fused, table_mod, engine, ckpt_mod,
                          TwoPhaseSys, PaxosSys)
    # The classic engine: its small gates against the CPU, then paxos 3
    # and 2pc 10 on both successor paths beside the fused runs above.
    cl = phase_classic(torch, kernels, ckpt_mod, TwoPhaseSys, PaxosSys, full)

    # Kernel 1 on the synthetic stream, on the default path's input of
    # each model (a mid-run wave's dedup fingerprints), and at the
    # rehash; kernels 2 and 3 on each model's mid-run rows; the append
    # kernel on the mid-run waves' outputs.
    src = "stateright_tpu_torch/csrc/"
    pallas = "stateright_tpu/tpu/pallas_table.py:"
    k_err = max(v["max_abs_err"] for v in k.values())
    w_err = max(v["max_abs_err"] for v in (*w.values(), *pw.values()))
    s_err = max(v["max_abs_err"] for v in (*sk.values(), *psk.values()))
    a_err = max(v["max_abs_err"] for v in ap.values())

    def launched(tag, name):
        return full[tag]["launches"][name]

    launches = launched("2pc 10", "dedup_and_insert")
    print(json.dumps({"kernels": [
        _kernel_row("dedup_and_insert", src + "table.cu", pallas + "256",
                    launches, k_err, k["stream"]),
        _kernel_row("dedup_and_insert[mid-run wave]", src + "table.cu",
                    pallas + "256", launches, k_err, k["wave"]),
        _kernel_row("dedup_and_insert[paxos 3 wave]", src + "table.cu",
                    pallas + "256", launched("paxos 3", "dedup_and_insert"),
                    k_err, k["paxos"]),
        _kernel_row("dedup_and_insert[rehash]", src + "table.cu",
                    pallas + "256", launches, k_err, k["rehash"]),
        _kernel_row("dedup_and_insert[resume seed]", src + "table.cu",
                    pallas + "256", ck["launches"], ck["max_abs_err"], ck),
        _kernel_row("dedup_and_insert[classic 2pc 10]", src + "table.cu",
                    pallas + "256",
                    cl["2pc 10"]["launches"]["dedup_and_insert"], k_err,
                    k["wave"]),
        _kernel_row("dedup_and_insert[classic paxos 3]", src + "table.cu",
                    pallas + "256",
                    cl["paxos 3"]["launches"]["dedup_and_insert"], k_err,
                    k["paxos"]),
        _kernel_row("wave_megakernel", src + "wave_twopc.cu", pallas + "380",
                    launched("2pc 10, wave kernel", "wave_megakernel"),
                    w_err, w["plain"]),
        _kernel_row("sender_megakernel", src + "wave_twopc.cu",
                    pallas + "451", launched("2pc 10, sharded, sender kernel",
                                             "sender_megakernel"), s_err,
                    sk[(False, True)]),
        _kernel_row("wave_megakernel[paxos 3]", src + "wave_paxos.cu",
                    pallas + "380",
                    launched("paxos 3, wave kernel", "wave_megakernel"),
                    w_err, pw["plain"]),
        _kernel_row("wave_megakernel[classic 2pc 10]",
                    src + "wave_twopc.cu", pallas + "380",
                    cl["2pc 10, wave kernel"]["launches"]["wave_megakernel"],
                    w_err, w["plain"]),
        _kernel_row("wave_megakernel[classic paxos 3]",
                    src + "wave_paxos.cu", pallas + "380",
                    cl["paxos 3, wave kernel"]["launches"]["wave_megakernel"],
                    w_err, pw["plain"]),
        _kernel_row("sender_megakernel[paxos 3]", src + "wave_paxos.cu",
                    pallas + "451",
                    launched("paxos 3, sharded, sender kernel",
                             "sender_megakernel"), s_err, psk[(False, True)]),
        _kernel_row("append_rows", src + "append.cu",
                    "stateright_tpu/tpu/fused.py:311",
                    launched("2pc 10, wave kernel", "append_rows"), a_err,
                    ap["2pc"]),
        _kernel_row("append_rows[paxos 3 wave]", src + "append.cu",
                    "stateright_tpu/tpu/fused.py:311",
                    launched("paxos 3, wave kernel", "append_rows"), a_err,
                    ap["paxos"]),
        _kernel_row("append_rows[sharded]", src + "append.cu",
                    "stateright_tpu/tpu/sharded_fused.py:322",
                    launched("2pc 10, sharded, sender kernel",
                             "append_rows"), a_err, ap["sharded"])]}))
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
