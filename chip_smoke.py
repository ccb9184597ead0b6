#!/usr/bin/env python3
"""Builds the port's kernels and drives the port on one CUDA card.

Usage, from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --rehash   # phase 1, then the rehash case of 3
    python3 chip_smoke.py --phases registers       # phase 1, then 9
    python3 chip_smoke.py --phases corpus          # phase 1, then 10
    python3 chip_smoke.py --phases actors          # phase 1, then 11
    python3 chip_smoke.py --phases sharded_classic # phase 1, then 12
    python3 chip_smoke.py --phases matmul          # phase 1, then 13
    python3 chip_smoke.py --phases sizes           # phase 1, then 14
    python3 chip_smoke.py --phases fallback        # phase 1, 15 and 16
    python3 chip_smoke.py --phases tiered          # phase 1, then 17
    python3 chip_smoke.py --phases obs             # phase 1, then 18
    python3 chip_smoke.py --phases kernels,full    # phase 1, 2-4 and 6

``--phases`` takes a comma-separated subset of ``kernels`` (phases 2 to
4), ``small`` (5), ``full`` (6), ``checkpoint`` (7), ``classic`` (8),
``registers`` (9), ``corpus`` (10), ``actors`` (11), ``sharded_classic``
(12), ``matmul`` (13), ``sizes`` (14), ``fallback`` (15 and 16),
``tiered`` (17) and ``obs`` (18), runs phase 1 and those, in this order,
and
prints the kernels line's rows those phases give
(phases 2 to 8's rows only when all of them ran). The CPU reference runs
that phases 5, 8, 9, 10 and 11 hold the card's runs to are made ahead in two
worker processes of the process that runs those phases (``_CpuRefs``:
after the build, or while a phase's process waits for its turn). Phases,
in order; any failure exits non-zero and prints no result line:

1. build ``stateright_tpu_torch/csrc/table.cu``, ``wave_twopc.cu``,
   ``wave_paxos.cu``, ``sender_paxos.cu``, ``wave_paxos4.cu``,
   ``sender_paxos4.cu``, ``wave_single_copy.cu``,
   ``sender_single_copy.cu``, ``wave_abd.cu``, ``sender_abd.cu``,
   ``wave_linear_equation.cu``, ``wave_dgraph.cu``,
   ``wave_increment.cu``, ``wave_increment_lock.cu``,
   ``wave_sliding_puzzle.cu``, ``wave_pingpong.cu``, ``wave_vsr.cu``,
   ``sender_vsr.cu`` (the wave kernel's and the sender kernel's entry
   points for 2pc, each register workload, each plain model and each
   actor model; paxos's, single-copy's, ABD's and VSR's senders in sources
   of their own, and paxos's fourth client count in two more; 2pc's and
   the shared counters' sources also hold the plan forms of both kernels)
   and ``append.cu`` for ``sm_90a``, one ``nvcc`` each, all at once, and
   print each build time
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
   16,668 / 32,971; paxos at 4 clients with symmetry to 5,000 states and
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
   the wave kernel with graphs on at two dispatches in flight, beside its
   run on the defaults (one; the in-flight depth's own effect); and
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
9. the register corpus (``phase_registers``; in a process of its own
   when earlier phases ran, since the profiler then dropped the device
   time of about half of its profiles): kernels 2 and 3 on
   single-copy 4 (its CUDA step and its representative over the 23
   non-identity client permutations) on the next 16,384 rows of a mid-run
   arena, against its engine's table and scratch, plain and with
   symmetry, then as 4 shards of 4,096 and ragged; on ABD 2/2's whole
   space (544 rows) with seeded adversarial rows, one batch of 1,024,
   then as 4 shards of 256 and ragged; all outputs, counts and tables
   equal, the scratch clean, each timed. Then single-copy 3 and 4 on one
   server (4,243 / 6,778 and 400,233 / 731,789), each plain and with
   symmetry (712 / 1,144 and 16,726 / 30,657, JAX's counts on the CPU),
   single-copy 2 on two servers (its "linearizable" counterexample) and
   ABD 2/2 (544 / 875) to their ends on the fused, the classic and the
   sharded engine (4 shards), each on the torch stages and on the
   kernels: the counts exact, the discoveries' chains equal to the same
   engine's run on the CPU (the fused engine's for the classic one;
   single-copy 4's, which makes no CPU run, to the card's fused torch
   stages', the sharded engine's to its own torch stages'), every
   kernel's launches exact, each run's
   seconds and peak device memory; then one replayed dispatch of
   single-copy 4 on the wave kernel under
   ``torch.cuda.set_sync_debug_mode("error")``;
10. the corpus's plain models (``phase_corpus``; in a process of its
    own when earlier phases ran, as phase 9): kernels 2 and 3 on each
    model's CUDA step against their plain versions at 16,384 rows, as 4
    shards of 4,096 and ragged, the scratch clean (the 4x3 puzzle,
    increment 16 and increment_lock 8 plain and with symmetry,
    LinearEquation, a random graph); then LinearEquation (2, 4, 7) and (2,
    10, 14), increment and increment_lock at 2 threads and at their
    largest instances (16 and 8), each plain and with symmetry, the 3x3
    puzzle (181,440 / 483,841) and the differential fuzz's random graphs
    of seeds 0 to 4 on the fused, classic and sharded engines, each on the
    torch stages and on the kernels, exact and against a CPU run at the
    same batch (each engine's own where a run stops at a counterexample;
    none for a full enumeration with no discovery, held to its counts);
    then, none cut, the 4x3 puzzle (239,500,800
    boards / 678,585,601 states, the closed form's; the device memory
    reckoned first) and ``paxos check 4`` (2,372,188 / 4,807,983; 1,194,428
    with symmetry), plain and with symmetry and its liveness property
    (BASELINE.json's workload), each on the fused torch stages, the fused and
    classic wave kernel and the sharded torch stages and sender kernel:
    equal counts, discovery chains (replayed through ``path.py``) equal to
    the fused torch stages' (the sharded sender's to the sharded torch
    stages'), no counterexample, launches exact, seconds and peak device
    memory printed;
11. the actor models, ping-pong and viewstamped replication
    (``phase_actors``; in a process of its own when earlier phases ran, as
    phase 9): kernels 2 and 3 on each model's CUDA step (on
    ``csrc/models/actor_net.cuh``) against their plain versions at 16,384
    rows of a mid-run arena of each full-width configuration, as 4 shards
    of 4,096 and ragged, the scratch clean; then ping-pong's 14 (lossy,
    max_nat 1), 4,094 (lossy and duplicating, 5), 11 (a perfect network,
    5) and its history form at 3, and VSR at 2 replicas (63 / 169) on the
    fused, classic and sharded engines, each on the torch stages and on
    the kernels, against a CPU run at the same batch; then, none cut,
    ping-pong lossy and duplicating at max_nat 11 on 26 slots (its counts
    read against the pattern 16,777,214 / 188,743,681) and VSR at 4
    replicas, max_view 1, on 48 slots (685,650 / 7,579,993, 82 lanes), each
    on the fused torch stages, the fused and classic wave kernel and the
    sharded torch stages and sender kernel: equal counts and discovery
    chains (the sharded sender's to the sharded torch stages'), launches
    exact, seconds, states/s and peak device memory printed;
12. the classic sharded engine (``spawn_cuda_bfs(mesh=[cuda:0] * n,
    fused=False)``, ``sharded.py``; ``phase_sharded_classic``, in a
    process of its own when earlier phases ran, as phase 9): at 4 shards
    and at a ragged 3, each on the torch stages and on the sender kernel,
    against the same run on the CPU (counts, discovery chains, parent maps
    and every wave's log fields): 2pc 3 (288 / 1,146), 2pc 4 with a
    visitor (the builder's fallback, every state visited, a rehash from
    2^12 slots), 2pc 5 with symmetry (314 / 2,048), paxos 1 with a
    property the host evaluates (265 / 482) and 2pc 3 with one that is
    found; 2pc 4 with every wave at an output rung of 8 rows (regathers)
    against the ladder off; ``fused=True`` with a visitor and
    ``pipeline=True`` refused. Then, 4 shards of 4,096 rows, graphs on:
    ``paxos check 3`` (1,194,428 / 2,420,477, "value chosen" found) on the
    torch stages and on the sender kernel, exact, and 2pc at 10 RMs on
    both cut at 100,000,000 states (``SHARDED_CLASSIC_CUTS``; the whole
    space, 61,515,776 / 817,760,258, is phase 6's and 8's), the launches
    exact, the sender kernel's chains and counts the torch stages', each
    run's seconds,
    waves, host us a wave, bytes down and peak device memory; from a
    mid-run point of each on each path, one replayed wave under
    ``torch.cuda.set_sync_debug_mode("error")``, three timed and one
    profiled (the card's time a wave and its idle share), and on the
    sender kernel's, kernels 3 and 1 held to their plain versions and
    timed at this path's shapes (the next wave's 4 x 4,096 rows; shard
    0's 851,968 (2pc) or 294,912 (paxos) received rows against its table
    slice with the engine's scratch);
13. the matmul expand (``spawn_cuda_bfs(wave_matmul=True)``,
    ``matmul_wave.py``; ``phase_matmul``, in a process of its own when
    earlier phases ran, as phase 9), at the full widths its gate admits,
    2pc at 7 RMs and increment_lock at 8 threads: the gate's verdict on
    the card (the pinned reasons); kernels 2 and 3 in plan form
    (``csrc/plan.cuh``) on the next 16,384 rows of a mid-run arena,
    against its engine's table and scratch, held bit for bit to their
    plain versions (``matmul_expand``) and timed, plain and with
    symmetry, the sender as 4 shards of 4,096 with local dedup on and off
    and ragged, and held bit for bit to their step forms; then each
    configuration to its end (296,448 / 2,744,706 and 438,401 / 438,401)
    on the fused, classic, sharded and classic sharded engines, with the
    knob off on the kernels and on, on the torch stages and on the
    kernels: counts exact, discovery chains equal to the knob-off run's,
    ``kernel_path()``'s ``+matmul``, the ``wave_matmul`` stats and every
    dispatch's ``expand_impl``, the launches exact; 2pc 5 with symmetry
    (314) on every engine's kernels, on against off; and 2pc 7 on the
    torch stages under ``torch.set_float32_matmul_precision("high")`` and
    ``torch.backends.cuda.matmul.allow_tf32 = True``, exact;
14. kernels 2 and 3 at every model size the entry points hold
    (``phase_sizes``; in a process of its own when earlier phases ran, as
    phase 9): at both ends of each range and one size of each capacity
    class (``SIZES``: increment at 1, 3, 5 and 12 threads, increment_lock
    at 1, 3, 5, 6, 12 and 16, the puzzle on 2x2, 3x2, 2x4, 3x4 and 4x4,
    single-copy at 1/1, 3/2, 2/6, 1/7 and 4/4 clients / servers, ABD at
    1/1, 2/4, 3/3, 4/4 and 1/7, ping-pong at 32 and 64 network slots, VSR
    at 1/8, 2/32, 3/48 and 4/64 replicas / slots; the plan forms at
    increment 3 and increment_lock 3 and 5), a run of the size on the fused
    wave kernel and one on the sharded sender kernel (graphs off; their
    launches exact; the sharded one stops at ``SIZE_SHARDED_CUT`` states),
    then kernel 2 against its plain version on 16,384 rows of the
    fused run's arena (all of it and seeded adversarial rows where it holds
    fewer) against a table of its states, plain and with symmetry where
    the model has it, and kernel 3 as 4 shards of 4,096 with and without
    local dedup and ragged: every output and count equal, the scratch
    clean, each plain version timed on its one checking call, each kernel
    by replays of a CUDA graph of one call, beside its bound. Then the
    registry's defaults, increment and increment_lock at 3 threads, to
    their ends on the four engines on the torch stages, the kernels and
    the kernels in plan form, each kernel run equal to its engine's torch
    stages in counts and chains, and increment 3 configured by
    ``STpu_WAVE_KERNEL=1`` alone on the wave kernel; single-copy 3/2 and
    ABD 2/4 and 3/3 (cut, ``SIZE_CUTS``) on the four engines likewise;
    ping-pong at 32 slots and VSR 4 at 64 cut on the fused, classic and
    sharded engines at batch 2,048 (past a few full waves; the classic
    runs' log counts them), each on the torch stages and the kernels, the
    kernel runs equal to the torch stages'; VSR at 3 replicas and max_view
    3 on 48 slots to its end on the fused wave kernel at batch 4,096,
    exactly JAX's 1,344,659 / 5,456,850 at that batch with the "agreement"
    counterexample, and both fused paths cut at 1,000,000 states, the
    kernel's run equal to the torch stages'; and
    the 3x4 puzzle (with an always property its space keeps, so that the
    run goes on past "solved") to its end on the fused wave kernel,
    239,500,800 / 678,585,601 (the 4x3's, transposed);
15. the host BFS as ``spawn_cuda_bfs``'s fallback (``phase_fallback``; in
    a process of its own when earlier phases ran, as phase 9): paxos 2
    clients / 5 servers at a target of 1,000 states, single-copy 5 / 1 at
    2,000 and ABD 3 / 2 at 200 (``FALLBACKS``), configurations with no
    device form, through ``spawn_cuda_bfs()``: each warns that it falls
    back, returns the host ``BfsChecker`` and gives the counts and
    discoveries JAX's ``spawn_tpu_bfs()`` gives at the same target, with
    the host's states/s logged; the three refusals (``checkpoint_path``,
    ``resume_from``, ``fused=True`` raise ``DeviceFormUnavailable`` naming
    the knob); and what never falls back: 2pc 3 through
    ``spawn_cuda_bfs()`` is the fused engine on ``cuda:0`` on the dedup
    kernel (288 / 1,146), and increment at 17 threads with
    ``wave_kernel=True`` raises ``NotImplementedError`` (no instance),
    neither with a warning;
16. the host DFS and the host forms (``phase_host``, in phase 15's
    process, after it): the host DFS on 2pc 5 to 8,832 states and with
    ``symmetry()`` to 665; single-copy 2 / 1 on the host DFS with
    ``symmetry_fn(host_representative)`` and on the card's fused wave
    kernel with ``symmetry()`` (the device representative), both 47; and
    VSR 2 / 1 (169 / 63 and the three "sometimes" found), increment at 3
    threads (with a property never met, so that both run to their ends),
    increment_lock at 3 and the 2x3 puzzle (841 / 360) on the host BFS,
    each equal in counts and discoveries to the card's fused wave kernel
    (``spawn_cuda_bfs(wave_kernel=True)`` on ``cuda:0``, which must run
    ``megakernel``); each host run's states/s logged as the card
    machine's CPU's;
17. the tiered store (``phase_tiered``; in a process of its own when
    earlier phases ran, as phase 9), each capped run held exactly to the
    uncapped run of the same path (counts, discoveries and chains), its
    launches exact: (a) 2pc at 10 RMs to its end on the fused wave kernel
    under a 2 GiB device budget (``TIER_FUSED_BUDGET``), where the arena
    must roll its expanded prefix off the card (spans, rows and bytes
    rolled, pressure notes, peak device memory against the budget and the
    uncapped peak, seconds against the uncapped run's); (b) the classic
    engine, 2pc 10 on the wave kernel and ``paxos check 3`` on the torch
    stages, each to its end under a table budget of half its uncapped
    final table and a host budget of an eighth of its visited set, with a
    segment directory (``_tier_tmp/`` beside the script, removed after),
    so that partitions go warm and then cold: spills by tier, probes and
    hits, the resident ratio, the host's ms a wave beside the uncapped
    run's, the logical visited set (hot and cold) equal; (c) paxos 3's
    capped run stopped after its first cold spill, checkpointed (its v5
    ``store`` refs) and resumed on the card with a store and without one,
    each to the uncapped counts, chains and logical visited set; (d) the
    sharded fused engine on 2pc 6 at 4 shards of 8 rows with a 512-row
    arena a shard under 300,000 B (each shard's roll), and the classic
    sharded engine on ``paxos check 3`` (4 x 4,096, the sender kernel)
    under half its uncapped tables;
18. the run telemetry (``phase_obs``; in a process of its own when
    earlier phases ran, as phase 9) with ``STpu_TRACE``, ``STpu_PROF``
    (cadence 1), ``STpu_HIST``, ``STpu_SLO`` and ``STpu_ANOMALY`` set: 2pc
    10 on the fused wave kernel and ``paxos check 3`` on the classic wave
    kernel, each disarmed, armed, disarmed, armed, exact, the armed
    seconds beside the disarmed; each armed run's trace valid under the
    port's schema (``obs/schema.py``), its waves' new rows summing to
    the unique count, every program key with a ``profile_snapshot``
    whose declared cost is there and whose roofline share is at most
    1.05; the armed hooks' host us a dispatch (``_obs_hook_us``); a
    replay of each armed under ``set_sync_debug_mode("error")``, and the
    fused graph's launches a wave armed equal to disarmed; then
    ``measure_wave_breakdown`` of paxos 3 and 2pc 10 at batch 4,096 on
    the card (``profiling.py``), with kernel 1's ``dedup_insert`` and
    kernel 2's ``wave_kernel`` stages timed, the stages' shares and the
    ``host`` stage printed;
19. the kernels line, the script's running time, the card line and the
    result line.

It imports neither JAX nor ``stateright_tpu``.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import random
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from collections import deque
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
#: the CPU (its whole space is far larger; its CPU runs cost most of the
#: phase)
PAXOS4_TARGET = 5_000
BATCH = 16_384
SHARDS = 4
SRC = "stateright_tpu_torch/csrc/"
PALLAS = "stateright_tpu/tpu/pallas_table.py:"


def _log(msg: str) -> None:
    print(msg, flush=True)


def _clocked(label: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall time logged under ``label``."""
    t0 = time.monotonic()
    out = fn(*args, **kw)
    _log(f"{label}: {time.monotonic() - t0:.1f} s")
    return out


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
    # Bound: the kernel's declared cost (``table.dedup_cost``: the fps
    # read, the two masks written, a 32-byte sector a candidate), the
    # profiler's count too.
    nbytes = table_mod.dedup_cost(S, cand)["bytes"]
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
    # Bound: the kernel's declared cost (``append.append_cost``: a new
    # row's index, source row and arena row, a distinct parent's 12 B
    # once), the profiler's count too.
    parents = sum(int(torch.unique(comp[k, :int(new_count[k])] // div)
                      .numel()) for k in range(n))
    nbytes = append_mod.append_cost(wp, new, parents)["bytes"]
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
    # Bound: kernel 1's declared cost over the old table's C slots (the
    # old table read, two masks written, a sector a key).
    nbytes = table_mod.dedup_cost(C, cand)["bytes"]
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


def _wave_case(torch, wave_mod, table_mod, dm, store, valid, layout, table,
               use_sym, tag, scratch=None, plan=None):
    """The wave kernel against its plain version on ``store`` and a copy
    of ``table``: all outputs equal, tables equal as sets; then its time
    with a caller-owned scratch (``scratch``, an engine's, or one of its
    own), by kernel and memset, beside the plain version's and the
    bound. Under a matmul ``plan`` both run its transition-table form, and
    the bound's bytes count its tables."""
    B = store.shape[0]
    S, wp = B * dm.max_fanout, layout.packed_width
    names = ("succ_store", "path_fps", "sflat", "new_mask", "cand_mask",
             "new_count", "cand_count", "full")
    if scratch is None:
        fn, scratch = _scratch(torch, table_mod, wave_mod.wave_megakernel, S)
    else:
        fn = functools.partial(wave_mod.wave_megakernel, scratch=scratch)
    fn = functools.partial(fn, plan=plan)
    plain = functools.partial(wave_mod.wave_megakernel_plain, plan=plan)
    t_k, t_p = table.clone(), table.clone()
    got = fn(dm, store, valid, t_k, use_sym, layout)
    want = plain(dm, store, valid, t_p, use_sym, layout)
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
    plain_ms = _time_ms(torch, plain, 3, setup)
    # Bound: the kernel's declared cost (``wave.wave_cost``: bytes each
    # once, the front's operations), the profiler's count too.
    cost = wave_mod.wave_cost(dm, B, wp, use_sym, plan, n_valid, cand)
    nbytes, ops = cost["bytes"], cost["ops"]
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


def _sender_equal(torch, wave_mod, fn, scratch, args, tag, plan=None):
    """The sender kernel (``fn``) against its plain version on ``args``
    (under ``plan`` when given): all five outputs equal, the scratch
    handed back clean. Returns ``(valid, sent)``."""
    names = ("succ_store", "dedup_fps", "path_fps", "sflat", "send_mask")
    got = fn(*args)
    want = wave_mod.sender_megakernel_plain(*args, plan)
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
                        model="2pc 10", syms=(False, True), plan=None):
    """The sender kernel against its plain version at the full-width
    shape: ``store``'s packed rows (of ``model``) as ``SHARDS`` shards'
    batches, with the engine's scratch, plain and with symmetry (each of
    ``syms``); then at a ragged shape (3 shards of a row less). Under a
    matmul ``plan`` both run its transition-table form."""
    B, wp = store.shape[0] // SHARDS, layout.packed_width
    rows = store
    store = rows.reshape(SHARDS, B, wp).contiguous()
    valid = torch.ones((SHARDS, B), dtype=torch.bool, device="cuda")
    n = SHARDS
    S = B * dm.max_fanout
    fn, scratch = _scratch(torch, table_mod, wave_mod.sender_megakernel,
                           n * S, n)
    fn = functools.partial(fn, plan=plan)
    plain = functools.partial(wave_mod.sender_megakernel_plain, plan=plan)
    out = {}
    for use_sym in syms:
        for local_dedup in (True, False):
            args = (dm, store, valid, use_sym, layout, local_dedup)
            tag = (f"{model}, {'sym' if use_sym else 'plain'}"
                   f"{'' if local_dedup else ', no local dedup'}")
            n_valid, n_send = _sender_equal(torch, wave_mod, fn, scratch,
                                            args, tag, plan)
            ms, parts = _breakdown(torch, fn, 5, lambda: args)
            call_ms = _time_ms(torch, fn, 5, lambda: args)
            _check_clean(torch, scratch, f"the sender kernel ({tag}, timed)")
            plain_ms = _time_ms(torch, plain, 3, lambda: args)
            # Bound: the kernel's declared cost (``wave.sender_cost``),
            # the profiler's count too.
            cost = wave_mod.sender_cost(dm, n, B, wp, use_sym, plan,
                                        n_valid)
            nbytes, ops = cost["bytes"], cost["ops"]
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
    # Ragged: 3 shards of B - 1 rows (4,095 at full width), the last 100
    # of shard 2 not valid.
    n, B = 3, B - 1
    store = rows[:n * B].reshape(n, B, wp).contiguous()
    valid = torch.ones((n, B), dtype=torch.bool, device="cuda")
    valid[2, -100:] = False
    S = B * dm.max_fanout
    fn, scratch = _scratch(torch, table_mod, wave_mod.sender_megakernel,
                           n * S, n)
    fn = functools.partial(fn, plan=plan)
    for local_dedup in (True, False):
        tag = f"{model}, ragged{'' if local_dedup else ', no local dedup'}"
        n_valid, n_send = _sender_equal(
            torch, wave_mod, fn, scratch,
            (dm, store, valid, False, layout, local_dedup), tag, plan)
        _log(f"sender kernel == plain ({tag}) at n={n} x B={B}, S={S} "
             f"({S % 256} slots in each shard's last tile): valid={n_valid} "
             f"sent={n_send}, scratch clean")
    return out


def _chains(c):
    if isinstance(c, _RefRun):
        return c.chains
    return {name: p.fingerprints for name, p in c.discoveries().items()}


def _model(kind, *args, **kw):
    """The port's model ``kind`` built from ``args``: what a CPU
    reference run's picklable build (``_checker``) names."""
    from stateright_tpu_torch.models import (abd, increment, increment_lock,
                                             paxos, pingpong, single_copy,
                                             sliding_puzzle, twopc, vsr)
    from stateright_tpu_torch import test_util

    return {"twopc": twopc.TwoPhaseSys, "paxos": paxos.PaxosSys,
            "single_copy": single_copy.SingleCopySys, "abd": abd.AbdSys,
            "increment": increment.IncrementModel,
            "increment_lock": increment_lock.IncrementLockModel,
            "puzzle": sliding_puzzle.SlidingPuzzle,
            "linear_equation": test_util.LinearEquation,
            "pingpong": pingpong.PingPongSys,
            "vsr": vsr.VsrSys}[kind](*args, **kw)


def _checker(kind, *args, sym=False, target=None, **kw):
    """``_model(kind, *args, **kw)``'s checker builder, with symmetry and
    a target state count where given."""
    b = _model(kind, *args, **kw).checker()
    if sym:
        b = b.symmetry()
    return b.target_state_count(target) if target else b


def _build(kind, *args, **kw):
    """A picklable ``build`` of ``_checker(kind, *args, **kw)``."""
    return functools.partial(_checker, kind, *args, **kw)


class _RefRun:
    """What a card run is held to of a CPU reference run: its counts and
    its discoveries' fingerprint chains, and a classic engine's parent map
    and waves' log fields (``_classic_same``); picklable, so a worker
    process can make it."""

    #: the log fields ``_classic_same`` may compare
    FIELDS = ("bucket", "rows", "out_rows", "novel", "overflow",
              "successors", "candidates", "capacity", "load_factor", "epoch")

    def __init__(self, c):
        self.unique, self.states = c.unique_state_count(), c.state_count()
        self.chains = _chains(c)
        self.parents = (c._parent_map() if hasattr(c, "_parent_map")
                        else None)
        self.dispatch_log = [{f: e[f] for f in self.FIELDS if f in e}
                             for e in c.dispatch_log]

    def unique_state_count(self):
        return self.unique

    def state_count(self):
        return self.states

    def discoveries(self):
        return self.chains

    def _parent_map(self):
        return self.parents


def _ref_run(build, spawn):
    """One CPU reference run (in a worker process)."""
    import torch

    torch.set_num_threads(2)
    return _RefRun(build().spawn_cuda_bfs(**spawn).join())


class _CpuRefs:
    """The CPU reference runs (the torch stages on the CPU) that the
    phases hold their card runs to. A process asks for its phases' runs
    ahead (``ahead``, after the build or while it waits for its turn):
    two worker processes make them while the card runs earlier phases,
    and ``run`` takes the result, or makes the run inline where none was
    asked for (a build that is not ``_build``'s, a run not listed)."""

    def __init__(self):
        self._pool, self._futs = None, {}

    @staticmethod
    def _key(build, spawn):
        if not isinstance(build, functools.partial) or \
                build.func is not _checker:
            return None
        return (build.args, tuple(sorted(build.keywords.items())),
                tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                             for k, v in spawn.items())))

    def ahead(self, jobs) -> None:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        for build, spawn in jobs:
            key = self._key(build, spawn)
            if key is None or key in self._futs:
                continue
            if self._pool is None:
                self._pool = ProcessPoolExecutor(
                    2, mp_context=multiprocessing.get_context("spawn"))
            self._futs[key] = self._pool.submit(_ref_run, build, spawn)

    def run(self, build, spawn):
        key = self._key(build, spawn)
        if key in self._futs:
            try:
                return self._futs[key].result()
            except Exception as e:  # noqa: BLE001 — the worker, not the run
                _log(f"a CPU reference run's worker failed ({e!r}); the "
                     "run is made here")
        return _ref_run(build, spawn)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


_REFS = _CpuRefs()


#: phase 5's 2pc configurations: (RMs, unique, states, symmetry)
SMALL_2PC = ((3, 288, 1146, False), (5, 8832, 58146, False),
             (5, 314, 2048, True))


def _small_refs():
    """Phase 5's CPU reference runs, as ``_CpuRefs.ahead`` takes them."""
    jobs = []
    for n, _, _, sym in SMALL_2PC:
        jobs.append((_build("twopc", n, sym=sym),
                     dict(device="cpu", batch_size=1024)))
        for shards in (1, SHARDS):
            jobs.append((_build("twopc", n, sym=sym),
                         dict(mesh=["cpu"] * shards, batch_size=256)))
    jobs += [(_build("twopc", 5), _spawn3("cpu", novel, wave_kernel=True))
             for novel in (True, False)]
    for clients in (1, 2):
        jobs += [(_build("paxos", clients), kw) for kw in (
            dict(device="cpu", batch_size=1024),
            dict(mesh=["cpu"] * SHARDS, batch_size=256))]
    jobs += [(_build("paxos", 4, sym=True, target=PAXOS4_TARGET),
              _on_cpu(dict(wave_kernel=True, **kw)))
             for kw in _PAXOS_ENGINES]
    jobs.append((_build("paxos", 1, liveness=True), _on_cpu(dict(
        wave_kernel=True, batch_size=1024))))
    return jobs


def _spawn3(device, novel, **kw):
    """2pc 5's odd-S sharded spawn: 3 shards of 255 rows."""
    return dict(mesh=[device] * 3, batch_size=255,
                exchange_novel_only=novel, **kw)


def _on_cpu(spawn):
    """``spawn`` with the card made the CPU."""
    return (dict(spawn, mesh=["cpu"] * len(spawn["mesh"])) if "mesh" in spawn
            else dict(spawn, device="cpu"))


def phase_small(TwoPhaseSys):
    for n, unique, states, sym in SMALL_2PC:
        def spawn(**kw):
            b = TwoPhaseSys(n).checker()
            return (b.symmetry() if sym else b).spawn_cuda_bfs(
                batch_size=1024, **kw).join()

        cpu = _REFS.run(_build("twopc", n, sym=sym),
                        dict(device="cpu", batch_size=1024))
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
    for n, unique, states, sym in SMALL_2PC:
        for shards in (1, SHARDS):
            def spawn(device, **kw):
                b = TwoPhaseSys(n).checker()
                return (b.symmetry() if sym else b).spawn_cuda_bfs(
                    mesh=[device] * shards, batch_size=256, **kw).join()

            cpu = _REFS.run(_build("twopc", n, sym=sym),
                            dict(mesh=["cpu"] * shards, batch_size=256))
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
        cpu = _REFS.run(_build("twopc", 5),
                        _spawn3("cpu", novel, wave_kernel=True))
        gpu = TwoPhaseSys(5).checker().spawn_cuda_bfs(
            **_spawn3("cuda:0", novel, wave_kernel=True)).join()
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


def _paxos_against_cpu(checker, want, path, found, cpu=None, **spawn):
    """``checker()``'s run on the card through ``spawn_cuda_bfs(**spawn)``
    (a ``mesh`` of ``cuda:0`` for the sharded engine) against the same run
    on the CPU (``cpu``, or made here): the counts (and ``want``, where
    given), the kernel path, the discoveries ``found`` (where given) and
    their chains."""
    if cpu is None:
        cpu = _REFS.run(checker, _on_cpu(spawn))
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


#: paxos 4's card spawns in phase 5: fused, and sharded on the card
_PAXOS_ENGINES = (dict(device="cuda:0", batch_size=1024),
                  dict(batch_size=256, mesh=["cuda:0"] * SHARDS))


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
        # One CPU run (the torch stages) an engine, both card paths held
        # to it.
        cpu = {engine: _REFS.run(_build("paxos", clients), kw)
               for engine, kw in (("fused", dict(device="cpu",
                                                  batch_size=1024)),
                                  ("sharded", dict(mesh=["cpu"] * SHARDS,
                                                   batch_size=256)))}
        for wave_kernel, paths in ((False, ("dedup_kernel", "dedup_kernel")),
                                   (True, ("megakernel", "sender_kernel"))):
            for path, (engine, spawn) in zip(paths, (
                    ("fused", dict(batch_size=1024)),
                    ("sharded", dict(batch_size=256,
                                     mesh=["cuda:0"] * SHARDS)))):
                _, line = _paxos_against_cpu(
                    PaxosSys(clients).checker, want, path, ["value chosen"],
                    cpu=cpu[engine], wave_kernel=wave_kernel, **spawn)
                _log(f"paxos {clients} {line}")
    for path, spawn in zip(("megakernel", "sender_kernel"), _PAXOS_ENGINES):
        gpu, line = _paxos_against_cpu(
            _build("paxos", 4, sym=True, target=PAXOS4_TARGET), None, path,
            None, wave_kernel=True, **spawn)
        if gpu.state_count() < PAXOS4_TARGET:
            raise AssertionError(f"paxos 4 sym {line}: stopped short of "
                                 f"{PAXOS4_TARGET} states")
        _log(f"paxos 4 sym to {PAXOS4_TARGET} states {line}")
    _, line = _paxos_against_cpu(
        _build("paxos", 1, liveness=True), (265, 482), "megakernel",
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


def _check_launches(fused, c, launches, **spawn) -> int:
    """Raises unless ``launches`` (by kernel name) are exactly those of
    fused-engine run ``c`` spawned with ``spawn``; returns its rehashes'
    chunks. Every dispatch launches K waves, also those past a rest point,
    and a replay counts its captured launches. A wave runs the dedup
    kernel once a shard, unless the single-kernel wave does the wave's
    dedup itself, and the append kernel once; a rehash runs the dedup
    kernel once a chunk of each old table slice: the least power of two of
    chunks of at most the engine's scratch rows."""
    n = getattr(c, "_n", 1)
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
    return chunks


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
    chunks = _check_launches(fused, c, launches, **spawn)
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
    names = sorted(c.discoveries())
    if names != found:
        raise AssertionError(f"{tag}: discoveries {names}")
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
    # Bound: kernel 1's declared cost, every key a candidate.
    nbytes = table_mod.dedup_cost(n, n)["bytes"]
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
                         batch=BATCH, target=60_000_000,
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


#: phase 8's runs against the CPU: (tag, checker, counts, batch)
CLASSIC_SMALL = (
    ("2pc 3", _build("twopc", 3), (288, 1146), 64),
    ("2pc 5", _build("twopc", 5), (8832, 58146), 64),
    ("2pc 5 sym", _build("twopc", 5, sym=True), (314, 2048), 64),
    ("paxos 1", _build("paxos", 1), (265, 482), 64),
    ("paxos 2", _build("paxos", 2), (16_668, 32_971), 1024))


def _classic_cpu(**kw):
    """A phase 8 CPU run's spawn: the classic engine, pipelined, as the
    card's run is by default."""
    return dict(kw, device="cpu", fused=False, pipeline=True)


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

    def against_cpu(tag, build, want, **kw):
        cpu = _REFS.run(build, _classic_cpu(**kw))
        for wave_kernel in (False, True):
            c = run(build(), device, wave_kernel=wave_kernel, **kw)
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

    for tag, build, want, batch in CLASSIC_SMALL:
        against_cpu(tag, build, want, batch_size=batch)

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
    down = list(c.bytes_down)
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
    names = sorted(c.discoveries())
    if names != want_found:
        raise AssertionError(f"{config} classic discoveries: {names}")
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
    phase 6's, where it ran)."""
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
        if fused_runs is None:  # phase 6 did not run
            continue
        f = fused_runs[fused_tag]["run"]
        _log(f"{tag}: classic {run['sec']:.3f} s ({run['waves']} waves) "
             f"against fused {f['sec']:.3f} s ({f['dispatches']} "
             f"dispatches); peak {run['peak']} B against {f['peak']} B")
    _log(f"classic phase: small gates {t1 - t0:.1f} s, full runs "
         f"{time.monotonic() - t1:.1f} s")
    return out


# -- The register corpus ------------------------------------------------------


#: single-copy's counts (unique, states) at 3 and 4 clients on one server,
#: plain and with symmetry; the symmetric ones are JAX spawn_tpu_bfs's on
#: the CPU with .symmetry()
SC_COUNTS = {(3, False): (4_243, 6_778), (4, False): (400_233, 731_789),
             (3, True): (712, 1_144), (4, True): (16_726, 30_657)}
ABD_COUNTS = (544, 875)
#: the states a single-copy 4 checker runs to before its next batch is the
#: kernels' input and its dispatch is sync-checked: a frontier wider than a
#: batch
SC4_MID = 150_000


def _register_modules():
    from stateright_tpu_torch.models.abd import AbdSys
    from stateright_tpu_torch.models.single_copy import SingleCopySys
    return SingleCopySys, AbdSys


def phase_register_kernels(torch, wave_mod, table_mod, SingleCopySys,
                           AbdSys):
    """Kernels 2 and 3 on both register models (their CUDA steps on
    ``csrc/models/register_workload.cuh``) against their plain versions:
    the next 16,384 rows of a mid-run single-copy 4 arena, against its
    engine's table and with its engine's scratch, plain and with symmetry
    (23 permutations a row), then as 4 shards of 4,096 and ragged; and
    ABD 2/2's whole space (544 rows) with seeded adversarial rows, one
    batch of 1,024, against its finished run's table, then as 4 shards of
    256 and ragged."""
    mid = (SingleCopySys(4).checker().target_state_count(SC4_MID)
           .spawn_cuda_bfs(device="cuda:0", batch_size=BATCH).join())
    if mid._tail - mid._head < BATCH:
        raise AssertionError(f"mid-run single_copy 4 frontier of "
                             f"{mid._tail - mid._head} rows is narrower than "
                             f"{BATCH}")
    dm, layout = mid._dm, mid._layout
    store = mid._vecs[mid._head:mid._head + BATCH].clone()
    valid = torch.ones(BATCH, dtype=torch.bool, device="cuda")
    out = {}
    for tag, use_sym in (("plain", False), ("sym", True)):
        out[("single_copy 4", tag)] = _wave_case(
            torch, wave_mod, table_mod, dm, store, valid, layout,
            mid._table, use_sym, f"single_copy 4, {tag}",
            scratch=mid._scratch)
    out[("single_copy 4", "sender")] = phase_sender_kernel(
        torch, wave_mod, table_mod, dm, store, layout, "single_copy 4")
    del mid, store

    full = AbdSys(2, 2).checker().spawn_cuda_bfs(device="cuda:0",
                                                 batch_size=1024).join()
    dm, layout = full._dm, full._layout
    reach = full._vecs[:full._tail]
    if reach.shape[0] != ABD_COUNTS[0]:
        raise AssertionError(f"abd 2 arena holds {reach.shape[0]} rows")
    B = 1024
    gen = torch.Generator(device="cuda").manual_seed(12)
    w, off, e = dm.state_width, dm.net_offset, dm.net_slots
    n = B - reach.shape[0]
    # Adversarial rows: small random lanes, and random envelopes (every
    # kind and destination, extra bits past their range), half sorted.
    adv = torch.randint(0, 12, (n, w), generator=gen, device="cuda")
    env = torch.randint(0, 1 << (dm.extra_shift + 4), (n, e), generator=gen,
                        device="cuda")
    env = torch.where(torch.rand((n, e), generator=gen, device="cuda") < 0.3,
                      torch.full_like(env, 0xFFFFFFFF), env)
    half = torch.arange(n, device="cuda")[:, None] < n // 2
    adv[:, off:off + e] = torch.where(half, torch.sort(env, dim=1).values,
                                      env)
    store = torch.cat([reach, layout.pack(adv)]).contiguous()
    valid = torch.ones(B, dtype=torch.bool, device="cuda")
    for tag, use_sym in (("plain", False), ("sym", True)):
        out[("abd 2", tag)] = _wave_case(
            torch, wave_mod, table_mod, dm, store, valid, layout,
            full._table, use_sym, f"abd 2, {tag}", scratch=full._scratch)
    out[("abd 2", "sender")] = phase_sender_kernel(
        torch, wave_mod, table_mod, dm, store, layout, "abd 2")
    return out


def _cpu_run(build, engine, batch):
    """The CPU run of ``build()``'s checker on ``engine`` at ``batch`` rows
    (``batch / SHARDS`` a shard on the sharded engine), the torch stages:
    its ``_RefRun``, made ahead where it was asked for."""
    return _REFS.run(build, _spawn_kw("cpu", engine, batch))


def _spawn_kw(device, engine, batch, **kw):
    if engine == "sharded":
        return dict(mesh=[device] * SHARDS, batch_size=batch // SHARDS, **kw)
    if engine == "classic":
        return dict(device=device, fused=False, pipeline=True,
                    batch_size=batch, **kw)
    return dict(device=device, batch_size=batch, **kw)


def _card_run(torch, kernels, fused, tag, build, engine, batch, want,
              found, cpu, wave_kernel):
    """``build()``'s checker to its end on the card on ``engine`` (fused,
    classic or sharded on ``mesh=[cuda:0] * SHARDS``), the kernels' launch
    counts set to 0 just before and read just after: the counts ``want``
    (unique, states; None for one not checked), the CPU run ``cpu``'s
    counts and chains exactly (where given), its discoveries ``found``
    (where given), the launches exact. Returns the run's numbers with its
    discoveries' chains (fingerprints and actions, replayed through
    ``path.py``)."""
    if batch == BATCH:
        gc.collect()  # the peak of a full-width run is its own
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    spawn = _spawn_kw("cuda:0", engine, batch, wave_kernel=wave_kernel)
    t0 = time.monotonic()
    c = build().spawn_cuda_bfs(**spawn).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    got = (c.unique_state_count(), c.state_count())
    path = c.kernel_path()
    tag = f"{tag}, {engine}, {path}"
    full = ("" if engine != "classic" else
            f" ({sum(e['rows'] == batch for e in c.dispatch_log)} of "
            f"{batch} rows)")
    _log(f"{tag}: unique={got[0]} states={got[1]} sec={sec:.3f} "
         f"states/s={got[1] / sec:.1f} waves={c.waves}{full} peak device "
         f"memory {peak} B launches={launches}")
    if any(w is not None and g != w for g, w in zip(got, want or ())):
        raise AssertionError(f"{tag}: {got} != {want}")
    if cpu is not None and got != (cpu.unique_state_count(),
                                   cpu.state_count()):
        raise AssertionError(f"{tag}: {got}, the CPU run's "
                             f"{cpu.unique_state_count()} / "
                             f"{cpu.state_count()}")
    paths = c.discoveries()  # each path rebuilt once
    if (found is not None and sorted(paths) != found) or (
            cpu is not None and {k: p.fingerprints for k, p in paths.items()}
            != _chains(cpu)):
        raise AssertionError(f"{tag}: discoveries {sorted(paths)}"
                             ", or their chains differ from the CPU run")
    want_path = {("fused", False): "dedup_kernel",
                 ("fused", True): "megakernel",
                 ("classic", False): "dedup_kernel",
                 ("classic", True): "megakernel",
                 ("sharded", False): "dedup_kernel",
                 ("sharded", True): "sender_kernel"}[engine, wave_kernel]
    if path != want_path:
        raise AssertionError(f"{tag}: kernel_path() is not {want_path}")
    if engine == "classic":
        want_l = {"dedup_and_insert": c.rehash_chunks + (
            0 if wave_kernel else c.waves),
            "wave_megakernel": c.waves if wave_kernel else 0,
            "sender_megakernel": 0, "append_rows": 0}
        if launches != want_l:
            raise AssertionError(f"{tag}: kernel launches {launches}, "
                                 f"expected {want_l}")
    else:
        _check_launches(fused, c, launches, **spawn)
    chains = {name: (p.fingerprints, [repr(a) for a in p.into_actions()])
              for name, p in paths.items()}
    return dict(sec=sec, peak=peak, launches=launches, waves=c.waves,
                counts=got, chains=chains)


#: the states the cut runs of the largest configurations stop at (depth
#: cut to keep the script inside its time: each configuration runs to its
#: end once, on the fused wave kernel): the 4x3 puzzle's "solved" lies 28
#: moves from its start, and the 50,962,543 successors of its first 29 BFS
#: levels are all expanded by 56 M; the others at 1/24 to 1/3 of their
#: states (cut further to make room for phase 14)
CUTS = {"single_copy 4": 200_000, "single_copy 4 sym": 15_000,
        "puzzle 4x3": 56_000_000, "paxos 4": 300_000,
        "paxos 4 sym liveness": 200_000, "pingpong 11": 8_000_000,
        "vsr 4": 800_000}


def _cut(tag: str) -> str:
    """The runs' tag of ``tag``'s cut runs."""
    return f"{tag} to {CUTS[tag]:,}"


def _whole_and_cut(torch, kernels, fused, tag, build, want, found):
    """``build()``'s checker at full width (batch 16,384): to its end on
    the fused wave kernel, its counts ``want`` (None for one not checked)
    and discoveries ``found``; then cut to ``CUTS[tag]`` states on the
    fused, the classic and the sharded engine (4 shards), each on the
    torch stages and on the kernels. Each engine's kernel run equals its
    torch stages' in counts and chains; the unsharded runs' chains are the
    fused torch stages' (the sharded engine's its own torch stages': its
    order within a wave is not the fused engine's); every cut run stops
    at or past the cut and short of the whole run, finds only what the
    whole run finds, and the whole run's chains are the fused torch
    stages' for what the cut found. Returns the runs by ``(tag, engine,
    wave_kernel)``, the whole run's under ``tag``, the cut runs' under
    ``_cut(tag)``."""
    whole = _card_run(torch, kernels, fused, tag, build, "fused", BATCH,
                      want, found, None, True)
    cut, target = _cut(tag), CUTS[tag]
    runs = {(tag, "fused", True): whole}
    for engine in ("fused", "classic", "sharded"):
        for wave_kernel in (False, True):
            runs[cut, engine, wave_kernel] = _card_run(
                torch, kernels, fused, cut,
                lambda: build().target_state_count(target), engine, BATCH,
                None, None, None, wave_kernel)
    ref = runs[cut, "fused", False]
    for (_, engine, wave_kernel), r in list(runs.items())[1:]:
        where = f"{cut}, {engine}, wave_kernel={wave_kernel}"
        if not target <= r["counts"][1] < whole["counts"][1]:
            raise AssertionError(f"{where}: {r['counts']}, not cut at "
                                 f"{target} states")
        if not set(r["chains"]) <= set(whole["chains"]):
            raise AssertionError(f"{where}: discoveries {sorted(r['chains'])}"
                                 f", the whole run's {found}")
        if r["counts"] != runs[cut, engine, False]["counts"]:
            torch_counts = runs[cut, engine, False]["counts"]
            raise AssertionError(f"{where}: {r['counts']}, the torch "
                                 f"stages' {torch_counts}")
        _same_runs(r, dict(ref, counts=r["counts"]) if engine != "sharded"
                   else runs[cut, "sharded", False], where)
    if {k: whole["chains"][k] for k in ref["chains"]} != ref["chains"]:
        raise AssertionError(f"{tag}: the whole run's chains differ from "
                             f"the cut runs' {sorted(ref['chains'])}")
    lengths = [{k: len(v[0]) for k, v in r["chains"].items()}
               for r in (whole, runs[cut, "sharded", False])]
    _log(f"{tag}: the runs agree ({whole['counts']} to its end; cut at "
         f"{target:,} states: {ref['counts']} fused, "
         f"{runs[cut, 'classic', False]['counts']} classic, "
         f"{runs[cut, 'sharded', False]['counts']} sharded; chains of "
         f"{lengths[0]} states, the sharded cut's {lengths[1]})")
    return runs


def _register_configs():
    """Phase 9's runs: (tag, checker, batch, the CPU run's batch, counts,
    discoveries)."""
    value = ["value chosen"]
    return (
        ("single_copy 3", _build("single_copy", 3), 1024, 1024,
         SC_COUNTS[3, False], value),
        ("single_copy 3 sym", _build("single_copy", 3, sym=True), 1024,
         1024, SC_COUNTS[3, True], value),
        ("single_copy 2/2", _build("single_copy", 2, 2), 1024, 1024, None,
         ["linearizable", "value chosen"]),
        ("abd 2", _build("abd", 2, 2), 1024, 1024, ABD_COUNTS, value),
        ("single_copy 4", _build("single_copy", 4), BATCH, None,
         SC_COUNTS[4, False], value),
        ("single_copy 4 sym", _build("single_copy", 4, sym=True), BATCH,
         None, SC_COUNTS[4, True], value))


def _register_refs():
    return [(build, _spawn_kw("cpu", engine, cpu_batch))
            for _, build, _, cpu_batch, _, _ in _register_configs()
            if cpu_batch for engine in ("fused", "sharded")]


def phase_registers(torch, kernels, fused, wave_mod, table_mod):
    """The register corpus on the card: kernels 2 and 3 held to their
    plain versions on single-copy 4 and ABD 2/2
    (``phase_register_kernels``); then each configuration to its end on
    the fused, the classic and the sharded engine, each on the torch
    stages and on the kernels, exact against its counts and against the
    same run on the CPU: single-copy 3 and 4 on one server, each plain
    and with symmetry, single-copy 2 on two servers (its linearizability
    counterexample) and ABD 2/2. The classic engine's runs are held to
    the fused engine's CPU run. Single-copy 4 makes no CPU run (the CPU's
    were most of the phase's time): it runs to its pinned counts, which
    the CPU tests hold to JAX's (``tests/test_torch_registers.py``), once
    on the fused wave kernel, and cut on the six paths, held to the
    card's torch stages (``_whole_and_cut``), as the corpus phase does
    for the puzzle. Single-copy's symmetric counts are JAX's.
    Then one replayed dispatch of single-copy 4 on the wave kernel under
    ``set_sync_debug_mode("error")``."""
    SingleCopySys, AbdSys = _register_modules()
    t0 = time.monotonic()
    holds = phase_register_kernels(torch, wave_mod, table_mod,
                                   SingleCopySys, AbdSys)
    t1 = time.monotonic()
    runs = {}
    for tag, build, batch, cpu_batch, want, found in _register_configs():
        if not cpu_batch:
            # No CPU run: the card's torch stages are the reference.
            runs.update(_whole_and_cut(torch, kernels, fused, tag, build,
                                       want, found))
            continue
        for engine in ("fused", "classic", "sharded"):
            if engine != "classic":
                t_cpu = time.monotonic()
                cpu = _cpu_run(build, engine, cpu_batch)
                _log(f"{tag}, {engine}, the CPU's run at batch {cpu_batch}:"
                     f" {time.monotonic() - t_cpu:.1f} s")
            for wave_kernel in (False, True):
                runs[tag, engine, wave_kernel] = _card_run(
                    torch, kernels, fused, tag, build, engine, batch, want,
                    found, cpu, wave_kernel)
    t2 = time.monotonic()
    mid = (SingleCopySys(4).checker().target_state_count(SC4_MID)
           .spawn_cuda_bfs(device="cuda:0", batch_size=BATCH,
                           wave_kernel=True).join())
    mid._stats[..., fused.ST_TARGET] = 1 << 62
    point = _Point(torch, fused, mid)
    waves, _, _, _, replay = _timed_dispatch(torch, point, sync_check=True)
    if waves == 0 or not replay:
        raise AssertionError(f"the sync-checked dispatch ran {waves} waves "
                             f"(a replay: {replay})")
    _log(f"single_copy 4 megakernel: one replayed dispatch under "
         f"set_sync_debug_mode('error'), {waves} waves, no synchronisation")
    del mid, point
    _log(f"register phase: kernel holds {t1 - t0:.1f} s, full runs "
         f"{t2 - t1:.1f} s, sync check {time.monotonic() - t2:.1f} s")
    for (tag, engine, wave_kernel), r in runs.items():
        path = "kernels" if wave_kernel else "torch stages"
        _log(f"  {tag:28s} {engine:8s} {path:13s} {r['sec']:8.3f} s  peak "
             f"{r['peak']:>12d} B  waves {r['waves']:4d}  {r['counts']}")
    return holds, runs


# -- The corpus's plain models ------------------------------------------------


#: the 4x3 puzzle's space: 12! / 2 boards (a board reaches exactly the even
#: permutations), and its states: each board's successors plus the init.
#: With an odd column count the tiles' parity does not depend on the
#: blank's cell, so each of the 12 cells holds the blank on 11! / 2 boards,
#: with 2 moves from a corner (4 cells), 3 from an edge's middle (6) and 4
#: from the middle (2): 19,958,400 x 34 + 1
PUZZLE43 = (239_500_800, 678_585_601)
#: the 3x3 gate's cut (its 483,841 states, 20,160 x (4 x 2 + 4 x 3 + 4) +
#: 1, are the CPU tests'): "solved" lies 16 moves from the start, and the
#: 104,260 successors of its first 21 BFS levels (the 21st of 16,993
#: boards, wider than a batch) are all expanded by 100,000
PUZZLE33_CUT = 100_000
#: paxos at 4 clients (MEASUREMENTS.md): the whole space, and its orbits
#: under the client symmetry (the states of a symmetric run are the fused
#: torch-stage run's)
PAXOS4 = (2_372_188, 4_807_983)
PAXOS4_SYM_UNIQUE = 1_194_428
#: the states the kernels' mid-run arenas are taken at (frontiers wider
#: than a batch)
PUZZLE_MID, LOCK_MID = 1_000_000, 150_000


def _corpus_modules():
    from stateright_tpu_torch.model import Property
    from stateright_tpu_torch.models.increment import IncrementModel
    from stateright_tpu_torch.models.increment_lock import IncrementLockModel
    from stateright_tpu_torch.models.paxos import PaxosSys
    from stateright_tpu_torch.models.sliding_puzzle import SlidingPuzzle
    from stateright_tpu_torch.test_util import LinearEquation, random_graph
    return dict(Property=Property, IncrementModel=IncrementModel,
                IncrementLockModel=IncrementLockModel, PaxosSys=PaxosSys,
                SlidingPuzzle=SlidingPuzzle, LinearEquation=LinearEquation,
                random_graph=random_graph)


def _fuzz_graphs(m, seed):
    """The differential fuzz's graphs of ``seed``
    (``tests/test_fuzz_engines.py``), from the same ``random.Random``
    draws: its discovery graph (an always or sometimes property of one
    node) and its eventually graph ("odd")."""
    Property, random_graph = m["Property"], m["random_graph"]
    rng = random.Random(2000 + seed)
    target, kind = rng.randrange(12), rng.choice(["always", "sometimes"])
    if kind == "always":
        prop = Property.always("p")
        pred = (lambda rows, t=target: rows[:, 0] != t)
    else:
        prop = Property.sometimes("p")
        pred = (lambda rows, t=target: rows[:, 0] == t)
    found = random_graph(rng, "p", pred).with_property_of(prop)
    odd = random_graph(random.Random(3000 + seed), "odd",
                       lambda rows: rows[:, 0] % 2 == 1).with_property_of(
        Property.eventually("odd"))
    return [(f"dgraph {seed} {kind}", found), (f"dgraph {seed} odd", odd)]


def _last_rows(c, rows: int):
    """The last ``rows`` packed rows of checker ``c``'s arena (its queue's,
    where the queue holds that many)."""
    if c._tail < rows:
        raise AssertionError(f"the arena holds {c._tail} rows, not {rows}")
    return c._vecs[c._tail - rows:c._tail].clone()


def phase_corpus_kernels(torch, wave_mod, table_mod, m):
    """Kernels 2 and 3 on the five plain models' CUDA steps against their
    plain versions at full width (16,384 rows, then as 4 shards of 4,096
    and ragged; the scratch clean after each), each against its engine's
    table and with its engine's scratch: the last rows of a mid-run arena
    of the 4x3 puzzle; of increment 16's (its run stops at the
    counterexample) and a mid-run increment_lock 8's, each plain and with
    symmetry; the first rows of LinearEquation (2, 4, 7)'s; and rows of
    random node ids of a random graph of the differential fuzz (seed 0's
    eventually graph)."""
    out = {}

    def hold(tag, c, store, syms, table=None):
        dm, layout = c._dm, c._layout
        valid = torch.ones(store.shape[0], dtype=torch.bool, device="cuda")
        table = c._table if table is None else table
        for use_sym in syms:
            sym = "sym" if use_sym else "plain"
            out[tag, sym] = _wave_case(
                torch, wave_mod, table_mod, dm, store, valid, layout, table,
                use_sym, f"{tag}, {sym}", scratch=c._scratch)
        out[tag, "sender"] = phase_sender_kernel(
            torch, wave_mod, table_mod, dm, store, layout, tag, syms=syms)

    mid = (m["SlidingPuzzle"](4, 3).checker().target_state_count(PUZZLE_MID)
           .spawn_cuda_bfs(device="cuda:0", batch_size=BATCH).join())
    hold("puzzle 4x3", mid, _last_rows(mid, BATCH), (False,))
    del mid
    run = (m["IncrementModel"](16).checker()
           .spawn_cuda_bfs(device="cuda:0", batch_size=BATCH).join())
    hold("increment 16", run, _last_rows(run, BATCH), (False, True))
    del run
    mid = (m["IncrementLockModel"](8).checker().target_state_count(LOCK_MID)
           .spawn_cuda_bfs(device="cuda:0", batch_size=BATCH).join())
    hold("increment_lock 8", mid, _last_rows(mid, BATCH),
         (False, True))
    del mid
    mid = (m["LinearEquation"](2, 4, 7).checker().target_state_count(20_000)
           .spawn_cuda_bfs(device="cuda:0", batch_size=BATCH).join())
    hold("linear_equation", mid, mid._vecs[:BATCH].clone(), (False,))
    del mid
    graph = _fuzz_graphs(m, 0)[1][1]
    run = graph.checker().spawn_cuda_bfs(device="cuda:0",
                                         batch_size=BATCH).join()
    gen = torch.Generator(device="cuda").manual_seed(13)
    nodes = torch.randint(0, run._dm.n, (BATCH, 1), generator=gen,
                          device="cuda")
    hold("dgraph 0", run, run._layout.pack(nodes).contiguous(), (False,))
    return out


def _corpus_cpu(build, batch, kind):
    """The CPU runs (the torch stages at ``batch`` rows) that each engine's
    card runs of ``build()`` are held to, by engine. A run that stops at
    its first counterexample (``kind`` "early") has counts that depend on
    the engine and the batch: each engine meets its own CPU run; so has
    one cut at a state count (``target_state_count``). A full
    enumeration's counts do not, and neither do the classic engine's
    discovery chains, which are the fused engine's
    (``tests/test_torch_corpus.py::test_full_enumerations_agree_across_
    engines``): with discoveries ("found") the classic engine meets the
    fused CPU run and the sharded engine its own; without ("full") the
    runs meet their exact counts alone (held to JAX's on the CPU by
    ``tests/test_torch_corpus.py``), and no CPU run is made."""
    if kind == "full":
        return dict.fromkeys(("fused", "classic", "sharded"))
    fused = _cpu_run(build, "fused", batch)
    out = {"fused": fused, "classic": fused,
           "sharded": _cpu_run(build, "sharded", batch)}
    if kind == "early":
        out["classic"] = _cpu_run(build, "classic", batch)
    return out


def _corpus_refs(configs):
    """``_corpus_cpu``'s runs of ``configs`` ((tag, build, batch, ...,
    kind) tuples), as ``_CpuRefs.ahead`` takes them."""
    jobs = []
    for tag, build, batch, *_, kind in configs:
        engines = {"full": (), "found": ("fused", "sharded")}.get(
            kind, ("fused", "sharded", "classic"))
        jobs += [(build, _spawn_kw("cpu", e, batch)) for e in engines]
    return jobs


def _corpus_configs():
    """Phase 10's small configurations but the fuzz graphs: (tag,
    checker, batch, counts, discoveries, the CPU runs' kind)."""
    return [
        ("linear_equation 2 4 7", _build("linear_equation", 2, 4, 7), 1024,
         (65_536, 131_073), [], "full"),
        ("linear_equation 2 10 14", _build("linear_equation", 2, 10, 14),
         1024, None, ["solvable"], "early"),
        ("increment 2", _build("increment", 2), 1024, (13, 15), ["fin"],
         "early"),
        ("increment 2 sym", _build("increment", 2, sym=True), 1024, (8, 10),
         ["fin"], "early"),
        ("increment 16", _build("increment", 16), 1024, None, ["fin"],
         "early"),
        ("increment 16 sym", _build("increment", 16, sym=True), 1024, None,
         ["fin"], "early"),
        ("increment_lock 2", _build("increment_lock", 2), 1024, (17, 17),
         [], "full"),
        ("increment_lock 2 sym", _build("increment_lock", 2, sym=True),
         1024, (9, 10), [], "full"),
        ("increment_lock 8", _build("increment_lock", 8), BATCH,
         (438_401, 438_401), [], "full"),
        ("increment_lock 8 sym", _build("increment_lock", 8, sym=True),
         BATCH, (33, 61), [], "full"),
        (f"puzzle 3x3 to {PUZZLE33_CUT:,}", _build(
            "puzzle", 3, 3, target=PUZZLE33_CUT), BATCH, None, ["solved"],
         "early")]


def phase_corpus_gates(torch, kernels, fused, m):
    """Each small configuration to its end on the fused, the classic and
    the sharded engine (4 shards), each on the torch stages and on the
    kernels, exact against its counts and against a CPU run at the same
    batch (``_corpus_cpu``: discoveries and their chains too), the
    kernels' launches exact. Returns the runs' numbers."""
    configs = _corpus_configs()
    for seed in range(5):
        for tag, graph in _fuzz_graphs(m, seed):
            configs.append((tag, graph.checker, 8, None, None, "early"))
    runs = {}
    for tag, build, batch, want, found, kind in configs:
        t_cpu = time.monotonic()
        cpu = _corpus_cpu(build, batch, kind)
        _log(f"{tag}: the CPU's runs at batch {batch}: "
             f"{time.monotonic() - t_cpu:.1f} s")
        for engine in ("fused", "classic", "sharded"):
            want_found = (sorted(cpu[engine].discoveries()) if found is None
                          else found)
            for wave_kernel in (False, True):
                runs[tag, engine, wave_kernel] = _card_run(
                    torch, kernels, fused, tag, build, engine, batch, want,
                    want_found, cpu[engine], wave_kernel)
    return runs


def _same_runs(a, b, tag):
    if a["counts"] != b["counts"] or a["chains"] != b["chains"]:
        raise AssertionError(f"{tag}: {a['counts']} and chains "
                             f"{a['chains']}, the reference's {b['counts']} "
                             f"and {b['chains']}")


def _puzzle_memory(words: int) -> str:
    """The 4x3 puzzle's device memory on the fused engine, reckoned before
    its run from its ``words`` packed words a row: the arena (packed row,
    fingerprint, parent, eventually bits) doubles to 2^28 rows while it
    still holds its 2^27 rows, the visited table to 2^29 slots (half
    load) while it still holds its 2^28."""
    row = 4 * words + 8 + 8 + 4
    unique = PUZZLE43[0]
    arena = (1 << (unique - 1).bit_length()) * row
    table = (1 << (2 * unique - 1).bit_length()) * 8
    return (f"{row} B an arena row; the arena {arena} B at 2^28 rows, "
            f"{arena * 3 // 2} B while it doubles; the table {table} B, "
            f"{table * 3 // 2} B while it doubles; peak about "
            f"{arena * 3 // 2 + table} B of 80 GB")


def phase_corpus_full(torch, kernels, fused, m):
    """The full-width runs (``_whole_and_cut``): the 4x3 puzzle
    (239,500,800 boards, the closed form's counts, no "even permutation"
    counterexample), then ``paxos check 4`` (2,372,188 / 4,807,983;
    1,194,428 with symmetry), plain and with symmetry and the liveness
    property (BASELINE.json's workload), each to its end on the fused
    wave kernel and cut on the six paths."""
    Puzzle, Paxos = m["SlidingPuzzle"], m["PaxosSys"]
    _log("puzzle 4x3, memory reckoned before the runs: "
         + _puzzle_memory(Puzzle(4, 3).device_model().state_width))
    configs = (
        ("puzzle 4x3", lambda: Puzzle(4, 3).checker(), PUZZLE43,
         ["solved"]),
        ("paxos 4", lambda: Paxos(4).checker(), PAXOS4, ["value chosen"]),
        ("paxos 4 sym liveness",
         lambda: Paxos(4, liveness=True).checker().symmetry(),
         (PAXOS4_SYM_UNIQUE, None), ["value chosen"]))
    runs = {}
    for tag, build, want, found in configs:
        runs.update(_whole_and_cut(torch, kernels, fused, tag, build, want,
                                   found))
    return runs


def phase_corpus(torch, kernels, fused, wave_mod, table_mod):
    """The corpus's plain models on the card: kernels 2 and 3 held to
    their plain versions (``phase_corpus_kernels``), the small
    configurations against the CPU (``phase_corpus_gates``) and the
    full-width runs (``phase_corpus_full``)."""
    m = _corpus_modules()
    t0 = time.monotonic()
    holds = phase_corpus_kernels(torch, wave_mod, table_mod, m)
    t1 = time.monotonic()
    gates = phase_corpus_gates(torch, kernels, fused, m)
    t2 = time.monotonic()
    full = phase_corpus_full(torch, kernels, fused, m)
    _log(f"corpus phase: kernel holds {t1 - t0:.1f} s, small gates "
         f"{t2 - t1:.1f} s, full runs {time.monotonic() - t2:.1f} s")
    for (tag, engine, wave_kernel), r in {**gates, **full}.items():
        path = "kernels" if wave_kernel else "torch stages"
        _log(f"  {tag:32s} {engine:8s} {path:13s} {r['sec']:8.3f} s  peak "
             f"{r['peak']:>12d} B  waves {r['waves']:6d}  {r['counts']}")
    return holds, gates, full


def _corpus_rows(holds, gates, full):
    """The kernels line's rows of the corpus phase: kernels 2 and 3 on each
    plain model, each with its launches in the model's largest run on
    that kernel (the 4x3 puzzle's sender kernel: its cut run's)."""
    src, pallas = SRC, PALLAS
    rows = []
    for tag, source, sym, run, runs in (
            ("puzzle 4x3", "wave_sliding_puzzle.cu", False, "puzzle 4x3",
             full),
            ("increment 16", "wave_increment.cu", False, "increment 16",
             gates),
            ("increment 16", "wave_increment.cu", True, "increment 16 sym",
             gates),
            ("increment_lock 8", "wave_increment_lock.cu", False,
             "increment_lock 8", gates),
            ("increment_lock 8", "wave_increment_lock.cu", True,
             "increment_lock 8 sym", gates),
            ("linear_equation", "wave_linear_equation.cu", False,
             "linear_equation 2 4 7", gates),
            ("dgraph 0", "wave_dgraph.cu", False, "dgraph 0 odd", gates)):
        name = tag + (" sym" if sym else "")
        rows.append(_kernel_row(
            f"wave_megakernel[{name}]", src + source, pallas + "380",
            runs[run, "fused", True]["launches"]["wave_megakernel"], 0,
            holds[tag, "sym" if sym else "plain"]))
        if not sym:
            rows.append(_kernel_row(
                f"sender_megakernel[{name}]", src + source, pallas + "451",
                runs[_cut(run) if run in CUTS else run, "sharded", True][
                    "launches"]["sender_megakernel"],
                0, holds[tag, "sender"][(False, True)]))
    return rows


# -- The actor models: ping-pong and viewstamped replication -----------------


#: ping-pong on a lossy, duplicating network at max_nat 11 and 26 network
#: slots (2 max_nat + 4, as JAX's run at 9 took 22; the CUDA instance's
#: most): 2^(2m+2) - 2 unique and 2^(2m+2) (m + 1/4) + 1 states, the
#: pattern of max_nat 5, 7 and 9 (4,094; 65,534 / 475,137; 1,048,574 /
#: 9,699,329: the JAX package's counts, the port's at 5 and 9 in its
#: tests). A count off the pattern is reported, not forced: the runs are
#: held to each other.
PP_MAX_NAT, PP_SLOTS = 11, 26
PP_PATTERN = (2 ** 24 - 2, 2 ** 24 * 45 // 4 + 1)
#: VSR at 4 replicas (the most the envelope holds), max_view 1, 48 network
#: slots (the default 32 overflows): JAX's fused engine's counts on the CPU
VSR41 = (685_650, 7_579_993)
VSR_SLOTS = 48
PP_FOUND = ["can reach max", "must exceed max", "must reach max"]
VSR_FOUND = ["can commit", "commit survives view change",
             "view change completes"]
#: the states the kernels' mid-run arenas are taken at (frontiers wider
#: than a batch)
PP_MID, VSR_MID = 2_000_000, 1_000_000


def _actor_modules():
    from stateright_tpu_torch.models.pingpong import PingPongSys
    from stateright_tpu_torch.models.vsr import VsrSys
    return PingPongSys, VsrSys


def phase_actor_kernels(torch, wave_mod, table_mod, PingPongSys, VsrSys):
    """Kernels 2 and 3 on both actor models' CUDA steps (on
    ``csrc/models/actor_net.cuh``) against their plain versions at full
    width: the last 16,384 rows of a mid-run arena of each card
    configuration (ping-pong at max_nat 11 on 26 slots, lossy and
    duplicating: 31 lanes, 52 actions; VSR at 4 replicas on 48 slots: 82
    lanes, 52 actions), against its engine's table and with its engine's
    scratch, then as 4 shards of 4,096 and ragged 3 x 4,095 (the scratch
    clean after each)."""
    out = {}
    for tag, build, target in (
            ("pingpong 11", lambda: PingPongSys(
                PP_MAX_NAT, lossy=True, net_slots=PP_SLOTS), PP_MID),
            ("vsr 4", lambda: VsrSys(4, 1, net_slots=VSR_SLOTS), VSR_MID)):
        mid = (build().checker().target_state_count(target)
               .spawn_cuda_bfs(device="cuda:0", batch_size=BATCH).join())
        dm, layout = mid._dm, mid._layout
        store = _last_rows(mid, BATCH)
        valid = torch.ones(BATCH, dtype=torch.bool, device="cuda")
        out[tag, "plain"] = _wave_case(
            torch, wave_mod, table_mod, dm, store, valid, layout, mid._table,
            False, tag, scratch=mid._scratch)
        out[tag, "sender"] = phase_sender_kernel(
            torch, wave_mod, table_mod, dm, store, layout, tag, syms=(False,))
        del mid, store
    return out


#: phase 11's small configurations: (tag, checker, counts)
ACTOR_CONFIGS = (
    ("pingpong 1 lossy", _build("pingpong", 1, lossy=True), (14, 21)),
    ("pingpong 5 lossy", _build("pingpong", 5, lossy=True), (4_094, 21_505)),
    ("pingpong 5 perfect", _build("pingpong", 5, duplicating=False),
     (11, 11)),
    ("pingpong 3 history", _build("pingpong", 3, True, lossy=True),
     (254, 833)),
    ("vsr 2", _build("vsr", 2, 1), (63, 169)))


def phase_actor_gates(torch, kernels, fused, PingPongSys, VsrSys):
    """The small configurations to their ends on the fused, the classic
    and the sharded engine (4 shards), each on the torch stages and on the
    kernels, exact against their counts and against a CPU run at the same
    batch (``_corpus_cpu``): ping-pong's 14 (lossy, max_nat 1), 4,094
    (lossy and duplicating, 5), 11 (a perfect network, 5) and its history
    form at max_nat 3 (254 / 833, JAX's); VSR at 2 replicas, 63 / 169."""
    runs = {}
    for tag, build, want in ACTOR_CONFIGS:
        cpu = _corpus_cpu(build, 1024, "found")
        for engine in ("fused", "classic", "sharded"):
            for wave_kernel in (False, True):
                runs[tag, engine, wave_kernel] = _card_run(
                    torch, kernels, fused, tag, build, engine, 1024, want,
                    sorted(cpu[engine].discoveries()), cpu[engine],
                    wave_kernel)
    return runs


def phase_actor_full(torch, kernels, fused, PingPongSys, VsrSys):
    """The full-width runs (``_whole_and_cut``): ping-pong at max_nat 11
    (lossy, duplicating, 26 slots), its counts against the pattern
    (reported), "delta within 1" held and "must reach max" found; VSR at
    4 replicas, max_view 1 (48 slots), exactly 685,650 / 7,579,993,
    "agreement" held and the three sometimes properties found; each to its
    end on the fused wave kernel and cut on the six paths."""
    configs = (
        ("pingpong 11", lambda: PingPongSys(
            PP_MAX_NAT, lossy=True, net_slots=PP_SLOTS).checker(), None,
         PP_FOUND),
        ("vsr 4", lambda: VsrSys(4, 1, net_slots=VSR_SLOTS).checker(),
         VSR41, VSR_FOUND))
    runs = {}
    for tag, build, want, found in configs:
        runs.update(_whole_and_cut(torch, kernels, fused, tag, build, want,
                                   found))
        if tag == "pingpong 11":
            got = runs[tag, "fused", True]["counts"]
            _log(f"pingpong 11: {got}, the pattern's {PP_PATTERN}: "
                 + ("equal" if got == PP_PATTERN else "DIFFERENT"))
    return runs


def phase_actors(torch, kernels, fused, wave_mod, table_mod):
    """The actor models on the card: kernels 2 and 3 held to their plain
    versions (``phase_actor_kernels``), the small configurations against
    the CPU (``phase_actor_gates``) and the full-width runs
    (``phase_actor_full``)."""
    PingPongSys, VsrSys = _actor_modules()
    t0 = time.monotonic()
    holds = phase_actor_kernels(torch, wave_mod, table_mod, PingPongSys,
                                VsrSys)
    t1 = time.monotonic()
    gates = phase_actor_gates(torch, kernels, fused, PingPongSys, VsrSys)
    t2 = time.monotonic()
    full = phase_actor_full(torch, kernels, fused, PingPongSys, VsrSys)
    _log(f"actor phase: kernel holds {t1 - t0:.1f} s, small gates "
         f"{t2 - t1:.1f} s, full runs {time.monotonic() - t2:.1f} s")
    for (tag, engine, wave_kernel), r in {**gates, **full}.items():
        path = "kernels" if wave_kernel else "torch stages"
        c = r["counts"]
        _log(f"  {tag:28s} {engine:8s} {path:13s} {r['sec']:8.3f} s  "
             f"{c[1] / r['sec']:14.1f} states/s  peak {r['peak']:>12d} B  "
             f"waves {r['waves']:5d}  {c}")
    return holds, full


def _actor_rows(holds, full):
    """The kernels line's rows of the actor phase: kernels 2 and 3 on each
    actor model, kernel 2 with its launches in the model's run to its end
    on the fused wave kernel, kernel 3 in its cut run on the sender
    kernel."""
    rows = []
    for tag, source in (("pingpong 11", "wave_pingpong.cu"),
                        ("vsr 4", "wave_vsr.cu")):
        rows.append(_kernel_row(
            f"wave_megakernel[{tag}]", SRC + source, PALLAS + "380",
            full[tag, "fused", True]["launches"]["wave_megakernel"], 0,
            holds[tag, "plain"]))
        rows.append(_kernel_row(
            f"sender_megakernel[{tag}]", SRC + source, PALLAS + "451",
            full[_cut(tag), "sharded", True]["launches"][
                "sender_megakernel"], 0,
            holds[tag, "sender"][(False, True)]))
    return rows


# -- The classic sharded engine ----------------------------------------------


def _sharded_classic_modules():
    from stateright_tpu_torch import Property
    from stateright_tpu_torch import sharded as sharded_mod
    from stateright_tpu_torch.models.paxos import PaxosSys
    from stateright_tpu_torch.models.twopc import RmState, TwoPhaseSys

    class HostAbort(TwoPhaseSys):
        """2pc with a property the host evaluates (found)."""

        def properties(self):
            return super().properties() + [Property.sometimes(
                "host-only abort", lambda _, s: all(
                    r is RmState.ABORTED for r in s.rm_state))]

    class HostPaxos(PaxosSys):
        """paxos with a property the host evaluates on every popped row
        (it always holds)."""

        def properties(self):
            return super().properties() + [
                Property.always("host-only true", lambda _, s: True)]

    return sharded_mod, TwoPhaseSys, PaxosSys, HostAbort, HostPaxos


def _sharded_classic_same(a, b, tag: str) -> None:
    """Two classic sharded runs equal in counts, discovery chains, parent
    maps and every wave's log fields."""
    _classic_same(a, b, tag, fields=("bucket", "rows", "out_rows", "novel",
                                     "overflow", "successors", "candidates",
                                     "capacity", "load_factor", "epoch"))


def phase_sharded_classic_small(torch):
    """The classic sharded engine on the card against the same run on
    the CPU, at ``SHARDS`` shards and at a ragged 3, each on the torch
    stages and on the sender kernel: 2pc 3 (``fused=False``), 2pc 4 with a
    visitor from a table of 2^12 slots (the builder's fallback, every
    state visited once, a rehash on the card), 2pc 5 with symmetry and
    paxos 1 with a property the host evaluates (the fallback, warned):
    counts, discovery chains, parent maps and waves equal; 2pc 3 with a
    host property found; 2pc 4 with every wave at an output rung of 8
    rows (regathers, each a graph of its own) against the ladder off; the
    refusals of ``fused=True`` with a visitor and of ``pipeline=True``."""
    import warnings

    (sharded_mod, TwoPhaseSys, PaxosSys, HostAbort,
     HostPaxos) = _sharded_classic_modules()
    from stateright_tpu_torch.fused import FusedUnsupported

    visits = []

    def run(build, dev, n, **kw):
        c = build().spawn_cuda_bfs(mesh=[dev] * n, **kw).join()
        if not isinstance(c, sharded_mod.ShardedCudaBfsChecker):
            raise AssertionError(f"{type(c).__name__} is not the classic "
                                 "sharded engine")
        return c

    configs = (
        ("2pc 3", lambda: TwoPhaseSys(3).checker(), (288, 1146),
         dict(fused=False)),
        ("2pc 4 visitor", lambda: TwoPhaseSys(4).checker().visitor(
            lambda _, path: visits.append(len(path.fingerprints))),
         (1568, 8258), dict(table_capacity=1 << 12)),
        ("2pc 5 sym", lambda: TwoPhaseSys(5).checker().symmetry(),
         (314, 2048), dict(fused=False)),
        ("paxos 1 host", lambda: HostPaxos(1).checker(), (265, 482), {}),
        ("2pc 3 host", lambda: HostAbort(3).checker(), None, {}))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for n in (SHARDS, 3):
            for tag, build, want, kw in configs:
                visits.clear()
                cpu = run(build, "cpu", n, batch_size=64, **kw)
                for wave_kernel in (False, True):
                    c = run(build, "cuda:0", n, batch_size=64,
                            wave_kernel=wave_kernel, **kw)
                    t = f"{tag} sharded classic n={n} {c.kernel_path()}"
                    got = (c.unique_state_count(), c.state_count())
                    if want and got != want:
                        raise AssertionError(f"{t}: {got} != {want}")
                    _sharded_classic_same(c, cpu, t)
                    s = c.scheduler_stats()
                    _log(f"{t}: unique={got[0]} states={got[1]}, {c.waves} "
                         f"waves, {c.rehashes} rehashes, rungs "
                         f"{s['succ_ladder']['out_rows_dispatches']}, graphs "
                         f"{s['graphs']}; chains, parent map and waves equal "
                         "to the CPU run's")
                if tag == "2pc 4 visitor":
                    if len(visits) != 3 * 1568 or not c.rehashes:
                        raise AssertionError(
                            f"{tag}: {len(visits)} visits, {c.rehashes} "
                            "rehashes")
                if tag == "2pc 3 host" and "host-only abort" not in _chains(c):
                    raise AssertionError("the host property was not found")

    try:
        TwoPhaseSys(3).checker().visitor(lambda *_: None).spawn_cuda_bfs(
            mesh=["cuda:0"] * SHARDS, fused=True)
    except FusedUnsupported:
        pass
    else:
        raise AssertionError("fused=True with a visitor did not raise")
    try:
        TwoPhaseSys(3).checker().spawn_cuda_bfs(mesh=["cuda:0"] * SHARDS,
                                                pipeline=True)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("a sharded pipeline=True did not raise")
    _log("sharded: fused=True with a visitor raises FusedUnsupported, "
         "pipeline=True raises NotImplementedError")

    cls = sharded_mod.ShardedCudaBfsChecker
    off = run(lambda: TwoPhaseSys(4).checker(), "cpu", SHARDS, batch_size=64,
              fused=False, succ_ladder=False)
    had = "_pick_out_rows" in vars(cls)
    cls._pick_out_rows = lambda self, B: (
        8 if self._succ_ladder_on else self._succ_full_rows(B))
    try:
        for wave_kernel in (False, True):
            c = run(lambda: TwoPhaseSys(4).checker(), "cuda:0", SHARDS,
                    batch_size=64, fused=False, wave_kernel=wave_kernel)
            s = c.scheduler_stats()
            regathers = s["succ_ladder"]["overflow_redispatches"]
            if (not regathers or c._parent_map() != off._parent_map()
                    or (c.unique_state_count(), c.state_count())
                    != (1568, 8258)):
                raise AssertionError(f"sharded 2pc 4 at rung 8 "
                                     f"({c.kernel_path()}): {regathers} "
                                     "regathers")
            _log(f"sharded 2pc 4 with every wave at a rung of 8 rows "
                 f"({c.kernel_path()}): {regathers} regathers of {c.waves} "
                 f"waves, graphs {s['graphs']}; counts and parent map equal "
                 "to the ladder-off run's")
    finally:
        if not had:
            del cls._pick_out_rows


class _ShardedPoint:
    """A point of a mid-run classic sharded checker to time waves from:
    every shard queue (``queued`` rows each) and a copy of the table. ``wave`` launches one wave
    of the widest bucket through the checker's own launch, waits for its
    outputs on the slot's event and puts the queues and the table back,
    never processing them; the first two launches (a warm-up and a
    capture) run in ``__init__``, so every later one is a replay."""

    def __init__(self, torch, mid):
        self.torch, self.mid = torch, mid
        if mid._needs_growth():
            mid._grow_table()
        self.bucket = mid._buckets[-1]
        self.queued = [sum(len(b[1]) for b in q) for q in mid._queues]
        self._queues = [list(q) for q in mid._queues]
        self._table = mid._table.clone()
        for _ in range(2):
            self.wave()

    def key(self):
        mid = self.mid
        return (self.bucket, mid._capacity, mid._pick_out_rows(self.bucket),
                mid._owner_map.epoch)

    def batch(self):
        """The next wave's stacked batch as the queues hold it, on the
        card: ``(store int32[n, B, Wp], valid bool[n, B])``."""
        import numpy as np

        mid, B = self.mid, self.bucket
        n, wp = mid._n, mid._layout.packed_width
        up = np.zeros((n * B, wp), np.uint32)
        taken = np.zeros(n, np.int64)
        for i, q in enumerate(self._queues):
            taken[i] = mid._take_batch(deque(q), B, up[i * B:(i + 1) * B],
                                       np.zeros(B, np.uint64),
                                       np.zeros(B, np.uint32))
        store = self.torch.from_numpy(up.view(np.int32)).to(mid._device)
        valid = (self.torch.arange(B)[None, :]
                 < self.torch.from_numpy(taken)[:, None]).to(mid._device)
        return store.view(n, B, wp), valid

    def launch(self):
        return self.mid._dispatch_wave(self.bucket)

    def wait(self, wave):
        out = self.mid._fetch(wave)
        new = int(out[1][-self.mid._n:].sum())  # each shard's new rows
        self.rewind()
        return new

    def wave(self):
        return self.wait(self.launch())

    def rewind(self) -> None:
        mid = self.mid
        for q, saved in zip(mid._queues, self._queues):
            q.clear()
            q.extend(saved)
        mid._table.copy_(self._table)
        self.torch.cuda.synchronize()


def phase_sharded_classic_full(torch, kernels, config, model, want_counts,
                               want_found, wave_kernel, cut=None):
    """``model()`` to its end on the classic sharded engine (``SHARDS``
    shards of ``BATCH / SHARDS`` rows, graphs on), or cut at ``cut``
    states, the kernels' launch counts set to 0 just before and read just
    after: exactly ``want_counts``, the discoveries ``want_found`` and no
    counterexample (a cut run: at least ``cut`` states and fewer than
    ``want_counts``, and only discoveries of ``want_found``), the launches
    exact (the dedup kernel ``SHARDS`` times a wave on the owner side plus
    the rehash chunks; the sender kernel once a wave and once a regather
    with ``wave_kernel``); the run's seconds, waves, graphs, rungs,
    regathers, host us a wave, bytes down, peak device memory and parent
    log. Returns ``(chains, launches, run)``."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.monotonic()
    builder = model().checker()
    if cut is not None:
        builder = builder.target_state_count(cut)
    c = builder.spawn_cuda_bfs(
        mesh=["cuda:0"] * SHARDS, batch_size=BATCH // SHARDS, fused=False,
        wave_kernel=wave_kernel).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    unique, states = c.unique_state_count(), c.state_count()
    s = c.scheduler_stats()
    g = s["graphs"] or {"captures": 0, "replays": 0, "capture_sec": 0.0}
    ladder = s["succ_ladder"]
    waves = c.waves
    regathers = ladder["overflow_redispatches"]
    down = list(c.bytes_down)
    host = {k: v * 1e6 / waves for k, v in c.host_sec.items()}
    run = dict(sec=sec, waves=waves, captures=g["captures"],
               counts=(unique, states),
               replays=g["replays"], capture_sec=g["capture_sec"],
               rungs=ladder["out_rows_dispatches"], regathers=regathers,
               host_us=host, bytes_down=sum(down) / waves,
               bytes_down_max=max(down), peak=peak,
               log_bytes=c.parent_log_bytes(), rehashes=c.rehashes,
               chunks=c.rehash_chunks, capacity=c._capacity,
               load=max(c._shard_counts) / c._capacity)
    _log(f"{config} sharded classic ({c.kernel_path()}, {SHARDS} x "
         f"{BATCH // SHARDS}): unique={unique} states={states} sec={sec:.3f} "
         f"states/s={states / sec:.1f} waves={waves} rehashes={c.rehashes} "
         f"({c.rehash_chunks} chunks) capacity 2^"
         f"{c._capacity.bit_length() - 1} a shard (fullest "
         f"{run['load']:.3f} full) launches={launches} captures="
         f"{g['captures']} replays={g['replays']} capture_sec="
         f"{g['capture_sec']:.3f} rungs={ladder['out_rows_dispatches']} "
         f"regathers={regathers}; host us a wave: launch "
         f"{host['launch']:.1f}, processing {host['process']:.1f}, waiting "
         f"{host['wait']:.1f}; bytes down a wave {run['bytes_down']:.0f} "
         f"(most {max(down)}); peak device memory {peak} B; host parent log "
         f"{run['log_bytes']} B")
    # Each path rebuilt once: on this engine a link is a search of the
    # host's parent log.
    chains = _chains(c)
    if cut is not None:
        if not cut <= states < want_counts[1] or not set(
                chains) <= set(want_found):
            raise AssertionError(f"{config} sharded classic cut at {cut}: "
                                 f"{(unique, states)}, discoveries "
                                 f"{sorted(chains)}")
    else:
        if (unique, states) != want_counts:
            raise AssertionError(f"{config} sharded classic: "
                                 f"{(unique, states)} != {want_counts}")
        if sorted(chains) != want_found:
            raise AssertionError(f"{config} sharded classic discoveries: "
                                 f"{sorted(chains)}")
        c.assert_properties()
    want = {"dedup_and_insert": SHARDS * waves + c.rehash_chunks,
            "wave_megakernel": 0,
            "sender_megakernel": waves + regathers if wave_kernel else 0,
            "append_rows": 0}
    if launches != want:
        raise AssertionError(f"{config} sharded classic: kernel launches "
                             f"{launches}, expected {want}")
    if not g["replays"]:
        raise AssertionError(f"{config} sharded classic: no replay")
    return chains, launches, run


def _sharded_point_timing(torch, point, run, config) -> None:
    """One replayed wave under ``set_sync_debug_mode("error")``, three
    timed, one under ``torch.profiler``: the card's time a wave and its
    idle share of the full run's pace (``run``, updated)."""
    if not point.mid._graphs.has_graph(point.key()):
        raise AssertionError("no wave graph after two waves")
    torch.cuda.set_sync_debug_mode("error")
    try:
        wave = point.launch()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    new = point.wait(wave)
    _log(f"one replayed sharded classic wave of {SHARDS} x {point.bucket} "
         f"rows under set_sync_debug_mode('error'): no synchronisation, "
         f"{new} new rows")
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
    pace = run["sec"] * 1e3 / run["waves"]
    run.update(busy_ms=busy, nodes=nodes, pace_ms=pace,
               wave_ms=sum(w for _, w in steady) / len(steady),
               launch_us=sum(u for u, _ in steady) / len(steady))
    _log(f"{config} sharded classic steady wave from a point: launch "
         f"{run['launch_us']:.1f} us, launch to outputs on the host "
         f"{run['wave_ms']:.3f} ms; card busy {busy:.3f} ms a wave ({nodes} "
         f"kernels and memsets, torch.profiler); the full run's pace "
         f"{pace:.3f} ms a wave, so the card idles {1 - busy / pace:.1%} of "
         "it")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        _log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
             f"{e.key[:90]}")


def _sharded_holds(torch, wave_mod, table_mod, sharded_mod, point, tag):
    """Kernels 3 and 1 at this path's shapes, from a mid-run point's next
    wave: the sender kernel on its ``SHARDS`` x B rows (and ragged), and
    the dedup kernel on shard 0's received rows (``R = SHARDS * S``)
    against its table slice with the engine's scratch, each against its
    plain version, timed."""
    mid = point.mid
    store, valid = point.batch()
    n, B, wp = store.shape
    sk = phase_sender_kernel(torch, wave_mod, table_mod, mid._dm,
                             store.reshape(n * B, wp), mid._layout,
                             f"{tag} sharded classic", syms=(False,))
    front = sharded_mod.sharded_front(
        mid._dm, mid._mesh, store, valid, mid._layout, False, True, None,
        False)
    recv_dedup = front[3]
    k = _dedup_case(torch, table_mod, recv_dedup[0].contiguous(),
                    mid._table[0], f"{tag} sharded classic, shard 0's "
                    "received rows", scratch=mid._scratch)
    return sk[(False, True)], k


#: phase 12's runs cut at a state count (depth cuts to keep the script
#: inside its time: 2pc 10 on the torch stages when phase 13 came, on the
#: sender kernel when phase 14 did; phases 6 and 8 run its whole space on
#: the other engines)
SHARDED_CLASSIC_CUTS = {("2pc 10", False): 100_000_000,
                        ("2pc 10", True): 100_000_000}


def phase_sharded_classic(torch, kernels, wave_mod, table_mod):
    """Phase 12: the classic sharded engine's small gates against the CPU
    (``phase_sharded_classic_small``), then 2pc at 10 RMs and ``paxos
    check 3`` at ``SHARDS`` x 4,096 rows on the torch stages and on the
    sender kernel, exact (2pc 10 cut at ``SHARDED_CLASSIC_CUTS``' state
    count), the sender kernel's chains and counts the torch stages';
    from a mid-run point of each on each path, one replayed wave under
    ``set_sync_debug_mode("error")`` and the card's time a wave, and on
    the sender kernel's, kernels 3 and 1 held to their plain versions and
    timed at this path's shapes."""
    import functools as ft

    (sharded_mod, TwoPhaseSys, PaxosSys, _, _) = _sharded_classic_modules()
    t0 = time.monotonic()
    phase_sharded_classic_small(torch)
    t1 = time.monotonic()
    configs = {
        "2pc 10": (ft.partial(TwoPhaseSys, 10), (FULL_UNIQUE, FULL_STATES),
                   ["abort agreement", "commit agreement"], 20_000_000),
        "paxos 3": (ft.partial(PaxosSys, 3), (PAXOS_UNIQUE, PAXOS_STATES),
                    ["value chosen"], PAXOS_WAVE_AT)}
    runs, holds = {}, {}
    for config, (model, counts, found, mid_target) in configs.items():
        chains = {}
        for wave_kernel in (False, True):
            chains[wave_kernel], launches, run = _clocked(
                f"{config}, wave_kernel={wave_kernel}, the run",
                phase_sharded_classic_full, torch, kernels, config, model,
                counts, found, wave_kernel,
                SHARDED_CLASSIC_CUTS.get((config, wave_kernel)))
            runs[config, wave_kernel] = dict(launches=launches, run=run)
        got = [runs[config, w]["run"]["counts"] for w in (False, True)]
        if chains[False] != chains[True] or got[0] != got[1]:
            raise AssertionError(f"{config} sharded classic: the sender "
                                 f"kernel's chains or counts {got[1]} "
                                 f"differ from the torch stages' {got[0]}")
        for wave_kernel in (False, True):
            t_point = time.monotonic()
            mid = (model().checker().target_state_count(mid_target)
                   .spawn_cuda_bfs(mesh=["cuda:0"] * SHARDS,
                                   batch_size=BATCH // SHARDS, fused=False,
                                   wave_kernel=wave_kernel).join())
            point = _ShardedPoint(torch, mid)
            _log(f"{config} sharded classic point ({mid.kernel_path()}) at "
                 f"{mid.state_count()} states: shard queues of "
                 f"{point.queued} rows")
            _log(f"{config}, wave_kernel={wave_kernel}, the point: "
                 f"{time.monotonic() - t_point:.1f} s")
            if wave_kernel:
                holds[config] = _clocked(
                    f"{config}, the kernel holds", _sharded_holds, torch,
                    wave_mod, table_mod, sharded_mod, point, config)
            _clocked(f"{config}, wave_kernel={wave_kernel}, the timed waves",
                     _sharded_point_timing, torch, point,
                     runs[config, wave_kernel]["run"],
                     f"{config}, {mid.kernel_path()}")
            del point, mid
    _log(f"sharded classic phase: small gates {t1 - t0:.1f} s, full runs "
         f"and points {time.monotonic() - t1:.1f} s")
    for (config, wave_kernel), r in runs.items():
        run = r["run"]
        line = (f"  {config:8s} {'sender kernel' if wave_kernel else 'torch stages':13s}"
                f" {run['sec']:8.3f} s {run['waves']:5d} waves "
                f"host us a wave {sum(run['host_us'].values()):8.1f} peak "
                f"{run['peak']:>12d} B")
        if "busy_ms" in run:
            line += (f"; card {run['busy_ms']:.3f} ms a wave of "
                     f"{run['pace_ms']:.3f}, idle "
                     f"{1 - run['busy_ms'] / run['pace_ms']:.1%}")
        _log(line)
    return holds, runs


def _sharded_classic_rows(holds, runs):
    """The kernels line's rows of phase 12: kernels 3 and 1 on 2pc 10 and
    paxos 3 at the classic sharded path's shapes, with their launches in
    that model's run on the sender kernel (kernel 3) and on the torch
    stages (kernel 1)."""
    rows = []
    for config, source in (("2pc 10", "wave_twopc.cu"),
                           ("paxos 3", "sender_paxos.cu")):
        sender, dedup = holds[config]
        rows.append(_kernel_row(
            f"sender_megakernel[sharded classic {config}]", SRC + source,
            PALLAS + "451",
            runs[config, True]["launches"]["sender_megakernel"], 0, sender))
        rows.append(_kernel_row(
            f"dedup_and_insert[sharded classic {config}]", SRC + "table.cu",
            PALLAS + "256",
            runs[config, False]["launches"]["dedup_and_insert"],
            dedup["max_abs_err"], dedup))
    return rows


# -- Phase 13: the matmul expand ----------------------------------------------

#: the full widths the matmul gate admits (it refuses 2pc 8 and increment
#: 16): each configuration's pinned verdict, its counts and the states its
#: mid-run point stops at (a frontier wider than a batch)
MATMUL_MODELS = {
    "2pc 7": ("regular (12 key groups, 55160 macs/row)",
              (296_448, 2_744_706), 400_000),
    "increment_lock 8": ("regular (24 key groups, 66176 macs/row)",
                         (438_401, 438_401), 150_000)}
#: the engines phase 13 runs each configuration on
MATMUL_ENGINES = ("fused", "classic", "sharded", "sharded_classic")


def _matmul_modules():
    from stateright_tpu_torch import matmul_wave
    from stateright_tpu_torch.models.increment_lock import IncrementLockModel
    from stateright_tpu_torch.models.twopc import TwoPhaseSys
    builds = {"2pc 7": lambda: TwoPhaseSys(7).checker(),
              "increment_lock 8": lambda: IncrementLockModel(8).checker()}
    return matmul_wave, builds, TwoPhaseSys


def _plan_vs_step(torch, wave_mod, table_mod, dm, store, valid, layout,
                  table, scratch, plan, tag):
    """Kernels 2 and 3 in plan form against their step forms on the same
    inputs (the step form is the model's own CUDA step): every output
    equal, the tables equal as sets, the scratch clean; plain and with
    symmetry, the sender on ``SHARDS`` shards with local dedup. Logs the
    wave kernel's step form's time (``_breakdown``) at this shape."""
    names = ("succ_store", "path_fps", "sflat", "new_mask", "cand_mask",
             "new_count", "cand_count", "full")
    for use_sym in (False, True):
        t_a, t_b = table.clone(), table.clone()
        got = wave_mod.wave_megakernel(dm, store, valid, t_a, use_sym,
                                       layout, scratch=scratch, plan=plan)
        want = wave_mod.wave_megakernel(dm, store, valid, t_b, use_sym,
                                        layout, scratch=scratch)
        torch.cuda.synchronize()
        for name, a, b in zip(names, got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"wave kernel ({tag}, sym={use_sym}): "
                                     f"the plan form differs from the step "
                                     f"form on {name}")
        if not torch.equal(torch.sort(t_a).values, torch.sort(t_b).values):
            raise AssertionError(f"wave kernel ({tag}): the plan form's "
                                 "table differs from the step form's")
        _check_clean(torch, scratch, f"the wave kernel ({tag}, plan/step)")
        del t_a, t_b, got, want
    # The step form's time at the same shape, beside the plan form's.
    step_ms, _ = _breakdown(
        torch, functools.partial(wave_mod.wave_megakernel, scratch=scratch),
        5, lambda: (dm, store, valid, table.clone(), False, layout))
    B, wp = store.shape[0] // SHARDS, layout.packed_width
    sstore = store.reshape(SHARDS, B, wp).contiguous()
    svalid = valid.reshape(SHARDS, B).contiguous()
    fn, sscratch = _scratch(torch, table_mod, wave_mod.sender_megakernel,
                            SHARDS * B * dm.max_fanout, SHARDS)
    for use_sym in (False, True):
        args = (dm, sstore, svalid, use_sym, layout, True)
        got, want = fn(*args, plan=plan), fn(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("succ_store", "dedup_fps", "path_fps",
                               "sflat", "send_mask"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"sender kernel ({tag}, sym={use_sym}):"
                                     f" the plan form differs from the step "
                                     f"form on {name}")
        _check_clean(torch, sscratch, f"the sender kernel ({tag}, plan/step)")
    _log(f"{tag}: kernels 2 and 3 in plan form == their step forms (plain "
         f"and with symmetry; the sender at {SHARDS} x {B}); the wave "
         f"kernel's step form {step_ms:.4f} ms on the card at this shape")


def _matmul_holds(torch, wave_mod, table_mod, matmul_wave, tag, build,
                  reason, mid_target):
    """The gate's verdict on the card, then kernels 2 and 3 in plan form at
    full width (the next 16,384 rows of a mid-run arena, against its
    engine's table with its engine's scratch): against their plain
    versions, timed (the wave kernel plain and with symmetry, the sender
    on ``SHARDS`` shards with local dedup on and off, and ragged), and
    against their step forms."""
    dm = build()._model.device_model()
    t0 = time.monotonic()
    cls = matmul_wave.classify(dm, "cuda:0")
    _log(f"{tag}: classified on the card in {time.monotonic() - t0:.1f} s: "
         f"{cls.reason}; tables {cls.plan and cls.plan.table_bytes} B as "
         f"float halves")
    if cls.reason != reason:
        raise AssertionError(f"{tag}: {cls.reason!r}, not {reason!r}")
    plan = cls.plan
    mid = (build().target_state_count(mid_target)
           .spawn_cuda_bfs(device="cuda:0", batch_size=BATCH,
                           wave_kernel=True, wave_matmul=True).join())
    if mid._tail - mid._head < BATCH:
        raise AssertionError(f"mid-run {tag} frontier of "
                             f"{mid._tail - mid._head} rows is narrower "
                             f"than {BATCH}")
    dm, layout = mid._dm, mid._layout
    store = mid._vecs[mid._head:mid._head + BATCH].clone()
    valid = torch.ones(BATCH, dtype=torch.bool, device="cuda")
    out = {}
    for sub, use_sym in (("plain", False), ("sym", True)):
        out[(tag, sub)] = _wave_case(
            torch, wave_mod, table_mod, dm, store, valid, layout,
            mid._table, use_sym, f"{tag}, {sub}, plan form",
            scratch=mid._scratch, plan=plan)
    out[(tag, "sender")] = phase_sender_kernel(
        torch, wave_mod, table_mod, dm, store, layout, f"{tag}, plan form",
        syms=(False,), plan=plan)[(False, True)]
    _plan_vs_step(torch, wave_mod, table_mod, dm, store, valid, layout,
                  mid._table, mid._scratch, plan, tag)
    return out


def _matmul_spawn(engine, **kw):
    """``spawn_cuda_bfs``'s knobs for ``engine`` at full width: ``_spawn_kw``'s
    engines and the classic sharded one (``SHARDS`` shards)."""
    if engine == "sharded_classic":
        return dict(mesh=["cuda:0"] * SHARDS, fused=False,
                    batch_size=BATCH // SHARDS, **kw)
    return _spawn_kw("cuda:0", engine, BATCH, **kw)


def _matmul_run(torch, kernels, fused, tag, build, engine, wave_kernel,
                wave_matmul, want):
    """``build()``'s checker to its end on the card on ``engine`` with the
    two knobs, the kernels' launch counts set to 0 just before and read
    just after: the counts ``want`` (where given), ``kernel_path()`` with
    ``+matmul`` exactly when the knob is on, the ``wave_matmul`` stats and
    every dispatch's ``expand_impl``, the launches exact. Returns the
    run's numbers and its discoveries' chains."""
    for fn in kernels.values():
        fn.launches = 0
    spawn = _matmul_spawn(engine, wave_kernel=wave_kernel,
                          wave_matmul=wave_matmul)
    t0 = time.monotonic()
    c = build().spawn_cuda_bfs(**spawn).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    got = (c.unique_state_count(), c.state_count())
    path = c.kernel_path()
    where = f"{tag}, {engine}, {path}"
    regathers = (c.scheduler_stats()["succ_ladder"]["overflow_redispatches"]
                 if engine == "sharded_classic" else 0)
    _log(f"{where}: unique={got[0]} states={got[1]} sec={sec:.3f} "
         f"states/s={got[1] / sec:.1f} waves={c.waves} launches={launches}")
    if want is not None and got != want:
        raise AssertionError(f"{where}: {got} != {want}")
    base = {(False, "sharded"): "dedup_kernel",
            (False, "sharded_classic"): "dedup_kernel",
            (True, "sharded"): "sender_kernel",
            (True, "sharded_classic"): "sender_kernel"}.get(
        (wave_kernel, engine), "megakernel" if wave_kernel else
        "dedup_kernel")
    if path != base + ("+matmul" if wave_matmul else ""):
        raise AssertionError(f"{where}: kernel_path() is not {base}"
                             f"{'+matmul' if wave_matmul else ''}")
    impl = "matmul" if wave_matmul else "step"
    stats = c.scheduler_stats()["wave_matmul"]
    if (stats["active"], stats["expand_impl"]) != (wave_matmul, impl) or any(
            e["expand_impl"] != impl for e in c.dispatch_log):
        raise AssertionError(f"{where}: wave_matmul stats {stats}")
    if engine in ("fused", "sharded"):
        _check_launches(fused, c, launches, **spawn)
    else:
        n = SHARDS if engine == "sharded_classic" else 1
        want_l = {"dedup_and_insert": c.rehash_chunks + (
            n * c.waves if n > 1 or not wave_kernel else 0),
            "wave_megakernel": c.waves if wave_kernel and n == 1 else 0,
            "sender_megakernel": (c.waves + regathers
                                  if wave_kernel and n > 1 else 0),
            "append_rows": 0}
        if launches != want_l:
            raise AssertionError(f"{where}: kernel launches {launches}, "
                                 f"expected {want_l}")
    chains = {name: (p.fingerprints, [repr(a) for a in p.into_actions()])
              for name, p in c.discoveries().items()}
    return dict(sec=sec, launches=launches, waves=c.waves, counts=got,
                chains=chains)


def _matmul_runs(torch, kernels, fused, tag, build, want):
    """``tag`` to its end on every engine: with the knob off on the
    kernels, then with it on, on the torch stages and on the kernels; each
    knob-on run's counts and discoveries' chains equal to its engine's
    knob-off run's."""
    runs = {}
    for engine in MATMUL_ENGINES:
        ref = runs[tag, engine, "off"] = _matmul_run(
            torch, kernels, fused, tag, build, engine, True, False, want)
        for wave_kernel in (False, True):
            r = runs[tag, engine, wave_kernel] = _matmul_run(
                torch, kernels, fused, tag, build, engine, wave_kernel, True,
                want)
            if (r["counts"], r["chains"]) != (ref["counts"], ref["chains"]):
                raise AssertionError(
                    f"{tag}, {engine}, wave_kernel={wave_kernel}: the knob "
                    f"on found {sorted(r['chains'])} in {r['counts']}, off "
                    f"{sorted(ref['chains'])} in {ref['counts']}")
    return runs


def _matmul_sym(torch, kernels, fused, TwoPhaseSys):
    """2pc 5 with symmetry on every engine's kernels, the knob on against
    off: 314 unique, equal counts and chains."""
    def build():
        return TwoPhaseSys(5).checker().symmetry()

    for engine in MATMUL_ENGINES:
        off, on = (_matmul_run(torch, kernels, fused, "2pc 5 sym", build,
                               engine, True, wave_matmul, None)
                   for wave_matmul in (False, True))
        if on["counts"][0] != 314 or (on["counts"], on["chains"]) != (
                off["counts"], off["chains"]):
            raise AssertionError(f"2pc 5 sym, {engine}: {on['counts']}, "
                                 f"off {off['counts']}")


def _matmul_tf32(torch, kernels, fused, build, want, ref):
    """2pc 7 on the fused torch stages with the knob on under the settings
    that let float32 matmuls run in TF32: exact counts and the knob-off
    run's chains (``ref``)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        r = _matmul_run(torch, kernels, fused, "2pc 7 under TF32", build,
                        "fused", False, True, want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
    if r["chains"] != ref["chains"]:
        raise AssertionError("2pc 7 under TF32: the chains differ")
    _log("2pc 7 under TF32 settings: exact")


def phase_matmul(torch, kernels, fused, wave_mod, table_mod):
    """Phase 13: the matmul expand on the card (see the usage text)."""
    matmul_wave, builds, TwoPhaseSys = _matmul_modules()
    holds, runs = {}, {}
    for tag, (reason, want, mid_target) in MATMUL_MODELS.items():
        holds.update(_clocked(f"{tag}'s kernel holds", _matmul_holds, torch,
                              wave_mod, table_mod, matmul_wave, tag,
                              builds[tag], reason, mid_target))
        runs.update(_clocked(f"{tag}'s runs", _matmul_runs, torch, kernels,
                             fused, tag, builds[tag], want))
    _clocked("2pc 5 with symmetry", _matmul_sym, torch, kernels, fused,
             TwoPhaseSys)
    _clocked("2pc 7 under TF32", _matmul_tf32, torch, kernels, fused,
             builds["2pc 7"], MATMUL_MODELS["2pc 7"][1],
             runs["2pc 7", "fused", "off"])
    return holds, runs


def _matmul_rows(holds, runs):
    """The kernels line's rows of phase 13: kernels 2 and 3 in plan form on
    each configuration, their launches those of its knob-on kernel runs
    (the wave kernel's on the fused and classic engines, the sender's on
    both sharded ones)."""
    rows = []
    for tag, source in (("2pc 7", "wave_twopc.cu"),
                        ("increment_lock 8", "wave_increment_lock.cu")):
        wave_l = sum(runs[tag, e, True]["launches"]["wave_megakernel"]
                     for e in ("fused", "classic"))
        send_l = sum(runs[tag, e, True]["launches"]["sender_megakernel"]
                     for e in ("sharded", "sharded_classic"))
        rows += [
            _kernel_row(f"wave_megakernel[{tag} plan]", SRC + source,
                        PALLAS + "380", wave_l, 0, holds[tag, "plain"]),
            _kernel_row(f"wave_megakernel[{tag} plan sym]", SRC + source,
                        PALLAS + "380", wave_l, 0, holds[tag, "sym"]),
            _kernel_row(f"sender_megakernel[{tag} plan]", SRC + source,
                        PALLAS + "451", send_l, 0, holds[tag, "sender"])]
    return rows


# -- Kernels 2 and 3 at every model size -------------------------------------


#: the batch of the runs that give the actor models' rows (rows of 31 to 98
#: whole words, 36 to 68 actions): their sharded runs at full width cost
#: most of the phase
WIDE = dict(batch=4096)
#: the sizes phase 14 holds kernels 2 and 3 at (both ends of each range the
#: entry points hold, and one size of each capacity class): (tag, the
#: model's module and system, its arguments, the state count its runs stop
#: at (None: to the end), symmetry held, spawn knobs of its runs). A run
#: that would pass its network's slots (ABD 1/7 overflows its 8 past about
#: 200 states) stops short of it at a small batch.
SIZES = (
    ("increment 1", "increment", (1,), None, True, {}),
    ("increment 3", "increment", (3,), None, True, {}),
    ("increment 5", "increment", (5,), None, True, {}),
    ("increment 12", "increment", (12,), None, True, {}),
    ("increment_lock 1", "increment_lock", (1,), None, True, {}),
    ("increment_lock 3", "increment_lock", (3,), None, True, {}),
    ("increment_lock 5", "increment_lock", (5,), None, True, {}),
    ("increment_lock 6", "increment_lock", (6,), None, True, {}),
    ("increment_lock 12", "increment_lock", (12,), 60_000, True, {}),
    ("increment_lock 16", "increment_lock", (16,), 60_000, True, {}),
    ("puzzle 2x2", "sliding_puzzle", (2, 2), None, False, {}),
    ("puzzle 3x2", "sliding_puzzle", (3, 2), None, False, {}),
    ("puzzle 2x4", "sliding_puzzle", (2, 4), None, False, {}),
    ("puzzle 3x4", "sliding_puzzle", (3, 4), 60_000, False, {}),
    ("puzzle 4x4", "sliding_puzzle", (4, 4), 60_000, False, {}),
    ("single_copy 1/1", "single_copy", (1, 1), None, True, {}),
    ("single_copy 3/2", "single_copy", (3, 2), None, True, {}),
    ("single_copy 2/6", "single_copy", (2, 6), None, True, {}),
    ("single_copy 1/7", "single_copy", (1, 7), None, True, {}),
    ("single_copy 4/4", "single_copy", (4, 4), None, True, {}),
    ("abd 1/1", "abd", (1, 1), None, False, {}),
    ("abd 2/4", "abd", (2, 4), 60_000, False, {}),
    ("abd 3/3", "abd", (3, 3), 60_000, False, {}),
    ("abd 4/4", "abd", (4, 4), 60_000, False, {}),
    ("abd 1/7", "abd", (1, 7), 200, False, dict(batch=16)),
    ("pingpong 32", "pingpong", (11, False, 32), 100_000, False, WIDE),
    ("pingpong 64", "pingpong", (11, False, 64), 100_000, False, WIDE),
    ("vsr 1/8", "vsr", (1, 1, 8), None, False, WIDE),
    ("vsr 2/32", "vsr", (2, 2, 32), None, False, WIDE),
    ("vsr 3/48", "vsr", (3, 3, 48), 80_000, False, WIDE),
    ("vsr 4/64", "vsr", (4, 1, 64), 110_000, False, WIDE))
#: the sizes whose plan form (``wave_matmul``) phase 14 holds too
PLAN_SIZES = ("increment 3", "increment_lock 3", "increment_lock 5")
#: each model's sources: the wave kernel's and the sender kernel's
SIZE_SOURCES = {"increment": ("wave_increment.cu",) * 2,
                "increment_lock": ("wave_increment_lock.cu",) * 2,
                "sliding_puzzle": ("wave_sliding_puzzle.cu",) * 2,
                "single_copy": ("wave_single_copy.cu",
                                "sender_single_copy.cu"),
                "abd": ("wave_abd.cu", "sender_abd.cu"),
                "pingpong": ("wave_pingpong.cu",) * 2,
                "vsr": ("wave_vsr.cu", "sender_vsr.cu")}
#: VSR at 3 replicas and max_view 3 on 48 slots, to its end at batch
#: 4,096: the JAX package's fused engine's counts on the CPU at that
#: batch, with an "agreement" counterexample. The run stops once
#: every property has a discovery, so its counts follow the batch: at
#: 16,384 both packages give 1,352,940 / 5,496,800 (PERF.md section 6).
VSR33, VSR33_BATCH = (1_344_659, 5_456_850), 4096
#: the states its runs on the fused torch stages and wave kernel, held
#: against each other, stop at (a fifth of the whole run's)
VSR33_CUT = 1_000_000
#: the 3x4 puzzle's space: the 4x3's transposed (an isomorphism of its
#: graph: 12! / 2 boards, 17 edges of the grid)
PUZZLE34 = PUZZLE43
#: the cut of ping-pong at 32 slots and VSR at 4 replicas on 64 (held on
#: the six engine and path combinations at batch 2,048, each past a few
#: full waves: the classic runs' log counts them), and of ABD's runs on the
#: four engines (their spaces are larger than a gate needs)
SIZE_CUTS = {"pingpong 32": 60_000, "vsr 4/64": 40_000,
             "abd 2/4": 40_000, "abd 3/3": 40_000}
#: the states each size's sharded run stops at (the run shows kernel 3
#: launched at the size on the sharded engine; the rows come from the
#: fused run's arena)
SIZE_SHARDED_CUT = 20_000


def _whole_puzzle(rows, cols):
    """The rows x cols puzzle (an even column count) with one more always
    property, "solvable": its tiles' inversions plus the blank's row are
    even on every board its start reaches (a vertical move hops a tile over
    cols - 1 others and moves the blank a row; a horizontal one changes
    neither), so a run goes on past "solved", its one sometimes property,
    to the space's end."""
    from stateright_tpu_torch.model import Property
    from stateright_tpu_torch.models.sliding_puzzle import (PuzzleDevice,
                                                            SlidingPuzzle)
    import torch

    if cols % 2:
        raise ValueError("the invariant is an even column count's")

    def inversions(tiles):
        t = [x for x in tiles if x != 0]
        return sum(a > b for i, a in enumerate(t) for b in t[i + 1:])

    class Device(PuzzleDevice):
        def device_properties(self):
            props = super().device_properties()
            n = self.state_width

            def solvable(rows):
                i, j = torch.triu_indices(n, n, offset=1, device=rows.device)
                a, b = rows[:, i], rows[:, j]
                inv = ((a > b) & (a != 0) & (b != 0)).sum(dim=1)
                blank = (rows == 0).to(torch.int64).argmax(dim=1)
                return (inv + blank // cols) % 2 == 0

            props["solvable"] = solvable
            return props

    class Whole(SlidingPuzzle):
        def properties(self):
            return super().properties() + [Property.always(
                "solvable", lambda _, s: (inversions(s)
                                          + s.index(0) // cols) % 2 == 0)]

        def device_model(self):
            return Device(self.rows, self.cols)

    return Whole(rows, cols)


def _size_modules():
    from stateright_tpu_torch import matmul_wave
    from stateright_tpu_torch.models import (abd, increment, increment_lock,
                                             pingpong, single_copy,
                                             sliding_puzzle, vsr)

    def build(model, args):
        if model == "increment":
            return increment.IncrementModel(*args)
        if model == "increment_lock":
            return increment_lock.IncrementLockModel(*args)
        if model == "sliding_puzzle":
            return sliding_puzzle.SlidingPuzzle(*args)
        if model == "single_copy":
            return single_copy.SingleCopySys(*args)
        if model == "abd":
            return abd.AbdSys(*args)
        if model == "pingpong":
            max_nat, history, slots = args
            return pingpong.PingPongSys(max_nat, history, lossy=True,
                                        net_slots=slots)
        n, max_view, slots = args
        return vsr.VsrSys(n, max_view, net_slots=slots)

    return build, matmul_wave


def _size_run(torch, kernels, fused, tag, build, target, sharded, batch,
              **kw):
    """``build()``'s checker on the card's kernels (stopped at ``target``
    states where given), fused at ``batch`` rows or sharded on ``SHARDS``
    shards of ``batch / SHARDS``, the launch counts set to 0 just before
    and read just after and held to the run's waves. Returns ``(checker,
    launches)``."""
    for fn in kernels.values():
        fn.launches = 0
    b = build().checker()
    if target is not None:
        b = b.target_state_count(target)
    spawn = (dict(mesh=["cuda:0"] * SHARDS, batch_size=max(batch // SHARDS, 1))
             if sharded else dict(device="cuda:0", batch_size=batch))
    spawn.update(wave_kernel=True, **kw)
    t0 = time.monotonic()
    c = b.spawn_cuda_bfs(**spawn).join()
    sec = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    _check_launches(fused, c, launches, **spawn)
    _log(f"{tag}, {'sharded' if sharded else 'fused'}: "
         f"{c.unique_state_count()} / {c.state_count()} states in "
         f"{sec:.3f} s, launches {launches}")
    want = "sender_kernel" if sharded else "megakernel"
    if c.kernel_path().split("+")[0] != want:
        raise AssertionError(f"{tag}: kernel_path() {c.kernel_path()}")
    return c, launches


def _size_rows(torch, c, B, gen):
    """``B`` packed rows of checker ``c``'s model: the last ``B`` of its
    arena, or where it holds fewer, all of them and seeded adversarial
    rows (a board's tiles shuffled; else small random lanes, and on a
    network random envelopes and empty slots, half of them sorted)."""
    dm, layout = c._dm, c._layout
    if c._tail >= B:
        return _last_rows(c, B), c._tail
    n, w = B - c._tail, dm.state_width
    if hasattr(dm, "rows") and hasattr(dm, "cols"):
        adv = torch.argsort(torch.rand((n, w), generator=gen, device="cuda"),
                            dim=1)
    else:
        adv = torch.randint(0, 12, (n, w), generator=gen, device="cuda")
        if getattr(dm, "net_offset", None) is not None:
            off, e = dm.net_offset, dm.net_slots
            top = 1 << (getattr(dm, "extra_shift", 11) + 4)
            env = torch.randint(0, top, (n, e), generator=gen,
                                device="cuda")
            env = torch.where(
                torch.rand((n, e), generator=gen, device="cuda") < 0.3,
                torch.full_like(env, 0xFFFFFFFF), env)
            half = torch.arange(n, device="cuda")[:, None] < n // 2
            adv[:, off:off + e] = torch.where(
                half, torch.sort(env, dim=1).values, env)
        if dm.error_lane is not None:
            adv[:, dm.error_lane] = 0
    return torch.cat([c._vecs[:c._tail], layout.pack(adv)]).contiguous(), \
        c._tail


def _replay_ms(torch, fn, calls, reps=3) -> float:
    """Device time of ``fn()`` a call: ``calls`` calls captured in one CUDA
    graph (after a call outside it), replayed once to warm it, then
    ``reps`` replays back to back between two CUDA events, over the calls
    they ran. Many calls a graph keep the card busier than the host's
    enqueue of a replay (a few microseconds), which a graph of one short
    call would time instead. The wrappers allocate their outputs from the
    graph's pool, as the engines' captured dispatches do."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * calls)


def _graph_calls(S: int, wp: int) -> int:
    """Calls a timing graph holds: enough that a replay keeps the card
    busy, few enough that their outputs (16 bytes a slot and its packed
    words) fit the graph's pool in about 256 MB."""
    return max(1, min(16, (1 << 28) // (S * (16 + 4 * wp))))


def _timed_once(torch, fn, *args):
    """``(fn(*args), its ms)``: one call between CUDA events, synchronised
    before and after."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _bound(cost):
    """``(bound_ms, bound_by)`` of a kernel's declared ``cost``."""
    bytes_ms = cost["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = cost["ops"] / OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _log_slots(torch, dm, layout, store, got, want, tag, most=3):
    """The first slots where the wave kernel's successor or sflat differs
    from its plain version's: the parent row, the action, both
    successors' lanes and sflats."""
    F = dm.max_fanout
    bad = ((got[0] != want[0]).any(dim=1) | (got[2] != want[2])).nonzero()
    _log(f"{tag}: {bad.numel()} slots differ; the first:")
    parents = layout.unpack(store)
    mine, theirs = layout.unpack(got[0]), layout.unpack(want[0])
    for i in bad[:most, 0].tolist():
        _log(f"  slot {i} (row {i // F}, action {i % F}): parent "
             f"{parents[i // F].tolist()}\n    kernel {mine[i].tolist()} "
             f"sflat {bool(got[2][i])}\n    plain  {theirs[i].tolist()} "
             f"sflat {bool(want[2][i])}")


def _size_wave(torch, wave_mod, table_mod, dm, layout, store, table, use_sym,
               plan, tag):
    """Kernel 2 against its plain version on ``store`` (every row valid)
    and a copy of ``table``, with a caller-owned scratch: every output, the
    counts and the table as a set equal, the scratch clean; the plain
    version timed on that one call, the kernel by graph replays
    (``_replay_ms``)."""
    B = store.shape[0]
    S, wp = B * dm.max_fanout, layout.packed_width
    valid = torch.ones(B, dtype=torch.bool, device="cuda")
    fn, scratch = _scratch(torch, table_mod, wave_mod.wave_megakernel, S)
    fn = functools.partial(fn, plan=plan)
    t_k, t_p = table.clone(), table.clone()
    got = fn(dm, store, valid, t_k, use_sym, layout)
    want, plain_ms = _timed_once(
        torch, functools.partial(wave_mod.wave_megakernel_plain, plan=plan),
        dm, store, valid, t_p, use_sym, layout)
    names = ("succ_store", "path_fps", "sflat", "new_mask", "cand_mask",
             "new_count", "cand_count", "full")
    for name, a, b in zip(names, got, want):
        if not torch.equal(a, b):
            _log_slots(torch, dm, layout, store, got, want, tag)
            raise AssertionError(f"wave kernel ({tag}) disagrees with its "
                                 f"plain version on {name}")
    if not torch.equal(torch.sort(t_k).values, torch.sort(t_p).values):
        raise AssertionError(f"wave kernel's table ({tag}) differs from the "
                             "plain version's as a set")
    _check_clean(torch, scratch, f"the wave kernel ({tag})")
    n_valid, cand, new = int(got[2].sum()), int(got[6]), int(got[5])
    del t_p, got, want
    # Each replay restores the table first, so that every call inserts
    # what the first did; the restore's own time is taken off.
    calls = _graph_calls(S, wp)
    ms = (_replay_ms(torch, lambda: (t_k.copy_(table), fn(
        dm, store, valid, t_k, use_sym, layout)), calls)
        - _replay_ms(torch, lambda: t_k.copy_(table), calls))
    _check_clean(torch, scratch, f"the wave kernel ({tag}, timed)")
    del t_k
    bound_ms, bound_by = _bound(wave_mod.wave_cost(
        dm, B, wp, use_sym, plan, n_valid, cand))
    _log(f"wave kernel == plain ({tag}) at B={B}, S={S}, C=2^"
         f"{table.shape[0].bit_length() - 1}: valid={n_valid} cand={cand} "
         f"new={new}; kernel {ms:.4f} ms a call (graph replays between "
         f"CUDA events), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
         f"({bound_by})")
    return dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def _size_sender(torch, wave_mod, table_mod, dm, layout, store, syms, plan,
                 tag):
    """Kernel 3 against its plain version on ``store`` as ``SHARDS``
    shards, each of ``syms`` with local dedup on and off, then ragged (3
    shards of a row less, the last 100 rows not valid): every output equal
    and the scratch clean; each plain version timed on its one call, the
    kernel (plain, local dedup: the engines' form) by graph replays
    (``_replay_ms``). Returns the timed form's numbers."""
    rows, wp = store, layout.packed_width
    n, B = SHARDS, store.shape[0] // SHARDS
    S = B * dm.max_fanout
    out = None
    for shape in ("even", "ragged"):
        if shape == "ragged":
            n, B = 3, B - 1
            S = B * dm.max_fanout
        stack = rows[:n * B].reshape(n, B, wp).contiguous()
        valid = torch.ones((n, B), dtype=torch.bool, device="cuda")
        if shape == "ragged":
            valid[2, -100:] = False
        fn, scratch = _scratch(torch, table_mod, wave_mod.sender_megakernel,
                               n * S, n)
        fn = functools.partial(fn, plan=plan)
        for use_sym in syms if shape == "even" else (False,):
            for local_dedup in (True, False):
                args = (dm, stack, valid, use_sym, layout, local_dedup)
                where = (f"{tag}, {shape}, {'sym' if use_sym else 'plain'}"
                         f"{'' if local_dedup else ', no local dedup'}")
                got = fn(*args)
                want, plain_ms = _timed_once(
                    torch, wave_mod.sender_megakernel_plain, *args, plan)
                for name, a, b in zip(("succ_store", "dedup_fps", "path_fps",
                                       "sflat", "send_mask"), got, want):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"sender kernel ({where}) disagrees with its "
                            f"plain version on {name}")
                _check_clean(torch, scratch, f"the sender kernel ({where})")
                n_valid, sent = int(got[3].sum()), int(got[4].sum())
                if out is None and local_dedup and not use_sym:
                    ms = _replay_ms(torch, lambda: fn(*args),
                                    _graph_calls(n * S, wp))
                    _check_clean(torch, scratch,
                                 f"the sender kernel ({where}, timed)")
                    bound_ms, bound_by = _bound(wave_mod.sender_cost(
                        dm, n, B, wp, False, plan, n_valid))
                    out = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by)
                    _log(f"sender kernel == plain ({where}) at n={n} x "
                         f"B={B}: valid={n_valid} sent={sent}; kernel "
                         f"{ms:.4f} ms a call, plain {plain_ms:.4f} ms, "
                         f"bound {bound_ms:.4f} ms ({bound_by})")
        del fn, scratch
    _log(f"sender kernel == plain ({tag}): every form, ragged too, scratch "
         "clean")
    return out


def _size_holds(torch, kernels, fused, engine, wave_mod, table_mod,
                build_model, matmul_wave):
    """Kernels 2 and 3 at each size of ``SIZES`` (and ``PLAN_SIZES`` in plan
    form): a run of the size on the fused wave kernel and one on the
    sharded sender kernel, each stopped at its target; kernel 2 against
    its plain version on 16,384 rows of the fused run's arena (all of it
    and seeded adversarial rows where it holds fewer), against a table of
    the run's states with the run's scratch, plain and with symmetry where
    the model has it; kernel 3 on the same rows as 4 shards of 4,096 and
    ragged. Returns the kernels line's rows."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows, failed = [], []
    for tag, model, args, target, sym, kw in SIZES:
        try:
            rows += _size_hold(torch, kernels, fused, engine, wave_mod,
                               table_mod, build_model, matmul_wave, gen, tag,
                               model, args, target, sym, kw)
        except AssertionError as e:
            # Every size is held before the phase fails, so that one run
            # shows each size that disagrees.
            _log(f"{tag}: FAILED: {e}")
            failed.append(tag)
    if failed:
        raise AssertionError(f"kernels 2 and 3 failed at {failed}")
    return rows


def _size_hold(torch, kernels, fused, engine, wave_mod, table_mod,
               build_model, matmul_wave, gen, tag, model, args, target, sym,
               kw):
    """``_size_holds`` at one size: its kernels line's rows."""
    rows = []
    t0 = time.monotonic()
    batch = kw.get("batch", BATCH)
    forms = [(False, None)]
    if tag in PLAN_SIZES:
        plan = matmul_wave.classify(build_model(model, args)
                                    .device_model()).plan
        if plan is None:
            raise AssertionError(f"{tag}: the gate found no plan")
        forms.append((True, plan))
    for planned, plan in forms:
        build = functools.partial(build_model, model, args)
        c, lw = _size_run(torch, kernels, fused, tag, build, target,
                          False, batch, wave_matmul=planned,
                          cuda_graph=False)
        _, ls = _size_run(torch, kernels, fused, tag, build,
                          min(target or SIZE_SHARDED_CUT, SIZE_SHARDED_CUT),
                          True, batch, wave_matmul=planned, cuda_graph=False)
        dm, layout = c._dm, c._layout
        store, reached = _size_rows(torch, c, BATCH, gen)
        keys = c._table[c._table != -1]
        S = BATCH * dm.max_fanout
        table = torch.full((_pow2(max(2 * (keys.numel() + S), 1 << 16)),),
                           -1, dtype=torch.int64, device="cuda")
        for chunk in keys.split(1 << 22):
            engine.global_insert(chunk, torch.ones_like(
                chunk, dtype=torch.bool), table)
        name = tag + (" plan" if planned else "")
        _log(f"{name}: {reached} rows of the run's arena "
             f"({c.unique_state_count()} / {c.state_count()} states, "
             f"waves {c.waves})")
        held = _size_wave(torch, wave_mod, table_mod, dm, layout, store,
                          table, False, plan, name)
        if sym:
            _size_wave(torch, wave_mod, table_mod, dm, layout, store,
                       table, True, plan, name + ", sym")
        sent = _size_sender(torch, wave_mod, table_mod, dm, layout, store,
                            (False, True) if sym else (False,), plan,
                            name)
        wave_src, send_src = SIZE_SOURCES[model]
        rows += [
            _kernel_row(f"wave_megakernel[{name}]", SRC + wave_src,
                        PALLAS + "380", lw["wave_megakernel"], 0, held),
            _kernel_row(f"sender_megakernel[{name}]", SRC + send_src,
                        PALLAS + "451", ls["sender_megakernel"], 0,
                        sent)]
        del c, store, table, keys
    _log(f"{tag}: held in {time.monotonic() - t0:.1f} s")
    return rows


def _registry_runs(torch, kernels, fused, build_model):
    """The registry's defaults, increment and increment_lock at 3 threads,
    on the four engines: the torch stages, the kernels, and the kernels in
    plan form (``wave_matmul``), each to its end; each engine's kernel runs
    equal in counts and chains to its torch stages'. Then one run
    configured by ``STpu_WAVE_KERNEL=1`` alone, on the wave kernel."""
    runs = {}
    for model in ("increment", "increment_lock"):
        tag = f"{model} 3"
        build = functools.partial(
            lambda m: build_model(m, (3,)).checker(), model)
        for engine in MATMUL_ENGINES:
            ref = runs[tag, engine, "torch"] = _matmul_run(
                torch, kernels, fused, tag, build, engine, False, False,
                None)
            for key, wave_matmul in (("kernel", False), ("plan", True)):
                r = runs[tag, engine, key] = _matmul_run(
                    torch, kernels, fused, tag, build, engine, True,
                    wave_matmul, None)
                _same_runs(r, ref, f"{tag}, {engine}, {key}")
        counts = {runs[tag, e, "torch"]["counts"] for e in MATMUL_ENGINES}
        _log(f"{tag}: every engine's kernel runs equal its torch stages' "
             f"({sorted(counts)})")
    old = os.environ.get("STpu_WAVE_KERNEL")
    os.environ["STpu_WAVE_KERNEL"] = "1"
    try:
        for fn in kernels.values():
            fn.launches = 0
        c = (build_model("increment", (3,)).checker()
             .spawn_cuda_bfs(device="cuda:0", batch_size=BATCH).join())
        launches = {name: fn.launches for name, fn in kernels.items()}
    finally:
        if old is None:
            del os.environ["STpu_WAVE_KERNEL"]
        else:
            os.environ["STpu_WAVE_KERNEL"] = old
    _check_launches(fused, c, launches, wave_kernel=True)
    ref = runs["increment 3", "fused", "kernel"]
    if c.kernel_path() != "megakernel" or launches["wave_megakernel"] == 0 \
            or (c.unique_state_count(), c.state_count()) != ref["counts"]:
        raise AssertionError(f"STpu_WAVE_KERNEL=1: {c.kernel_path()}, "
                             f"launches {launches}")
    _log(f"increment 3 configured by STpu_WAVE_KERNEL=1 alone: "
         f"{c.kernel_path()}, launches {launches}")
    return runs


def _four_engine_runs(torch, kernels, fused, tag, build):
    """``build()`` on the four engines, each on the torch stages and the
    kernels, the kernel runs equal to their torch stages' in counts and
    chains."""
    runs = {}
    for engine in MATMUL_ENGINES:
        ref = runs[tag, engine, False] = _matmul_run(
            torch, kernels, fused, tag, build, engine, False, False, None)
        r = runs[tag, engine, True] = _matmul_run(
            torch, kernels, fused, tag, build, engine, True, False, None)
        _same_runs(r, ref, f"{tag}, {engine}")
    return runs


def _cut_runs(torch, kernels, fused, tag, build, target, batch=2048):
    """``build()`` cut at ``target`` states on the fused, classic and
    sharded engines at ``batch`` rows (a quarter of that a shard), each on
    the torch stages and the kernels: each engine's kernel run equal to
    its torch stages' in counts and chains, every run at or past the
    cut."""
    runs = {}
    for engine in ("fused", "classic", "sharded"):
        for wave_kernel in (False, True):
            runs[tag, engine, wave_kernel] = r = _card_run(
                torch, kernels, fused, tag,
                lambda: build().checker().target_state_count(target), engine,
                batch, None, None, None, wave_kernel)
            if r["counts"][1] < target:
                raise AssertionError(f"{tag}, {engine}: {r['counts']} not "
                                     f"cut at {target}")
        _same_runs(runs[tag, engine, True], runs[tag, engine, False],
                   f"{tag}, {engine}")
    return runs


def phase_sizes(torch, kernels, fused, engine, wave_mod, table_mod):
    """Phase 14: kernels 2 and 3 at every model size (see the usage
    text). Returns ``(rows, runs)``."""
    build_model, matmul_wave = _size_modules()
    rows = _clocked("the sizes' kernel holds", _size_holds, torch, kernels,
                    fused, engine, wave_mod, table_mod, build_model,
                    matmul_wave)
    runs = _clocked("the registry's defaults", _registry_runs, torch,
                    kernels, fused, build_model)
    for tag, args in (("single_copy 3/2", ("single_copy", (3, 2))),
                      ("abd 2/4", ("abd", (2, 4))),
                      ("abd 3/3", ("abd", (3, 3)))):
        target = SIZE_CUTS.get(tag)
        build = functools.partial(
            lambda a, t: (build_model(*a).checker() if t is None else
                          build_model(*a).checker().target_state_count(t)),
            args, target)
        runs.update(_clocked(f"{tag} on the four engines",
                             _four_engine_runs, torch, kernels, fused, tag,
                             build))
    for tag, args in (("pingpong 32", ("pingpong", (11, False, 32))),
                      ("vsr 4/64", ("vsr", (4, 1, 64)))):
        runs.update(_clocked(f"{tag} cut", _cut_runs, torch, kernels, fused,
                             tag, functools.partial(build_model, *args),
                             SIZE_CUTS[tag]))
    runs["puzzle 3x4", "fused", True] = _clocked(
        "puzzle 3x4, to its end", _card_run, torch, kernels, fused,
        "puzzle 3x4", lambda: _whole_puzzle(3, 4).checker(), "fused", BATCH,
        PUZZLE34, ["solved"], None, True)

    def vsr():
        return build_model("vsr", (3, 3, 48)).checker()

    def vsr_cut():
        return vsr().target_state_count(VSR33_CUT)

    whole = _clocked("vsr 3/3 on 48 slots, to its end", _card_run, torch,
                     kernels, fused, "vsr 3/3", vsr, "fused", VSR33_BATCH,
                     None, None, None, True)
    cut = [_clocked(f"vsr 3/3 on 48 slots to {VSR33_CUT:,}, wave_kernel="
                    f"{wave_kernel}", _card_run, torch, kernels, fused,
                    "vsr 3/3", vsr_cut, "fused", VSR33_BATCH, None, None,
                    None, wave_kernel)
           for wave_kernel in (False, True)]
    _same_runs(cut[1], cut[0], f"vsr 3/3, 48 slots, to {VSR33_CUT:,}")
    if not VSR33_CUT <= cut[0]["counts"][1] < whole["counts"][1]:
        raise AssertionError(f"vsr 3/3, 48 slots: {cut[0]['counts']}, not "
                             f"cut at {VSR33_CUT} states")
    _log(f"vsr 3/3 on 48 slots: {whole['counts']} (JAX's fused engine on "
         f"the CPU at the same batch: {VSR33}), found "
         f"{sorted(whole['chains'])}")
    if whole["counts"] != VSR33 or "agreement" not in whole["chains"]:
        raise AssertionError(f"vsr 3/3, 48 slots: {whole['counts']} and "
                             f"{sorted(whole['chains'])}, JAX's {VSR33} and "
                             "an agreement counterexample")
    runs["vsr 3/3", "fused", True] = whole
    return rows, runs


#: the configurations phase 15 checks on the host BFS through
#: ``spawn_cuda_bfs()``: (tag, the model's module and class, its
#: arguments, the target, JAX's ``spawn_tpu_bfs()`` at that target on the
#: CPU: (states, unique) and the discoveries, and what the warning names)
FALLBACKS = (
    ("paxos 2/5", "paxos", "PaxosSys", (2, 5), 1_000, (8_615, 3_465), [],
     "3 servers"),
    ("single_copy 5/1", "single_copy", "SingleCopySys", (5, 1), 2_000,
     (7_380, 4_529), ["value chosen"], "1 to 4 clients"),
    ("abd 3/2", "abd", "AbdSys", (3, 2), 200, (3_450, 1_862),
     ["value chosen"], "request ids collide"))


def _spawn_warned(spawn):
    """``spawn()`` and the warnings it gave."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        c = spawn()
    return c, [str(w.message) for w in caught]


def phase_fallback(torch):
    """Phase 15: the host BFS where ``spawn_cuda_bfs`` falls back to it,
    and the spawns that must not (see the usage text). Returns no kernel
    rows: the host BFS launches none."""
    import importlib

    from stateright_tpu_torch.device_model import DeviceFormUnavailable
    from stateright_tpu_torch.models.increment import IncrementModel
    from stateright_tpu_torch.models.twopc import TwoPhaseSys

    def sys_of(module, name):
        return getattr(importlib.import_module(
            f"stateright_tpu_torch.models.{module}"), name)

    for tag, module, name, args, target, want, found, why in FALLBACKS:
        t0 = time.monotonic()
        c, warned = _spawn_warned(lambda: sys_of(module, name)(
            *args).checker().target_state_count(target).spawn_cuda_bfs())
        c.join()
        sec = time.monotonic() - t0
        got = (c.state_count(), c.unique_state_count())
        _log(f"{tag} through spawn_cuda_bfs(): {type(c).__name__}, "
             f"states={got[0]} unique={got[1]} sec={sec:.3f} "
             f"states/s={got[0] / sec:.1f} (the host's), found "
             f"{sorted(c.discoveries())}; warned {warned}")
        if (type(c).__name__ != "BfsChecker" or len(warned) != 1
                or "falling back to the host BFS engine" not in warned[0]
                or why not in warned[0]):
            raise AssertionError(f"{tag}: {type(c)} and {warned}, not the "
                                 "host BFS with the fallback's warning")
        if got != want or sorted(c.discoveries()) != found:
            raise AssertionError(f"{tag}: {got}, {sorted(c.discoveries())}; "
                                 f"JAX's {want}, {found}")
    paxos = sys_of("paxos", "PaxosSys")
    # A refusal that regressed into a fallback stops at the target.
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        ckpt = os.path.join(tmp, "paxos.npz")
        for knob, kw in (("checkpoint_path", dict(checkpoint_path=ckpt)),
                         ("resume_from", dict(resume_from=ckpt)),
                         ("fused=True", dict(fused=True))):
            try:
                paxos(2, 5).checker().target_state_count(
                    1_000).spawn_cuda_bfs(**kw)
            except DeviceFormUnavailable as e:
                if f"cannot honor ['{knob}']" not in str(e):
                    raise AssertionError(f"{knob}: {e}") from e
                _log(f"paxos 2/5 with {knob} refuses: {e}")
            else:
                raise AssertionError(f"paxos 2/5 with {knob} fell back")
    c, warned = _spawn_warned(lambda: TwoPhaseSys(3).checker()
                              .spawn_cuda_bfs())
    c.join()
    got = (c.state_count(), c.unique_state_count())
    _log(f"2pc 3 through spawn_cuda_bfs(): {type(c).__name__} on "
         f"{c._device}, {c.kernel_path()}, {got}")
    if (type(c).__name__ != "FusedCudaBfsChecker" or warned
            or str(c._device) != "cuda:0" or c.kernel_path() != "dedup_kernel"
            or got != (1_146, 288)):
        raise AssertionError(f"2pc 3: {type(c)} on {c._device}, "
                             f"{c.kernel_path()}, {got}, warned {warned}")
    try:
        _spawn_warned(lambda: IncrementModel(17).checker().spawn_cuda_bfs(
            wave_kernel=True))
    except DeviceFormUnavailable as e:
        raise AssertionError(f"increment 17 fell back: {e}") from e
    except NotImplementedError as e:
        _log(f"increment 17 with wave_kernel=True raises: {e}")
    else:
        raise AssertionError("increment 17 with wave_kernel=True ran")
    return []


def _host_run(tag: str, build, spawn: str):
    """A host engine's run of ``build()`` (a configured builder), its
    checker and its states/s on this machine's CPU logged."""
    t0 = time.monotonic()
    c = getattr(build(), spawn)().join()
    sec = time.monotonic() - t0
    _log(f"{tag} on the host {spawn[6:].upper()}: states="
         f"{c.state_count()} unique={c.unique_state_count()} sec={sec:.3f} "
         f"states/s={c.state_count() / sec:.1f} (the card machine's CPU), "
         f"found {sorted(c.discoveries())}")
    return c


def _wave_kernel_run(torch, tag: str, build):
    """``build().spawn_cuda_bfs(wave_kernel=True)`` on ``cuda:0``: the fused
    engine on the wave kernel, which it must launch."""
    from stateright_tpu_torch.wave import wave_megakernel

    wave_megakernel.launches = 0
    c = build().spawn_cuda_bfs(device="cuda:0", wave_kernel=True).join()
    torch.cuda.synchronize()
    launches = wave_megakernel.launches
    _log(f"{tag} on the card: states={c.state_count()} "
         f"unique={c.unique_state_count()}, {c.kernel_path()}, "
         f"{launches} wave kernel launches, found {sorted(c.discoveries())}")
    if (type(c).__name__ != "FusedCudaBfsChecker"
            or c.kernel_path() != "megakernel" or launches < 1):
        raise AssertionError(f"{tag}: {type(c).__name__} on "
                             f"{c.kernel_path()} ({launches} launches), "
                             "not the wave kernel")
    return c


def _full_increment(IncrementModel, Property, torch):
    """Increment with a property never met (on the host and the device),
    so that every engine runs it to its end despite the race it finds
    (``tests/test_examples.py::_FullIncrement``)."""

    class FullIncrement(IncrementModel):
        def properties(self):
            return super().properties() + [
                Property.sometimes("unreachable", lambda _m, _s: False)]

        def device_model(self):
            dm = super().device_model()
            preds = dm.device_properties()
            dm.device_properties = lambda: {
                **preds, "unreachable": lambda rows: torch.zeros(
                    rows.shape[0], dtype=torch.bool, device=rows.device)}
            return dm

    return FullIncrement


def phase_host(torch, card: str):
    """Phase 16: the host DFS with symmetry and the host forms of VSR,
    increment, increment_lock and the puzzle, each held to its exact
    counts and, where the card runs the model, to the card's fused wave
    kernel (see the usage text). Returns no kernel rows: the host engines
    launch none, and the card runs are checks of the host."""
    from stateright_tpu_torch import Property
    from stateright_tpu_torch.models.increment import IncrementModel
    from stateright_tpu_torch.models.increment_lock import (
        IncrementLockModel)
    from stateright_tpu_torch.models.single_copy import SingleCopySys
    from stateright_tpu_torch.models.sliding_puzzle import SlidingPuzzle
    from stateright_tpu_torch.models.twopc import TwoPhaseSys
    from stateright_tpu_torch.models.vsr import VsrSys

    _log(f"phase 16 host rates: the card machine's CPU, beside {card}")
    for tag, build, want in (
            ("2pc 5", lambda: TwoPhaseSys(5).checker(), 8_832),
            ("2pc 5 symmetry", lambda: TwoPhaseSys(5).checker().symmetry(),
             665)):
        c = _host_run(tag, build, "spawn_dfs")
        if c.unique_state_count() != want:
            raise AssertionError(f"{tag}: {c.unique_state_count()}, not "
                                 f"{want}")
        c.assert_properties()

    sc = SingleCopySys(2, 1)
    rep = sc.device_model().host_representative
    host = _host_run("single-copy 2/1 symmetry_fn(host_representative)",
                     lambda: sc.checker().symmetry_fn(rep), "spawn_dfs")
    card_sc = _wave_kernel_run(
        torch, "single-copy 2/1 symmetry",
        lambda: SingleCopySys(2, 1).checker().symmetry())
    if not host.unique_state_count() == card_sc.unique_state_count() == 47:
        raise AssertionError(
            f"single-copy 2/1 orbits: host {host.unique_state_count()}, "
            f"card {card_sc.unique_state_count()}, not 47")
    host.assert_properties()
    card_sc.assert_properties()

    full_increment = _full_increment(IncrementModel, Property, torch)
    for tag, build, want in (
            ("vsr 2/1", lambda: VsrSys(2, 1).checker(), (169, 63)),
            ("increment 3", lambda: full_increment(3).checker(), None),
            ("increment_lock 3", lambda: IncrementLockModel(3).checker(),
             None),
            ("puzzle 2x3", lambda: SlidingPuzzle(2, 3).checker(),
             (841, 360))):
        host = _host_run(tag, build, "spawn_bfs")
        card_run = _wave_kernel_run(torch, tag, build)
        got = [(c.state_count(), c.unique_state_count(),
                sorted(c.discoveries())) for c in (host, card_run)]
        if got[0] != got[1] or want not in (None, got[0][:2]):
            raise AssertionError(f"{tag}: host {got[0]}, card {got[1]}, "
                                 f"want {want}")
    return []


#: phase 17's device budget for the fused 2pc 10 run: under its uncapped
#: peak of 3,123,973,632 B (PERF.md section 5), of which its 2^27-slot table
#: is 1 GiB
TIER_FUSED_BUDGET = 2 << 30
#: the uncapped final tables (slots) of phase 17's classic runs at
#: batch 16,384, whose halves are their table budgets, and of its classic
#: sharded paxos 3 (a shard, 4 x 4,096): each held to the uncapped run's
TIER_CLASSIC_TABLE = {"twopc": 1 << 27, "paxos": 1 << 22}
TIER_SHARDED_TABLE = 1 << 21
#: phase 17's classic runs: (tag, model, spawn, counts, discoveries)
TIER_CLASSIC = (
    ("2pc 10, wave kernel", ("twopc", 10), dict(wave_kernel=True),
     (FULL_UNIQUE, FULL_STATES), ["abort agreement", "commit agreement"]),
    ("paxos 3, torch stages", ("paxos", 3), dict(),
     (PAXOS_UNIQUE, PAXOS_STATES), ["value chosen"]))


def _tier_model(name, size):
    from stateright_tpu_torch.models.paxos import PaxosSys
    from stateright_tpu_torch.models.twopc import TwoPhaseSys

    return (TwoPhaseSys if name == "twopc" else PaxosSys)(size)


def _tier_run(torch, kernels, tag, build, **spawn):
    """``build()``'s checker through ``spawn_cuda_bfs(**spawn)``, the
    kernels' launch counts set to 0 just before and read just after:
    ``(checker, seconds, peak device memory, launches)``, the launches
    held exact: per wave (the dedup kernel a shard on the torch stages
    and on a sharded engine's owner side, the wave kernel or the sender
    kernel on the kernels, the append kernel a wave of a fused engine;
    a fused engine's dispatches launch K waves each, a sharded classic
    regather its sender again) plus the dedup kernel's calls at rest
    points (``table_chunks``: rehashes, a resumed table, a table rebuilt
    after a visited spill)."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.monotonic()
    c = build().spawn_cuda_bfs(**spawn).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in kernels.items()}
    n = getattr(c, "_n", 1)
    wk = spawn.get("wave_kernel", False)
    if hasattr(c, "_K"):
        waves = c._K * c.dispatches
        want = {"dedup_and_insert": c.table_chunks + (
                    n * waves if n > 1 or not wk else 0),
                "wave_megakernel": waves if wk and n == 1 else 0,
                "sender_megakernel": waves if wk and n > 1 else 0,
                "append_rows": waves}
    else:
        waves = c.waves
        regathers = c.scheduler_stats()["succ_ladder"][
            "overflow_redispatches"]
        sharded = hasattr(c, "_shard_counts")
        want = {"dedup_and_insert": c.table_chunks + (
                    n * waves if sharded or not wk else 0),
                "wave_megakernel": waves if wk and not sharded else 0,
                "sender_megakernel": waves + regathers if wk and sharded
                else 0, "append_rows": 0}
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches}, expected "
                             f"{want}")
    if not any(launches.values()):
        raise AssertionError(f"{tag}: no kernel launched")
    return c, sec, peak, launches


def _logical_visited(c, load_cold_refs):
    """The visited set a checkpoint of ``c`` would carry, with its cold
    segments read: its logical set, each fingerprint once."""
    import numpy as np

    visited, refs = c._visited_section()
    if refs:
        visited = np.concatenate([visited, load_cold_refs(refs)])
    return np.unique(visited)


def _spill_transients(torch, run):
    """``run()`` (a ``_tier_run``) with the classic engines' visited
    spill wrapped: ``(its result, (the most device memory a spill held
    above what was allocated as it began, the table's bytes then))``. The
    peak counter is reset as each spill begins; the run's peak before
    each reset is kept and goes into the result's peak."""
    from stateright_tpu_torch.classic import CudaBfsChecker

    real = CudaBfsChecker._spill_for_headroom
    seen = {"run": 0, "spill": 0, "table": 0}

    def spill(self):
        torch.cuda.synchronize()
        seen["run"] = max(seen["run"], torch.cuda.max_memory_allocated())
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            return real(self)
        finally:
            torch.cuda.synchronize()
            seen["spill"] = max(seen["spill"],
                                torch.cuda.max_memory_allocated() - base)
            seen["table"] = max(seen["table"], self._table.numel() * 8)

    CudaBfsChecker._spill_for_headroom = spill
    try:
        c, sec, peak, launches = run()
    finally:
        CudaBfsChecker._spill_for_headroom = real
    if not seen["table"]:
        raise AssertionError("no visited spill ran")
    return (c, sec, max(peak, seen["run"]), launches), (seen["spill"],
                                                        seen["table"])


def _tier_summary(c, logical=None):
    """What a capped run is held to of a run: its counts and its
    discoveries' chains, and with ``logical`` (``load_cold_refs``) its
    logical visited set."""
    return ((c.unique_state_count(), c.state_count()), _chains(c),
            None if logical is None else _logical_visited(c, logical))


def _tier_same(tag, got, want, counts) -> None:
    """Exactly the uncapped run's counts, discoveries and chains (and
    logical visited set, where both have it)."""
    import numpy as np

    if got[:2] != want[:2] or got[0] != counts or (
            got[2] is not None and want[2] is not None
            and not np.array_equal(got[2], want[2])):
        raise AssertionError(f"{tag}: {got[0]} {sorted(got[1])}, the "
                             f"uncapped run's {want[0]} {sorted(want[1])}, "
                             f"or the logical visited sets differ")


def _captures(c):
    return (c.scheduler_stats()["graphs"] or {}).get("captures")


def _store_line(st) -> str:
    return (f"spills host {st['spills']['host']} / disk "
            f"{st['spills']['disk']} ({st['spill_bytes']} B), warm "
            f"{st['host']['rows']} rows, cold {st['disk']['rows']} rows in "
            f"{st['disk']['segments']} segments, probes {st['probes']} "
            f"(hits {st['probe_hits']}), resident ratio "
            f"{st.get('resident_ratio')}, device {st.get('device')}, "
            f"frontier {st['frontier']}")


def phase_tiered(torch, kernels):
    """Phase 17: the tiered store on the card, each capped run exactly the
    uncapped run of the same path. Each capped run goes first, and is
    summarised and dropped before its uncapped twin, so that each peak of
    device memory is its run's own."""
    import shutil

    from stateright_tpu_torch.checkpoint_format import verify_file
    from stateright_tpu_torch.models.twopc import TwoPhaseSys
    from stateright_tpu_torch.store.tiered import load_cold_refs

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "_tier_tmp")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        return _phase_tiered(torch, kernels, TwoPhaseSys, load_cold_refs,
                             verify_file, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _phase_tiered(torch, kernels, TwoPhaseSys, load_cold_refs, verify_file,
                  workdir):
    out = {}
    # (a) The fused engine, 2pc 10 on the wave kernel, under a device
    # budget its arena must roll to keep.
    spawn = dict(device="cuda:0", batch_size=BATCH, wave_kernel=True)
    c, sec, peak, launches = _clocked(
        "(a) the capped run", _tier_run, torch, kernels,
        "2pc 10 fused, capped", TwoPhaseSys(10).checker,
        tier_device_bytes=TIER_FUSED_BUDGET, **spawn)
    st, got = c.store_stats(), _tier_summary(c)
    rolls, ucap, grows, notes, caps = (c.rolls, c._ucap, c.arena_grows,
                                       c._store.pressure_notes, _captures(c))
    del c
    if not rolls or st["arena_spans"]["spills"] != rolls:
        raise AssertionError(f"2pc 10 fused, capped: {rolls} rolls, "
                             f"{st['arena_spans']}")
    free, sec0, peak0, l0 = _clocked(
        "(a) the uncapped run", _tier_run, torch, kernels, "2pc 10 fused",
        TwoPhaseSys(10).checker, **spawn)
    _tier_same("2pc 10 fused, capped", got, _tier_summary(free),
               (FULL_UNIQUE, FULL_STATES))
    _log(f"(a) 2pc 10 fused on the wave kernel under {TIER_FUSED_BUDGET} B: "
         f"unique={got[0][0]} states={got[0][1]} and chains equal to the "
         f"uncapped run's; {rolls} arena-span rolls "
         f"({st['arena_spans']['rows']} rows, {st['arena_spans']['bytes']} "
         f"B), {notes} pressure notes, arena {ucap} rows (uncapped "
         f"{free._ucap}), {grows} doublings (uncapped {free.arena_grows}); "
         f"peak device memory {peak} B ({peak / TIER_FUSED_BUDGET:.3f} of "
         f"the budget; uncapped {peak0} B); {sec:.3f} s, the process's "
         f"first run, against the uncapped {sec0:.3f} s; graph captures "
         f"{caps} (uncapped {_captures(free)}); launches {launches} "
         f"(uncapped {l0})")
    out["fused"] = dict(sec=sec, sec0=sec0, peak=peak, peak0=peak0,
                        rolls=rolls, launches=launches)
    del free

    # (b) The classic engine under a table budget of half its uncapped
    # final table and a host budget of an eighth of its visited set:
    # partitions go warm, then cold.
    for tag, (name, size), extra, counts, found in TIER_CLASSIC:
        spawn = dict(device="cuda:0", fused=False, batch_size=BATCH, **extra)
        build = functools.partial(lambda n, s: _tier_model(n, s).checker(),
                                  name, size)
        budget = TIER_CLASSIC_TABLE[name] * 8 // 2
        host = counts[0]  # an eighth of the visited set's bytes
        tier = dict(tier_device_bytes=budget, tier_host_bytes=host,
                    tier_dir=os.path.join(workdir, name))
        # The visited sets are compared on paxos 3 (2pc 10's are 0.5 GB).
        logical = load_cold_refs if name == "paxos" else None
        (c, sec, peak, launches), spill = _spill_transients(
            torch, lambda: _clocked(
                f"(b) {tag}, the capped run", _tier_run, torch, kernels,
                f"{tag} classic, capped", build, **tier, **spawn))
        st, got, cap = c.store_stats(), _tier_summary(c, logical), c._capacity
        bitmap = c._store._filter.nbytes
        ms = sum(c.host_sec.values()) * 1e3 / c.waves
        chunks, at = c.table_chunks, next(
            (e["states"] for e in c.dispatch_log if e.get("tier_disk_rows")),
            None)
        del c
        if sorted(got[1]) != found:
            raise AssertionError(f"{tag}: discoveries {sorted(got[1])}")
        if not (st["spills"]["host"] and st["spills"]["disk"]
                and st["probe_hits"] and st["resident_ratio"] < 1):
            raise AssertionError(f"{tag} classic, capped: {st}")
        if cap * 8 > budget:
            raise AssertionError(f"{tag} classic, capped: the table grew "
                                 f"to {cap} slots")
        free, sec0, peak0, l0 = _clocked(
            f"(b) {tag}, the uncapped run", _tier_run, torch, kernels,
            f"{tag} classic", build, **spawn)
        if free._capacity != TIER_CLASSIC_TABLE[name]:
            raise AssertionError(f"{tag} classic: the final table is "
                                 f"{free._capacity} slots")
        want = _tier_summary(free, logical)
        _tier_same(f"{tag} classic, capped", got, want, counts)
        ms0 = sum(free.host_sec.values()) * 1e3 / free.waves
        _log(f"(b) {tag} classic under a table budget of {budget} B (half "
             f"the uncapped final table's {free._capacity} slots) and a "
             f"host budget of {host} B: counts and chains"
             f"{' and the logical visited set' if logical else ''} equal "
             f"to the uncapped run's; {_store_line(st)}; the probe's filter "
             f"{bitmap} B of the host tier's; table {cap} slots, "
             f"{chunks} chunk calls at rest (uncapped {free.table_chunks}); "
             f"host {ms:.3f} ms a wave (uncapped {ms0:.3f}); {sec:.3f} s "
             f"against {sec0:.3f} s; peak device memory {peak} B "
             f"({peak / budget:.3f} of the table budget, the wave's buffers "
             f"included; uncapped {peak0} B), a spill at most {spill[0]} B "
             f"above what it began with ({spill[0] / spill[1]:.3f} of the "
             f"{spill[1]} B table); launches {launches} (uncapped {l0})")
        out[tag] = dict(sec=sec, sec0=sec0, ms=ms, ms0=ms0, store=st,
                        peak=peak, peak0=peak0, spill=spill,
                        launches=launches)
        del free
        if name == "paxos":
            _clocked("(c) the resumes", _tier_resume, torch, kernels, tag,
                     build, spawn, tier, at, want, verify_file,
                     load_cold_refs, workdir)

    # (d) The sharded engines, small: the sharded fused engine's per-shard
    # roll (JAX's slow arm, 2pc 6 on 4 shards of 8 rows, a 512-row arena
    # a shard under 300 KB) and the classic sharded engine's visited spill
    # on the sender kernel (paxos check 3, 4 x 4,096).
    small = dict(mesh=["cuda:0"] * SHARDS, batch_size=8, table_capacity=4096,
                 wave_kernel=True)
    c, sec, _, launches = _clocked(
        "(d) 2pc 6 sharded fused, the capped run", _tier_run, torch,
        kernels, "2pc 6 sharded fused, capped", TwoPhaseSys(6).checker,
        arena_capacity=512, tier_device_bytes=300_000,
        tier_host_bytes=1 << 20, tier_dir=os.path.join(workdir, "sf"),
        **small)
    spans, notes, got = (c.store_stats()["arena_spans"],
                         c._store.pressure_notes, _tier_summary(c))
    del c
    free, sec0, _, _ = _clocked(
        "(d) 2pc 6 sharded fused, the uncapped run", _tier_run, torch,
        kernels, "2pc 6 sharded fused", TwoPhaseSys(6).checker, **small)
    _tier_same("2pc 6 sharded fused, capped", got, _tier_summary(free),
               (50_816, 402_306))
    del free
    if not spans["spills"]:
        raise AssertionError(f"2pc 6 sharded fused, capped: {spans}")
    _log(f"(d) 2pc 6 sharded fused on the sender kernel, {SHARDS} x 8 rows, "
         f"a 512-row arena a shard under 300,000 B: equal to the uncapped "
         f"run; spans {spans}, {notes} pressure notes; {sec:.3f} s against "
         f"{sec0:.3f} s; launches {launches}")
    out["sharded fused"] = dict(sec=sec, sec0=sec0, spans=spans,
                                launches=launches)
    sharded = dict(mesh=["cuda:0"] * SHARDS, batch_size=BATCH // SHARDS,
                   fused=False, wave_kernel=True)
    build = functools.partial(lambda: _tier_model("paxos", 3).checker())
    budget = SHARDS * TIER_SHARDED_TABLE * 8 // 2
    c, sec, _, launches = _clocked(
        "(d) paxos 3 sharded classic, the capped run", _tier_run, torch,
        kernels, "paxos 3 sharded classic, capped", build,
        tier_device_bytes=budget, tier_dir=os.path.join(workdir, "sc"),
        **sharded)
    st, got = c.store_stats(), _tier_summary(c)
    del c
    free, sec0, _, _ = _clocked(
        "(d) paxos 3 sharded classic, the uncapped run", _tier_run, torch,
        kernels, "paxos 3 sharded classic", build, **sharded)
    if free._capacity != TIER_SHARDED_TABLE:
        raise AssertionError(f"paxos 3 sharded classic: the final tables "
                             f"are {free._capacity} slots a shard")
    _tier_same("paxos 3 sharded classic, capped", got, _tier_summary(free),
               (PAXOS_UNIQUE, PAXOS_STATES))
    del free
    if not st["spills"]["host"] or not st["probe_hits"]:
        raise AssertionError(f"paxos 3 sharded classic, capped: {st}")
    _log(f"(d) paxos 3 sharded classic on the sender kernel under {budget} "
         f"B (half its uncapped tables): equal to the uncapped run; "
         f"{_store_line(st)}; {sec:.3f} s against {sec0:.3f} s; launches "
         f"{launches}")
    out["sharded classic"] = dict(sec=sec, sec0=sec0, store=st,
                                  launches=launches)
    return out


def _tier_resume(torch, kernels, tag, build, spawn, tier, at, want,
                 verify_file, load_cold_refs, workdir):
    """(c) The capped paxos run stopped after the wave of its first cold
    spill (``at`` states), checkpointed, and resumed with a store and
    without one, each to the uncapped run's counts, chains and logical
    visited set ``want``."""
    path = os.path.join(workdir, "paxos3-tiered.npz")
    cut, _, _, _ = _tier_run(
        torch, kernels, f"{tag} classic, capped, to {at}",
        lambda: build().target_state_count(at),
        **dict(tier, tier_dir=os.path.join(workdir, "cut")), **spawn)
    cold, states = cut.store_stats()["disk"]["segments"], cut.state_count()
    cut.checkpoint(path)
    del cut
    refs = verify_file(path).get("store") or {"cold": []}
    if not cold or len(refs["cold"]) != cold:
        raise AssertionError(f"(c) the checkpoint at {states} states holds "
                             f"{refs} for {cold} cold segments")
    for arm, knobs in (("with a store", dict(
            tier, tier_dir=os.path.join(workdir, "resume"))),
            ("without one", {})):
        r, rsec, _, rl = _tier_run(
            torch, kernels, f"(c) resumed {arm}", build, resume_from=path,
            **knobs, **spawn)
        disk = r.store_stats().get("disk")
        _tier_same(f"(c) resumed {arm}", _tier_summary(r, load_cold_refs),
                   want, want[0])
        del r
        _log(f"(c) paxos 3's capped checkpoint at {states} states ({cold} "
             f"cold segments referenced) resumed {arm}: counts, chains and "
             f"the logical visited set equal to the uncapped run's in "
             f"{rsec:.3f} s; store {disk}; launches {rl}")


def _tiered_rows(torch, kernels):
    """Phase 17, which gives no rows of its own: its runs' launches are
    held exact in the phase and logged."""
    _clocked("phase 17", phase_tiered, torch, kernels)
    return []


#: the variables phase 18 arms, and their values (the trace's path apart)
OBS_ARMED = {"STpu_PROF": "1", "STpu_PROF_SAMPLE": "1", "STpu_HIST": "1",
             "STpu_SLO": "1", "STpu_ANOMALY": "1"}
#: phase 18's runs: the fused wave kernel on 2pc 10, the classic wave
#: kernel on ``paxos check 3``; the states a mid-run point stops at
OBS_RUNS = (("2pc 10", dict(wave_kernel=True), 20_000_000),
            ("paxos 3", dict(wave_kernel=True, fused=False), PAXOS_MID))
#: each run's turns, disarmed and armed alternately, disarmed first
OBS_TURNS = {"2pc 10": 4, "paxos 3": 6}


def _obs_warm(torch) -> None:
    """What phase 18's process runs while it waits for its turn: a small
    run on each of its paths, so that its first timed turn finds the
    kernels loaded."""
    from stateright_tpu_torch.models.paxos import PaxosSys
    from stateright_tpu_torch.models.twopc import TwoPhaseSys

    TwoPhaseSys(3).checker().spawn_cuda_bfs(
        device="cuda:0", batch_size=64, wave_kernel=True).join()
    PaxosSys(1).checker().spawn_cuda_bfs(
        device="cuda:0", batch_size=64, wave_kernel=True,
        fused=False).join()
    torch.cuda.synchronize()
    _WARMED.add("obs")


#: the phases whose process has warmed up
_WARMED: set = set()


#: the phases whose process warms up while it waits for its turn
_WARM = {"obs": _obs_warm}


def _obs_env(trace=None) -> None:
    """Every phase-18 variable unset, then, with ``trace`` a path, all
    armed with the trace going there."""
    for var in ("STpu_TRACE", *OBS_ARMED):
        os.environ.pop(var, None)
    if trace is not None:
        os.environ.update(OBS_ARMED, STpu_TRACE=trace)


def _obs_run(torch, kernels, fused, obs, tag, spawn, trace=None):
    """One run of ``tag`` (``OBS_RUNS``) to its end on the card, armed
    when ``trace`` is a path: exact, its kernels launched (the fused
    run's exactly), the null objects held when disarmed. Returns
    ``(checker, seconds)``."""
    from stateright_tpu_torch.models.paxos import PaxosSys
    from stateright_tpu_torch.models.twopc import TwoPhaseSys

    build, want, found = {
        "2pc 10": (functools.partial(TwoPhaseSys, 10),
                   (FULL_UNIQUE, FULL_STATES),
                   ["abort agreement", "commit agreement"]),
        "paxos 3": (functools.partial(PaxosSys, 3),
                    (PAXOS_UNIQUE, PAXOS_STATES), ["value chosen"])}[tag]
    _obs_env(trace)
    try:
        gc.collect()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.monotonic()
        c = build().checker().spawn_cuda_bfs(
            device="cuda:0", batch_size=BATCH, **spawn).join()
        torch.cuda.synchronize()
        sec = time.monotonic() - t0
    finally:
        _obs_env()
    launches = {name: fn.launches for name, fn in kernels.items()}
    got = (c.unique_state_count(), c.state_count())
    if got != want or sorted(c.discoveries()) != found:
        raise AssertionError(f"{tag} ({'armed' if trace else 'disarmed'}): "
                             f"{got}, {sorted(c.discoveries())}")
    c.assert_properties()
    if spawn.get("fused", True):
        _check_launches(fused, c, launches, **spawn)
    elif launches["wave_megakernel"] != len(c.dispatch_log):
        raise AssertionError(f"{tag} classic: launches {launches} for "
                             f"{len(c.dispatch_log)} waves")
    nulls = (c._tracer is obs.NULL_TRACER, c._prof is obs.NULL_PROF,
             c._wave_obs is obs.NULL_OBS)
    if nulls != ((trace is None,) * 3):
        raise AssertionError(f"{tag}: the null objects {nulls}, armed "
                             f"{trace is not None}")
    g = c.scheduler_stats()["graphs"] or {}
    host = {k: round(v * 1e6 / len(c.dispatch_log), 1)
            for k, v in getattr(c, "host_sec", {}).items()}
    _log(f"{tag} ({'armed' if trace else 'disarmed'}): {sec:.3f} s, "
         f"{len(c.dispatch_log)} dispatches, {g.get('captures')} captures "
         f"in {g.get('capture_sec', 0):.3f} s, {g.get('replays')} replays"
         + (f"; host us a wave {host}" if host else ""))
    return c, sec


def _obs_trace(obs, c, path, tag) -> dict:
    """Phase 18's checks of an armed run's trace: every line valid under
    the port's schema, every wave field-exact, the waves' new rows
    summing to the run's unique count less its seeds, every program key
    with a ``profile_snapshot`` whose operations or bytes are declared
    and whose roofline share is at most 1.05, the histograms' snapshots
    consistent. Returns the trace's numbers."""
    lines = open(path, encoding="utf-8").read().splitlines()
    errors = [e for line in lines for e in obs.validate_line(line)]
    if errors:
        raise AssertionError(f"{tag}'s trace: {errors[:3]}")
    events = [json.loads(line) for line in lines]
    waves = [e for e in events if e["type"] == "wave"]
    if any(set(w) != set(obs.WAVE_FIELDS) for w in waves):
        raise AssertionError(f"{tag}: a wave event off the schema's fields")
    seeds = waves[0]["unique"] - waves[0]["novel"]
    if (not 1 <= seeds <= c._base_states
            or waves[-1]["unique"] != c.unique_state_count()
            or sum(w["novel"] for w in waves) + seeds
            != c.unique_state_count()):
        raise AssertionError(f"{tag}: the waves' novel sum to "
                             f"{sum(w['novel'] for w in waves)} + {seeds}")
    snaps: dict = {}
    for e in events:
        if e["type"] == "profile_snapshot":
            snaps.setdefault(e["key"], []).append(e)
    programs = c.scheduler_stats()["prof"]["programs"]
    if set(programs) != set(snaps):
        raise AssertionError(f"{tag}: program keys {sorted(programs)} "
                             f"against snapshots {sorted(snaps)}")
    shares = []
    for key, got in snaps.items():
        for e in got:
            if e["flops"] is None and e["bytes"] is None:
                raise AssertionError(f"{tag}: {key} declares no cost")
            if e["share"] > 1.05:
                raise AssertionError(f"{tag}: {key} reached {e['share']} of "
                                     "its bound")
            shares.append(e["share"])
    hists = [e for e in events if e["type"] == "hist_snapshot"]
    for h in hists:
        for series, data in h["hists"].items():
            if sum(data["buckets"]) != data["count"]:
                raise AssertionError(f"{tag}: {series}'s buckets")
    out = dict(lines=len(lines), waves=len(waves), snaps=len(shares),
               keys=len(snaps), hist_snapshots=len(hists),
               share_max=max(shares), share_mean=sum(shares) / len(shares),
               measured_ms=sum(e["measured_s"] for v in snaps.values()
                               for e in v) * 1e3,
               anomalies=sum(e["type"] == "anomaly" for e in events),
               breaches=sum(e["type"] == "slo_breach" for e in events),
               bytes=os.path.getsize(path))
    _log(f"{tag}'s trace: {out['lines']} lines ({out['bytes']} B), "
         f"{out['waves']} waves, {out['snaps']} profile snapshots of "
         f"{out['keys']} program keys (roofline share {out['share_mean']:.4f}"
         f" mean, {out['share_max']:.4f} most), {out['hist_snapshots']} "
         f"histogram snapshots, {out['anomalies']} anomalies, "
         f"{out['breaches']} SLO breaches; valid, novel sums exact")
    return out


def _obs_hook_us(torch, obs, c, path, n=2000) -> dict:
    """The armed hooks' host us a dispatch on the finished armed fused run
    ``c``, its trace reopened at ``path``: the profiler's start and stop
    around a launch (two CUDA events recorded), the cost stamp with its
    ``profile_snapshot`` (the events' elapsed time read), and the wave
    event's publish (flight ring, trace, histograms, SLOs, detector)."""
    c._tracer = obs.RunTracer(path, c._ENGINE_ID)
    key = ("dispatch", c._B, c._capacity, c._ucap, c._K)
    last = {k: v for k, v in c.dispatch_log[-1].items()
            if not k.startswith("cost_")}
    out = {}
    with torch.cuda.device(c._device):
        # A sampled dispatch's riders, its two events done (as a stats
        # read leaves them), for the stamp alone.
        riders = c._prof_stop(c._prof_start(key, list))
        torch.cuda.synchronize()
        for name, fn in (
                ("start+stop", lambda: c._prof_stop(c._prof_start(
                    key, lambda: c._dispatch_costs(c._B)))),
                ("stamp", lambda: c._stamp_cost(dict(last, **riders))),
                ("publish", lambda: c._publish(dict(last)))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) / n * 1e6
    c._tracer.close()
    _log("armed hooks' host us a dispatch (2pc 10's fused engine, "
         + ", ".join(f"{k} {v:.1f}" for k, v in out.items())
         + f"; {n} each): {sum(out.values()):.1f} in all")
    return out


def _obs_points(torch, fused, tag, spawn, mid_target, trace):
    """A mid-run point of ``tag`` armed (``trace`` a path) or not: one
    replay under ``set_sync_debug_mode("error")`` and, fused, the graph's
    kernel launches a launched wave (``torch.profiler``). Returns those
    launches (None for the classic engine)."""
    from stateright_tpu_torch.models.paxos import PaxosSys
    from stateright_tpu_torch.models.twopc import TwoPhaseSys

    build = {"2pc 10": functools.partial(TwoPhaseSys, 10),
             "paxos 3": functools.partial(PaxosSys, 3)}[tag]
    how = "armed" if trace else "disarmed"
    _obs_env(trace)
    try:
        mid = (build().checker().target_state_count(mid_target)
               .spawn_cuda_bfs(device="cuda:0", batch_size=BATCH, **spawn)
               .join())
        if spawn.get("fused", True):
            mid._stats[..., fused.ST_TARGET] = 1 << 62
            point = _Point(torch, fused, mid)
            waves, dev_ms, _, host_us, replay = _timed_dispatch(
                torch, point, sync_check=True)
            _log(f"{tag} ({how}): one replayed dispatch under "
                 f"set_sync_debug_mode('error'): {waves} waves, no "
                 f"synchronisation, {dev_ms:.3f} ms, {host_us:.1f} us in "
                 "the host's launch")
            return phase_profile(torch, point)[1]
        point = _ClassicPoint(torch, mid)
        torch.cuda.set_sync_debug_mode("error")
        try:
            wave = point.launch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        new = point.wait(wave)
        _log(f"{tag} ({how}): one replayed classic wave under "
             f"set_sync_debug_mode('error'): no synchronisation, {new} new "
             "rows")
        return None
    finally:
        _obs_env()


def phase_obs(torch, kernels, fused):
    """Phase 18: the run telemetry on the card (``obs``, every variable
    armed, the profiler at cadence 1) on 2pc 10 on the fused wave kernel
    and ``paxos check 3`` on the classic wave kernel: each disarmed,
    armed, disarmed, armed in turn, exact; each armed run's trace checked
    (``_obs_trace``); a replay of each armed under
    ``set_sync_debug_mode("error")``, and the fused graph's launches a
    wave armed and disarmed, equal; then ``measure_wave_breakdown`` on
    paxos 3 and 2pc 10 at batch 4,096 on the card, kernel 1's and kernel
    2's stages timed."""
    import shutil

    from stateright_tpu_torch import obs
    from stateright_tpu_torch.models.paxos import PaxosSys
    from stateright_tpu_torch.models.twopc import TwoPhaseSys
    from stateright_tpu_torch.obs import prof
    from stateright_tpu_torch.profiling import measure_wave_breakdown

    if (prof.HBM_BYTES_PER_S, prof.OPS_PER_S) != (HBM_BYTES_PER_S,
                                                  OPS_PER_S):
        raise AssertionError("the profiler's peaks are not the script's")
    if "obs" not in _WARMED:  # run alone, not started ahead
        _clocked("phase 18's warm-up", _obs_warm, torch)
    workdir = tempfile.mkdtemp(prefix="stpu-obs-")
    out = {}
    try:
        for tag, spawn, mid_target in OBS_RUNS:
            secs = {"disarmed": [], "armed": []}
            for turn in range(OBS_TURNS[tag]):
                trace = (os.path.join(workdir, f"{tag}-{turn}.jsonl")
                         if turn % 2 else None)
                c, sec = _obs_run(torch, kernels, fused, obs, tag, spawn,
                                  trace)
                secs["armed" if trace else "disarmed"].append(sec)
                if trace:
                    out[tag, turn] = _obs_trace(obs, c, trace, tag)
                    if turn == OBS_TURNS[tag] - 1 and spawn.get("fused",
                                                               True):
                        out[tag, "hooks"] = _obs_hook_us(
                            torch, obs, c, os.path.join(workdir,
                                                        "hooks.jsonl"))
                    stats = c.scheduler_stats()
                    _log(f"{tag} armed: slo healthy "
                         f"{stats['slo']['healthy']}, "
                         f"{len(stats['anomalies'])} recent anomalies")
                del c
            med = {k: sorted(v)[(len(v) - 1) // 2] for k, v in secs.items()}
            _log(f"{tag}: disarmed {secs['disarmed']} s, armed "
                 f"{secs['armed']} s (alternate turns, disarmed first); "
                 f"medians (the lower of two middles): disarmed "
                 f"{med['disarmed']:.3f} s, armed {med['armed']:.3f} s "
                 f"({med['armed'] / med['disarmed'] - 1:+.1%})")
            out[tag] = secs
            if spawn.get("fused", True):
                pw = [_obs_points(torch, fused, tag, spawn, mid_target, t)
                      for t in (None, os.path.join(workdir, "point.jsonl"))]
                if pw[0] != pw[1]:
                    raise AssertionError(f"{tag}: graph launches a wave "
                                         f"{pw[0]} disarmed, {pw[1]} armed")
                _log(f"{tag}: {pw[1]:.1f} kernel launches a launched wave "
                     "armed and disarmed")
            else:
                _obs_points(torch, fused, tag, spawn, mid_target,
                            os.path.join(workdir, "point.jsonl"))
        for tag, build, waves in (("paxos 3", functools.partial(PaxosSys, 3),
                                   6),
                                  ("2pc 10", functools.partial(
                                      TwoPhaseSys, 10), 6)):
            t0 = time.monotonic()
            bd = measure_wave_breakdown(build(), batch_size=4096,
                                        table_capacity=1 << 22,
                                        max_waves=waves, device="cuda:0")
            sec = time.monotonic() - t0
            st = bd["stages_sec"]
            if st["dedup_insert"] <= 0 or st["wave_kernel"] <= 0:
                raise AssertionError(f"{tag} breakdown: {st}")
            roof = {k: v["share"] for k, v in bd["roofline"].items()
                    if v["share"] is not None}
            _log(f"{tag} wave breakdown at batch 4,096 ({sec:.1f} s): "
                 f"{bd['waves']} waves, {bd['states']} states; seconds "
                 f"{st}; shares {bd['stages_share']}; staged "
                 f"{bd['staged_total_sec']} s against the production wave "
                 f"{bd['fused_wave_sec']} s (ladder "
                 f"{bd['fused_wave_ladder_sec']} s); roofline shares "
                 f"{roof}; host stage {st['host']} s of "
                 f"{bd['staged_total_sec']}")
            out[tag, "breakdown"] = bd
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def _obs_rows(torch, kernels, fused):
    """Phase 18, which gives no rows of its own (it launches the kernels
    of phases 2 to 6 and holds their launches)."""
    _clocked("phase 18", phase_obs, torch, kernels, fused)
    return []


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
            model = re.search(r"(TwoPhase|PaxosServer|SingleCopyServer"
                              r"|AbdServer|IncrementLock|Increment"
                              r"|SlidingPuzzle|PingPong|Vsr)ILi(\d+)E"
                              r"(?:Li(\d+)E)?(?:Li(\d+)E)?(?:Lb(\d)E)?"
                              r"|(LinearEquation|DGraph)", mangled)
            tail = re.search(r"(WaveTail|SenderTail)", mangled)
            if model and model.group(6):
                name = model.group(6)
            elif model:
                name = model.group(1).replace("Server", "") + "<" + ", ".join(
                    g for g in model.groups()[1:4] if g) + (
                    ", true" if model.group(5) == "1" else "") + ">"
            if model and "PlanStep" in mangled:
                name = f"PlanStep<{name}>"
            kernel = ((fn.group(1) if fn else mangled)
                      + (f"<{name}, {tail.group(1)}>" if model and tail
                         else ""))
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
    def entries(name, kinds, source):
        # Each model's params' C types (wave._kinds); the sender entry
        # point too where it shares the wave kernel's source, and the plan
        # forms where the source holds them.
        if source in wave_mod.SENDER_SOURCES:
            return lambda: wave_mod._entry(name, kinds, source=source)
        plans = (True,) if name in ("twopc", "increment",
                                    "increment_lock") else ()
        return lambda: [fn(name, kinds, plan) for plan in (False,) + plans
                        for fn in (wave_mod._entry, wave_mod._sender_entry)]

    # (model, its params' C types, the source's name: wave._source)
    models = (("twopc", "i", "twopc"), ("paxos", "ii", "paxos"),
              ("paxos", "ii", "paxos4"),
              ("single_copy", "iii", "single_copy"),
              ("abd", "iii", "abd"), ("linear_equation", "",
                                      "linear_equation"),
              ("dgraph", "p", "dgraph"), ("increment", "i", "increment"),
              ("increment_lock", "i", "increment_lock"),
              ("sliding_puzzle", "ii", "sliding_puzzle"),
              ("pingpong", "iiiii", "pingpong"), ("vsr", "iiiii", "vsr"))
    jobs = ([("table", table_mod._lib)]
            + [("wave_" + source, entries(name, kinds, source))
               for name, kinds, source in models]
            + [(wave_mod.SENDER_SOURCES[source], functools.partial(
                wave_mod._sender_entry, name, kinds, source=source))
               for name, kinds, source in models
               if source in wave_mod.SENDER_SOURCES]
            + [("append", append_mod._lib)])
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


def _phase_kernels(torch, engine, fused, table_mod, wave_mod, append_mod,
                   TwoPhaseSys, PaxosSys):
    """Phases 2 to 4: each kernel against its plain version at full width,
    timed."""
    w, rows, wave_case = _clocked(
        "the wave kernel's holds", phase_wave_kernel, torch, wave_mod,
        table_mod, engine, TwoPhaseSys)
    paxos_mid = _clocked("paxos 3's mid-run point", _paxos_mid, PaxosSys)
    k = _clocked("the dedup kernel's holds and the rehash", phase_kernel,
                 torch, table_mod, engine, fused, wave_case, TwoPhaseSys,
                 paxos_mid)
    ap = _clocked("the append kernel's holds", phase_append, torch, engine,
                  wave_mod, table_mod, append_mod, rows, wave_case[1],
                  paxos_mid)
    del wave_case
    sk = _clocked("the sender kernel's holds", phase_sender_kernel, torch,
                  wave_mod, table_mod, *rows)
    del rows
    pw, psk = _clocked("paxos 3's kernel holds", phase_paxos_kernels, torch,
                       wave_mod, table_mod, paxos_mid)
    del paxos_mid
    return dict(w=w, k=k, ap=ap, sk=sk, pw=pw, psk=psk)


def _phase_small(torch, fused, TwoPhaseSys, TwoPhaseDevice, PaxosSys,
                 PaxosDevice):
    """Phase 5: the small runs against the CPU, the refusals and the host
    loop's gates."""
    _clocked("2pc's small runs", phase_small, TwoPhaseSys)
    _clocked("2pc's small sharded runs", phase_sharded_small, torch, fused,
             TwoPhaseSys)
    _clocked("paxos' small runs", phase_paxos_small, PaxosSys, PaxosDevice)
    _clocked("the refusals", phase_refusals, TwoPhaseSys, TwoPhaseDevice)
    _clocked("the host loop's gates", phase_gates, torch, TwoPhaseSys,
             PaxosSys)


def _phase_full_runs(torch, kernels, fused, TwoPhaseSys, PaxosSys):
    """Phase 6: the full-width runs of 2pc 10 and ``paxos check 3``, each
    path's run reading its own kernels' launches."""
    # 2pc at 10 RMs on
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
            ("2pc 10, wave kernel, depth 2", twopc[:5] + (0,),
             dict(batch_size=BATCH, wave_kernel=True,
                  inflight_dispatches=2)),
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
        full[tag] = dict(zip(("launches", "run"), _clocked(
            f"{tag}, run and points", phase_full, torch, kernels, fused,
            *cfg, **spawn)))
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
    _log(f"2pc 10 on the wave kernel, graphs on, the in-flight depth alone: "
         f"depth 1 {full['2pc 10, wave kernel']['run']['sec']} s (the "
         f"defaults), depth 2 "
         f"{full['2pc 10, wave kernel, depth 2']['run']['sec']} s")
    buckets = full["paxos 3, ladder"]["run"]["buckets"]
    if len(buckets) < 2:
        raise AssertionError(f"paxos 3 on a ladder used one bucket: "
                             f"{buckets}")
    return full


def _earlier_rows(k, w, pw, sk, psk, ap, full, ck, cl):
    """The kernels line's rows of phases 2 to 8."""
    # Kernel 1 on the synthetic stream, on the default path's input of
    # each model (a mid-run wave's dedup fingerprints), and at the
    # rehash; kernels 2 and 3 on each model's mid-run rows; the append
    # kernel on the mid-run waves' outputs.
    src, pallas = SRC, PALLAS
    k_err = max(v["max_abs_err"] for v in k.values())
    w_err = max(v["max_abs_err"] for v in (*w.values(), *pw.values()))
    s_err = max(v["max_abs_err"] for v in (*sk.values(), *psk.values()))
    a_err = max(v["max_abs_err"] for v in ap.values())

    def launched(tag, name):
        return full[tag]["launches"][name]

    launches = launched("2pc 10", "dedup_and_insert")
    return [
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
        _kernel_row("sender_megakernel[paxos 3]", src + "sender_paxos.cu",
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
                             "append_rows"), a_err, ap["sharded"])]


def _register_rows(holds, runs):
    """The kernels line's rows of the register phase: kernels 2 and 3 on
    single-copy 4 (the wave kernel plain and with symmetry) and ABD 2/2,
    each with its launches in the model's full run on that kernel."""
    src, pallas = SRC, PALLAS

    def launched(tag, engine, name):
        # a configuration run to its end once has its sharded run cut
        key = tag if (tag, engine, True) in runs else _cut(tag)
        return runs[key, engine, True]["launches"][name]

    return [
        _kernel_row("wave_megakernel[single_copy 4]",
                    src + "wave_single_copy.cu", pallas + "380",
                    launched("single_copy 4", "fused", "wave_megakernel"),
                    0, holds["single_copy 4", "plain"]),
        _kernel_row("wave_megakernel[single_copy 4 sym]",
                    src + "wave_single_copy.cu", pallas + "380",
                    launched("single_copy 4 sym", "fused",
                             "wave_megakernel"),
                    0, holds["single_copy 4", "sym"]),
        _kernel_row("wave_megakernel[abd 2]", src + "wave_abd.cu",
                    pallas + "380",
                    launched("abd 2", "fused", "wave_megakernel"), 0,
                    holds["abd 2", "plain"]),
        _kernel_row("sender_megakernel[single_copy 4]",
                    src + "wave_single_copy.cu", pallas + "451",
                    launched("single_copy 4", "sharded",
                             "sender_megakernel"),
                    0, holds["single_copy 4", "sender"][(False, True)]),
        _kernel_row("sender_megakernel[abd 2]", src + "wave_abd.cu",
                    pallas + "451",
                    launched("abd 2", "sharded", "sender_megakernel"), 0,
                    holds["abd 2", "sender"][(False, True)])]


class _Children:
    """Phases 9 to 18 (``later``, in order), each in a process of its own
    (``--phases <phase>``) whose log it passes on and whose kernels line's
    rows it returns. After phases 2 to 8 in one process, about half of the
    profiles the register phase took there recorded no device time on the
    card; a fresh process records them all. Each process is started a turn
    ahead (``ahead``, then as the one before it is let go): it imports the
    port, loads its kernels and the card, and waits for a line on its
    standard input (``CHIP_SMOKE_WAIT``), so that its start overlaps the
    phase before it."""

    def __init__(self, card: str, later):
        self.card, self.queue, self.procs = card, list(later), {}

    def _start(self, phase: str) -> None:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phases", phase],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=dict(os.environ, CHIP_SMOKE_WAIT="1"))
        # A phase that hangs is killed: its output then ends, and it fails.
        timer = threading.Timer(900, proc.kill)
        timer.daemon = True
        timer.start()
        self.procs[phase] = (proc, timer)

    def ahead(self) -> None:
        """Starts the first waiting phase's process, if none is running."""
        if self.queue and self.queue[0] not in self.procs:
            self._start(self.queue[0])

    def run(self, phase: str):
        """Lets ``phase``'s process go (the next one starts meanwhile) and
        returns its rows once it has printed its result line."""
        assert self.queue and self.queue[0] == phase
        self.ahead()
        proc, _ = self.procs[phase]
        proc.stdin.write("go\n")
        proc.stdin.close()
        self.queue.pop(0)
        self.ahead()
        rows = ok = None
        for line in proc.stdout:
            line = line.rstrip("\n")
            if line.startswith('{"kernels": '):
                rows = json.loads(line)["kernels"]
            elif line.startswith('{"ok": '):
                ok = json.loads(line)
                break
            elif not line.startswith("card: ") and line != self.card:
                _log(line)
        rc = proc.wait() if ok is None else 0
        if rc != 0 or rows is None or not ok:
            raise AssertionError(f"the {phase} phase's process failed (rc "
                                 f"{proc.wait()})")
        return rows

    def close(self) -> None:
        """Waits for every process it started (each past its result line
        only exits), stopping any still waiting or running."""
        for proc, timer in self.procs.values():
            if proc.poll() is None and not proc.stdin.closed:
                proc.stdin.close()  # a waiting phase reads no go: it ends
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            timer.cancel()
            proc.stdout.close()


#: each phase's CPU reference runs, as ``_CpuRefs.ahead`` takes them
_PHASE_REFS = {
    "small": _small_refs, "registers": _register_refs,
    "classic": lambda: [(build, _classic_cpu(batch_size=batch))
                        for _, build, _, batch in CLASSIC_SMALL],
    "corpus": lambda: _corpus_refs(_corpus_configs()),
    "actors": lambda: _corpus_refs([(tag, build, 1024, "found")
                                    for tag, build, _ in ACTOR_CONFIGS])}

#: the phases ``--phases`` can name, in the order they run
PHASES = ("kernels", "small", "full", "checkpoint", "classic", "registers",
          "corpus", "actors", "sharded_classic", "matmul", "sizes",
          "fallback", "tiered", "obs")


def _parse(argv):
    """``(phases, rehash)`` of the command line, or None when it is not
    one of the forms in the usage text."""
    if argv == []:
        return set(PHASES), False
    if argv == ["--rehash"]:
        return set(), True
    if len(argv) == 2 and argv[0] == "--phases":
        names = set(argv[1].split(","))
        if names <= set(PHASES):
            return names, False
    return None


def main(argv) -> int:
    try:
        return _main(argv)
    finally:
        _REFS.close()


def _main(argv) -> int:
    parsed = _parse(argv)
    if parsed is None:
        print(__doc__, file=sys.stderr)
        return 2
    phases, rehash = parsed
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    (_build, engine, fused, table_mod, wave_mod, append_mod, ckpt_mod,
     TwoPhaseDevice, TwoPhaseSys, PaxosDevice, PaxosSys) = _modules()
    t_start = time.monotonic()
    _clocked("the build", phase_build, _build, table_mod, wave_mod,
             append_mod)
    card = _card_line()
    _log(f"card: {card}")
    # The CPU reference runs of the phases this process runs, made ahead
    # in worker processes (``_CpuRefs``): phases 9 to 18 run in processes
    # of their own unless one is asked for alone.
    here = phases if len(phases) == 1 else phases & set(PHASES[:5])
    _REFS.ahead(job for phase in PHASES if phase in here
                for job in _PHASE_REFS.get(phase, list)())
    if os.environ.get("CHIP_SMOKE_WAIT"):
        # Started a turn ahead (``_Children``): the port, its kernels and
        # the card are loaded; the phase runs once the parent says so, and
        # not at all when its input ends first.
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        for phase in phases & set(_WARM):
            _WARM[phase](torch)
        if not sys.stdin.readline():
            return 1
        t_start = time.monotonic()
    if rehash:
        r = phase_rehash(torch, table_mod, engine, fused, TwoPhaseSys)
        print(json.dumps({"rehash": {
            key: r[key] for key in ("ms", "plain_ms", "bound_ms", "parts",
                                    "peak", "runs", "one_call")}}))
        return 0

    kernels = {fn.__name__: fn for fn in fused.KERNELS}
    old = {}
    if "kernels" in phases:
        old.update(_clocked("phases 2 to 4", _phase_kernels, torch, engine,
                            fused, table_mod, wave_mod, append_mod,
                            TwoPhaseSys, PaxosSys))
    if "small" in phases:
        _clocked("phase 5", _phase_small, torch, fused, TwoPhaseSys,
                 TwoPhaseDevice, PaxosSys, PaxosDevice)
    if "full" in phases:
        old["full"] = _clocked("phase 6", _phase_full_runs, torch, kernels,
                               fused, TwoPhaseSys, PaxosSys)
    if "checkpoint" in phases:
        # The small gates against the CPU, paxos 3 and 2pc 10 at full
        # width, the resumed table's build.
        old["ck"] = _clocked("phase 7", phase_checkpoint, torch, kernels,
                             fused, table_mod, engine, ckpt_mod, TwoPhaseSys,
                             PaxosSys)
    # Phases 9 to 18 each in a process of its own, unless it is the only
    # one asked for; the first starts while phase 8 runs.
    alone = len(phases) == 1
    children = _Children(card, [] if alone else
                         [p for p in PHASES[5:] if p in phases])
    try:
        return _later_phases(torch, kernels, fused, engine, wave_mod,
                             table_mod, ckpt_mod, TwoPhaseSys, PaxosSys,
                             phases, old, card, children, t_start)
    finally:
        children.close()


def _later_phases(torch, kernels, fused, engine, wave_mod, table_mod,
                  ckpt_mod, TwoPhaseSys, PaxosSys, phases, old, card,
                  children, t_start) -> int:
    """Phases 8 to 19 of ``main``."""
    alone = len(phases) == 1
    if "classic" in phases:
        children.ahead()
        # Its small gates against the CPU, then paxos 3 and 2pc 10 on both
        # successor paths beside the fused runs of phase 6.
        old["cl"] = _clocked("phase 8", phase_classic, torch, kernels,
                             ckpt_mod, TwoPhaseSys, PaxosSys, old.get("full"))
    rows = []
    if set(PHASES[:5]) <= phases:
        rows += _earlier_rows(**{key: old[key] for key in (
            "k", "w", "pw", "sk", "psk", "ap", "full", "ck", "cl")})
    here = {
        "registers": lambda: _register_rows(*phase_registers(
            torch, kernels, fused, wave_mod, table_mod)),
        "corpus": lambda: _corpus_rows(*phase_corpus(
            torch, kernels, fused, wave_mod, table_mod)),
        "actors": lambda: _actor_rows(*phase_actors(
            torch, kernels, fused, wave_mod, table_mod)),
        "sharded_classic": lambda: _sharded_classic_rows(
            *phase_sharded_classic(torch, kernels, wave_mod, table_mod)),
        "matmul": lambda: _matmul_rows(*_clocked(
            "phase 13", phase_matmul, torch, kernels, fused, wave_mod,
            table_mod)),
        "sizes": lambda: _clocked("phase 14", phase_sizes, torch, kernels,
                                  fused, engine, wave_mod, table_mod)[0],
        "fallback": lambda: _clocked("phase 15", phase_fallback, torch)
        + _clocked("phase 16", phase_host, torch, card),
        "tiered": lambda: _tiered_rows(torch, kernels),
        "obs": lambda: _obs_rows(torch, kernels, fused)}
    for phase in PHASES[5:]:
        if phase not in phases:
            continue
        if alone:
            rows += here[phase]()
        else:
            rows += _clocked(f"the {phase} phase's process", children.run,
                             phase)
    print(json.dumps({"kernels": rows}))
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
