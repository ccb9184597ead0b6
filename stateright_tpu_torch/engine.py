"""The stage functions of one BFS wave, as plain torch ops.

The port's copy of the wave building blocks of
``stateright_tpu/tpu/engine.py``: the dispatch width's bucket ladder, the
classic engine's output ladder, property evaluation, expansion,
fingerprinting, the two dedup levels and compaction. The dedup functions
here (``first_occurrence_candidates``, ``global_insert`` and their
composition ``dedup_and_insert``) are the plain version of the CUDA
kernel in ``table.py`` and the reference it is held to; the engines
reach them only through ``table.dedup_and_insert`` and the kernels of
``wave``, which take them for CPU tensors alone. The sharded wave's
sender side takes its first occurrence from ``first_occurrence_sorted``,
the same function with no synchronisation. ``mux_wave`` is the
multiplexer's wave (``service/mux.py``), which inserts through kernel 1.

Hash constants and slot/step functions equal the reference's, so a table
built by either side is a valid probe structure for the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .hashing import SENTINEL, SENTINEL_U64, device_fp64

__all__ = ["batch_bucket_ladder", "pick_bucket", "succ_bucket_ladder",
           "eval_properties",
           "expand_frontier", "fingerprint_successors",
           "cumsum_rows", "compaction_order", "first_occurrence_sorted",
           "TABLE_MIX",
           "STEP_MIX", "slot_hash", "host_table_insert", "scratch_slots",
           "first_occurrence_candidates", "global_insert",
           "dedup_and_insert", "mux_wave"]

# Fibonacci mixing constant (2^64 / golden ratio): the HIGH bits of
# fp * TABLE_MIX pick the home slot. STEP_MIX makes the odd double-hashing
# step, so each key walks its own sequence through the power-of-two table.
TABLE_MIX = 0x9E3779B97F4A7C15
STEP_MIX = 0xC2B2AE3D27D4EB4F


def _signed(c: int) -> int:
    return c - (1 << 64) if c >> 63 else c


def batch_bucket_ladder(base: int, max_batch) -> tuple:
    """The dispatch widths the host loop picks from: ``base``, then
    doublings up to ``max_batch`` rounded up to a power of two (capped by
    that power when the doublings of a base that is not one stop short).
    With ``max_batch`` unset, or at most ``base``, the one rung
    ``(base,)``. The BFS's results do not depend on the width (the first
    occurrence keeps the queue's order whatever a wave holds), so the
    ladder is a schedule only."""
    base = max(1, int(base))
    if not max_batch or int(max_batch) <= base:
        return (base,)
    top = 1 << max(0, int(max_batch) - 1).bit_length()
    ladder = [base]
    while ladder[-1] * 2 <= top:
        ladder.append(ladder[-1] * 2)
    if ladder[-1] < int(max_batch):
        ladder.append(top)
    return tuple(ladder)


def pick_bucket(ladder: tuple, width: int) -> int:
    """The least rung that covers ``width`` queued rows, else the widest
    (the queue then drains over several full-width waves)."""
    for b in ladder:
        if width <= b:
            return b
    return ladder[-1]


def succ_bucket_ladder(full: int, base: int = 256) -> tuple:
    """The classic engine's output ladder: how many compacted new rows a
    wave emits. ``base`` times powers of four, then ``full`` (the wave's
    ``B * F`` successors, so that any wave fits the last rung). A wave
    whose new rows outgrow its rung is regathered at a rung that fits,
    so the ladder bounds the rows a wave sends to the host and never
    changes a result."""
    full = max(1, int(full))
    if full <= base:
        return (full,)
    rungs = []
    k = base
    while k < full:
        rungs.append(k)
        k *= 4
    rungs.append(full)
    return tuple(rungs)


def eval_properties(prop_fns, rows: torch.Tensor):
    """Each property predicate over the batch (at "pop time"); None for
    a property the host evaluates (the classic engine's)."""
    return [None if fn is None else fn(rows) for fn in prop_fns]


def expand_frontier(dm, rows: torch.Tensor, valid: torch.Tensor):
    """Successors with boundary pruning: ``(succ_flat [B*F, W],
    valid_flat [B*F], succ_count (int64), terminal [B])``; a terminal
    row has no successor inside the boundary."""
    succ, sv = dm.step(rows)
    sv = sv & valid[:, None]
    b, f, w = succ.shape
    succ_flat = succ.reshape(b * f, w)
    inside = dm.boundary(succ_flat)
    if inside is not None:
        sv = sv & inside.reshape(b, f)
    terminal = valid & ~sv.any(dim=1)
    return succ_flat, sv.reshape(b * f), sv.sum(dtype=torch.int64), terminal


def fingerprint_successors(dm, succ_flat: torch.Tensor,
                           valid_flat: torch.Tensor, use_sym: bool):
    """``(dedup_fps, path_fps)``: under symmetry, dedup by the
    representative's fingerprint but continue paths with the original
    row's. Invalid rows carry the sentinel."""
    path_fps = device_fp64(succ_flat)
    dedup_fps = (device_fp64(dm.representative(succ_flat)) if use_sym
                 else path_fps)
    dedup_fps = torch.where(valid_flat, dedup_fps,
                            torch.full_like(dedup_fps, SENTINEL))
    return dedup_fps, path_fps


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 prefix sums along the last dim of ``[..., n]``, as
    one scan of the flattened tensor: a scan along the last dim of a few
    long rows runs one block a row on CUDA, a thousand times slower."""
    flat = torch.cumsum(x.reshape(-1), 0, dtype=torch.int64).view(x.shape)
    if x.dim() == 1:
        return flat
    return flat - (flat[..., :1] - x[..., :1].to(torch.int64))


def compaction_order(mask: torch.Tensor) -> torch.Tensor:
    """Indices that bring ``mask``'s True rows to the front, both halves
    in their original order (a stable argsort of ~mask, by a prefix sum),
    along the last dim of ``[..., n]``."""
    n = mask.shape[-1]
    rows = torch.arange(n, dtype=torch.int64, device=mask.device)
    kept = cumsum_rows(mask)
    # A dropped row has rows - kept dropped rows before it.
    slot = torch.where(mask, kept - 1, kept[..., -1:] + rows - kept)
    return torch.empty_like(slot).scatter_(-1, slot, rows.expand_as(slot))


def first_occurrence_sorted(fps: torch.Tensor) -> torch.Tensor:
    """True at the earliest row of each non-sentinel fingerprint along
    the last dim of ``[..., n]``: the function of
    ``first_occurrence_candidates`` by a stable sort, with no
    synchronisation, for the sender side of the sharded wave."""
    key, order = torch.sort(fps, dim=-1, stable=True)
    first = torch.ones_like(key, dtype=torch.bool)
    first[..., 1:] = key[..., 1:] != key[..., :-1]
    first &= key != SENTINEL
    return torch.empty_like(first).scatter_(-1, order, first)


def slot_hash(fps: torch.Tensor, capacity: int):
    """``(home, step)`` of each fingerprint in a power-of-two table: the
    high bits of fp*TABLE_MIX, and an odd step from fp*STEP_MIX (a
    logical right shift, done as an arithmetic one plus a mask)."""
    bits = capacity.bit_length() - 1
    shift, mask = 64 - bits, capacity - 1
    home = ((fps * _signed(TABLE_MIX)) >> shift) & mask
    step = (((fps * _signed(STEP_MIX)) >> shift) & mask) | 1
    return home, step


def host_table_insert(table: np.ndarray, fps: np.ndarray) -> None:
    """Inserts uint64 fingerprints into a host copy of the table with the
    same slot and step functions (for seeding)."""
    if not len(fps):
        return
    capacity = len(table)
    mask = np.int64(capacity - 1)
    shift = np.uint64(64 - (capacity.bit_length() - 1))
    fps = fps.astype(np.uint64)
    with np.errstate(over="ignore"):
        idx = ((fps * np.uint64(TABLE_MIX)) >> shift).astype(np.int64)
        step = ((fps * np.uint64(STEP_MIX)) >> shift).astype(np.int64) | 1
    pending = np.ones(len(fps), bool)
    while pending.any():
        cur = table[idx]
        found = pending & (cur == fps)
        empty = pending & (cur == SENTINEL_U64)
        table[idx[empty]] = fps[empty]
        won = empty & (table[idx] == fps)
        pending &= ~(found | won)
        idx = np.where(pending, (idx + step) & mask, idx)


def scratch_slots(n: int) -> int:
    """Slots of the first-occurrence scratch table for ``n`` rows: a
    power of two of at least ``2n`` (and 16), as in the reference."""
    return 1 << max((n - 1).bit_length() + 1, 4)


def first_occurrence_candidates(fps: torch.Tensor) -> torch.Tensor:
    """True at the EARLIEST row of each non-sentinel fingerprint (the
    BFS enqueue order). A scratch table of ``m >= 2n`` slots; each round
    a scatter-min of the row index resolves one whole fp group per
    contended slot, and unresolved groups advance by their odd step.
    Synchronises once a round: the plain version, not for the card's
    dispatch."""
    n = fps.shape[0]
    first = torch.zeros(n, dtype=torch.bool, device=fps.device)
    if n == 0:
        return first
    m = scratch_slots(n)
    h, step = slot_hash(fps, m)
    rows = torch.arange(n, dtype=torch.int64, device=fps.device)
    pending = fps != SENTINEL
    while bool(pending.any()):
        # slot m is the drop slot for rows that already resolved
        scratch = torch.full((m + 1,), n, dtype=torch.int64,
                             device=fps.device)
        scratch.scatter_reduce_(0, torch.where(pending, h, m), rows,
                                reduce="amin")
        winner_row = scratch[h]
        winner_fp = fps[winner_row.clamp(max=n - 1)]
        same = pending & (winner_fp == fps)
        first |= same & (winner_row == rows)
        pending &= ~same
        h = torch.where(pending, (h + step) & (m - 1), h)
    return first


def global_insert(fps: torch.Tensor, candidate: torch.Tensor,
                  table: torch.Tensor):
    """Insert-or-test of distinct candidates against the open-addressing
    table, IN PLACE: ``(new_mask, full)``. Each round a pending row
    reads its slot: its own fp means seen, the sentinel means claim it
    (scatter, then re-read to see which of two racing keys won), any
    other key means advance. After ``capacity`` rounds a still-pending
    row has seen every slot taken: ``full`` is then True."""
    capacity = table.shape[0]
    idx, step = slot_hash(fps, capacity)
    pending = candidate.clone()
    is_new = torch.zeros_like(candidate)
    for _ in range(capacity):
        if not bool(pending.any()):
            break
        cur = table[idx]
        found = pending & (cur == fps)
        empty = pending & (cur == SENTINEL)
        table[idx[empty]] = fps[empty]
        won = empty & (table[idx] == fps)
        is_new |= won
        pending &= ~(found | won)
        idx = torch.where(pending, (idx + step) & (capacity - 1), idx)
    return is_new, pending.any()


def dedup_and_insert(fps: torch.Tensor, table: torch.Tensor):
    """The plain dedup: first occurrence within the wave, then the table
    probe. Updates ``table`` in place and returns ``(new_mask, cand_mask,
    new_count, cand_count, full)``, the counts as int32 tensors."""
    cand = first_occurrence_candidates(fps)
    new_mask, full = global_insert(fps, cand, table)
    return (new_mask, cand, new_mask.sum(dtype=torch.int32),
            cand.sum(dtype=torch.int32), full)


def mux_wave(dm, vecs: torch.Tensor, valid: torch.Tensor,
             tag_fps: torch.Tensor, table: torch.Tensor, layout,
             prop_fns=(), scratch=None):
    """The multi-tenant wave (the reference's ``build_mux_wave``,
    ``tpu/engine.py:2123-2210``): one BFS level over a batch drawn from
    several jobs' queues. ``vecs int32[B, Wp + 1]`` are tenant-lane rows
    (``layout.with_tenant_lane()``), ``valid bool[B]``, ``tag_fps
    int64[J]`` each slot's 64-bit tag (int64 bit patterns), ``table
    int64[C]`` the visited table the tenants share, updated in place.
    Returns, in the reference's order, ``(conds, terminal, seg_succ,
    seg_cand, seg_novel, new_count, new_vecs, new_fps, new_dedup,
    new_parent, full)``.

    Each tenant's dedup fingerprints are XORed with its tag before the
    dedup, so the one table holds per-(tenant, state) entries and tenants
    never dedup against each other. The dedup is kernel 1
    (``table.dedup_and_insert``, with ``scratch``) where JAX runs its XLA
    ``first_occurrence_candidates`` and ``global_insert``: the port's
    choice; on the CPU it runs its plain version, which is those two.
    Path fingerprints stay untagged, and ``new_dedup`` returns the
    untagged dedup fingerprints of the new rows, each tenant's visited
    set for its checkpoint. ``seg_succ``, ``seg_cand`` and ``seg_novel``
    are int64 segment sums over the ``J`` slots. The output rung is the
    whole ``B * F``: new rows come back compacted in frontier order (a
    stable compaction, the earliest row of each key first), so each
    tenant's come in its solo engine's order. Nothing here reads a
    device value on the host: it can run inside a CUDA graph."""
    # ``table`` imports this module (the kernel's plain version is here).
    from .table import dedup_and_insert as dedup_kernel

    J, F = tag_fps.shape[0], dm.max_fanout
    slots = layout.tenant(vecs).clamp(0, J - 1)
    rows = layout.unpack(vecs)
    conds = eval_properties(prop_fns, rows)
    succ, sflat, _, terminal = expand_frontier(dm, rows, valid)
    dedup_raw = device_fp64(succ)
    flat_slots = slots.repeat_interleave(F)
    tagged = torch.where(sflat, dedup_raw ^ tag_fps[flat_slots],
                         torch.full_like(dedup_raw, SENTINEL))
    new_mask, cand_mask, new_count, _, full = dedup_kernel(
        tagged, table, scratch=scratch)

    def seg_sum(mask):
        return torch.zeros(J, dtype=torch.int64, device=vecs.device
                           ).scatter_add_(0, flat_slots, mask.to(torch.int64))

    comp = compaction_order(new_mask)
    parent = comp // F
    new_vecs = layout.pack_tenant(succ[comp], slots[parent])
    # No symmetry in a group: the path and dedup fingerprints are one.
    new_fps = dedup_raw[comp]
    conds_out = [c for c in conds if c is not None]
    return (conds_out, terminal, seg_sum(sflat), seg_sum(cand_mask),
            seg_sum(new_mask), new_count, new_vecs, new_fps, new_fps,
            parent.to(torch.int32), full)

