"""The visited-table dedup of one wave: the CUDA kernel and its wrapper.

``dedup_and_insert`` replaces the Pallas kernel
``stateright_tpu/tpu/pallas_table.py::dedup_and_insert_pallas``. It
marks the earliest row of each non-sentinel fingerprint in the wave,
then inserts those candidates into the open-addressing visited table
(in place) or finds them there already.

For CUDA tensors it launches the kernel of ``csrc/table.cu`` (built by
``_build`` at first use) or raises; for CPU tensors it runs the plain
version, ``dedup_and_insert_plain`` (``engine.dedup_and_insert``), which
is also the reference the kernel is held to on the card. The wrapper
never synchronises, so it can run inside a multi-wave dispatch.

The kernel's scratch (``DedupScratch``, shared with the wave kernel of
``wave.py``) belongs to the caller: an engine keeps one and passes it to
every call (``scratch=``), and the kernels hand it back clean, so a call
fills nothing; the engines' rehash, too, goes through theirs, in chunks of
its rows. Without one the wrapper makes a fresh one for the call; one too
small or on another device raises. The sender
kernel (``wave.sender_megakernel``) claims in the same scratch, a region
of it a shard (``scratch_bits``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import build_and_load
from .engine import dedup_and_insert as dedup_and_insert_plain
from .engine import scratch_slots

__all__ = ["dedup_and_insert", "dedup_and_insert_plain", "DedupScratch",
           "scratch_bits", "dedup_cost", "load_library"]

_INT32_MAX = (1 << 31) - 1


def dedup_cost(n: int, cand=None) -> dict:
    """The work ``dedup_and_insert`` must do on ``n`` fingerprints of
    which ``cand`` are candidates (default: all of them, the most ``n``
    rows can take): ``{"bytes", "ops"}``. Bytes, each once: the
    fingerprints read, the two masks written, and one 32-byte sector a
    candidate in the visited table; the scratch is neither input nor
    output. Operations are not counted (a probe is a few integer
    operations beside its sector), so the bound is the bytes'. The
    profiler's records (``obs/prof.py``) and ``chip_smoke.py``'s bounds
    both come from here."""
    cand = n if cand is None else int(cand)
    return {"bytes": 8 * n + 2 * n + 32 * cand, "ops": 0}


#: a clean scratch slot (``sr::Slot``, two int64 words): the sentinel
#: key, then the row INT32_MAX in the low half and the walk 0 in the high
CLEAN_SLOT = (-1, _INT32_MAX)


def scratch_bits(n: int, shards: int = 1):
    """``(m_bits, region_bits)`` of the kernels' scratch for waves of up
    to ``n`` rows, which the sender kernel splits into ``shards`` shards
    of ``ceil(n / shards)`` rows: shard k claims in the region of
    ``2^region_bits = scratch_slots(ceil(n / shards))`` slots from slot
    ``k << region_bits``, and ``2^m_bits`` is the least power of two that
    holds those regions and the ``scratch_slots(n)`` of a dedup call over
    all ``n`` rows (more than that only for a shard count that is not a
    power of two)."""
    region = scratch_slots(-(-n // shards))
    m = max(scratch_slots(n), 1 << (shards * region - 1).bit_length())
    return m.bit_length() - 1, region.bit_length() - 1


class DedupScratch:
    """The scratch of the dedup, wave and sender kernels for waves of up
    to ``n`` rows (``shards`` shards of them for the sender), on one CUDA
    device: a table of ``2^scratch_bits(n, shards)[0]`` slots of 16 bytes
    (a key, a least row and the outcome of the key's table walk), the
    kernel's tally of three counters, and each row's slot. Made clean;
    every kernel call leaves it clean. Calls that share one must run in
    order on one stream (one checker's waves do); two checkers keep one
    each."""

    def __init__(self, n: int, device, shards: int = 1):
        m_bits = scratch_bits(n, shards)[0]
        if m_bits > 30:
            raise ValueError(f"{n} rows exceed the kernels' int32 row index")
        self.n, self.m_bits = n, m_bits
        m = 1 << m_bits
        self.slots = torch.tensor(CLEAN_SLOT, dtype=torch.int64,
                                  device=device).repeat(m, 1)
        self.tally = torch.zeros(3, dtype=torch.int32, device=device)
        self.slot_of = torch.empty(max(n, 1), dtype=torch.int32,
                                   device=device)

    @classmethod
    def for_call(cls, scratch, n: int, device,
                 shards: int = 1) -> "DedupScratch":
        """A fresh scratch for ``n`` rows in ``shards`` shards on
        ``device`` when ``scratch`` is None, else ``scratch``, which must
        take them there."""
        if scratch is None:
            return cls(n, device, shards)
        if (n > scratch.n or scratch_bits(n, shards)[0] > scratch.m_bits
                or scratch.slots.device != device):
            raise ValueError(
                f"the scratch takes {scratch.n} rows in 2^{scratch.m_bits} "
                f"slots on {scratch.slots.device}, not {n} rows in {shards} "
                f"shard(s) on {device}")
        return scratch

    def args(self):
        """The kernels' scratch arguments: the slots, tally and slot_of
        pointers, then m_bits."""
        return (self.slots.data_ptr(), self.tally.data_ptr(),
                self.slot_of.data_ptr(), self.m_bits)

    def is_clean(self) -> bool:
        """Whether every slot and counter is as made (synchronises)."""
        clean = torch.tensor(CLEAN_SLOT, device=self.slots.device)
        return bool((self.slots == clean).all() and (self.tally == 0).all())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build_and_load("table")
    fn = lib.sr_dedup_and_insert
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_longlong, p, i, p, p, p, i, p, p, p, p]
    return lib


def load_library() -> ctypes.CDLL:
    """Builds ``csrc/table.cu`` (once a build directory) and loads it (once
    a process); a failed build raises."""
    return _lib()


def dedup_and_insert(fps: torch.Tensor, table: torch.Tensor, scratch=None):
    """``fps int64[n]``, ``table int64[C]`` (C a power of two, updated in
    place) -> ``(new_mask bool[n], cand_mask bool[n], new_count,
    cand_count, full)``; the counts are int32 and ``full`` bool 0-dim
    tensors on the same device. ``full`` is True when a candidate found
    neither its key nor a free slot in the whole table. ``scratch``, a
    caller's ``DedupScratch`` for at least ``n`` rows on the tensors'
    device, is used in place of a fresh one."""
    if fps.device.type == "cpu" and table.device.type == "cpu":
        return dedup_and_insert_plain(fps, table)
    if fps.device.type != "cuda" or table.device != fps.device:
        raise ValueError(
            f"fps on {fps.device} and table on {table.device}: both must "
            "be on one CUDA device (or both on the CPU)")
    for name, t in (("fps", fps), ("table", table)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 tensor")
    capacity = table.shape[0]
    if capacity < 2 or capacity & (capacity - 1):
        raise ValueError(f"table capacity {capacity} is not a power of two")
    n, dev = fps.shape[0], fps.device
    scratch = DedupScratch.for_call(scratch, n, dev)
    new_mask = torch.empty(n, dtype=torch.bool, device=dev)
    cand_mask = torch.empty(n, dtype=torch.bool, device=dev)
    counts = torch.empty(3, dtype=torch.int32, device=dev)
    # The launch goes to the current device's context, which in the
    # checker's worker thread is not necessarily the tensors' device.
    with torch.cuda.device(dev):
        rc = _lib().sr_dedup_and_insert(
            fps.data_ptr(), n, table.data_ptr(), capacity.bit_length() - 1,
            *scratch.args(), new_mask.data_ptr(), cand_mask.data_ptr(),
            counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dedup_and_insert kernel launch failed: "
                           f"CUDA error {rc}")
    dedup_and_insert.launches += 1
    return new_mask, cand_mask, counts[0], counts[1], counts[2] != 0


#: kernel launches since the caller last set it to 0 (the CPU path does
#: not count: it launches nothing)
dedup_and_insert.launches = 0
