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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import build_and_load
from .engine import dedup_and_insert as dedup_and_insert_plain
from .engine import scratch_slots

__all__ = ["dedup_and_insert", "dedup_and_insert_plain"]

_INT32_MAX = (1 << 31) - 1


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build_and_load("table")
    fn = lib.sr_dedup_and_insert
    fn.restype = ctypes.c_int
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_longlong, p, ctypes.c_int, p, p, p,
                   ctypes.c_int, p, p, p, p]
    return lib


def dedup_and_insert(fps: torch.Tensor, table: torch.Tensor):
    """``fps int64[n]``, ``table int64[C]`` (C a power of two, updated in
    place) -> ``(new_mask bool[n], cand_mask bool[n], new_count,
    cand_count, full)``; the counts are int32 and ``full`` bool 0-dim
    tensors on the same device. ``full`` is True when a candidate found
    neither its key nor a free slot in the whole table."""
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
    n = fps.shape[0]
    m = scratch_slots(n)
    if m > _INT32_MAX:
        raise ValueError(f"{n} rows exceed the kernel's int32 row index")
    dev = fps.device
    keys = torch.full((m,), -1, dtype=torch.int64, device=dev)
    rows = torch.full((m,), _INT32_MAX, dtype=torch.int32, device=dev)
    slot_of = torch.empty(max(n, 1), dtype=torch.int32, device=dev)
    new_mask = torch.empty(n, dtype=torch.bool, device=dev)
    cand_mask = torch.empty(n, dtype=torch.bool, device=dev)
    counts = torch.zeros(3, dtype=torch.int32, device=dev)
    # The launch goes to the current device's context, which in the
    # checker's worker thread is not necessarily the tensors' device.
    with torch.cuda.device(dev):
        rc = _lib().sr_dedup_and_insert(
            fps.data_ptr(), n, table.data_ptr(), capacity.bit_length() - 1,
            keys.data_ptr(), rows.data_ptr(), slot_of.data_ptr(),
            m.bit_length() - 1, new_mask.data_ptr(), cand_mask.data_ptr(),
            counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dedup_and_insert kernel launch failed: "
                           f"CUDA error {rc}")
    dedup_and_insert.launches += 1
    return new_mask, cand_mask, counts[0], counts[1], counts[2] != 0


#: kernel launches since the caller last set it to 0 (the CPU path does
#: not count: it launches nothing)
dedup_and_insert.launches = 0
