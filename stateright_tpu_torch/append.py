"""The append of a wave's new rows to the device arena: the CUDA kernel
and its wrapper.

``append_rows`` replaces the appends of the reference's waves
(``stateright_tpu/tpu/fused.py:311-315`` and ``tpu/sharded_fused.py:
322-329``; not a Pallas kernel, but four full-window updates a wave that
the port's plain version turned into ``index_copy_`` over every row a
wave may append). It writes each shard's new rows, in their compacted
order, at the shard's tail: the packed row, its path fingerprint, its
parent's fingerprint and its eventually bits.

For CUDA tensors it launches the kernel of ``csrc/append.cu`` (built by
``_build`` at first use) or raises; for CPU tensors it runs the plain
version, ``append_rows_plain``, which is also the reference the kernel
is held to on the card. The plain version writes a row for every source
row, those that are not new to each shard's dump row (its last arena
row); the kernel writes the new rows alone. Arena rows ``[0, tail +
new_count)`` are equal bit for bit either way, and no reader looks past
the tail. The kernel reads the counts and tails on the device and has a
fixed grid, so the wrapper never synchronises and a CUDA graph can hold
its launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import build_and_load

__all__ = ["append_rows", "append_rows_plain", "append_cost"]


def append_cost(wp: int, new: int, parents=None, div: int = 1) -> dict:
    """The work ``append_rows`` must do to append ``new`` rows of ``wp``
    packed words from ``parents`` distinct parents (default: one a
    ``div`` new rows, as a full wave of fan-out ``div`` has):
    ``{"bytes", "ops"}``. Bytes, each once: a new row's compaction index
    (8 B) and source row read (its words and fingerprint), its arena row
    written (those, its parent's fingerprint and eventually bits), and a
    parent's 12 B read once. No arithmetic beyond addressing."""
    parents = -(-int(new) // max(1, int(div))) if parents is None \
        else int(parents)
    return {"bytes": new * (2 * (4 * wp + 8) + 8 + 12) + 12 * parents,
            "ops": 0}


def append_rows_plain(arena, src, comp: torch.Tensor,
                      new_count: torch.Tensor, tail: torch.Tensor,
                      div: int) -> None:
    """The plain version of ``append_rows``, in torch ops: one
    ``index_copy_`` a column over every source row."""
    vecs, fps, par, ebits = arena
    s_vecs, s_fps, s_par, s_ebits = src
    n, rows = comp.shape
    arena_rows, wp = vecs.shape[1], vecs.shape[2]
    dev = comp.device
    rr = torch.arange(rows, dtype=torch.int64, device=dev)
    pos = torch.where(rr < new_count[:, None], tail[:, None] + rr,
                      arena_rows - 1)
    pos = (pos + torch.arange(n, dtype=torch.int64, device=dev)[:, None]
           * arena_rows).view(-1)
    parent = comp // div
    vecs.view(n * arena_rows, wp).index_copy_(0, pos, s_vecs.gather(
        1, comp[:, :, None].expand(n, rows, wp)).view(n * rows, wp))
    fps.view(-1).index_copy_(0, pos, s_fps.gather(1, comp).view(-1))
    par.view(-1).index_copy_(0, pos, s_par.gather(1, parent).view(-1))
    ebits.view(-1).index_copy_(0, pos, s_ebits.gather(1, parent).view(-1))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build_and_load("append")
    fn = lib.sr_append_rows
    fn.restype = ctypes.c_int
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [i, ll, i, i, ll] + [p] * 11 + [i, p]
    return lib


def append_rows(arena, src, comp: torch.Tensor, new_count: torch.Tensor,
                tail: torch.Tensor, div: int) -> None:
    """Appends ``n`` stacked shards' new rows, in place. ``arena`` is
    ``(vecs int32[n, U, Wp], fps int64[n, U], par int64[n, U], ebits
    int32[n, U])`` with each shard's dump row at ``U - 1``; ``src`` is
    ``(vecs int32[n, R, Wp], fps int64[n, R], par int64[n, R / div],
    ebits int32[n, R / div])``; ``comp int64[n, R]`` the compaction
    order, new rows first; ``new_count`` and ``tail`` ``int64[n]``. Row
    ``i < new_count[k]`` of shard ``k`` goes to arena row ``tail[k] +
    i``: the packed row and fingerprint of source row ``comp[k, i]``, the
    parent fingerprint and eventually bits of source parent ``comp[k, i]
    // div``."""
    tensors = (*arena, *src, comp, new_count, tail)
    if all(t.device.type == "cpu" for t in tensors):
        append_rows_plain(arena, src, comp, new_count, tail, div)
        return
    dev = comp.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("append_rows: every tensor must be on one CUDA "
                         "device (or all on the CPU)")
    vecs = arena[0]
    n, rows = comp.shape
    U, wp = vecs.shape[1], vecs.shape[2]
    if div < 1 or rows % div:
        raise ValueError(f"{rows} source rows are not {div} a parent")
    shapes = ((n, U, wp), (n, U), (n, U), (n, U), (n, rows, wp), (n, rows),
              (n, rows // div), (n, rows // div), (n, rows), (n,), (n,))
    dtypes = (torch.int32, torch.int64, torch.int64, torch.int32) * 2 + (
        torch.int64,) * 3
    for k, (t, shape, dtype) in enumerate(zip(tensors, shapes, dtypes)):
        if t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"append_rows: argument {k} must be a "
                             f"contiguous {dtype} tensor of shape {shape}, "
                             f"not {t.dtype} {tuple(t.shape)}")
    with torch.cuda.device(dev):
        rc = _lib().sr_append_rows(
            n, rows, div, wp, U, *(t.data_ptr() for t in tensors[4:]),
            *(t.data_ptr() for t in arena),
            torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"append_rows kernel launch failed: CUDA error "
                           f"{rc}")
    append_rows.launches += 1


#: kernel launches since the caller last set it to 0 (the CPU path does
#: not count: it launches nothing)
append_rows.launches = 0
