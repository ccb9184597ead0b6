"""Moves checker state between the JAX package's arrays and the port.

The model checker's counterpart of loading weights: the JAX engine's
state as numpy arrays (its dtypes) becomes the port's tensors (the
port's dtype policy) and back, so that a test can start both sides from
the same state. Every conversion keeps the bits:

- ``uint64`` visited tables, fingerprints, parent fingerprints and the
  register workloads' packed observation tables (any shape) are
  ``int64`` bit patterns (``SENTINEL`` becomes -1);
- ``uint32`` unpacked rows ``[N, W]`` (paxos's sentinel lanes, all-ones,
  included) are ``int64`` lane values;
- ``uint32`` packed rows ``[N, Wp]`` and eventually-bits ``[N]`` are
  ``int32`` bit patterns;
- the sharded engine's flat shard-major ``[n * cap]`` table and
  ``[n * ucap, ...]`` arena columns are the port's stacked ``[n, cap]``
  and ``[n, ucap + 1, ...]`` (with each shard's dump row).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["u64_in", "u64_out", "rows_in", "rows_out", "words_in",
           "words_out", "sharded_table_in", "sharded_arena_in"]


def u64_in(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """``uint64[...]`` (table, fps, parent fps) -> ``int64`` tensor."""
    a = np.ascontiguousarray(arr, np.uint64).view(np.int64)
    return torch.from_numpy(a.copy()).to(device)


def u64_out(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint64)


def rows_in(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """``uint32[N, W]`` unpacked rows -> ``int64`` lane values."""
    return torch.from_numpy(np.asarray(arr, np.uint32).astype(np.int64)
                            ).to(device)


def rows_out(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.uint32)


def words_in(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """``uint32[...]`` packed rows or ebits -> ``int32`` bit patterns."""
    a = np.ascontiguousarray(arr, np.uint32).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def words_out(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint32)


def sharded_table_in(table: np.ndarray, n: int, device="cpu") -> torch.Tensor:
    """A sharded engine's flat ``uint64[n * cap]`` visited table -> the
    port's stacked ``int64[n, cap]``."""
    return u64_in(np.asarray(table).reshape(n, -1), device)


def sharded_arena_in(arr: np.ndarray, n: int, device="cpu",
                     layout=None) -> torch.Tensor:
    """A column of a sharded engine's flat arena, ``[n * ucap, ...]``
    (shard-major), -> the port's stacked ``[n, ucap + 1, ...]`` with each
    shard's dump row at ``ucap``: ``uint64`` fingerprints and parents
    become ``int64`` (dump ``SENTINEL``), ``uint32`` eventually-bits and
    rows become ``int32`` bit patterns (dump 0). Unpacked rows
    ``[n * ucap, W]`` are packed with ``layout`` first."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint64:
        fill, conv = np.uint64(0xFFFFFFFFFFFFFFFF), u64_in
    else:
        fill, conv = np.uint32(0), words_in
        if (arr.ndim == 2 and layout is not None
                and arr.shape[1] == layout.width != layout.packed_width):
            arr = layout.pack_np(arr)
    arr = arr.reshape((n, -1) + arr.shape[1:])
    dump = np.full((n, 1) + arr.shape[2:], fill, arr.dtype)
    return conv(np.concatenate([arr, dump], axis=1), device)
