"""Moves checker state between the JAX package's arrays and the port.

The model checker's counterpart of loading weights: the JAX engine's
state as numpy arrays (its dtypes) becomes the port's tensors (the
port's dtype policy) and back, so that a test can start both sides from
the same state. Every conversion keeps the bits:

- ``uint64`` visited tables, fingerprints and parent fingerprints are
  ``int64`` bit patterns (``SENTINEL`` becomes -1);
- ``uint32`` unpacked rows ``[N, W]`` are ``int64`` lane values;
- ``uint32`` packed rows ``[N, Wp]`` and eventually-bits ``[N]`` are
  ``int32`` bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["u64_in", "u64_out", "rows_in", "rows_out", "words_in",
           "words_out"]


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
