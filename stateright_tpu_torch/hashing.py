"""64-bit fingerprints of encoded state rows, in torch and on the host.

The port's copy of ``stateright_tpu/tpu/hashing.py``: two murmur3-style
32-bit hashes of a row's ``uint32`` lanes (different seeds), packed into
one ``uint64``. The host twin (``host_fp64``) computes the same function,
so path replay and the device visited table agree on identity.

Dtype policy: torch has almost no unsigned arithmetic on CUDA, so lanes
are ``int64`` tensors holding values in ``[0, 2^32)``, masked to 32 bits
after every multiply or shift, and a fingerprint is the ``int64`` bit
pattern of its ``uint64`` value. All-ones (``SENTINEL``, ``-1`` as int64)
marks an empty table slot or an invalid row, and zero is avoided; real
fingerprints landing on either are nudged exactly as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SENTINEL", "SENTINEL_U64", "device_fp64", "host_fp64",
           "host_fp64_batch", "to_u64", "to_i64"]

#: the empty-slot / invalid-row fingerprint as an int64 bit pattern
SENTINEL = -1
#: the same value as the reference's uint64
SENTINEL_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_SEED_HI = 0x9747B28C
_SEED_LO = 0x2E1F36D9
_M32 = 0xFFFFFFFF


def to_u64(fp: int) -> int:
    """An int64 bit pattern as the uint64 value it stands for."""
    return int(fp) & 0xFFFFFFFFFFFFFFFF


def to_i64(fp: int) -> int:
    """A uint64 value as its int64 bit pattern."""
    fp = int(fp) & 0xFFFFFFFFFFFFFFFF
    return fp - (1 << 64) if fp >> 63 else fp


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _mm3_fold(h, k):
    """One murmur3_32 round absorbing lane ``k`` into state ``h``."""
    k = (k * _C1) & _M32
    k = _rotl32(k, 15)
    k = (k * _C2) & _M32
    h = _rotl32(h ^ k, 13)
    return (h * 5 + 0xE6546B64) & _M32


def _mm3_final(h, nbytes: int):
    h = h ^ nbytes
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def device_fp64(rows: torch.Tensor) -> torch.Tensor:
    """Fingerprints encoded rows: ``int64[..., W] -> int64[...]``.

    ``rows`` holds uint32 lane values (``0 <= v < 2^32``); the result is
    the uint64 fingerprint's int64 bit pattern. Elementwise and
    synchronisation-free, so it runs inside a dispatch on the card.
    """
    w = rows.shape[-1]
    hi = torch.full(rows.shape[:-1], _SEED_HI, dtype=torch.int64,
                    device=rows.device)
    lo = torch.full_like(hi, _SEED_LO)
    for i in range(w):
        lane = rows[..., i]
        hi = _mm3_fold(hi, lane)
        lo = _mm3_fold(lo, lane)
    hi = _mm3_final(hi, 4 * w)
    lo = _mm3_final(lo, 4 * w)
    fp = (hi << 32) | lo
    fp = torch.where(fp == SENTINEL, fp - 1, fp)
    return torch.where(fp == 0, torch.ones_like(fp), fp)


def _host_mm3(words: np.ndarray, seed: int) -> int:
    h = seed
    for k in words:
        k = (int(k) * _C1) & _M32
        k = ((k << 15) | (k >> 17)) & _M32
        k = (k * _C2) & _M32
        h ^= k
        h = ((h << 13) | (h >> 19)) & _M32
        h = (h * 5 + 0xE6546B64) & _M32
    h ^= 4 * len(words)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def host_fp64(vec: np.ndarray) -> int:
    """The fingerprint of one encoded state (a uint64 Python int)."""
    fp = (_host_mm3(vec, _SEED_HI) << 32) | _host_mm3(vec, _SEED_LO)
    if fp == int(SENTINEL_U64):
        fp -= 1
    return fp if fp != 0 else 1


def host_fp64_batch(vecs: np.ndarray) -> np.ndarray:
    """Vectorized ``host_fp64`` over ``uint32[N, W]`` -> ``uint64[N]``."""
    vecs = np.asarray(vecs, np.uint32)
    n, w = vecs.shape
    out = np.zeros(n, np.uint64)
    with np.errstate(over="ignore"):
        for shift, seed in ((32, _SEED_HI), (0, _SEED_LO)):
            h = np.full(n, seed, np.uint32)
            for i in range(w):
                k = vecs[:, i] * np.uint32(_C1)
                k = (k << np.uint32(15)) | (k >> np.uint32(17))
                k = k * np.uint32(_C2)
                h = h ^ k
                h = (h << np.uint32(13)) | (h >> np.uint32(19))
                h = h * np.uint32(5) + np.uint32(0xE6546B64)
            h = h ^ np.uint32(4 * w)
            h ^= h >> np.uint32(16)
            h = h * np.uint32(0x85EBCA6B)
            h ^= h >> np.uint32(13)
            h = h * np.uint32(0xC2B2AE35)
            h ^= h >> np.uint32(16)
            out |= h.astype(np.uint64) << np.uint64(shift)
    out[out == SENTINEL_U64] -= np.uint64(1)
    out[out == 0] = np.uint64(1)
    return out
