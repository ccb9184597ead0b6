"""Model-derived bit-packed row format for the device arena.

The port's copy of ``stateright_tpu/tpu/packing.py``, the multiplexer's
tenant lane included (``with_tenant_lane``). States are computed as ``W`` lanes but most
lanes are far narrower than 32 bits (a 2pc RM state is 2 bits), so the
arena stores each row as ``Wp = ceil(sum(bits) / 32)`` words. The word
layout equals the reference's bit for bit.

Lane specs (one per lane, in lane order):

- ``b`` (1..32): a plain lane whose values fit ``b`` bits.
- ``(b, sentinel)``: values in ``[0, 2^b - 1)`` plus one out-of-band
  sentinel, stored as the field's all-ones pattern.

Torch codec dtypes: unpacked lanes are ``int64`` (uint32 values), packed
words are ``int32`` bit patterns of the uint32 words. The numpy twins
work on ``uint32`` for the host's cold paths.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["PackedLayout", "compile_layout"]

_M32 = 0xFFFFFFFF


class _Lane:
    __slots__ = ("bits", "word", "offset", "sentinel", "spill", "mask")

    def __init__(self, bits: int, word: int, offset: int,
                 sentinel: Optional[int]):
        self.bits = bits
        self.word = word          # first packed word holding this lane
        self.offset = offset      # bit offset within that word
        self.sentinel = sentinel  # unpacked value of the all-ones field
        self.spill = offset + bits > 32  # straddles into word+1
        self.mask = (1 << bits) - 1


def _parse_spec(spec, i: int) -> Tuple[int, Optional[int]]:
    if isinstance(spec, (tuple, list)):
        if len(spec) != 2:
            raise ValueError(
                f"lane {i}: spec {spec!r} must be `bits` or "
                "`(bits, sentinel)`")
        bits, sentinel = int(spec[0]), int(spec[1])
    else:
        bits, sentinel = int(spec), None
    if not 1 <= bits <= 32:
        raise ValueError(f"lane {i}: declared width {bits} outside 1..32")
    if sentinel is not None:
        if not 0 <= sentinel < (1 << 32):
            raise ValueError(
                f"lane {i}: sentinel {sentinel} is not a uint32")
        if bits == 32:
            sentinel = None
        elif sentinel < (1 << bits) - 1:
            raise ValueError(
                f"lane {i}: sentinel {sentinel} collides with the "
                f"{bits}-bit value range (must be >= {(1 << bits) - 1})")
    return bits, sentinel


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> their int32 bit patterns."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


class PackedLayout:
    """A compiled word-aligned bitfield plan for one model's rows.
    ``packs`` is False when packing saves nothing."""

    def __init__(self, specs: Sequence, state_width: int):
        specs = list(specs)
        if len(specs) != state_width:
            raise ValueError(
                f"lane_bits declares {len(specs)} lanes; the model's "
                f"state_width is {state_width}")
        self.width = state_width
        self.lanes: List[_Lane] = []
        cursor = 0
        for i, spec in enumerate(specs):
            bits, sentinel = _parse_spec(spec, i)
            self.lanes.append(
                _Lane(bits, cursor // 32, cursor % 32, sentinel))
            cursor += bits
        self.total_bits = cursor
        self.packed_width = max(1, -(-cursor // 32))
        self.packs = self.packed_width < self.width
        #: the lane specs in json form, as a checkpoint header records
        #: them (``checkpoint_format.make_header``)
        self.specs = [(l.bits if l.sentinel is None
                       else [l.bits, l.sentinel]) for l in self.lanes]
        #: set by ``with_tenant_lane`` on derived layouts; a layout
        #: compiled from a model never has one
        self.tenant_lane: Optional[_Lane] = None

    def with_tenant_lane(self, bits: int = 16) -> "PackedLayout":
        """A layout whose packed rows grow one trailing word-aligned lane
        carrying a tenant (job) slot (the reference's, ``packing.py:157``):
        the model lanes keep their words, offsets and sentinels, and the
        tenant lane takes a fresh word after them, so ``packed[..., :-1]``
        of a tenant row is the row this layout packs."""
        if self.tenant_lane is not None:
            raise ValueError("layout already carries a tenant lane")
        if not 1 <= int(bits) <= 32:
            raise ValueError(f"tenant lane width {bits} outside 1..32")
        out = PackedLayout(self.specs, self.width)
        out.tenant_lane = _Lane(int(bits), out.packed_width, 0, None)
        out.packed_width += 1
        return out

    def _tenant_lane(self) -> _Lane:
        if self.tenant_lane is None:
            raise ValueError("layout has no tenant lane")
        return self.tenant_lane

    # -- torch codec (device waves) --------------------------------------

    def pack(self, rows: torch.Tensor) -> torch.Tensor:
        """``int64[..., W] -> int32[..., Wp]``."""
        words = [torch.zeros(rows.shape[:-1], dtype=torch.int64,
                             device=rows.device)
                 for _ in range(self.packed_width)]
        for i, l in enumerate(self.lanes):
            v = rows[..., i]
            f = (torch.clamp(v, max=l.mask) if l.sentinel is not None
                 else v & l.mask)
            words[l.word] = words[l.word] | ((f << l.offset) & _M32)
            if l.spill:
                words[l.word + 1] = words[l.word + 1] | (
                    f >> (32 - l.offset))
        return _as_int32(torch.stack(words, dim=-1))

    def unpack(self, packed: torch.Tensor) -> torch.Tensor:
        """``int32[..., Wp] -> int64[..., W]``."""
        p = packed.to(torch.int64) & _M32
        return torch.stack([self._lane(p, l) for l in self.lanes], dim=-1)

    @staticmethod
    def _lane(p: torch.Tensor, l: _Lane) -> torch.Tensor:
        f = p[..., l.word] >> l.offset
        if l.spill:
            f = f | (p[..., l.word + 1] << (32 - l.offset))
        f = f & l.mask
        if l.sentinel is not None:
            f = torch.where(f == l.mask, torch.full_like(f, l.sentinel), f)
        return f

    def lane(self, packed: torch.Tensor, lane: int) -> torch.Tensor:
        """One unpacked lane (int64) of packed rows."""
        return self._lane(packed.to(torch.int64) & _M32, self.lanes[lane])

    def tenant(self, packed: torch.Tensor) -> torch.Tensor:
        """The tenant slot (int64) of tenant-lane rows."""
        return self._lane(packed.to(torch.int64) & _M32, self._tenant_lane())

    def pack_tenant(self, rows: torch.Tensor,
                    tags: torch.Tensor) -> torch.Tensor:
        """``(int64[..., W], int[...]) -> int32[..., Wp + 1]``: the model
        lanes packed as the base layout packs them, then the tenant slot
        in the trailing word."""
        l = self._tenant_lane()
        words = self.pack(rows)[..., :l.word]
        tag = _as_int32(tags.to(torch.int64) & l.mask)
        return torch.cat([words, tag[..., None]], dim=-1)

    # -- numpy codec (host cold paths) -----------------------------------

    def pack_np(self, rows: np.ndarray) -> np.ndarray:
        """``uint32[..., W] -> uint32[..., Wp]``."""
        rows = np.asarray(rows, np.uint32)
        out = np.zeros(rows.shape[:-1] + (self.packed_width,), np.uint32)
        for i, l in enumerate(self.lanes):
            mask = np.uint32(l.mask)
            v = rows[..., i]
            f = np.minimum(v, mask) if l.sentinel is not None else v & mask
            out[..., l.word] |= (f << np.uint32(l.offset)).astype(np.uint32)
            if l.spill:
                out[..., l.word + 1] |= (
                    f >> np.uint32(32 - l.offset)).astype(np.uint32)
        return out

    def unpack_np(self, packed: np.ndarray) -> np.ndarray:
        """``uint32[..., Wp] -> uint32[..., W]``."""
        packed = np.asarray(packed, np.uint32)
        out = np.zeros(packed.shape[:-1] + (self.width,), np.uint32)
        for i in range(self.width):
            out[..., i] = self.lane_np(packed, i)
        return out

    def lane_np(self, packed: np.ndarray, lane: int) -> np.ndarray:
        """One unpacked lane (``uint32``) of packed rows."""
        packed = np.asarray(packed, np.uint32)
        l = self.lanes[lane]
        mask = np.uint32(l.mask)
        f = packed[..., l.word] >> np.uint32(l.offset)
        if l.spill:
            f = f | (packed[..., l.word + 1]
                     << np.uint32(32 - l.offset)).astype(np.uint32)
        f = f & mask
        if l.sentinel is not None:
            f = np.where(f == mask, np.uint32(l.sentinel), f)
        return f

    def tenant_np(self, packed: np.ndarray) -> np.ndarray:
        """The tenant slot column (``uint32``) of tenant-lane rows."""
        l = self._tenant_lane()
        return np.asarray(packed, np.uint32)[..., l.word] & np.uint32(l.mask)

    def pack_tenant_np(self, rows: np.ndarray,
                       tags: np.ndarray) -> np.ndarray:
        """``(uint32[..., W], tag[...]) -> uint32[..., Wp + 1]``: the numpy
        twin of ``pack_tenant``."""
        l = self._tenant_lane()
        out = self.pack_np(rows)
        out[..., l.word] = np.asarray(tags, np.uint32) & np.uint32(l.mask)
        return out

    def check_fits(self, rows: np.ndarray) -> None:
        """Raises if a lane value exceeds its declared width (a wrong
        ``lane_bits`` contract would otherwise truncate silently)."""
        rows = np.asarray(rows, np.uint32)
        for i, l in enumerate(self.lanes):
            if l.bits == 32:
                continue
            mask = np.uint32(l.mask)
            v = rows[..., i]
            bad = (v > mask) if l.sentinel is None else \
                ((v >= mask) & (v != np.uint32(l.sentinel)))
            if bad.any():
                raise ValueError(
                    f"lane {i} holds value {int(v[bad.nonzero()][0])}, "
                    f"outside its declared {l.bits}-bit width — the "
                    "model's lane_bits() contract is wrong")

    def __repr__(self) -> str:
        return (f"PackedLayout(W={self.width}, Wp={self.packed_width}, "
                f"bits={self.total_bits}, packs={self.packs})")


def compile_layout(lane_bits, state_width: int) -> PackedLayout:
    """Compiles a ``lane_bits()`` declaration; ``None`` (32 bits a lane)
    gives the identity layout (``packs`` False)."""
    if lane_bits is None:
        lane_bits = [32] * state_width
    return PackedLayout(lane_bits, state_width)
