"""Stable 64-bit fingerprints of host states.

The port's copy of ``stateright_tpu/fingerprint.py``, for the host BFS
engine (``bfs.py``) and host paths (``path.py``): the same type-tagged
canonical encoding hashed with the same keyed blake2b. Dataclasses and
enums are tagged by ``__qualname__``, and a value with
``__fingerprint__()`` by its class's qualname and that value's
encoding, so a port state whose classes have the JAX package's names and
fields has the JAX package's fingerprint. Unordered collections
(``set``, ``frozenset``, ``dict``) hash order-insensitively, through the
sorted digests of their elements.

These are not the device engines' fingerprints (``hashing.py``), which
hash encoded state rows.
"""

from __future__ import annotations

import struct
from dataclasses import fields, is_dataclass
from enum import Enum
from hashlib import blake2b
from typing import Any, Callable

__all__ = [
    "fingerprint",
    "fingerprint_bytes",
    "stable_encode",
    "register_encoder",
]

_KEY = b"stateright-tpu.v1"
_MASK64 = (1 << 64) - 1

# Type tags for the canonical encoding. Distinct tags keep e.g. 1 and True
# and "1" from colliding.
_T_NONE = b"\x00"
_T_FALSE = b"\x01"
_T_TRUE = b"\x02"
_T_INT = b"\x03"
_T_FLOAT = b"\x04"
_T_STR = b"\x05"
_T_BYTES = b"\x06"
_T_SEQ = b"\x07"
_T_SET = b"\x08"
_T_MAP = b"\x09"
_T_OBJ = b"\x0a"
_T_ENUM = b"\x0b"
_T_CUSTOM = b"\x0c"
_T_BIGINT = b"\x0d"

_pack_i64 = struct.Struct("<q").pack
_pack_u32 = struct.Struct("<I").pack
_pack_f64 = struct.Struct("<d").pack

# type -> encoder(value, buf) for user-registered types.
_EXTRA_ENCODERS: dict[type, Callable[[Any, bytearray], None]] = {}

# class -> tuple of dataclass field names (cached; dataclasses.fields is slow).
_DC_FIELDS: dict[type, tuple[str, ...]] = {}


def register_encoder(cls: type, encode: Callable[[Any, bytearray], None]) -> None:
    """Registers a canonical-encoding function for a user type.

    ``encode(value, buf)`` must append a deterministic byte encoding of
    ``value`` to ``buf``. Prefer frozen dataclasses, which are supported
    natively, before reaching for this.
    """
    _EXTRA_ENCODERS[cls] = encode


def _encode_int(v: int, buf: bytearray) -> None:
    if -(1 << 63) <= v < (1 << 63):
        buf += _T_INT
        buf += _pack_i64(v)
    else:  # bignum gets its own tag so the encoding stays injective
        nbytes = (v.bit_length() + 8) // 8
        buf += _T_BIGINT + _pack_u32(nbytes) + v.to_bytes(nbytes, "little", signed=True)


def _encode_str(v: str, buf: bytearray) -> None:
    raw = v.encode("utf-8")
    buf += _T_STR + _pack_u32(len(raw)) + raw


def _encode_seq(v, buf: bytearray) -> None:
    buf += _T_SEQ + _pack_u32(len(v))
    for item in v:
        _encode(item, buf)


def _encode_set(v, buf: bytearray) -> None:
    # Order-insensitive: sorted element digests (util.rs:123-144).
    buf += _T_SET + _pack_u32(len(v))
    for digest in sorted(fingerprint_bytes(item) for item in v):
        buf += digest


def _encode_map(v, buf: bytearray) -> None:
    buf += _T_MAP + _pack_u32(len(v))
    for digest in sorted(fingerprint_bytes(kv) for kv in v.items()):
        buf += digest


def _encode(value: Any, buf: bytearray) -> None:
    # Order of checks matters: bool is a subclass of int; Enum members of
    # int-backed enums are ints.
    t = type(value)
    if value is None:
        buf += _T_NONE
    elif t is bool:
        buf += _T_TRUE if value else _T_FALSE
    elif t is int:
        _encode_int(value, buf)
    elif t is str:
        _encode_str(value, buf)
    elif t is tuple or t is list:
        _encode_seq(value, buf)
    elif t is frozenset or t is set:
        _encode_set(value, buf)
    elif t is dict:
        _encode_map(value, buf)
    elif t is float:
        buf += _T_FLOAT + _pack_f64(value)
    elif t is bytes:
        buf += _T_BYTES + _pack_u32(len(value)) + value
    elif isinstance(value, Enum):
        name = t.__qualname__.encode("utf-8")
        member = value.name.encode("utf-8")
        buf += _T_ENUM + _pack_u32(len(name)) + name + _pack_u32(len(member)) + member
    elif t in _EXTRA_ENCODERS:
        qual = t.__qualname__.encode("utf-8")
        buf += _T_CUSTOM + _pack_u32(len(qual)) + qual
        _EXTRA_ENCODERS[t](value, buf)
    elif is_dataclass(value):
        names = _DC_FIELDS.get(t)
        if names is None:
            names = tuple(f.name for f in fields(value))
            _DC_FIELDS[t] = names
        qual = t.__qualname__.encode("utf-8")
        buf += _T_OBJ + _pack_u32(len(qual)) + qual + _pack_u32(len(names))
        for name in names:
            _encode(getattr(value, name), buf)
    elif isinstance(value, tuple):  # namedtuple and tuple subclasses
        buf += _T_SEQ + _pack_u32(len(value))
        for item in value:
            _encode(item, buf)
    elif isinstance(value, int):  # int subclasses, e.g. actor Id
        _encode_int(int(value), buf)
    elif isinstance(value, str):
        _encode_str(value, buf)
    elif isinstance(value, (list, frozenset, set, dict)):
        # A subclass that redefines equality (e.g. OrderedDict's
        # order-sensitive __eq__) would fingerprint-collide values its own
        # __eq__ distinguishes; require an explicit encoder for those.
        if type(value).__eq__ not in (
                list.__eq__, set.__eq__, frozenset.__eq__, dict.__eq__):
            raise TypeError(
                f"cannot fingerprint {type(value).__qualname__}: it "
                "overrides __eq__ with non-standard semantics; use "
                "register_encoder or __fingerprint__")
        if isinstance(value, list):
            _encode_seq(value, buf)
        elif isinstance(value, dict):
            _encode_map(value, buf)
        else:
            _encode_set(value, buf)
    else:
        custom = getattr(value, "__fingerprint__", None)
        if custom is not None:
            qual = t.__qualname__.encode("utf-8")
            buf += _T_CUSTOM + _pack_u32(len(qual)) + qual
            _encode(custom(), buf)
        else:
            raise TypeError(
                f"cannot fingerprint value of type {t.__module__}.{t.__qualname__}; "
                "use a frozen dataclass, builtin container, Enum, or define "
                "__fingerprint__()/register_encoder"
            )


def stable_encode(value: Any) -> bytes:
    """Returns the canonical byte encoding used for fingerprinting."""
    buf = bytearray()
    _encode(value, buf)
    return bytes(buf)


def fingerprint_bytes(value: Any) -> bytes:
    """Returns the 8-byte stable digest of ``value``."""
    buf = bytearray()
    _encode(value, buf)
    return blake2b(bytes(buf), digest_size=8, key=_KEY).digest()


def fingerprint(value: Any) -> int:
    """Converts a state to a nonzero 64-bit ``Fingerprint`` (lib.rs:307-311)."""
    fp = int.from_bytes(fingerprint_bytes(value), "big")
    return fp if fp != 0 else 1
