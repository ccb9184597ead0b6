"""The checkpoint format the port's engines write and resume from.

The port's copy of ``stateright_tpu/checkpoint_format.py``, cut to what
the engines use: a snapshot is one ``.npz`` whose sections have the
reference's names and dtypes, so each package reads the other's files.

Sections: ``header`` (json as ``uint8``), ``visited`` (``uint64``
fingerprints, sorted), ``pending_vecs`` (``uint32`` rows, unpacked or
bit-packed as the header says), ``pending_fps`` (``uint64``),
``pending_ebits`` (``uint32``), ``parent_child`` / ``parent_parent``
(``uint64``) and ``parent_rooted`` (``bool``), and ``crcs`` (json as
``uint8``: each section's CRC32).

Version history (the reference's): v1 unpacked rows; v2 packed rows with
a self-describing layout; v3 CRCs and keep-last-2 rotation; v4 the
elastic workers' ``shard`` and ``elastic`` sections; v5 the tiered
store's ``store`` section. The port writes v5 headers with none of the
v4/v5 sections, and reads every version; an engine refuses a header that
carries one of them (the modules behind them are not ported). The
reference's fault plan (``resilience/faults.py``) is not ported either,
so ``write_atomic`` injects nothing.
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib

import numpy as np

from .packing import compile_layout

__all__ = ["CKPT_VERSION", "PREV_SUFFIX", "make_header", "validate_header",
           "verify_sections", "verify_file", "load_checkpoint",
           "pending_rows", "write_atomic"]

CKPT_VERSION = 5

#: Where :func:`write_atomic` rotates the previous generation
#: (keep-last-2: a torn current write falls back here).
PREV_SUFFIX = ".prev"


def make_header(*, model_name: str, state_width: int, state_count: int,
                unique_count: int, use_symmetry: bool, discoveries: dict,
                row_format: str = "u32", lane_bits=None,
                packed_width=None) -> np.ndarray:
    """The header payload, json encoded as a ``uint8`` array.
    ``discoveries`` maps a property name to its uint64 fingerprint
    (stringified, since json has no uint64), sorted by name so that the
    bytes do not depend on the order of discovery. ``state_width`` is the
    unpacked width; ``row_format`` (``"u32"`` or ``"packed"``),
    ``lane_bits`` and ``packed_width`` say how ``pending_vecs`` is
    stored."""
    if row_format not in ("u32", "packed"):
        raise ValueError(f"unknown row_format {row_format!r}")
    if row_format == "packed" and lane_bits is None:
        raise ValueError(
            "row_format='packed' requires the lane_bits layout so the "
            "checkpoint stays self-describing")
    header = {
        "version": CKPT_VERSION,
        "model": model_name,
        "state_width": state_width,
        "state_count": state_count,
        "unique_count": unique_count,
        "use_symmetry": use_symmetry,
        "discoveries": {k: str(discoveries[k])
                        for k in sorted(discoveries)},
        "row_format": row_format,
    }
    if row_format == "packed":
        header["lane_bits"] = [list(b) if isinstance(b, (tuple, list))
                               else int(b) for b in lane_bits]
        header["packed_width"] = int(packed_width)
    return np.frombuffer(json.dumps(header).encode(), np.uint8)


def _crc32(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _section_names(data) -> list:
    files = getattr(data, "files", None)
    return list(files) if files is not None else list(data)


def verify_sections(data, where: str = "checkpoint") -> None:
    """Checks every section the ``crcs`` table lists against its CRC32
    (v3 and later; older files have no table and skip the check). A
    section that cannot be decoded (a torn write) or whose bytes changed
    raises ``ValueError``."""
    if "crcs" not in _section_names(data):
        return
    try:
        crcs = json.loads(bytes(np.asarray(data["crcs"]).tobytes()).decode())
    except Exception as e:  # noqa: BLE001 — the crc table itself is torn
        raise ValueError(
            f"{where}: integrity table is unreadable (torn write or "
            f"corruption): {e}") from e
    for key, want in crcs.items():
        try:
            arr = np.asarray(data[key])
        except Exception as e:  # noqa: BLE001 — torn/undecodable section
            raise ValueError(
                f"{where}: section {key!r} is unreadable (torn write "
                f"or corruption): {e}") from e
        got = _crc32(arr)
        if got != int(want):
            raise ValueError(
                f"{where}: section {key!r} failed its CRC32 check "
                f"(stored {int(want):#010x}, computed {got:#010x}) — "
                f"corrupted snapshot; the previous generation "
                f"('{PREV_SUFFIX}' rotation) may still be valid")


def validate_header(data, *, model_name: str, state_width: int,
                    use_symmetry: bool) -> dict:
    """Parses a loaded checkpoint's header and holds it to the resuming
    checker: the version first (a newer file is refused as newer, not as
    corrupt), then every section's CRC, the model's name, its unpacked
    width and the symmetry setting. Returns the header dict."""
    header = _parse_header(data)
    if header["version"] > CKPT_VERSION:
        raise ValueError(
            f"checkpoint version {header['version']} is newer than this "
            f"build supports ({CKPT_VERSION}); upgrade before resuming")
    if header["version"] < 1:
        raise ValueError(
            f"checkpoint version {header['version']} is not valid")
    verify_sections(data)
    if header["model"] != model_name:
        raise ValueError(
            f"checkpoint is from model {header['model']!r}, not "
            f"{model_name!r}")
    if header["state_width"] != state_width:
        raise ValueError(
            f"checkpoint state_width {header['state_width']} does not "
            f"match this model's {state_width} — wrong model or encoding "
            "changed")
    if header["use_symmetry"] != use_symmetry:
        raise ValueError(
            "checkpoint symmetry setting does not match builder")
    return header


def _parse_header(data) -> dict:
    """The json header; a torn one raises ``ValueError``."""
    try:
        return json.loads(bytes(np.asarray(data["header"]).tobytes()).decode())
    except Exception as e:  # noqa: BLE001 — torn/undecodable header
        raise ValueError(
            f"checkpoint header is unreadable (torn write or "
            f"corruption): {e}") from e


def verify_file(path: str) -> dict:
    """A file's integrity alone (no model checks): a readable npz, a
    parseable header of a known version, every section passing its CRC.
    Returns the header; raises ``ValueError`` on any corruption."""
    with load_checkpoint(path) as data:
        header = _parse_header(data)
        if header.get("version", 0) > CKPT_VERSION:
            raise ValueError(
                f"checkpoint {path!r} version {header['version']} "
                f"is newer than this build supports ({CKPT_VERSION})")
        verify_sections(data, where=f"checkpoint {path!r}")
    return header


def load_checkpoint(path: str):
    """Opens a checkpoint npz; a file that is not one (a torn write is a
    truncated zip) raises ``ValueError``."""
    try:
        return np.load(path)
    except Exception as e:  # noqa: BLE001 — BadZipFile/OSError/...
        raise ValueError(
            f"checkpoint {path!r} is unreadable (torn write or not a "
            f"checkpoint): {e}") from e


def pending_rows(data, header: dict, state_width: int) -> np.ndarray:
    """The pending rows unpacked, ``uint32[n, state_width]``, whatever
    row format the writer stored."""
    vecs = np.asarray(data["pending_vecs"], np.uint32)
    if header.get("row_format", "u32") == "packed":
        layout = compile_layout(header["lane_bits"], state_width)
        if vecs.shape[-1] != layout.packed_width:
            raise ValueError(
                f"packed checkpoint rows are {vecs.shape[-1]} words but "
                f"the declared layout packs to {layout.packed_width}")
        vecs = layout.unpack_np(vecs)
    elif vecs.size and vecs.shape[-1] != state_width:
        raise ValueError(
            f"checkpoint pending rows are {vecs.shape[-1]} wide, "
            f"expected state_width {state_width}")
    return np.ascontiguousarray(vecs, np.uint32)


def write_atomic(path: str, payload: dict, compress: bool = True) -> None:
    """Writes the npz atomically with keep-last-2 rotation: the previous
    file moves to ``path + PREV_SUFFIX`` just before the new one lands,
    so a complete generation is on disk at every instant. Records every
    section's CRC32 in ``crcs``. A failed write leaves no temp file."""
    payload = dict(payload)
    payload["crcs"] = _crcs_of(payload)
    tmp = f"{path}.tmp-{os.getpid()}"
    writer = np.savez_compressed if compress else np.savez
    try:
        with open(tmp, "wb") as f:
            writer(f, **payload)
        if _rotatable(path):
            os.replace(path, path + PREV_SUFFIX)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _rotatable(path: str) -> bool:
    """Whether the current file deserves the ``.prev`` slot: an intact
    zip with a header member. A known-torn file never rotates over the
    good previous generation."""
    if not os.path.exists(path):
        return False
    try:
        with zipfile.ZipFile(path) as z:
            z.getinfo("header.npy")
        return True
    except Exception:  # noqa: BLE001 — BadZipFile/KeyError/OSError
        return False


def _crcs_of(payload: dict) -> np.ndarray:
    crcs = {key: _crc32(np.asarray(value))
            for key, value in payload.items() if key != "crcs"}
    return np.frombuffer(json.dumps(crcs).encode(), np.uint8)
