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
store's ``store`` section, which references cold visited segments by
content hash (``{"segment_dir", "cold": [{"partition", "file", "sha",
"rows"}, ...]}``, each ref with its own ``dir`` where the segment lives
elsewhere), and the ``store_segment`` header that marks a file as one
cold segment (``{"partition", "rows", "sha"}``). A segment is written by
``write_atomic(..., compress=False)``, each member's data 64-byte
aligned in the file, so that its ``visited`` section memory-maps in
place as an aligned array (``store.tiered.map_segment_visited``), and is a
valid checkpoint shard: ``verify_file`` checks it. The port reads every
version and writes v5, with a ``store`` section where its tiered store
(``store/tiered.py``) holds cold segments; an engine refuses a header
with a v4 section (the elastic workers are not ported). ``write_atomic``
holds the fault plan's ``ckpt_crc`` and ``torn_ckpt`` points
(``resilience/faults.py``), as the reference's does.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import time
import zipfile
import zlib

import numpy as np

from .packing import compile_layout

__all__ = ["CKPT_VERSION", "PREV_SUFFIX", "content_hash", "make_header",
           "validate_header", "verify_sections", "verify_file",
           "load_checkpoint", "pending_rows", "write_atomic"]

CKPT_VERSION = 5


def content_hash(arr) -> str:
    """The hash a v5 ``store`` section references a cold segment by:
    blake2b over the array's raw bytes, an 8-byte digest in hex."""
    return hashlib.blake2b(
        np.ascontiguousarray(arr).tobytes(), digest_size=8).hexdigest()

#: Where :func:`write_atomic` rotates the previous generation
#: (keep-last-2: a torn current write falls back here).
PREV_SUFFIX = ".prev"


def make_header(*, model_name: str, state_width: int, state_count: int,
                unique_count: int, use_symmetry: bool, discoveries: dict,
                row_format: str = "u32", lane_bits=None,
                packed_width=None, store=None,
                store_segment=None) -> np.ndarray:
    """The header payload, json encoded as a ``uint8`` array.
    ``discoveries`` maps a property name to its uint64 fingerprint
    (stringified, since json has no uint64), sorted by name so that the
    bytes do not depend on the order of discovery. ``state_width`` is the
    unpacked width; ``row_format`` (``"u32"`` or ``"packed"``),
    ``lane_bits`` and ``packed_width`` say how ``pending_vecs`` is
    stored. ``store`` is the tiered store's references to its cold
    segments, ``store_segment`` marks the file as one segment (both v5,
    optional)."""
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
    if store is not None:
        header["store"] = store
    if store_segment is not None:
        header["store_segment"] = dict(store_segment)
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
    section's CRC32 in ``crcs``. A failed write leaves no temp file.

    The fault plan's two points (the reference's :326-365): under
    ``ckpt_crc`` a lying disk changes one byte of a nonempty ``visited``
    after the CRCs were taken, so only a load's CRC check finds it; under
    ``torn_ckpt`` the writer rotates the last generation to ``.prev``,
    leaves a truncated prefix of the new file at ``path`` and raises
    ``InjectedFault``. On the engines' writer thread (``async_io``) the
    fault raises at the engine's next join."""
    from .resilience.faults import InjectedFault, fault_plan_from_env

    payload = dict(payload)
    payload["crcs"] = _crcs_of(payload)
    plan = fault_plan_from_env()
    if (plan.active and np.asarray(payload.get("visited", ())).size
            and plan.fires("ckpt_crc", key="visited")):
        # The CRC table keeps the original bytes' sums.
        corrupt = np.array(payload["visited"], copy=True)
        corrupt.reshape(-1)[0] ^= np.asarray(1, corrupt.dtype)
        payload["visited"] = corrupt
    tmp = f"{path}.tmp-{os.getpid()}"
    writer = np.savez_compressed if compress else _savez_aligned
    try:
        with open(tmp, "wb") as f:
            writer(f, **payload)
        if plan.active and plan.fires("torn_ckpt", path=path):
            # The writer dies mid-sequence: the last generation has
            # rotated, and a prefix of the new one is at the final path.
            if _rotatable(path):
                os.replace(path, path + PREV_SUFFIX)
            with open(tmp, "rb") as f:
                blob = f.read()
            with open(path, "wb") as f:
                f.write(blob[:max(8, len(blob) // 3)])
            os.unlink(tmp)
            raise InjectedFault(
                "checkpoint writer died mid-write (injected torn_ckpt): "
                f"{path!r} holds a truncated snapshot; the previous "
                f"generation is at {path + PREV_SUFFIX!r}")
        if _rotatable(path):
            os.replace(path, path + PREV_SUFFIX)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


#: the file offset each member's array data starts at a multiple of, in
#: an uncompressed file
_ALIGN = 64
#: the extra field that pads a member's local header (zipalign's id;
#: readers skip an extra field they do not know)
_PAD_ID = 0xD935


def _savez_aligned(f, **payload) -> None:
    """``np.savez``'s file (the same members, each the same ``.npy``
    bytes), with each member's array data at a file offset that is a
    multiple of ``_ALIGN``: a padding extra field in its local header
    makes up the difference. A section memory-mapped in place is then
    aligned, and numpy searches it where it lies; unaligned, each search
    copies the whole array first."""
    with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as z:
        for key, value in payload.items():
            value = np.ascontiguousarray(value)
            header = io.BytesIO()
            np.lib.format.write_array_header_1_0(
                header, np.lib.format.header_data_from_array_1_0(value))
            header = header.getvalue()
            name = key + ".npy"
            info = zipfile.ZipInfo(name, time.localtime(time.time())[:6])
            info.file_size = len(header) + value.nbytes
            # The local header: 30 bytes, the name, the padding field (4
            # bytes and its pad), zipfile's zip64 field where the member
            # is large.
            start = (f.tell() + 30 + len(name.encode()) + 4 + len(header)
                     + (20 if info.file_size * 1.05 > zipfile.ZIP64_LIMIT
                        else 0))
            pad = -start % _ALIGN
            info.extra = struct.pack("<HH", _PAD_ID, pad) + bytes(pad)
            with z.open(info, "w") as out:
                out.write(header)
                out.write(value.view(np.uint8).reshape(-1).data)


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
