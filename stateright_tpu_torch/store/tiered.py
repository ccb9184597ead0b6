"""The tiered state store: the card's table and arena, host RAM, disk.

The port's copy of ``stateright_tpu/store/tiered.py``. It lets a run
check a space whose visited table or arena would not fit the card's byte
budget:

- **Hot**: the device structures (the visited table, the fused arena),
  owned by the engines and budgeted by ``device_budget`` bytes.
- **Warm**: host-RAM partitions of evicted visited fingerprints (``fp %
  n_partitions`` buckets, each a sorted ``uint64`` array), the host
  frontier blocks of the classic engines, and the probe's filter (a
  bitmap over the spilled keys, which the reference does not have).
  Budgeted by ``host_budget``; ``stats()``'s host bytes count the
  filter.
- **Cold**: disk segments under ``segment_dir``. A cold segment is
  written by ``checkpoint_format.write_atomic`` uncompressed and
  aligned, so that its ``visited`` section memory-maps in place as an
  aligned array; it is a valid checkpoint
  shard (``verify_file`` checks it), keep-last-2 rotation gives every
  partition's file a ``.prev`` predecessor, and a v5 checkpoint refers
  to it by content hash instead of copying it.

Spilling never changes a result. The classic engines keep inserting into
the card's table; a spilled fingerprint generated again is admitted to
the table again, and the wave's host-side ``probe`` (sorted-array
membership over the wave's new rows) drops it before it reaches the
counts, the parent log or the queue. The fused engines never evict
visited rows (their dedup is on the card across a dispatch): their valve
is the arena-span roll (``note_arena_span``).

Its ``spill`` / ``page_in`` / ``pressure`` events go to the owning
engine's tracer and flight ring (``owner``, read at each event, as the
reference's ``_event``), at the reference's points. Not ported yet: the
reference's fault points (``spill_fail``, ``disk_full``, ``page_in_torn``;
``resilience/faults.py``) inject nothing. Every counter that ``stats()``
reports is kept.

The disarmed store is the shared ``NULL_STORE`` (``active`` False): an
engine's wave pays one attribute check.
"""

from __future__ import annotations

import os
import threading
import weakref
import zipfile
from typing import Dict, List, Optional

import numpy as np

from ..checkpoint_format import (PREV_SUFFIX, content_hash, load_checkpoint,
                                 make_header, verify_file, write_atomic)
from ..io.async_io import SyncWriter

__all__ = [
    "TIER_DEVICE_ENV", "TIER_HOST_ENV", "TIER_DIR_ENV",
    "FrontierRef", "TieredStore", "NullStore", "NULL_STORE",
    "load_cold_refs", "map_segment_visited", "store_from_config",
]

#: The environment's byte budgets for the device and host tiers and the
#: cold segments' directory (an engine's keyword wins). Any one arms the
#: store; a missing budget leaves its tier unbounded, a missing
#: directory means no cold tier (host pressure is then not relieved).
TIER_DEVICE_ENV = "STpu_TIER_DEVICE_BYTES"
TIER_HOST_ENV = "STpu_TIER_HOST_BYTES"
TIER_DIR_ENV = "STpu_TIER_DIR"


def _parse_bytes(text) -> Optional[int]:
    """A byte count with an optional ``k``/``m``/``g`` (or ``kib``, ...)
    suffix; None for nothing or ``"0"``."""
    if text is None:
        return None
    text = str(text).strip().lower()
    if not text or text == "0":
        return None
    mult = 1
    for suffix, m in (("kib", 1024), ("mib", 1 << 20), ("gib", 1 << 30),
                      ("k", 1024), ("m", 1 << 20), ("g", 1 << 30)):
        if text.endswith(suffix):
            mult = m
            text = text[:-len(suffix)]
            break
    return int(float(text) * mult)


class FrontierRef:
    """A frontier block paged out to disk by ``balance_frontier``: the
    queue's entry in its place, read back by ``fetch_frontier`` before
    its rows reach a wave. Its three arrays' raw bytes lie one after
    another at ``offset`` in the log file ``path`` (``_Log``); ``layout``
    holds their dtypes and shapes."""

    __slots__ = ("path", "rows", "nbytes", "layout", "offset")

    def __init__(self, path: str, rows: int, nbytes: int, layout=(),
                 offset: int = 0):
        self.path = path
        self.rows = rows
        self.nbytes = nbytes
        self.layout = layout
        self.offset = offset


class _Log:
    """An append-only file of paged-out frontier blocks: a block a write
    at its end, read back in place, and the file deleted once every block
    in it was read back (``live``). One file for many blocks spares a
    file's creation and deletion a block."""

    __slots__ = ("path", "fd", "size", "live")

    def __init__(self, path: str):
        self.path = path
        self.fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
        self.size = self.live = 0

    def close(self, unlink: bool = True) -> None:
        os.close(self.fd)
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


#: a frontier log's size past which the next block starts a new one
_LOG_BYTES = 64 << 20


class _ColdPart:
    """One partition's cold generation: its segment file and its sorted
    fingerprints (memory-mapped where possible)."""

    __slots__ = ("path", "fps", "rows", "sha")

    def __init__(self, path: str, fps: np.ndarray, sha: str):
        self.path = path
        self.fps = fps
        self.rows = int(len(fps))
        self.sha = sha


def _block_bytes(block) -> int:
    return sum(a.nbytes for a in block)


def _distinct(out: np.ndarray) -> np.ndarray:
    """The sorted array ``out`` with each value once. (A sort and a
    comparison of neighbours: ``np.unique`` of some numpy versions hashes
    instead, many times slower on tens of millions of keys.)"""
    if len(out) > 1:
        keep = np.empty(len(out), bool)
        keep[0] = True
        np.not_equal(out[1:], out[:-1], out=keep[1:])
        out = out[keep]
    return out


def _merge_sorted(a: Optional[np.ndarray], b: np.ndarray) -> np.ndarray:
    """The sorted union of ``a`` (sorted, or None) and ``b`` (any
    order), each value once."""
    b = np.sort(np.asarray(b, np.uint64))
    if a is None or not len(a):
        return _distinct(b)
    out = np.concatenate([np.asarray(a, np.uint64), b])
    out.sort(kind="stable")  # two sorted runs: a merge
    return _distinct(out)


def _sorted_member(arr: Optional[np.ndarray], vals: np.ndarray) -> np.ndarray:
    """Whether each of ``vals`` is in the sorted array ``arr`` (``vals``
    sorted too searches several times faster: nearby keys walk nearby
    slots)."""
    if arr is None or not len(arr) or not len(vals):
        return np.zeros(len(vals), bool)
    idx = np.searchsorted(arr, vals)
    idx = np.minimum(idx, len(arr) - 1)
    return arr[idx] == vals


def _partitions(fps: np.ndarray, P: int) -> np.ndarray:
    """Each fingerprint's ``fp % P`` partition, small ints (a mask where
    ``P`` is a power of two: a 64-bit division is slow)."""
    part = (fps & np.uint64(P - 1) if not P & (P - 1)
            else fps % np.uint64(P))
    return part.astype(np.int16)


#: the spilled keys past which the probe's filter is made: a search of
#: fewer costs less than the filter's upkeep
_FILTER_KEYS = 1 << 20
#: the filter takes at most ``1 / _FILTER_SHARE`` of the host budget (a
#: bit of it spares more host time than a warm row's 64 bits spare disk)
_FILTER_SHARE = 2


class _Filter:
    """A bitmap over the top bits of every spilled fingerprint: a probe
    searches the sorted tiers only where its bit is set (no fingerprint
    spilled is missed; at 16 bits a key about one in 16 others is
    searched for nothing). Made once ``_FILTER_KEYS`` keys are spilled,
    it grows four times at a time, rebuilt from the tiers, to keep 16
    bits a key, up to ``1 << cap_log2`` bits: past that it passes more
    keys. Its bytes belong to the host tier."""

    def __init__(self, cap_log2: int):
        self.cap_log2 = cap_log2
        self.clear()

    def clear(self) -> None:
        self.log2, self.keys, self.bits = 0, 0, None

    @property
    def nbytes(self) -> int:
        return 0 if self.bits is None else len(self.bits)

    def _set(self, fps: np.ndarray) -> None:
        """Sets the bits of the sorted ``fps``: their bit indices come
        sorted, so each byte's bits are ORed in one pass and the bytes
        written once each (a scatter with repeated bytes would lose bits,
        and ``ufunc.at`` is slow)."""
        if not len(fps):
            return
        h = fps >> np.uint64(64 - self.log2)
        byte = h >> np.uint64(3)
        bits = np.left_shift(np.uint8(1), (h & np.uint64(7)).astype(np.uint8))
        starts = np.flatnonzero(np.concatenate(
            ([True], byte[1:] != byte[:-1])))
        self.bits[byte[starts]] |= np.bitwise_or.reduceat(bits, starts)

    def add(self, fps: np.ndarray, tiers) -> None:
        """Counts ``fps`` (sorted, already in the tiers) and sets their
        bits; where the keys pass 1/16 of the bits and the cap allows, the
        bitmap grows and is rebuilt from ``tiers()``, every spilled array
        (each sorted)."""
        self.keys += len(fps)
        if self.keys < _FILTER_KEYS or self.cap_log2 < 13:
            return
        log2 = max(self.log2, 20)
        while self.keys * 16 > (1 << log2) and log2 < self.cap_log2:
            log2 += 2
        log2 = min(log2, self.cap_log2)
        if self.bits is not None and log2 == self.log2:
            self._set(fps)
            return
        self.log2 = log2
        self.bits = np.zeros(1 << (log2 - 3), np.uint8)
        for arr in tiers():
            self._set(np.asarray(arr, np.uint64))

    def maybe(self, fps: np.ndarray) -> np.ndarray:
        """False where ``fps`` cannot have been spilled."""
        if self.bits is None:
            return np.ones(len(fps), bool)
        h = fps >> np.uint64(64 - self.log2)
        return ((self.bits[h >> np.uint64(3)] >> (h & np.uint64(7)).astype(
            np.uint8)) & 1).astype(bool)


def map_segment_visited(path: str) -> np.ndarray:
    """The ``visited`` section of an uncompressed segment file, memory-
    mapped in place; read whole where the member is compressed or laid
    out otherwise."""
    try:
        with zipfile.ZipFile(path) as z:
            info = z.getinfo("visited.npy")
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError("compressed member")
            with open(path, "rb") as f:
                # The local file header gives the data's start (its extra
                # field can differ from the central directory's).
                f.seek(info.header_offset)
                local = f.read(30)
                if local[:4] != b"PK\x03\x04":
                    raise ValueError("bad local header")
                name_len = int.from_bytes(local[26:28], "little")
                extra_len = int.from_bytes(local[28:30], "little")
                f.seek(info.header_offset + 30 + name_len + extra_len)
                version = np.lib.format.read_magic(f)
                shape, fortran, dtype = \
                    np.lib.format._read_array_header(f, version)
                array_off = f.tell()
        if fortran or dtype != np.dtype(np.uint64) or len(shape) != 1:
            raise ValueError("unexpected visited layout")
        return np.memmap(path, dtype=np.uint64, mode="r",
                         offset=array_off, shape=shape)
    except Exception:  # noqa: BLE001 — the memmap is an optimisation only
        with load_checkpoint(path) as data:
            return np.array(data["visited"], np.uint64)


class NullStore:
    """The disarmed store: ``active`` is False, a probe finds nothing,
    and ``stats()`` says disabled."""

    __slots__ = ()
    active = False
    device_budget = None
    spilled_rows = 0

    def probe(self, fps) -> np.ndarray:
        return np.zeros(len(fps), bool)

    def balance_frontier(self, queues) -> None:
        pass

    def attach_async(self, writer) -> None:
        pass

    def stats(self) -> dict:
        return {"enabled": False}

    def gauges(self) -> dict:
        return {}


NULL_STORE = NullStore()


class TieredStore:
    """The warm and cold visited partitions and the frontier paging of
    one engine. ``meta`` (``model_name``, ``state_width``,
    ``use_symmetry``) goes into each cold segment's header, which makes a
    segment a checkpoint shard."""

    active = True

    def __init__(self, *, device_budget: Optional[int] = None,
                 host_budget: Optional[int] = None,
                 segment_dir: Optional[str] = None,
                 n_partitions: int = 16, meta: Optional[dict] = None,
                 owner=None):
        self.device_budget = device_budget
        # The engine whose ``_tracer`` and ``_flight`` take the events, held
        # weakly: the engine holds the store, and a cycle would keep the
        # engine's device memory until the collector ran.
        self._owner = None if owner is None else weakref.ref(owner)
        self.host_budget = host_budget
        self.segment_dir = segment_dir
        if segment_dir:
            os.makedirs(segment_dir, exist_ok=True)
        self._P = max(1, int(n_partitions))
        self._meta = dict(meta or {})
        self._lock = threading.Lock()
        self._warm: List[Optional[np.ndarray]] = [None] * self._P
        self._cold: Dict[int, _ColdPart] = {}
        self._next_spill = 0
        self._frontier_seq = 0
        #: the frontier logs by path, and the one blocks are appended to
        self._logs: Dict[str, _Log] = {}
        self._log: Optional[_Log] = None
        self._executor = None
        self._prefetched: Dict[tuple, object] = {}
        # The engine's writer (``attach_async``): cold-segment writes go
        # to it; a partition with a write submitted and not landed sits
        # in ``_spilling``, so the budget loop never submits it twice.
        self._aio = SyncWriter()
        self._spilling: set = set()
        self._spills = {"host": 0, "disk": 0}
        self._spill_bytes = 0
        self._page_ins = 0
        self._prefetch_hits = 0
        self._probes = 0
        self._probe_hits = 0
        self._arena_span_rows = 0
        self._arena_span_bytes = 0
        self._arena_span_spills = 0
        self._frontier_bytes = 0
        self._host_high_water = 0
        self._disk_high_water = 0
        #: ``note_device_pressure`` calls (the reference emits an event)
        self.pressure_notes = 0
        # The probe's filter: a share of the host budget at most, 8 GiB
        # with none.
        cap = (host_budget // _FILTER_SHARE if host_budget is not None
               else 1 << 33)
        self._filter = _Filter(max(0, int(cap) * 8).bit_length() - 1)

    def attach_async(self, writer) -> None:
        """Hands cold-segment writes to the engine's checkpoint writer
        (``io.async_io``), whose join at a rest point covers both; with
        a ``SyncWriter`` they stay inline."""
        self._aio = writer

    # -- Events --------------------------------------------------------------

    def _event(self, etype: str, **fields) -> None:
        """One event to the owner's tracer (flushed at once, as the
        reference's) and flight ring, where they are on."""
        owner = None if self._owner is None else self._owner()
        tracer = getattr(owner, "_tracer", None)
        if tracer is not None and tracer.enabled:
            tracer.event(etype, _flush=True, **fields)
        flight = getattr(owner, "_flight", None)
        if flight is not None and flight.armed:
            flight.record_event(etype, **fields)

    # -- Tier accounting --------------------------------------------------

    @property
    def warm_rows(self) -> int:
        return sum(len(a) for a in self._warm if a is not None)

    @property
    def warm_bytes(self) -> int:
        """The host tier's bytes: its rows and the probe's filter."""
        return 8 * self.warm_rows + self._filter.nbytes

    @property
    def cold_rows(self) -> int:
        return sum(p.rows for p in self._cold.values())

    @property
    def cold_bytes(self) -> int:
        return 8 * self.cold_rows + self._frontier_bytes

    @property
    def spilled_rows(self) -> int:
        """The spilled visited rows, warm and cold: what ``probe``
        checks."""
        return self.warm_rows + self.cold_rows

    def host_used(self, frontier_host_bytes: int = 0) -> int:
        return self.warm_bytes + frontier_host_bytes

    # -- Visited spill (device -> warm -> cold) ---------------------------

    def spill_mask(self, fps: np.ndarray, enough) -> np.ndarray:
        """The fingerprints to evict from the device: whole ``fp % P``
        partitions in a fixed round-robin order until ``enough(kept
        fps)`` holds (or every partition is taken). Which partitions go
        is a matter of pace, never of result."""
        part = _partitions(fps, self._P)
        mask = np.zeros(len(fps), bool)
        for taken in range(self._P):
            if enough(fps[~mask] if taken else fps):
                break
            p = self._next_spill
            self._next_spill = (self._next_spill + 1) % self._P
            mask |= part == p
        return mask

    @property
    def partitions(self) -> int:
        """``P``, the fingerprints' ``fp % P`` partitions."""
        return self._P

    def spill_partitions(self, counts: np.ndarray, enough) -> List[int]:
        """The partitions ``spill_mask`` would take, in its order, from
        the rows' counts by partition instead of the rows (``counts[p]``,
        of any shape past the first axis): ``enough(kept)`` is given the
        counts of the partitions not taken, summed over the first axis."""
        counts = np.asarray(counts, np.int64)
        kept, taken = counts.sum(axis=0), []
        for _ in range(self._P):
            if enough(kept):
                break
            p = self._next_spill
            self._next_spill = (self._next_spill + 1) % self._P
            taken.append(p)
            kept = kept - counts[p]
        return taken

    def spill_visited(self, fps: np.ndarray) -> None:
        """Takes evicted device fingerprints into the warm tier, then
        pushes the largest warm partitions to cold segments while the
        host tier is over its budget."""
        fps = np.asarray(fps, np.uint64)
        if not len(fps):
            return
        part = _partitions(fps, self._P)
        with self._lock:
            for p in np.flatnonzero(np.bincount(part, minlength=self._P)):
                batch = np.sort(fps[part == p])
                self._warm[p] = _merge_sorted(self._warm[p], batch)
                self._filter.add(batch, self._tiers)
            self._spills["host"] += 1
            self._spill_bytes += 8 * len(fps)
            self._host_high_water = max(self._host_high_water,
                                        self.warm_bytes)
        self._event("spill", tier="host", kind="visited",
                    rows=int(len(fps)), bytes=8 * int(len(fps)))
        self.enforce_host_budget()

    def enforce_host_budget(self, frontier_bytes: int = 0) -> None:
        """Pushes warm partitions to the cold tier, the largest first,
        while the host tier is over its budget; without a segment
        directory the pressure stays."""
        if self.host_budget is None:
            return
        if self.host_used(frontier_bytes) <= self.host_budget:
            return
        if not self.segment_dir:
            self._event("pressure", tier="host",
                        used=int(self.host_used(frontier_bytes)),
                        budget=int(self.host_budget))
            return
        if self._aio.enabled:
            self._enforce_host_budget_async(frontier_bytes)
            return
        while self.host_used(frontier_bytes) > self.host_budget:
            sizes = [(0 if a is None else len(a)) for a in self._warm]
            p = int(np.argmax(sizes))
            if sizes[p] == 0:
                break
            self._spill_partition_to_disk(p)
        self._event("pressure", tier="host",
                    used=int(self.host_used(frontier_bytes)),
                    budget=int(self.host_budget))

    def _enforce_host_budget_async(self, frontier_bytes: int) -> None:
        """The budget loop on the writer: partitions are picked here, on
        the caller's thread, with a submitted write's rows counted as
        gone, so the pick order is the inline loop's and the segments'
        bytes are the same; each write takes the partition's rows as of
        now (rows merged later stay warm)."""
        with self._lock:
            sizes = [0 if (a is None or p in self._spilling) else len(a)
                     for p, a in enumerate(self._warm)]
            pending = sum(
                0 if self._warm[p] is None else len(self._warm[p])
                for p in self._spilling)
        used = self.host_used(frontier_bytes) - 8 * pending
        while used > self.host_budget:
            p = int(np.argmax(sizes))
            if sizes[p] == 0:
                break
            with self._lock:
                warm = self._warm[p]
                if warm is None or not len(warm):
                    sizes[p] = 0
                    continue
                self._spilling.add(p)
            self._aio.submit(
                lambda p=p, warm=warm:
                self._spill_partition_to_disk(p, warm_rows=warm))
            used -= 8 * sizes[p]
            sizes[p] = 0
        self._event("pressure", tier="host", used=int(max(used, 0)),
                    budget=int(self.host_budget))

    def _segment_path(self, p: int) -> str:
        return os.path.join(self.segment_dir,
                            f"tier-p{p:03d}.npz")

    def _spill_partition_to_disk(self, p: int,
                                 warm_rows: Optional[np.ndarray] = None
                                 ) -> None:
        """Writes partition ``p``'s next cold generation, the union of
        its last one and its warm rows, at a rotating path (keep-last-2 a
        partition), and reads it straight back. A segment that lands torn
        (its CRCs or its hash fail) falls back to the rotation
        predecessor, itself checked before any parse, and the rows stay
        warm: no fingerprint is lost. ``warm_rows`` are the rows an
        asynchronous write took at its submission."""
        with self._lock:
            warm = self._warm[p] if warm_rows is None else warm_rows
            if warm is None or not len(warm):
                self._spilling.discard(p)
                return
            prev = self._cold.get(p)
            union = _merge_sorted(None if prev is None else prev.fps, warm)
        path = self._segment_path(p)
        sha = content_hash(union)
        header = make_header(
            model_name=str(self._meta.get("model_name", "store")),
            state_width=int(self._meta.get("state_width", 0)),
            state_count=int(len(union)), unique_count=int(len(union)),
            use_symmetry=bool(self._meta.get("use_symmetry", False)),
            discoveries={},
            store_segment={"partition": p, "rows": int(len(union)),
                           "sha": sha})
        try:
            # Uncompressed: the visited section must memory-map in place.
            write_atomic(path, {"header": header, "visited": union},
                         compress=False)
        except BaseException:
            with self._lock:
                self._spilling.discard(p)
            raise
        try:
            verify_file(path)
            got = map_segment_visited(path)
            if content_hash(np.asarray(got)) != sha:
                raise ValueError("content hash mismatch after write")
        except ValueError:
            prev_path = path + PREV_SUFFIX
            restored = None
            if prev is not None and os.path.exists(prev_path):
                try:
                    verify_file(prev_path)
                    fps = map_segment_visited(prev_path)
                    if content_hash(np.asarray(fps)) == prev.sha:
                        restored = _ColdPart(prev_path, fps, prev.sha)
                except ValueError:
                    restored = None
            with self._lock:
                if restored is not None:
                    self._cold[p] = restored
                elif prev is not None:
                    # The previous view's arrays stay valid.
                    self._cold[p] = prev
                else:
                    self._cold.pop(p, None)
                self._spilling.discard(p)
            return
        with self._lock:
            # The cold generation goes in and exactly the rows it holds
            # leave the warm tier at once, so a probe meanwhile finds
            # every fingerprint in one tier or the other; rows merged
            # after an asynchronous write's capture stay warm.
            self._cold[p] = _ColdPart(path, got, sha)
            cur = self._warm[p]
            if cur is None or cur is warm:
                self._warm[p] = None
            else:
                keep = cur[~_sorted_member(warm, cur)]
                self._warm[p] = keep if len(keep) else None
            self._spilling.discard(p)
            self._spills["disk"] += 1
            self._spill_bytes += 8 * int(len(union))
            self._disk_high_water = max(self._disk_high_water,
                                        self.cold_bytes)
        self._event("spill", tier="disk", kind="visited",
                    rows=int(len(union)), bytes=8 * int(len(union)))

    # -- Membership probe --------------------------------------------------

    def probe(self, fps: np.ndarray) -> np.ndarray:
        """Whether each of ``fps`` was spilled (is warm or cold): a wave's
        new rows, in one call."""
        fps = np.asarray(fps, np.uint64)
        present = np.zeros(len(fps), bool)
        if not len(fps) or not self.spilled_rows:
            return present
        with self._lock:
            # The rows the filter passes, sorted by partition and, within
            # one, by value.
            rows = np.flatnonzero(self._filter.maybe(fps))
            rows = rows[np.argsort(fps[rows])]
            part = _partitions(fps[rows], self._P)
            rows = rows[np.argsort(part, kind="stable")]
            ends = np.cumsum(np.bincount(part, minlength=self._P))
            for p in range(self._P):
                lo, hi = (ends[p - 1] if p else 0), ends[p]
                warm, cold = self._warm[p], self._cold.get(p)
                if lo == hi or (warm is None and cold is None):
                    continue
                idx = rows[lo:hi]
                vals = fps[idx]
                acc = _sorted_member(warm, vals)
                if cold is not None:
                    acc |= _sorted_member(cold.fps, vals)
                present[idx] = acc
            self._probes += len(fps)
            self._probe_hits += int(present.sum())
        return present

    def _tiers(self):
        """Every spilled array, warm and cold (the filter's rebuild)."""
        yield from (a for a in self._warm if a is not None)
        yield from (p.fps for p in self._cold.values())

    # -- Partition by partition (the elastic workers' surface) ------------

    def spill_partition_rows(self, p: int, fps: np.ndarray) -> None:
        """Takes one partition's visited rows into the warm tier (cold
        under host pressure)."""
        fps = np.asarray(fps, np.uint64)
        if not len(fps):
            return
        with self._lock:
            self._warm[p] = _merge_sorted(self._warm[p], fps)
            self._filter.add(np.sort(fps), self._tiers)
            self._spills["host"] += 1
            self._spill_bytes += 8 * len(fps)
            self._host_high_water = max(self._host_high_water,
                                        self.warm_bytes)
        self._event("spill", tier="host", kind="visited",
                    rows=int(len(fps)), bytes=8 * int(len(fps)))
        self.enforce_host_budget()

    def probe_partition(self, p: int, vals: np.ndarray) -> np.ndarray:
        """Whether each of ``vals`` is in partition ``p``'s spilled
        tiers."""
        vals = np.asarray(vals, np.uint64)
        with self._lock:
            warm = self._warm[p]
            cold = self._cold.get(p)
            acc = _sorted_member(warm, vals)
            if cold is not None:
                acc |= _sorted_member(cold.fps, vals)
            self._probes += len(vals)
            self._probe_hits += int(acc.sum())
        return acc

    def partition_fps(self, p: int) -> np.ndarray:
        """Every spilled fingerprint of partition ``p``, warm and cold,
        sorted."""
        with self._lock:
            warm = self._warm[p]
            cold = self._cold.get(p)
        parts = [a for a in (warm, None if cold is None else cold.fps)
                 if a is not None and len(a)]
        if not parts:
            return np.zeros(0, np.uint64)
        return np.asarray(_merge_sorted(parts[0], parts[1])
                          if len(parts) == 2 else parts[0], np.uint64)

    def drop_partition(self, p: int) -> None:
        """Forgets partition ``p``'s spilled tiers."""
        with self._lock:
            self._warm[p] = None
            self._cold.pop(p, None)

    # -- Frontier paging (host RAM -> disk, read back ahead) -------------

    def balance_frontier(self, queues) -> None:
        """Pages frontier blocks out to disk while the host tier (warm
        rows and queued frontier bytes) is over its budget: the largest
        last block of any queue each time (dispatched last), never a
        queue's head block, so each queue keeps its order."""
        if self.host_budget is None or not self.segment_dir:
            return
        total = 0
        for q in queues:  # every wave: no generator a block
            for b in q:
                if type(b) is tuple:
                    total += b[0].nbytes + b[1].nbytes + b[2].nbytes
        if self.host_used(total) <= self.host_budget:
            return
        moved = False
        while self.host_used(total) > self.host_budget:
            best, best_bytes = None, 0
            for q in queues:
                for i in range(len(q) - 1, 0, -1):
                    b = q[i]
                    if isinstance(b, FrontierRef):
                        continue
                    nb = _block_bytes(b)
                    if nb > best_bytes:
                        best, best_bytes = (q, i), nb
                    break
            if best is None:
                break
            q, i = best
            q[i] = self._stash_block(q[i])
            total -= best_bytes
            moved = True
        if moved:
            self._event("pressure", tier="host",
                        used=int(self.host_used(total)),
                        budget=int(self.host_budget))

    def _stash_block(self, block) -> FrontierRef:
        arrays = [np.ascontiguousarray(a) for a in block]
        nbytes = sum(a.nbytes for a in arrays)
        with self._lock:
            log = self._log
            if log is None or log.size >= _LOG_BYTES:
                seq = self._frontier_seq
                self._frontier_seq += 1
                log = self._log = _Log(os.path.join(
                    self.segment_dir, f"frontier-{seq:06d}.bin"))
                self._logs[log.path] = log
            offset = log.size
            if os.pwritev(log.fd, [a.view(np.uint8).reshape(-1)
                                   for a in arrays], offset) != nbytes:
                raise OSError(f"a short write to {log.path!r}")
            log.size += nbytes
            log.live += 1
            self._frontier_bytes += nbytes
            self._disk_high_water = max(self._disk_high_water,
                                        self.cold_bytes)
        self._event("spill", tier="disk", kind="frontier",
                    rows=int(len(block[1])), bytes=int(nbytes))
        return FrontierRef(log.path, int(len(block[1])), nbytes, tuple(
            (a.dtype, a.shape) for a in arrays), offset)

    def _read_block(self, ref: FrontierRef):
        try:
            with self._lock:
                log = self._logs.get(ref.path)
            if log is None:
                raise ValueError("its log was deleted")
            buf = np.empty(ref.nbytes, np.uint8)
            got = os.preadv(log.fd, [buf], ref.offset)
            if got != ref.nbytes:
                raise ValueError(f"{got} bytes, not {ref.nbytes}")
            out, at = [], 0
            for dtype, shape in ref.layout:
                n = int(np.prod(shape)) * dtype.itemsize
                out.append(buf[at:at + n].view(dtype).reshape(shape))
                at += n
            return tuple(out)
        except Exception as e:  # noqa: BLE001 — torn or missing stash
            raise ValueError(
                f"frontier block {ref.path!r} at {ref.offset} is unreadable "
                f"(torn write or missing file): {e}; resume from the last "
                "checkpoint") from e

    def prefetch(self, ref: Optional[FrontierRef]) -> None:
        """Starts reading the block ``ref`` on a helper thread, so that
        the read overlaps the current wave."""
        if ref is None or (ref.path, ref.offset) in self._prefetched:
            return
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="stpu-page")
        self._prefetched[ref.path, ref.offset] = self._executor.submit(
            self._read_block, ref)

    def prefetch_window(self, refs) -> None:
        """``prefetch`` of each of ``refs`` (one read a path)."""
        for ref in refs:
            self.prefetch(ref)

    def fetch_frontier(self, ref: FrontierRef, prefetch=None):
        """Reads a paged-out block back (its prefetched read, if any),
        deletes its log once every block in it was read back, and
        prefetches ``prefetch`` (a ref or a list of them)."""
        fut = self._prefetched.pop((ref.path, ref.offset), None)
        if fut is not None:
            block = fut.result()
            self._prefetch_hits += 1
        else:
            block = self._read_block(ref)
        with self._lock:
            log = self._logs.get(ref.path)
            if log is not None:
                log.live -= 1
                if not log.live:
                    del self._logs[ref.path]
                    if log is self._log:
                        self._log = None
                    log.close()
            self._frontier_bytes = max(0, self._frontier_bytes - ref.nbytes)
            self._page_ins += 1
        self._event("page_in", tier="disk", kind="frontier",
                    rows=int(ref.rows), bytes=int(ref.nbytes))
        # A tier shrank: the lint's monotonicity window resets here.
        self._event("pressure", tier="disk", used=int(self.cold_bytes),
                    budget=int(self.host_budget or 0))
        if isinstance(prefetch, (list, tuple)):
            self.prefetch_window(prefetch)
        else:
            self.prefetch(prefetch)
        return block

    def load_ref(self, ref: FrontierRef):
        """A paged-out block's rows, its file kept (a snapshot's read)."""
        return self._read_block(ref)

    # -- The fused engines' arena spans ------------------------------------

    def note_arena_span(self, rows: int, nbytes: int) -> None:
        """Counts one arena-span roll: the expanded prefix of a fused
        arena left the card for the host's parent log."""
        with self._lock:
            self._arena_span_spills += 1
            self._arena_span_rows += int(rows)
            self._arena_span_bytes += int(nbytes)
            self._spill_bytes += int(nbytes)
            self._spills["host"] += 1
            self._host_high_water = max(
                self._host_high_water,
                self.warm_bytes + self._arena_span_bytes)
        self._event("spill", tier="host", kind="arena_span",
                    rows=int(rows), bytes=int(nbytes))

    def note_device_pressure(self, used: int, budget: int) -> None:
        """Counts a device structure that had to pass its budget with
        nothing left to spill (``pressure_notes``)."""
        with self._lock:
            self.pressure_notes += 1
        self._event("pressure", tier="device", used=int(used),
                    budget=int(budget))

    # -- Checkpoints (format v5) -------------------------------------------

    def warm_fps(self) -> np.ndarray:
        """Every warm fingerprint (a snapshot's ``visited`` section holds
        hot and warm; cold travels by reference)."""
        with self._lock:
            arrs = [a for a in self._warm if a is not None and len(a)]
        if not arrs:
            return np.zeros(0, np.uint64)
        return np.concatenate(arrs)

    def checkpoint_refs(self) -> Optional[dict]:
        """The v5 header's ``store`` section: the cold segments by content
        hash, each with its own ``dir`` where it lives outside this
        store's directory (attached from an earlier checkpoint)."""
        with self._lock:
            if not self._cold:
                return None
            cold = []
            for p, part in sorted(self._cold.items()):
                ref = {"partition": p,
                       "file": os.path.basename(part.path),
                       "sha": part.sha, "rows": part.rows}
                part_dir = os.path.dirname(part.path)
                if part_dir and part_dir != self.segment_dir:
                    ref["dir"] = part_dir
                cold.append(ref)
            return {"segment_dir": self.segment_dir, "cold": cold}

    def attach_refs(self, refs: dict, base_dir: Optional[str] = None) -> int:
        """Attaches the cold segments a v5 ``store`` section references,
        each checked by its CRCs and its content hash; a current file
        that fails gives way to its rotation predecessor where that
        matches. Searches each ref's own ``dir``, then the section's
        ``segment_dir``, ``base_dir`` and this store's directory. Returns
        the rows attached; a ref nothing matches raises ``ValueError``."""
        search = [d for d in (refs.get("segment_dir"), base_dir,
                              self.segment_dir) if d]
        attached = 0
        for ref in refs.get("cold", ()):
            p = int(ref["partition"])
            want = str(ref["sha"])
            found = None
            ref_dir = ref.get("dir")
            dirs = ([ref_dir] if ref_dir else []) + search
            for d in dirs:
                for cand in (os.path.join(d, ref["file"]),
                             os.path.join(d, ref["file"]) + PREV_SUFFIX):
                    if not os.path.exists(cand):
                        continue
                    try:
                        verify_file(cand)
                        fps = map_segment_visited(cand)
                        if content_hash(np.asarray(fps)) == want:
                            found = _ColdPart(cand, fps, want)
                            break
                    except ValueError:
                        continue
                if found is not None:
                    break
            if found is None:
                raise ValueError(
                    f"checkpoint references cold segment {ref['file']!r} "
                    f"(partition {p}, sha {want}) but no generation on "
                    "disk matches — the segment is missing or corrupt "
                    "beyond its rotation predecessor")
            with self._lock:
                self._cold[p] = found
                self._filter.add(np.asarray(found.fps, np.uint64),
                                 self._tiers)
            attached += found.rows
        return attached

    def reset(self) -> None:
        """Drops the warm, cold and frontier state (a restart attaches
        its checkpoint's refs again); the settings and counters stay."""
        with self._lock:
            self._warm = [None] * self._P
            self._cold = {}
            self._filter.clear()
            self._prefetched.clear()
            for log in self._logs.values():
                log.close()
            self._logs, self._log = {}, None
            self._spilling.clear()
            self._frontier_bytes = 0

    # -- Telemetry ----------------------------------------------------------

    def gauges(self) -> dict:
        """A wave's tier gauges for the host and disk tiers (the engine
        adds the device tier's)."""
        return {
            "tier_host_rows": int(self.warm_rows + self._arena_span_rows),
            "tier_host_bytes": int(self.warm_bytes
                                   + self._arena_span_bytes),
            "tier_disk_rows": int(self.cold_rows),
            "tier_disk_bytes": int(self.cold_bytes),
        }

    def stats(self) -> dict:
        """The store's settings and counters, under the reference's
        keys."""
        with self._lock:
            return {
                "enabled": True,
                "device_budget": self.device_budget,
                "host_budget": self.host_budget,
                "segment_dir": self.segment_dir,
                "partitions": self._P,
                "host": {"rows": int(self.warm_rows),
                         "bytes": int(self.warm_bytes),
                         "high_water_bytes": int(self._host_high_water)},
                "disk": {"rows": int(self.cold_rows),
                         "bytes": int(self.cold_bytes),
                         "segments": len(self._cold),
                         "spills_in_flight": len(self._spilling),
                         "high_water_bytes": int(self._disk_high_water)},
                "frontier": {"stashed_bytes": int(self._frontier_bytes),
                             "page_ins": int(self._page_ins),
                             "prefetch_hits": int(self._prefetch_hits)},
                "spills": dict(self._spills),
                "spill_bytes": int(self._spill_bytes),
                "probes": int(self._probes),
                "probe_hits": int(self._probe_hits),
                "arena_spans": {"spills": int(self._arena_span_spills),
                                "rows": int(self._arena_span_rows),
                                "bytes": int(self._arena_span_bytes)},
            }


def load_cold_refs(refs: dict, base_dir: Optional[str] = None) -> np.ndarray:
    """The cold segments a v5 ``store`` section references, as one
    fingerprint array (a resume with no store puts them in the table),
    checked as ``TieredStore.attach_refs`` checks them."""
    tmp = TieredStore()
    tmp.attach_refs(refs, base_dir=base_dir)
    parts = [np.asarray(p.fps, np.uint64)
             for _, p in sorted(tmp._cold.items())]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint64)


def store_from_config(*, device_bytes=None, host_bytes=None,
                      segment_dir=None, n_partitions=None, meta=None,
                      owner=None):
    """The engines' store: each keyword given wins over its ``STpu_TIER_*``
    variable; nothing configured gives the shared ``NULL_STORE``."""
    device_bytes = (_parse_bytes(os.environ.get(TIER_DEVICE_ENV))
                    if device_bytes is None else int(device_bytes))
    host_bytes = (_parse_bytes(os.environ.get(TIER_HOST_ENV))
                  if host_bytes is None else int(host_bytes))
    segment_dir = (os.environ.get(TIER_DIR_ENV) or None
                   if segment_dir is None else segment_dir)
    if device_bytes is None and host_bytes is None and not segment_dir:
        return NULL_STORE
    return TieredStore(
        device_budget=device_bytes, host_budget=host_bytes,
        segment_dir=segment_dir,
        n_partitions=int(n_partitions) if n_partitions else 16,
        meta=meta, owner=owner)
