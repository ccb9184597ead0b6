"""The single-kernel wave and the sender kernel: CUDA kernels and wrappers.

``sender_megakernel`` replaces the Pallas kernel
``build_sender_megakernel``: the front half of the wave below with no
table, which the sharded engine (``sharded_fused.py``) runs on every
shard's batch at once, ending in each shard's own first occurrence
(``send_mask``). It follows the same rules as ``wave_megakernel``, with
``sender_megakernel_plain`` as its plain version, and claims in the same
caller-owned scratch (``scratch=``), a region a shard.

``wave_megakernel`` replaces the Pallas kernel
``stateright_tpu/tpu/pallas_table.py::build_wave_megakernel`` (with
``_wave_front``). From a packed batch it computes a wave's whole
successor path: unpack, the model's step, the path and dedup
fingerprints (the representative's under symmetry), the first occurrence
within the wave, the probe and claim in the visited table (in place),
and the re-pack of the successors.

For CUDA tensors it launches the kernel of ``csrc/wave.cuh``, built for
the model named by ``DeviceModel.cuda_model()`` from
``csrc/wave_<name>.cu`` at first use (2pc's; the actor models' on
``csrc/models/actor_net.cuh``: the register workloads' on
``csrc/models/register_workload.cuh``, paxos's, single-copy's and ABD's,
and ping-pong's and viewstamped replication's; the plain models'), or
raises: a model with no device code, a layout or a size the
device code does not take, a failed build or a failed launch all raise.
Sentinel lanes (the register workloads' network slots) pack and unpack as
``packing.py`` does. For CPU tensors
it runs the plain version, ``wave_megakernel_plain``: the port's own
stage functions in the order of ``_wave_front`` and the dedup kernel. It
is also the reference the kernel is held to on the card. The wrapper
never synchronises, so it can run inside a multi-wave dispatch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import build_and_load
from .engine import dedup_and_insert as dedup_and_insert_plain
from .engine import (expand_frontier, fingerprint_successors,
                     first_occurrence_candidates)
from .table import DedupScratch, scratch_bits

__all__ = ["wave_megakernel", "wave_megakernel_plain", "sender_megakernel",
           "sender_megakernel_plain", "cuda_model"]

_INT32_MAX = (1 << 31) - 1


def wave_megakernel_plain(dm, store: torch.Tensor, valid: torch.Tensor,
                          table: torch.Tensor, use_sym: bool, layout):
    """The plain version of ``wave_megakernel``, in torch ops."""
    succ, sflat, _, _ = expand_frontier(dm, layout.unpack(store), valid)
    dedup_fps, path_fps = fingerprint_successors(dm, succ, sflat, use_sym)
    new_mask, cand_mask, new_count, cand_count, full = \
        dedup_and_insert_plain(dedup_fps, table)
    return (layout.pack(succ), path_fps, sflat, new_mask, cand_mask,
            new_count, cand_count, full)


def _defining_class(cls, name: str):
    return next(k for k in cls.__mro__ if name in vars(k))


#: the hooks whose device twin a model's CUDA code is: a subclass that
#: overrides one below the class declaring ``cuda_model`` has no device
#: code (the actor layer's delivery and timeout and the register
#: workload's client and symmetry hooks, which ``csrc/models/actor_net.cuh``,
#: ``register_workload.cuh`` and their models mirror, included)
_DEVICE_HOOKS = ("step", "boundary", "representative", "deliver",
                 "timeout", "server_deliver", "_client_deliver", "build_env",
                 "client_permutations", "_sym_tables", "_sym_rewrite",
                 "sym_extra_tables", "sym_rewrite_servers",
                 "sym_rewrite_extra", "sym_rewrite_internal_req")


def cuda_model(dm, layout):
    """``(name, params, lanes)`` of ``dm``'s CUDA device code, with
    ``lanes`` the layout as the kernel takes it: each lane's packed word,
    bit offset, bits, sentinel flag and sentinel value (its uint32 bit
    pattern; the field's all-ones value when the lane has none),
    ``int32[5 * W]``. Raises when the model has no device code for its
    step."""
    spec = dm.cuda_model()
    owner = _defining_class(type(dm), "cuda_model")
    overridden = [fn for fn in _DEVICE_HOOKS if hasattr(dm, fn)
                  and _defining_class(type(dm), fn) not in owner.__mro__]
    if spec is None or overridden:
        raise NotImplementedError(
            f"model {type(dm).__name__} has no CUDA step for the "
            "single-kernel wave (DeviceModel.cuda_model()"
            + (f"; it overrides {overridden}" if overridden else "")
            + "): run it with wave_kernel=False on the card")
    lanes = np.array([[lane.word for lane in layout.lanes],
                      [lane.offset for lane in layout.lanes],
                      [lane.bits for lane in layout.lanes],
                      [lane.sentinel is not None for lane in layout.lanes],
                      [lane.mask if lane.sentinel is None else lane.sentinel
                       for lane in layout.lanes]], np.int64)
    name, params = spec
    params = tuple(np.ascontiguousarray(p, np.int32)
                   if isinstance(p, np.ndarray) else int(p) for p in params)
    return (name, params,
            lanes.reshape(-1).astype(np.uint32).view(np.int32))


def _kinds(params) -> str:
    """The C types of a model's params as the entry points take them: 'i'
    an int, 'p' a host int32 array passed by pointer (read during the
    call, which copies it into the kernel's parameters)."""
    return "".join("p" if isinstance(p, np.ndarray) else "i" for p in params)


def _c_params(params) -> list:
    return [p.ctypes.data if isinstance(p, np.ndarray) else p for p in params]


def _device_index(dev: torch.device) -> int:
    """The index of CUDA device ``dev`` (the current one for a bare
    ``cuda``)."""
    return torch.cuda.current_device() if dev.index is None else dev.index


@functools.lru_cache(maxsize=None)
def _entry(name: str, kinds: str):
    """``csrc/wave_<name>.cu``'s wave entry point, its model params of the
    C types ``kinds`` (``_kinds``)."""
    fn = getattr(build_and_load("wave_" + name), "sr_wave_" + name)
    fn.restype = ctypes.c_int
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = ([{"i": i, "p": p}[k] for k in kinds]
                   + [i, p, i, i, p, p, ctypes.c_longlong, i,
                                      p, i, p, p, p, p, p, p, i, p, p, p, i,
                                      p])
    return fn


def wave_megakernel(dm, store: torch.Tensor, valid: torch.Tensor,
                    table: torch.Tensor, use_sym: bool, layout,
                    scratch=None):
    """``store int32[B, Wp]`` (packed rows), ``valid bool[B]``, ``table
    int64[C]`` (C a power of two, updated in place) -> ``(succ_store
    int32[S, Wp], path_fps int64[S], sflat bool[S], new_mask bool[S],
    cand_mask bool[S], new_count, cand_count, full)`` with ``S = B * F``;
    the counts are int32 and ``full`` bool 0-dim tensors on the same
    device. ``full`` is True when a candidate found neither its key nor
    a free slot in the whole table. ``scratch``, a caller's
    ``table.DedupScratch`` for at least ``S`` rows on the tensors' device,
    is used in place of a fresh one."""
    tensors = (store, valid, table)
    if all(t.device.type == "cpu" for t in tensors):
        return wave_megakernel_plain(dm, store, valid, table, use_sym, layout)
    dev = store.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"store on {store.device}, valid on {valid.device} and table on "
            f"{table.device}: all must be on one CUDA device (or the CPU)")
    B, F, wp = store.shape[0], dm.max_fanout, layout.packed_width
    capacity = table.shape[0]
    for name, t, dtype, shape in (("store", store, torch.int32, (B, wp)),
                                  ("valid", valid, torch.bool, (B,)),
                                  ("table", table, torch.int64, (capacity,))):
        if t.dtype != dtype or not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"of shape {shape}")
    if capacity < 2 or capacity & (capacity - 1):
        raise ValueError(f"table capacity {capacity} is not a power of two")
    name, params, lanes = cuda_model(dm, layout)
    S = B * F
    scratch = DedupScratch.for_call(scratch, S, dev)
    succ_store = torch.empty((S, wp), dtype=torch.int32, device=dev)
    path_fps = torch.empty(S, dtype=torch.int64, device=dev)
    sflat = torch.empty(S, dtype=torch.bool, device=dev)
    new_mask = torch.empty(S, dtype=torch.bool, device=dev)
    cand_mask = torch.empty(S, dtype=torch.bool, device=dev)
    counts = torch.empty(3, dtype=torch.int32, device=dev)
    fn = _entry(name, _kinds(params))
    # The launch goes to the current device's context, which in the
    # checker's worker thread is not necessarily the tensors' device.
    with torch.cuda.device(dev):
        rc = fn(*_c_params(params), int(use_sym), lanes.ctypes.data,
                layout.width, wp, store.data_ptr(), valid.data_ptr(), B, F,
                table.data_ptr(), capacity.bit_length() - 1,
                succ_store.data_ptr(),
                path_fps.data_ptr(), sflat.data_ptr(), *scratch.args(),
                new_mask.data_ptr(), cand_mask.data_ptr(), counts.data_ptr(),
                _device_index(dev),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wave kernel launch for {name} failed: CUDA "
                           f"error {rc}")
    wave_megakernel.launches += 1
    return (succ_store, path_fps, sflat, new_mask, cand_mask, counts[0],
            counts[1], counts[2] != 0)


#: kernel launches since the caller last set it to 0 (the CPU path does
#: not count: it launches nothing)
wave_megakernel.launches = 0


# -- The sender kernel -------------------------------------------------------


def sender_megakernel_plain(dm, store: torch.Tensor, valid: torch.Tensor,
                            use_sym: bool, layout, local_dedup: bool):
    """The plain version of ``sender_megakernel``, in torch ops: the
    front half of ``wave_megakernel_plain`` over the stacked shards, then
    each shard's own first occurrence (``pallas_table.py:486-487``)."""
    n, B = valid.shape
    S = B * dm.max_fanout
    rows = layout.unpack(store).reshape(n * B, -1)
    succ, sflat, _, _ = expand_frontier(dm, rows, valid.reshape(n * B))
    dedup_fps, path_fps = fingerprint_successors(dm, succ, sflat, use_sym)
    dedup_fps, sflat = dedup_fps.reshape(n, S), sflat.reshape(n, S)
    if local_dedup:
        send_mask = torch.stack([first_occurrence_candidates(d)
                                 for d in dedup_fps.unbind()])
    else:
        send_mask = sflat.clone()
    return (layout.pack(succ).reshape(n, S, -1), dedup_fps,
            path_fps.reshape(n, S), sflat, send_mask)


#: models whose sender entry point is a source of its own
#: (``csrc/<source>.cu``), so that its kernels build beside the wave
#: kernel's: paxos's four client counts are the longest build
SENDER_SOURCES = {"paxos": "sender_paxos"}


@functools.lru_cache(maxsize=None)
def _sender_entry(name: str, kinds: str):
    """Likewise, its sender entry point (in ``csrc/wave_<name>.cu``, or
    ``SENDER_SOURCES[name]``)."""
    fn = getattr(build_and_load(SENDER_SOURCES.get(name, "wave_" + name)),
                 "sr_sender_" + name)
    fn.restype = ctypes.c_int
    i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = ([{"i": i, "p": p}[k] for k in kinds]
                   + [i, i, p, i, i, p, p, ll, ll, i, p, p, p, p, p, p, p, i,
                      i, p])
    return fn


def sender_megakernel(dm, store: torch.Tensor, valid: torch.Tensor,
                      use_sym: bool, layout, local_dedup: bool,
                      scratch=None):
    """The sharded engine's per-shard front half of a wave, for ``n``
    stacked shards: ``store int32[n, B, Wp]`` (packed rows), ``valid
    bool[n, B]`` -> ``(succ_store int32[n, S, Wp], dedup_fps int64[n, S],
    path_fps int64[n, S], sflat bool[n, S], send_mask bool[n, S])`` with
    ``S = B * F``. ``send_mask`` is the earliest slot of each dedup
    fingerprint within its own shard when ``local_dedup``, else
    ``sflat``. One launch covers every shard, and a second finds the
    first occurrences when ``local_dedup``. ``scratch``, a caller's
    ``table.DedupScratch`` for at least ``n * S`` rows in ``n`` shards
    on the tensors' device, is used in place of a fresh one; without
    ``local_dedup`` none is needed."""
    if store.device.type == "cpu" and valid.device.type == "cpu":
        return sender_megakernel_plain(dm, store, valid, use_sym, layout,
                                       local_dedup)
    dev = store.device
    if dev.type != "cuda" or valid.device != dev:
        raise ValueError(
            f"store on {store.device} and valid on {valid.device}: both "
            "must be on one CUDA device (or the CPU)")
    n, B = valid.shape
    F, wp = dm.max_fanout, layout.packed_width
    for name, t, dtype, shape in (("store", store, torch.int32, (n, B, wp)),
                                  ("valid", valid, torch.bool, (n, B))):
        if t.dtype != dtype or not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"of shape {shape}")
    name, params, lanes = cuda_model(dm, layout)
    S = B * F
    if n * S > _INT32_MAX:
        raise ValueError(f"{n} x {S} successor slots exceed the kernel's "
                         "int32 row index")
    succ_store = torch.empty((n, S, wp), dtype=torch.int32, device=dev)
    dedup_fps = torch.empty((n, S), dtype=torch.int64, device=dev)
    path_fps = torch.empty((n, S), dtype=torch.int64, device=dev)
    sflat = torch.empty((n, S), dtype=torch.bool, device=dev)
    send_mask = torch.empty((n, S), dtype=torch.bool, device=dev)
    slots = slot_of = None
    region_bits = 0
    if local_dedup:
        scratch = DedupScratch.for_call(scratch, n * S, dev, shards=n)
        slots, slot_of = scratch.slots.data_ptr(), scratch.slot_of.data_ptr()
        region_bits = scratch_bits(n * S, n)[1]
    fn = _sender_entry(name, _kinds(params))
    with torch.cuda.device(dev):
        rc = fn(*_c_params(params), int(use_sym), int(local_dedup),
                lanes.ctypes.data, layout.width, wp, store.data_ptr(),
                valid.data_ptr(), B, n, F, succ_store.data_ptr(),
                dedup_fps.data_ptr(), path_fps.data_ptr(), sflat.data_ptr(),
                send_mask.data_ptr(),
                slots, slot_of, region_bits, _device_index(dev),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sender kernel launch for {name} failed: CUDA "
                           f"error {rc}")
    sender_megakernel.launches += 1
    return succ_store, dedup_fps, path_fps, sflat, send_mask


#: kernel launches since the caller last set it to 0 (the CPU path does
#: not count: it launches nothing)
sender_megakernel.launches = 0
