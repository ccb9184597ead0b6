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

Under a matmul plan (``plan=``, ``matmul_wave.MatmulPlan``) both kernels
run the plan's transition-table step (``csrc/plan.cuh::PlanStep``) in
place of the model's: ``sr_wave_<name>_plan`` and ``sr_sender_<name>_plan``
of the model's source, held where the gate admits the model (2pc and
increment and increment_lock at 1 to 8 RMs or threads;
``DeviceModel.CUDA_PLAN_INSTANCES``), with the plan copied into the
kernel's parameters (``plan_host``) and its tables in a device buffer
(``plan_tables``). A plan the entry points do not take raises
(``cuda_plan``). The plain versions run ``matmul_wave.matmul_expand``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import build_and_load
from .device_model import held
from .engine import dedup_and_insert as dedup_and_insert_plain
from .engine import fingerprint_successors, first_occurrence_candidates
from .matmul_wave import expand
from .table import DedupScratch, scratch_bits

__all__ = ["wave_megakernel", "wave_megakernel_plain", "sender_megakernel",
           "sender_megakernel_plain", "cuda_model", "cuda_plan", "plan_host",
           "plan_tables", "plan_table_bytes", "wave_cost", "sender_cost",
           "front_ops", "sym_ops"]

_INT32_MAX = (1 << 31) - 1


def wave_megakernel_plain(dm, store: torch.Tensor, valid: torch.Tensor,
                          table: torch.Tensor, use_sym: bool, layout,
                          plan=None):
    """The plain version of ``wave_megakernel``, in torch ops."""
    succ, sflat, _, _ = expand(dm, plan, layout.unpack(store), valid)
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


#: ``csrc/plan.cuh``'s capacities: key groups, key lanes a group, entries
#: (outputs written, all actions), constants and actions
PLAN_GROUPS, PLAN_KEYS, PLAN_ENTRIES, PLAN_CONSTS, PLAN_ACTIONS = (
    32, 12, 192, 64, 64)
_CONST_GROUP = 0xFF


def plan_host(plan) -> np.ndarray:
    """``plan`` as ``csrc/plan.cuh``'s ``PlanStep::load`` takes it, int32:
    the counts (groups, entries, constants, fanout, width); each group's
    table offset in words, rows, columns, key count, keys and strides
    (``PLAN_KEYS`` each); each action's first entry and the end; the
    entries (``lane | group << 8 | column << 16``, a constant's group
    ``0xFF`` and its column its index among the constants); the constants'
    values (uint32 bit patterns). Raises ``NotImplementedError`` for a plan
    past the struct's capacities."""
    W, F = plan.width, plan.fanout
    n_entries = len(plan.consts) + sum(len(g.cols) for g in plan.groups)
    if (len(plan.groups) > PLAN_GROUPS or F > PLAN_ACTIONS or W > 254
            or n_entries > PLAN_ENTRIES or len(plan.consts) > PLAN_CONSTS
            or any(len(g.keys) > PLAN_KEYS for g in plan.groups)):
        raise NotImplementedError(
            f"a matmul plan of {len(plan.groups)} groups, {n_entries} "
            f"entries and {len(plan.consts)} constants at fanout {F} does "
            "not fit csrc/plan.cuh: run it with wave_kernel=False on the "
            "card")
    head = [len(plan.groups), n_entries, len(plan.consts), F, W]
    groups, offset = [], 0
    for g in plan.groups:
        pad = [0] * (PLAN_KEYS - len(g.keys))
        groups += ([offset, g.domain, len(g.cols), len(g.keys)]
                   + list(g.keys) + pad + list(g.strides) + pad)
        offset += g.domain * len(g.cols)
    by_action = [[] for _ in range(F)]
    for c, (a, o, _) in enumerate(plan.consts):
        by_action[a].append(o | _CONST_GROUP << 8 | c << 16)
    for gi, g in enumerate(plan.groups):
        for j, (a, o) in enumerate(g.cols):
            by_action[a].append(o | gi << 8 | j << 16)
    first = np.cumsum([0] + [len(e) for e in by_action]).tolist()
    entries = [e for action in by_action for e in action]
    consts = [v for _, _, v in plan.consts]
    return np.array(head + groups + first + entries + consts,
                    np.int64).astype(np.uint32).view(np.int32)


def plan_tables(plan) -> np.ndarray:
    """Every group's table of exact outputs, uint32 ``[rows, cols]``
    row-major, one after another (``plan_host``'s offsets), as int32 bit
    patterns."""
    parts = [g.table_u32().reshape(-1) for g in plan.groups]
    return np.concatenate(parts or [np.zeros(0, np.int64)]).astype(
        np.uint32).view(np.int32)


def plan_table_bytes(plan) -> int:
    """The bytes of a matmul plan's tables as the kernels read them (0
    without a plan)."""
    return 0 if plan is None else plan_tables(plan).nbytes


def sym_ops(dm) -> int:
    """32-bit integer operations of one representative beyond its
    fingerprint: 2pc's sort network over its RMs' keys, the shared
    counters' over their threads' pairs; a register workload's network
    rewritten and sorted again, and its lanes compared, once a
    non-identity client permutation (none where the group is trivial:
    paxos below 4 clients, ABD; 23 at single-copy 4 on one server)."""
    if hasattr(dm, "rm_count"):
        return 2 * dm.rm_count ** 2
    if hasattr(dm, "thread_count"):
        # The shared counters' stable sort of (key, t, pc) triples: T(T-1)/2
        # compare-exchanges of about 8 operations each.
        return 4 * dm.thread_count ** 2
    return len(dm.client_permutations()) * (2 * dm.net_slots ** 2
                                            + 8 * dm.state_width)


def front_ops(dm, slots: int, n_valid: int, use_sym: bool) -> int:
    """32-bit integer operations of the kernels' front: the path
    fingerprint, unpack, step and re-pack of every slot, and the
    representative and its fingerprint of each of ``n_valid`` valid
    successors under symmetry."""
    W = dm.state_width
    fp_ops = 2 * (6 * W + 9) + 4
    ops = slots * (fp_ops + 8 * W)
    if use_sym:
        ops += n_valid * (fp_ops + sym_ops(dm))
    return ops


def wave_cost(dm, B: int, wp: int, use_sym: bool = False, plan=None,
              n_valid=None, cand=None) -> dict:
    """The work ``wave_megakernel`` must do on ``B`` packed rows of
    ``wp`` words, ``S = B * F`` successor slots of which ``n_valid`` are
    valid and ``cand`` candidates (default: all ``S``, the most the shape
    can take): ``{"bytes", "ops"}``. Bytes, each once: the packed batch
    and valid read, the packed successors, path fingerprints and three
    byte masks written, one 32-byte sector a candidate in the visited
    table, and a plan's tables read once; the dedup fingerprints and the
    scratch are neither input nor output. Operations: ``front_ops``.
    The profiler's records and ``chip_smoke.py``'s bounds both come from
    here."""
    S = B * dm.max_fanout
    n_valid = S if n_valid is None else int(n_valid)
    cand = S if cand is None else int(cand)
    return {"bytes": (4 * B * wp + B + 4 * S * wp + 8 * S + 3 * S
                      + 32 * cand + plan_table_bytes(plan)),
            "ops": front_ops(dm, S, n_valid, use_sym)}


def sender_cost(dm, n: int, B: int, wp: int, use_sym: bool = False,
                plan=None, n_valid=None) -> dict:
    """The work ``sender_megakernel`` must do on ``n`` shards of ``B``
    packed rows (``n_valid`` of the ``n * S`` slots valid; default all):
    ``{"bytes", "ops"}``. Bytes, each once: the packed batch and valid
    read; the packed successors, two fingerprint arrays and two byte
    masks written; a plan's tables read once. Operations: ``front_ops``
    over the ``n * S`` slots."""
    S = B * dm.max_fanout
    n_valid = n * S if n_valid is None else int(n_valid)
    return {"bytes": (4 * n * B * wp + n * B + 4 * n * S * wp + 16 * n * S
                      + 2 * n * S + plan_table_bytes(plan)),
            "ops": front_ops(dm, n * S, n_valid, use_sym)}


def cuda_plan(dm, layout, plan) -> None:
    """Raises ``NotImplementedError`` unless the kernels' entry points take
    ``plan`` for ``dm``: its CUDA device code, an instance of the plan form
    at its size (``DeviceModel.CUDA_PLAN_INSTANCES``, the first of its
    ``cuda_model()`` params), no boundary, and a plan within
    ``csrc/plan.cuh``'s capacities."""
    name, params, _ = cuda_model(dm, layout)
    instances = getattr(type(dm), "CUDA_PLAN_INSTANCES", ())
    W = dm.state_width
    if (not params or params[0] not in instances
            or dm.boundary(torch.zeros((1, W), dtype=torch.int64))
            is not None):
        raise NotImplementedError(
            f"csrc/wave_{name}.cu has no plan-form entry for "
            f"{type(dm).__name__} at {params[:1]} (it holds "
            f"{held(instances)}): run it with wave_matmul=False or "
            "wave_kernel=False on the card")
    plan_host(plan)

def _device_index(dev: torch.device) -> int:
    """The index of CUDA device ``dev`` (the current one for a bare
    ``cuda``)."""
    return torch.cuda.current_device() if dev.index is None else dev.index


#: sources that hold some of a model's instances, by the model's name and
#: its first param: paxos at 4 clients builds from ``csrc/wave_paxos4.cu``
#: and ``sender_paxos4.cu``, beside its sources of 1 to 3 clients (its
#: fourth client count alone takes about as long to build as the others)
SPLIT_SOURCES = {"paxos": {4: "paxos4"}}


def _source(name: str, params) -> str:
    """The name of the sources (``csrc/wave_<source>.cu``, and the sender's
    ``SENDER_SOURCES[source]``) that hold model ``name`` at ``params``
    (another model's params may be arrays: only a split model's are
    looked up)."""
    split = SPLIT_SOURCES.get(name)
    return split.get(params[0], name) if split else name


@functools.lru_cache(maxsize=None)
def _entry(name: str, kinds: str, plan: bool = False, source=None):
    """``csrc/wave_<source>.cu``'s wave entry point (``source`` is
    ``name`` unless given), its model params of the C types ``kinds``
    (``_kinds``); its plan form ``sr_wave_<name>_plan``, which takes the
    host plan and the device tables after them, when ``plan``."""
    fn = getattr(build_and_load("wave_" + (source or name)),
                 "sr_wave_" + name + ("_plan" if plan else ""))
    fn.restype = ctypes.c_int
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = ([{"i": i, "p": p}[k] for k in kinds] + [p, p] * plan
                   + [i, p, i, i, p, p, ctypes.c_longlong, i,
                                      p, i, p, p, p, p, p, p, i, p, p, p, i,
                                      p])
    return fn


def wave_megakernel(dm, store: torch.Tensor, valid: torch.Tensor,
                    table: torch.Tensor, use_sym: bool, layout,
                    scratch=None, plan=None):
    """``store int32[B, Wp]`` (packed rows), ``valid bool[B]``, ``table
    int64[C]`` (C a power of two, updated in place) -> ``(succ_store
    int32[S, Wp], path_fps int64[S], sflat bool[S], new_mask bool[S],
    cand_mask bool[S], new_count, cand_count, full)`` with ``S = B * F``;
    the counts are int32 and ``full`` bool 0-dim tensors on the same
    device. ``full`` is True when a candidate found neither its key nor
    a free slot in the whole table. ``scratch``, a caller's
    ``table.DedupScratch`` for at least ``S`` rows on the tensors' device,
    is used in place of a fresh one. ``plan``, a ``matmul_wave.MatmulPlan``
    of ``dm``, runs the plan's step in place of the model's."""
    tensors = (store, valid, table)
    if all(t.device.type == "cpu" for t in tensors):
        return wave_megakernel_plain(dm, store, valid, table, use_sym, layout,
                                     plan)
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
    fn, pre = _launcher(_entry, dm, layout, name, params, plan, dev)
    # The launch goes to the current device's context, which in the
    # checker's worker thread is not necessarily the tensors' device.
    with torch.cuda.device(dev):
        rc = fn(*_c_params(params), *pre, int(use_sym), lanes.ctypes.data,
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


def _launcher(entry, dm, layout, name, params, plan, dev):
    """``(entry point, its plan arguments)``: the step form's, or under
    ``plan`` the plan form's with the host plan and the device tables,
    checked (``cuda_plan``) and made once a plan and device."""
    source = _source(name, params)
    if plan is None:
        return entry(name, _kinds(params), source=source), ()

    def make():
        cuda_plan(dm, layout, plan)
        return plan_host(plan), torch.from_numpy(plan_tables(plan)).to(dev)

    host, tables = plan.derived(("kernel", str(dev)), make)
    return (entry(name, _kinds(params), True, source=source),
            (host.ctypes.data, tables.data_ptr()))


# -- The sender kernel -------------------------------------------------------


def sender_megakernel_plain(dm, store: torch.Tensor, valid: torch.Tensor,
                            use_sym: bool, layout, local_dedup: bool,
                            plan=None):
    """The plain version of ``sender_megakernel``, in torch ops: the
    front half of ``wave_megakernel_plain`` over the stacked shards, then
    each shard's own first occurrence (``pallas_table.py:486-487``)."""
    n, B = valid.shape
    S = B * dm.max_fanout
    rows = layout.unpack(store).reshape(n * B, -1)
    succ, sflat, _, _ = expand(dm, plan, rows, valid.reshape(n * B))
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
#: kernel's: paxos's client counts are the longest build, then VSR's,
#: single-copy's and ABD's instances (keyed by ``_source``)
SENDER_SOURCES = {"paxos": "sender_paxos", "paxos4": "sender_paxos4",
                  "vsr": "sender_vsr", "single_copy": "sender_single_copy",
                  "abd": "sender_abd"}


@functools.lru_cache(maxsize=None)
def _sender_entry(name: str, kinds: str, plan: bool = False, source=None):
    """Likewise, its sender entry point (in ``csrc/wave_<source>.cu``, or
    ``SENDER_SOURCES[source]``), and its plan form."""
    source = source or name
    fn = getattr(build_and_load(SENDER_SOURCES.get(source,
                                                   "wave_" + source)),
                 "sr_sender_" + name + ("_plan" if plan else ""))
    fn.restype = ctypes.c_int
    i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = ([{"i": i, "p": p}[k] for k in kinds] + [p, p] * plan
                   + [i, i, p, i, i, p, p, ll, ll, i, p, p, p, p, p, p, p, i,
                      i, p])
    return fn


def sender_megakernel(dm, store: torch.Tensor, valid: torch.Tensor,
                      use_sym: bool, layout, local_dedup: bool,
                      scratch=None, plan=None):
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
    ``local_dedup`` none is needed. ``plan`` as ``wave_megakernel``'s."""
    if store.device.type == "cpu" and valid.device.type == "cpu":
        return sender_megakernel_plain(dm, store, valid, use_sym, layout,
                                       local_dedup, plan)
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
    fn, pre = _launcher(_sender_entry, dm, layout, name, params, plan, dev)
    with torch.cuda.device(dev):
        rc = fn(*_c_params(params), *pre, int(use_sym), int(local_dedup),
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
