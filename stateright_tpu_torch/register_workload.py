"""Register workloads, checked for linearizability: host and device forms.

A register workload has ``S`` servers behind the Put/Get interface and
``C`` clients that each Put one value and then Get it, round robin over
the servers, with a linearizability tester riding along as history.

The host form is the port's copy of ``stateright_tpu/actor/register.py``:
``RegisterActor`` (the scripted client, and the wrapper of a protocol's
server actor), the history hooks ``record_invocations`` /
``record_returns``, and ``register_model``, which builds a protocol's
``ActorModel`` as each example's ``into_model()`` does.

The device form is the port's copy of
``stateright_tpu/tpu/register_workload.py``, batch-first. Its base owns
what every such protocol shares:

- the envelope layout, the client's state machine with its history
  recording, and the host codec of clients, history and network;
- the device properties: linearizability and sequential consistency,
  searched as a static reduction over every per-thread-ordered
  interleaving (constant tables, below), and "value chosen";
- the client-permutation symmetry and its ``representative``.

A protocol implements its server: ``SERVER_LANES``, ``server_deliver``,
``encode_server``/``decode_server``, and for internal messages
``INTERNAL_KINDS`` with ``encode_internal``/``decode_internal``.

Envelope bits (model-specific ``extra`` bits above the value field):

====  ========  ========================================
bits  field     meaning
====  ========  ========================================
0:3   dst       destination actor index
3:6   src       source actor index
6:10  kind      PUT/GET/PUTOK/GETOK, then internal kinds
10:13 req       request id as ``(op-1) << 2 | client``
13:   value     0 = NO_VALUE, else 1 + client index (2 bits, 3 at C=4)
====  ========  ========================================

The device functions take ``int64`` rows and tables. The observation
tables are ``uint64`` words, carried as their ``int64`` bit patterns:
the search only ANDs them and tests ``!= 0``. A table gather clamps its
index, as the reference's does. The tables live on each device the model
runs on once its first call there has copied them.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import permutations, product
from typing import Optional

import numpy as np
import torch

from .actor import (NO_VALUE, Actor, ActorModel, ActorModelState, Envelope,
                    Get, GetOk, Id, Internal, LinearizabilityTester, Network,
                    Out, Put, PutOk, Read, ReadOk, Register,
                    RegisterClientState, RegisterServerState, Write, WriteOk)
from .actor_device import EMPTY_ENV, M32, ActorDeviceModel
from . import device_model
from .device_model import DeviceFormUnavailable
from .model import Expectation

__all__ = ["RegisterWorkloadDevice", "RegisterActor", "register_model",
           "record_invocations", "record_returns", "linearizable",
           "value_chosen", "perm_tables",
           "observation_tables", "packed_observation_tables",
           "serialization_tables", "PUT", "GET", "PUTOK", "GETOK"]

PUT, GET, PUTOK, GETOK = range(4)


def cuda_instance(name: str, dm, instances) -> None:
    """Raises ``NotImplementedError`` unless ``csrc/wave_<name>.cu``
    holds its kernels at ``dm``'s ``(clients, servers)``, one of
    ``instances``, and its ``net_slots``, 1 up to the default (each
    message names what is held)."""
    device_model.cuda_instance(name, (dm.C, dm.S), instances,
                               f"{dm.C} clients / {dm.S} servers")
    if not 1 <= dm.net_slots <= dm.default_slots:
        raise NotImplementedError(
            f"csrc/wave_{name}.cu holds 1 to {dm.default_slots} network "
            f"slots at {dm.C} clients / {dm.S} servers, not "
            f"{dm.net_slots}: run it with wave_kernel=False on the card")


def record_invocations(cfg, history, env):
    """``ActorModel.record_msg_out`` of a register workload: a Put sent
    records a Write invoked, a Get a Read, on the sending actor's thread
    (the reference's ``register.rs:37-58``)."""
    msg = env.msg
    if type(msg) is Get:
        op = Read()
    elif type(msg) is Put:
        op = Write(msg.value)
    else:
        return None
    history = history.clone()
    try:
        history.on_invoke(env.src, op)
    except ValueError:
        pass  # an invalid history fails the "linearizable" search
    return history


def record_returns(cfg, history, env):
    """``ActorModel.record_msg_in`` of a register workload: a GetOk
    delivered records a ReadOk returned, a PutOk a WriteOk, on the
    receiving actor's thread (``register.rs:64-87``)."""
    msg = env.msg
    if type(msg) is GetOk:
        ret = ReadOk(msg.value)
    elif type(msg) is PutOk:
        ret = WriteOk()
    else:
        return None
    history = history.clone()
    try:
        history.on_return(env.dst, ret)
    except ValueError:
        pass
    return history


class RegisterActor(Actor):
    """A register workload's actor: a scripted client (``client``: it
    Puts one value to a server, then Gets from the next) or
    a wrapped server (``wrap``), as ``stateright_tpu/actor/register.py``
    (the reference's ``register.rs:90-217``). Servers come first in the
    actor list, so a client finds a server by its index modulo the server
    count."""

    def __init__(self, *, server_count: Optional[int] = None,
                 server: Optional[Actor] = None):
        self.server = server
        self.server_count = server_count

    @staticmethod
    def client(server_count: int) -> "RegisterActor":
        return RegisterActor(server_count=server_count)

    @staticmethod
    def wrap(server: Actor) -> "RegisterActor":
        return RegisterActor(server=server)

    def on_start(self, id: Id, o: Out):
        if self.server is not None:
            return RegisterServerState(self.server.on_start(id, o))
        index, server_count = int(id), self.server_count
        if index < server_count:
            raise ValueError("RegisterActor clients must be added to the "
                             "model after servers.")
        value = chr(ord("A") + (index - server_count))
        o.send(Id(index % server_count), Put(index, value))
        return RegisterClientState(awaiting=index, op_count=1)

    def on_msg(self, id: Id, state, src: Id, msg, o: Out):
        if self.server is not None:
            inner = self.server.on_msg(id, state.state, src, msg, o)
            return None if inner is None else RegisterServerState(inner)
        if state.awaiting is None:
            return None
        index, server_count = int(id), self.server_count
        if type(msg) is PutOk and msg.request_id == state.awaiting:
            request_id = (state.op_count + 1) * index
            dst = Id((index + state.op_count) % server_count)
            o.send(dst, Get(request_id))
            return RegisterClientState(awaiting=request_id,
                                       op_count=state.op_count + 1)
        if type(msg) is GetOk and msg.request_id == state.awaiting:
            return RegisterClientState(awaiting=None,
                                       op_count=state.op_count + 1)
        return None


def register_model(model: ActorModel, servers, client_count: int
                   ) -> ActorModel:
    """``model`` made the register workload of ``servers`` (one actor a
    server) and ``client_count`` Put-then-Get clients, as each example's
    ``into_model()``: a network that does not duplicate, a
    linearizability tester as history, and "linearizable" (always) and
    "value chosen" (sometimes)."""
    model.init_history = LinearizabilityTester(Register(NO_VALUE))
    for server in servers:
        model.actor(RegisterActor.wrap(server))
    for _ in range(client_count):
        model.actor(RegisterActor.client(server_count=len(servers)))
    return (model.with_duplicating_network(False)
            .property(Expectation.ALWAYS, "linearizable", linearizable)
            .property(Expectation.SOMETIMES, "value chosen", value_chosen)
            .record_msg_in(record_returns)
            .record_msg_out(record_invocations))


def value_chosen(_model, state: ActorModelState) -> bool:
    """"value chosen": a ``GetOk`` of a written value is in flight."""
    return any(type(env.msg) is GetOk and env.msg.value != NO_VALUE
               for env in state.network)


def linearizable(_model, state: ActorModelState) -> bool:
    """"linearizable": the history serializes."""
    return state.history.serialized_history() is not None


@lru_cache(maxsize=None)
def perm_tables(c: int):
    """All multiset permutations of (thread 0 x2, ..., thread c-1 x2),
    sorted: ``(thread [NC, 2c], occurrence [NC, 2c], pos [NC, c, 2])``,
    the occurrence index of each op and the position of each (thread,
    op)."""
    perms = sorted(set(permutations([t for t in range(c) for _ in (0, 1)])))
    thread = np.array(perms, np.int32)
    occ = np.zeros_like(thread)
    pos = np.zeros((len(perms), c, 2), np.int32)
    for i, p in enumerate(perms):
        counts = [0] * c
        for j, t in enumerate(p):
            occ[i, j] = counts[t]
            pos[i, t, counts[t]] = j
            counts[t] += 1
    return thread, occ, pos


@lru_cache(maxsize=None)
def observation_tables(c: int):
    """``(obs [NC, c, 2^c] uint32, edge_ok [NC, c, 4^c] bool)``: the value
    thread t's read observes under a permutation with a set of placed
    writers (0 = none: the placed writer latest before the read), and
    whether no op recorded as completed before t's read (its
    happened-before edges, 2 bits a peer) sits after it."""
    _, _, pos = perm_tables(c)
    nc = pos.shape[0]
    obs = np.zeros((nc, c, 1 << c), np.uint32)
    edge_ok = np.zeros((nc, c, 1 << (2 * c)), bool)
    for perm in range(nc):
        for t in range(c):
            p_read = pos[perm, t, 1]
            for placed in range(1 << c):
                best_pos, v = -1, 0
                for j in range(c):
                    pw = pos[perm, j, 0]
                    if (placed >> j) & 1 and best_pos < pw < p_read:
                        best_pos, v = pw, j + 1
                obs[perm, t, placed] = v
            for hb in range(1 << (2 * c)):
                edge_ok[perm, t, hb] = all(
                    not ((edge >= 1 and pos[perm, j, 0] > p_read)
                         or (edge >= 2 and pos[perm, j, 1] > p_read))
                    for j in range(c) if j != t
                    for edge in ((hb >> (2 * j)) & 3,))
    return obs, edge_ok


@lru_cache(maxsize=None)
def packed_observation_tables(c: int):
    """The observation tables packed over the permutation axis into
    ``uint64`` words (pad bits 0): ``ok_v[t, placed * (c+1) + ret]`` has
    bit p set iff thread t's read observes ``ret`` under permutation p
    with writer set ``placed``; ``edge_pk[t, hb]`` bit p iff no
    happened-before edge of t's read is violated under p."""
    obs, edge_ok = observation_tables(c)
    nc = obs.shape[0]
    nw = (nc + 63) // 64
    word = np.arange(nc) // 64
    bit = np.uint64(1) << (np.arange(nc) % 64).astype(np.uint64)

    def pack(bools):
        out = np.zeros(nw, np.uint64)
        np.bitwise_or.at(out, word[bools], bit[bools])
        return out

    ok_v = np.zeros((c, (1 << c) * (c + 1), nw), np.uint64)
    edge_pk = np.zeros((c, 1 << (2 * c), nw), np.uint64)
    for t in range(c):
        for placed in range(1 << c):
            for ret in range(c + 1):
                ok_v[t, placed * (c + 1) + ret] = pack(obs[:, t, placed]
                                                       == ret)
        for hb in range(1 << (2 * c)):
            edge_pk[t, hb] = pack(edge_ok[:, t, hb])
    return ok_v, edge_pk


@lru_cache(maxsize=None)
def serialization_tables(c: int):
    """The flattened form of the same search over ``P = 2^c * NC``
    (inclusion mask x permutation) combos: ``(include [P, c], wbefore
    [P, c, c], later0 [P, c, c], later1 [P, c, c])``, the writers before
    each thread's read latest first (``c`` = none), and whether a peer's
    first or second op sits after it. The port's predicate uses the
    packed tables; this one stays as the reference's cross-check."""
    _, _, pos = perm_tables(c)
    nc = pos.shape[0]
    p_total = (1 << c) * nc
    include = np.zeros((p_total, c), bool)
    wbefore = np.zeros((p_total, c, c), np.int32)
    later0 = np.zeros((p_total, c, c), bool)
    later1 = np.zeros((p_total, c, c), bool)
    for mask in range(1 << c):
        for perm in range(nc):
            i = mask * nc + perm
            for t in range(c):
                include[i, t] = bool((mask >> t) & 1)
                p_read = pos[perm, t, 1]
                writers = sorted(
                    (j for j in range(c) if pos[perm, j, 0] < p_read),
                    key=lambda j: -pos[perm, j, 0])
                for slot in range(c):
                    wbefore[i, t, slot] = (writers[slot]
                                           if slot < len(writers) else c)
                for j in range(c):
                    later0[i, t, j] = pos[perm, j, 0] > p_read
                    later1[i, t, j] = pos[perm, j, 1] > p_read
    return include, wbefore, later0, later1


class _EnvFields:
    """The common fields of a batch of envelopes ``int64[N]``."""

    __slots__ = ("dst", "src", "kind", "req", "value", "extra")

    def __init__(self, env, dm):
        self.dst = env & 7
        self.src = (env >> 3) & 7
        self.kind = (env >> 6) & 15
        self.req = (env >> 10) & 7
        self.value = (env >> 13) & dm.value_mask
        self.extra = env >> dm.extra_shift


class RegisterWorkloadDevice(ActorDeviceModel):
    """The device form of ``server_count`` servers and ``client_count``
    clients. Lanes: each server's ``SERVER_LANES``, each client's phase,
    each client's history triple (status, read's return, happened-before
    edges), the network, the overflow lane."""

    #: lane names of one server's state (subclass)
    SERVER_LANES: tuple = ()
    #: names of the internal message kinds, codes 4, 5, ... (subclass)
    INTERNAL_KINDS: tuple = ()

    max_out = 1
    #: a delivered envelope leaves the network, as in JAX's register
    #: workloads (``duplicating=False``, the reference's ``paxos.rs:213``)
    duplicating = False

    def __init__(self, client_count: int, server_count: int,
                 net_slots: int = 0):
        if not 1 <= client_count <= 4:
            raise DeviceFormUnavailable(
                "the envelope encoding and the enumerated linearizability "
                "interleavings are sized for 1 to 4 clients")
        if server_count > 7 or server_count + client_count > 8:
            raise DeviceFormUnavailable("the actor index field is 3 bits")
        if len(self.INTERNAL_KINDS) > 12:
            raise NotImplementedError("the kind field is 4 bits (12 "
                                      "internal kinds)")
        self.S, self.C = server_count, client_count
        self.value_bits = 2 if client_count <= 3 else 3
        self.value_mask = (1 << self.value_bits) - 1
        self.extra_shift = 13 + self.value_bits
        # The reference's bound: ~5 envelopes in flight a client, and room
        # for a broadcast; an overflow raises, naming the bound.
        self.default_slots = max(5 * client_count + 3,
                                 client_count * (self.max_out + 2))
        self.net_slots = net_slots or self.default_slots
        nsl = len(self.SERVER_LANES)
        self.phase_off = nsl * server_count
        self.hist_off = self.phase_off + client_count
        self.net_offset = self.hist_off + 3 * client_count
        self.state_width = self.net_offset + self.net_slots + 1
        self.error_lane = self.net_offset + self.net_slots
        self._kind_code = {name: 4 + i
                           for i, name in enumerate(self.INTERNAL_KINDS)}
        self._on_device = {}

    # -- Packed-row layout ---------------------------------------------------

    def server_lane_bits(self) -> tuple:
        """Bits of each server lane (subclass hook; 32 by default)."""
        return (32,) * len(self.SERVER_LANES)

    def extra_bits(self) -> int:
        """Width of the envelope's ``extra`` field (subclass hook)."""
        if not self.INTERNAL_KINDS:
            return 0
        return 32 - self.extra_shift

    def lane_bits(self):
        """Server lanes from the hook, 2-bit phases, history triples,
        network slots at the envelope's width plus one bit (the all-ones
        field is ``EMPTY_ENV``), and a 1-bit overflow lane."""
        env_bits = min(self.extra_shift + self.extra_bits(), 32)
        net_spec = 32 if env_bits >= 32 else (env_bits + 1, EMPTY_ENV)
        hist = [3, self.value_bits, 2 * self.C] * self.C
        return (list(self.server_lane_bits()) * self.S + [2] * self.C
                + hist + [net_spec] * self.net_slots + [1])

    # -- Values and request ids -----------------------------------------------

    def value_idx(self, value) -> int:
        return 0 if value == NO_VALUE else ord(value) - ord("A") + 1

    def value_of(self, idx: int):
        return NO_VALUE if idx == 0 else chr(ord("A") + idx - 1)

    def _req_field(self, request_id: int, client_actor: int = None) -> int:
        """The req field of request ``request_id`` (= op * actor) of
        client actor ``client_actor``; without the actor (ABD's internal
        messages carry bare request ids), of the one client whose op
        gives that product."""
        if client_actor is not None:
            op = request_id // client_actor
            if op * client_actor != request_id or op not in (1, 2):
                raise ValueError(
                    f"request id {request_id} not from actor {client_actor}")
            return (op - 1) << 2 | (client_actor - self.S)
        matches = [(op, k) for k in range(self.C) for op in (1, 2)
                   if op * (self.S + k) == request_id]
        if len(matches) != 1:
            raise ValueError(
                f"request id {request_id} is "
                f"{'ambiguous' if matches else 'outside the universe'}; "
                "pass the client actor for context")
        op, k = matches[0]
        return (op - 1) << 2 | k

    def _req_id(self, field: int) -> int:
        return ((field >> 2) + 1) * (self.S + (field & 3))

    # -- Envelope codec -------------------------------------------------------

    def build_env(self, *, dst, src, kind, req=0, value=0, extra=0):
        """Envelopes from their fields (ints or int64 tensors)."""
        return (dst | (src << 3) | (kind << 6) | (req << 10) | (value << 13)
                | (extra << self.extra_shift)) & M32

    def encode_internal(self, inner) -> tuple:
        """An ``Internal`` payload -> ``(kind name, req, value, extra)``
        (subclass, with internal kinds)."""
        raise NotImplementedError

    def decode_internal(self, kind_name: str, req: int, value: int,
                        extra: int):
        raise NotImplementedError

    def env_encode(self, envelope) -> int:
        msg, t = envelope.msg, type(envelope.msg)
        kind = req = value = extra = 0
        if t is Put:
            kind, req = PUT, self._req_field(msg.request_id,
                                             int(envelope.src))
            value = self.value_idx(msg.value)
        elif t is Get:
            kind, req = GET, self._req_field(msg.request_id,
                                             int(envelope.src))
        elif t is PutOk:
            kind, req = PUTOK, self._req_field(msg.request_id,
                                               int(envelope.dst))
        elif t is GetOk:
            kind, req = GETOK, self._req_field(msg.request_id,
                                               int(envelope.dst))
            value = self.value_idx(msg.value)
        elif t is Internal:
            name, req, value, extra = self.encode_internal(msg.msg)
            kind = self._kind_code[name]
        else:
            raise ValueError(f"unsupported message {msg!r}")
        return self.build_env(dst=int(envelope.dst), src=int(envelope.src),
                              kind=kind, req=req, value=value, extra=extra)

    def env_decode(self, code: int):
        dst, src = Id(code & 7), Id((code >> 3) & 7)
        kind, req = (code >> 6) & 15, (code >> 10) & 7
        value = (code >> 13) & self.value_mask
        extra = code >> self.extra_shift
        if kind == PUT:
            msg = Put(self._req_id(req), self.value_of(value))
        elif kind == GET:
            msg = Get(self._req_id(req))
        elif kind == PUTOK:
            msg = PutOk(self._req_id(req))
        elif kind == GETOK:
            msg = GetOk(self._req_id(req), self.value_of(value))
        else:
            name = self.INTERNAL_KINDS[kind - 4]
            msg = Internal(self.decode_internal(name, req, value, extra))
        return Envelope(src, dst, msg)

    # -- Deliveries -----------------------------------------------------------

    def server_deliver(self, lanes, f: _EnvFields):
        """One delivery to each row's ``f.dst`` server, whose lanes are
        ``lanes int64[N, n_lanes]``: ``(new_lanes, handled bool[N], outs
        int64[N, max_out])`` (subclass)."""
        raise NotImplementedError

    def encode_server(self, server_state, vec: np.ndarray,
                      base: int) -> None:
        raise NotImplementedError

    def decode_server(self, vec: np.ndarray, base: int, server_index: int):
        raise NotImplementedError

    def _server_index(self, dst):
        """``dst * n_lanes`` of each row's server, a client clipped to the
        last server (its branch is selected away)."""
        return dst.clamp(0, self.S - 1) * len(self.SERVER_LANES)

    def gather_server(self, body, dst):
        """The lanes of each row's ``dst`` server: ``int64[N, n_lanes]``."""
        nsl = len(self.SERVER_LANES)
        idx = (self._server_index(dst)[:, None]
               + torch.arange(nsl, device=body.device))
        return body.gather(1, idx)

    def scatter_server(self, servers, dst, lanes):
        """``servers int64[N, S * n_lanes]`` with each row's ``dst``
        server's lanes replaced by ``lanes``."""
        n, nsl = servers.shape[0], len(self.SERVER_LANES)
        hot = (torch.arange(self.S, device=dst.device)
               == dst.clamp(0, self.S - 1)[:, None])
        return torch.where(hot[:, :, None], lanes[:, None, :],
                           servers.reshape(n, self.S, nsl)).view(n, -1)

    def deliver(self, body, env):
        """A server delivery touches only its server's lanes; a client
        delivery only the phases and history."""
        f = _EnvFields(env, self)
        is_server = f.dst < self.S
        lanes0 = self.gather_server(body, f.dst)
        srv_lanes, srv_handled, srv_outs = self.server_deliver(lanes0, f)
        cli_phases, cli_hist, cli_handled, cli_outs = \
            self._client_deliver(body, f)
        po, ho, no = self.phase_off, self.hist_off, self.net_offset
        srv = is_server[:, None]
        new_body = torch.cat([
            self.scatter_server(body[:, :po], f.dst,
                                torch.where(srv, srv_lanes, lanes0)),
            torch.where(srv, body[:, po:ho], cli_phases),
            torch.where(srv, body[:, ho:no], cli_hist)], dim=1)
        return (new_body, torch.where(is_server, srv_handled, cli_handled),
                torch.where(srv, srv_outs, cli_outs))

    def _client_deliver(self, body, f: _EnvFields):
        """The Put-then-Get client and its history: PutOk completes the
        write and invokes the read (with happened-before edges over the
        peers' completed ops), GetOk completes the read with its value.
        ``(phases [N, C], hist [N, 3C], handled, outs)``."""
        s, c = self.S, self.C
        n = body.shape[0]
        dev = body.device
        k = (f.dst - s) & M32  # the client (wraps for servers; unused)
        phases = body[:, self.phase_off:self.hist_off]
        hist = body[:, self.hist_off:self.net_offset].reshape(n, c, 3)
        status, rets, hbs = hist[..., 0], hist[..., 1], hist[..., 2]
        phase = phases.gather(1, k.clamp(0, c - 1)[:, None])[:, 0]
        req_matches = ((f.req & 3) == k) & ((f.req >> 2) + 1 == phase)
        putok = (f.kind == PUTOK) & (phase == 1) & req_matches
        getok = (f.kind == GETOK) & (phase == 2) & req_matches

        is_k = torch.arange(c, device=dev) == k[:, None]
        new_phase = torch.where(putok, 2, torch.where(getok, 3, phase))
        new_phases = torch.where(is_k, new_phase[:, None], phases)
        # Happened-before edges at the read's invocation: each peer's
        # completed ops (0, 1 or 2), 2 bits a peer.
        comp = torch.where(status >= 4, 2, torch.where(status >= 2, 1, 0))
        shift = 2 * torch.arange(c, device=dev)
        hb = (torch.where(is_k, 0, comp) << shift).sum(dim=1)
        k_put, k_get = is_k & putok[:, None], is_k & getok[:, None]
        new_hist = torch.stack([
            torch.where(k_put, 3, torch.where(k_get, 4, status)),
            torch.where(k_get, f.value[:, None], rets),
            torch.where(k_put, hb[:, None], hbs)], dim=2).reshape(n, 3 * c)
        # After PutOk the client Gets from server (actor + 1) % S.
        get_out = self.build_env(dst=(f.dst + 1) % s, src=f.dst, kind=GET,
                                 req=4 | k.clamp(0, 3))
        outs = torch.cat([
            torch.where(putok, get_out, EMPTY_ENV)[:, None],
            torch.full((n, self.max_out - 1), EMPTY_ENV, dtype=torch.int64,
                       device=dev)], dim=1)
        return new_phases, new_hist, putok | getok, outs

    # -- Client-permutation symmetry ------------------------------------------
    #
    # A client's destinations follow from its index (Put to index % S, op
    # o to (index + o - 1) % S), so only clients of one residue class mod
    # S are exchangeable: the group is the product of the symmetric groups
    # of the classes, and the representative is the least encoded row
    # over it, every client-derived payload rewritten. At 3 servers it is
    # trivial below 4 clients.

    def client_permutations(self) -> list:
        """The group's non-identity permutations, as ``sigma`` tuples
        (old client index -> new)."""
        classes: dict = {}
        for k in range(self.C):
            classes.setdefault(k % self.S, []).append(k)
        per_class = [[dict(zip(m, p)) for p in permutations(m)]
                     for m in classes.values()]
        sigmas = []
        for combo in product(*per_class):
            sigma = list(range(self.C))
            for mapping in combo:
                for old, new in mapping.items():
                    sigma[old] = new
            if sigma != list(range(self.C)):
                sigmas.append(tuple(sigma))
        return sigmas

    def sym_extra_tables(self, sigma: tuple, t: dict) -> None:
        """Hook: the model's own rewrite tables for ``sigma`` (numpy),
        added to ``t``."""

    def sym_rewrite_servers(self, servers, t: dict):
        """Hook: ``servers int64[N, S, n_lanes]`` under the permutation of
        ``t`` (its tables on the rows' device)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement client-symmetry "
            "server rewriting (sym_rewrite_servers)")

    def sym_rewrite_extra(self, kind, extra, t: dict):
        """Hook: the internal messages' ``extra`` bits under ``t``."""
        if not self.INTERNAL_KINDS:
            return extra
        raise NotImplementedError(
            f"{type(self).__name__} does not implement client-symmetry "
            "extra-bit rewriting (sym_rewrite_extra)")

    def sym_rewrite_internal_req(self, kind, req, t: dict):
        """Hook: the internal messages' ``req`` field under ``t``."""
        if not self.INTERNAL_KINDS:
            return req
        raise NotImplementedError(
            f"{type(self).__name__} does not implement client-symmetry "
            "internal-req rewriting (sym_rewrite_internal_req)")

    def _sym_tables(self) -> list:
        """Each permutation's rewrite tables (numpy), total over each
        field's range so that garbage rows map too."""
        tables = []
        for sigma in self.client_permutations():
            val = np.arange(self.value_mask + 1, dtype=np.int64)
            for k in range(self.C):
                val[1 + k] = 1 + sigma[k]
            req = np.arange(8, dtype=np.int64)
            for r in range(8):
                if (r & 3) < self.C:
                    req[r] = (r & 4) | sigma[r & 3]
            actor = np.arange(8, dtype=np.int64)
            for k in range(self.C):
                actor[self.S + k] = self.S + sigma[k]
            t = {"sigma": sigma, "inv": np.argsort(np.asarray(sigma)),
                 "val": val, "req": req, "actor": actor}
            self.sym_extra_tables(sigma, t)
            tables.append(t)
        return tables

    def _tables(self, device) -> dict:
        """The device functions' constant tables on ``device``, copied
        there by the first call on it."""
        tabs = self._on_device.get(device)
        if tabs is None:
            def dev(a):
                a = np.asarray(a)
                return torch.from_numpy(a.view(np.int64) if a.dtype
                                        == np.uint64 else a.astype(np.int64)
                                        ).to(device)

            ok_v, edge_pk = packed_observation_tables(self.C)
            sym = [dict({k: dev(v) for k, v in t.items() if k != "sigma"},
                        inv_host=t["inv"]) for t in self._sym_tables()]
            tabs = {"ok_v": dev(ok_v), "edge_pk": dev(edge_pk), "sym": sym}
            self._on_device[device] = tabs
        return tabs

    def _sym_rewrite(self, rows, t: dict):
        """``rows int64[N, W]`` under one client permutation (``t``'s
        tables on the rows' device, ``inv_host`` its inverse in numpy)."""
        s, c, e = self.S, self.C, self.net_slots
        n = rows.shape[0]
        servers = rows[:, :self.phase_off].reshape(n, s, -1)
        hist = rows[:, self.hist_off:self.net_offset].reshape(n, c, 3)
        net = rows[:, self.net_offset:self.net_offset + e]
        inv = t["inv"]
        val_map, req_map, actor_map = t["val"], t["req"], t["actor"]
        hist = hist.index_select(1, inv)
        hb_old = hist[..., 2]
        hb_new = torch.zeros_like(hb_old)
        for j in range(c):  # new peer j is old peer inv[j]
            hb_new = hb_new | (((hb_old >> (2 * int(t["inv_host"][j]))) & 3)
                               << (2 * j))
        new_hist = torch.stack(
            [hist[..., 0], val_map[hist[..., 1].clamp(max=self.value_mask)],
             hb_new], dim=2)
        dst, src = net & 7, (net >> 3) & 7
        kind, req = (net >> 6) & 15, (net >> 10) & 7
        value = (net >> 13) & self.value_mask
        new_extra = self.sym_rewrite_extra(kind, net >> self.extra_shift, t)
        new_req = torch.where(kind < 4, req_map[req],
                              self.sym_rewrite_internal_req(kind, req, t))
        new_env = self.build_env(dst=actor_map[dst], src=actor_map[src],
                                 kind=kind, req=new_req,
                                 value=val_map[value], extra=new_extra)
        new_net = torch.sort(torch.where(net == EMPTY_ENV, net, new_env),
                             dim=1).values
        return torch.cat([
            self.sym_rewrite_servers(servers, t).reshape(n, -1),
            rows[:, self.phase_off:self.hist_off].index_select(1, inv),
            new_hist.reshape(n, 3 * c), new_net,
            rows[:, self.net_offset + e:]], dim=1)

    def representative(self, rows):
        """The least encoded row of each row's class under the client
        permutations (the row itself when the group is trivial), or
        ``None`` when the model lacks the rewrite hooks."""
        best = rows
        try:
            for t in self._tables(rows.device)["sym"]:
                cand = self._sym_rewrite(rows, t)
                diff = best != cand
                first = diff.to(torch.int32).argmax(dim=1, keepdim=True)
                best_le = (~diff.any(dim=1)
                           | (best.gather(1, first)
                              < cand.gather(1, first))[:, 0])
                best = torch.where(best_le[:, None], best, cand)
        except NotImplementedError:
            return None
        return best

    def host_representative(self, state):
        """The host canonicaliser for ``CheckerBuilder.symmetry_fn``: the
        partition of ``representative``, through the encoding (encode,
        the least row over the client permutations on the CPU, decode),
        as JAX's ``host_representative`` makes it."""
        rows = torch.from_numpy(self.encode(state).astype(np.int64))[None]
        best = self.representative(rows)
        if best is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no client-symmetry rewrite")
        return self.decode(best[0].numpy().astype(np.uint32))

    # -- Host state codec ----------------------------------------------------

    def encode(self, state) -> np.ndarray:
        s, c = self.S, self.C
        nsl = len(self.SERVER_LANES)
        vec = np.zeros(self.state_width, np.uint32)
        for i in range(s):
            self.encode_server(state.actor_states[i].state, vec, nsl * i)
        for k in range(c):
            cs = state.actor_states[s + k]
            vec[self.phase_off + k] = (3 if cs.awaiting is None
                                       else cs.op_count)
        self._encode_history(state.history, vec)
        vec[self.net_offset:] = self.encode_network(state.network)
        return vec

    def decode(self, vec: np.ndarray) -> ActorModelState:
        s, c = self.S, self.C
        nsl = len(self.SERVER_LANES)
        actor_states = [RegisterServerState(self.decode_server(
            vec, nsl * i, i)) for i in range(s)]
        for k in range(c):
            phase = int(vec[self.phase_off + k])
            actor_states.append(
                RegisterClientState(awaiting=None, op_count=3) if phase == 3
                else RegisterClientState(awaiting=phase * (s + k),
                                         op_count=phase))
        return ActorModelState(
            actor_states=actor_states,
            network=Network(self.decode_network(vec[self.net_offset:])),
            is_timer_set=[], history=self._decode_history(vec))

    def _encode_history(self, tester, vec: np.ndarray) -> None:
        """Each client's (status, read's return, edges): status 0 idle, 1
        write in flight, 2 write done, 3 read in flight, 4 read done."""
        s = self.S
        if not tester.is_valid_history:
            raise ValueError("register workloads cannot produce invalid "
                             "histories")
        for k in range(self.C):
            tid = Id(s + k)
            completed = tester.history_by_thread.get(tid, ())
            inflight = tester.in_flight_by_thread.get(tid)
            busy = inflight is not None
            status = (1 if busy else 0, 3 if busy else 2, 4)[
                min(len(completed), 2)]
            ret = (self.value_idx(completed[1][2].value)
                   if len(completed) == 2 else 0)
            read_cs = (inflight[0] if status == 3
                       else completed[1][0] if status == 4 else ())
            hb = 0
            for peer_tid, last_idx in read_cs:
                hb |= (last_idx + 1) << (2 * (int(peer_tid) - s))
            base = self.hist_off + 3 * k
            vec[base:base + 3] = (status, ret, hb)

    def _decode_history(self, vec: np.ndarray) -> LinearizabilityTester:
        s, c = self.S, self.C
        tester = LinearizabilityTester(Register(NO_VALUE))
        for k in range(c):
            base = self.hist_off + 3 * k
            status = int(vec[base])
            if status == 0:
                continue
            tid = Id(s + k)
            hb = int(vec[base + 2])
            read_cs = tuple(sorted(
                (Id(s + j), ((hb >> (2 * j)) & 3) - 1)
                for j in range(c) if (hb >> (2 * j)) & 3))
            write = Write(self.value_of(k + 1))
            write_entry = ((), write, WriteOk())
            tester.history_by_thread[tid] = ()
            if status == 1:
                tester.in_flight_by_thread[tid] = ((), write)
            else:
                tester.history_by_thread[tid] = (write_entry,)
            if status == 3:
                tester.in_flight_by_thread[tid] = (read_cs, Read())
            elif status == 4:
                ret = ReadOk(self.value_of(int(vec[base + 1])))
                tester.history_by_thread[tid] = (
                    write_entry, (read_cs, Read(), ret))
        return tester

    # -- Properties ----------------------------------------------------------

    def _serializable(self, rows, real_time_edges: bool):
        """Whether some (inclusion mask, permutation) combo serializes
        each row's history: the reference's backtracking search as a
        reduction. A row touches a combo only through each thread's
        placed-writer set, read return and edges, so each constraint is a
        gather of a ``[n_words]`` row of the packed tables ANDed into the
        accumulator; the mask axis is a tensor dimension. Without the
        edge constraint it is sequential consistency."""
        c = self.C
        n = rows.shape[0]
        tabs = self._tables(rows.device)
        ok_v, edge_pk = tabs["ok_v"], tabs["edge_pk"]
        hist = rows[:, self.hist_off:self.net_offset].reshape(n, c, 3)
        status, rets, hbs = hist[..., 0], hist[..., 1], hist[..., 2]
        bit = 1 << torch.arange(c, device=rows.device)
        completed_w = torch.where(status >= 2, bit, 0).sum(dim=1)
        inflight_w = torch.where(status == 1, bit, 0).sum(dim=1)
        masks = torch.arange(1 << c, device=rows.device)
        placed = completed_w[:, None] | (inflight_w[:, None] & masks)
        acc = torch.full((n, 1 << c, ok_v.shape[-1]), -1, dtype=torch.int64,
                         device=rows.device)
        for t in range(c):
            r_completed = status[:, t] == 4
            row_v = ok_v[t][(placed * (c + 1) + rets[:, t:t + 1]).clamp(
                0, ok_v.shape[1] - 1)]
            acc = acc & torch.where(r_completed[:, None, None], row_v, -1)
            if real_time_edges:
                read_placed = r_completed[:, None] | (
                    (status[:, t] == 3)[:, None] & (((masks >> t) & 1) == 1))
                row_e = edge_pk[t][hbs[:, t].clamp(0, edge_pk.shape[1] - 1)]
                acc = acc & torch.where(read_placed[:, :, None],
                                        row_e[:, None, :], -1)
        return (acc != 0).flatten(1).any(dim=1)

    def device_properties(self):
        e, off, vm = self.net_slots, self.net_offset, self.value_mask

        def value_chosen(rows):
            net = rows[:, off:off + e]
            return ((net != EMPTY_ENV) & (((net >> 6) & 15) == GETOK)
                    & (((net >> 13) & vm) != 0)).any(dim=1)

        return {
            "linearizable": lambda rows: self._serializable(rows, True),
            "sequentially consistent":
                lambda rows: self._serializable(rows, False),
            "value chosen": value_chosen,
            # The same predicate under an EVENTUALLY expectation.
            "eventually chosen": value_chosen,
        }
