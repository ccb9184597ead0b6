"""The ABD quorum register: the host model and its device form.

The port's copy of ``examples/linearizable_register.py`` (the internal
messages, the server's phases and state, the server ``AbdActor`` and the
model, ``AbdModelCfg.into_model()``) and of
``stateright_tpu/tpu/models/abd.py`` (the device encoding), after the
reference's ``examples/linearizable-register.rs`` (Attiya, Bar-Noy,
Dolev: "Sharing Memory Robustly in Message-Passing Systems"). Reads and
writes both run a query phase (collect (seq, value) from a quorum), then
a record phase (install the chosen pair at a quorum). Checked for
"linearizable" (always) and "value chosen" (sometimes). Gate: 544 unique
/ 875 states at 2 clients / 2 servers.

The device form is the register workload's (``register_workload.py``).
Sequencers ``(clock, server id)`` are encoded as ``clock * S + id``, so
that integer order is the host's tuple order and the quorum's max is an
integer max; the clock is bounded by the writes (at most C). A server's
lanes: ``seq``, ``val``, and its phase: ``ph_kind`` (0 none, 1 query, 2
record), ``ph_req`` (the request's req field), ``ph_write`` (0 = a read,
else the value index), ``ph_read`` (0 = a write, else 1 + the value
index), ``ph_acks`` (a server bitmask) and one response lane a server (0
= none, else ``1 + seq * (C + 1) + value``). Lanes the phase does not use
are 0, so the encoding is injective. Internal messages carry a bare
request id, so a configuration where two clients' ops give the same
product (3 clients on 2 servers, for one) has no device form. The
client-permutation group is trivial on every configuration that has one,
so the representative is the row itself. Its CUDA device code
(``cuda_model()``) is ``csrc/models/abd.cuh`` on
``csrc/models/register_workload.cuh``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from ..actor import (NO_VALUE, Actor, ActorModel, Get, GetOk, Id, Internal,
                     Out, Put, PutOk, majority, model_peers)
from ..actor_device import EMPTY_ENV, M32, compact_envs
from ..device_model import DeviceFormUnavailable
from ..register_workload import (GET, GETOK, PUT, PUTOK,
                                 RegisterWorkloadDevice, cuda_instance,
                                 register_model)

__all__ = ["Query", "AckQuery", "Record", "AckRecord", "Phase1", "Phase2",
           "AbdState", "AbdActor", "AbdSys", "AbdDevice"]

# Internal kind codes follow the public four.
QUERY, ACKQUERY, RECORD, ACKRECORD = 4, 5, 6, 7


@dataclass(frozen=True)
class Query:
    request_id: int

    def __repr__(self):
        return f"Query({self.request_id})"


@dataclass(frozen=True)
class AckQuery:
    request_id: int
    seq: Tuple
    value: str

    def __repr__(self):
        return f"AckQuery({self.request_id}, {self.seq!r}, {self.value!r})"


@dataclass(frozen=True)
class Record:
    request_id: int
    seq: Tuple
    value: str

    def __repr__(self):
        return f"Record({self.request_id}, {self.seq!r}, {self.value!r})"


@dataclass(frozen=True)
class AckRecord:
    request_id: int

    def __repr__(self):
        return f"AckRecord({self.request_id})"


@dataclass(frozen=True)
class Phase1:
    request_id: int
    requester_id: Id
    write: Optional[str]
    responses: Tuple  # sorted tuple of (server id, (seq, value))

    def __repr__(self):
        return (f"Phase1 {{ request_id: {self.request_id}, "
                f"requester_id: {self.requester_id!r}, "
                f"write: {self.write!r}, responses: {self.responses!r} }}")


@dataclass(frozen=True)
class Phase2:
    request_id: int
    requester_id: Id
    read: Optional[str]
    acks: Tuple  # sorted tuple of server ids

    def __repr__(self):
        return (f"Phase2 {{ request_id: {self.request_id}, "
                f"requester_id: {self.requester_id!r}, "
                f"read: {self.read!r}, acks: {self.acks!r} }}")


@dataclass(frozen=True)
class AbdState:
    seq: Tuple
    val: str
    phase: Optional[object]


class AbdActor(Actor):
    """An ABD server (the reference's ``linearizable-register.rs:56-186``):
    a Put or a Get starts a query phase at a quorum, then a record phase
    of the chosen (seq, value), then the reply."""

    def __init__(self, peers):
        self.peers = list(peers)

    def on_start(self, id: Id, o: Out) -> AbdState:
        return AbdState(seq=(0, id), val=NO_VALUE, phase=None)

    def on_msg(self, id: Id, state: AbdState, src: Id, msg, o: Out):
        if type(msg) in (Put, Get) and state.phase is None:
            o.broadcast(self.peers, Internal(Query(msg.request_id)))
            return replace(state, phase=Phase1(
                request_id=msg.request_id, requester_id=src,
                write=msg.value if type(msg) is Put else None,
                responses=((id, (state.seq, state.val)),)))
        if type(msg) is not Internal:
            return None
        inner = msg.msg

        if type(inner) is Query:
            o.send(src, Internal(
                AckQuery(inner.request_id, state.seq, state.val)))
            return None

        if (type(inner) is AckQuery and type(state.phase) is Phase1
                and state.phase.request_id == inner.request_id):
            phase = state.phase
            responses = dict(phase.responses)
            responses[src] = (inner.seq, inner.value)
            responses = tuple(sorted(responses.items()))
            if len(responses) == majority(len(self.peers) + 1):
                # A quorum: the record phase, with the latest pair
                # (sequencers are distinct, linearizable-register.rs:111-116).
                _, (seq, val) = max(responses, key=lambda kv: kv[1][0])
                read = None
                if phase.write is not None:
                    seq, val = (seq[0] + 1, id), phase.write
                else:
                    read = val
                o.broadcast(self.peers,
                            Internal(Record(phase.request_id, seq, val)))
                # Its own Record and AckRecord, as if sent to itself.
                new_seq, new_val = state.seq, state.val
                if seq > state.seq:
                    new_seq, new_val = seq, val
                return replace(state, seq=new_seq, val=new_val,
                               phase=Phase2(request_id=phase.request_id,
                                            requester_id=phase.requester_id,
                                            read=read, acks=(id,)))
            return replace(state, phase=replace(phase, responses=responses))

        if type(inner) is Record:
            o.send(src, Internal(AckRecord(inner.request_id)))
            if inner.seq > state.seq:
                return replace(state, seq=inner.seq, val=inner.value)
            return None

        if (type(inner) is AckRecord and type(state.phase) is Phase2
                and state.phase.request_id == inner.request_id
                and src not in state.phase.acks):
            phase = state.phase
            acks = tuple(sorted(set(phase.acks) | {src}))
            if len(acks) == majority(len(self.peers) + 1):
                if phase.read is not None:
                    o.send(phase.requester_id,
                           GetOk(phase.request_id, phase.read))
                else:
                    o.send(phase.requester_id, PutOk(phase.request_id))
                return replace(state, phase=None)
            return replace(state, phase=replace(phase, acks=acks))
        return None


class AbdSys(ActorModel):
    """``client_count`` Put-then-Get clients of ``server_count`` ABD
    servers: ``AbdModelCfg(client_count, server_count).into_model()``.
    The device form has no configuration whose request ids collide (more
    clients than servers); ``spawn_cuda_bfs`` checks one on the host BFS,
    with a warning."""

    #: the JAX package's model is an ``ActorModel``: the same name lets
    #: each package resume the other's checkpoints
    checkpoint_name = "ActorModel"

    def __init__(self, client_count: int, server_count: int = 2):
        super().__init__(cfg=self)
        self.client_count = client_count
        self.server_count = server_count
        register_model(self, [AbdActor(model_peers(i, server_count))
                              for i in range(server_count)], client_count)

    def device_model(self) -> "AbdDevice":
        return AbdDevice(self.client_count, self.server_count)


class AbdDevice(RegisterWorkloadDevice):
    INTERNAL_KINDS = ("Query", "AckQuery", "Record", "AckRecord")

    def __init__(self, client_count: int, server_count: int = 2,
                 net_slots: int = 0):
        # Internal messages carry bare request ids (op * actor), so the
        # req field can only be recovered when every product op * (S + k),
        # op in {1, 2}, k < C, is unique: 3 clients on 2 servers collide
        # (1 * (2 + 2) == 2 * (2 + 0)).
        ids: dict = {}
        for k in range(client_count):
            for op in (1, 2):
                ids.setdefault(op * (server_count + k), []).append(k)
        if any(len(v) > 1 for v in ids.values()):
            raise DeviceFormUnavailable(
                f"ABD request ids collide at {client_count} clients / "
                f"{server_count} servers (op * actor products are not "
                "unique), and internal messages carry no requester to "
                "disambiguate")
        self.SERVER_LANES = (
            "seq", "val", "ph_kind", "ph_req", "ph_write", "ph_read",
            "ph_acks") + tuple(f"ph_resp{j}" for j in range(server_count))
        self.max_out = max(server_count - 1, 1)
        super().__init__(client_count, server_count, net_slots=net_slots)

    #: (clients, servers) that ``csrc/wave_abd.cu`` holds: every pair of 1
    #: to 4 clients and 1 to 7 servers of at most 8 actors whose request
    #: ids do not collide, clients <= servers (16; ``sr::with_abd`` names
    #: the instance of each)
    CUDA_INSTANCES = tuple((c, s) for c in range(1, 5) for s in range(1, 8)
                           if c <= s and c + s <= 8)

    def cuda_model(self):
        """``csrc/models/abd.cuh`` at this client and server count and
        ``net_slots`` (the entry point refuses more slots than the
        default's). Raises for counts it holds no instance of."""
        cuda_instance("abd", self, self.CUDA_INSTANCES)
        return "abd", (self.C, self.S, self.net_slots)

    # -- Packed-row layout ---------------------------------------------------

    def _seq_max(self) -> int:
        # seq = clock * S + id, clock <= C (a Put a client), id < S.
        return self.C * self.S + self.S - 1

    def server_lane_bits(self) -> tuple:
        def bits(n):
            return max(1, int(n).bit_length())

        resp_max = 1 + self._seq_max() * (self.C + 1) + self.C
        return ((bits(self._seq_max()), bits(self.C), 2, 3, bits(self.C),
                 bits(self.C + 1), self.S) + (bits(resp_max),) * self.S)

    def extra_bits(self) -> int:
        # AckQuery and Record carry a bare sequencer in extra.
        return max(1, self._seq_max().bit_length())

    # -- Sequencer and response encodings ------------------------------------

    def _seq_idx(self, seq) -> int:
        clock, sid = seq
        return clock * self.S + int(sid)

    def _seq_tuple(self, idx: int):
        return (idx // self.S, Id(idx % self.S))

    def _resp_enc(self, seq, value) -> int:
        return 1 + self._seq_idx(seq) * (self.C + 1) + self.value_idx(value)

    def _resp_dec(self, code: int):
        code -= 1
        return (self._seq_tuple(code // (self.C + 1)),
                self.value_of(code % (self.C + 1)))

    # -- Internal-message codec ----------------------------------------------

    def encode_internal(self, inner) -> tuple:
        t, req = type(inner), self._req_field(inner.request_id)
        if t is Query:
            return "Query", req, 0, 0
        if t is AckQuery:
            return ("AckQuery", req, self.value_idx(inner.value),
                    self._seq_idx(inner.seq))
        if t is Record:
            return ("Record", req, self.value_idx(inner.value),
                    self._seq_idx(inner.seq))
        if t is AckRecord:
            return "AckRecord", req, 0, 0
        raise ValueError(f"unsupported internal message {inner!r}")

    def decode_internal(self, kind_name: str, req: int, value: int,
                        extra: int):
        req_id = self._req_id(req)
        if kind_name == "Query":
            return Query(req_id)
        if kind_name == "AckQuery":
            return AckQuery(req_id, self._seq_tuple(extra),
                            self.value_of(value))
        if kind_name == "Record":
            return Record(req_id, self._seq_tuple(extra),
                          self.value_of(value))
        return AckRecord(req_id)

    # -- Server delivery (linearizable-register.rs:68-186) -------------------

    def server_deliver(self, lanes, f):
        """``AbdActor.on_msg`` at each row's ``f.dst`` server. Every branch
        computes, and each lane selects its value: the message kinds
        exclude each other. Arithmetic that can wrap is masked to
        uint32."""
        s, c = self.S, self.C
        seq, val, ph_kind, ph_req, ph_write, ph_read, ph_acks = (
            lanes[:, i] for i in range(7))
        resp = [lanes[:, 7 + j] for j in range(s)]
        maj = s // 2 + 1

        def sel(cond, x, y):
            return torch.where(cond, x, y)

        # Put or Get with no phase in flight: the query phase, with the
        # server's own (seq, val) as its first response.
        start_case = ((f.kind == PUT) | (f.kind == GET)) & (ph_kind == 0)
        self_resp = (1 + seq * (c + 1) + val) & M32
        start_lanes = torch.stack(
            [seq, val, torch.ones_like(seq), f.req,
             sel(f.kind == PUT, f.value, 0), torch.zeros_like(seq),
             torch.zeros_like(seq)]
            + [sel(f.dst == j, self_resp, 0) for j in range(s)], dim=1)

        # Query: reply with (seq, val).
        query_case = f.kind == QUERY
        ackquery_out = self.build_env(dst=f.src, src=f.dst, kind=ACKQUERY,
                                      req=f.req, value=val, extra=seq)

        # AckQuery in our query phase of the same request.
        ackq_case = (f.kind == ACKQUERY) & (ph_kind == 1) & (ph_req == f.req)
        m_resp = (1 + f.extra * (c + 1) + f.value) & M32
        resp2 = [sel(f.src == j, m_resp, resp[j]) for j in range(s)]
        quorum_q = sum((r != 0).to(torch.int64) for r in resp2) == maj
        best = resp2[0]
        for r in resp2[1:]:
            best = torch.maximum(best, r)
        best = (best - 1) & M32  # distinct seqs: the max code's seq is max
        best_seq, best_val = best // (c + 1), best % (c + 1)
        is_write = ph_write != 0
        new_seq = sel(is_write, ((best_seq // s + 1) * s + f.dst) & M32,
                      best_seq)
        new_val = sel(is_write, ph_write, best_val)
        adopt = quorum_q & (new_seq > seq)  # the self-sent Record
        ackq_lanes = torch.stack(
            [sel(adopt, new_seq, seq), sel(adopt, new_val, val),
             sel(quorum_q, 2, 1), ph_req, sel(quorum_q, 0, ph_write),
             sel(quorum_q & ~is_write, 1 + best_val, 0),
             sel(quorum_q, 1 << f.dst, 0)]
            + [sel(quorum_q, 0, r) for r in resp2], dim=1)

        # Record: ack, and adopt the pair if newer.
        record_case = f.kind == RECORD
        rec_adopt = f.extra > seq
        record_lanes = torch.cat([
            torch.stack([sel(rec_adopt, f.extra, seq),
                         sel(rec_adopt, f.value, val)], dim=1),
            lanes[:, 2:]], dim=1)
        ackrecord_out = self.build_env(dst=f.src, src=f.dst, kind=ACKRECORD,
                                       req=f.req)

        # AckRecord in our record phase of the same request, from a new
        # acker: on a quorum, the reply to the requester.
        ackr_case = ((f.kind == ACKRECORD) & (ph_kind == 2)
                     & (ph_req == f.req) & (((ph_acks >> f.src) & 1) == 0))
        acks2 = ph_acks | (1 << f.src)
        quorum_r = sum((acks2 >> j) & 1 for j in range(s)) == maj
        ackr_lanes = torch.cat([
            lanes[:, :2],
            torch.stack([sel(quorum_r, 0, 2), sel(quorum_r, 0, ph_req),
                         ph_write, sel(quorum_r, 0, ph_read),
                         sel(quorum_r, 0, acks2)], dim=1),
            lanes[:, 7:]], dim=1)
        requester = s + (ph_req & 3)
        reply_out = sel(
            ph_read != 0,
            self.build_env(dst=requester, src=f.dst, kind=GETOK, req=ph_req,
                           value=(ph_read - 1) & M32),
            self.build_env(dst=requester, src=f.dst, kind=PUTOK, req=ph_req))

        handled = (start_case | query_case | ackq_case | record_case
                   | ackr_case)
        new_lanes = lanes
        for case, case_lanes in ((start_case, start_lanes),
                                 (ackq_case, ackq_lanes),
                                 (record_case, record_lanes),
                                 (ackr_case, ackr_lanes)):
            new_lanes = sel(case[:, None], case_lanes, new_lanes)

        # Broadcasts, to the S - 1 peers (the self slot is empty): Query on
        # the start, Record on the query quorum, compacted into max_out
        # slots.
        bcast = torch.stack([
            sel(f.dst == p, EMPTY_ENV, sel(
                start_case,
                self.build_env(dst=p, src=f.dst, kind=QUERY, req=f.req),
                sel(ackq_case & quorum_q,
                    self.build_env(dst=p, src=f.dst, kind=RECORD, req=ph_req,
                                   value=new_val, extra=new_seq),
                    EMPTY_ENV)))
            for p in range(s)], dim=1)
        outs = compact_envs(bcast, self.max_out)
        # The reply slot (never live together with a broadcast).
        reply = sel(query_case, ackquery_out,
                    sel(record_case, ackrecord_out,
                        sel(ackr_case & quorum_r, reply_out, EMPTY_ENV)))
        outs[:, 0] = sel(reply != EMPTY_ENV, reply, outs[:, 0])
        return new_lanes, handled, outs

    # -- Host codec ----------------------------------------------------------

    def encode_server(self, ss, vec: np.ndarray, base: int) -> None:
        vec[base] = self._seq_idx(ss.seq)
        vec[base + 1] = self.value_idx(ss.val)
        ph = ss.phase
        if ph is None:
            return
        req = self._req_field(ph.request_id)
        vec[base + 3] = req
        assert int(ph.requester_id) == self.S + (req & 3), \
            "requester outside the universe"
        if type(ph) is Phase1:
            vec[base + 2] = 1
            vec[base + 4] = (0 if ph.write is None
                             else self.value_idx(ph.write))
            for sid, (seq, value) in ph.responses:
                vec[base + 7 + int(sid)] = self._resp_enc(seq, value)
        else:
            vec[base + 2] = 2
            vec[base + 5] = (0 if ph.read is None
                             else 1 + self.value_idx(ph.read))
            vec[base + 6] = sum(1 << int(a) for a in ph.acks)

    def decode_server(self, vec: np.ndarray, base: int, server_index: int):
        seq = self._seq_tuple(int(vec[base]))
        val = self.value_of(int(vec[base + 1]))
        kind = int(vec[base + 2])
        if kind == 0:
            return AbdState(seq=seq, val=val, phase=None)
        req = int(vec[base + 3])
        req_id, requester = self._req_id(req), Id(self.S + (req & 3))
        if kind == 1:
            write = int(vec[base + 4])
            phase = Phase1(
                request_id=req_id, requester_id=requester,
                write=None if write == 0 else self.value_of(write),
                responses=tuple(sorted(
                    (Id(j), self._resp_dec(int(vec[base + 7 + j])))
                    for j in range(self.S) if vec[base + 7 + j])))
        else:
            read = int(vec[base + 5])
            phase = Phase2(
                request_id=req_id, requester_id=requester,
                read=None if read == 0 else self.value_of(read - 1),
                acks=tuple(Id(j) for j in range(self.S)
                           if (int(vec[base + 6]) >> j) & 1))
        return AbdState(seq=seq, val=val, phase=phase)
