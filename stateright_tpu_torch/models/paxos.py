"""Single-decree Paxos under linearizability checking: the host model and
its device form.

The port's copy of ``examples/paxos.py`` (the message and server state
types, the init state, the properties) and of
``stateright_tpu/tpu/models/paxos.py`` (the device encoding), after the
reference's ``examples/paxos.rs``: 3 Paxos servers and ``client_count``
clients that each Put one value and then Get, with a linearizability
tester riding along as history, checked for "linearizable" (always) and
"value chosen" (sometimes), and with ``liveness`` also "eventually
chosen". Gates: 265 / 482 states at 1 client, 16,668 unique at 2, and
1,194,428 unique / 2,420,477 at 3.

The device form implements the register workload's server over bounded
universes:

- **values**: 0 = NO_VALUE, ``1 + k`` = client k's value;
- **ballots** ``(round, leader)`` with round <= client_count: index
  ``1 + (round - 1) * S + leader`` (0 = ``(0, Id(0))``);
- **proposals**: client k's ``(request id, requester, value)``: ``1 + k``;
- **accepted pairs** ``(ballot, proposal)``: ``1 + (b - 1) * C + (p - 1)``,
  whose order is the host's ``_accepted_key`` order, so the quorum's
  latest accepted pair is an integer max.

Internal messages carry ``ballot[0:4] | proposal[4:] | last accepted``
in the envelope's ``extra`` bits. A server's lanes: ballot, proposal,
prepares[3] (0 = none, else 1 + la), the accepts mask, the accepted la
index, decided. Its CUDA device code (``cuda_model()``) is
``csrc/models/paxos.cuh``, which the single-kernel wave and the sender
kernel run on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..actor import Id
from ..actor_device import EMPTY_ENV, M32
from ..device_model import DeviceFormUnavailable
from ..model import Model, Property
from ..register_workload import (GET, GETOK, PUT, PUTOK,
                                 RegisterWorkloadDevice, register_init_state)

__all__ = ["Prepare", "Prepared", "Accept", "Accepted", "Decided",
           "PaxosState", "PaxosSys", "PaxosDevice"]

# Internal kind codes follow the public four.
PREPARE, PREPARED, ACCEPT, ACCEPTED, DECIDED = range(4, 9)


@dataclass(frozen=True)
class Prepare:
    ballot: Tuple

    def __repr__(self):
        return f"Prepare {{ ballot: {self.ballot!r} }}"


@dataclass(frozen=True)
class Prepared:
    ballot: Tuple
    last_accepted: Optional[Tuple]

    def __repr__(self):
        return (f"Prepared {{ ballot: {self.ballot!r}, "
                f"last_accepted: {self.last_accepted!r} }}")


@dataclass(frozen=True)
class Accept:
    ballot: Tuple
    proposal: Tuple

    def __repr__(self):
        return (f"Accept {{ ballot: {self.ballot!r}, "
                f"proposal: {self.proposal!r} }}")


@dataclass(frozen=True)
class Accepted:
    ballot: Tuple

    def __repr__(self):
        return f"Accepted {{ ballot: {self.ballot!r} }}"


@dataclass(frozen=True)
class Decided:
    ballot: Tuple
    proposal: Tuple

    def __repr__(self):
        return (f"Decided {{ ballot: {self.ballot!r}, "
                f"proposal: {self.proposal!r} }}")


@dataclass(frozen=True)
class PaxosState:
    """A server: ballot = (round, leader), proposal = (request id,
    requester, value), prepares a sorted tuple of (acceptor, last
    accepted), accepts a sorted tuple of acceptors."""

    ballot: Tuple
    proposal: Optional[Tuple]
    prepares: Tuple
    accepts: Tuple
    accepted: Optional[Tuple]
    is_decided: bool


class PaxosSys(Model):
    """``server_count`` Paxos servers (the device form takes 3) and
    ``client_count`` (1 to 4) Put-then-Get clients."""

    #: the model name checkpoints record: the JAX package's paxos is
    #: ``examples/paxos.py``'s ``PaxosModelCfg.into_model()``, an
    #: ``ActorModel``, so the same name lets its files resume here and
    #: the port's resume there
    checkpoint_name = "ActorModel"

    def __init__(self, client_count: int, server_count: int = 3,
                 liveness: bool = False):
        if server_count != 3:
            raise DeviceFormUnavailable(
                "the device encoding is sized for 3 servers (the "
                "reference example's count); the port has no host engine "
                "for others")
        self.client_count = client_count
        self.server_count = server_count
        self.liveness = liveness

    def device_model(self) -> "PaxosDevice":
        return PaxosDevice(self.client_count, self.server_count)

    def init_states(self):
        """Every server fresh; each client has sent its Put to server
        ``index % S``, and the history holds the Put's write in flight."""
        return [register_init_state([PaxosState(
            ballot=(0, Id(0)), proposal=None, prepares=(), accepts=(),
            accepted=None, is_decided=False)] * self.server_count,
            self.client_count)]

    def properties(self):
        props = [Property.always("linearizable"),
                 Property.sometimes("value chosen")]
        if self.liveness:
            props.append(Property.eventually("eventually chosen"))
        return props


class PaxosDevice(RegisterWorkloadDevice):
    SERVER_LANES = ("ballot", "proposal", "prep0", "prep1", "prep2",
                    "accepts", "accepted", "decided")
    INTERNAL_KINDS = ("Prepare", "Prepared", "Accept", "Accepted",
                      "Decided")
    max_out = 3  # an Accepted quorum: two Decided broadcasts and a PutOk

    def __init__(self, client_count: int, server_count: int = 3,
                 net_slots: int = 0):
        if server_count != 3:
            raise DeviceFormUnavailable(
                "the device encoding is sized for 3 servers")
        super().__init__(client_count, server_count, net_slots=net_slots)
        # extra = ballot[0:4] | proposal | last accepted; the proposal
        # field widens with the value field at 4 clients.
        self.prop_bits = 2 if client_count <= 3 else 3
        self.prop_mask = (1 << self.prop_bits) - 1
        self.la_shift = 4 + self.prop_bits

    def cuda_model(self):
        """``csrc/models/paxos.cuh`` at this client count and
        ``net_slots`` (the entry point refuses more slots than the
        default's)."""
        return "paxos", (self.C, self.net_slots)

    # -- Packed-row layout -------------------------------------------------

    def _la_max(self) -> int:
        """The largest accepted-pair index: ballot <= C * S, proposal <=
        C."""
        return 1 + (self.C * self.S - 1) * self.C + (self.C - 1)

    def server_lane_bits(self) -> tuple:
        prep_bits = (1 + self._la_max()).bit_length()
        return ((self.C * self.S).bit_length(), self.C.bit_length(),
                prep_bits, prep_bits, prep_bits, self.S,
                self._la_max().bit_length(), 1)

    def extra_bits(self) -> int:
        return self.la_shift + self._la_max().bit_length()

    # -- Universe indices ----------------------------------------------------

    def _ballot_tuple(self, idx: int):
        if idx == 0:
            return (0, Id(0))
        return ((idx - 1) // self.S + 1, Id((idx - 1) % self.S))

    def _ballot_idx(self, ballot) -> int:
        r, leader = ballot
        return 0 if r == 0 else 1 + (r - 1) * self.S + int(leader)

    def _proposal_tuple(self, idx: int):
        if idx == 0:
            return None
        i = self.S + idx - 1  # the requester
        return (i, Id(i), self.value_of(idx))

    def _proposal_idx(self, proposal) -> int:
        return 0 if proposal is None else int(proposal[1]) - self.S + 1

    def _la_idx(self, accepted) -> int:
        if accepted is None:
            return 0
        ballot, proposal = accepted
        return (1 + (self._ballot_idx(ballot) - 1) * self.C
                + self._proposal_idx(proposal) - 1)

    def _la_tuple(self, idx: int):
        if idx == 0:
            return None
        return (self._ballot_tuple((idx - 1) // self.C + 1),
                self._proposal_tuple((idx - 1) % self.C + 1))

    # -- Internal-message codec ----------------------------------------------

    def encode_internal(self, inner) -> tuple:
        t, ballot = type(inner), self._ballot_idx(inner.ballot)
        if t is Prepare:
            return "Prepare", 0, 0, ballot
        if t is Prepared:
            return ("Prepared", 0, 0, ballot | self._la_idx(
                inner.last_accepted) << self.la_shift)
        if t is Accept:
            return ("Accept", 0, 0,
                    ballot | self._proposal_idx(inner.proposal) << 4)
        if t is Accepted:
            return "Accepted", 0, 0, ballot
        return ("Decided", 0, 0,
                ballot | self._proposal_idx(inner.proposal) << 4)

    def decode_internal(self, kind_name: str, req: int, value: int,
                        extra: int):
        ballot = self._ballot_tuple(extra & 15)
        prop = self._proposal_tuple((extra >> 4) & self.prop_mask)
        if kind_name == "Prepare":
            return Prepare(ballot)
        if kind_name == "Prepared":
            return Prepared(ballot, self._la_tuple(extra >> self.la_shift))
        if kind_name == "Accept":
            return Accept(ballot, prop)
        if kind_name == "Accepted":
            return Accepted(ballot)
        return Decided(ballot, prop)

    # -- Client symmetry -----------------------------------------------------
    #
    # A client permutation rewrites the proposal indices and the accepted
    # pairs that embed them; ballots are the servers' own. On reachable
    # states a ballot has one proposal, so the quorum max stays sound.

    def sym_extra_tables(self, sigma: tuple, t: dict) -> None:
        c = self.C
        la = np.arange(self._la_max() + 1, dtype=np.int64)
        for i in range(1, len(la)):
            b, p = (i - 1) // c + 1, (i - 1) % c + 1
            la[i] = 1 + (b - 1) * c + sigma[p - 1]
        prep = np.arange(len(la) + 1, dtype=np.int64)
        prep[1:] = 1 + la[prep[1:] - 1]
        t["la"], t["prep"] = la, prep

    def sym_rewrite_servers(self, servers, t):
        la, prep = t["la"], t["prep"]
        return torch.cat([
            servers[..., 0:1],
            t["val"][servers[..., 1:2].clamp(max=self.value_mask)],
            prep[servers[..., 2:5].clamp(max=len(prep) - 1)],
            servers[..., 5:6],
            la[servers[..., 6:7].clamp(max=len(la) - 1)],
            servers[..., 7:8]], dim=-1)

    def sym_rewrite_internal_req(self, kind, req, t):
        return req  # the internal kinds leave req unused

    def sym_rewrite_extra(self, kind, extra, t):
        la = t["la"]
        ballot = extra & 15
        with_la = ballot | (la[(extra >> self.la_shift).clamp(
            max=len(la) - 1)] << self.la_shift)
        with_prop = ballot | (t["val"][((extra >> 4) & self.prop_mask)
                                       .clamp(max=self.value_mask)] << 4)
        return torch.where(
            kind == PREPARED, with_la,
            torch.where((kind == ACCEPT) | (kind == DECIDED), with_prop,
                        extra))

    # -- Server host codec ---------------------------------------------------

    def encode_server(self, ps, vec: np.ndarray, base: int) -> None:
        prepares = dict(ps.prepares)
        vec[base] = self._ballot_idx(ps.ballot)
        vec[base + 1] = self._proposal_idx(ps.proposal)
        for a in range(self.S):
            if Id(a) in prepares:
                vec[base + 2 + a] = 1 + self._la_idx(prepares[Id(a)])
        vec[base + 5] = sum(1 << int(a) for a in ps.accepts)
        vec[base + 6] = self._la_idx(ps.accepted)
        vec[base + 7] = 1 if ps.is_decided else 0

    def decode_server(self, vec: np.ndarray, base: int, server_index: int):
        s = self.S
        return PaxosState(
            ballot=self._ballot_tuple(int(vec[base])),
            proposal=self._proposal_tuple(int(vec[base + 1])),
            prepares=tuple(sorted(
                (Id(a), self._la_tuple(int(vec[base + 2 + a]) - 1))
                for a in range(s) if vec[base + 2 + a])),
            accepts=tuple(Id(a) for a in range(s)
                          if (int(vec[base + 5]) >> a) & 1),
            accepted=self._la_tuple(int(vec[base + 6])),
            is_decided=bool(vec[base + 7]))

    # -- Server delivery (paxos.rs:96-222) -----------------------------------

    def server_deliver(self, lanes, f):
        """``PaxosActor.on_msg`` at each row's ``f.dst`` server. Every
        branch computes, and each lane selects its value: the message
        kinds exclude each other, and a decided server answers only Get.
        Arithmetic that can wrap is masked to uint32."""
        s, c = self.S, self.C
        dst, src, kind = f.dst, f.src, f.kind
        m_ballot = f.extra & 15
        m_prop = (f.extra >> 4) & self.prop_mask
        m_la = f.extra >> self.la_shift
        b, prop, accmask, acc, dec = (lanes[:, i] for i in (0, 1, 5, 6, 7))
        prep = [lanes[:, 2 + a] for a in range(s)]
        majority = s // 2 + 1

        def sel(cond, x, y):
            return torch.where(cond, x, y)

        # Decided and Get: GetOk with the accepted value (its proposal
        # index is its value index).
        acc_prop = sel(acc == 0, 0, (acc - 1) % c + 1)
        getok = self.build_env(dst=src, src=dst, kind=GETOK, req=f.req,
                               value=acc_prop)
        case_get = dec == 1
        # Put with no proposal: a new ballot (round + 1, self), Prepare to
        # the peers.
        r_cur = sel(b == 0, 0, (b - 1) // s + 1)
        put_ballot = (r_cur * s + dst + 1) & M32
        put_prop = (f.req & 3) + 1
        put_outs = [sel(dst == p, EMPTY_ENV, self.build_env(
            dst=p, src=dst, kind=PREPARE, extra=put_ballot))
            for p in range(s)]
        case_put = (kind == PUT) & (prop == 0)
        # Prepare with a higher ballot: Prepared with the last accepted.
        prepared_out = self.build_env(
            dst=src, src=dst, kind=PREPARED,
            extra=m_ballot | (acc << self.la_shift))
        case_prepare = (kind == PREPARE) & (b < m_ballot)
        # Prepared at the current ballot: on a quorum, Accept the latest
        # accepted proposal (or its own).
        prep2 = [sel(src == a, (1 + m_la) & M32, prep[a]) for a in range(s)]
        quorum_p = sum((p != 0).to(torch.int64) for p in prep2) == majority
        best = (torch.maximum(torch.maximum(prep2[0], prep2[1]), prep2[2])
                - 1) & M32
        best_prop = sel(best == 0, prop, (best - 1) % c + 1)
        accepted_new = (1 + (b - 1) * c + (best_prop - 1)) & M32
        accept_outs = [sel(quorum_p & (dst != p), self.build_env(
            dst=p, src=dst, kind=ACCEPT, extra=b | (best_prop << 4)),
            EMPTY_ENV) for p in range(s)]
        case_prepared = (kind == PREPARED) & (m_ballot == b)
        # Accept at a ballot at least the current one: Accepted.
        accepted_out = self.build_env(dst=src, src=dst, kind=ACCEPTED,
                                      extra=m_ballot)
        la_m = (1 + (m_ballot - 1) * c + (m_prop - 1)) & M32
        case_accept = (kind == ACCEPT) & (b <= m_ballot)
        # Accepted at the current ballot: on a quorum, Decided to the
        # peers and PutOk to the requester.
        accmask2 = accmask | (1 << src)
        quorum_a = sum((accmask2 >> a) & 1 for a in range(s)) == majority
        req_k = (prop - 1) & M32
        putok_out = self.build_env(dst=s + req_k, src=dst, kind=PUTOK,
                                   req=req_k)
        decided_outs = [sel(quorum_a & (dst != p), self.build_env(
            dst=p, src=dst, kind=DECIDED, extra=b | (prop << 4)),
            EMPTY_ENV) for p in range(s)]
        case_accepted = (kind == ACCEPTED) & (m_ballot == b)
        case_decided = kind == DECIDED

        live = ~case_get
        g_put, g_prep = live & case_put, live & case_prepare
        g_prpd, g_acc = live & case_prepared, live & case_accept
        g_accd, g_dec = live & case_accepted, live & case_decided
        g_prpd_q = g_prpd & quorum_p
        new_lanes = torch.stack([
            sel(g_put, put_ballot, sel(g_prep | g_acc | g_dec, m_ballot, b)),
            sel(g_put, put_prop, sel(g_prpd_q, best_prop, prop)),
            *[sel(g_put, sel(dst == a, (1 + acc) & M32, 0),
                  sel(g_prpd, prep2[a], prep[a])) for a in range(s)],
            sel(g_put, 0, sel(g_prpd_q, accmask | (1 << dst),
                              sel(g_accd, accmask2, accmask))),
            sel(g_prpd_q, accepted_new, sel(g_acc | g_dec, la_m, acc)),
            sel((g_accd & quorum_a) | g_dec, 1, dec)], dim=1)
        handled = sel(case_get, kind == GET,
                      case_put | case_prepare | case_prepared | case_accept
                      | case_accepted | case_decided)

        reply = sel(case_get & (kind == GET), getok, EMPTY_ENV)
        reply = sel(g_prep, prepared_out, reply)
        reply = sel(g_acc, accepted_out, reply)
        reply = sel(g_accd & quorum_a, putok_out, reply)
        # Two broadcast slots: the first two of the three per-peer
        # envelopes that are not empty (the self slot is), in peer order.
        bc = [sel(g_put, put_outs[p], sel(g_prpd, accept_outs[p],
                                          sel(g_accd, decided_outs[p],
                                              EMPTY_ENV)))
              for p in range(s)]
        b0e, b1e = bc[0] != EMPTY_ENV, bc[1] != EMPTY_ENV
        c0 = sel(b0e, bc[0], sel(b1e, bc[1], bc[2]))
        c1 = sel(b0e & b1e, bc[1], sel(b0e ^ b1e, bc[2], EMPTY_ENV))
        return new_lanes, handled, torch.stack([reply, c0, c1], dim=1)
