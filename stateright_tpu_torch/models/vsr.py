"""Viewstamped replication: the host model and its device form.

The port's copy of ``stateright_tpu/actor/viewstamped.py`` (the model:
``VsrCfg(n, max_view, lossy, duplicating).into_model()``) and of
``stateright_tpu/tpu/models/vsr.py`` (the device encoding). Single-slot
VR on ``n`` replicas: the primary of view ``v`` (replica ``v mod n``)
proposes the value ``v + 1`` on its timer, backups acknowledge with
``PrepareOk`` and a majority of acks commits; a backup's timer instead
suspects the primary and starts a view change (``StartViewChange``
gossip, then ``DoViewChange`` to the new primary with the sender's
accepted operation, which adopts the maximum and announces it with
``StartView``). Every replica's timer is armed at start and re-armed on
each timeout, so a Timeout is always enabled (a quiescent replica's is a
self-loop that counts in the states); the ``max_view`` boundary bounds
the space. Checked for "agreement" (always) and three sometimes
properties. Gates: 63 / 169 at n = 2, 5,531 / 32,006 at n = 3.

Lanes (``W = 8n + 1 + net_slots + 1``): each replica's eight
``ReplicaState`` fields in their order (view, status, op_val, committed,
oks, svc, dvc, dvc_best); the timer bitmask; the network (``net_slots``,
``8n`` by default) and the overflow flag. Envelope code, src and dst two
bits each (at most 4 replicas), view and value four each (``max_view``
at most 14)::

    ((((view << 4) | val) << 3 | kind) << 2 | src) << 2 | dst

with kinds Prepare 0, PrepareOk 1, Commit 2, StartViewChange 3,
DoViewChange 4 and StartView 5. Each handler mirrors its host twin
branch for branch, the no-op branches in its ``handled`` flag. No
symmetry; every lane a whole word. Its CUDA device code
(``cuda_model()``) is ``csrc/models/vsr.cuh`` on
``csrc/models/actor_net.cuh``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..actor import ActorModelState, Envelope, Id, Network
from ..actor_device import EMPTY_ENV, M32, ActorDeviceModel
from ..model import Model, Property

__all__ = ["VsrSys", "VsrDevice", "ReplicaState", "Prepare", "PrepareOk",
           "Commit", "StartViewChange", "DoViewChange", "StartView",
           "majority"]

_PREPARE, _PREPARE_OK, _COMMIT = 0, 1, 2
_START_VC, _DO_VC, _START_VIEW = 3, 4, 5
#: a replica's lanes, ReplicaState's field order
_VIEW, _STATUS, _OP, _COMMITTED, _OKS, _SVC, _DVC, _BEST = range(8)


def majority(cluster_size: int) -> int:
    """The nodes of a majority (the reference's ``actor.rs:437-439``)."""
    return cluster_size // 2 + 1


# -- Messages and the replica's state -----------------------------------------


@dataclass(frozen=True)
class Prepare:
    """Primary of ``view`` proposes operation ``val`` (= view + 1)."""
    view: int
    val: int

    def __repr__(self):
        return f"Prepare(v={self.view}, x={self.val})"


@dataclass(frozen=True)
class PrepareOk:
    """Backup acknowledges the accepted operation of ``view``."""
    view: int

    def __repr__(self):
        return f"PrepareOk(v={self.view})"


@dataclass(frozen=True)
class Commit:
    """Primary announces ``val`` committed in ``view``."""
    view: int
    val: int

    def __repr__(self):
        return f"Commit(v={self.view}, x={self.val})"


@dataclass(frozen=True)
class StartViewChange:
    """A replica suspects the primary and proposes moving to ``view``."""
    view: int

    def __repr__(self):
        return f"StartViewChange(v={self.view})"


@dataclass(frozen=True)
class DoViewChange:
    """A majority member hands its accepted operation (0 = none) to the
    new primary of ``view``."""
    view: int
    op_val: int

    def __repr__(self):
        return f"DoViewChange(v={self.view}, x={self.op_val})"


@dataclass(frozen=True)
class StartView:
    """The new primary of ``view`` announces the adopted operation."""
    view: int
    op_val: int

    def __repr__(self):
        return f"StartView(v={self.view}, x={self.op_val})"


@dataclass(frozen=True)
class ReplicaState:
    view: int = 0
    status: int = 0        # 0 normal, 1 view-change
    op_val: int = 0        # accepted operation value (0 = none)
    committed: int = 0     # committed value (0 = none)
    oks: int = 0           # PrepareOk bitmask (valid at the primary)
    svc: int = 0           # StartViewChange bitmask
    dvc: int = 0           # DoViewChange bitmask (valid at new primary)
    dvc_best: int = 0      # max op carried by received DoViewChanges


_KINDS = {Prepare: _PREPARE, PrepareOk: _PREPARE_OK, Commit: _COMMIT,
          StartViewChange: _START_VC, DoViewChange: _DO_VC,
          StartView: _START_VIEW}


class VsrSys(Model):
    """``n`` replicas (1 to 4) bounded at ``max_view`` view changes, on a
    network that duplicates and loses messages as asked, bounded on the
    device at ``net_slots`` envelopes in flight (``8n`` by default)."""

    #: its host transitions are not ported yet: it runs on the device
    #: engines only
    host_form_item = "A16"

    #: the JAX package's model is an ``ActorModel``: the same name lets
    #: each package resume the other's checkpoints
    checkpoint_name = "ActorModel"

    def __init__(self, n: int = 3, max_view: int = 1, lossy: bool = False,
                 duplicating: bool = True, net_slots: int = None):
        self.n = n
        self.max_view = max_view
        self.lossy = lossy
        self.duplicating = duplicating
        self.net_slots = net_slots

    def device_model(self) -> "VsrDevice":
        return VsrDevice(self.n, self.max_view, lossy=self.lossy,
                         duplicating=self.duplicating,
                         net_slots=self.net_slots)

    def init_states(self):
        """``VsrReplica.on_start``: every replica fresh, its timer armed,
        nothing in flight."""
        return [ActorModelState(
            actor_states=[ReplicaState() for _ in range(self.n)],
            network=Network(), is_timer_set=[True] * self.n, history=None)]

    def properties(self):
        return [Property.always("agreement"),
                Property.sometimes("can commit"),
                Property.sometimes("view change completes"),
                Property.sometimes("commit survives view change")]


class VsrDevice(ActorDeviceModel):
    #: replica counts that ``csrc/wave_vsr.cu`` and ``sender_vsr.cu``
    #: instantiate, each with its instances' network slots (an instance
    #: holds every count up to its own; the smallest that holds a run runs)
    CUDA_INSTANCES = {1: (64,), 2: (16, 64), 3: (40, 64), 4: (48, 64)}

    def __init__(self, n: int, max_view: int, lossy: bool = False,
                 duplicating: bool = True, net_slots: int = None):
        if n > 4:
            raise ValueError("envelope codec supports at most 4 replicas")
        if max_view > 14:
            raise ValueError("envelope codec supports max_view <= 14")
        self.n = n
        self.max_view = max_view
        self.maj = majority(n)
        self.net_slots = 8 * n if net_slots is None else net_slots
        self.n_timers = n
        self.timer_offset = 8 * n
        self.net_offset = 8 * n + 1
        self.state_width = self.net_offset + self.net_slots + 1
        self.error_lane = self.net_offset + self.net_slots
        self.max_out = n
        self.lossy = lossy
        self.duplicating = duplicating

    def cuda_model(self):
        """``csrc/models/vsr.cuh`` at this replica count, form,
        ``max_view`` and ``net_slots``; raises for a count it holds no
        instance of, or more slots than its largest instance takes (the
        message names the range held)."""
        most = max(self.CUDA_INSTANCES.get(self.n, (0,)))
        if not 1 <= self.net_slots <= most:
            top = max(map(max, self.CUDA_INSTANCES.values()))
            raise NotImplementedError(
                f"csrc/wave_vsr.cu has no instance at {self.n} replicas "
                f"and {self.net_slots} network slots (it holds 1 to 4 "
                f"replicas at 1 to {top} slots): run it with "
                "wave_kernel=False on the card")
        return "vsr", (self.n, int(self.lossy), int(self.duplicating),
                       self.max_view, self.net_slots)

    # -- Envelope codec -------------------------------------------------------

    def env_encode(self, envelope) -> int:
        msg = envelope.msg
        val = getattr(msg, "val", getattr(msg, "op_val", 0)) or 0
        code = (msg.view << 4) | val
        return ((((code << 3) | _KINDS[type(msg)]) << 2
                 | int(envelope.src)) << 2) | int(envelope.dst)

    def env_decode(self, code: int):
        dst, src = code & 3, (code >> 2) & 3
        kind, val, view = (code >> 4) & 7, (code >> 7) & 15, (code >> 11) & 15
        msg = {_PREPARE: lambda: Prepare(view, val),
               _PREPARE_OK: lambda: PrepareOk(view),
               _COMMIT: lambda: Commit(view, val),
               _START_VC: lambda: StartViewChange(view),
               _DO_VC: lambda: DoViewChange(view, val),
               _START_VIEW: lambda: StartView(view, val)}[kind]()
        return Envelope(Id(src), Id(dst), msg)

    # -- State codec ----------------------------------------------------------

    def encode(self, state) -> np.ndarray:
        vec = np.zeros(self.state_width, np.uint32)
        for i, s in enumerate(state.actor_states):
            vec[8 * i:8 * i + 8] = (s.view, s.status, s.op_val, s.committed,
                                    s.oks, s.svc, s.dvc, s.dvc_best)
        vec[self.timer_offset] = sum(
            1 << i for i, armed in enumerate(state.is_timer_set) if armed)
        vec[self.net_offset:] = self.encode_network(state.network)
        return vec

    def decode(self, vec: np.ndarray):
        n = self.n
        states = [ReplicaState(*(int(v) for v in vec[8 * i:8 * i + 8]))
                  for i in range(n)]
        timers = [bool((int(vec[self.timer_offset]) >> i) & 1)
                  for i in range(n)]
        return ActorModelState(
            actor_states=states,
            network=Network(self.decode_network(vec[self.net_offset:])),
            is_timer_set=timers, history=None)

    # -- Helpers --------------------------------------------------------------

    @staticmethod
    def _enc(view, val, kind: int, src, dst):
        """The envelope of these fields, wrapped to 32 bits as the
        reference's uint32 shifts wrap."""
        return ((((((view << 4) | val) << 3) | kind) << 2 | src) << 2
                | dst) & M32

    def _popcount(self, mask):
        total = torch.zeros_like(mask)
        for b in range(self.n):
            total = total + ((mask >> b) & 1)
        return total

    def _row(self, body, i):
        """Replica ``i``'s eight lanes of each row (``i int64[N]``, JAX's
        gather: clamped to the last replica)."""
        rows = body[:, :8 * self.n].view(-1, self.n, 8)
        i = i.clamp(max=self.n - 1)
        return rows.gather(1, i[:, None, None].expand(-1, 1, 8))[:, 0]

    def _set_row(self, body, i, row):
        """``body`` with replica ``i``'s lanes set to ``row`` (JAX's
        scatter: nothing set past the last replica)."""
        n = self.n
        hit = (torch.arange(n, device=body.device) == i[:, None])[:, :, None]
        rows = torch.where(hit, row[:, None, :],
                           body[:, :8 * n].view(-1, n, 8))
        return torch.cat([rows.reshape(-1, 8 * n), body[:, 8 * n:]], dim=1)

    # -- Delivery (viewstamped.py:171-287) ------------------------------------

    def deliver(self, body, env):
        n, maj, pop = self.n, self.maj, self._popcount
        dst, src = env & 3, (env >> 2) & 3
        kind, val, view = (env >> 4) & 7, (env >> 7) & 15, (env >> 11) & 15
        where = torch.where

        row = self._row(body, dst)
        (s_view, s_status, s_op, s_com, s_oks, s_svc, s_dvc,
         s_best) = row.unbind(1)
        i_bit, j_bit = 1 << dst, 1 << src
        is_primary = view % n == dst

        # Prepare (view, x): accept and ack, or catch up.
        p_catch = (kind == _PREPARE) & (view > s_view)
        p_same = ((kind == _PREPARE) & (view == s_view) & (s_status == 0)
                  & ~is_primary & (s_op == 0))
        prep_handled = p_catch | p_same
        # PrepareOk (view): quorum counting at the primary.
        ok_valid = ((kind == _PREPARE_OK) & (view == s_view)
                    & (s_status == 0) & (s_view % n == dst) & (s_op != 0)
                    & (s_com == 0))
        oks2 = s_oks | j_bit | i_bit
        ok_changed = ok_valid & (oks2 != s_oks)
        ok_quorum = ok_changed & (pop(oks2) >= maj)
        # Commit (view, x): adopt the committed fact.
        c_fresh = (kind == _COMMIT) & (s_com == 0)
        c_newer = c_fresh & (view > s_view)
        # StartViewChange (view): gossip and quorum.
        svc_enter = (kind == _START_VC) & (view > s_view)
        svc_same = (kind == _START_VC) & (view == s_view) & (s_status == 1)
        svc_mask_enter = i_bit | j_bit
        svc_mask_same = s_svc | j_bit
        svc_changed = svc_same & (svc_mask_same != s_svc)
        svc_handled = svc_enter | svc_changed
        svc_send_dvc = ((svc_enter & (pop(svc_mask_enter) >= maj))
                        | (svc_changed & (pop(svc_mask_same) >= maj)
                           & (pop(s_svc) < maj)))
        # DoViewChange (view, o): the new primary collects.
        dvc_newer = (kind == _DO_VC) & is_primary & (view > s_view)
        dvc_same = ((kind == _DO_VC) & is_primary & (view == s_view)
                    & (s_status == 1))
        dvc_mask_newer = i_bit | j_bit
        best_newer = torch.maximum(s_op, val)
        dvc_mask_same = s_dvc | j_bit | i_bit
        best_same = torch.maximum(torch.maximum(s_best, s_op), val)
        dvc_changed = dvc_same & ((dvc_mask_same != s_dvc)
                                  | (best_same != s_best))
        dvc_handled = dvc_newer | dvc_changed
        dvc_complete = ((dvc_newer & (pop(dvc_mask_newer) >= maj))
                        | (dvc_changed & (pop(dvc_mask_same) >= maj)
                           & (pop(s_dvc) < maj)))
        dvc_mask = where(dvc_newer, dvc_mask_newer, dvc_mask_same)
        dvc_best = where(dvc_newer, best_newer, best_same)
        # StartView (view, o): adopt the announced op.
        sv_adopt = ((kind == _START_VIEW)
                    & ((view > s_view)
                       | ((view == s_view) & (s_status == 1))))
        sv_ack = sv_adopt & (val != 0) & (s_com == 0)

        handled = (prep_handled | ok_changed | c_fresh | svc_handled
                   | dvc_handled | sv_adopt)

        # The new replica row: a where-cascade a field (the branches
        # exclude each other, since the kind selects them).
        reset = p_catch | c_newer | svc_enter | dvc_newer | sv_adopt
        new_view = where(reset, view, s_view)
        new_status = where(p_catch | c_newer | sv_adopt, 0, s_status)
        new_status = where(svc_enter | dvc_newer, 1, new_status)
        new_status = where(dvc_complete, 0, new_status)
        new_op = where(prep_handled | c_newer, val, s_op)
        new_op = where(c_fresh & ~c_newer, where(s_op == 0, val, s_op),
                       new_op)
        new_op = where(sv_adopt, val, new_op)
        new_op = where(dvc_complete, dvc_best, new_op)
        new_com = where(c_fresh, val, s_com)
        new_com = where(ok_quorum, s_op, new_com)
        new_oks = where(reset, 0, s_oks)
        new_oks = where(ok_changed, oks2, new_oks)
        new_oks = where(dvc_complete, where(dvc_best != 0, i_bit, 0),
                        new_oks)
        new_svc = where(p_catch | c_newer | dvc_newer | sv_adopt, 0, s_svc)
        new_svc = where(svc_enter, svc_mask_enter, new_svc)
        new_svc = where(svc_changed, svc_mask_same, new_svc)
        new_svc = where(dvc_complete, 0, new_svc)
        cleared = p_catch | c_newer | svc_enter | sv_adopt
        new_dvc = where(cleared, 0, s_dvc)
        new_dvc = where(dvc_handled, dvc_mask, new_dvc)
        new_dvc = where(dvc_complete, 0, new_dvc)
        new_best = where(cleared, 0, s_best)
        new_best = where(dvc_handled, dvc_best, new_best)
        new_best = where(dvc_complete, 0, new_best)
        new_row = torch.stack([new_view, new_status, new_op, new_com,
                               new_oks, new_svc, new_dvc, new_best], dim=1)
        new_body = self._set_row(body, dst,
                                 where(handled[:, None], new_row, row))

        # Sends: slots [0, n - 1) broadcast to every other replica (Commit
        # on quorum, StartViewChange gossip, StartView on completion; by
        # kind, at most one), slot n - 1 the unicast (PrepareOk back to
        # src, or DoViewChange to the new primary).
        enc = self._enc
        outs = []
        for k in range(n - 1):
            other = where(k < dst, k, k + 1)
            e = torch.full_like(env, EMPTY_ENV)
            e = where(ok_quorum, enc(s_view, s_op, _COMMIT, dst, other), e)
            e = where(svc_enter, enc(view, 0, _START_VC, dst, other), e)
            e = where(dvc_complete,
                      enc(view, dvc_best, _START_VIEW, dst, other), e)
            outs.append(e)
        uni = torch.full_like(env, EMPTY_ENV)
        ack = enc(view, 0, _PREPARE_OK, dst, src)
        uni = where(prep_handled | sv_ack, ack, uni)
        uni = where(svc_send_dvc, enc(view, s_op, _DO_VC, dst, view % n),
                    uni)
        outs.append(uni)
        return new_body, handled, torch.stack(outs, dim=1)

    # -- Timeout (viewstamped.py:155-169) -------------------------------------

    def timeout(self, body, actor):
        """``VsrReplica.on_timeout`` of replica ``actor``: the primary of
        a normal view with nothing accepted proposes, a backup in a normal
        view suspects the primary; else nothing changes. Always handled:
        the timer re-arms, so even the quiescent branch is a self-loop."""
        n, where = self.n, torch.where
        row = self._row(body, actor)
        s_view, s_status, s_op = row[:, _VIEW], row[:, _STATUS], row[:, _OP]
        i_bit = 1 << actor
        is_primary = s_view % n == actor
        propose = (s_status == 0) & is_primary & (s_op == 0)
        suspect = (s_status == 0) & ~is_primary
        nv = (s_view + 1) & M32
        new_row = torch.stack([
            where(suspect, nv, s_view),
            where(suspect, 1, s_status),
            where(propose, nv, s_op),
            row[:, _COMMITTED],
            where(propose, i_bit, where(suspect, 0, row[:, _OKS])),
            where(suspect, i_bit, row[:, _SVC]),
            where(suspect, 0, row[:, _DVC]),
            where(suspect, 0, row[:, _BEST])], dim=1)
        new_body = self._set_row(body, actor, new_row)
        outs = []
        for k in range(n - 1):
            other = where(k < actor, k, k + 1)
            e = torch.full_like(actor, EMPTY_ENV)
            e = where(propose, self._enc(s_view, nv, _PREPARE, actor, other),
                      e)
            e = where(suspect, self._enc(nv, 0, _START_VC, actor, other), e)
            outs.append(e)
        # Slot n - 1, the unicast, is not used by a timeout.
        outs.append(torch.full_like(actor, EMPTY_ENV))
        return (new_body, torch.ones_like(actor, dtype=torch.bool),
                torch.stack(outs, dim=1))

    # -- Boundary and properties (viewstamped.py:296-335) ---------------------

    def boundary(self, rows):
        return (rows[:, 0:8 * self.n:8] <= self.max_view).all(dim=1)

    def device_properties(self):
        n = self.n

        def lanes(rows, field):
            return rows[:, field:8 * n:8]

        def agreement(rows):
            com = lanes(rows, _COMMITTED)
            holds = torch.ones(rows.shape[0], dtype=torch.bool,
                               device=rows.device)
            for a in range(n):
                for b in range(a + 1, n):
                    ca, cb = com[:, a], com[:, b]
                    holds = holds & ((ca == 0) | (cb == 0) | (ca == cb))
            return holds

        return {
            "agreement": agreement,
            "can commit": lambda r: (lanes(r, _COMMITTED) != 0).any(dim=1),
            "view change completes": lambda r: (
                (lanes(r, _VIEW) > 0) & (lanes(r, _STATUS) == 0)).any(dim=1),
            "commit survives view change": lambda r: (
                (lanes(r, _COMMITTED) != 0) & (lanes(r, _VIEW) > 0)).any(
                    dim=1),
        }
