"""Two-phase commit: the host types, the model, and its device form.

The port's copy of ``examples/two_phase_commit.py`` (the host state
types and ``TwoPhaseSys``, with its host transitions and conditions) and
of ``stateright_tpu/tpu/models/twopc.py`` (the device encoding), after
the reference's ``examples/2pc.rs``.

State lanes (``W = rm_count + 3``, each a uint32 value):

- ``[0, N)``: per-RM state (WORKING=0, PREPARED=1, COMMITTED=2, ABORTED=3)
- ``[N]``: TM state (INIT=0, COMMITTED=1, ABORTED=2)
- ``[N+1]``: TM-prepared bitmask (bit i: RM i observed prepared)
- ``[N+2]``: message-set bitmask (bit 0 Commit, bit 1 Abort, bit 2+i
  Prepared(i))

Fan-out ``2 + 5N`` in the reference's action order: TmCommit, TmAbort,
then per RM TmRcvPrepared, RmPrepare, RmChooseToAbort, RmRcvCommitMsg,
RmRcvAbortMsg.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import FrozenSet, Tuple

import numpy as np
import torch

from ..device_model import DeviceModel
from ..model import Model, Property
from ..symmetry import RewritePlan

__all__ = ["RmState", "TmState", "TwoPhaseState", "COMMIT", "ABORT",
           "prepared", "TwoPhaseSys", "TwoPhaseDevice"]


class RmState(Enum):
    WORKING = 0
    PREPARED = 1
    COMMITTED = 2
    ABORTED = 3


class TmState(Enum):
    INIT = 0
    COMMITTED = 1
    ABORTED = 2


# Messages: ("prepared", rm) | ("commit",) | ("abort",)
COMMIT = ("commit",)
ABORT = ("abort",)


def prepared(rm: int) -> Tuple:
    return ("prepared", rm)


@dataclass(frozen=True)
class TwoPhaseState:
    rm_state: Tuple[RmState, ...]
    tm_state: TmState
    tm_prepared: Tuple[bool, ...]
    msgs: FrozenSet[Tuple]

    def representative(self) -> "TwoPhaseState":
        """The RMs sorted by state, with the RM indices in the messages
        rewritten to match (``2pc.rs:165-182``): the host DFS's
        ``symmetry()``. A heuristic, as the reference's: 665 classes at 5
        RMs, where the device form's exact representative finds 314."""
        plan = RewritePlan.from_values_to_sort(
            [s.value for s in self.rm_state])
        return TwoPhaseState(
            rm_state=tuple(self.rm_state[i] for i in plan.reindex_mapping),
            tm_state=self.tm_state,
            tm_prepared=tuple(
                self.tm_prepared[i] for i in plan.reindex_mapping),
            msgs=frozenset(
                ("prepared", plan.rewrite(m[1])) if m[0] == "prepared" else m
                for m in self.msgs),
        )


class TwoPhaseSys(Model):
    """Two-phase commit with ``rm_count`` resource managers. Its host
    actions are bare tuples, ``("TmCommit",)``, ``("RmPrepare", rm)`` and
    so on (``2pc.rs:43-121``), the device form's action labels."""

    def __init__(self, rm_count: int):
        self.rm_count = rm_count

    def device_model(self) -> "TwoPhaseDevice":
        return TwoPhaseDevice(self.rm_count)

    def init_states(self):
        return [TwoPhaseState(
            rm_state=(RmState.WORKING,) * self.rm_count,
            tm_state=TmState.INIT,
            tm_prepared=(False,) * self.rm_count,
            msgs=frozenset(),
        )]

    def actions(self, state, actions):
        if state.tm_state is TmState.INIT and all(state.tm_prepared):
            actions.append(("TmCommit",))
        if state.tm_state is TmState.INIT:
            actions.append(("TmAbort",))
        for rm in range(self.rm_count):
            if (state.tm_state is TmState.INIT
                    and prepared(rm) in state.msgs):
                actions.append(("TmRcvPrepared", rm))
            if state.rm_state[rm] is RmState.WORKING:
                actions.append(("RmPrepare", rm))
                actions.append(("RmChooseToAbort", rm))
            if COMMIT in state.msgs:
                actions.append(("RmRcvCommitMsg", rm))
            if ABORT in state.msgs:
                actions.append(("RmRcvAbortMsg", rm))

    def next_state(self, state, action):
        kind = action[0]
        rm_state = list(state.rm_state)
        tm_prepared = list(state.tm_prepared)
        tm_state = state.tm_state
        msgs = state.msgs
        if kind == "TmRcvPrepared":
            tm_prepared[action[1]] = True
        elif kind == "TmCommit":
            tm_state = TmState.COMMITTED
            msgs = msgs | {COMMIT}
        elif kind == "TmAbort":
            tm_state = TmState.ABORTED
            msgs = msgs | {ABORT}
        elif kind == "RmPrepare":
            rm_state[action[1]] = RmState.PREPARED
            msgs = msgs | {prepared(action[1])}
        elif kind == "RmChooseToAbort":
            rm_state[action[1]] = RmState.ABORTED
        elif kind == "RmRcvCommitMsg":
            rm_state[action[1]] = RmState.COMMITTED
        else:  # RmRcvAbortMsg
            rm_state[action[1]] = RmState.ABORTED
        return TwoPhaseState(tuple(rm_state), tm_state,
                             tuple(tm_prepared), msgs)

    def properties(self):
        return [
            Property.sometimes("abort agreement", lambda _, s: all(
                r is RmState.ABORTED for r in s.rm_state)),
            Property.sometimes("commit agreement", lambda _, s: all(
                r is RmState.COMMITTED for r in s.rm_state)),
            Property.always("consistent", lambda _, s: not (
                any(r is RmState.ABORTED for r in s.rm_state)
                and any(r is RmState.COMMITTED for r in s.rm_state))),
        ]


class TwoPhaseDevice(DeviceModel):
    #: the RM counts ``csrc/wave_twopc.cu``'s plan form (``wave.cuda_plan``)
    #: holds: its instances at 4 and 8 RMs
    CUDA_PLAN_INSTANCES = tuple(range(1, 9))

    def __init__(self, rm_count: int):
        if rm_count > 28:
            raise ValueError("bitmask encoding supports at most 28 RMs")
        self.rm_count = rm_count
        self.state_width = rm_count + 3
        self.max_fanout = 2 + 5 * rm_count

    def lane_bits(self):
        """2-bit RM/TM states, an N-bit prepared mask and an
        (N+2)-bit message mask: 44 bits, two words, at 10 RMs."""
        n = self.rm_count
        return [2] * n + [2, n, n + 2]

    def cuda_model(self):
        """``csrc/models/twopc.cuh``, at this RM count."""
        return "twopc", (self.rm_count,)

    def action_names(self):
        names = [("TmCommit",), ("TmAbort",)]
        for i in range(self.rm_count):
            names += [("TmRcvPrepared", i), ("RmPrepare", i),
                      ("RmChooseToAbort", i), ("RmRcvCommitMsg", i),
                      ("RmRcvAbortMsg", i)]
        return names

    # -- Codec -----------------------------------------------------------

    def encode(self, state) -> np.ndarray:
        n = self.rm_count
        vec = np.zeros(self.state_width, np.uint32)
        for i, s in enumerate(state.rm_state):
            vec[i] = s.value
        vec[n] = state.tm_state.value
        vec[n + 1] = sum(1 << i for i, p in enumerate(state.tm_prepared) if p)
        msgs = 0
        for m in state.msgs:
            if m[0] == "commit":
                msgs |= 1
            elif m[0] == "abort":
                msgs |= 2
            else:  # ("prepared", rm)
                msgs |= 1 << (2 + m[1])
        vec[n + 2] = msgs
        return vec

    def decode(self, vec: np.ndarray) -> TwoPhaseState:
        n = self.rm_count
        bits = int(vec[n + 2])
        msgs = set()
        if bits & 1:
            msgs.add(COMMIT)
        if bits & 2:
            msgs.add(ABORT)
        for i in range(n):
            if (bits >> (2 + i)) & 1:
                msgs.add(prepared(i))
        return TwoPhaseState(
            rm_state=tuple(RmState(int(vec[i])) for i in range(n)),
            tm_state=TmState(int(vec[n])),
            tm_prepared=tuple(
                bool((int(vec[n + 1]) >> i) & 1) for i in range(n)),
            msgs=frozenset(msgs),
        )

    # -- Device transition (2pc.rs:52-76) --------------------------------

    def step(self, rows: torch.Tensor):
        n = self.rm_count
        B, W = rows.shape
        rm, tm = rows[:, :n], rows[:, n]
        prep, msgs = rows[:, n + 1], rows[:, n + 2]
        i = torch.arange(n, device=rows.device)
        base = 2 + 5 * i
        init = tm == 0
        succ = rows[:, None, :].expand(B, self.max_fanout, W).clone()
        valid = torch.empty((B, self.max_fanout), dtype=torch.bool,
                            device=rows.device)
        # TmCommit
        succ[:, 0, n] = 1
        succ[:, 0, n + 2] = msgs | 1
        valid[:, 0] = init & (prep == (1 << n) - 1)
        # TmAbort
        succ[:, 1, n] = 2
        succ[:, 1, n + 2] = msgs | 2
        valid[:, 1] = init
        # TmRcvPrepared(i)
        succ[:, base, n + 1] = prep[:, None] | (1 << i)
        valid[:, base] = init[:, None] & (((msgs[:, None] >> (2 + i)) & 1)
                                          == 1)
        # RmPrepare(i). An advanced-index store takes tensor values: a
        # Python scalar there would be copied from the host, a sync.
        succ[:, base + 1, i] = torch.ones_like(rm)
        succ[:, base + 1, n + 2] = msgs[:, None] | (1 << (2 + i))
        valid[:, base + 1] = rm == 0
        # RmChooseToAbort(i)
        succ[:, base + 2, i] = torch.full_like(rm, 3)
        valid[:, base + 2] = rm == 0
        # RmRcvCommitMsg(i)
        succ[:, base + 3, i] = torch.full_like(rm, 2)
        valid[:, base + 3] = ((msgs & 1) == 1)[:, None].expand(B, n)
        # RmRcvAbortMsg(i)
        succ[:, base + 4, i] = torch.full_like(rm, 3)
        valid[:, base + 4] = ((msgs & 2) == 2)[:, None].expand(B, n)
        return succ, valid

    # -- Properties (2pc.rs:106-121) -------------------------------------

    def device_properties(self):
        n = self.rm_count

        def abort_agreement(rows):
            return (rows[:, :n] == 3).all(dim=1)

        def commit_agreement(rows):
            return (rows[:, :n] == 2).all(dim=1)

        def consistent(rows):
            rm = rows[:, :n]
            return ~((rm == 3).any(dim=1) & (rm == 2).any(dim=1))

        return {
            "abort agreement": abort_agreement,
            "commit agreement": commit_agreement,
            "consistent": consistent,
        }

    # -- Symmetry (2pc.rs:165-182) ---------------------------------------

    def representative(self, rows: torch.Tensor) -> torch.Tensor:
        """Exact canonicalization: an RM's whole part of the state is the
        triple (rm_state, tm_prepared bit, prepared-message bit), packed
        into one key; sorting each row's keys sorts the RMs, and equal
        keys are identical triples, so the sorted keys alone rebuild the
        row. 8,832 states fall into 314 classes at 5 RMs."""
        n = self.rm_count
        i = torch.arange(n, device=rows.device)
        prep, msgs = rows[:, n + 1], rows[:, n + 2]
        prep_bits = (prep[:, None] >> i) & 1
        msg_bits = (msgs[:, None] >> (2 + i)) & 1
        key = torch.sort(rows[:, :n] * 4 + prep_bits * 2 + msg_bits,
                         dim=1).values
        new_prep = (((key >> 1) & 1) << i).sum(dim=1)
        new_msgs = (msgs & 3) | (((key & 1) << i).sum(dim=1) << 2)
        return torch.cat([key >> 2, rows[:, n:n + 1], new_prep[:, None],
                          new_msgs[:, None]], dim=1)
