"""Ping-pong: the actor layer's test fixture, host model and device form.

The port's copy of ``stateright_tpu/actor/actor_test_util.py`` (the actor
``PingPongActor`` and the model, ``PingPongCfg(maintains_history,
max_nat).into_model()``, after the reference's ``actor_test_util.rs:4-96``;
the host ``ActorModel``'s fixture for its network forms and history) and of
``stateright_tpu/tpu/models/pingpong.py`` (the device encoding). Two
actors bounce ``Ping``/``Pong`` messages: actor 0 sends ``Ping(0)`` to
actor 1 on start, and each actor whose count equals a message's value
replies (``Pong(v)`` to a ``Ping(v)``, ``Ping(v + 1)`` to a ``Pong(v)``)
and counts it. An optional ``(msgs_in, msgs_out)`` history rides along.
The boundary keeps both counts at most ``max_nat``. The parity workout
for the actor layer's network forms: the reference's counts are 14 at
``max_nat`` 1 on a lossy network, 4,094 at 5 on a lossy duplicating one
and 11 at 5 on a perfect one (``actor/model.rs:547, 629, 660``).

Lanes: ``[0]``, ``[1]`` each actor's count; ``[2]``, ``[3]`` the history
(in, out), kept at (0, 0) without one; ``[4, 4 + E)`` the network;
``[4 + E]`` the overflow flag. Envelope code: ``value << 3 | kind << 2 |
src << 1 | dst``, with kind Ping 0 and Pong 1. No timers, no symmetry;
every lane a whole word (JAX's form declares no ``lane_bits``). Its CUDA
device code (``cuda_model()``) is ``csrc/models/pingpong.cuh`` on
``csrc/models/actor_net.cuh``, which the single-kernel wave and the
sender kernel run on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..actor import (Actor, ActorModel, ActorModelState, Envelope, Id,
                     Network, Out)
from ..actor_device import EMPTY_ENV, M32, ActorDeviceModel
from ..model import Expectation

__all__ = ["Ping", "Pong", "PingPongActor", "PingPongSys", "PingPongDevice"]

_PING, _PONG = 0, 1


@dataclass(frozen=True)
class Ping:
    value: int

    def __repr__(self):
        return f"Ping({self.value})"


@dataclass(frozen=True)
class Pong:
    value: int

    def __repr__(self):
        return f"Pong({self.value})"


class PingPongActor(Actor):
    """Sends ``Ping(0)`` on start when it serves a peer, and answers a
    ``Ping`` or a ``Pong`` whose value equals its count (the reference's
    ``actor_test_util.rs:13-37``). State: its count."""

    def __init__(self, serve_to: Optional[Id] = None):
        self.serve_to = serve_to

    def on_start(self, id: Id, o: Out) -> int:
        if self.serve_to is not None:
            o.send(self.serve_to, Ping(0))
        return 0

    def on_msg(self, id: Id, state: int, src: Id, msg, o: Out):
        if type(msg) is Pong and state == msg.value:
            o.send(src, Ping(msg.value + 1))
            return state + 1
        if type(msg) is Ping and state == msg.value:
            o.send(src, Pong(msg.value))
            return state + 1
        return None


def _record_in(cfg, history, env):
    if cfg.maintains_history:
        msgs_in, msgs_out = history
        return (msgs_in + 1, msgs_out)
    return None


def _record_out(cfg, history, env):
    if cfg.maintains_history:
        msgs_in, msgs_out = history
        return (msgs_in, msgs_out + 1)
    return None


def _reaches(model, state, count) -> bool:
    return any(c == count for c in state.actor_states)


class PingPongSys(ActorModel):
    """The two counters up to ``max_nat``, with the ``(in, out)`` history
    when ``maintains_history``, on a network that duplicates and loses
    messages as asked (the host model's defaults: duplicating, not lossy;
    ``with_lossy_network`` / ``with_duplicating_network`` change them),
    bounded on the device at ``net_slots`` envelopes in flight."""

    #: the JAX package's model is an ``ActorModel``: the same name lets
    #: each package resume the other's checkpoints
    checkpoint_name = "ActorModel"

    def __init__(self, max_nat: int, maintains_history: bool = False,
                 lossy: bool = False, duplicating: bool = True,
                 net_slots: int = 16):
        super().__init__(cfg=self, init_history=(0, 0))
        self.max_nat = max_nat
        self.maintains_history = maintains_history
        self.net_slots = net_slots
        always, sometimes = Expectation.ALWAYS, Expectation.SOMETIMES
        eventually = Expectation.EVENTUALLY
        (self.actor(PingPongActor(serve_to=Id(1)))
         .actor(PingPongActor(serve_to=None))
         .record_msg_in(_record_in).record_msg_out(_record_out)
         .with_boundary(lambda cfg, state: all(
             count <= cfg.max_nat for count in state.actor_states))
         .with_lossy_network(lossy).with_duplicating_network(duplicating)
         .property(always, "delta within 1", lambda _, state:
                   max(state.actor_states) - min(state.actor_states) <= 1)
         .property(sometimes, "can reach max",
                   lambda m, s: _reaches(m, s, m.cfg.max_nat))
         .property(eventually, "must reach max",
                   lambda m, s: _reaches(m, s, m.cfg.max_nat))
         # falsifiable, because of the boundary
         .property(eventually, "must exceed max",
                   lambda m, s: _reaches(m, s, m.cfg.max_nat + 1))
         .property(always, "#in <= #out",
                   lambda _, state: state.history[0] <= state.history[1])
         .property(eventually, "#out <= #in + 1",
                   lambda _, state: state.history[1] <= state.history[0] + 1))

    def device_model(self) -> "PingPongDevice":
        return PingPongDevice(self.max_nat, self.maintains_history,
                              net_slots=self.net_slots,
                              duplicating=self.duplicating_network,
                              lossy=self.lossy_network)


class PingPongDevice(ActorDeviceModel):
    max_out = 1

    #: the network slots of ``csrc/wave_pingpong.cu``'s instances, each
    #: holding every count up to its own in every form (the history and
    #: the network's form are runtime flags there), and the most of them
    CUDA_INSTANCES = (26, 64)
    CUDA_MAX_SLOTS = max(CUDA_INSTANCES)

    def __init__(self, max_nat: int, maintains_history: bool = False,
                 net_slots: int = 16, duplicating: bool = True,
                 lossy: bool = False):
        self.max_nat = max_nat
        self.maintains_history = maintains_history
        self.net_slots = net_slots
        self.net_offset = 4
        self.state_width = 4 + net_slots + 1
        self.error_lane = 4 + net_slots
        self.duplicating = duplicating
        self.lossy = lossy

    def cuda_model(self):
        """``csrc/models/pingpong.cuh`` at this form, ``max_nat`` and
        ``net_slots``; raises past the largest instance's network slots
        (the message names the range held)."""
        if not 1 <= self.net_slots <= self.CUDA_MAX_SLOTS:
            raise NotImplementedError(
                f"csrc/wave_pingpong.cu holds 1 to {self.CUDA_MAX_SLOTS}"
                f" network slots, not {self.net_slots}: run it with "
                "wave_kernel=False on the card")
        return "pingpong", (int(self.maintains_history), int(self.lossy),
                            int(self.duplicating), self.max_nat,
                            self.net_slots)

    # -- Envelope codec -------------------------------------------------------

    def env_encode(self, envelope) -> int:
        msg = envelope.msg
        kind = _PONG if type(msg) is Pong else _PING
        return ((msg.value << 3) | (kind << 2) | (int(envelope.src) << 1)
                | int(envelope.dst))

    def env_decode(self, code: int):
        value = code >> 3
        msg = Pong(value) if (code >> 2) & 1 else Ping(value)
        return Envelope(Id((code >> 1) & 1), Id(code & 1), msg)

    # -- State codec ----------------------------------------------------------

    def encode(self, state) -> np.ndarray:
        vec = np.zeros(self.state_width, np.uint32)
        vec[0], vec[1] = state.actor_states
        if self.maintains_history:
            vec[2], vec[3] = state.history
        vec[4:] = self.encode_network(state.network)
        return vec

    def decode(self, vec: np.ndarray):
        history = ((int(vec[2]), int(vec[3])) if self.maintains_history
                   else (0, 0))
        return ActorModelState(
            actor_states=[int(vec[0]), int(vec[1])],
            network=Network(self.decode_network(vec[4:])),
            is_timer_set=[], history=history)

    # -- Delivery (actor_test_util.rs:20-37) ----------------------------------

    def deliver(self, body, env):
        """``PingPongActor.on_msg`` at each row's destination: a message
        whose value is the actor's count is answered (to its source) and
        counted; with the history, ``record_msg_in`` and then
        ``record_msg_out`` of the reply."""
        dst, src = env & 1, (env >> 1) & 1
        kind, value = (env >> 2) & 1, env >> 3
        count = torch.where(dst == 0, body[:, 0], body[:, 1])
        handled = count == value
        pong = kind == _PONG
        reply = ((torch.where(pong, value + 1, value) << 3)
                 | (torch.where(pong, _PING, _PONG) << 2) | (dst << 1)
                 | src) & M32
        bumped = (count + 1) & M32
        lanes = [torch.where(dst == 0, bumped, body[:, 0]),
                 torch.where(dst == 1, bumped, body[:, 1])]
        if self.maintains_history:
            lanes += [(body[:, 2] + 1) & M32, (body[:, 3] + 1) & M32]
        else:
            lanes += [body[:, 2], body[:, 3]]
        new_body = torch.stack(lanes, dim=1)
        outs = torch.where(handled, reply, EMPTY_ENV)[:, None]
        return new_body, handled, outs

    # -- Boundary and properties (actor_test_util.rs:60-95) -------------------

    def boundary(self, rows):
        m = self.max_nat
        return (rows[:, 0] <= m) & (rows[:, 1] <= m)

    def device_properties(self):
        m = self.max_nat

        def reach(rows, k):
            return (rows[:, 0] == k) | (rows[:, 1] == k)

        # The history properties hold trivially without a history, whose
        # lanes stay (0, 0), as the host model's constant history does.
        return {
            "delta within 1": lambda r: (r[:, 0] - r[:, 1]).abs() <= 1,
            "can reach max": lambda r: reach(r, m),
            "must reach max": lambda r: reach(r, m),
            "must exceed max": lambda r: reach(r, m + 1),
            "#in <= #out": lambda r: r[:, 2] <= r[:, 3],
            "#out <= #in + 1": lambda r: r[:, 3] <= (r[:, 2] + 1) & M32,
        }
