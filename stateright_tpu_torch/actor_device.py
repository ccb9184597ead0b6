"""The device form of actor systems: a slot-list network and the step.

The port's copy of ``stateright_tpu/tpu/actor_device.py``, batch-first.

- **Network.** The host's set of in-flight envelopes is a sorted list of
  ``net_slots`` encoded envelopes (uint32 values in int64 lanes), padded
  with ``EMPTY_ENV`` (all-ones, which sorts last). Sorted and unique is a
  canonical form of the set, so equal sets encode equally. A delivery's
  sends go in at their rank (the count of smaller envelopes), shifting
  the tail right; a send into a full list sets the overflow lane at
  ``net_offset + net_slots``, which is the model's ``error_lane``, and the
  engine raises (raise ``net_slots``).
- **Network forms** (the reference's ``actor/model.rs:54-55, 240-266``).
  On a duplicating network (the default) a delivered envelope stays in
  the list, so it can be delivered again; on one that does not
  duplicate it leaves the list (a shift left past its slot). A lossy
  network adds a Drop action an envelope, which removes it and changes
  nothing else.
- **Actions**, in the host model's order: for each slot, its Drop (lossy
  only) and then its Deliver, interleaved ``[drop0, deliver0, drop1,
  deliver1, ...]``; then one Timeout a timer actor (``n_timers`` of them,
  the armed-timer bitmask in lane ``timer_offset``, below
  ``net_offset``). So ``max_fanout == net_slots * (1 + lossy) +
  n_timers``; an empty slot and a disarmed timer are no action.
- **No-op elision.** The model's ``deliver`` and ``timeout`` return a
  ``handled`` flag that mirrors the host handler's "return None"
  branches; an action that is not handled is no action, even where its
  successor would differ.

All ``B * net_slots`` deliveries of a batch run at once along one row
axis: the model's ``deliver`` sees ``body[N, net_offset]`` and
``env[N]`` with ``N = B * net_slots`` (row ``b * net_slots + f``), and
its ``timeout`` sees ``body[B * n_timers, net_offset]`` and the actor of
each row; there is no loop over slots. Lane arithmetic is the uint32
arithmetic of the reference: values stay in ``[0, 2^32)``, and a result
that can wrap is masked with ``M32``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .actor import DeliverAction, DropAction, Id, TimeoutAction
from .device_model import DeviceModel

__all__ = ["EMPTY_ENV", "M32", "ActorDeviceModel", "compact_envs",
           "net_remove_at", "net_insert"]

#: an empty network slot: all-ones, so real (smaller) envelopes sort first
EMPTY_ENV = 0xFFFFFFFF
#: the uint32 mask that keeps wrapped lane arithmetic equal to the
#: reference's
M32 = 0xFFFFFFFF


def compact_envs(envs: torch.Tensor, k: int) -> torch.Tensor:
    """The first ``k`` envelopes of each row of ``envs int64[N, n]`` that
    are not ``EMPTY_ENV``, in their order, padded with ``EMPTY_ENV``:
    ``int64[N, k]``. A cumsum and a scatter, as JAX's
    ``actor_device.py::compact_envs``; a sort is not needed."""
    n = envs.shape[0]
    nonempty = envs != EMPTY_ENV
    rank = nonempty.cumsum(dim=1) - 1
    slot = torch.where(nonempty & (rank < k), rank, k)
    out = torch.full((n, k + 1), EMPTY_ENV, dtype=envs.dtype,
                     device=envs.device)
    return out.scatter_(1, slot, torch.where(slot < k, envs, EMPTY_ENV))[
        :, :k]


def net_remove_at(net: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``net int64[N, E]`` without the envelope at ``slot int64[N]``, the
    rest shifted left: the list stays sorted."""
    idx = torch.arange(net.shape[1], device=net.device)
    nxt = torch.cat([net[:, 1:], torch.full_like(net[:, :1], EMPTY_ENV)],
                    dim=1)
    return torch.where(idx < slot[:, None], net, nxt)


def net_insert(net: torch.Tensor, outs: torch.Tensor):
    """Inserts each row's sends ``outs int64[N, K]`` (``EMPTY_ENV`` means
    none) into its sorted list ``net int64[N, E]``, once each: ``(net,
    overflow bool[N])``. A send into a full list drops the largest
    envelope and sets ``overflow``."""
    e = net.shape[1]
    idx = torch.arange(e, device=net.device)
    overflow = torch.zeros(net.shape[0], dtype=torch.bool, device=net.device)
    for j in range(outs.shape[1]):
        env = outs[:, j:j + 1]
        skip = (env == EMPTY_ENV) | (net == env).any(dim=1, keepdim=True)
        overflow = overflow | (~skip[:, 0] & (net[:, e - 1] != EMPTY_ENV))
        pos = (net < env).sum(dim=1, keepdim=True)
        prev = torch.cat([net[:, :1], net[:, :-1]], dim=1)
        shifted = torch.where(idx < pos, net,
                              torch.where(idx == pos, env, prev))
        net = torch.where(skip, net, shifted)
    return net, overflow


class ActorDeviceModel(DeviceModel):
    """The device form of an actor system (``ActorModel``).

    A subclass sets ``net_slots`` (E), ``net_offset`` (the first network
    lane; the lane after the E network lanes is the overflow flag),
    ``max_out`` (sends an action), the network form (``duplicating``,
    ``lossy``) and its timers (``n_timers``, ``timer_offset``), and
    implements ``deliver(body int64[N, net_offset], env int64[N]) ->
    (new_body, handled bool[N], outs int64[N, max_out])`` (``EMPTY_ENV`` =
    no send), with timers ``timeout(body, actor int64[N])`` of the same
    form, and the host codec ``env_encode``/``env_decode``."""

    net_slots: int
    net_offset: int
    max_out: int
    duplicating: bool = True
    lossy: bool = False
    n_timers: int = 0
    timer_offset: int = -1

    @property
    def max_fanout(self) -> int:  # type: ignore[override]
        return self.net_slots * (2 if self.lossy else 1) + self.n_timers

    def deliver(self, body: torch.Tensor, env: torch.Tensor):
        raise NotImplementedError

    def timeout(self, body: torch.Tensor, actor: torch.Tensor):
        raise NotImplementedError

    def step(self, rows: torch.Tensor):
        """Every action of every row: ``int64[B, W] -> (int64[B, F, W],
        bool[B, F])``, in the order of the module docstring."""
        e, off = self.net_slots, self.net_offset
        B, W = rows.shape
        N = B * e
        body = rows[:, None, :off].expand(B, e, off).reshape(N, off)
        net = rows[:, None, off:off + e].expand(B, e, e).reshape(N, e)
        err = rows[:, None, off + e].expand(B, e).reshape(N)
        env = rows[:, off:off + e].reshape(N)
        present = env != EMPTY_ENV
        new_body, handled, outs = self.deliver(body, env)
        removed = None
        if self.lossy or not self.duplicating:
            slot = torch.arange(e, device=rows.device).repeat(B)
            removed = net_remove_at(net, slot)
        new_net, overflow = net_insert(
            net if self.duplicating else removed, outs)
        new_err = torch.where(overflow, 1, err)
        succ = torch.cat([new_body, new_net, new_err[:, None]], dim=1)
        succ, valid = succ.view(B, e, W), (present & handled).view(B, e)
        if self.lossy:
            dropped = torch.cat([body, removed, err[:, None]], dim=1)
            succ = torch.stack([dropped.view(B, e, W), succ],
                               dim=2).view(B, 2 * e, W)
            valid = torch.stack([present.view(B, e), valid],
                                dim=2).view(B, 2 * e)
        if self.n_timers:
            t_succ, t_valid = self._timeouts(rows)
            succ = torch.cat([succ, t_succ], dim=1)
            valid = torch.cat([valid, t_valid], dim=1)
        return succ, valid

    def _timeouts(self, rows: torch.Tensor):
        """Each timer actor's Timeout for every row: ``(int64[B, T, W],
        bool[B, T])``; the sends go in as a delivery's, and nothing leaves
        the network."""
        e, off, T = self.net_slots, self.net_offset, self.n_timers
        B, W = rows.shape
        N = B * T
        body = rows[:, None, :off].expand(B, T, off).reshape(N, off)
        net = rows[:, None, off:off + e].expand(B, T, e).reshape(N, e)
        err = rows[:, None, off + e].expand(B, T).reshape(N)
        actor = torch.arange(T, device=rows.device).repeat(B)
        armed = ((body[:, self.timer_offset] >> actor) & 1) == 1
        new_body, handled, outs = self.timeout(body, actor)
        new_net, overflow = net_insert(net, outs)
        new_err = torch.where(overflow, 1, err)
        succ = torch.cat([new_body, new_net, new_err[:, None]], dim=1)
        return succ.view(B, T, W), (armed & handled).view(B, T)

    def action_label(self, vec: np.ndarray, f: int):
        """Action ``f`` of ``vec``: the Drop or the Deliver of a slot's
        envelope, or an actor's Timeout."""
        lossy = int(self.lossy)
        if f >= self.net_slots * (1 + lossy):
            return TimeoutAction(Id(f - self.net_slots * (1 + lossy)))
        env = self.env_decode(int(vec[self.net_offset + (f >> lossy)]))
        if lossy and f % 2 == 0:
            return DropAction(env)
        return DeliverAction(env.src, env.dst, env.msg)

    # -- Host-side network codec -------------------------------------------

    def env_encode(self, envelope) -> int:
        raise NotImplementedError

    def env_decode(self, code: int):
        raise NotImplementedError

    def encode_network(self, network) -> np.ndarray:
        """The network lanes and the overflow lane (0) of ``network``."""
        codes = sorted(self.env_encode(env) for env in network)
        if len(codes) > self.net_slots:
            raise ValueError(
                f"network has {len(codes)} in-flight envelopes; the device "
                f"encoding bounds it at net_slots={self.net_slots}")
        out = np.full(self.net_slots + 1, EMPTY_ENV, np.uint32)
        out[:len(codes)] = codes
        out[self.net_slots] = 0
        return out

    def decode_network(self, lanes: np.ndarray) -> List:
        if int(lanes[self.net_slots]) != 0:
            raise RuntimeError(
                "device network overflow: a state exceeded net_slots "
                f"({self.net_slots}) in-flight envelopes; re-run with a "
                "larger bound")
        return [self.env_decode(int(c)) for c in lanes[:self.net_slots]
                if c != EMPTY_ENV]
