"""The device mesh of the sharded engine, driven from one process.

The port's counterpart of ``stateright_tpu/tpu/_compat.py::shard_map``
and the ``Mesh``/``NamedSharding`` plumbing of
``stateright_tpu/tpu/sharded_fused.py``. JAX runs one program a shard
under ``shard_map`` from a single controller; the port keeps that design
and stores the shards that share a device **stacked** along a leading
shard axis, the JAX flat ``[n * cap]`` layout reshaped to ``[n, cap]``.
The collectives of a shard's program then become operations on that
axis:

- ``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)`` is a
  transpose of the shard axis with the destination blocks
  (``all_to_all``);
- ``psum``, ``pmax`` and ``all_gather`` are a sum, a max and the
  stacked tensor itself, over dim 0.

A mesh over distinct devices (one shard a card, with peer copies or
NCCL for the exchange) is not ported yet (ROADMAP A14) and raises.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["Mesh"]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """``n`` shards on one device, stacked along dim 0 of every sharded
    tensor."""

    def __init__(self, devices: Sequence):
        devices = [_device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if any(d != devices[0] for d in devices):
            raise NotImplementedError(
                f"a mesh over distinct devices {[str(d) for d in devices]} "
                "is not ported yet (ROADMAP A14): the port stacks the "
                "shards of one device; pass the same device n times")
        self.devices = devices
        self.n = len(devices)
        self.device = devices[0]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``[n_src, n_dst * CAP, ...] -> [n_dst, n_src * CAP, ...]``:
        block ``d`` of source ``s`` becomes block ``s`` of destination
        ``d``."""
        n = self.n
        rest = x.shape[2:]
        cap = x.shape[1] // n
        return (x.reshape((n, n, cap) + rest).transpose(0, 1)
                .reshape((n, n * cap) + rest))

    @staticmethod
    def psum(x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0)

    @staticmethod
    def pmax(x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=0)

    @staticmethod
    def all_gather(x: torch.Tensor) -> torch.Tensor:
        """Every shard's value, ``[n, ...]``: the stacked tensor."""
        return x

    def __repr__(self) -> str:
        return f"Mesh(n={self.n}, device={self.device})"
