"""Which shard owns a fingerprint.

The port's copy of the part of ``stateright_tpu/resilience/membership.py``
that the sharded engine reads: ``OwnerMap`` (:53) at its identity
assignment, with its epoch, and the engine's ``_owner`` (``EpochOwnership``
:164; here ``_owners``, over a numpy array). Partition ``p`` of the
fingerprint space is ``fp % n``; shard ``assignment()[p]`` owns it. The
engine's dispatch takes the assignment as a tensor whenever the map is
not the identity, so a later remap needs no change to the wave.
``EpochOwnership`` also builds and rehashes the stacked table both
sharded engines share, each shard's slice holding the fingerprints it
owns. Remapping itself (``with_assignment``, ``set_owner_assignment``) belongs
to the elastic layer and is not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .engine import host_table_insert
from .hashing import SENTINEL, SENTINEL_U64

__all__ = ["OwnerMap", "EpochOwnership"]


class OwnerMap:
    """An immutable epoch-versioned partition -> owner assignment."""

    __slots__ = ("n_partitions", "epoch", "_assign")

    def __init__(self, n_partitions: int, assignment: List[int],
                 epoch: int = 0):
        if n_partitions < 1:
            raise ValueError("n_partitions must be >= 1")
        if len(assignment) != n_partitions:
            raise ValueError(f"assignment covers {len(assignment)} "
                             f"partitions, expected {n_partitions}")
        self.n_partitions = int(n_partitions)
        self.epoch = int(epoch)
        self._assign = [int(a) for a in assignment]

    @classmethod
    def identity(cls, n: int) -> "OwnerMap":
        """Partition ``p`` owned by shard ``p``."""
        return cls(n, list(range(n)))

    @property
    def is_identity(self) -> bool:
        """Whether routing is the raw modulo (no gather)."""
        return self._assign == list(range(self.n_partitions))

    def partition_of(self, fp: int) -> int:
        """The partition of a uint64 fingerprint."""
        return int(fp) % self.n_partitions

    def owner(self, fp: int) -> int:
        return self._assign[self.partition_of(fp)]

    def assignment(self) -> List[int]:
        return list(self._assign)

    def __repr__(self) -> str:
        return f"OwnerMap(n={self.n_partitions}, epoch={self.epoch})"


class EpochOwnership:
    """Mixin of the sharded engines: ``_owners`` over ``self._owner_map``,
    and the stacked table ``int64[_n, _capacity]`` on ``_device``, each
    slice built and rehashed as the unsharded engines build their table
    (``_insert_chunked``)."""

    def _owners(self, fps: np.ndarray) -> np.ndarray:
        """The shard owning each ``uint64`` fingerprint of ``fps`` under
        the current epoch's assignment, vectorised (the reference's
        ``_owner`` a fingerprint at a time)."""
        assign = np.asarray(self._owner_map.assignment(), np.int64)
        return assign[(fps % np.uint64(self._owner_map.n_partitions))
                      .astype(np.int64)]

    def _table_bytes(self, capacity: int) -> int:
        """Every shard's slice (JAX's ``tpu/sharded.py`` :192-194 and
        ``tpu/sharded_fused.py`` :120-122)."""
        return self._n * capacity * 8

    def _stacked_table(self, visited: np.ndarray, resumed: bool):
        """The stacked table holding the ``uint64`` fingerprints
        ``visited``, and each shard's occupancy (``int64[n]``): shard
        ``i``'s slice holds the fingerprints it owns (JAX's
        ``_new_table``, ``tpu/sharded.py`` :138-156); the seeds are
        inserted on the host, a resumed visited set by the dedup kernel in
        strided chunks."""
        n, cap, device = self._n, self._capacity, self._device
        owner = self._owners(visited)
        occs = np.bincount(owner, minlength=n).astype(np.int64)
        if not resumed:
            table = np.full((n, cap), SENTINEL_U64, np.uint64)
            for i in range(n):
                host_table_insert(table[i], visited[owner == i])
            return torch.from_numpy(table.view(np.int64)).to(device), occs
        table = torch.full((n, cap), SENTINEL, dtype=torch.int64,
                           device=device)
        full = torch.stack([self._insert_chunked(torch.from_numpy(
            visited[owner == i].view(np.int64)).to(device), table[i])
            for i in range(n)]).any()
        if bool(full):
            raise RuntimeError("the resumed visited set found no free slot")
        return table, occs

    def _rehash(self, capacity: int) -> torch.Tensor:
        """The stacked table rehashed into ``capacity`` slots a shard,
        each slice through the dedup kernel in strided chunks with the
        engine's scratch (in place of the unsharded engine's
        ``_rehash``)."""
        new = torch.full((self._n, capacity), SENTINEL, dtype=torch.int64,
                         device=self._table.device)
        full = torch.stack([self._insert_chunked(self._table[k], new[k])
                            for k in range(self._n)]).any()
        if bool(full):
            raise RuntimeError("rehash found no free slot")
        return new
