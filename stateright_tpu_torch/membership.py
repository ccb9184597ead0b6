"""Which shard owns a fingerprint.

The port's copy of the part of ``stateright_tpu/resilience/membership.py``
that the sharded engine reads: ``OwnerMap`` (:53) at its identity
assignment, with its epoch, and the engine's ``_owner`` (``EpochOwnership``
:164; here ``_owners``, over a numpy array). Partition ``p`` of the
fingerprint space is ``fp % n``; shard ``assignment()[p]`` owns it. The
engine's dispatch takes the assignment as a tensor whenever the map is
not the identity, so a later remap needs no change to the wave.
Remapping itself (``with_assignment``, ``set_owner_assignment``) belongs
to the elastic layer and is not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np

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
    """Mixin: the engine's ``_owners`` over ``self._owner_map``."""

    def _owners(self, fps: np.ndarray) -> np.ndarray:
        """The shard owning each ``uint64`` fingerprint of ``fps`` under
        the current epoch's assignment, vectorised (the reference's
        ``_owner`` a fingerprint at a time)."""
        assign = np.asarray(self._owner_map.assignment(), np.int64)
        return assign[(fps % np.uint64(self._owner_map.n_partitions))
                      .astype(np.int64)]
