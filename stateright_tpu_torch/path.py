"""Paths through a model's state graph, rebuilt from fingerprints.

The port's copy of ``stateright_tpu/checker/path.py``. The engine keeps
only fingerprints and parent fingerprints; a ``Path`` is rebuilt by
replaying the model along the chain: from the init state whose encoding
has the first fingerprint, step the row with the device model's own
``step`` (a batch of one, on the CPU) and follow the successor whose
``host_fp64`` is the next fingerprint. A chain that cannot be replayed
means the model is not deterministic.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from .hashing import host_fp64

__all__ = ["Path", "NondeterminismError"]


class NondeterminismError(RuntimeError):
    """A fingerprint chain could not be replayed against the model."""


class Path:
    """A list of ``(state, action-or-None)`` pairs (the last action is
    ``None``), with the encoded rows and fingerprints it was rebuilt
    from."""

    __slots__ = ("_pairs", "vecs", "fingerprints")

    def __init__(self, pairs: List[Tuple], vecs: List[np.ndarray],
                 fingerprints: List[int]):
        self._pairs = pairs
        #: the encoded state rows, uint32[W] each
        self.vecs = vecs
        #: the uint64 fingerprint of each state
        self.fingerprints = fingerprints

    @staticmethod
    def from_fingerprints(model, fingerprints: Iterable[int], dm=None,
                          known: Optional[dict] = None) -> "Path":
        """``known``, where given, maps each fingerprint already replayed
        along the same parent links to ``(row, action into it)``: those
        states are taken from it, not stepped, and every state stepped to
        here is added, so replays that share a prefix step it once."""
        dm = dm if dm is not None else model.device_model()
        fps = [int(f) for f in fingerprints]
        if not fps:
            raise NondeterminismError("empty path is invalid")
        inits = [np.asarray(dm.encode(s), np.uint32)
                 for s in model.init_states()]
        vec = next((v for v in inits if host_fp64(v) == fps[0]), None)
        if vec is None:
            raise NondeterminismError(
                f"no init state has the fingerprint {fps[0]}; available: "
                f"{[host_fp64(v) for v in inits]}")
        vecs, actions = [vec], []
        for fp in fps[1:]:
            hit = None if known is None else known.get(fp)
            if hit is None:
                hit = Path._step_to(dm, vec, fp, len(vecs))
                if known is not None:
                    known[fp] = hit
            vec, action = hit
            actions.append(action)
            vecs.append(vec)
        pairs = [(dm.decode(v), a) for v, a in zip(vecs, actions + [None])]
        return Path(pairs, vecs, fps)

    @staticmethod
    def _step_to(dm, vec: np.ndarray, fp: int, replayed: int) -> Tuple:
        """The successor of ``vec`` with the fingerprint ``fp``, and the
        action to it."""
        succ, valid = dm.step(torch.from_numpy(vec.astype(np.int64))[None])
        succ = succ[0].numpy().astype(np.uint32)
        for f in np.flatnonzero(valid[0].numpy()):
            if host_fp64(succ[f]) == fp:
                return succ[f], dm.action_label(vec, int(f))
        raise NondeterminismError(
            f"{replayed} state(s) of the path were replayed, but no "
            f"successor has the next fingerprint ({fp})")

    def last_state(self):
        return self._pairs[-1][0]

    def into_states(self) -> list:
        return [s for s, _ in self._pairs]

    def into_actions(self) -> list:
        return [a for _, a in self._pairs if a is not None]

    def __repr__(self) -> str:
        return f"Path({self._pairs!r})"

    def __str__(self) -> str:
        lines = [f"Path[{len(self._pairs) - 1}]:"]
        lines += [f"- {a!r}" for _, a in self._pairs if a is not None]
        return "\n".join(lines) + "\n"
