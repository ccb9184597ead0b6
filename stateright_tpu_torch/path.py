"""Paths through a model's state graph, rebuilt from fingerprints.

The port's copy of ``stateright_tpu/checker/path.py``. An engine keeps
only fingerprints and parent fingerprints; a ``Path`` is rebuilt by
replaying the model along the chain. A chain that cannot be replayed
means the model is not deterministic. Two replays:

- on the host (``from_fingerprints``, the host BFS's): from the init
  state whose host ``fingerprint`` is the first, follow the successor
  (``next_steps``) whose fingerprint is the next;
- on the device form (``from_device_fingerprints``, the device
  engines'): from the init state whose encoding has the first
  ``host_fp64``, step the row with the device model's own ``step`` (a
  batch of one, on the CPU) and follow the successor whose ``host_fp64``
  is the next.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from .fingerprint import fingerprint
from .hashing import host_fp64
from .model import _fmt

__all__ = ["Path", "NondeterminismError"]


class NondeterminismError(RuntimeError):
    """A fingerprint chain could not be replayed against the model."""


_INIT_MSG = """\
Unable to reconstruct a `Path` from fingerprints of states visited earlier. No
init state has the expected fingerprint ({fp}). This usually happens when the
return value of `Model.init_states` varies between calls.

The most obvious cause is a model that reads untracked external state such as
the file system, a global mutable, or a source of randomness (including
iteration order of an unordered container with unstable ordering).

Available init fingerprints (none of which match): {available}"""

_NEXT_MSG = """\
Unable to reconstruct a `Path` from fingerprints of states visited earlier.
{n} previous state(s) of the path were reconstructed, but no subsequent state
has the next fingerprint ({fp}). This usually happens when `Model.actions` or
`Model.next_state` vary even when given the same input arguments.

The most obvious cause is a model that reads untracked external state such as
the file system, a global mutable, or a source of randomness (including
iteration order of an unordered container with unstable ordering).

Available next fingerprints (none of which match): {available}"""


class Path:
    """A list of ``(state, action-or-None)`` pairs (the last action is
    ``None``), with the fingerprints it was rebuilt from and, on the
    device form, the encoded rows."""

    __slots__ = ("_pairs", "vecs", "fingerprints")

    def __init__(self, pairs: List[Tuple], vecs: Optional[List] = None,
                 fingerprints: Optional[List[int]] = None):
        self._pairs = list(pairs)
        #: the encoded state rows, uint32[W] each (device replays only)
        self.vecs = vecs
        #: the fingerprint of each state: the host ``fingerprint`` on a
        #: host replay, the device ``host_fp64`` on a device one
        self.fingerprints = fingerprints

    @staticmethod
    def from_fingerprints(model, fingerprints: Iterable[int]) -> "Path":
        """Replays ``model``'s host transitions along ``fingerprints``
        (each state's host ``fingerprint``)."""
        fps = [int(f) for f in fingerprints]
        if not fps:
            raise NondeterminismError("empty path is invalid")
        init_fp, rest = fps[0], fps[1:]
        last_state = None
        for s in model.init_states():
            if fingerprint(s) == init_fp:
                last_state = s
                break
        else:
            raise NondeterminismError(_INIT_MSG.format(
                fp=init_fp,
                available=[fingerprint(s) for s in model.init_states()]))
        pairs: List[Tuple] = []
        for next_fp in rest:
            for action, next_state in model.next_steps(last_state):
                if fingerprint(next_state) == next_fp:
                    pairs.append((last_state, action))
                    last_state = next_state
                    break
            else:
                raise NondeterminismError(_NEXT_MSG.format(
                    n=1 + len(pairs), fp=next_fp,
                    available=[fingerprint(s)
                               for s in model.next_states(last_state)]))
        pairs.append((last_state, None))
        return Path(pairs, fingerprints=fps)

    @staticmethod
    def from_actions(model, init_state, actions: Iterable
                     ) -> Optional["Path"]:
        """Replays ``model`` from ``init_state`` along ``actions``;
        ``None`` where an action is not enabled along the way."""
        if not any(s == init_state for s in model.init_states()):
            return None
        pairs: List[Tuple] = []
        prev_state = init_state
        for action in actions:
            for candidate, next_state in model.next_steps(prev_state):
                if candidate == action:
                    pairs.append((prev_state, candidate))
                    prev_state = next_state
                    break
            else:
                return None
        pairs.append((prev_state, None))
        return Path(pairs)

    @staticmethod
    def final_state(model, fingerprints: Iterable[int]):
        """The last state of a host fingerprint chain, or ``None``."""
        fps = list(fingerprints)
        if not fps:
            return None
        matching = next((s for s in model.init_states()
                         if fingerprint(s) == fps[0]), None)
        if matching is None:
            return None
        for next_fp in fps[1:]:
            matching = next((s for s in model.next_states(matching)
                             if fingerprint(s) == next_fp), None)
            if matching is None:
                return None
        return matching

    @staticmethod
    def from_device_fingerprints(model, fingerprints: Iterable[int], dm,
                                 known: Optional[dict] = None) -> "Path":
        """Replays the device model ``dm`` along a device fingerprint
        chain. ``known``, where given, maps each fingerprint already
        replayed along the same parent links to ``(row, action into
        it)``: those states are taken from it, not stepped, and every
        state stepped to here is added, so replays that share a prefix
        step it once."""
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

    def into_vec(self) -> list:
        return list(self._pairs)

    def encode(self) -> str:
        """The path as ``/``-joined host fingerprints of its states."""
        return "/".join(str(fingerprint(s)) for s, _ in self._pairs)

    def __len__(self) -> int:
        return len(self._pairs)

    def __iter__(self):
        return iter(self._pairs)

    def __eq__(self, other) -> bool:
        return isinstance(other, Path) and self._pairs == other._pairs

    def __hash__(self) -> int:
        return hash(tuple((fingerprint(s),
                           fingerprint(a) if a is not None else 0)
                          for s, a in self._pairs))

    def __repr__(self) -> str:
        return f"Path({self._pairs!r})"

    def __str__(self) -> str:
        lines = [f"Path[{len(self._pairs) - 1}]:"]
        lines += [f"- {_fmt(a)}" for _, a in self._pairs if a is not None]
        return "\n".join(lines) + "\n"
