"""The sliding-tile puzzle: the host model and its device form.

The port's copy of ``examples/sliding_puzzle.py`` (``SlidingPuzzle`` and
``PuzzleDevice``): a ``rows x cols`` board, one lane a cell holding its
tile (the blank is 0), from a fixed scrambled start. A board reaches
exactly the even permutations, so the full space is ``(rows * cols)! /
2`` states: 360 at 2x3, 181,440 at 3x3 and 239,500,800 at 4x3. ``sometimes
"solved"`` finds a shortest solution under BFS, and on odd-column boards
``always "even permutation"`` pins the parity invariant, so a run goes
to its end.

The rows are stored unpacked (no ``lane_bits``: 32 bits a lane), as
JAX's are, so checkpoints stay byte-equal to JAX's. Its CUDA device code
(``cuda_model()``) is ``csrc/models/sliding_puzzle.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device_model import DeviceModel
from ..model import Model, Property

__all__ = ["MOVES", "SlidingPuzzle", "PuzzleDevice"]

#: the four moves of the blank, in the host's action order (the device's
#: slot order)
MOVES = ("up", "down", "left", "right")
_DELTA = {"up": (-1, 0), "down": (1, 0), "left": (0, -1), "right": (0, 1)}


def _is_even_permutation(tiles) -> bool:
    perm = [t for t in tiles if t != 0]
    inversions = sum(1 for i in range(len(perm))
                     for j in range(i + 1, len(perm)) if perm[i] > perm[j])
    return inversions % 2 == 0


class SlidingPuzzle(Model):
    """``rows x cols`` sliding puzzle from a fixed scrambled start."""

    def __init__(self, rows: int = 2, cols: int = 3):
        self.rows = rows
        self.cols = cols
        n = rows * cols
        # An even permutation (reachable from solved): three tiles of the
        # solved board rotated.
        tiles = list(range(n))
        tiles[1], tiles[2], tiles[n - 1] = tiles[2], tiles[n - 1], tiles[1]
        self._start = tuple(tiles)
        self._solved = tuple(range(n))

    def init_states(self):
        return [self._start]

    def actions(self, state, actions):
        actions += list(MOVES)

    def next_state(self, state, action):
        r, c = divmod(state.index(0), self.cols)
        dr, dc = _DELTA[action]
        nr, nc = r + dr, c + dc
        if not (0 <= nr < self.rows and 0 <= nc < self.cols):
            return None  # off the board: the action is ignored
        t = list(state)
        i, j = r * self.cols + c, nr * self.cols + nc
        t[i], t[j] = t[j], t[i]
        return tuple(t)

    def properties(self):
        props = [Property.sometimes(
            "solved", lambda model, s: s == model._solved)]
        if self.cols % 2 == 1:
            # A vertical move hops the tile over cols - 1 neighbours, so
            # the tiles' parity is conserved exactly when cols is odd.
            props.append(Property.always(
                "even permutation",
                lambda model, s: _is_even_permutation(s)))
        return props

    def format_action(self, action):
        return f"slide blank {action}"

    def device_model(self) -> "PuzzleDevice":
        return PuzzleDevice(self.rows, self.cols)


class PuzzleDevice(DeviceModel):
    """One uint32 lane a cell; four slots a row (``MOVES``), a move off
    the board invalid. An invalid slot holds what JAX's does: the blank
    swapped with the clamped cell index."""

    #: the (rows, cols) boards that ``csrc/wave_sliding_puzzle.cu`` holds:
    #: every board of 2 to 16 cells (instances at capacities of 4, 6, 9, 12
    #: and 16 cells, the board at run time)
    CUDA_INSTANCES = tuple((r, c) for r in range(1, 17)
                           for c in range(1, 17) if 2 <= r * c <= 16)

    def __init__(self, rows: int, cols: int):
        self.rows = rows
        self.cols = cols
        self.state_width = rows * cols
        self.max_fanout = len(MOVES)

    def cuda_model(self):
        """``csrc/models/sliding_puzzle.cuh`` on this board. Raises for a
        board it holds no instance of (one of more than 16 cells)."""
        board = (self.rows, self.cols)
        if board not in self.CUDA_INSTANCES:
            raise NotImplementedError(
                f"csrc/wave_sliding_puzzle.cu has no instance at "
                f"{self.rows}x{self.cols} (it holds every board of 2 to 16 "
                "cells): run it with wave_kernel=False on the card")
        return "sliding_puzzle", (self.rows, self.cols)

    def action_names(self):
        return list(MOVES)

    # -- Codec -----------------------------------------------------------

    def encode(self, state) -> np.ndarray:
        return np.asarray(state, np.uint32)

    def decode(self, vec: np.ndarray):
        return tuple(int(v) for v in vec)

    # -- Step ------------------------------------------------------------

    def step(self, rows: torch.Tensor):
        R, C, n = self.rows, self.cols, self.state_width
        B = rows.shape[0]
        blank = (rows == 0).to(torch.int32).argmax(dim=1)  # the first 0
        r, c = blank // C, blank % C
        # Each move's row and column steps, made on the device (a tensor
        # from the host would be a copy): up, down, left, right.
        f = torch.arange(4, device=rows.device)
        dr = torch.where(f < 2, 2 * f - 1, 0)
        dc = torch.where(f < 2, 0, 2 * f - 5)
        nr, nc = r[:, None] + dr, c[:, None] + dc
        valid = (nr >= 0) & (nr < R) & (nc >= 0) & (nc < C)
        j = (nr * C + nc).clamp(0, n - 1)  # [B, 4]
        succ = rows[:, None, :].expand(B, 4, n).clone()
        tile = torch.gather(rows, 1, j)
        succ.scatter_(2, blank[:, None, None].expand(B, 4, 1),
                      tile[..., None])
        succ.scatter_(2, j[..., None], torch.zeros_like(tile)[..., None])
        return succ, valid

    # -- Properties ------------------------------------------------------

    def device_properties(self):
        n = self.state_width

        def solved(rows):
            return (rows == torch.arange(n, device=rows.device)).all(dim=1)

        def even_permutation(rows):
            i, j = torch.triu_indices(n, n, offset=1, device=rows.device)
            a, b = rows[:, i], rows[:, j]
            inv = ((a > b) & (a != 0) & (b != 0)).sum(dim=1)
            return inv % 2 == 0

        props = {"solved": solved}
        if self.cols % 2 == 1:
            props["even permutation"] = even_permutation
        return props
