"""Deterministic toy models for the port's tests and card gates.

The port's copy of ``stateright_tpu/test_util.py``, after the reference's
``src/test_util.rs``:

- ``BinaryClock``, a machine that cycles between two states;
- ``DGraph``, a directed graph given by paths from its initial states,
  whose device form is a dense successor table (it pins the engines'
  eventually-bit semantics, and the differential fuzz runs random ones);
- ``FnModel``, a model given by one function;
- ``LinearEquation``, which looks for u8 ``x, y`` with ``a*x + b*y = c
  (mod 256)``: 65,536 states at full coverage, and a short ``solvable``
  chain when there is a solution.

Each has its host transitions, for the host BFS. ``BinaryClock`` and
``FnModel`` have no device form; the others' CUDA steps
(``cuda_model()``) are ``csrc/models/dgraph.cuh`` and
``csrc/models/linear_equation.cuh``.
"""

from __future__ import annotations

import random
from enum import Enum
from typing import Callable, Dict, List, Optional, Set

import numpy as np
import torch

from .device_model import DeviceModel
from .model import Model, Property

__all__ = ["BinaryClock", "BinaryClockAction", "DGraph", "DGraphDevice",
           "FnModel", "Guess", "LinearEquation", "LinearEquationDevice",
           "random_graph"]


class BinaryClockAction(Enum):
    GO_LOW = 0
    GO_HIGH = 1


class BinaryClock(Model):
    """A machine that cycles between two states (``test_util.rs:4-46``)."""

    def init_states(self):
        return [0, 1]

    def actions(self, state, actions):
        actions.append(BinaryClockAction.GO_HIGH if state == 0
                       else BinaryClockAction.GO_LOW)

    def next_state(self, state, action):
        return 1 if action is BinaryClockAction.GO_HIGH else 0

    def properties(self):
        return [Property.always("in [0, 1]",
                                lambda _, state: 0 <= state <= 1)]


class DGraph(Model):
    """A directed graph specified via paths from initial states
    (``test_util.rs:49-117``). Its properties' device predicates
    (``rows[B, 1] -> bool[B]`` on the node id) are attached with
    :meth:`with_device_predicate`."""

    def __init__(self, property: Property,
                 inits: Optional[Set[int]] = None,
                 edges: Optional[Dict[int, Set[int]]] = None,
                 device_preds: Optional[Dict[str, Callable]] = None):
        self._property = property
        self._inits: Set[int] = inits or set()
        self._edges: Dict[int, Set[int]] = edges or {}
        self._device_preds = device_preds or {}

    @staticmethod
    def with_property(property: Property) -> "DGraph":
        return DGraph(property)

    def with_path(self, path: List[int]) -> "DGraph":
        inits = set(self._inits)
        inits.add(path[0])
        edges = {k: set(v) for k, v in self._edges.items()}
        src = path[0]
        for dst in path[1:]:
            edges.setdefault(src, set()).add(dst)
            src = dst
        return DGraph(self._property, inits, edges, self._device_preds)

    def with_device_predicate(self, name: str, fn) -> "DGraph":
        preds = dict(self._device_preds)
        preds[name] = fn
        return DGraph(self._property, self._inits, self._edges, preds)

    def with_property_of(self, property: Property) -> "DGraph":
        """The same graph and predicates under another property."""
        return DGraph(property, self._inits, self._edges, self._device_preds)

    def check(self):
        """The host BFS of this graph, joined."""
        return self.checker().spawn_bfs().join()

    def init_states(self):
        return sorted(self._inits)

    def actions(self, state, actions):
        actions.extend(sorted(self._edges.get(state, ())))

    def next_state(self, state, action):
        return action

    def properties(self):
        return [self._property]

    def device_model(self) -> "DGraphDevice":
        return DGraphDevice(self)


def random_graph(rng: random.Random, pred_name: str, pred) -> DGraph:
    """A random graph of 4 to 12 nodes along 2 to 4 random paths, drawn
    from ``rng`` exactly as the JAX package's differential fuzz draws its
    graphs (``tests/test_fuzz_engines.py::_random_graph``), so one seed
    gives both packages the same graph; its property is a placeholder
    (``with_property_of`` sets the real one) and ``pred`` the device
    predicate named ``pred_name``."""
    n_nodes = rng.randint(4, 12)
    graph = DGraph.with_property(
        Property.always("placeholder", lambda m, s: True))
    graph = graph.with_device_predicate(pred_name, pred)
    for _ in range(rng.randint(2, 4)):
        length = rng.randint(1, 5)
        path = [rng.randrange(n_nodes) for _ in range(length)]
        graph = graph.with_path(path)
    return graph


class DGraphDevice(DeviceModel):
    """Device form of :class:`DGraph`: a dense successor table indexed by
    node id, looked up per frontier row. Fanout slots follow the sorted
    successors, the host's action order, so the device BFS visits levels
    in the host's order; a slot past a node's successors holds node 0,
    invalid. A node id past the table reads its last node, as JAX's
    clamped gather does."""

    error_lane = None
    state_width = 1
    #: the most nodes, and successors a node, ``csrc/models/dgraph.cuh``
    #: holds in the kernel's parameters
    CUDA_MAX_NODES = 32

    def __init__(self, graph: DGraph):
        self._graph = graph
        nodes = set(graph._inits)
        for src, dsts in graph._edges.items():
            nodes.add(src)
            nodes.update(dsts)
        self.n = max(nodes) + 1 if nodes else 1
        self.max_fanout = max([len(d) for d in graph._edges.values()]
                              or [1])
        succ = np.zeros((self.n, self.max_fanout), np.int64)
        self.degree = np.zeros(self.n, np.int64)
        for src, dsts in graph._edges.items():
            succ[src, :len(dsts)] = sorted(dsts)
            self.degree[src] = len(dsts)
        self.succ = succ
        self._on_device = {}

    def encode(self, state) -> np.ndarray:
        return np.array([state], np.uint32)

    def decode(self, vec):
        return int(vec[0])

    def action_label(self, vec, f: int):
        """The host's action is the successor node itself."""
        return int(self.succ[min(int(vec[0]), self.n - 1), f])

    def _tables(self, device):
        """``(succ int64[n, F], valid bool[n, F])`` on ``device``, copied
        there by the first call on it."""
        tabs = self._on_device.get(device)
        if tabs is None:
            valid = np.arange(self.max_fanout) < self.degree[:, None]
            tabs = (torch.from_numpy(self.succ).to(device),
                    torch.from_numpy(valid).to(device))
            self._on_device[device] = tabs
        return tabs

    def step(self, rows: torch.Tensor):
        succ, valid = self._tables(rows.device)
        node = rows[:, 0].clamp(max=self.n - 1)
        return succ[node][:, :, None], valid[node]

    def device_properties(self):
        return dict(self._graph._device_preds)

    def cuda_model(self):
        """``csrc/models/dgraph.cuh``, the table in the kernel's
        parameters: ``int32[2 + n + n * F]``, the node count, the fanout,
        each node's degree and the successor table row by row. Raises for
        a graph past ``CUDA_MAX_NODES`` nodes or successors."""
        most = self.CUDA_MAX_NODES
        if self.n > most or self.max_fanout > most:
            raise NotImplementedError(
                f"csrc/models/dgraph.cuh holds at most {most} nodes and "
                f"{most} successors a node, not {self.n} and "
                f"{self.max_fanout}: run it with wave_kernel=False on the "
                "card")
        table = np.concatenate([[self.n, self.max_fanout], self.degree,
                                self.succ.reshape(-1)])
        return "dgraph", (table.astype(np.int32),)


class FnModel(Model):
    """A model given by ``fn(prev_state_or_None, out)`` (``test_util.rs:
    120-138``): given ``None`` it appends the init states to ``out``,
    given a state its successors; an action is the state it leads to."""

    def __init__(self, fn: Callable):
        self._fn = fn

    def init_states(self):
        states: List = []
        self._fn(None, states)
        return states

    def actions(self, state, actions):
        self._fn(state, actions)

    def next_state(self, state, action):
        return action


class Guess(Enum):
    INCREASE_X = 0
    INCREASE_Y = 1

    def __repr__(self):  # Debug-style, for discovery summaries
        return self.name


class LinearEquation(Model):
    """Finds ``x``, ``y`` in u8 such that ``a*x + b*y = c (mod 256)``
    (``test_util.rs:141-188``). State: ``(x, y)``."""

    def __init__(self, a: int, b: int, c: int):
        self.a, self.b, self.c = a, b, c

    def device_model(self) -> "LinearEquationDevice":
        return LinearEquationDevice(self)

    def init_states(self):
        return [(0, 0)]

    def actions(self, state, actions):
        actions.append(Guess.INCREASE_X)
        actions.append(Guess.INCREASE_Y)

    def next_state(self, state, action):
        x, y = state
        if action is Guess.INCREASE_X:
            return ((x + 1) % 256, y)
        return (x, (y + 1) % 256)

    def properties(self):
        def solvable(model, solution):
            x, y = solution
            return (model.a * x + model.b * y) % 256 == model.c

        return [Property.sometimes("solvable", solvable)]


class LinearEquationDevice(DeviceModel):
    """Device form of :class:`LinearEquation`: two 32-bit lanes, increments
    wrapping at 256, the ``solvable`` predicate."""

    error_lane = None
    state_width = 2
    max_fanout = 2

    def __init__(self, model: LinearEquation):
        self._m = model

    def encode(self, state) -> np.ndarray:
        return np.array(state, np.uint32)

    def decode(self, vec):
        return (int(vec[0]), int(vec[1]))

    def action_names(self):
        return [Guess.INCREASE_X, Guess.INCREASE_Y]

    def step(self, rows: torch.Tensor):
        x, y = rows[:, 0], rows[:, 1]
        succ = torch.stack([torch.stack([(x + 1) % 256, y], dim=1),
                            torch.stack([x, (y + 1) % 256], dim=1)], dim=1)
        return succ, torch.ones(succ.shape[:2], dtype=torch.bool,
                                device=rows.device)

    def device_properties(self):
        a, b, c = self._m.a, self._m.b, self._m.c

        def solvable(rows):
            return (a * rows[:, 0] + b * rows[:, 1]) % 256 == c

        return {"solvable": solvable}

    def cuda_model(self):
        """``csrc/models/linear_equation.cuh`` (the step does not depend
        on ``a``, ``b`` or ``c``: the predicate runs in torch)."""
        return "linear_equation", ()
