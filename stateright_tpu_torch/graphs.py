"""One CUDA graph a dispatch: the port's form of the reference's "one XLA
program a dispatch" (``stateright_tpu/tpu/fused.py::_dispatch_fn``).

JAX compiles a dispatch's K waves into one program for each ``(batch,
capacity, ucap, K)``, so the host issues one call a dispatch. Torch runs
eagerly and the host issues every op of every wave, 131 to 3,052 a wave
on the port's paths, each costing the host more than the card. A
dispatch reads nothing back and its shapes are fixed between rest
points, so ``DispatchGraphs`` captures it once a key and replays it. The
engine keys its graphs by the dispatch's bucket alone: K is fixed for an
engine, and the capacity and ``ucap`` change only at a growth, which
drops every graph.

- The first dispatch at a key runs eagerly. It is the warm-up: each
  kernel launcher asks the runtime for its resident blocks (a query that
  must not run during a capture) and keeps the answer, the models copy
  their constant tables to the device, and the allocator learns the
  dispatch's temporaries.
- The second dispatch at the key captures, then replays; every later one
  replays. Capturing on first use would need the warm-up anyway, and a
  key used once would pay a capture (the host's pass over every op, then
  the graph's instantiation) for no replay: ``paxos check 3`` runs only
  7 dispatches over 2 or 3 keys.
- At a rest point's growth the engine drops every graph (``clear``): the
  rehash and the arena doubling reallocate the tensors the graphs hold
  and change the sizes the graphs were captured at.

An engine's graphs share one memory pool. That is safe because one
stream runs every replay in turn, and a dispatch keeps nothing past its
end in the pool: its results go in place into the engine's static stats,
arena and table, and whatever a dispatch caches for later (launchers'
block counts, models' tables) was made by the key's eager warm-up.

The wrappers' ``.launches`` counters see Python calls, and a capture
calls each wrapper without launching. ``run`` reads every counter before
and after a capture, puts it back (a capture runs nothing), and adds the
captured counts at each replay, so the counters stay exact.

A capture that fails raises; the engine never falls back to eager
dispatches. The capture uses ``capture_error_mode="thread_local"``: an
engine captures in its worker thread while other threads may use the
card.
"""

from __future__ import annotations

import time

__all__ = ["DispatchGraphs", "CudaGraphApi", "CUDA_GRAPHS"]


class CudaGraphApi:
    """What ``DispatchGraphs`` needs of ``torch.cuda``: a new graph, a
    shared memory pool, and a capture of a function into a graph."""

    @staticmethod
    def graph():
        import torch

        return torch.cuda.CUDAGraph()

    @staticmethod
    def pool():
        import torch

        return torch.cuda.graph_pool_handle()

    @staticmethod
    def capture(graph, pool, fn) -> None:
        import torch

        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            fn()


#: the API ``DispatchGraphs`` uses (a test may put a stand-in here)
CUDA_GRAPHS = CudaGraphApi()


class DispatchGraphs:
    """An engine's dispatch graphs, one a key, with the launch accounting
    of ``kernels`` (the wrappers whose ``.launches`` count)."""

    def __init__(self, kernels):
        self._kernels = tuple(kernels)
        self._api = CUDA_GRAPHS
        self._graphs = {}
        self._pool = None
        #: graphs captured, replays run, and host seconds spent capturing
        self.captures = self.replays = 0
        self.capture_sec = 0.0

    def has_graph(self, key) -> bool:
        """Whether the next dispatch at ``key`` is a replay."""
        return self._graphs.get(key) is not None

    def run(self, key, dispatch) -> bool:
        """Runs ``dispatch()`` at ``key``: eagerly the first time, captured
        and replayed the second, replayed after. Returns whether this call
        captured."""
        entry = self._graphs.get(key)
        if key not in self._graphs:
            dispatch()
            self._graphs[key] = None
            return False
        captured = entry is None
        if captured:
            t0 = time.perf_counter()
            before = [k.launches for k in self._kernels]
            if self._pool is None:
                self._pool = self._api.pool()
            graph = self._api.graph()
            self._api.capture(graph, self._pool, dispatch)
            deltas = [k.launches - b for k, b in zip(self._kernels, before)]
            for k, b in zip(self._kernels, before):
                k.launches = b
            entry = self._graphs[key] = (graph, deltas)
            self.captures += 1
            self.capture_sec += time.perf_counter() - t0
        graph, deltas = entry
        graph.replay()
        self.replays += 1
        for k, d in zip(self._kernels, deltas):
            k.launches += d
        return captured

    def clear(self) -> None:
        """Drops every graph and the pool: the next dispatch at any key
        runs eagerly again."""
        self._graphs.clear()
        self._pool = None

    def __len__(self) -> int:
        """Graphs held."""
        return sum(e is not None for e in self._graphs.values())
