"""Differential fuzzing of the port's engines on random digraphs.

The random graphs of ``tests/test_fuzz_engines.py`` (drawn by its
``_random_graph`` and by the port's ``test_util.random_graph`` from the
same ``random.Random`` state, so both packages hold the same graph) run
on the JAX package's host BFS (the semantics reference) and on the
port's fused, classic, sharded fused and sharded classic (both on
``mesh=["cpu"] * 3``) engines, each on the torch stages and with
``wave_kernel=True`` (the kernels' plain versions): the four arms of the
JAX package's fuzz. Guarantees checked, as the JAX package's fuzz checks
them:

- **Full enumeration** (a property never found): state and unique-state
  counts exact on every engine.
- **Discovery existence** for always and sometimes properties on every
  engine; **discovery identity** on the single-device engines, which keep
  the host's level order: the same last state as the host, and the same
  chain as JAX ``spawn_tpu_bfs`` at the same batch.
- **Eventually** semantics (the documented revisit false negative
  included): the single-device engines agree with the host exactly; a
  sharded engine's counterexample, where it reports one, is a terminal
  path on which the condition never held.
"""

import random

import numpy as np
import pytest
import torch

from stateright_tpu import Property as RefProperty
from stateright_tpu.tpu.hashing import host_fp64
from test_fuzz_engines import _random_graph, _with_property

from stateright_tpu_torch.model import Property
from stateright_tpu_torch.test_util import DGraph, random_graph

torch.set_num_threads(2)

# One seed in the fast set, as the JAX package's fuzz; the deeper sweep
# runs with `pytest -m slow`.
SEEDS = [0] + [pytest.param(i, marks=pytest.mark.slow)
               for i in range(1, 5)]


def _graphs(seed, draw, ref_pred, pred, ref_prop, prop):
    """The JAX package's graph and the port's, from one seed: ``draw(rng)``
    takes the test's own draws first, then each graph is built from the
    same generator state."""
    rng = random.Random(seed)
    drawn = draw(rng)
    state = rng.getstate()
    ref = _with_property(_random_graph(rng, ref_prop.name, ref_pred),
                         ref_prop)
    rng.setstate(state)
    ours = random_graph(rng, prop.name, pred).with_property_of(prop)
    assert ours._inits == ref._inits and ours._edges == ref._edges
    return drawn, ref, ours


def _engines(model):
    """The port's engines on ``model``, each on both paths."""
    spawns = {"fused": dict(device="cpu", batch_size=8),
              "classic": dict(device="cpu", batch_size=8, fused=False),
              "sharded": dict(mesh=["cpu"] * 3, batch_size=4),
              "sharded-classic": dict(mesh=["cpu"] * 3, batch_size=4,
                                      fused=False)}
    return {(name, wave_kernel): model.checker().spawn_cuda_bfs(
                wave_kernel=wave_kernel, **kw).join()
            for name, kw in spawns.items() for wave_kernel in (False, True)}


@pytest.mark.parametrize("seed", SEEDS)
def test_full_enumeration_counts_agree(seed):
    _, ref, model = _graphs(
        1000 + seed, lambda rng: None, lambda v: v[0] < 0,
        lambda rows: rows[:, 0] < 0,
        RefProperty.sometimes("none", lambda m, s: False),
        Property.sometimes("none"))
    host = ref.checker().spawn_bfs().join()
    assert host.discoveries() == {}
    for name, c in _engines(model).items():
        assert c.unique_state_count() == host.unique_state_count(), name
        assert c.state_count() == host.state_count(), name
        assert c.discoveries() == {}, name


def _chain(path, encode):
    return [host_fp64(np.asarray(encode(s), np.uint32))
            for s in path.into_states()]


@pytest.mark.parametrize("seed", SEEDS)
def test_discovery_existence_and_identity(seed):
    def draw(rng):
        return rng.randrange(12), rng.choice(["always", "sometimes"])

    rng = random.Random(2000 + seed)
    target, kind = draw(rng)
    if kind == "always":
        props = (RefProperty.always("p", lambda m, s: s != target),
                 Property.always("p"))
        preds = (lambda v: v[0] != target, lambda rows: rows[:, 0] != target)
    else:
        props = (RefProperty.sometimes("p", lambda m, s: s == target),
                 Property.sometimes("p"))
        preds = (lambda v: v[0] == target, lambda rows: rows[:, 0] == target)
    _, ref, model = _graphs(2000 + seed, draw, *preds, *props)
    host = ref.checker().spawn_bfs().join()
    expected = set(host.discoveries())
    runs = _engines(model)
    for name, c in runs.items():
        assert set(c.discoveries()) == expected, (name, kind, target)
        for path in c.discoveries().values():
            assert path.last_state() is not None
    if expected:
        host_state = host.discovery("p").last_state()
        ref_tpu = ref.checker().spawn_tpu_bfs(batch_size=8).join()
        want = _chain(ref_tpu.discovery("p"), ref.device_model().encode)
        for (name, wave_kernel), c in runs.items():
            if not name.startswith("sharded"):
                assert c.discovery("p").last_state() == host_state, name
                assert c.discovery("p").fingerprints == want, name


@pytest.mark.parametrize("seed", SEEDS)
def test_eventually_single_device_matches_host(seed):
    _, ref, model = _graphs(
        3000 + seed, lambda rng: None, lambda v: (v[0] % 2) == 1,
        lambda rows: rows[:, 0] % 2 == 1,
        RefProperty.eventually("odd", lambda m, s: s % 2 == 1),
        Property.eventually("odd"))
    host = ref.checker().spawn_bfs().join()
    expected = set(host.discoveries())
    for (name, wave_kernel), c in _engines(model).items():
        if not name.startswith("sharded"):
            assert set(c.discoveries()) == expected, name
            if expected:
                assert (c.discovery("odd").into_states()
                        == host.discovery("odd").into_states()), name
            continue
        # A sharded verdict must be valid even where it depends on the
        # order: a terminal path on which the condition never held.
        path = c.discovery("odd")
        if path is not None:
            states = path.into_states()
            assert all(s % 2 == 0 for s in states)
            assert not model._edges.get(states[-1])


# -- The eventually semantics on fixed graphs (tests/test_eventually.py) ------


def _odd(paths):
    graph = DGraph.with_property(Property.eventually("odd")) \
        .with_device_predicate("odd", lambda rows: rows[:, 0] % 2 == 1)
    for path in paths:
        graph = graph.with_path(path)
    return graph


@pytest.mark.parametrize("paths, want", [
    ([[0, 1], [0, 2]], [0, 2]),
    ([[0, 1], [2, 4]], [2, 4]),
    ([[0, 1, 4, 6], [2, 4, 8]], [2, 4, 6]),
    ([[1], [2, 3], [2, 6, 7], [4, 9, 10]], None),
    ([[0, 2, 4, 2]], None),
    ([[0, 2, 4], [1, 4, 6]], None)],
    ids=["two-inits", "terminal-next", "longer", "validates", "cycle",
         "revisit"])
def test_eventually_on_fixed_graphs(paths, want):
    """The counterexamples the JAX package's device engines find, its
    validations, and the documented revisit false negative
    (``checker.rs:400-413``): the single-device engines find exactly the
    host's path, a sharded one a terminal path that never held."""
    model = _odd(paths)
    for (name, wave_kernel), c in _engines(model).items():
        path = c.discovery("odd")
        if want is None:
            assert path is None, name
        elif not name.startswith("sharded"):
            assert path.into_states() == want, name
        else:
            states = path.into_states()
            assert all(s % 2 == 0 for s in states)
            assert states[-1] not in model._edges
