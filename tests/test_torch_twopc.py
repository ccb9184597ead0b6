"""The port's 2pc device model against the JAX package's.

Successor rows, valid masks, the symmetry ``representative`` and the
three device properties must equal JAX ``TwoPhaseDevice``'s, on every
reachable state at 3 RMs and on seeded random rows (each lane inside its
``lane_bits`` width) at 5 and 10 RMs. The codec must agree too.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import stateright_tpu.tpu  # noqa: F401,E402  (enables x64)
import two_phase_commit as ref_model  # noqa: E402
from stateright_tpu_torch import carry  # noqa: E402
from stateright_tpu_torch.models import twopc  # noqa: E402

torch.set_num_threads(2)


def _reachable(rm):
    """Every reachable state at ``rm`` RMs, by a host BFS of the
    reference example model, encoded by the JAX device model."""
    model = ref_model.TwoPhaseSys(rm)
    dm = model.device_model()
    seen = {}
    queue = list(model.init_states())
    while queue:
        s = queue.pop()
        if s in seen:
            continue
        seen[s] = dm.encode(s)
        queue.extend(model.next_states(s))
    return np.stack(list(seen.values()))


def _random_rows(rm, n=1024):
    rng = np.random.default_rng(rm)
    bits = twopc.TwoPhaseDevice(rm).lane_bits()
    rows = np.stack([rng.integers(0, 1 << b, n, dtype=np.uint64)
                     for b in bits], axis=1).astype(np.uint32)
    rows[:, rm] %= 3  # the TM state has three values
    return rows


def _check(rm, rows):
    ref = ref_model.TwoPhaseSys(rm).device_model()
    dm = twopc.TwoPhaseDevice(rm)
    assert (dm.state_width, dm.max_fanout) == (ref.state_width,
                                              ref.max_fanout)
    assert dm.lane_bits() == ref.lane_bits()
    x = carry.rows_in(rows)
    succ, valid = dm.step(x)
    r_succ, r_valid = jax.vmap(ref.step)(jnp.asarray(rows))
    assert np.array_equal(carry.rows_out(succ), np.asarray(r_succ))
    assert np.array_equal(valid.numpy(), np.asarray(r_valid))
    rep = dm.representative(x)
    r_rep = jax.vmap(ref.representative)(jnp.asarray(rows))
    assert np.array_equal(carry.rows_out(rep), np.asarray(r_rep))
    r_props = ref.device_properties()
    for name, fn in dm.device_properties().items():
        assert np.array_equal(fn(x).numpy(),
                              np.asarray(jax.vmap(r_props[name])(
                                  jnp.asarray(rows)))), name


def test_step_matches_jax_on_every_reachable_state_at_3():
    rows = _reachable(3)
    assert len(rows) == 288
    _check(3, rows)


@pytest.mark.parametrize("rm", [5, 10])
def test_step_matches_jax_on_random_rows(rm):
    _check(rm, _random_rows(rm))


def test_codec_and_model_match_reference():
    ref = ref_model.TwoPhaseSys(3)
    ref_dm = ref.device_model()
    ours = twopc.TwoPhaseSys(3)
    dm = ours.device_model()
    for vec in _reachable(3):
        state = dm.decode(vec)
        assert np.array_equal(dm.encode(state), vec)
        assert np.array_equal(ref_dm.encode(ref_dm.decode(vec)), vec)
    assert [(p.name, p.expectation.value) for p in ours.properties()] == [
        (p.name, p.expectation.value) for p in ref.properties()]
    assert np.array_equal(dm.encode(ours.init_states()[0]),
                          ref_dm.encode(ref.init_states()[0]))
    assert len(dm.action_names()) == dm.max_fanout
    # The action labels follow the reference's enumeration order.
    s = ref.init_states()[0]
    acts = []
    ref.actions(s, acts)
    names = dm.action_names()
    _, valid = dm.step(carry.rows_in(ref_dm.encode(s)[None]))
    assert [names[f] for f in np.flatnonzero(valid[0].numpy())] == acts
