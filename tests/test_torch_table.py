"""The port's visited-table dedup against the JAX package's.

``stateright_tpu_torch.table.dedup_and_insert`` on CPU tensors runs the
kernel's plain version; it must equal the Pallas kernel
(``dedup_and_insert_pallas``, interpret mode, as the JAX tests run it)
and the XLA ``dedup_and_insert`` exactly: new mask, candidate mask and
both counts, the table as a set, and the compaction order. Inputs are
the reference tests' stream (duplicates, sentinels, revisits of resident
fingerprints) against a table pre-filled by ``host_table_insert``. The
CUDA kernel itself is held to the same plain version on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import stateright_tpu.tpu  # noqa: F401  (enables x64)
from stateright_tpu.tpu import engine as ref
from stateright_tpu.tpu.hashing import SENTINEL
from stateright_tpu.tpu.pallas_table import dedup_and_insert_pallas
from stateright_tpu_torch import carry, engine, table

torch.set_num_threads(2)


def _random_stream(rng, n, resident):
    fresh = rng.integers(1, 1 << 62, n, dtype=np.uint64)
    out = fresh.copy()
    dup_rows = rng.random(n) < 0.3
    out[dup_rows] = rng.choice(fresh, dup_rows.sum())
    rev_rows = rng.random(n) < 0.2
    out[rev_rows] = rng.choice(resident, rev_rows.sum())
    out[rng.random(n) < 0.1] = SENTINEL
    return out


def _as_set(t):
    return set(t[t != SENTINEL].tolist())


@pytest.mark.parametrize("capacity", [1 << 14, 1 << 15])
def test_dedup_matches_pallas_and_xla(capacity):
    rng = np.random.default_rng(capacity)
    resident = rng.integers(1, 1 << 62, capacity // 8, dtype=np.uint64)
    host = np.full(capacity, SENTINEL, np.uint64)
    ref.host_table_insert(host, resident)
    mine = np.full(capacity, SENTINEL, np.uint64)
    engine.host_table_insert(mine, resident)
    assert _as_set(mine) == _as_set(host)

    j_xla = jax.jit(lambda f, t: ref.dedup_and_insert(f, t, capacity))
    j_pls = jax.jit(lambda f, t: dedup_and_insert_pallas(f, t, capacity))
    j_first = jax.jit(ref.first_occurrence_candidates)
    j_comp = jax.jit(ref.compaction_order)
    t_x, t_p, t_mine = jnp.asarray(host), jnp.asarray(host), \
        carry.u64_in(host)
    launches = table.dedup_and_insert.launches
    for _ in range(3):
        fps = _random_stream(rng, 1024, resident)
        m_x, c_x, t_x = j_xla(jnp.asarray(fps), t_x)
        m_p, c_p, cand_p, t_p = j_pls(jnp.asarray(fps), t_p)
        new, cand, n_new, n_cand, full = table.dedup_and_insert(
            carry.u64_in(fps), t_mine)
        assert np.array_equal(new.numpy(), np.asarray(m_x))
        assert np.array_equal(new.numpy(), np.asarray(m_p))
        assert np.array_equal(cand.numpy(),
                              np.asarray(j_first(jnp.asarray(fps))))
        assert int(n_new) == int(c_x) == int(c_p)
        assert int(n_cand) == int(cand_p)
        assert not bool(full)
        assert _as_set(carry.u64_out(t_mine)) == _as_set(np.asarray(t_x)) \
            == _as_set(np.asarray(t_p))
        assert np.array_equal(engine.compaction_order(new).numpy(),
                              np.asarray(j_comp(m_x)))
    # The CPU path runs the plain version and launches nothing.
    assert table.dedup_and_insert.launches == launches


def test_full_table_is_flagged_not_a_hang():
    t = torch.full((16,), -1, dtype=torch.int64)
    fps = torch.arange(1, 41, dtype=torch.int64) * 0x1234567
    new, cand, n_new, n_cand, full = table.dedup_and_insert(fps, t)
    assert bool(full) and int(n_new) == 16 and int(n_cand) == 40
    assert bool((t != -1).all())


def test_wrapper_refuses_mixed_devices():
    with pytest.raises(ValueError):
        table.dedup_and_insert(torch.zeros(4, dtype=torch.int64),
                               torch.zeros(16, dtype=torch.int64,
                                           device="meta"))


def test_a_callers_scratch_that_does_not_fit_raises():
    fresh = table.DedupScratch.for_call(None, 10, torch.device("cpu"))
    assert fresh.n == 10 and fresh.is_clean()
    assert table.DedupScratch.for_call(fresh, 8, torch.device("cpu")) is fresh
    for n, dev in ((11, "cpu"), (8, "meta")):
        with pytest.raises(ValueError, match="the scratch takes 10 rows"):
            table.DedupScratch.for_call(fresh, n, torch.device(dev))
