"""The port's fingerprints against the JAX package's.

``stateright_tpu_torch.hashing.device_fp64`` (int64 torch ops) and its
numpy twins must give the same uint64 values, bit for bit, as the JAX
``device_fp64`` and ``host_fp64_batch`` on the same random rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import stateright_tpu.tpu  # noqa: F401  (enables x64 for uint64)
from stateright_tpu.tpu import hashing as ref
from stateright_tpu_torch import carry, hashing

torch.set_num_threads(2)


@pytest.mark.parametrize("width", [1, 5, 8, 13, 55])
def test_fingerprints_match_jax(width):
    rng = np.random.default_rng(width)
    rows = rng.integers(0, 1 << 32, (4096, width), dtype=np.uint64
                        ).astype(np.uint32)
    rows[:4] = 0                       # all-zero rows
    rows[4:8] = 0xFFFFFFFF             # all-ones rows
    want = np.asarray(ref.device_fp64(jnp.asarray(rows)))
    assert np.array_equal(want, ref.host_fp64_batch(rows))
    got = carry.u64_out(hashing.device_fp64(carry.rows_in(rows)))
    assert np.array_equal(got, want)
    assert np.array_equal(hashing.host_fp64_batch(rows), want)
    for row in rows[:8]:
        assert hashing.host_fp64(row) == ref.host_fp64(row)


def test_sentinel_and_bit_pattern_helpers():
    assert hashing.SENTINEL == -1
    assert hashing.to_u64(-1) == int(ref.SENTINEL)
    assert hashing.to_i64(int(ref.SENTINEL)) == -1
    for v in (1, 1 << 63, (1 << 64) - 2, 12345):
        assert hashing.to_u64(hashing.to_i64(v)) == v
