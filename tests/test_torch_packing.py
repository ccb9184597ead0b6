"""The port's packed row layout against the JAX package's.

For 2pc's ``lane_bits`` at 3, 5 and 10 RMs, the port's torch ``pack``
and numpy ``pack_np`` must give the same words as the JAX layout's
``pack_np`` and jnp ``pack``; ``unpack`` must invert them; and the
``carry`` converters must move packed words and eventually-bits across
without changing a bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import stateright_tpu.tpu  # noqa: F401  (enables x64)
from stateright_tpu.tpu.packing import compile_layout as ref_layout
from stateright_tpu_torch import carry
from stateright_tpu_torch.models.twopc import TwoPhaseDevice
from stateright_tpu_torch.packing import compile_layout

torch.set_num_threads(2)


def _rows(rng, bits, n=2048):
    return np.stack([rng.integers(0, 1 << b, n, dtype=np.uint64)
                     for b in bits], axis=1).astype(np.uint32)


@pytest.mark.parametrize("rm", [3, 5, 10])
def test_pack_matches_jax_layout(rm):
    bits = TwoPhaseDevice(rm).lane_bits()
    ours, theirs = compile_layout(bits, rm + 3), ref_layout(bits, rm + 3)
    assert ours.packed_width == theirs.packed_width
    assert ours.packs and (rm < 10 or ours.packed_width == 2)
    rows = _rows(np.random.default_rng(rm), bits)
    want = theirs.pack_np(rows)
    assert np.array_equal(np.asarray(theirs.pack(jnp.asarray(rows))), want)
    assert np.array_equal(ours.pack_np(rows), want)
    packed = ours.pack(carry.rows_in(rows))
    assert packed.dtype == torch.int32
    assert np.array_equal(carry.words_out(packed), want)
    assert np.array_equal(carry.rows_out(ours.unpack(packed)), rows)
    assert np.array_equal(ours.unpack_np(want), rows)
    assert np.array_equal(carry.rows_out(
        ours.unpack(carry.words_in(want))), rows)
    for lane in (0, rm, rm + 2):
        assert np.array_equal(carry.rows_out(ours.lane(packed, lane)),
                              rows[:, lane])


def test_sentinel_lanes_and_identity_layout():
    # A spilling lane and a sentinel lane, against the JAX layout.
    bits = [20, (15, 0xFFFFFFFF), 32, 3]
    ours, theirs = compile_layout(bits, 4), ref_layout(bits, 4)
    rng = np.random.default_rng(1)
    rows = _rows(rng, [20, 14, 32, 3])
    rows[::3, 1] = 0xFFFFFFFF
    want = theirs.pack_np(rows)
    packed = ours.pack(carry.rows_in(rows))
    assert np.array_equal(carry.words_out(packed), want)
    assert np.array_equal(carry.rows_out(ours.unpack(packed)), rows)
    ident = compile_layout(None, 3)
    assert not ident.packs and ident.packed_width == 3
    rows = _rows(rng, [32, 32, 32])
    assert np.array_equal(carry.rows_out(ident.unpack(
        ident.pack(carry.rows_in(rows)))), rows)
    with pytest.raises(ValueError):
        compile_layout([2, 2], 3)
    with pytest.raises(ValueError):
        compile_layout([4], 1).check_fits(np.array([[16]], np.uint32))


def test_carry_round_trips():
    rng = np.random.default_rng(3)
    u64 = rng.integers(0, 1 << 64, 100, dtype=np.uint64)
    u64[0] = np.uint64(0xFFFFFFFFFFFFFFFF)
    t = carry.u64_in(u64)
    assert t.dtype == torch.int64 and int(t[0]) == -1
    assert np.array_equal(carry.u64_out(t), u64)
    ebits = rng.integers(0, 1 << 32, 100, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(carry.words_out(carry.words_in(ebits)), ebits)
