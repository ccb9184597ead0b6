"""The port's single-kernel wave against the JAX package's.

``stateright_tpu_torch.wave.wave_megakernel`` on CPU tensors runs its
plain version, ``wave_megakernel_plain``. Here it is held to the Pallas
megakernel ``build_wave_megakernel`` (interpret mode, as the JAX tests
run it) on three chained waves of 2pc at 4 RMs, plain and with symmetry:
successor rows, path fingerprints, sflat, new and candidate masks equal
bit for bit (tolerance: exact), the tables equal as sets. The port's
fused engine with ``wave_kernel=True`` is held to the JAX fused engine
with ``wave_kernel=True`` (counts and discovery paths exact) and to its
own ``wave_kernel=False`` run (counts, paths and the arena bit for bit).
Inputs are made with numpy and cross through ``carry``. The CUDA kernel
itself is held to the same plain version on the card by
``chip_smoke.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import stateright_tpu.tpu  # noqa: F401,E402  (enables x64)
import two_phase_commit as ref_model  # noqa: E402
from stateright_tpu.tpu.hashing import SENTINEL, host_fp64  # noqa: E402
from stateright_tpu.tpu.packing import compile_layout as ref_layout  # noqa: E402,E501
from stateright_tpu.tpu.pallas_table import build_wave_megakernel  # noqa: E402,E501
from stateright_tpu_torch import carry, wave  # noqa: E402
from stateright_tpu_torch.models import twopc  # noqa: E402
from stateright_tpu_torch.packing import compile_layout  # noqa: E402

torch.set_num_threads(2)

CAP = 1 << 14


def _as_set(a):
    return set(a[a != SENTINEL].tolist())


@pytest.mark.parametrize("use_sym", [False, True], ids=["plain", "sym"])
def test_plain_version_matches_jax_megakernel(use_sym):
    B = 64
    rdm = ref_model.TwoPhaseSys(4).device_model()
    dm = twopc.TwoPhaseDevice(4)
    W = dm.state_width
    r_layout, layout = ref_layout(rdm.lane_bits(), W), \
        compile_layout(dm.lane_bits(), W)
    assert layout.packed_width == r_layout.packed_width == 1
    mega = build_wave_megakernel(rdm, B, CAP, use_sym=use_sym,
                                 layout=r_layout, interpret=True)

    rng = np.random.default_rng(4)
    # A table that already holds some random keys.
    host = np.full(CAP, SENTINEL, np.uint64)
    host[rng.choice(CAP, 64, replace=False)] = rng.integers(
        1, 1 << 62, 64, dtype=np.uint64)
    frontier = [np.asarray(rdm.encode(s), np.uint32)
                for s in ref_model.TwoPhaseSys(4).init_states()]
    r_table, table = jnp.asarray(host), carry.u64_in(host)
    launches = wave.wave_megakernel.launches
    for wave_i in range(3):
        batch = rng.integers(0, 2, (B, W)).astype(np.uint32)  # invalid rows
        n = min(B, len(frontier))
        batch[:n] = np.stack(frontier[:n])
        frontier = frontier[n:]
        packed = layout.pack_np(batch)
        valid = np.arange(B) < n
        valid[rng.random(B) < 0.1] = False  # holes inside the batch

        (r_succ, r_pfp, r_sflat, r_new, r_cand, r_table) = mega(
            jnp.asarray(packed), jnp.asarray(valid), r_table)
        args = (dm, carry.words_in(packed), torch.from_numpy(valid))
        t2 = table.clone()
        outs = [wave.wave_megakernel_plain(*args, table, use_sym, layout),
                wave.wave_megakernel(*args, t2, use_sym, layout)]
        for out, tab in zip(outs, (table, t2)):
            succ, pfp, sflat, new, cand, n_new, n_cand, full = out
            assert np.array_equal(carry.words_out(succ), np.asarray(r_succ))
            assert np.array_equal(carry.u64_out(pfp), np.asarray(r_pfp))
            assert np.array_equal(sflat.numpy(), np.asarray(r_sflat))
            assert np.array_equal(new.numpy(), np.asarray(r_new))
            assert np.array_equal(cand.numpy(), np.asarray(r_cand))
            assert int(n_new) == int(np.asarray(r_new).sum())
            assert int(n_cand) == int(np.asarray(r_cand).sum())
            assert not bool(full)
            assert _as_set(carry.u64_out(tab)) == _as_set(np.asarray(r_table))
        assert np.asarray(r_new).sum() > 0, wave_i
        new_rows = np.asarray(r_succ)[np.asarray(r_new)]
        frontier.extend(r_layout.unpack_np(new_rows))
        table = t2
    # The CPU path runs the plain version and launches nothing.
    assert wave.wave_megakernel.launches == launches


def _ref_chains(c):
    dm = c._dm
    return {name: [host_fp64(np.asarray(dm.encode(s), np.uint32))
                   for s in path.into_states()]
            for name, path in c.discoveries().items()}


def _chains(c):
    return {name: p.fingerprints for name, p in c.discoveries().items()}


@pytest.mark.parametrize("rm, unique, states, sym", [
    (3, 288, 1146, False), (5, 8832, 58146, False), (5, 314, 2048, True)])
def test_wave_kernel_engine_matches_jax(rm, unique, states, sym):
    rb, ob = ref_model.TwoPhaseSys(rm).checker(), \
        twopc.TwoPhaseSys(rm).checker()
    if sym:
        rb, ob = rb.symmetry(), ob.symmetry()
    ref = rb.spawn_tpu_bfs(wave_kernel=True, pack_arena=True,
                           batch_size=256).join()
    assert ref.kernel_path() == "interpret"
    ours = ob.spawn_cuda_bfs(device="cpu", wave_kernel=True,
                             batch_size=256).join()
    assert ours.kernel_path() == "megakernel_plain"
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count()) == (unique, states)
    assert _chains(ours) == _ref_chains(ref)
    assert sorted(_chains(ours)) == ["abort agreement", "commit agreement"]
    ours.assert_properties()


def test_wave_kernel_on_and_off_agree_bit_for_bit():
    kw = dict(device="cpu", batch_size=32, table_capacity=1 << 12,
              arena_capacity=1 << 9, waves_per_dispatch=2)
    on = twopc.TwoPhaseSys(4).checker().spawn_cuda_bfs(
        wave_kernel=True, **kw).join()
    off = twopc.TwoPhaseSys(4).checker().spawn_cuda_bfs(**kw).join()
    assert on.rehashes > 0 and on.arena_grows > 0
    assert (on.unique_state_count(), on.state_count(), on.candidates) == (
        off.unique_state_count(), off.state_count(), off.candidates)
    assert _chains(on) == _chains(off)
    tail = on._tail
    assert tail == off._tail == on.unique_state_count()
    for name in ("_vecs", "_fps", "_par", "_ebits"):
        assert torch.equal(getattr(on, name)[:tail],
                           getattr(off, name)[:tail]), name


def test_kernel_path_names_the_plain_versions_on_the_cpu():
    b = twopc.TwoPhaseSys(2).checker()
    assert b.spawn_cuda_bfs(device="cpu", wave_kernel=True).join() \
        .kernel_path() == "megakernel_plain"
    assert b.spawn_cuda_bfs(device="cpu").join().kernel_path() \
        == "dedup_plain"


class _OwnStep(twopc.TwoPhaseDevice):
    """Overrides the step, so 2pc's device code no longer computes it."""

    def step(self, rows):
        succ, valid = super().step(rows)
        return succ, valid & (rows[:, :1] != 3)


class _NoCode(twopc.TwoPhaseDevice):
    def cuda_model(self):
        return None


class _SentinelLane(twopc.TwoPhaseDevice):
    def lane_bits(self):
        return [(3, 7)] + super().lane_bits()[1:]


@pytest.mark.parametrize("dm_cls, match", [
    (_OwnStep, "_OwnStep has no CUDA step.*overrides \\['step'\\]"),
    (_NoCode, "_NoCode has no CUDA step"),
    (_SentinelLane, "sentinel")])
def test_wave_kernel_on_the_card_never_falls_back(dm_cls, match):
    """Without device code for the model, ``wave_kernel=True`` on a CUDA
    device raises at spawn, before any device work (so no card is
    needed to reach it); on the CPU the same model runs its plain
    version."""

    class Sys(twopc.TwoPhaseSys):
        def device_model(self):
            return dm_cls(self.rm_count)

    with pytest.raises(NotImplementedError, match=match):
        Sys(2).checker().spawn_cuda_bfs(device="cuda:0", wave_kernel=True)
    dm = dm_cls(2)
    with pytest.raises(NotImplementedError, match=match):
        wave.cuda_model(dm, compile_layout(dm.lane_bits(), dm.state_width))
    c = Sys(2).checker().spawn_cuda_bfs(device="cpu", wave_kernel=True)
    assert c.join().kernel_path() == "megakernel_plain"


def test_wrapper_refuses_mixed_devices():
    dm = twopc.TwoPhaseDevice(2)
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    with pytest.raises(ValueError, match="one CUDA device"):
        wave.wave_megakernel(dm, torch.zeros((4, 1), dtype=torch.int32),
                             torch.ones(4, dtype=torch.bool),
                             torch.zeros(16, dtype=torch.int64,
                                         device="meta"), False, layout)
