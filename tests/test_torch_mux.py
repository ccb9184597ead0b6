"""The multiplexer of the port against JAX's: ``MuxGroup`` and its wave.

``engine.mux_wave`` (kernel 1's plain version on the CPU) is held to
JAX's ``build_mux_wave`` on the same tenant-lane batch, tags and table:
every output equal, the tables equal as sets. Then the port arms of
``tests/test_mux.py``'s four ``MuxGroup`` cases, at its ``KNOBS``: each
tenant of a group equals JAX's solo classic run (``pack_arena=True``,
whose sections the port's packed rows match) and the port's own in
counters, discovery chains and checkpoint sections, byte for byte; a
tenant preempted at a wave boundary resumes in a fresh group to the
same; the group trace's attributed lines sum to its totals and every
trace passes ``tools/trace_lint.py``; the program cache records its
hits. The siblings run ping-pong, VSR at 2 replicas and increment_lock;
the early stop (increment, equal to a solo run at the effective width)
stays under ``-m slow``, as JAX's does. Exact throughout.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))

import stateright_tpu.tpu  # noqa: F401,E402  (enables x64)
import trace_lint  # noqa: E402
from stateright_tpu.service import default_registry as ref_registry  # noqa: E402,E501
from stateright_tpu.tpu import engine as ref_engine  # noqa: E402
from stateright_tpu.tpu import packing as ref_packing  # noqa: E402
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
from stateright_tpu_torch import carry  # noqa: E402
from stateright_tpu_torch.engine import mux_wave  # noqa: E402
from stateright_tpu_torch.jit_cache import WaveProgramCache  # noqa: E402
from stateright_tpu_torch.packing import compile_layout  # noqa: E402
from stateright_tpu_torch.service import (MuxGroup,  # noqa: E402
                                          default_registry)
from stateright_tpu_torch.service.mux import _splitmix64  # noqa: E402

torch.set_num_threads(2)

#: one corpus shape shared by the fast cases (``test_mux.py:36``)
KNOBS = {"batch_size": 32, "table_capacity": 1 << 14,
         "checkpoint_every_waves": 1}
SOLO = dict(fused=False, batch_size=32, table_capacity=1 << 14)


def _sections(path):
    with np.load(path) as data:
        return {k: (data[k].dtype, data[k].shape, data[k].tobytes())
                for k in data.files}


def _same_sections(a, b):
    want, got = _sections(a), _sections(b)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name


def _chains(c, dm):
    return {k: (p.fingerprints if hasattr(p, "fingerprints") else [
        host_fp64(np.asarray(dm.encode(s), np.uint32))
        for s in p.into_states()]) for k, p in c.discoveries().items()}


def _solo(name, params, path):
    """JAX's and the port's solo classic runs of a registry model, each
    with its end-of-run checkpoint at ``path`` + ``.jax`` / ``.port``."""
    ref_model, _ = ref_registry().build(name, params)
    ref = ref_model.checker().spawn_tpu_bfs(
        pack_arena=True, checkpoint_path=path + ".jax", **SOLO).join()
    model, _ = default_registry().build(name, params)
    ours = model.checker().spawn_cuda_bfs(
        device="cpu", checkpoint_path=path + ".port", **SOLO).join()
    assert (ours.unique_state_count(), ours.state_count()) == (
        ref.unique_state_count(), ref.state_count())
    chains = _chains(ref, ref._dm)
    assert _chains(ours, ours._dm) == chains
    _same_sections(path + ".jax", path + ".port")
    return {"model": model, "states": ref.state_count(),
            "unique": ref.unique_state_count(), "chains": chains,
            "ckpt": path + ".jax"}


@pytest.fixture(scope="module")
def solo_twopc(tmp_path_factory):
    d = tmp_path_factory.mktemp("solo")
    return _solo("twopc", {"rm_count": 3}, str(d / "solo.npz"))


def _assert_solo(h, solo, dm, ckpt=None):
    assert h.state_count() == solo["states"]
    assert h.unique_state_count() == solo["unique"]
    assert _chains(h, dm) == solo["chains"]
    if ckpt is not None:
        _same_sections(solo["ckpt"], ckpt)


# -- The wave ----------------------------------------------------------------


def test_mux_wave_equals_jax_build_mux_wave():
    """Two tenants' rows of 2pc at 4 RMs (every state, from a finished
    run's arena) in one batch with invalid rows, against a table that
    holds some of each tenant's tagged keys: JAX's program with packing
    on and the port's wave give equal outputs, tables equal as sets."""
    model, _ = default_registry().build("twopc", {"rm_count": 4})
    ref_model, _ = ref_registry().build("twopc", {"rm_count": 4})
    run = model.checker().spawn_cuda_bfs(device="cpu", batch_size=64).join()
    dm, ref_dm = model.device_model(), ref_model.device_model()
    base = compile_layout(dm.lane_bits(), dm.state_width)
    rows = base.unpack_np(
        run._vecs[:run._tail].numpy().view(np.uint32))[:200]
    B, J = len(rows), 4
    slots = np.where(np.arange(B) < 120, 0, 3).astype(np.uint32)
    mux = base.with_tenant_lane()
    vecs = mux.pack_tenant_np(rows, slots)
    ref_mux = ref_packing.compile_layout(
        ref_dm.lane_bits(), ref_dm.state_width).with_tenant_lane()
    assert np.array_equal(ref_mux.pack_tenant_np(rows, slots), vecs)
    valid = np.arange(B) < B - 7
    tags = np.array([_splitmix64(k) for k in range(1, J + 1)], np.uint64)
    cap = 1 << 12
    table = np.full(cap, np.uint64(2 ** 64 - 1), np.uint64)
    seen = np.array([host_fp64(r) for r in rows[::5]], np.uint64)
    ref_engine.host_table_insert(table, np.concatenate(
        [seen ^ tags[0], seen[:10] ^ tags[3]]))
    ours_table = torch.from_numpy(table.view(np.int64).copy())
    preds = [fn for fn in dm.device_properties().values()]
    ref_preds = [fn for fn in ref_dm.device_properties().values()]
    ours = mux_wave(dm, torch.from_numpy(vecs.view(np.int32)),
                    torch.from_numpy(valid),
                    torch.from_numpy(tags.view(np.int64)), ours_table, mux,
                    preds)
    import jax.numpy as jnp

    prog = ref_engine.build_mux_wave(ref_dm, B, cap, ref_preds, False,
                                     max_jobs=J, layout=ref_mux,
                                     pack_on=True)
    ref = prog(jnp.asarray(vecs), jnp.asarray(valid), jnp.asarray(tags),
               jnp.asarray(table))
    (conds, terminal, seg_succ, seg_cand, seg_novel, new_count, new_vecs,
     new_fps, new_dedup, new_parent, full) = ours
    k = int(new_count)
    assert k == int(ref[5]) and not bool(full)
    for a, b in zip(conds, ref[0]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(terminal.numpy(), np.asarray(ref[1]))
    for a, b in zip((seg_succ, seg_cand, seg_novel), ref[2:5]):
        assert a.tolist() == np.asarray(b).astype(np.int64).tolist()
    assert np.array_equal(new_vecs[:k].numpy().view(np.uint32),
                          np.asarray(ref[6])[:k])
    for a, b in ((new_fps, ref[7]), (new_dedup, ref[8])):
        assert np.array_equal(a[:k].numpy().view(np.uint64),
                              np.asarray(b)[:k])
    assert np.array_equal(new_parent[:k].numpy(), np.asarray(ref[9])[:k])
    keys = carry.u64_out(ours_table)
    ref_keys = np.asarray(ref[10])
    assert np.array_equal(np.sort(keys), np.sort(ref_keys))
    assert int(seg_novel.sum()) == k > 0


# -- The group ---------------------------------------------------------------


def test_mux_differential_vs_solo(solo_twopc, tmp_path):
    """Three tenants of one group each report the solo run's counters,
    discoveries and checkpoint sections, and the group trace's per-job
    attribution sums to its wave totals."""
    cache = WaveProgramCache()
    group_trace = str(tmp_path / "mux.trace.jsonl")
    g = MuxGroup(solo_twopc["model"], knobs=dict(KNOBS),
                 program_cache=cache, program_key=("twopc", 3),
                 trace_path=group_trace, device="cpu")
    ckpts = [str(tmp_path / f"t{i}.npz") for i in range(3)]
    tenant_trace = str(tmp_path / "t0.trace.jsonl")
    handles = [g.admit(f"j-{i}", checkpoint_path=ckpts[i],
                       trace_path=tenant_trace if i == 0 else None)
               for i in range(3)]
    for h in handles:
        h.join()
    g.join(timeout=30)
    assert g.closed and not g._thread.is_alive()
    dm = solo_twopc["model"].device_model()
    for h, ckpt in zip(handles, ckpts):
        assert not h.preempted
        _assert_solo(h, solo_twopc, dm, ckpt)
    stats = [h.scheduler_stats() for h in handles]
    assert all(s["engine"] == "mux" for s in stats)
    assert sum(s["program_cache"]["hits"] for s in stats) >= 2
    assert max(s["jobs_in_group_high_water"] for s in stats) == 3
    waves = [json.loads(line) for line in open(group_trace)]
    waves = [w for w in waves if w.get("type") == "wave"]
    totals = [w for w in waves if w["job_id"] is None]
    attr = [w for w in waves if w["job_id"] is not None]
    assert totals and attr
    assert all(w["kernel_path"] == "dedup_plain" for w in waves)
    for field in ("successors", "candidates", "novel"):
        assert sum(a[field] for a in attr) == sum(t[field] for t in totals)
    assert sum(t["novel"] for t in totals) == 3 * (solo_twopc["unique"] - 1)
    for path in (group_trace, tenant_trace):
        counts, errors = trace_lint.lint_file(path)
        assert not errors, errors[:3]
        assert counts.get("wave", 0) > 0


def test_mux_preempt_resume_differential(solo_twopc, tmp_path):
    """Preempting one tenant at a wave boundary neither disturbs its
    co-tenant nor loses work: resumed in a fresh group from its own
    checkpoint generation, it ends with the solo run's counters,
    discoveries and sections."""
    cache = WaveProgramCache()
    g = MuxGroup(solo_twopc["model"], knobs=dict(KNOBS),
                 program_cache=cache, program_key=("twopc", 3),
                 device="cpu")
    c0 = str(tmp_path / "t0.npz")
    h0 = g.admit("j-0", checkpoint_path=c0)
    h1 = g.admit("j-1", checkpoint_path=str(tmp_path / "t1.npz"))
    h0.preempt()
    h0.join()
    h1.join()
    g.join(timeout=30)
    dm = solo_twopc["model"].device_model()
    assert not h1.preempted
    _assert_solo(h1, solo_twopc, dm, str(tmp_path / "t1.npz"))
    if not h0.preempted:
        # The group drained j-0 before the flag landed: it is done and
        # already the solo run.
        _assert_solo(h0, solo_twopc, dm, c0)
        return
    assert h0.unique_state_count() < solo_twopc["unique"]
    g2 = MuxGroup(solo_twopc["model"], knobs=dict(KNOBS),
                  program_cache=cache, program_key=("twopc", 3),
                  device="cpu")
    h0r = g2.admit("j-0r", checkpoint_path=c0, resume_from=c0)
    h0r.join()
    g2.join(timeout=30)
    _assert_solo(h0r, solo_twopc, dm, c0)
    assert h0r.scheduler_stats()["program_cache"]["hits"] >= 1


def test_a_tenant_preempted_at_a_fixed_wave_resumes_in_a_fresh_group(
        solo_twopc, tmp_path):
    """The same drill at a wave the test picks: the group is held before
    its first wave, so the preempt lands at the first boundary after one
    wave of both tenants."""
    g = MuxGroup(solo_twopc["model"], knobs=dict(KNOBS), device="cpu")
    c0 = str(tmp_path / "t0.npz")
    real = g._wave
    waves = []

    def one_then_preempt():
        real()
        waves.append(1)
        if len(waves) == 1:
            h0.preempt()

    g._wave = one_then_preempt
    with g._cv:
        h0 = g.admit("j-0", checkpoint_path=c0)
        h1 = g.admit("j-1")
    h1.join()
    h0.join()
    g.join(timeout=30)
    assert h0.preempted and h0.unique_state_count() < solo_twopc["unique"]
    dm = solo_twopc["model"].device_model()
    _assert_solo(h1, solo_twopc, dm)
    g2 = MuxGroup(solo_twopc["model"], knobs=dict(KNOBS), device="cpu")
    h0r = g2.admit("j-0r", checkpoint_path=c0, resume_from=c0)
    h0r.join()
    g2.join(timeout=30)
    _assert_solo(h0r, solo_twopc, dm, c0)


@pytest.mark.parametrize("name, params", [
    ("pingpong", None), ("vsr", {"n": 2}), ("increment_lock", None)],
    ids=["pingpong", "vsr2", "increment_lock"])
def test_mux_matrix_siblings(tmp_path, name, params):
    """Beyond 2pc: two tenants a group across other corpus shapes, each
    the solo run's counters, discoveries and checkpoint sections."""
    solo = _solo(name, params, str(tmp_path / "solo.npz"))
    g = MuxGroup(solo["model"], knobs={"batch_size": 32,
                                       "table_capacity": 1 << 14},
                 program_cache=WaveProgramCache(), program_key=(name,),
                 device="cpu")
    ckpts = [str(tmp_path / f"{name}-{i}.npz") for i in range(2)]
    handles = [g.admit(f"{name}-{i}", checkpoint_path=ckpts[i])
               for i in range(2)]
    for h in handles:
        h.join()
    g.join(timeout=60)
    dm = solo["model"].device_model()
    for h, ckpt in zip(handles, ckpts):
        _assert_solo(h, solo, dm, ckpt)


def test_admission_refusals_and_knobs():
    """A full group refuses another tenant; a knob outside ``MUX_KNOBS``
    is refused; the default device is the card, never quietly the CPU."""
    model, _ = default_registry().build("twopc")
    with pytest.raises(ValueError, match="mux-eligible"):
        MuxGroup(model, knobs={"symmetry": True}, device="cpu")
    g = MuxGroup(model, knobs={"batch_size": 32}, max_jobs=1, device="cpu")
    with g._cv:
        h = g.admit("a")
        assert g.admit("b") is None
    assert h.join().unique_state_count() == 288
    g.join(timeout=30)
    assert g.admit("c") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MuxGroup(model)


@pytest.mark.slow
def test_mux_early_stop_equals_solo_at_effective_width():
    """An early stop (every property found before the end) stops at a
    wave, which depends on the rows a wave: two tenants splitting a
    32-row wave see 16 rows each, so they equal a solo batch-16 run."""
    model, _ = default_registry().build("increment", None)
    ref_model, _ = ref_registry().build("increment", None)
    solo16 = ref_model.checker().spawn_tpu_bfs(
        fused=False, batch_size=16, table_capacity=1 << 14).join()
    assert solo16.discoveries()
    g = MuxGroup(model, knobs={"batch_size": 32,
                               "table_capacity": 1 << 14},
                 program_cache=WaveProgramCache(),
                 program_key=("increment",), device="cpu")
    handles = [g.admit(f"i-{i}") for i in range(2)]
    for h in handles:
        h.join()
    g.join(timeout=60)
    for h in handles:
        assert h.state_count() == solo16.state_count()
        assert h.unique_state_count() == solo16.unique_state_count()
