"""The port's engines' non-wave events against JAX's, on the CPU.

``grow``, ``overflow_redispatch``, ``ckpt_begin`` / ``ckpt_done``, the
``matmul_ops`` gauge, and the tiered store's ``spill`` / ``page_in`` /
``pressure`` under JAX's ``TIER_CFGS``: each run traced in JAX and in
the port with the same knobs, the streams held to each other as
``test_torch_obs_trace._same_streams`` holds them (every line valid under
both schemas, the lint clean, the waves and the other events equal but
for clock fields and ``kernel_path``).
"""

import pytest

from stateright_tpu.tpu.engine import TpuBfsChecker
from stateright_tpu_torch.classic import CudaBfsChecker
from test_torch_obs_trace import (DEVICE, _jax, _port, _same_streams,
                                  _traced, _two_pc)
from test_torch_tiered_store import TIER_CFGS


@pytest.mark.parametrize("engine,cfg", [("classic", "classic"),
                                        ("fused", "fused"),
                                        ("sharded", "sharded-classic"),
                                        ("sharded_fused", "sharded-fused")])
def test_tiered_store_events_equal_jax(tmp_path, monkeypatch, engine, cfg):
    """2pc 4 under JAX's ``TIER_CFGS``: the store's ``spill`` /
    ``page_in`` / ``pressure`` events and the waves' ``tier_*`` gauges are
    JAX's, in order."""
    knobs = {k: v for k, v in TIER_CFGS[cfg].items()
             if k not in ("fused", "sharded", "batch_size")}
    _, ref = _traced(monkeypatch, tmp_path / "jax.jsonl", _jax, engine,
                     _two_pc(4, False), tier_dir=str(tmp_path / "j"),
                     **knobs)
    _, ours = _traced(monkeypatch, tmp_path / "port.jsonl", _port, engine,
                      _two_pc(4, True), tier_dir=str(tmp_path / "p"),
                      **knobs)
    types = _same_streams(engine, ref, ours, tmp_path / "port.jsonl")
    if engine == "classic":
        assert {"spill", "page_in", "pressure"} <= set(types)
    elif engine == "fused":
        assert "spill" in types  # the arena-span rolls
    else:
        assert "pressure" in types
    waves = [e for e in ours if e["type"] == "wave"]
    assert all(w["tier_device_rows"] is not None for w in waves)


@pytest.mark.parametrize("engine", DEVICE)
def test_checkpoint_and_growth_events_equal_jax(tmp_path, monkeypatch,
                                                engine):
    """2pc 4 from a 2^12-slot table with a checkpoint every 2 waves: the
    ``grow`` and ``ckpt_begin`` / ``ckpt_done`` events are JAX's."""
    knobs = dict(table_capacity=1 << 12, checkpoint_every_waves=2)
    _, ref = _traced(monkeypatch, tmp_path / "jax.jsonl", _jax, engine,
                     _two_pc(4, False),
                     checkpoint_path=str(tmp_path / "j.npz"), **knobs)
    _, ours = _traced(monkeypatch, tmp_path / "port.jsonl", _port, engine,
                      _two_pc(4, True),
                      checkpoint_path=str(tmp_path / "p.npz"), **knobs)
    types = _same_streams(engine, ref, ours, tmp_path / "port.jsonl")
    assert "ckpt_begin" in types and "ckpt_done" in types
    assert types.count("ckpt_begin") == types.count("ckpt_done")


def test_overflow_and_matmul_events_equal_jax(tmp_path, monkeypatch):
    """The classic engine with every wave at an output rung of 8 rows
    (regathers: ``overflow_redispatch`` before the wave's event, its
    ``overflow`` flag set), then with ``wave_matmul=True`` (the
    ``matmul_ops`` gauge after ``run_start``): JAX's events."""
    rung = (lambda self, B: 8 if self._succ_ladder_on
            else self._succ_full_rows(B))
    monkeypatch.setattr(TpuBfsChecker, "_pick_out_rows", rung)
    monkeypatch.setattr(CudaBfsChecker, "_pick_out_rows", rung)
    _, ref = _traced(monkeypatch, tmp_path / "jax.jsonl", _jax, "classic",
                     _two_pc(4, False), table_capacity=1 << 12)
    _, ours = _traced(monkeypatch, tmp_path / "port.jsonl", _port,
                      "classic", _two_pc(4, True), table_capacity=1 << 12)
    types = _same_streams("classic", ref, ours, tmp_path / "port.jsonl")
    flagged = sum(1 for e in ours if e["type"] == "wave" and e["overflow"])
    assert flagged == types.count("overflow_redispatch") > 0
    assert "grow" in types
    monkeypatch.undo()
    _, ref = _traced(monkeypatch, tmp_path / "jax_mm.jsonl", _jax,
                     "fused", _two_pc(3, False), wave_matmul=True)
    _, ours = _traced(monkeypatch, tmp_path / "port_mm.jsonl", _port,
                      "fused", _two_pc(3, True), wave_matmul=True)
    types = _same_streams("fused", ref, ours, tmp_path / "port_mm.jsonl")
    assert types[:2] == ["run_start", "gauge"]
    gauge = next(e for e in ours if e["type"] == "gauge")
    assert gauge["name"] == "matmul_ops" and gauge["value"] > 0
