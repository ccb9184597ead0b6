"""The port's wave-time attribution (``stateright_tpu_torch/profiling.py``)
against JAX's ``measure_wave_breakdown``, on the CPU: the same keys and
stages, the same frontier driven (``states``, ``waves`` and the buckets
equal to JAX's for the same arguments), JAX's ``deadline_s`` rule, the
stages as spans of the trace, and ``roofline`` by stage from the kernels'
declared costs."""

import json
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import pytest  # noqa: E402

from paxos import PaxosModelCfg  # noqa: E402
from stateright_tpu.tpu.profiling import \
    measure_wave_breakdown as ref_breakdown  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosSys  # noqa: E402
from stateright_tpu_torch.models.twopc import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.obs import validate_event  # noqa: E402
from stateright_tpu_torch.profiling import (STAGES,  # noqa: E402
                                            measure_wave_breakdown)
from stateright_tpu_torch.table import dedup_cost  # noqa: E402

#: the keys of the result that count the frontier, not the clock
_PROGRESS = ("waves", "states", "batch_size", "bucket_ladder",
             "bucket_waves", "ladder_rows_waves",
             "local_dedup_collapse_ratio")


def test_wave_breakdown_shape_and_progress():
    """JAX's test, on the port: paxos at 1 client, batch 128, 4 waves,
    2^14 slots; the progress keys equal JAX's run of the same
    arguments."""
    out = measure_wave_breakdown(PaxosSys(1), batch_size=128, max_waves=4,
                                 table_capacity=1 << 14, device="cpu")
    ref = ref_breakdown(PaxosModelCfg(1, 3).into_model(), batch_size=128,
                        max_waves=4, table_capacity=1 << 14)
    assert set(out) == set(ref)
    assert set(out["stages_sec"]) == set(STAGES) == set(ref["stages_sec"])
    assert {k: out[k] for k in _PROGRESS} == {k: ref[k] for k in _PROGRESS}
    # Paxos is matmul-irregular (sentinel lane domains).
    assert out["stages_sec"]["matmul_expand"] == 0.0
    assert out["waves"] >= 1 and out["states"] > 0
    assert out["fused_wave_sec"] > 0 and out["fused_wave_ladder_sec"] > 0
    assert out["stages_sec"]["wave_kernel"] > 0
    assert out["stages_sec"]["dedup_insert"] > 0
    assert 0.0 <= out["local_dedup_collapse_ratio"] <= 1.0
    assert abs(sum(out["stages_share"].values()) - 1.0) < 0.02


def test_roofline_by_stage_from_declared_costs():
    """``roofline`` is keyed by stage: kernel 1's stage carries its
    declared bytes at the wave's shape, a torch stage null costs, each a
    measured time; 2pc is matmul-regular, so its matmul stage runs."""
    out = measure_wave_breakdown(TwoPhaseSys(3), batch_size=32,
                                 table_capacity=1 << 12, max_waves=3,
                                 device="cpu")
    roof = out["roofline"]
    assert roof["dedup_insert"]["share"] is not None
    assert roof["wave_kernel"]["flops"] > 0
    assert roof["expand"]["flops"] is None and roof["expand"]["share"] is None
    assert all(r["measured_s"] > 0 for r in roof.values())
    assert out["stages_sec"]["matmul_expand"] > 0
    F = TwoPhaseSys(3).device_model().max_fanout
    assert roof["dedup_insert"]["bytes"] == dedup_cost(32 * F)["bytes"]


def test_deadline_bounds_warmup():
    """``deadline_s=0``: past the budget before the first stage ends, so
    no wave counts; without one, warm waves are counted (JAX's rule)."""
    bd = measure_wave_breakdown(TwoPhaseSys(3), batch_size=32,
                                table_capacity=1 << 12, max_waves=4,
                                deadline_s=0.0, device="cpu")
    assert bd["waves"] == 0 and bd["states"] == 0
    bd2 = measure_wave_breakdown(TwoPhaseSys(3), batch_size=32,
                                 table_capacity=1 << 12, max_waves=3,
                                 device="cpu")
    assert bd2["waves"] >= 1


def test_stages_are_spans_of_the_trace(tmp_path, monkeypatch):
    path = tmp_path / "prof.jsonl"
    monkeypatch.setenv("STpu_TRACE", str(path))
    measure_wave_breakdown(TwoPhaseSys(3), batch_size=32,
                           table_capacity=1 << 12, max_waves=2,
                           device="cpu")
    monkeypatch.delenv("STpu_TRACE")
    events = [json.loads(line) for line in open(path) if line.strip()]
    spans = {e["name"] for e in events if e.get("type") == "span"}
    assert {"properties", "expand", "fingerprint", "local_dedup",
            "dedup_insert", "compact", "wave_kernel", "fused_wave",
            "fused_wave_ladder"} <= spans
    assert any(e.get("type") == "profile_snapshot" for e in events)
    assert all(validate_event(e) == [] for e in events)


def test_the_card_is_the_default(monkeypatch):
    """With no device given it asks for the card, and raises here."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_wave_breakdown(TwoPhaseSys(3), batch_size=32)
