"""``spawn_cuda_bfs`` falls back to the host BFS where JAX's
``spawn_tpu_bfs`` does, and only there.

A configuration with no device form (``device_model()`` raises
``DeviceFormUnavailable``) checks on the host BFS, with JAX's warning, on
a box without a card too: paxos on 5 servers, paxos with 5 clients,
single-copy with 5 clients and ABD where request ids collide, each at a
target, against JAX's ``spawn_tpu_bfs()`` at the same target in counts
and discoveries. Under ``checkpoint_path``, ``resume_from`` or
``fused=True`` the spawn refuses, as JAX's does; a mesh is dropped with
the other knobs, by name. A device-formable model never falls back.
"""

import os
import sys
import warnings

import pytest
import torch

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import stateright_tpu.tpu  # noqa: F401,E402  (enables x64)
import linearizable_register as ref_abd  # noqa: E402
import paxos as ref_paxos  # noqa: E402
import single_copy_register as ref_sc  # noqa: E402
from stateright_tpu.tpu.device_model import \
    DeviceFormUnavailable as RefUnavailable  # noqa: E402
from stateright_tpu_torch.bfs import BfsChecker  # noqa: E402
from stateright_tpu_torch.device_model import DeviceFormUnavailable  # noqa: E402,E501
from stateright_tpu_torch.models.abd import AbdSys  # noqa: E402
from stateright_tpu_torch.models.paxos import PaxosSys  # noqa: E402
from stateright_tpu_torch.models.single_copy import SingleCopySys  # noqa: E402,E501

torch.set_num_threads(2)

#: each configuration's JAX and port models, its target and what the
#: fallback's warning names
CONFIGS = {
    "paxos 2/5": (lambda: ref_paxos.PaxosModelCfg(2, 5).into_model(),
                  lambda: PaxosSys(2, server_count=5), 1_000, "3 servers"),
    "paxos 5/3": (lambda: ref_paxos.PaxosModelCfg(5, 3).into_model(),
                  lambda: PaxosSys(5), 2_000, "1 to 4 clients"),
    "single-copy 5/1": (lambda: ref_sc.SingleCopyModelCfg(5, 1).into_model(),
                        lambda: SingleCopySys(5, 1), 2_000, "1 to 4 clients"),
    "abd 3/2": (lambda: ref_abd.AbdModelCfg(3, 2).into_model(),
                lambda: AbdSys(3, 2), 200, "request ids collide"),
}


def _summary(c):
    return (c.state_count(), c.unique_state_count(),
            {name: p.encode() for name, p in c.discoveries().items()})


@pytest.mark.parametrize("config", list(CONFIGS))
def test_fallback_equals_jax(config):
    ref_build, build, target, why = CONFIGS[config]
    with pytest.warns(RuntimeWarning, match="falling back to the host BFS"):
        ref = (ref_build().checker().target_state_count(target)
               .spawn_tpu_bfs().join())
    want = _summary(ref)
    for kw in ({}, {"device": "cpu"}):
        with pytest.warns(RuntimeWarning) as record:
            got = (build().checker().target_state_count(target)
                   .spawn_cuda_bfs(**kw).join())
        assert type(got) is BfsChecker
        (w,) = record
        assert why in str(w.message), w.message
        assert str(w.message).startswith(
            "no device form for this configuration (")
        assert str(w.message).endswith(
            "falling back to the host BFS engine" + (
                " (dropping engine knobs ['device'])" if kw else ""))
        assert _summary(got) == want


def _refusal(spawn, exc):
    with pytest.raises(exc) as info:
        spawn()
    return str(info.value).split("; refusing", 1)[1]


@pytest.mark.parametrize("knob", ["checkpoint_path", "resume_from", "fused"])
def test_refusals_match_jax(knob, tmp_path):
    kw = {"fused": True} if knob == "fused" else {knob: str(tmp_path / "c")}
    ref = _refusal(lambda: ref_paxos.PaxosModelCfg(2, 5).into_model()
                   .checker().spawn_tpu_bfs(**kw), RefUnavailable)
    got = _refusal(lambda: PaxosSys(2, server_count=5).checker()
                   .spawn_cuda_bfs(**kw), DeviceFormUnavailable)
    assert got == ref
    assert (knob if knob != "fused" else "fused=True") in got


def test_a_mesh_is_dropped_by_name():
    model = PaxosSys(2, server_count=5)
    with pytest.warns(RuntimeWarning) as record:
        c = (model.checker().target_state_count(100)
             .spawn_cuda_bfs(sharded=True, batch_size=64).join())
    assert type(c) is BfsChecker
    assert str(record[0].message).endswith(
        "(dropping engine knobs ['batch_size', 'mesh/sharded'])")


def test_a_device_formable_model_never_falls_back():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        c = PaxosSys(1).checker().spawn_cuda_bfs(device="cpu").join()
        assert type(c).__name__ == "FusedCudaBfsChecker"
        c = (PaxosSys(1).checker().visitor(lambda m, p: None)
             .spawn_cuda_bfs(device="cpu").join())
        assert type(c).__name__ == "CudaBfsChecker"
        assert (c.unique_state_count(), c.state_count()) == (265, 482)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                PaxosSys(1).checker().spawn_cuda_bfs()
