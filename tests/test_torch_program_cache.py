"""The program cache and the corpus registry of the port against JAX's.

``stateright_tpu_torch/service/registry.py`` is held to
``stateright_tpu/service/registry.py`` (the port arm of
``tests/test_service.py::test_registry_corpus``): the nine names, their
defaults and docs, the refusals, the coercion and every program key
equal; each entry builds the port's twin of JAX's model. Then
``jit_cache.WaveProgramCache`` on the engines (``spawn_cuda_bfs(
program_cache=, program_key=)``, keyed as JAX keys it): a second engine
of the same key records a hit and classifies no model again (the matmul
gate runs once), with the counts and discovery chains of JAX's engines
under JAX's cache, which record the same hit. Exact throughout.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import stateright_tpu.tpu  # noqa: F401,E402  (enables x64)
from stateright_tpu.jit_cache import WaveProgramCache as RefCache  # noqa: E402
from stateright_tpu.service.registry import (  # noqa: E402
    default_registry as ref_registry)
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
from stateright_tpu_torch import matmul_wave  # noqa: E402
from stateright_tpu_torch.jit_cache import (WaveProgramCache,  # noqa: E402
                                            shared_program_cache)
from stateright_tpu_torch.service import default_registry  # noqa: E402

torch.set_num_threads(2)


def test_registry_corpus():
    r = default_registry()
    assert r.names() == ["abd", "increment", "increment_lock", "paxos",
                         "pingpong", "single_copy", "sliding_puzzle",
                         "twopc", "vsr"]
    with pytest.raises(KeyError):
        r.entry("raft")
    with pytest.raises(ValueError):
        r.resolve_params("twopc", {"rms": 5})
    assert r.resolve_params("twopc", {"rm_count": "5"}) == {"rm_count": 5}
    assert r.program_key("twopc", {"rm_count": 3}) == \
        r.program_key("twopc", None)
    assert r.program_key("twopc", {"rm_count": 5}) != \
        r.program_key("twopc", None)
    assert any(e["name"] == "vsr" and e["params"]["n"] == 3
               for e in r.describe())


def test_the_listing_and_every_program_key_equal_jax():
    ours, ref = default_registry(), ref_registry()
    assert ours.describe() == ref.describe()
    for name in ref.names():
        assert ours.program_key(name) == ref.program_key(name)
        params = {k: (str(v) if isinstance(v, int) and not
                      isinstance(v, bool) else v)
                  for k, v in ref.resolve_params(name, None).items()}
        assert ours.program_key(name, params) == \
            ref.program_key(name, params)


@pytest.mark.parametrize("name", ["twopc", "paxos", "increment",
                                  "increment_lock", "single_copy", "abd",
                                  "pingpong", "sliding_puzzle", "vsr"])
def test_every_entry_builds_the_port_twin(name):
    """The port's model at the registry's defaults is JAX's twin: the same
    encoding width and fanout, and the same init states' fingerprints."""
    ours, params = default_registry().build(name)
    ref, ref_params = ref_registry().build(name)
    assert params == ref_params
    dm, ref_dm = ours.device_model(), ref.device_model()
    assert (dm.state_width, dm.max_fanout) == (ref_dm.state_width,
                                               ref_dm.max_fanout)
    fps = [host_fp64(np.asarray(dm.encode(s), np.uint32))
           for s in ours.init_states()]
    ref_fps = [host_fp64(np.asarray(ref_dm.encode(s), np.uint32))
               for s in ref.init_states()]
    assert fps == ref_fps


def _chains(c, dm):
    return {k: (p.fingerprints if hasattr(p, "fingerprints") else [
        host_fp64(np.asarray(dm.encode(s), np.uint32))
        for s in p.into_states()]) for k, p in c.discoveries().items()}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "classic"])
def test_a_second_same_key_engine_hits_and_classifies_once(monkeypatch,
                                                           fused):
    """Two engines of one registry key under one cache, with
    ``wave_matmul=True``: the second records a hit and no second
    classification, and both give JAX's counts and chains; JAX's two
    engines under its cache record the same miss and hit."""
    calls = []
    real = matmul_wave.gate

    def counted(dm, device):
        calls.append(type(dm).__name__)
        return real(dm, device)

    monkeypatch.setattr(matmul_wave, "gate", counted)
    key = default_registry().program_key("twopc", {"rm_count": 3})
    cache, ref_cache = WaveProgramCache(), RefCache()
    knobs = dict(batch_size=16, wave_matmul=True, wave_kernel=True,
                 fused=fused)
    runs = []
    for _ in range(2):
        model, _ = default_registry().build("twopc", {"rm_count": 3})
        ours = model.checker().spawn_cuda_bfs(
            device="cpu", program_cache=cache, program_key=key,
            **knobs).join()
        ref_model, _ = ref_registry().build("twopc", {"rm_count": 3})
        ref = ref_model.checker().spawn_tpu_bfs(
            program_cache=ref_cache, program_key=key, **knobs).join()
        runs.append((ours, ref))
    assert calls == ["TwoPhaseDevice"]
    (first, ref_first), (second, ref_second) = runs
    assert first.scheduler_stats()["program_cache"] == {
        "shared": True, "hits": 0, "misses": 1}
    assert second.scheduler_stats()["program_cache"] == {
        "shared": True, "hits": 1, "misses": 0}
    assert ref_second.scheduler_stats()["program_cache"]["hits"] >= 1
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1
    for ours, ref in runs:
        assert ours.kernel_path() == "megakernel_plain+matmul"
        assert (ours.unique_state_count(), ours.state_count()) == (
            ref.unique_state_count(), ref.state_count()) == (288, 1146)
        assert _chains(ours, ours._dm) == _chains(ref, ref._dm)


def test_the_key_holds_the_path_knobs_and_needs_both_arguments(
        monkeypatch):
    """Another ``wave_kernel`` is another key (a miss), as in JAX; a cache
    without a key, or a key without a cache, shares nothing."""
    calls = []
    real = matmul_wave.gate
    monkeypatch.setattr(matmul_wave, "gate",
                        lambda dm, device: calls.append(1) or real(dm,
                                                                   device))
    key = default_registry().program_key("increment_lock", None)
    cache = WaveProgramCache()

    def spawn(**kw):
        model, _ = default_registry().build("increment_lock")
        return model.checker().spawn_cuda_bfs(
            device="cpu", batch_size=16, wave_matmul=True, **kw).join()

    on = spawn(wave_kernel=True, program_cache=cache, program_key=key)
    off = spawn(wave_kernel=False, program_cache=cache, program_key=key)
    assert [c.scheduler_stats()["program_cache"]["misses"]
            for c in (on, off)] == [1, 1]
    alone = [spawn(program_cache=cache), spawn(program_key=key)]
    assert all(c.scheduler_stats()["program_cache"] == {
        "shared": False, "hits": 0, "misses": 0} for c in alone)
    assert len(calls) == 4
    assert {c.unique_state_count() for c in [on, off] + alone} == {61}
    assert shared_program_cache() is shared_program_cache()
