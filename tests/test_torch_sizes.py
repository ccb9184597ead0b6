"""Kernels 2 and 3 at every model size JAX's kernels take.

The port's entry points hold each model over a range of sizes, with
instances a capacity and the size at run time (``csrc/models/*.cuh``'s
dispatch): increment and increment_lock at 1 to 16 threads and their plan
forms at 1 to 8, the puzzle on every board of 2 to 16 cells, single-copy
at its 22 (clients, servers) pairs and ABD at its 16, ping-pong and VSR
(1 to 4 replicas) at up to 64 network slots. On the CPU:

- ``cuda_model()`` and ``wave.cuda_plan()`` walk each range: every size
  is admitted, and the first size past each range is refused with a
  message that names the range held (the card raises there rather than
  fall back), a register workload's network past its default slots
  too;
- the registry's defaults, increment and increment_lock at 3 threads,
  with ``wave_kernel=True`` (the kernels' plain versions) against JAX's
  ``spawn_tpu_bfs(wave_kernel=True)`` (its Pallas kernels in interpret
  mode, as JAX's own tests run them) on the four engines: counts,
  capacities, discovery chains and ``kernel_path()``.

The device code of every size is held to the port's step by
``tests/test_torch_device_code.py``; the card's runs are
``chip_smoke.py``'s phase 14.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as RefMesh

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import stateright_tpu.tpu  # noqa: F401,E402  (enables x64)
import increment as ref_inc  # noqa: E402
import increment_lock as ref_lock  # noqa: E402
from stateright_tpu.tpu.hashing import host_fp64  # noqa: E402
from stateright_tpu_torch import matmul_wave, wave  # noqa: E402
from stateright_tpu_torch.models import (  # noqa: E402
    abd, increment, increment_lock, paxos, pingpong, single_copy,
    sliding_puzzle, vsr)
from stateright_tpu_torch.packing import compile_layout  # noqa: E402

torch.set_num_threads(2)


def _admits(dm) -> bool:
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    try:
        wave.cuda_model(dm, layout)
    except NotImplementedError as e:
        assert "wave_kernel=False" in str(e)
        return False
    return True


def _refused(dm, held: str) -> bool:
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    with pytest.raises(NotImplementedError, match=held):
        wave.cuda_model(dm, layout)
    return True


@pytest.mark.parametrize("cls", [increment.IncrementDevice,
                                 increment_lock.IncrementLockDevice])
def test_thread_counts_1_to_16_are_held(cls):
    assert all(_admits(cls(t)) for t in range(1, 17))
    assert _refused(cls(17), "it holds 1 to 16")


def test_every_board_of_2_to_16_cells_is_held():
    boards = [(r, c) for r in range(1, 17) for c in range(1, 17)
              if 2 <= r * c <= 16]
    assert all(_admits(sliding_puzzle.PuzzleDevice(r, c)) for r, c in boards)
    assert len(boards) == len(sliding_puzzle.PuzzleDevice.CUDA_INSTANCES)
    for r, c in ((1, 17), (3, 6), (4, 5), (17, 1)):
        assert _refused(sliding_puzzle.PuzzleDevice(r, c), "2 to 16 cells")


def test_every_register_pair_with_a_device_form_is_held():
    """Every (clients, servers) pair JAX's device form takes: 1 to 4
    clients, at most 7 servers and 8 actors (22 for single-copy); ABD
    less the pairs whose request ids collide (clients > servers), which
    keep raising ``DeviceFormUnavailable`` as in JAX (16)."""
    sc = [(c, s) for c in range(1, 5) for s in range(1, 8) if c + s <= 8]
    assert all(_admits(single_copy.SingleCopyDevice(c, s)) for c, s in sc)
    assert len(sc) == 22
    held = []
    for c, s in sc:
        try:
            dm = abd.AbdDevice(c, s)
        except abd.DeviceFormUnavailable:
            assert c > s
            continue
        assert _admits(dm)
        held.append((c, s))
    assert len(held) == 16 and all(c <= s for c, s in held)


def test_actor_models_up_to_64_slots_are_held():
    for e in (1, 16, 26, 27, 32, 64):
        assert _admits(pingpong.PingPongDevice(3, net_slots=e))
    assert _refused(pingpong.PingPongDevice(3, net_slots=65),
                    "holds 1 to 64")
    for n in range(1, 5):
        for e in (1, 8 * n, 41, 49, 64):
            assert _admits(vsr.VsrDevice(n, 1, net_slots=e))
        assert _refused(vsr.VsrDevice(n, 1, net_slots=65), "1 to 64 slots")


def test_register_networks_past_the_default_are_refused():
    """A register workload's entry points hold 1 to its default network
    slots (paxos's at 1 to 4 clients, single-copy's and ABD's at every
    pair): one slot more is refused, naming the range."""
    for dm in (paxos.PaxosDevice(2), single_copy.SingleCopyDevice(3, 2),
               abd.AbdDevice(2, 4)):
        assert _admits(dm)
        e = dm.default_slots
        cls = type(dm)
        args = (dm.C,) if cls is paxos.PaxosDevice else (dm.C, dm.S)
        assert _admits(cls(*args, net_slots=1))
        assert _refused(cls(*args, net_slots=e + 1), f"1 to {e} network")


def test_paxos_at_4_clients_builds_from_sources_of_its_own():
    """The entry points pick paxos's sources by its client count
    (``wave.SPLIT_SOURCES``): 4 clients ``csrc/wave_paxos4.cu`` and
    ``sender_paxos4.cu``, 1 to 3 ``wave_paxos.cu`` and ``sender_paxos.cu``;
    every other model its own name's, a DGraph's array params too."""
    from stateright_tpu_torch import test_util
    from stateright_tpu_torch.model import Property

    for c, want in ((1, "paxos"), (3, "paxos"), (4, "paxos4")):
        dm = paxos.PaxosDevice(c)
        name, params, _ = wave.cuda_model(
            dm, compile_layout(dm.lane_bits(), dm.state_width))
        assert wave._source(name, params) == want
        assert wave.SENDER_SOURCES[want] == "sender_" + want
        assert os.path.exists(os.path.join(
            os.path.dirname(wave.__file__), "csrc", f"wave_{want}.cu"))
    graph = test_util.DGraph.with_property(
        Property.always("p")).with_path([0, 3, 1])
    name, params, _ = wave.cuda_model(graph.device_model(),
                                      compile_layout(None, 1))
    assert wave._source(name, params) == "dgraph"
    dm = single_copy.SingleCopyDevice(4, 1)
    assert wave._source(*wave.cuda_model(
        dm, compile_layout(dm.lane_bits(), dm.state_width))[:2]) == (
        "single_copy")


@pytest.mark.parametrize("cls", [increment.IncrementDevice,
                                 increment_lock.IncrementLockDevice])
def test_plan_forms_1_to_8_are_held(cls):
    """Each count's own plan (the gate finds the shared counters regular
    at 1 to 8 threads) is taken by ``cuda_plan``; past 8 the entry points
    hold no plan form."""
    for t in range(1, 9):
        dm = cls(t)
        verdict = matmul_wave.classify(dm)
        assert verdict.plan is not None, verdict.reason
        layout = compile_layout(dm.lane_bits(), dm.state_width)
        wave.cuda_plan(dm, layout, verdict.plan)
    dm = cls(9)
    layout = compile_layout(dm.lane_bits(), dm.state_width)
    with pytest.raises(NotImplementedError, match="1 to 8"):
        wave.cuda_plan(dm, layout, verdict.plan)


# -- The registry's defaults on the kernels, against JAX --------------------


#: each engine's knobs on both sides at 3 shards (the classic ones
#: without the successor ladder, whose rungs JAX compiles a program each)
ENGINES = {
    "fused": (dict(), dict(device="cpu")),
    "classic": (dict(fused=False, pack_arena=True, succ_ladder=False),
                dict(device="cpu", fused=False, succ_ladder=False)),
    "sharded": (dict(sharded=True), dict(mesh=["cpu"] * 3)),
    "sharded_classic": (dict(sharded=True, fused=False, pack_arena=True,
                             succ_ladder=False),
                        dict(mesh=["cpu"] * 3, fused=False,
                             succ_ladder=False))}
MODELS = {"increment": (ref_inc.IncrementModel, increment.IncrementModel,
                        ["fin"]),
          "increment_lock": (ref_lock.IncrementLockModel,
                             increment_lock.IncrementLockModel, [])}


def _ref_chains(c):
    dm = c._dm
    return {name: [host_fp64(np.asarray(dm.encode(s), np.uint32))
                   for s in path.into_states()]
            for name, path in c.discoveries().items()}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("name", list(MODELS))
def test_registry_default_on_the_kernels_matches_jax(name, engine):
    """The registry's and the examples' default, 3 threads, on the
    kernels' path (JAX's Pallas kernels in interpret mode, the port's
    plain versions): counts, capacities, discovery chains and the path
    each side names."""
    ref_cls, cls, found = MODELS[name]
    ref_kw, kw = ENGINES[engine]
    ref_kw = dict(ref_kw)
    if "sharded" in engine:
        ref_kw["mesh"] = RefMesh(np.array(jax.devices()[:3]), ("shard",))
    ref = ref_cls(3).checker().spawn_tpu_bfs(
        wave_kernel=True, batch_size=16, **ref_kw).join()
    ours = cls(3).checker().spawn_cuda_bfs(
        wave_kernel=True, batch_size=16, **kw).join()
    assert ref.kernel_path() == "interpret"
    assert ours.kernel_path() == ("sender_plain" if "sharded" in engine
                                  else "megakernel_plain")
    counts = (ours.unique_state_count(), ours.state_count())
    assert counts == (ref.unique_state_count(), ref.state_count())
    if name == "increment_lock":
        assert counts == (61, 61)
    assert ours._capacity == ref._capacity
    chains = {k: p.fingerprints for k, p in ours.discoveries().items()}
    assert sorted(chains) == found
    assert chains == _ref_chains(ref)
