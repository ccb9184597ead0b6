"""The port stands alone: it imports neither JAX nor the JAX package.

An AST scan of every file of ``stateright_tpu_torch/`` (the classic
engine's ``classic.py`` and ``visitor.py``, the classic sharded engine's
``sharded.py``, the register models' ``models/single_copy.py`` and
``models/abd.py``, and the plain models' ``test_util.py``,
``models/increment.py``, ``models/increment_lock.py`` and
``models/sliding_puzzle.py``, and the actor models' ``models/pingpong.py``
and ``models/vsr.py``, and the matmul expand's ``matmul_wave.py``, and the
host engine's ``bfs.py``, ``_market.py``, ``fingerprint.py`` and
``semantics.py``, the shared ``host.py``, and the host DFS's ``dfs.py``
and ``symmetry.py`` and
the host actor layer's ``actor.py``, and the run telemetry's ``obs/``
package and ``profiling.py`` among them); a fresh interpreter that checks 2pc at 3 RMs
(on the host BFS, on the fused engine,
with a visitor on the classic engine and on the classic sharded engine,
and with ``wave_matmul=True``, classified by the port's own
``matmul_wave``), paxos at 1 client, single-copy at 2
clients on one server, ABD at 2 clients on two, LinearEquation, increment
and increment_lock at 2 threads, the 2x3 puzzle, ping-pong at max_nat 5 on
a lossy network and VSR at 2 replicas through the port on the CPU, 2pc
at 5 RMs and single-copy at 2 clients with symmetry on the host DFS,
VSR at 2 replicas on the host BFS, and
paxos on 5 servers through a ``spawn_cuda_bfs()`` that falls back to the
host BFS, and then finds neither ``jax`` nor ``stateright_tpu`` loaded; and
the entry point's default device, which is CUDA and raises on a box
without one.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from stateright_tpu_torch.models.twopc import TwoPhaseSys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "stateright_tpu_torch")
_BANNED = ("jax", "jaxlib", "stateright_tpu", "examples", "two_phase_commit",
           "paxos", "single_copy_register", "linearizable_register",
           "increment", "increment_lock", "sliding_puzzle", "test_util",
           "actor_test_util", "viewstamped")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(_PKG)
             for f in fs if f.endswith(".py")]
    assert len(files) >= 12
    names = {os.path.relpath(f, _PKG) for f in files}
    assert {"classic.py", "visitor.py", "sharded.py",
            "models/single_copy.py",
            "models/abd.py", "test_util.py", "models/increment.py",
            "models/increment_lock.py", "models/sliding_puzzle.py",
            "models/pingpong.py", "models/vsr.py",
            "matmul_wave.py", "bfs.py", "_market.py", "fingerprint.py",
            "semantics.py", "dfs.py", "symmetry.py", "actor.py",
            "host.py", "profiling.py", "obs/__init__.py", "obs/schema.py",
            "obs/tracer.py", "obs/flight.py", "obs/hist.py", "obs/slo.py",
            "obs/anomaly.py", "obs/prof.py"} <= names
    for path in files + [os.path.join(_REPO, "chip_smoke.py")]:
        for name in _imports(path):
            assert name.split(".")[0] not in _BANNED, (path, name)


def test_a_cpu_check_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from stateright_tpu_torch.models.twopc import TwoPhaseSys\n"
        "c = TwoPhaseSys(3).checker().spawn_cuda_bfs(device='cpu').join()\n"
        "assert (c.unique_state_count(), c.state_count()) == (288, 1146)\n"
        "c.assert_properties()\n"
        "from stateright_tpu_torch.visitor import StateRecorder\n"
        "rec, states = StateRecorder.new_with_accessor()\n"
        "c = (TwoPhaseSys(3).checker().visitor(rec)\n"
        "     .spawn_cuda_bfs(device='cpu').join())\n"
        "assert type(c).__name__ == 'CudaBfsChecker', type(c)\n"
        "assert (c.unique_state_count(), len(states())) == (288, 288)\n"
        "c = (TwoPhaseSys(3).checker().visitor(rec)\n"
        "     .spawn_cuda_bfs(mesh=['cpu'] * 2).join())\n"
        "assert type(c).__name__ == 'ShardedCudaBfsChecker', type(c)\n"
        "assert (c.unique_state_count(), len(states())) == (288, 576)\n"
        "c = TwoPhaseSys(3).checker().spawn_cuda_bfs(\n"
        "    device='cpu', wave_matmul=True).join()\n"
        "assert c.kernel_path() == 'dedup_plain+matmul', c.kernel_path()\n"
        "assert (c.unique_state_count(), c.state_count()) == (288, 1146)\n"
        "from stateright_tpu_torch.models.paxos import PaxosSys\n"
        "c = PaxosSys(1).checker().spawn_cuda_bfs(device='cpu').join()\n"
        "assert (c.unique_state_count(), c.state_count()) == (265, 482)\n"
        "c.assert_properties()\n"
        "from stateright_tpu_torch.models.single_copy import SingleCopySys\n"
        "c = SingleCopySys(2).checker().spawn_cuda_bfs(device='cpu').join()\n"
        "assert c.unique_state_count() == 93, c.unique_state_count()\n"
        "c.assert_properties()\n"
        "from stateright_tpu_torch.models.abd import AbdSys\n"
        "c = AbdSys(2, 2).checker().spawn_cuda_bfs(device='cpu').join()\n"
        "assert (c.unique_state_count(), c.state_count()) == (544, 875)\n"
        "c.assert_properties()\n"
        "from stateright_tpu_torch.test_util import LinearEquation\n"
        "c = LinearEquation(2, 10, 14).checker().spawn_cuda_bfs(\n"
        "    device='cpu').join()\n"
        "assert c.discovery('solvable') is not None\n"
        "from stateright_tpu_torch.models.increment import IncrementModel\n"
        "c = IncrementModel(2).checker().spawn_cuda_bfs(device='cpu').join()\n"
        "assert c.unique_state_count() == 13, c.unique_state_count()\n"
        "from stateright_tpu_torch.models.increment_lock import (\n"
        "    IncrementLockModel)\n"
        "c = IncrementLockModel(2).checker().spawn_cuda_bfs(\n"
        "    device='cpu').join()\n"
        "assert c.unique_state_count() == 17, c.unique_state_count()\n"
        "c.assert_properties()\n"
        "from stateright_tpu_torch.models.sliding_puzzle import (\n"
        "    SlidingPuzzle)\n"
        "c = SlidingPuzzle(2, 3).checker().spawn_cuda_bfs(\n"
        "    device='cpu').join()\n"
        "assert (c.unique_state_count(), c.state_count()) == (360, 841)\n"
        "from stateright_tpu_torch.models.pingpong import PingPongSys\n"
        "c = PingPongSys(5, lossy=True).checker().spawn_cuda_bfs(\n"
        "    device='cpu').join()\n"
        "assert (c.unique_state_count(), c.state_count()) == (4094, 21505)\n"
        "from stateright_tpu_torch.models.vsr import VsrSys\n"
        "c = VsrSys(2, 1).checker().spawn_cuda_bfs(device='cpu').join()\n"
        "assert (c.unique_state_count(), c.state_count()) == (63, 169)\n"
        "c.assert_properties()\n"
        "c = TwoPhaseSys(5).checker().symmetry().spawn_dfs().join()\n"
        "assert type(c).__name__ == 'DfsChecker', type(c)\n"
        "assert c.unique_state_count() == 665, c.unique_state_count()\n"
        "m = SingleCopySys(2)\n"
        "c = (m.checker().symmetry_fn(m.device_model().host_representative)\n"
        "     .spawn_dfs().join())\n"
        "assert c.unique_state_count() == 47, c.unique_state_count()\n"
        "c = VsrSys(2, 1).checker().spawn_bfs().join()\n"
        "assert (c.unique_state_count(), c.state_count()) == (63, 169)\n"
        "c = TwoPhaseSys(3).checker().spawn_bfs().join()\n"
        "assert type(c).__name__ == 'BfsChecker', type(c)\n"
        "assert (c.unique_state_count(), c.state_count()) == (288, 1146)\n"
        "c.assert_properties()\n"
        "import warnings\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        "    c = (PaxosSys(2, server_count=5).checker()\n"
        "         .target_state_count(1000).spawn_cuda_bfs().join())\n"
        "assert type(c).__name__ == 'BfsChecker', type(c)\n"
        "assert 'falling back to the host BFS' in str(w[0].message)\n"
        "assert (c.unique_state_count(), c.state_count()) == (3465, 8615)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'stateright_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_cuda_and_never_quietly_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        TwoPhaseSys(3).checker().spawn_cuda_bfs()
