"""stateright_tpu_torch: the model checker's device engine in PyTorch,
with its kernels written for NVIDIA Hopper.

A port of ``stateright_tpu``'s device BFS engines, with the host BFS they
fall back to. It imports neither JAX nor ``stateright_tpu``; the JAX
package is the reference its tests hold it to. Entry points:
``Model.checker().spawn_cuda_bfs()`` and ``.spawn_bfs()``.
"""

from .builder import CheckerBuilder
from .model import Expectation, Model, Property

__all__ = ["CheckerBuilder", "Expectation", "Model", "Property"]
