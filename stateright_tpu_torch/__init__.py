"""stateright_tpu_torch: the model checker's device engine in PyTorch,
with its kernels written for NVIDIA Hopper.

A port of ``stateright_tpu``'s fused device BFS. It imports neither JAX
nor ``stateright_tpu``; the JAX package is the reference its tests hold
it to. Entry point: ``Model.checker().spawn_cuda_bfs()``.
"""

from .builder import CheckerBuilder
from .model import Expectation, Model, Property

__all__ = ["CheckerBuilder", "Expectation", "Model", "Property"]
