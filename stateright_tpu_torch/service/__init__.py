"""The checking service's layer of the port, as far as it is ported.

- ``registry``: the corpus of models by name and the canonical parameter
  keys that scope the program cache (``jit_cache.py``);
- ``mux``: many same-shape jobs in one shared wave (``MuxGroup``), each
  tenant's results those of its solo run.

The job service, the differential fuzz gate and the overload controller
(with its disarmed ``NullControl``, which a group reads only once an
armed one can be given) are not ported yet (ROADMAP A13).
"""

from .mux import MUX_KNOBS, MuxGroup, TenantHandle
from .registry import CorpusEntry, ModelRegistry, default_registry

__all__ = ["CorpusEntry", "ModelRegistry", "default_registry",
           "MuxGroup", "TenantHandle", "MUX_KNOBS"]
