"""Resilient execution: deterministic fault injection and supervised
crash recovery.

The port's copy of ``stateright_tpu/resilience``, its first part (ROADMAP
A13 (a)):

- **Fault injection** (``faults.py``): the ``STpu_FAULTS`` registry, with
  JAX's 14 points and hit counting, its hooks in the four device engines,
  the host BFS, the checkpoint writer, the classic sharded engine's
  exchange and the tiered store. Unset, a site pays one attribute check
  (``NULL_PLAN``). ``is_oom`` also takes the card's
  ``torch.OutOfMemoryError``.
- **Supervised recovery** (``supervisor.py``): bounded retry with
  jittered exponential backoff over an engine factory, each attempt
  resuming from the newest checkpoint generation that passes its CRCs
  (the ``.prev`` one when the current is torn), in place through the
  engine's ``restart_from``.

Not ported yet: the job service and its controller, which run each job
under a ``Supervisor`` (A13 (b)); the elastic runtime, ``Membership``,
``OwnerMap``, ``ElasticChecker`` and ``elastic_check`` (A13 (c)); and the
bench's ``child_death`` hook (the bench is not ported).
"""

from .faults import (FAULT_POINTS, FAULTS_ENV, ExchangeIntegrityError,
                     FaultPlan, InjectedFault, InjectedOom, NULL_PLAN,
                     fault_plan_from_env, is_oom, reset_fault_plans,
                     strip_point)
from .supervisor import Supervisor, newest_valid_checkpoint, supervise

__all__ = [
    "FAULT_POINTS", "FAULTS_ENV", "ExchangeIntegrityError", "FaultPlan",
    "InjectedFault", "InjectedOom", "NULL_PLAN", "fault_plan_from_env",
    "is_oom", "reset_fault_plans", "strip_point",
    "Supervisor", "newest_valid_checkpoint", "supervise",
]
