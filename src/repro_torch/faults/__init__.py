"""Deterministic fault injection and graceful degradation for the serving
runtime (port's copy of ``repro.faults``, less the cluster scenarios):

* **Injection** (:mod:`plan`, :mod:`inject`): a seeded, scripted
  :class:`FaultPlan` (same seed -> bit-identical fault timeline) and the
  :class:`FaultInjector` that replays it into a consumer.
* **Detection** (:mod:`health`): :class:`HealthMonitor`, per-target EMA
  drift and spike detection with hysteresis, a staleness watchdog, and
  the failed/recovered marks and census of a cluster's replicas.
* **Degradation and recovery** (:mod:`chaos` and the engine's hooks):
  unhealthy PIM clamps the sieve split to GPU-only with no new graph
  capture, and the measured cost feed is quarantined back to the
  roofline; :class:`EngineChaos` scripts such faults into a live engine.
"""

from .health import (  # noqa: F401
    DEGRADED,
    FAILED,
    HEALTHY,
    HealthMonitor,
    StragglerMonitor,
    Transition,
)
from .inject import FaultInjector  # noqa: F401
from .plan import (  # noqa: F401
    FAULT_KINDS,
    LINK_DEGRADE,
    PIM_BROWNOUT,
    PROBE_POISON,
    REPLICA_CRASH,
    STRAGGLE,
    FaultEvent,
    FaultPlan,
    make_plan,
)
from .chaos import (  # noqa: F401
    ENGINE_SCENARIOS,
    SCENARIOS,
    EngineChaos,
    run_chaos,
    run_engine_chaos,
)
