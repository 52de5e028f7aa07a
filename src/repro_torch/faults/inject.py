"""FaultInjector: drives a :class:`FaultPlan`'s timeline into a consumer
(port's copy of ``repro.faults.inject``).

The injector is a deterministic event queue over the plan's expanded
``(t, phase, event)`` actions.  Consumers (the engine chaos harness here,
the cluster simulator's event loop in the JAX package) merge
:meth:`next_time` into their own clock and call :meth:`pop_due` at each
tick; the injector never touches targets itself — application is the
consumer's job, so the same plan can drive the request-level simulator
and the live engine.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .plan import FaultEvent, FaultPlan

_EPS = 1e-12


class FaultInjector:
    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._queue: List[Tuple[float, str, FaultEvent]] = plan.timeline()
        self._i = 0
        # applied actions, in application order — the reproducible fault
        # timeline the determinism tests compare
        self.applied: List[Tuple[float, str, FaultEvent]] = []
        # events currently inside their fault window
        self._active: List[FaultEvent] = []

    # ------------------------------------------------------------------
    @property
    def exhausted(self) -> bool:
        return self._i >= len(self._queue)

    def next_time(self) -> Optional[float]:
        """Time of the next pending action; None when exhausted."""
        if self.exhausted:
            return None
        return self._queue[self._i][0]

    def pop_due(self, now: float) -> List[Tuple[str, FaultEvent]]:
        """All actions with ``t <= now`` (plus epsilon), in order."""
        due = []
        while not self.exhausted and self._queue[self._i][0] <= now + _EPS:
            t, phase, ev = self._queue[self._i]
            self._i += 1
            self.applied.append((t, phase, ev))
            if phase == "start":
                self._active.append(ev)
            else:
                self._active = [a for a in self._active if a is not ev]
            due.append((phase, ev))
        return due

    def active(self, kind: Optional[str] = None) -> List[FaultEvent]:
        if kind is None:
            return list(self._active)
        return [ev for ev in self._active if ev.kind == kind]

    def timeline_log(self) -> List[Tuple[float, str, str, int, float]]:
        """Flattened applied log for reports/tests: (t, phase, kind,
        target, magnitude) tuples — hashable and JSON-friendly."""
        return [
            (t, phase, ev.kind, ev.target, ev.magnitude)
            for t, phase, ev in self.applied
        ]
