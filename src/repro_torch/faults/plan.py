"""Seeded, scripted fault plans: same seed -> bit-identical timeline
(port's copy of ``repro.faults.plan``, numpy only).

A :class:`FaultPlan` is a sorted tuple of :class:`FaultEvent` windows.
Event times are plain floats whose unit is the *consumer's* clock:
seconds of simulated time for the cluster simulator, engine step indices
for the serving-engine scenarios.  :func:`make_plan` derives every
jittered quantity from one ``numpy`` generator seeded by the caller, so a
plan is a pure function of ``(scenario, horizon, n_replicas, seed)`` —
the chaos determinism tests pin this.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

PIM_BROWNOUT = "pim_brownout"  # scale a replica's PIM timings by magnitude
REPLICA_CRASH = "replica_crash"  # kill a replica; in-flight work is lost
LINK_DEGRADE = "link_degrade"  # scale a replica's interconnect times
STRAGGLE = "straggle"  # scale a replica's whole step duration
PROBE_POISON = "probe_poison"  # corrupt measured stage-probe durations

FAULT_KINDS = (PIM_BROWNOUT, REPLICA_CRASH, LINK_DEGRADE, STRAGGLE, PROBE_POISON)


@dataclass(frozen=True)
class FaultEvent:
    """One fault window: ``[t, t + duration)`` on ``target``.

    ``magnitude`` is the degradation factor (timings multiply by it) for
    the degrade kinds, the corruption multiplier for ``probe_poison``,
    and ignored for ``replica_crash``.
    """

    t: float
    kind: str
    target: int = 0
    magnitude: float = 1.0
    duration: float = 0.0

    @property
    def t_clear(self) -> float:
        return self.t + self.duration


@dataclass(frozen=True)
class FaultPlan:
    """A scripted, reproducible fault schedule."""

    events: Tuple[FaultEvent, ...]
    scenario: str = ""
    seed: int = 0

    def __post_init__(self):
        for ev in self.events:
            if ev.kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {ev.kind!r}; expected one of {FAULT_KINDS}"
                )
            if ev.duration < 0:
                raise ValueError(f"fault duration must be >= 0, got {ev.duration}")
        object.__setattr__(
            self, "events", tuple(sorted(self.events, key=lambda e: (e.t, e.kind)))
        )

    @property
    def empty(self) -> bool:
        return not self.events

    def timeline(self):
        """Expanded ``(t, phase, event)`` actions, time-sorted; ``phase``
        is ``"start"`` or ``"clear"`` (crash windows clear = recover)."""
        acts = []
        for ev in self.events:
            acts.append((ev.t, "start", ev))
            acts.append((ev.t_clear, "clear", ev))
        acts.sort(key=lambda a: (a[0], a[1] == "start", a[2].kind, a[2].target))
        return acts

    def describe(self) -> str:
        lines = [f"FaultPlan(scenario={self.scenario!r}, seed={self.seed})"]
        for ev in self.events:
            lines.append(
                f"  t={ev.t:.4g} +{ev.duration:.4g} {ev.kind} "
                f"target={ev.target} x{ev.magnitude:g}"
            )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Scenarios (cluster scenarios use seconds; engine scenarios steps)
# ---------------------------------------------------------------------------


def _jitter(rng: np.random.Generator, lo: float, hi: float) -> float:
    return float(lo + (hi - lo) * rng.random())


def make_plan(
    scenario: str,
    horizon: float,
    n_replicas: int = 2,
    seed: int = 0,
    magnitude: float | None = None,
) -> FaultPlan:
    """Build the named chaos scenario's fault plan over ``horizon``.

    Cluster scenarios (``pim-brownout``, ``replica-crash``, ``link-flap``)
    interpret ``horizon`` as simulated seconds; the engine scenarios
    (``probe-poison``, ``pim-brownout-engine``) as a step count.  Faults
    start after a warm quarter and clear before the last quarter so every
    run observes healthy -> faulted -> recovered.
    """
    rng = np.random.default_rng(seed)
    target = int(rng.integers(0, max(n_replicas, 1)))
    if scenario == "pim-brownout":
        t0 = _jitter(rng, 0.25, 0.30) * horizon
        return FaultPlan(
            events=(
                FaultEvent(
                    t=t0, kind=PIM_BROWNOUT, target=target,
                    magnitude=magnitude or 8.0, duration=0.30 * horizon,
                ),
            ),
            scenario=scenario, seed=seed,
        )
    if scenario in ("replica-crash", "replica-crash-migrate"):
        # the -migrate variant consumes the same rng draws, so the fault
        # timeline is bit-identical to plain replica-crash — the warm-vs-
        # cold recovery comparison isolates the recovery policy
        t0 = _jitter(rng, 0.25, 0.30) * horizon
        return FaultPlan(
            events=(
                FaultEvent(
                    t=t0, kind=REPLICA_CRASH, target=target,
                    duration=0.30 * horizon,
                ),
            ),
            scenario=scenario, seed=seed,
        )
    if scenario == "link-flap":
        # several short degrade windows on one replica's links (flapping)
        events = []
        t = 0.25 * horizon
        for _ in range(3):
            dur = _jitter(rng, 0.04, 0.08) * horizon
            events.append(
                FaultEvent(
                    t=t, kind=LINK_DEGRADE, target=target,
                    magnitude=magnitude or 6.0, duration=dur,
                )
            )
            t += dur + _jitter(rng, 0.03, 0.06) * horizon
        return FaultPlan(events=tuple(events), scenario=scenario, seed=seed)
    if scenario == "straggler":
        t0 = _jitter(rng, 0.25, 0.30) * horizon
        return FaultPlan(
            events=(
                FaultEvent(
                    t=t0, kind=STRAGGLE, target=target,
                    magnitude=magnitude or 4.0, duration=0.30 * horizon,
                ),
            ),
            scenario=scenario, seed=seed,
        )
    if scenario in ("probe-poison", "pim-brownout-engine"):
        # engine scenarios: t is a step index; the fault spans the middle
        # refresh cadences of the run
        t0 = float(int(0.3 * horizon))
        dur = float(int(0.3 * horizon))
        # magnitudes sit far above the health threshold (default 4x) so
        # detection at the first faulted refresh boundary is robust to
        # wall-clock measurement noise in the sentinel baseline
        mag = magnitude or (1000.0 if scenario == "probe-poison" else 32.0)
        return FaultPlan(
            events=(
                FaultEvent(
                    t=t0, kind=PROBE_POISON if scenario == "probe-poison"
                    else PIM_BROWNOUT,
                    target=0, magnitude=mag, duration=dur,
                ),
            ),
            scenario=scenario, seed=seed,
        )
    raise ValueError(f"unknown chaos scenario {scenario!r}")
