"""Health detection for the serving engine's measured cost loop and the
chaos harness (port's copy of ``repro.faults.health``).

:class:`HealthMonitor` keeps one EMA drift/spike monitor
(:class:`StragglerMonitor`) per named target and adds:

* a state machine per target (``healthy -> degraded -> healthy``, plus
  an explicit ``failed`` state that only :meth:`mark_recovered` clears)
  with hysteresis: ``confirm`` consecutive breaches to flag, ``recover``
  consecutive in-bound observations to clear, so one outlier never flips
  the state;
* breaches do not pollute the EMA baseline, so a long degradation is
  still measured against the healthy baseline and clearance is
  detectable;
* a staleness watchdog (:meth:`watch`) over monotone counters: a feed
  that silently stops advancing is a fault even though no sample ever
  looked wrong;
* a bounded transition log with timestamps, from which harnesses read
  time-to-detect and time-to-clear, and optional telemetry points
  (``health/<target>`` series).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

HEALTHY = "healthy"
DEGRADED = "degraded"
FAILED = "failed"

_STATUS_CODE = {HEALTHY: 0.0, DEGRADED: 1.0, FAILED: 2.0}


class StragglerMonitor:
    """EMA step-time monitor; flags steps slower than ``threshold`` x EMA."""

    def __init__(self, alpha: float = 0.2, threshold: float = 2.0, warmup: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.n = 0
        self.flagged: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.n += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = self.n > self.warmup and dt > self.threshold * self.ema
        if is_straggler:
            self.flagged.append(step)
            # do not pollute the EMA with the spike
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return is_straggler


@dataclass(frozen=True)
class Transition:
    """One health-state change (timestamps are caller time: step indices
    for the serving engine)."""

    t: float
    target: str
    old: str
    new: str
    reason: str = ""


@dataclass
class _TargetState:
    monitor: StragglerMonitor
    status: str = HEALTHY
    bad_streak: int = 0
    good_streak: int = 0
    last_value: float = 0.0
    # staleness watchdog
    last_counter: Optional[float] = None
    stale_checks: int = 0


class HealthMonitor:
    """Keyed EMA drift + spike detection with hysteresis and a watchdog.

    ``threshold``/``alpha``/``warmup`` parameterize the per-target
    :class:`StragglerMonitor`; ``confirm`` breaches flag a target
    ``degraded`` and ``recover`` in-bound observations clear it.
    ``stale_after`` consecutive unchanged :meth:`watch` checks flag
    staleness (the watchdog is orthogonal to the value stream: a target
    can be value-healthy but stale).

    The transition log is bounded (``max_transitions``; oldest entries
    drop first, counted in ``n_transitions_dropped``) so a long run with a
    flapping target cannot grow it without limit.
    """

    def __init__(
        self,
        threshold: float = 3.0,
        alpha: float = 0.2,
        warmup: int = 1,
        confirm: int = 1,
        recover: int = 1,
        stale_after: int = 3,
        telemetry=None,
        max_transitions: int = 4096,
    ):
        if confirm < 1 or recover < 1:
            raise ValueError("confirm and recover must be >= 1")
        if max_transitions < 1:
            raise ValueError("max_transitions must be >= 1")
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.confirm = confirm
        self.recover = recover
        self.stale_after = stale_after
        self.tel = telemetry
        self.max_transitions = int(max_transitions)
        self._targets: Dict[str, _TargetState] = {}
        self.transitions: List[Transition] = []
        self.n_transitions_dropped = 0

    # ------------------------------------------------------------------
    def _state(self, target: str) -> _TargetState:
        st = self._targets.get(target)
        if st is None:
            st = self._targets[target] = _TargetState(
                monitor=StragglerMonitor(
                    alpha=self.alpha,
                    threshold=self.threshold,
                    warmup=self.warmup,
                )
            )
        return st

    def _set(self, st: _TargetState, target: str, new: str, t: float, reason: str):
        if st.status == new:
            return
        self.transitions.append(
            Transition(t=t, target=target, old=st.status, new=new, reason=reason)
        )
        if len(self.transitions) > self.max_transitions:
            drop = len(self.transitions) - self.max_transitions
            del self.transitions[:drop]
            self.n_transitions_dropped += drop
        st.status = new
        if self.tel is not None and self.tel.enabled:
            self.tel.point(f"health/{target}", _STATUS_CODE[new], t_s=t)

    # ------------------------------------------------------------------
    def observe(self, target: str, value: float, t: float = 0.0) -> str:
        """Absorb one observation for ``target``; returns its status.

        ``value`` is whatever drift signal the caller tracks — a step
        duration for replicas, a measured/proxy time ratio for the PIM
        stack.  The EMA baseline forms over the first ``warmup + 1``
        observations; after that, breaches (``value > threshold * ema``)
        count toward ``degraded`` and never feed the baseline.
        """
        st = self._state(target)
        st.last_value = value
        breach = st.monitor.observe(st.monitor.n, value)
        if st.status == FAILED:
            # an explicitly failed target only recovers via mark_recovered
            return st.status
        if breach:
            st.bad_streak += 1
            st.good_streak = 0
            if st.status == HEALTHY and st.bad_streak >= self.confirm:
                self._set(st, target, DEGRADED, t,
                          f"drift {value:.3g} > {self.threshold:g}x ema")
        else:
            st.good_streak += 1
            st.bad_streak = 0
            if st.status == DEGRADED and st.good_streak >= self.recover:
                self._set(st, target, HEALTHY, t, "drift cleared")
        return st.status

    def watch(self, target: str, counter: float, t: float = 0.0) -> bool:
        """Staleness watchdog: True when ``counter`` (a monotone version,
        e.g. ``CostTable.version``) has not advanced for ``stale_after``
        consecutive checks."""
        st = self._state(target)
        advanced = st.last_counter is not None and counter != st.last_counter
        if st.last_counter is not None and not advanced:
            st.stale_checks += 1
        else:
            st.stale_checks = 0
        st.last_counter = counter
        stale = st.stale_checks >= self.stale_after
        if stale and st.status == HEALTHY:
            self._set(st, target, DEGRADED, t,
                      f"stale: counter stuck at {counter:g}")
        elif advanced and st.status == DEGRADED:
            # the watchdog owns this target's DEGRADED state, so an
            # advancing counter is the recovery signal
            self._set(st, target, HEALTHY, t, "counter advancing")
        return stale

    # ------------------------------------------------------------------
    def mark_failed(self, target: str, t: float = 0.0, reason: str = "") -> None:
        self._set(self._state(target), target, FAILED, t, reason or "failed")

    def mark_recovered(self, target: str, t: float = 0.0, reason: str = "") -> None:
        st = self._state(target)
        st.bad_streak = st.good_streak = 0
        st.stale_checks = 0
        self._set(st, target, HEALTHY, t, reason or "recovered")

    # ------------------------------------------------------------------
    def status(self, target: str) -> str:
        st = self._targets.get(target)
        return st.status if st is not None else HEALTHY

    def is_healthy(self, target: str) -> bool:
        return self.status(target) == HEALTHY

    def targets(self) -> List[str]:
        return sorted(self._targets)

    def status_counts(self, prefix: str = "") -> Dict[str, int]:
        """Census of per-target statuses (optionally restricted to targets
        whose name starts with ``prefix``): ``counts[FAILED] == total``
        means the pool is gone."""
        counts = {HEALTHY: 0, DEGRADED: 0, FAILED: 0}
        for name, st in self._targets.items():
            if prefix and not name.startswith(prefix):
                continue
            counts[st.status] = counts.get(st.status, 0) + 1
        return counts

    def time_to_detect(self, target: str, fault_t: float) -> Optional[float]:
        """Time from ``fault_t`` to the first non-healthy transition of
        ``target`` at or after it; None if never detected."""
        for tr in self.transitions:
            if tr.target == target and tr.new != HEALTHY and tr.t >= fault_t:
                return tr.t - fault_t
        return None

    def time_to_clear(self, target: str, clear_t: float) -> Optional[float]:
        """Time from ``clear_t`` to the first healthy transition of
        ``target`` at or after it; None if it never recovered."""
        for tr in self.transitions:
            if tr.target == target and tr.new == HEALTHY and tr.t >= clear_t:
                return tr.t - clear_t
        return None

    # ---- persistence (engine snapshots) -----------------------
    def state_dict(self) -> dict:
        """JSON-friendly runtime state (config knobs excluded —
        they belong to the constructor, not the snapshot)."""
        return {
            "targets": {
                name: {
                    "status": st.status,
                    "bad_streak": st.bad_streak,
                    "good_streak": st.good_streak,
                    "last_value": st.last_value,
                    "last_counter": st.last_counter,
                    "stale_checks": st.stale_checks,
                    "ema": st.monitor.ema,
                    "n": st.monitor.n,
                    "flagged": list(st.monitor.flagged),
                }
                for name, st in self._targets.items()
            },
            "transitions": [
                {
                    "t": tr.t,
                    "target": tr.target,
                    "old": tr.old,
                    "new": tr.new,
                    "reason": tr.reason,
                }
                for tr in self.transitions
            ],
            "n_transitions_dropped": self.n_transitions_dropped,
        }

    def load_state_dict(self, state: dict) -> None:
        self._targets = {}
        for name, d in state["targets"].items():
            st = self._state(name)
            st.status = d["status"]
            st.bad_streak = int(d["bad_streak"])
            st.good_streak = int(d["good_streak"])
            st.last_value = float(d["last_value"])
            st.last_counter = (
                None if d["last_counter"] is None else float(d["last_counter"])
            )
            st.stale_checks = int(d["stale_checks"])
            st.monitor.ema = None if d["ema"] is None else float(d["ema"])
            st.monitor.n = int(d["n"])
            st.monitor.flagged = [int(x) for x in d["flagged"]]
        self.transitions = [Transition(**tr) for tr in state["transitions"]]
        self.n_transitions_dropped = int(state["n_transitions_dropped"])
