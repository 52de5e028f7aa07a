"""Runtime telemetry core: ring-buffered spans + metric aggregates (port's
copy of ``repro.telemetry.core``, numpy only).

Low-overhead instrumentation substrate for the serving stack (the signal
layer the Sieve scheduler's evidence — bimodal expert distributions,
head/tail arithmetic-intensity disparity — is read from at runtime):

* **Spans** — named timed regions recorded into a fixed-capacity ring of
  parallel numpy arrays (no per-event dict/list allocation; wraparound
  overwrites the oldest events).  Timestamps come from a monotonic
  ``perf_counter_ns`` clock, or are supplied explicitly in seconds by
  discrete-event callers (the cluster simulator records *simulated*
  time on per-replica tracks).
* **Counters / gauges / histograms** — named aggregates kept in dicts
  next to the ring, exported as a Prometheus-style text snapshot
  (:meth:`Telemetry.snapshot`).  Counter/gauge updates also drop a
  sample point into the ring so the same signal renders as a Perfetto
  counter track (``repro_torch.telemetry.export``).

**Disabled mode is the default posture and is allocation-free on the hot
path**: every public method early-returns, and :meth:`Telemetry.span`
hands back one shared no-op context-manager singleton — no object is
created per call.
A disabled engine step is bit-for-bit identical to an uninstrumented
one; enabling telemetry never changes results, only records timings.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

_NAN = float("nan")

# ring record kinds
KIND_SPAN = 0  # timed region: [t0, t0+dur)
KIND_POINT = 1  # counter/gauge sample: value at t0


class _NullSpan:
    """Shared no-op context manager returned by disabled telemetry."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """Live span: records (t_enter, duration) into the ring on exit."""

    __slots__ = ("_tel", "_name_id", "_track_id", "_value", "_t0")

    def __init__(self, tel: "Telemetry", name_id: int, track_id: int, value: float):
        self._tel = tel
        self._name_id = name_id
        self._track_id = track_id
        self._value = value

    def __enter__(self):
        self._t0 = self._tel._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        tel = self._tel
        tel._emit(
            KIND_SPAN, self._name_id, self._track_id,
            self._t0, tel._clock() - self._t0, self._value,
        )
        return False


class _Hist:
    """Power-of-two bucketed histogram (Prometheus cumulative export)."""

    # bucket b counts observations with value <= 2**b; last bucket = +Inf
    N_BUCKETS = 22  # le 1, 2, 4, ..., 2**20, +Inf

    # upper bounds of the finite buckets, for one-searchsorted bucketing
    # (values past the last finite bound land in the +Inf bucket)
    _BOUNDS = 2.0 ** np.arange(N_BUCKETS - 1)

    __slots__ = ("buckets", "total", "count", "vmax")

    def __init__(self):
        self.buckets = np.zeros(self.N_BUCKETS, dtype=np.int64)
        self.total = 0.0
        self.count = 0
        self.vmax = 0.0

    def observe_many(self, values: np.ndarray) -> None:
        v = np.asarray(values, dtype=np.float64).reshape(-1)
        if v.size == 0:
            return
        # index of the first bound >= v (side="left" keeps exact powers of
        # two in their own le-bucket); past the last bound -> +Inf bucket
        idx = np.searchsorted(self._BOUNDS, v, side="left")
        self.buckets += np.bincount(idx, minlength=self.N_BUCKETS)
        self.total += float(v.sum())
        self.count += int(v.size)
        self.vmax = max(self.vmax, float(v.max()))

    def bounds(self) -> List[float]:
        return [float(2 ** b) for b in range(self.N_BUCKETS - 1)] + [math.inf]


def _sanitize(name: str) -> str:
    """Prometheus metric-name form of a span/metric name."""
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


class Telemetry:
    """Ring-buffered span/metric recorder; a no-op when ``enabled=False``.

    One instance is one recording session (one clock domain): the serving
    engine records wall-clock ns, the cluster simulator records simulated
    seconds via the explicit-timestamp entry points (:meth:`span_at`,
    :meth:`point`).  ``capacity`` bounds memory — the ring keeps the most
    recent ``capacity`` events and counts what it overwrote
    (:attr:`n_overflowed`).
    """

    def __init__(
        self,
        capacity: int = 1 << 15,
        enabled: bool = True,
        clock: Callable[[], int] = time.perf_counter_ns,
    ):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._clock = clock
        n = self.capacity
        self._kind = np.zeros(n, dtype=np.uint8)
        self._name = np.zeros(n, dtype=np.int32)
        self._track = np.zeros(n, dtype=np.int32)
        self._t0 = np.zeros(n, dtype=np.int64)  # ns
        self._dur = np.zeros(n, dtype=np.int64)  # ns (0 for points)
        self._val = np.zeros(n, dtype=np.float64)
        self._head = 0  # total events ever emitted (monotone cursor)
        self._names: List[str] = []
        self._name_ids: Dict[str, int] = {}
        self._tracks: List[str] = []
        self._track_ids: Dict[str, int] = {}
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Hist] = {}
        self._default_track = self._intern_track("main")

    # ---- interning -------------------------------------------------------
    def _intern(self, name: str) -> int:
        nid = self._name_ids.get(name)
        if nid is None:
            nid = len(self._names)
            self._names.append(name)
            self._name_ids[name] = nid
        return nid

    def _intern_track(self, track: Optional[str]) -> int:
        if track is None:
            return 0 if self._tracks else self._intern_track("main")
        tid = self._track_ids.get(track)
        if tid is None:
            tid = len(self._tracks)
            self._tracks.append(track)
            self._track_ids[track] = tid
        return tid

    @property
    def tracks(self) -> List[str]:
        return list(self._tracks)

    # ---- ring ------------------------------------------------------------
    def _emit(
        self, kind: int, name_id: int, track_id: int,
        t0_ns: int, dur_ns: int, value: float,
    ) -> None:
        i = self._head % self.capacity
        self._kind[i] = kind
        self._name[i] = name_id
        self._track[i] = track_id
        self._t0[i] = t0_ns
        self._dur[i] = dur_ns
        self._val[i] = value
        self._head += 1

    @property
    def n_emitted(self) -> int:
        """Total events ever emitted (the monotone ring cursor)."""
        return self._head

    @property
    def n_overflowed(self) -> int:
        """Events the ring has overwritten (lost to wraparound)."""
        return max(0, self._head - self.capacity)

    # ---- recording -------------------------------------------------------
    def span(self, name: str, value: float = _NAN, track: Optional[str] = None):
        """Context manager timing a region on the instance's clock.

        ``value`` is optional numeric metadata carried on the span (e.g.
        the token count a stage probe executed — what
        :class:`repro_torch.telemetry.TimingFeed` keys on).  Returns the shared
        no-op singleton when disabled (zero allocation).
        """
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, self._intern(name), self._intern_track(track), value)

    def span_at(
        self, name: str, t_start_s: float, dur_s: float,
        track: Optional[str] = None, value: float = _NAN,
    ) -> None:
        """Record a completed span with explicit timestamps (seconds).

        The discrete-event entry point: the cluster simulator stamps spans
        with *simulated* time, so a whole knee-finder sweep renders as one
        Perfetto timeline across replicas.
        """
        if not self.enabled:
            return
        # non-finite stamps can't be represented in the int64 ring; record
        # a zero-duration span at t=0 instead of raising — downstream
        # consumers (TimingFeed) reject dur <= 0, so corrupt timings from
        # a faulted clock degrade to "no sample", never a crash
        if not math.isfinite(t_start_s):
            t_start_s = 0.0
        dur_ns = int(dur_s * 1e9) if math.isfinite(dur_s) else 0
        self._emit(
            KIND_SPAN, self._intern(name), self._intern_track(track),
            int(t_start_s * 1e9), max(dur_ns, 0), value,
        )

    def point(
        self, name: str, value: float,
        t_s: Optional[float] = None, track: Optional[str] = None,
    ) -> None:
        """Record a counter-track sample (renders as ``ph:"C"`` in traces)."""
        if not self.enabled:
            return
        t_ns = self._clock() if t_s is None else int(t_s * 1e9)
        self._emit(
            KIND_POINT, self._intern(name), self._intern_track(track),
            t_ns, 0, float(value),
        )

    def counter(
        self, name: str, inc: float = 1.0,
        t_s: Optional[float] = None, track: Optional[str] = None,
    ) -> None:
        """Monotonic counter: aggregate for the snapshot + a ring sample
        carrying the new cumulative value."""
        if not self.enabled:
            return
        new = self._counters.get(name, 0.0) + inc
        self._counters[name] = new
        self.point(name, new, t_s=t_s, track=track)

    def gauge(
        self, name: str, value: float,
        t_s: Optional[float] = None, track: Optional[str] = None,
    ) -> None:
        """Last-value gauge: aggregate for the snapshot + a ring sample."""
        if not self.enabled:
            return
        self._gauges[name] = float(value)
        self.point(name, value, t_s=t_s, track=track)

    def observe(self, name: str, values) -> None:
        """Histogram observation(s) (scalar or array), aggregate-only."""
        if not self.enabled:
            return
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = _Hist()
        h.observe_many(np.atleast_1d(values))

    # ---- reading ---------------------------------------------------------
    def _order(self, start: int) -> np.ndarray:
        """Ring indices for absolute event ids [start, head), oldest first."""
        ids = np.arange(start, self._head, dtype=np.int64)
        return ids % self.capacity

    def events(self) -> List[dict]:
        """All retained events, oldest first, as plain dicts."""
        return self.events_since(0)[0]

    def events_since(self, cursor: int) -> Tuple[List[dict], int]:
        """Events with absolute id >= ``cursor`` (clamped to what the ring
        still holds) plus the new cursor.  Consumers that poll (e.g.
        :class:`repro_torch.telemetry.TimingFeed`) pass the returned cursor back
        in; events lost to wraparound between polls are skipped."""
        start = max(cursor, self._head - self.capacity, 0)
        idx = self._order(start)
        out = []
        for i in idx:
            out.append(
                {
                    "kind": "span" if self._kind[i] == KIND_SPAN else "point",
                    "name": self._names[self._name[i]],
                    "track": self._tracks[self._track[i]],
                    "t0_ns": int(self._t0[i]),
                    "dur_ns": int(self._dur[i]),
                    "value": float(self._val[i]),
                }
            )
        return out, self._head

    def counters(self) -> Dict[str, float]:
        return dict(self._counters)

    def gauges(self) -> Dict[str, float]:
        return dict(self._gauges)

    # ---- Prometheus-style text snapshot ---------------------------------
    def snapshot(self, prefix: str = "repro_") -> str:
        """Aggregates as Prometheus text exposition (counters, gauges,
        histograms with cumulative ``_bucket{le=...}`` lines)."""
        lines: List[str] = []
        for name in sorted(self._counters):
            m = prefix + _sanitize(name)
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {self._counters[name]:g}")
        for name in sorted(self._gauges):
            m = prefix + _sanitize(name)
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {self._gauges[name]:g}")
        for name in sorted(self._hists):
            h = self._hists[name]
            m = prefix + _sanitize(name)
            lines.append(f"# TYPE {m} histogram")
            cum = 0
            for b, le in zip(h.buckets, h.bounds()):
                cum += int(b)
                le_s = "+Inf" if math.isinf(le) else f"{le:g}"
                lines.append(f'{m}_bucket{{le="{le_s}"}} {cum}')
            lines.append(f"{m}_sum {h.total:g}")
            lines.append(f"{m}_count {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Process-wide default instance
# ---------------------------------------------------------------------------

_default: Optional[Telemetry] = None


def default() -> Telemetry:
    """The process-wide instance components fall back to when no explicit
    :class:`Telemetry` is passed.  Disabled (compiled-out hot path) unless
    ``REPRO_TELEMETRY=1`` is set at first use."""
    global _default
    if _default is None:
        _default = Telemetry(
            enabled=os.environ.get("REPRO_TELEMETRY", "0")
            not in ("0", "false", "False", ""),
        )
    return _default
