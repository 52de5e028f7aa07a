"""TimingFeed: span-measured stage durations -> the EMA cost table (port's
copy of ``repro.telemetry.timing_feed``).

Closes the cost loop: instead of the DRAM-model proxy
(``repro_torch.sim.dram.PimGemvModel``) synthesizing "observed"
PIM times, the serving engine *measures* its tail-stage executions via
telemetry spans (``stage/tail_gemv`` probes carrying the token count as
span value) and this feed aggregates them into
:meth:`repro_torch.core.cost_table.CostTable.update_batch` on the engine's EMA
refresh cadence.  The next ``SieveState`` export then drives the in-graph
``dual_path_cost`` split from *measured* timings — the model-proxy path
stays available as the oracle/fallback (``cost_source="model"``).

The feed is the trust boundary between raw measurements and the split
decision, so it defends the table (in order):

1. **validity** — non-finite or non-positive durations and malformed
   token counts are rejected outright;
2. **intra-poll MAD clipping** — within one poll's samples of a single
   token count, observations further than ``mad_k`` median-absolute-
   deviations from the median are rejected (a poisoned probe among
   honest repeats cannot skew the window mean);
3. **ratio gating vs the EMA** — an aggregated observation more than
   ``clip_ratio`` x away (either direction) from the table's current
   value for that count is rejected, so a single wild probe cannot move
   the split.  Genuine sustained drift beyond the gate starves the feed
   instead — which the engine's :class:`repro_torch.faults.HealthMonitor`
   staleness watchdog and drift detector turn into a quarantine +
   model-proxy fallback (the graceful-degradation path);
4. **quarantine** — while ``quarantined`` is set the feed still polls
   (``last_raw`` keeps feeding the health monitor) but absorbs nothing.

Events lost to ring wraparound between polls are simply skipped — the
EMA is robust to missing windows.
"""

from __future__ import annotations

import math
from typing import Dict, List

from .core import Telemetry

TAIL_SPAN = "stage/tail_gemv"


class TimingFeed:
    """Aggregates measured stage spans into a :class:`CostTable`.

    Polls the telemetry ring with a monotone cursor; each :meth:`poll`
    groups the new ``span_name`` spans by their token-count value, means
    the surviving durations per count (several probes of one count within
    a window collapse into one EMA step, mirroring the engine's deduped
    observations), and absorbs the batch with ``update_batch``.
    """

    def __init__(
        self,
        table,
        telemetry: Telemetry,
        span_name: str = TAIL_SPAN,
        clip_ratio: float = 8.0,
        mad_k: float = 6.0,
    ):
        if clip_ratio <= 1.0:
            raise ValueError(f"clip_ratio must be > 1, got {clip_ratio}")
        self.table = table
        self.tel = telemetry
        self.span_name = span_name
        self.clip_ratio = clip_ratio
        self.mad_k = mad_k
        self._cursor = 0
        self.n_polls = 0
        self.n_fed = 0  # distinct (count -> time) entries absorbed
        self.n_rejected = 0  # samples/aggregates dropped by the filters
        # raw per-count means of the last poll, pre-gating — the drift
        # signal the HealthMonitor compares against the model proxy
        self.last_raw: Dict[int, float] = {}
        # polls whose samples survived the filters (advances even while
        # quarantined — the staleness watchdog watches this to tell "feed
        # broken" from "feed held back", so recovery is detectable)
        self.n_ok = 0
        # while quarantined the feed observes but never writes the table
        self.quarantined = False
        # polls left with the ratio gate suspended (post-recovery re-warm)
        self._ungated_polls = 0

    # ------------------------------------------------------------------
    def rewarm(self, polls: int = 1) -> None:
        """Suspend the ratio gate for the next ``polls`` sample-bearing
        polls.  Called on health clearance: while the feed was quarantined
        the table may have been re-seeded from the model proxy (a
        different scale than wall-clock measurements), so the first
        measured window is accepted like a first observation — validity
        and MAD filtering still apply."""
        self._ungated_polls = max(self._ungated_polls, int(polls))

    def _mad_filter(self, xs: List[float]) -> List[float]:
        """Reject intra-window outliers via median absolute deviation."""
        if len(xs) < 4:
            return xs
        s = sorted(xs)
        n = len(s)
        med = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
        devs = sorted(abs(x - med) for x in xs)
        mad = devs[n // 2] if n % 2 else 0.5 * (devs[n // 2 - 1] + devs[n // 2])
        # noise floor: tiny MADs (near-identical samples) must not turn
        # ordinary jitter into rejections
        bound = self.mad_k * max(mad, 0.05 * med)
        kept = [x for x in xs if abs(x - med) <= bound]
        self.n_rejected += len(xs) - len(kept)
        return kept

    def poll(self) -> Dict[int, float]:
        """Absorb new measured spans; returns {count: mean seconds} fed
        (empty while quarantined — ``last_raw`` still updates)."""
        events, self._cursor = self.tel.events_since(self._cursor)
        by_count: Dict[int, list] = {}
        for e in events:
            if e["kind"] != "span" or e["name"] != self.span_name:
                continue
            v = e["value"]
            if math.isnan(v) or v < 1:
                continue
            dur = e["dur_ns"] * 1e-9
            if not math.isfinite(dur) or dur <= 0:
                self.n_rejected += 1
                continue
            by_count.setdefault(int(v), []).append(dur)
        if not by_count:
            return {}
        self.last_raw = {
            c: sum(xs) / len(xs) for c, xs in by_count.items()
        }
        # while quarantined nothing is written anyway, so the ratio gate's
        # only job is the n_ok progress signal — suspend it there so valid
        # (if inflated) samples register as progress and a cleared fault
        # is observable; the re-warm window also runs ungated
        gated = not self.quarantined and self._ungated_polls <= 0
        fed: Dict[int, float] = {}
        for c in sorted(by_count):
            xs = self._mad_filter(by_count[c])
            if not xs:
                continue
            t = sum(xs) / len(xs)
            prev = self.table.lookup(c) if self.table.has(c) else None
            if gated and prev is not None and prev > 0 and not (
                prev / self.clip_ratio <= t <= prev * self.clip_ratio
            ):
                # a single aggregate this far off the EMA is untrusted;
                # sustained drift starves the feed and trips the
                # staleness watchdog / health quarantine instead
                self.n_rejected += 1
                continue
            fed[c] = t
        if not gated:
            self._ungated_polls -= 1
        if fed:
            self.n_ok += 1
        if self.quarantined or not fed:
            return {}
        counts = sorted(fed)
        times = [fed[c] for c in counts]
        self.table.update_batch(counts, times, assume_unique=True)
        self.n_polls += 1
        self.n_fed += len(counts)
        return dict(zip(counts, times))

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """Runtime state for engine snapshots.  ``_cursor`` is deliberately
        excluded: it indexes the live telemetry ring, which does not
        survive a process restart — a restored feed polls its fresh ring
        from the beginning."""
        return {
            "n_polls": self.n_polls,
            "n_fed": self.n_fed,
            "n_rejected": self.n_rejected,
            "last_raw": {int(k): float(v) for k, v in self.last_raw.items()},
            "n_ok": self.n_ok,
            "quarantined": self.quarantined,
            "ungated_polls": self._ungated_polls,
        }

    def load_state_dict(self, state: dict) -> None:
        self.n_polls = int(state["n_polls"])
        self.n_fed = int(state["n_fed"])
        self.n_rejected = int(state["n_rejected"])
        self.last_raw = {int(k): float(v) for k, v in state["last_raw"].items()}
        self.n_ok = int(state["n_ok"])
        self.quarantined = bool(state["quarantined"])
        self._ungated_polls = int(state["ungated_polls"])
