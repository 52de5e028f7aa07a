"""Runtime PIM cost table (paper §5.1, "Timing Models") — port's copy.

Counterpart of ``repro.core.cost_table``, cut to what the serving engine
runs: the EMA ``update`` per observed tail expert and the batched
``update_batch`` the measured feed absorbs, the lookups the host scheduler
and the feed issue, the dense float32 ``export`` behind the
device-resident ``SieveState``, and ``state_dict``/``load_state_dict`` for
engine snapshots.  Same storage (dense ``count -> seconds`` float64 array
plus a dict spill), same arithmetic and the same ``version`` steps, so
both packages export bit-identical tables from the same observations and
skip the same refreshes.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

_DENSE_CAP = 1 << 20


class CostTable:
    """EMA table: token count -> observed PIM execution time (seconds)."""

    def __init__(self, fallback: Callable[[int], float], alpha: float = 0.25):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self._fallback = fallback
        self.alpha = alpha
        self._dense = np.zeros(0, dtype=np.float64)
        self._dense_ok = np.zeros(0, dtype=bool)
        self._big: Dict[int, float] = {}
        self.n_updates = 0
        self.n_fallback_lookups = 0
        self.n_rejected = 0
        # bumps on every mutation, so the engine skips re-exports when
        # nothing changed since the last refresh
        self.version = 0
        self._fallback_memo: Dict[int, float] = {}

    def _get(self, key: int):
        if 0 <= key < self._dense_ok.shape[0] and self._dense_ok[key]:
            return float(self._dense[key])
        return self._big.get(key)

    def lookup(self, n_tokens: int) -> float:
        t = self._get(int(n_tokens))
        if t is not None:
            return t
        self.n_fallback_lookups += 1
        return self._fallback(int(n_tokens))

    def has(self, n_tokens: int) -> bool:
        return self._get(int(n_tokens)) is not None

    def observed(self) -> Dict[int, float]:
        out = {int(k): float(self._dense[k]) for k in np.nonzero(self._dense_ok)[0]}
        out.update(self._big)
        return out

    def lookup_vec(self, counts) -> np.ndarray:
        """Observed seconds per token count, the fallback where a count has
        no observation (bit-identical to the reference's ``lookup``)."""
        c = np.asarray(counts, dtype=np.int64)
        out = np.empty(c.shape, dtype=np.float64)
        n_dense = self._dense_ok.shape[0]
        in_range = (c >= 0) & (c < n_dense)
        hit = np.zeros(c.shape, dtype=bool)
        if n_dense:
            hit[in_range] = self._dense_ok[c[in_range]]
            out[hit] = self._dense[c[hit]]
        miss = ~hit
        if miss.any():
            memo = self._fallback_memo
            vals = []
            for k in c[miss].tolist():
                t = self._big.get(k)
                if t is None:
                    t = memo.get(k)
                    if t is None:
                        t = float(self._fallback(k))
                        memo[k] = t
                    self.n_fallback_lookups += 1
                vals.append(t)
            out[miss] = vals
        return out

    def export(self, max_count: int) -> np.ndarray:
        """Dense float32 ``count -> seconds`` array: ``export(m)[c] ==
        float32(lookup(c))`` for ``1 <= c <= m`` and ``export(m)[0] == 0``."""
        out = np.empty(max_count + 1, dtype=np.float64)
        out[0] = 0.0
        if max_count:
            counts = np.arange(1, max_count + 1, dtype=np.int64)
            out[1:] = self.lookup_vec(counts)
        return out.astype(np.float32)

    def _ensure_dense(self, key: int) -> None:
        if key >= self._dense_ok.shape[0]:
            new_len = max(2 * self._dense_ok.shape[0], key + 1, 64)
            dense = np.zeros(new_len, dtype=np.float64)
            ok = np.zeros(new_len, dtype=bool)
            dense[: self._dense.shape[0]] = self._dense
            ok[: self._dense_ok.shape[0]] = self._dense_ok
            self._dense, self._dense_ok = dense, ok

    def update(self, n_tokens: int, observed_time: float) -> float:
        """EMA update; returns the new table value.  Non-finite times are
        skipped (counted in ``n_rejected``); negative ones raise."""
        if not np.isfinite(observed_time):
            self.n_rejected += 1
            prev = self._get(int(n_tokens))
            return prev if prev is not None else self._fallback(int(n_tokens))
        if observed_time < 0:
            raise ValueError("observed_time must be non-negative")
        key = int(n_tokens)
        prev = self._get(key)
        if prev is None:
            new = float(observed_time)
        else:
            new = (1.0 - self.alpha) * prev + self.alpha * float(observed_time)
        if 0 <= key < _DENSE_CAP:
            self._ensure_dense(key)
            self._dense[key] = new
            self._dense_ok[key] = True
        else:
            self._big[key] = new
        self.n_updates += 1
        self.version += 1
        return new

    def update_many(self, items) -> None:
        for n_tokens, t in items:
            self.update(n_tokens, t)

    def update_batch(self, counts, times, assume_unique: bool = False) -> None:
        """Sequential-equivalent batch of :meth:`update` calls: one
        vectorized EMA step (one ``version`` bump) when the keys are
        distinct and dense, else one ``update`` per key in order.  Non-finite
        times are dropped and counted in ``n_rejected``."""
        c = np.asarray(counts, dtype=np.int64)
        t = np.asarray(times, dtype=np.float64)
        if c.shape != t.shape:
            raise ValueError("counts and times must have matching shapes")
        finite = np.isfinite(t)
        if not finite.all():
            self.n_rejected += int((~finite).sum())
            c, t = c[finite], t[finite]
        if c.size and (t < 0).any():
            raise ValueError("observed_time must be non-negative")
        if (
            c.size
            and c.min(initial=0) >= 0
            and c.max(initial=0) < _DENSE_CAP
            and (assume_unique or np.unique(c).size == c.size)
        ):
            self._ensure_dense(int(c.max()))
            ok = self._dense_ok[c]
            prev = self._dense[c]
            new = np.where(ok, (1.0 - self.alpha) * prev + self.alpha * t, t)
            self._dense[c] = new
            self._dense_ok[c] = True
            self.n_updates += c.size
            self.version += 1
            return
        for key, obs in zip(c.tolist(), t.tolist()):
            self.update(key, obs)

    def state_dict(self) -> dict:
        return {"alpha": self.alpha, "table": self.observed()}

    def load_state_dict(self, state: dict) -> None:
        """Replace the observations (keys may arrive as strings from a JSON
        blob).  Bumps ``version`` once, as the reference does; a snapshot
        restore then sets ``version`` verbatim."""
        self.alpha = float(state["alpha"])
        self._dense = np.zeros(0, dtype=np.float64)
        self._dense_ok = np.zeros(0, dtype=bool)
        self._big = {}
        for k, v in state["table"].items():
            key, val = int(k), float(v)
            if 0 <= key < _DENSE_CAP:
                self._ensure_dense(key)
                self._dense[key] = val
                self._dense_ok[key] = True
            else:
                self._big[key] = val
        self.version += 1
