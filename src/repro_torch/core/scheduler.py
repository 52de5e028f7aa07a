"""Host-side Sieve scheduler (paper §5) — port's copy.

Counterpart of ``repro.core.scheduler``, cut to the two policies the
serving engine runs: ``sieve`` (the paper's greedy, the engine default)
and ``dual_cost`` (the host twin of the cost-driven dual-path split).
Every other policy name raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from .cost_model import CostModel
from .cost_table import CostTable

POLICIES = ("sieve", "dual_cost")


@dataclass
class Partition:
    """Result of a scheduling decision for one MoE layer on one device."""

    gpu_experts: np.ndarray
    pim_experts: np.ndarray
    t_comm: float
    t_gpu: float
    t_pim: float
    iterations: int = 0
    policy: str = "sieve"
    meta: dict = field(default_factory=dict)

    @property
    def t_total(self) -> float:
        return max(self.t_comm, self.t_gpu, self.t_pim)


def _active(counts: np.ndarray):
    """Expert ids with >=1 token, sorted by count descending (stable)."""
    counts = np.asarray(counts, dtype=np.int64)
    ids = np.nonzero(counts > 0)[0]
    order = np.argsort(-counts[ids], kind="stable")
    return ids[order], counts


def _prefix_times(counts, cost_model, cost_table):
    ids, counts = _active(counts)
    t_comm = cost_model.t_comm(int(counts.sum()))
    sorted_counts = counts[ids]
    t_gpu_all = cost_model.t_gpu_prefix(sorted_counts)
    t_pim_all = cost_model.t_pim_suffix(sorted_counts, cost_table)
    t_all = np.maximum(np.maximum(t_gpu_all, t_pim_all), t_comm)
    return ids, sorted_counts, t_comm, t_gpu_all, t_pim_all, t_all


def sieve_schedule(
    counts: Sequence[int],
    cost_model: CostModel,
    cost_table: Optional[CostTable] = None,
) -> Partition:
    """Paper §5.2 greedy: the first prefix split whose successor does not
    strictly improve T_total."""
    ids, sorted_counts, t_comm, t_gpu_all, t_pim_all, t_all = _prefix_times(
        counts, cost_model, cost_table
    )
    n = len(ids)
    nonimp = np.nonzero(t_all[1:] >= t_all[:-1])[0]
    g = int(nonimp[0]) if nonimp.size else n
    return Partition(
        gpu_experts=ids[:g].copy(),
        pim_experts=ids[g:].copy(),
        t_comm=t_comm,
        t_gpu=float(t_gpu_all[g]),
        t_pim=float(t_pim_all[g]),
        iterations=g + 2 if g < n else n + 1,
        policy="sieve",
        meta={"split": g, "n_active": n},
    )


def _dual_feasible_window(sorted_counts, tail_tokens: int, max_head: int):
    """``[lo, hi]``: every expert over ``tail_tokens`` rows must be in the
    head; ``max_head <= 0`` means no head budget."""
    n = len(sorted_counts)
    lo = int(np.sum(sorted_counts > tail_tokens))
    hi = n if max_head <= 0 else min(n, int(max_head))
    return lo, hi


def dual_cost_schedule(
    counts: Sequence[int],
    cost_model: CostModel,
    cost_table: Optional[CostTable] = None,
    *,
    tail_tokens: int = 1,
    max_head: int = 0,
) -> Partition:
    """Cost-driven dual-path split: prefix argmin clamped to the executor's
    feasibility window (host twin of ``dual_path_split_cost``)."""
    ids, sorted_counts, t_comm, t_gpu_all, t_pim_all, t_all = _prefix_times(
        counts, cost_model, cost_table
    )
    lo, hi = _dual_feasible_window(sorted_counts, tail_tokens, max_head)
    g = hi if lo > hi else lo + int(np.argmin(t_all[lo : hi + 1]))
    return Partition(
        gpu_experts=ids[:g].copy(),
        pim_experts=ids[g:].copy(),
        t_comm=t_comm,
        t_gpu=float(t_gpu_all[g]),
        t_pim=float(t_pim_all[g]),
        policy="dual_cost",
        meta={
            "split": g,
            "n_active": len(ids),
            "tail_tokens": tail_tokens,
            "window": (lo, hi),
        },
    )


def schedule(policy: str, counts, cost_model, cost_table=None, **kw) -> Partition:
    """Dispatch by policy name (see :data:`POLICIES`)."""
    if policy == "sieve":
        return sieve_schedule(counts, cost_model, cost_table)
    if policy == "dual_cost":
        return dual_cost_schedule(counts, cost_model, cost_table, **kw)
    raise ValueError(
        f"policy {policy!r} is not ported; expected one of {POLICIES}"
    )
