"""The Sieve scheduler (paper §5) and the baseline policies (paper §7.1):
port's copy of ``repro.core.scheduler``, every policy of it.

All policies take the runtime token-count vector over the activated experts
of one MoE layer on one device (+ its EP peers' routed tokens) and return a
:class:`Partition` assigning each activated expert to the GPU/xPU or to PIM.

Policies
--------
``sieve``          paper §5.2 greedy: sort by count desc, start all-on-PIM,
                   move the most popular expert to GPU while T_total strictly
                   decreases; stop at the first non-improvement.
``sieve_argmin``   beyond-paper refinement: T_total evaluated for *every*
                   prefix split of the sorted order, take the global argmin.
                   Never worse than the paper greedy (the greedy's result is
                   one of the evaluated prefixes); same O(E log E) cost.
``pimoe``          PIMoE (DAC'25) reproduction: channel-EP on PIM, moves the
                   most popular expert from the busiest PIM channel to the
                   GPU until T_GPU exceeds T_PIM.  Ignores both attention-
                   on-PIM time and inter-GPU communication (paper §5.2).
``noexp``          all experts on GPU, attention on PIM (NeuPIMs/PAISE).
``allexp``         all experts on PIM (PAPI/Stratum).
``gpu_only``       everything (incl. attention) on the GPU.
``dual_threshold`` the model layer's fixed rule (expert_exec="dual_path"):
                   head = experts with > tail_tokens rows, cost-blind.
``dual_cost``      the model layer's cost-driven rule
                   (expert_exec="dual_path_cost"): sieve prefix argmin
                   clamped to the dual-path feasibility window — the host
                   twin of scheduler_torch.dual_path_split_cost.

Hot path
--------
``sieve_schedule`` and ``pimoe_schedule`` are vectorized: T_Comm/T_GPU/T_PIM
are evaluated for *all* prefix splits of the sorted count vector at once via
cumulative sums (``CostModel.t_gpu_prefix`` / ``t_pim_suffix``), so both the
paper greedy and the argmin refinement cost one O(E log E) sort plus O(E)
scans — instead of O(E^2) cost-model calls.  The straightforward scalar
implementations are retained as ``sieve_schedule_reference`` /
``pimoe_schedule_reference`` (and ``dual_cost_schedule_reference``,
``brute_force_schedule``): the oracles of the JAX package's equivalence
suite.  The port holds each function to its JAX counterpart
(tests/test_torch_policies.py), never a vectorized form to a scalar
oracle: the two sum in other orders and need not be bit-identical on
every host.

An unknown policy name raises ``ValueError`` in :func:`schedule`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from .cost_model import CostModel, attention_time_on_xpu
from .cost_table import CostTable

POLICIES = (
    "sieve",
    "sieve_argmin",
    "pimoe",
    "pimoe_dynamic",
    "noexp",
    "allexp",
    "gpu_only",
    "dual_threshold",
    "dual_cost",
)


@dataclass
class Partition:
    """Result of a scheduling decision for one MoE layer on one device."""

    gpu_experts: np.ndarray  # expert ids assigned to the xPU (grouped GEMM)
    pim_experts: np.ndarray  # expert ids assigned to PIM (serialized GEMV)
    t_comm: float
    t_gpu: float
    t_pim: float
    iterations: int = 0
    policy: str = "sieve"
    meta: dict = field(default_factory=dict)

    @property
    def t_total(self) -> float:
        return max(self.t_comm, self.t_gpu, self.t_pim)

    def validate(self, n_active: int) -> None:
        s = set(self.gpu_experts.tolist())
        p = set(self.pim_experts.tolist())
        assert not (s & p), "expert assigned to both GPU and PIM"
        assert len(s) + len(p) == n_active, "partition does not cover E"


def _active(counts: np.ndarray):
    """Expert ids with >=1 token, sorted by token count descending.

    Ties broken by expert id for determinism (stable sort on -count).
    """
    counts = np.asarray(counts, dtype=np.int64)
    ids = np.nonzero(counts > 0)[0]
    order = np.argsort(-counts[ids], kind="stable")
    return ids[order], counts


def _prefix_times(counts, cost_model, cost_table):
    """Shared prefix-family evaluation for the sorted-prefix policies.

    One cumulative-sum pass: ``t_all[g] = max(t_comm, t_gpu(prefix g),
    t_pim(suffix g))`` for every split of the active experts sorted by
    count descending.  ``sieve_schedule`` selects over the full range;
    the dual-path rules clamp it to their feasibility window — keeping
    the evaluation here means the two families cannot drift apart.
    """
    ids, counts = _active(counts)
    t_comm = cost_model.t_comm(int(counts.sum()))
    sorted_counts = counts[ids]
    t_gpu_all = cost_model.t_gpu_prefix(sorted_counts)
    t_pim_all = cost_model.t_pim_suffix(sorted_counts, cost_table)
    t_all = np.maximum(np.maximum(t_gpu_all, t_pim_all), t_comm)
    return ids, sorted_counts, t_comm, t_gpu_all, t_pim_all, t_all


# ---------------------------------------------------------------------------
# Sieve (paper §5.2)
# ---------------------------------------------------------------------------


def sieve_schedule(
    counts: Sequence[int],
    cost_model: CostModel,
    cost_table: Optional[CostTable] = None,
    *,
    mode: str = "greedy",
) -> Partition:
    """Paper §5.2 greedy (``mode='greedy'``) or prefix-argmin refinement.

    ``counts`` is the global token count per expert hosted on this device
    (after the routing-map AllGather, §6.1 ③).

    Vectorized: the greedy only ever moves the current most-popular expert,
    so its reachable states are exactly the prefixes of the sorted order.
    T_total for every prefix split comes from two cumulative-sum scans
    (O(E) after the sort); the greedy is the first non-improvement in that
    array and the argmin is its global minimum.  Bit-identical to
    :func:`sieve_schedule_reference`.
    """
    if mode not in ("greedy", "argmin"):
        raise ValueError(f"unknown mode {mode!r}")
    ids, sorted_counts, t_comm, t_gpu_all, t_pim_all, t_all = _prefix_times(
        counts, cost_model, cost_table
    )
    n = len(ids)

    if mode == "greedy":
        # First split whose successor does not strictly improve: the scalar
        # greedy advances while t[g+1] < t[g] and stops at the first
        # non-improvement, having evaluated splits 0..g+1.
        nonimp = np.nonzero(t_all[1:] >= t_all[:-1])[0]
        g = int(nonimp[0]) if nonimp.size else n
        iters = g + 2 if g < n else n + 1
    else:
        g = int(np.argmin(t_all))  # first occurrence, like the scalar scan
        iters = n + 1

    part = Partition(
        gpu_experts=ids[:g].copy(),
        pim_experts=ids[g:].copy(),
        t_comm=t_comm,
        t_gpu=float(t_gpu_all[g]),
        t_pim=float(t_pim_all[g]),
        iterations=iters,
        policy="sieve" if mode == "greedy" else "sieve_argmin",
        meta={"split": g, "n_active": n},
    )
    # no validate() here: a prefix split of distinct active ids satisfies
    # the partition invariants by construction, and the O(E) set walk is
    # measurable on the hot path (the scalar reference still validates).
    return part


def sieve_schedule_reference(
    counts: Sequence[int],
    cost_model: CostModel,
    cost_table: Optional[CostTable] = None,
    *,
    mode: str = "greedy",
) -> Partition:
    """Scalar oracle for :func:`sieve_schedule` (O(E^2) cost-model calls).

    Retained for the equivalence suite; do not use on the hot path.  The
    per-split PIM sum runs least-popular-first (the reversed suffix) so its
    float association order matches the vectorized suffix scan exactly.
    """
    if mode not in ("greedy", "argmin"):
        raise ValueError(f"unknown mode {mode!r}")
    ids, counts = _active(counts)
    total_routed = int(counts.sum())
    t_comm = cost_model.t_comm(total_routed)

    sorted_counts = counts[ids]  # descending
    n = len(ids)

    # Evaluate T_total for prefix split g = number of experts moved to GPU
    # (the greedy only ever moves the current most-popular expert, so its
    # reachable states are exactly the prefixes of the sorted order).
    def eval_split(g: int):
        gpu_c = sorted_counts[:g]
        pim_c = sorted_counts[g:][::-1]  # least-popular-first summation
        t_gpu = cost_model.t_gpu(gpu_c)
        t_pim = cost_model.t_pim(pim_c, cost_table)
        return t_gpu, t_pim, max(t_comm, t_gpu, t_pim)

    if mode == "greedy":
        g = 0
        t_gpu, t_pim, best = eval_split(0)
        iters = 1
        while g < n:
            t_gpu2, t_pim2, t2 = eval_split(g + 1)
            iters += 1
            if t2 < best:
                g, best, t_gpu, t_pim = g + 1, t2, t_gpu2, t_pim2
            else:
                break  # first non-improvement stops the scan (paper §5.2)
    else:
        best, g, t_gpu, t_pim = np.inf, 0, 0.0, 0.0
        iters = n + 1
        for k in range(n + 1):
            t_gpu2, t_pim2, t2 = eval_split(k)
            if t2 < best:
                best, g, t_gpu, t_pim = t2, k, t_gpu2, t_pim2

    part = Partition(
        gpu_experts=ids[:g].copy(),
        pim_experts=ids[g:].copy(),
        t_comm=t_comm,
        t_gpu=t_gpu,
        t_pim=t_pim,
        iterations=iters,
        policy="sieve" if mode == "greedy" else "sieve_argmin",
        meta={"split": g, "n_active": n},
    )
    part.validate(n)
    return part


# ---------------------------------------------------------------------------
# Dual-path split rules (the model layer's head/tail partition, mirrored
# here so the simulator charges exactly the split the compiled step runs)
# ---------------------------------------------------------------------------


def _dual_feasible_window(sorted_counts, tail_tokens: int, max_head: int):
    """Feasible prefix-split range ``[lo, hi]`` of the dual-path executor.

    ``lo``: every expert with more than ``tail_tokens`` rows must be in the
    grouped-GEMM head (the tail slab executes at most ``tail_tokens`` rows
    per expert).  ``hi``: the head-compaction budget (``max_head <= 0``
    means no budget).  ``lo > hi`` happens only when the budget squeezes a
    popular expert off the grouped path — the budget wins and the overflow
    rows surface as drops in the model layer.
    """
    n = len(sorted_counts)
    lo = int(np.sum(sorted_counts > tail_tokens))
    hi = n if max_head <= 0 else min(n, int(max_head))
    return lo, hi


def dual_threshold_schedule(
    counts: Sequence[int],
    cost_model: CostModel,
    cost_table: Optional[CostTable] = None,
    *,
    tail_tokens: int = 1,
    max_head: int = 0,
) -> Partition:
    """The model layer's fixed-threshold rule (``expert_exec="dual_path"``).

    Head (GPU/grouped-GEMM side) = every expert with more than
    ``tail_tokens`` routed tokens, optionally capped at the ``max_head``
    most popular; tail (PIM/GEMV side) = the rest.  Cost-model-blind by
    construction — this is the baseline the cost-driven rule must beat.
    The reported times still come from the cost model so the simulator
    charges the threshold rule for its blind spots.
    """
    ids, counts = _active(counts)
    sorted_counts = counts[ids]
    lo, hi = _dual_feasible_window(sorted_counts, tail_tokens, max_head)
    g = min(lo, hi)  # threshold boundary, clamped by the head budget
    part = Partition(
        gpu_experts=ids[:g].copy(),
        pim_experts=ids[g:].copy(),
        t_comm=cost_model.t_comm(int(counts.sum())),
        t_gpu=cost_model.t_gpu(sorted_counts[:g]),
        t_pim=cost_model.t_pim(sorted_counts[g:][::-1], cost_table),
        policy="dual_threshold",
        meta={"split": g, "n_active": len(ids), "tail_tokens": tail_tokens},
    )
    # no validate(): a prefix split of distinct active ids satisfies the
    # partition invariants by construction (cf. sieve_schedule) and this
    # runs per layer-half on the simulator hot path
    return part


def dual_cost_schedule(
    counts: Sequence[int],
    cost_model: CostModel,
    cost_table: Optional[CostTable] = None,
    *,
    tail_tokens: int = 1,
    max_head: int = 0,
    mode: str = "argmin",
) -> Partition:
    """Cost-driven dual-path split (``expert_exec="dual_path_cost"``).

    Same prefix family and cumulative-sum evaluation as
    :func:`sieve_schedule`, with the evaluated range clamped to the
    dual-path executor's feasibility window (see
    :func:`_dual_feasible_window`) — the host NumPy twin of
    :func:`repro_torch.core.scheduler_torch.dual_path_split_cost`, so the
    host decision trail charges exactly the split the decode step runs.
    Bit-identical to :func:`dual_cost_schedule_reference`.
    """
    if mode not in ("greedy", "argmin"):
        raise ValueError(f"unknown mode {mode!r}")
    ids, sorted_counts, t_comm, t_gpu_all, t_pim_all, t_all = _prefix_times(
        counts, cost_model, cost_table
    )
    n = len(ids)
    lo, hi = _dual_feasible_window(sorted_counts, tail_tokens, max_head)

    if lo > hi:  # budget below the feasibility floor: the budget wins
        g = hi
    elif mode == "greedy":
        seg = t_all[lo : hi + 1]
        nonimp = np.nonzero(seg[1:] >= seg[:-1])[0]
        g = lo + (int(nonimp[0]) if nonimp.size else hi - lo)
    else:
        g = lo + int(np.argmin(t_all[lo : hi + 1]))  # first occurrence

    part = Partition(
        gpu_experts=ids[:g].copy(),
        pim_experts=ids[g:].copy(),
        t_comm=t_comm,
        t_gpu=float(t_gpu_all[g]),
        t_pim=float(t_pim_all[g]),
        policy="dual_cost",
        meta={
            "split": g,
            "n_active": n,
            "tail_tokens": tail_tokens,
            "window": (lo, hi),
        },
    )
    # prefix split of distinct active ids: partition invariants hold by
    # construction (cf. sieve_schedule)
    return part


def dual_cost_schedule_reference(
    counts: Sequence[int],
    cost_model: CostModel,
    cost_table: Optional[CostTable] = None,
    *,
    tail_tokens: int = 1,
    max_head: int = 0,
    mode: str = "argmin",
) -> Partition:
    """Scalar oracle for :func:`dual_cost_schedule` (O(E^2) eval calls)."""
    if mode not in ("greedy", "argmin"):
        raise ValueError(f"unknown mode {mode!r}")
    ids, counts = _active(counts)
    total_routed = int(counts.sum())
    t_comm = cost_model.t_comm(total_routed)
    sorted_counts = counts[ids]
    n = len(ids)
    lo, hi = _dual_feasible_window(sorted_counts, tail_tokens, max_head)

    def eval_split(g: int):
        gpu_c = sorted_counts[:g]
        pim_c = sorted_counts[g:][::-1]  # least-popular-first summation
        t_gpu = cost_model.t_gpu(gpu_c)
        t_pim = cost_model.t_pim(pim_c, cost_table)
        return t_gpu, t_pim, max(t_comm, t_gpu, t_pim)

    if lo > hi:
        g = hi
        t_gpu, t_pim, _ = eval_split(g)
    elif mode == "greedy":
        g = lo
        t_gpu, t_pim, best = eval_split(g)
        while g < hi:
            t_gpu2, t_pim2, t2 = eval_split(g + 1)
            if t2 < best:
                g, best, t_gpu, t_pim = g + 1, t2, t_gpu2, t_pim2
            else:
                break
    else:
        best, g, t_gpu, t_pim = np.inf, lo, 0.0, 0.0
        for k in range(lo, hi + 1):
            t_gpu2, t_pim2, t2 = eval_split(k)
            if t2 < best:
                best, g, t_gpu, t_pim = t2, k, t_gpu2, t_pim2

    part = Partition(
        gpu_experts=ids[:g].copy(),
        pim_experts=ids[g:].copy(),
        t_comm=t_comm,
        t_gpu=t_gpu,
        t_pim=t_pim,
        policy="dual_cost",
        meta={
            "split": g,
            "n_active": n,
            "tail_tokens": tail_tokens,
            "window": (lo, hi),
        },
    )
    part.validate(n)
    return part


# ---------------------------------------------------------------------------
# PIMoE baseline (paper §5.2 / §7.1)
# ---------------------------------------------------------------------------


def _pimoe_channel_assign(ids: np.ndarray, counts: np.ndarray, n_channels: int):
    """Greedy longest-processing-time assignment of experts to PIM channels
    (PIMoE uses channel-level expert parallelism, paper §6.2 / Fig 10)."""
    loads = np.zeros(n_channels)
    chan_of = {}
    for e in ids:  # ids already sorted by count desc
        c = int(np.argmin(loads))
        loads[c] += counts[e]
        chan_of[int(e)] = c
    return chan_of, loads


def pimoe_schedule(
    counts: Sequence[int],
    cost_model: CostModel,
    cost_table: Optional[CostTable] = None,
) -> Partition:
    """PIMoE: threshold-style offloading, blind to T_Comm and attention-on-PIM.

    Moves the most popular expert off the busiest channel while the PIM-side
    makespan (max channel load, *excluding* attention) exceeds the GPU time.

    Expert parallelism granularity: one expert per HBM-PIM *stack* (32
    pseudo-channels TP within the stack, EP across the 8 stacks).  Finer
    per-pseudo-channel EP would be uniformly dominated (256x slower weight
    streaming per expert); stack-level EP is the strongest reasonable
    reading of PIMoE's design and still exhibits the utilization imbalance
    of paper Fig 10.

    Vectorized: per-expert GEMV times are looked up in one batch and each
    iteration re-runs LPT + channel makespans as array ops; bit-identical
    to :func:`pimoe_schedule_reference`.
    """
    ids, counts = _active(counts)
    n = len(ids)
    pim = cost_model.system.pim
    n_channels = pim.stacks if pim is not None else 1

    sorted_counts = counts[ids]
    if cost_table is not None:
        gemv = cost_table.lookup_vec(sorted_counts) if n else np.zeros(0)
    else:
        gemv = (
            cost_model.t_pim_gemv_roofline_vec(sorted_counts)
            if n
            else np.zeros(0)
        )
    # stack-EP: an expert's GEMVs run on a single stack, which serves only
    # 1/n_stacks of the aggregate PIM bandwidth.
    gemv_ep = gemv * n_channels

    # Python-scalar loop state: the move loop is sequential by nature (each
    # LPT re-pack depends on the previous move), so the win comes from O(1)
    # incremental T_GPU (exact integer byte/FLOP accumulators mirroring
    # CostModel.t_gpu) and a single LPT pass per move that also records each
    # channel's first (most popular) expert.
    cnts = sorted_counts.tolist()
    times_ep = gemv_ep.tolist()
    tile = cost_model.system.xpu.tile_m
    m = cost_model.layer
    hbm_denom = cost_model.system.xpu.hbm_bw * cost_model.hbm_efficiency
    flop_denom = (
        cost_model.system.xpu.peak_flops * cost_model.grouped_gemm_efficiency
    )
    gpu_weight_bytes = 0  # n_live * expert_param_bytes
    gpu_tokens = 0
    gpu_padded = 0
    remaining = list(range(n))  # sorted-order indices still on PIM
    moved: List[int] = []  # sorted-order indices, in move order
    iters = 0
    while True:
        iters += 1
        # LPT over remaining token counts; track per-channel time load and
        # the first expert assigned to each channel (= its most popular).
        loads_cnt = [0.0] * n_channels
        loads_t = [0.0] * n_channels
        first_of = [-1] * n_channels
        for i in remaining:
            c = 0
            best = loads_cnt[0]
            for ch in range(1, n_channels):
                if loads_cnt[ch] < best:
                    best, c = loads_cnt[ch], ch
            loads_cnt[c] = best + cnts[i]
            loads_t[c] += times_ep[i]
            if first_of[c] < 0:
                first_of[c] = i
        t_pim = max(loads_t) if remaining else 0.0  # no attention term!
        # incremental T_GPU = max(offchip, comp), same arithmetic as
        # CostModel.t_gpu on the moved set (integer totals are exact)
        act_bytes = 2 * gpu_tokens * m.d_model * m.dtype_bytes
        t_offchip = (
            gpu_weight_bytes + act_bytes + cost_model.gpu_base_bytes
        ) / hbm_denom
        flops = 2.0 * gpu_padded * m.n_matrices * m.d_model * m.d_ff
        t_comp = (flops + cost_model.gpu_base_flops) / flop_denom
        t_gpu = t_offchip if t_offchip > t_comp else t_comp
        if t_pim <= t_gpu or not remaining:
            break
        # move the most popular expert from the busiest channel to the GPU
        busiest = loads_t.index(max(loads_t))
        mover = first_of[busiest]
        remaining.remove(mover)
        moved.append(mover)
        gpu_weight_bytes += m.expert_param_bytes
        gpu_tokens += cnts[mover]
        gpu_padded += -(-cnts[mover] // tile) * tile

    # Final ordering matches the scalar oracle: GPU experts stable-sorted by
    # count over their *move order* (count ties keep move order); PIM
    # experts keep the sorted order, which is already count-descending.
    moved_arr = np.asarray(moved, dtype=np.int64)
    gpu_order = moved_arr[np.argsort(-sorted_counts[moved_arr], kind="stable")]
    gpu_ids = ids[gpu_order]
    pim_ids = ids[np.asarray(remaining, dtype=np.int64)]
    total_routed = int(counts.sum())
    # Report the *actual* times (including the terms PIMoE ignored) so the
    # simulator charges PIMoE for its blind spots.
    t_pim_actual = cost_model.t_pim(counts[pim_ids], cost_table)
    part = Partition(
        gpu_experts=gpu_ids,
        pim_experts=pim_ids,
        t_comm=cost_model.t_comm(total_routed),
        t_gpu=cost_model.t_gpu(counts[gpu_ids]),
        t_pim=t_pim_actual,
        iterations=iters,
        policy="pimoe",
        meta={"n_active": n},
    )
    # validated by construction (disjoint move-set/remainder of active ids)
    return part


def pimoe_schedule_reference(
    counts: Sequence[int],
    cost_model: CostModel,
    cost_table: Optional[CostTable] = None,
) -> Partition:
    """Scalar oracle for :func:`pimoe_schedule` (per-expert dict walk)."""
    ids, counts = _active(counts)
    n = len(ids)
    pim = cost_model.system.pim
    n_channels = pim.stacks if pim is not None else 1

    def gemv_time(c):
        if cost_table is not None:
            return cost_table.lookup(int(c))
        return cost_model.t_pim_gemv_roofline(int(c))

    on_pim: List[int] = list(ids)
    on_gpu: List[int] = []
    iters = 0
    while True:
        iters += 1
        chan_of, _ = _pimoe_channel_assign(
            np.asarray(on_pim, dtype=np.int64), counts, n_channels
        )
        loads = np.zeros(n_channels)
        for e in on_pim:
            # stack-EP: an expert's GEMVs run on a single stack, which
            # serves only 1/n_stacks of the aggregate PIM bandwidth.
            loads[chan_of[int(e)]] += gemv_time(counts[e]) * n_channels
        t_pim = float(loads.max()) if on_pim else 0.0  # no attention term!
        t_gpu = cost_model.t_gpu(counts[np.asarray(on_gpu, dtype=np.int64)] if on_gpu else [])
        if t_pim <= t_gpu or not on_pim:
            break
        # move the most popular expert from the busiest channel to the GPU
        busiest = int(loads.argmax())
        cands = [e for e in on_pim if chan_of[int(e)] == busiest]
        mover = max(cands, key=lambda e: counts[e])
        on_pim.remove(mover)
        on_gpu.append(mover)

    gpu_ids = np.asarray(sorted(on_gpu, key=lambda e: -counts[e]), dtype=np.int64)
    pim_ids = np.asarray(sorted(on_pim, key=lambda e: -counts[e]), dtype=np.int64)
    total_routed = int(counts.sum())
    # Report the *actual* times (including the terms PIMoE ignored) so the
    # simulator charges PIMoE for its blind spots.
    t_pim_actual = cost_model.t_pim(counts[pim_ids], cost_table)
    part = Partition(
        gpu_experts=gpu_ids,
        pim_experts=pim_ids,
        t_comm=cost_model.t_comm(total_routed),
        t_gpu=cost_model.t_gpu(counts[gpu_ids]),
        t_pim=t_pim_actual,
        iterations=iters,
        policy="pimoe",
        meta={"n_active": n},
    )
    part.validate(n)
    return part


# ---------------------------------------------------------------------------
# Static baselines
# ---------------------------------------------------------------------------


def noexp_schedule(counts, cost_model, cost_table=None) -> Partition:
    """NoExp: attention on PIM, every expert on the GPU (NeuPIMs/PAISE)."""
    ids, counts = _active(counts)
    part = Partition(
        gpu_experts=ids.copy(),
        pim_experts=np.asarray([], dtype=np.int64),
        t_comm=cost_model.t_comm(int(counts.sum())),
        t_gpu=cost_model.t_gpu(counts[ids]),
        t_pim=cost_model.t_pim([], cost_table),  # attention only
        policy="noexp",
        meta={"n_active": len(ids)},
    )
    part.validate(len(ids))
    return part


def allexp_schedule(counts, cost_model, cost_table=None) -> Partition:
    """AllExp: every expert on PIM (PAPI / Stratum policy)."""
    ids, counts = _active(counts)
    part = Partition(
        gpu_experts=np.asarray([], dtype=np.int64),
        pim_experts=ids.copy(),
        t_comm=cost_model.t_comm(int(counts.sum())),
        t_gpu=cost_model.t_gpu([]),
        t_pim=cost_model.t_pim(counts[ids], cost_table),
        policy="allexp",
        meta={"n_active": len(ids)},
    )
    part.validate(len(ids))
    return part


def gpu_only_schedule(counts, cost_model, cost_table=None, attn_spec=None,
                      batch: int = 0, seq: int = 0) -> Partition:
    """GPU-Only: no PIM at all; attention also runs on the xPU."""
    ids, counts = _active(counts)
    t_attn_gpu = 0.0
    if attn_spec is not None and batch and seq:
        t_attn_gpu = attention_time_on_xpu(cost_model.system, attn_spec, batch, seq)
    t_gpu = max(
        cost_model.t_gpu_offchip(counts[ids]) + t_attn_gpu,
        cost_model.t_gpu_comp(counts[ids]) + t_attn_gpu,
    )
    part = Partition(
        gpu_experts=ids.copy(),
        pim_experts=np.asarray([], dtype=np.int64),
        t_comm=cost_model.t_comm(int(counts.sum())),
        t_gpu=t_gpu,
        t_pim=0.0,
        policy="gpu_only",
        meta={"n_active": len(ids)},
    )
    part.validate(len(ids))
    return part


def pimoe_static_partition(
    counts: Sequence[int],
    static_pim_ids,
    cost_model: CostModel,
    cost_table: Optional[CostTable] = None,
) -> Partition:
    """Apply PIMoE's *static* placement at runtime (paper §5.2: "PIMoE uses
    a static threshold ...", §7.3: degrades when the runtime distribution
    shifts).  ``static_pim_ids`` is the expert-id set assigned to PIM during
    calibration (see :func:`pimoe_schedule`); at runtime each activated
    expert executes wherever its id was pinned, regardless of its current
    token count.  ``static_pim_ids`` may also be a precomputed boolean mask
    over expert ids (the runtime's O(1) pinning lookup).
    """
    ids, counts = _active(counts)
    if isinstance(static_pim_ids, np.ndarray) and static_pim_ids.dtype == np.bool_:
        mask = static_pim_ids[ids]
    else:
        static_arr = np.fromiter(
            (int(e) for e in static_pim_ids), dtype=np.int64
        )
        mask = np.isin(ids, static_arr)
    pim_ids = ids[mask]
    gpu_ids = ids[~mask]
    part = Partition(
        gpu_experts=gpu_ids,
        pim_experts=pim_ids,
        t_comm=cost_model.t_comm(int(counts.sum())),
        t_gpu=cost_model.t_gpu(counts[gpu_ids]),
        t_pim=cost_model.t_pim(counts[pim_ids], cost_table),
        policy="pimoe",
        meta={"n_active": len(ids), "static": True},
    )
    part.validate(len(ids))
    return part


def schedule(policy: str, counts, cost_model, cost_table=None, **kw) -> Partition:
    """Dispatch by policy name (see :data:`POLICIES`)."""
    if policy == "sieve":
        return sieve_schedule(counts, cost_model, cost_table, mode="greedy")
    if policy == "sieve_argmin":
        return sieve_schedule(counts, cost_model, cost_table, mode="argmin")
    if policy in ("pimoe", "pimoe_dynamic"):
        return pimoe_schedule(counts, cost_model, cost_table)
    if policy == "noexp":
        return noexp_schedule(counts, cost_model, cost_table)
    if policy == "allexp":
        return allexp_schedule(counts, cost_model, cost_table)
    if policy == "gpu_only":
        return gpu_only_schedule(counts, cost_model, cost_table, **kw)
    if policy == "dual_threshold":
        return dual_threshold_schedule(counts, cost_model, cost_table, **kw)
    if policy == "dual_cost":
        return dual_cost_schedule(counts, cost_model, cost_table, **kw)
    raise ValueError(f"unknown policy {policy!r}; expected one of {POLICIES}")


def brute_force_schedule(
    counts: Sequence[int],
    cost_model: CostModel,
    cost_table: Optional[CostTable] = None,
) -> Partition:
    """Exhaustive 2^|E| search (tests only; paper §5.2 notes infeasibility)."""
    ids, counts = _active(counts)
    n = len(ids)
    if n > 16:
        raise ValueError("brute force is for tests with small |E| only")
    total_routed = int(counts.sum())
    t_comm = cost_model.t_comm(total_routed)
    best, best_mask = np.inf, 0
    for mask in range(1 << n):
        gpu_ids = ids[[i for i in range(n) if mask >> i & 1]]
        pim_ids = ids[[i for i in range(n) if not mask >> i & 1]]
        t = max(
            t_comm,
            cost_model.t_gpu(counts[gpu_ids]),
            cost_model.t_pim(counts[pim_ids], cost_table),
        )
        if t < best:
            best, best_mask = t, mask
    gpu_ids = ids[[i for i in range(n) if best_mask >> i & 1]]
    pim_ids = ids[[i for i in range(n) if not best_mask >> i & 1]]
    part = Partition(
        gpu_experts=gpu_ids,
        pim_experts=pim_ids,
        t_comm=t_comm,
        t_gpu=cost_model.t_gpu(counts[gpu_ids]),
        t_pim=cost_model.t_pim(counts[pim_ids], cost_table),
        policy="brute_force",
        meta={"n_active": n},
    )
    part.validate(n)
    return part
