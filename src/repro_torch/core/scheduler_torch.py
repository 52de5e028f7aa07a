"""On-device Sieve split (counterpart of ``repro.core.scheduler_jax``).

The paper's greedy only ever moves the most popular expert from PIM to
the GPU, so every reachable partition is a *prefix* of the experts sorted
by token count.  The whole search is cumulative sums plus one argmin over
float32 tensors on the model's device: the split runs inside the serving
step with no host round trip.

The PIM cost table enters as a dense ``pim_time_by_count`` tensor (seconds
per token count, clamped at the last entry) held in a :class:`SieveState`
that the serving engine refreshes in place (``copy_``) on its EMA cadence.

Entry points: :func:`sieve_partition_torch` (cost scalars fixed per
:class:`SieveParams`) and :func:`sieve_partition_dynamic` (the scalars a
tensor, as the serving engine holds them) pick the paper's greedy split or
the prefix argmin; :func:`dual_path_split` and
:func:`dual_path_split_cost` are the MoE executor's head/tail partitions.
None reads a value back to the host, so each can be captured in a CUDA
graph and replayed with new counts written into the same tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import functools

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class SieveParams:
    """Static scalars of the cost model, precomputed on the host."""

    flops_per_row: float
    expert_param_bytes: float
    act_bytes_per_token: float
    hbm_bw: float
    peak_flops_eff: float
    tile_m: int
    gpu_base_flops: float = 0.0
    gpu_base_bytes: float = 0.0
    pim_attn_time: float = 0.0
    t_comm: float = 0.0

    # field order of the packed float32 vector (SieveState.params)
    FIELDS = (
        "flops_per_row",
        "expert_param_bytes",
        "act_bytes_per_token",
        "hbm_bw",
        "peak_flops_eff",
        "tile_m",
        "gpu_base_flops",
        "gpu_base_bytes",
        "pim_attn_time",
        "t_comm",
    )

    @staticmethod
    def from_cost_model(cm, total_routed_tokens: int) -> "SieveParams":
        return SieveParams(
            flops_per_row=2.0 * cm.layer.n_matrices * cm.layer.d_model * cm.layer.d_ff,
            expert_param_bytes=float(cm.layer.expert_param_bytes),
            act_bytes_per_token=2.0 * cm.layer.d_model * cm.layer.dtype_bytes,
            hbm_bw=cm.system.xpu.hbm_bw * cm.hbm_efficiency,
            peak_flops_eff=cm.system.xpu.peak_flops * cm.grouped_gemm_efficiency,
            tile_m=cm.system.xpu.tile_m,
            gpu_base_flops=cm.gpu_base_flops,
            gpu_base_bytes=cm.gpu_base_bytes,
            pim_attn_time=cm.pim_attn_time,
            t_comm=cm.t_comm(total_routed_tokens),
        )

    def to_array(self) -> np.ndarray:
        return np.asarray(
            [float(getattr(self, f)) for f in self.FIELDS], dtype=np.float32
        )

    @staticmethod
    def from_array(arr) -> "SieveParams":
        vals = np.asarray(arr, dtype=np.float32)
        kw = {f: float(vals[i]) for i, f in enumerate(SieveParams.FIELDS)}
        kw["tile_m"] = int(kw["tile_m"])
        return SieveParams(**kw)


class SieveState(NamedTuple):
    """Cost-model state for the on-device cost-driven split: two float32
    tensors on the model's device."""

    pim_time_by_count: torch.Tensor  # (maxc+1,) seconds per token count
    params: torch.Tensor  # (len(SieveParams.FIELDS),) packed scalars


def export_cost_table(cost_table, cost_model, max_count: int) -> np.ndarray:
    """Dense per-token-count PIM time array (float32): the table's export,
    or the pure roofline when there is no table."""
    if cost_table is not None:
        return cost_table.export(max_count)
    out = np.empty(max_count + 1, dtype=np.float32)
    out[0] = 0.0
    counts = np.arange(1, max_count + 1, dtype=np.int64)
    out[1:] = cost_model.t_pim_gemv_roofline_vec(counts)
    return out


def make_sieve_state(cost_table, cost_model, max_count: int,
                     total_routed_tokens: int = 0,
                     device="cuda") -> SieveState:
    """Host-side export: (CostTable, CostModel) -> a :class:`SieveState`
    on ``device`` (``"cuda"`` unless the caller names the CPU)."""
    device = resolve_device(device)
    return SieveState(
        pim_time_by_count=torch.from_numpy(
            export_cost_table(cost_table, cost_model, max_count)
        ).to(device),
        params=torch.from_numpy(
            SieveParams.from_cost_model(cost_model, total_routed_tokens).to_array()
        ).to(device),
    )


def _argsort_stable(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices


def _prefix_partition(
    counts: torch.Tensor,  # (E,) token count per local expert
    pim_time_by_count: torch.Tensor,  # (maxc+1,) float32 seconds
    params: torch.Tensor,  # packed SieveParams, float32
    min_split: Optional[torch.Tensor] = None,
    max_split: Optional[int] = None,
    mode: str = "argmin",
    weight_of_group: Optional[torch.Tensor] = None,  # (E,) 0/1: charges weight bytes?
) -> dict:
    """Prefix-family split of T_total = max(T_GPU, T_PIM, T_Comm), clamped
    to ``[min_split, max_split]``; float32 throughout, as in JAX.
    ``mode="argmin"`` takes the window's first minimum, ``"greedy"`` the
    paper's first split whose successor does not strictly improve.

    ``weight_of_group`` marks the entries that charge their expert's
    ``expert_param_bytes`` in T_GPU's memory term.  ``None`` charges every
    active entry (entries are whole experts); the all-to-all layout's
    segments pass the first segment of each expert, so an expert whose
    segments all enter the head is charged its shared weights once."""
    if mode not in ("greedy", "argmin"):
        raise ValueError(f"unknown mode {mode!r}")
    p = {f: params[i] for i, f in enumerate(SieveParams.FIELDS)}
    E = counts.shape[0]
    dev = counts.device
    counts = counts.to(torch.int32)
    order = _argsort_stable(-counts)  # popular first
    sc = counts[order]
    active = sc > 0
    n_active = active.sum(dtype=torch.int32)

    tile = p["tile_m"].to(torch.int32)
    padded = torch.where(active, ((sc + tile - 1) // tile) * tile, 0)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    cum_tokens = torch.cat([zero, torch.cumsum(sc, 0, dtype=torch.int32)])
    cum_padded = torch.cat([zero, torch.cumsum(padded, 0, dtype=torch.int32)])
    if weight_of_group is None:
        live = active.to(torch.int32)
    else:
        live = torch.where(active, weight_of_group[order].to(torch.int32), 0)
    cum_live = torch.cat([zero, torch.cumsum(live, 0, dtype=torch.int32)])

    t_gpu_comp = (
        p["flops_per_row"] * cum_padded.float() + p["gpu_base_flops"]
    ) / p["peak_flops_eff"]
    t_gpu_mem = (
        p["expert_param_bytes"] * cum_live.float()
        + p["act_bytes_per_token"] * cum_tokens.float()
        + p["gpu_base_bytes"]
    ) / p["hbm_bw"]
    t_gpu = torch.maximum(t_gpu_comp, t_gpu_mem)

    maxc = pim_time_by_count.shape[0] - 1
    per_expert_pim = pim_time_by_count[sc.clamp(0, maxc).long()]
    per_expert_pim = torch.where(active, per_expert_pim, 0.0)
    cum_pim = torch.cat([
        torch.zeros(1, dtype=torch.float32, device=dev),
        torch.cumsum(per_expert_pim, 0),
    ])
    t_pim = p["pim_attn_time"] + (cum_pim[-1] - cum_pim)

    t_total = torch.maximum(torch.maximum(t_gpu, t_pim), p["t_comm"])
    g_range = torch.arange(E + 1, dtype=torch.int32, device=dev)
    lo = zero[0] if min_split is None else min_split
    hi = n_active if max_split is None else torch.clamp(n_active, max=max_split)
    valid = (g_range <= n_active) & (g_range >= lo) & (g_range <= hi)
    t_masked = torch.where(valid, t_total, float("inf"))
    if mode == "greedy":
        # first split whose successor does not strictly improve (paper
        # §5.2), scanning only inside the feasible window
        nonimp = (t_masked[1:] >= t_masked[:-1]) & valid[1:]
        first = torch.argmax(nonimp.to(torch.int32)).to(torch.int32)  # first True
        g_star = torch.where(nonimp.any(), first, hi)
    else:
        g_star = torch.argmin(t_masked).to(torch.int32)  # first occurrence
    # empty window (budget below the feasibility floor): the budget wins
    g_star = torch.where(valid.any(), g_star, hi).to(torch.int32)

    rank = _argsort_stable(order)  # expert id -> popularity rank
    gpu_mask = (rank < g_star) & (counts > 0)
    # index_select, not t[g_star]: indexing by a 0-d tensor reads it back
    # to the host, a device sync per MoE layer
    at = g_star.long().reshape(1)
    return {
        "gpu_mask": gpu_mask,
        "order": order,
        "rank": rank,
        "split": g_star,
        "t_total": t_total.index_select(0, at)[0],
        "t_gpu": t_gpu.index_select(0, at)[0],
        "t_pim": t_pim.index_select(0, at)[0],
        "t_comm": p["t_comm"],
        "n_active": n_active,
    }


@functools.lru_cache(maxsize=64)
def _params_tensor(params: SieveParams, device: torch.device) -> torch.Tensor:
    """The packed float32 scalars of ``params`` on ``device``, made once per
    (params, device) (JAX's static-argument jit key): a capture that reads
    them copies nothing from the host."""
    return torch.from_numpy(params.to_array()).to(device)


def sieve_partition_torch(
    counts: torch.Tensor,  # (E,) token count per local expert
    pim_time_by_count: torch.Tensor,  # (maxc+1,) float32 seconds
    params: SieveParams,
    mode: str = "argmin",
) -> dict:
    """``gpu_mask`` (E,) bool plus the evaluated split's diagnostics, with
    the cost scalars fixed by ``params`` (``repro.core.scheduler_jax.
    sieve_partition_jax``).

    ``mode="argmin"`` is the global argmin over the prefix family
    (``scheduler.sieve_schedule(..., mode="argmin")``), ``"greedy"`` the
    paper's first non-improvement on the same prefix arrays.  The scalars
    are rounded to float32 as the dynamic form stores them, so both forms
    pick the same split.  The first call for a ``params`` on a device
    uploads them: make it outside a graph capture."""
    return _prefix_partition(
        counts, pim_time_by_count, _params_tensor(params, counts.device), mode=mode
    )


def sieve_partition_dynamic(
    counts: torch.Tensor,  # (E,) token count per local expert
    pim_time_by_count: torch.Tensor,  # (maxc+1,) float32 seconds
    params_arr: torch.Tensor,  # (len(SieveParams.FIELDS),) packed float32
    mode: str = "argmin",
) -> dict:
    """:func:`sieve_partition_torch` with the cost scalars as a tensor
    (``SieveState.params``): a refresh that ``copy_``-s new scalars into
    it changes the split of a captured graph without a new capture."""
    return _prefix_partition(counts, pim_time_by_count, params_arr.float(), mode=mode)


def dual_path_split(
    rows: torch.Tensor,  # (E,) buffered rows per local expert
    tail_tokens: int = 1,
    max_head: Optional[int] = None,
) -> dict:
    """Fixed-threshold head/tail partition (``expert_exec="dual_path"``):
    head = experts with more than ``tail_tokens`` rows, optionally capped
    at the ``max_head`` most popular; squeezed rows count as drops."""
    E = rows.shape[0]
    rows = rows.to(torch.int32)
    order = _argsort_stable(-rows)
    rank = _argsort_stable(order)
    head = rows > tail_tokens
    if max_head is not None and max_head < E:
        head = head & (rank < max_head)
    tail = (rows > 0) & ~head
    overflow = torch.where((rows > tail_tokens) & ~head, rows - tail_tokens, 0)
    return {
        "head_mask": head,
        "tail_mask": tail,
        "order": order,
        "rank": rank,
        "n_head": head.sum(dtype=torch.int32),
        "n_tail": tail.sum(dtype=torch.int32),
        "n_dropped": overflow.sum(dtype=torch.int32),
    }


def dual_path_split_cost(
    rows: torch.Tensor,  # (E,) buffered rows per local expert
    pim_time_by_count: torch.Tensor,
    params_arr: torch.Tensor,  # packed SieveParams (SieveState.params)
    tail_tokens: int = 1,
    max_head: Optional[int] = None,
    weight_of_group: Optional[torch.Tensor] = None,  # (E,) 0/1 weight-byte mask
) -> dict:
    """Cost-driven head/tail partition (``expert_exec="dual_path_cost"``).

    Same contract as :func:`dual_path_split`; the prefix boundary is the
    cost-model argmin, clamped below by the experts that must be in the
    head (more than ``tail_tokens`` rows) and above by ``max_head``
    (``None`` = no budget, ``0`` = empty head, as in JAX).
    ``weight_of_group``: see :func:`_prefix_partition`."""
    E = rows.shape[0]
    rows = rows.to(torch.int32)
    n_over = (rows > tail_tokens).sum(dtype=torch.int32)
    cap = None if (max_head is None or max_head >= E) else int(max_head)
    part = _prefix_partition(
        rows, pim_time_by_count, params_arr.float(),
        min_split=n_over, max_split=cap, weight_of_group=weight_of_group,
    )
    head = part["gpu_mask"]
    tail = (rows > 0) & ~head
    overflow = torch.where((rows > tail_tokens) & tail, rows - tail_tokens, 0)
    return {
        "head_mask": head,
        "tail_mask": tail,
        "order": part["order"],
        "rank": part["rank"],
        "split": part["split"],
        "t_total": part["t_total"],
        "t_gpu": part["t_gpu"],
        "t_pim": part["t_pim"],
        "n_head": head.sum(dtype=torch.int32),
        "n_tail": tail.sum(dtype=torch.int32),
        "n_dropped": overflow.sum(dtype=torch.int32),
    }
