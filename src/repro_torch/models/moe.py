"""Mixture-of-Experts layer on one device: router, capacity dispatch and
the Sieve dual-path executor (counterpart of ``repro.models.moe``, its
non-EP path).

* Router: float32 logits, top-k, renormalised weights, GShard aux loss.
* Dispatch: capacity scatter into an ``(E, C, d)`` buffer, sort-free
  (counting) below ``_COUNTING_DISPATCH_MAX_ELEMS`` and by stable sort
  above it; overflow is dropped and counted.
* Execution: ``expert_exec="dense"`` runs one einsum over the buffer (the
  oracle); the dual modes split experts into a head (grouped SwiGLU
  kernel over the capacity slab) and a tail (per-row SwiGLU GEMV kernel)
  with the split computed on the device
  (:mod:`repro_torch.core.scheduler_torch`).  ``REPRO_FUSED_SWIGLU=0``
  runs head and tail as three calls each (gate, up, down) of the grouped
  matmul and expert GEMV kernels instead of the fused SwiGLU kernels.

Every op is on fixed shapes and data-independent control flow, so a MoE
layer issues no host synchronisation.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.core.scheduler_torch import (
    SieveState,
    dual_path_split,
    dual_path_split_cost,
    make_sieve_state,
)
from repro_torch.kernels import ops
from .layers import he_init


def init_moe(gen, arch: ArchConfig, dtype, device) -> dict:
    cfg = arch.moe
    d, f, E = arch.d_model, cfg.d_expert, cfg.n_experts
    w_router = torch.randn((d, E), generator=gen, dtype=torch.float32, device=device)
    p = {
        "w_router": w_router.mul_(0.02),
        "w_gate": he_init(gen, (E, d, f), dtype, device),
        "w_up": he_init(gen, (E, d, f), dtype, device),
        "w_down": he_init(gen, (E, f, d), dtype, device),
    }
    if cfg.n_shared:
        p["shared"] = {
            "w_gate": he_init(gen, (d, cfg.n_shared * f), dtype, device),
            "w_up": he_init(gen, (d, cfg.n_shared * f), dtype, device),
            "w_down": he_init(gen, (cfg.n_shared * f, d), dtype, device),
        }
    return p


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


class RouterOut(NamedTuple):
    expert_idx: torch.Tensor  # (T, k) int32
    weights: torch.Tensor  # (T, k) activation dtype
    aux_loss: torch.Tensor  # scalar float32
    counts: torch.Tensor  # (E,) int32 tokens per expert


def route(x: torch.Tensor, w_router: torch.Tensor, cfg: MoEConfig) -> RouterOut:
    """Top-k routing with renormalised weights and the load-balance aux loss."""
    T = x.shape[0]
    E = w_router.shape[1]
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts the lower index first among equal
    # probabilities, as jax.lax.top_k does (torch.topk leaves ties unordered)
    srt_p, srt_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = srt_p[:, : cfg.top_k], srt_i[:, : cfg.top_k]
    weights = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat = top_i.reshape(-1)
    frac = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.float32)
    ) / (T * cfg.top_k)
    aux = E * torch.sum(probs.mean(0) * frac)
    counts = torch.zeros((E,), dtype=torch.int32, device=x.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32)
    )
    return RouterOut(top_i.to(torch.int32), weights.to(x.dtype), aux, counts)


# ---------------------------------------------------------------------------
# Capacity dispatch / combine
# ---------------------------------------------------------------------------


class Dispatched(NamedTuple):
    buf: torch.Tensor  # (E, C, d)
    slot_of: torch.Tensor  # (T, k) int32 slot in flat (E*C) space, -1 dropped
    n_dropped: torch.Tensor  # scalar int32


def capacity(T: int, cfg: MoEConfig, n_experts: int) -> int:
    c = int(-(-T * cfg.top_k * cfg.capacity_factor // n_experts))
    return max(c, min(T, cfg.min_capacity), 1)


# The counting dispatch does Theta(Tk * E) work for its running counters,
# the stable sort O(Tk log Tk); past this many counter elements the sort is
# used.  Both give identical slots (the same crossover as the reference).
_COUNTING_DISPATCH_MAX_ELEMS = 4_000_000


def dispatch(x: torch.Tensor, r: RouterOut, n_experts: int, cap: int) -> Dispatched:
    """Scatter tokens into an (E, cap, d) buffer.  An assignment's slot is
    its rank among same-expert assignments in token order."""
    T = x.shape[0]
    k = r.expert_idx.shape[1]
    if T * k * (n_experts + 1) > _COUNTING_DISPATCH_MAX_ELEMS:
        return dispatch_argsort(x, r, n_experts, cap)
    return dispatch_counting(x, r, n_experts, cap)


def _scatter(x, token_of, slot, keep, nE, cap) -> torch.Tensor:
    d = x.shape[1]
    vals = x[token_of] * keep[:, None].to(x.dtype)
    buf = torch.zeros((nE * cap + 1, d), dtype=x.dtype, device=x.device)
    # dropped assignments all land on the trash row nE * cap with zeros
    buf[slot.long()] = vals
    return buf[: nE * cap].reshape(nE, cap, d)


def dispatch_counting(x: torch.Tensor, r: RouterOut, n_experts: int, cap: int) -> Dispatched:
    """Counting-scatter dispatch: pos[i] = #{j < i : e[j] == e[i]}."""
    T = x.shape[0]
    k = r.expert_idx.shape[1]
    nE = n_experts
    e_key = r.expert_idx.reshape(-1).to(torch.int64)
    onehot = e_key[:, None] == torch.arange(nE + 1, device=x.device)[None, :]
    running = torch.cumsum(onehot.to(torch.int32), dim=0, dtype=torch.int32) - 1
    pos = torch.gather(running, 1, e_key[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, e_key.to(torch.int32) * cap + pos, nE * cap).to(torch.int32)
    token_of = torch.arange(T * k, device=x.device) // k
    buf = _scatter(x, token_of, slot, keep, nE, cap)
    slot_of = torch.where(keep, slot, -1).reshape(T, k)
    n_dropped = (~keep).sum(dtype=torch.int32)
    return Dispatched(buf, slot_of, n_dropped)


def dispatch_argsort(x: torch.Tensor, r: RouterOut, n_experts: int, cap: int) -> Dispatched:
    """Stable-sort dispatch (the original formulation, the oracle)."""
    T = x.shape[0]
    k = r.expert_idx.shape[1]
    Tk = T * k
    nE = n_experts
    e_key = r.expert_idx.reshape(-1).to(torch.int64)
    order = torch.sort(e_key, stable=True).indices
    e_sorted = e_key[order]
    counts = torch.zeros((nE + 1,), dtype=torch.int64, device=x.device).index_add_(
        0, e_key, torch.ones_like(e_key)
    )
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    pos_sorted = torch.arange(Tk, device=x.device) - starts[e_sorted]
    keep = pos_sorted < cap
    slot_sorted = torch.where(keep, e_sorted * cap + pos_sorted, nE * cap)
    slot_flat = torch.empty_like(slot_sorted)
    slot_flat[order] = slot_sorted
    buf = _scatter(x, order // k, slot_sorted.to(torch.int32), keep, nE, cap)
    slot_of = torch.where(slot_flat == nE * cap, -1, slot_flat).to(torch.int32).reshape(T, k)
    n_dropped = (~keep).sum(dtype=torch.int32)
    return Dispatched(buf, slot_of, n_dropped)


def combine(y_buf: torch.Tensor, slot_of: torch.Tensor, weights: torch.Tensor,
            T: int) -> torch.Tensor:
    E, C, d = y_buf.shape
    flat = y_buf.reshape(E * C, d)
    idx = torch.clamp(slot_of, min=0).long()
    gathered = flat[idx.reshape(-1)].reshape(T, -1, d)
    mask = (slot_of >= 0)[..., None].to(flat.dtype)
    w = weights[..., None].to(flat.dtype)
    return torch.sum(gathered * mask * w, dim=1)


# ---------------------------------------------------------------------------
# Expert FFN: dense oracle + sieve dual-path executor
# ---------------------------------------------------------------------------


def experts_ffn(params: dict, buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU over every capacity slot (the dense oracle)."""
    gate = torch.einsum("ecd,edf->ecf", buf, params["w_gate"])
    up = torch.einsum("ecd,edf->ecf", buf, params["w_up"])
    return torch.einsum("ecf,efd->ecd", F.silu(gate) * up, params["w_down"])


# Default table depth of the roofline state used when no engine-exported
# state is provided; counts beyond it clamp to the last entry.
_DEFAULT_SIEVE_MAX_COUNT = 2048


@functools.lru_cache(maxsize=16)
def _default_sieve_state(d_model, d_expert, n_experts, top_k, n_shared,
                         max_count, device) -> SieveState:
    from repro_torch.core.cost_model import CostModel, MoELayerSpec, b200_pim_system

    cm = CostModel(
        system=b200_pim_system(),
        layer=MoELayerSpec(
            d_model=d_model, d_ff=d_expert, n_experts=n_experts,
            top_k=top_k, n_shared=n_shared,
        ),
    )
    return make_sieve_state(None, cm, max_count, device=device)


def default_sieve_state(arch: ArchConfig, device,
                        max_count: int = _DEFAULT_SIEVE_MAX_COUNT) -> SieveState:
    """Roofline-only :class:`SieveState` for the arch's MoE layer dims (no
    measured observations) — used when no engine state is provided."""
    cfg = arch.moe
    return _default_sieve_state(
        arch.d_model, cfg.d_expert, cfg.n_experts, cfg.top_k, cfg.n_shared,
        max_count, torch.device(device),
    )


def resolve_sieve_state(cfg: MoEConfig, d_model: int, sieve: Optional[SieveState],
                        device) -> Optional[SieveState]:
    """The state the executor uses: the caller's under ``dual_path_cost``
    (defaulting to the roofline state), ``None`` for the other modes."""
    if cfg.expert_exec != "dual_path_cost":
        return None
    if sieve is not None:
        return sieve
    return _default_sieve_state(
        d_model, cfg.d_expert, cfg.n_experts, cfg.top_k, cfg.n_shared,
        _DEFAULT_SIEVE_MAX_COUNT, torch.device(device),
    )


def _fused_swiglu_default() -> bool:
    """Head and tail run the single-pass fused SwiGLU kernels by default;
    ``REPRO_FUSED_SWIGLU=0`` selects the three-call formulation (gate, up
    and down as separate kernel calls), read as the JAX package reads it
    (``repro/models/moe.py:390``)."""
    env = os.environ.get("REPRO_FUSED_SWIGLU")
    if env is not None:
        return env not in ("0", "false", "False")
    return True


def tail_stage(toks, wg, wu, wd, eids, valid):
    """Tail stage: per-row streaming expert SwiGLU (the PIM-GEMV proxy).
    Three-call form: ``silu(gate) * up`` is rounded to the working dtype
    between the calls, as in the JAX package."""
    if _fused_swiglu_default():
        return ops.swiglu_gemv(toks, wg, wu, wd, eids, valid)
    gate = ops.expert_gemv(toks, wg, eids, valid)
    up = ops.expert_gemv(toks, wu, eids, valid)
    return ops.expert_gemv(F.silu(gate) * up, wd, eids, valid)


def head_stage(slab, wg, wu, wd, sizes):
    """Head stage: grouped SwiGLU over the capacity slab (three grouped
    matmuls in the three-call form)."""
    if _fused_swiglu_default():
        return ops.swiglu_gmm_capacity(slab, wg, wu, wd, sizes)
    gate = ops.gmm_capacity(slab, wg, sizes)
    up = ops.gmm_capacity(slab, wu, sizes)
    return ops.gmm_capacity(F.silu(gate) * up, wd, sizes)


def _dual_split(rows, cfg: MoEConfig, tau: int, max_head: Optional[int],
                sieve: Optional[SieveState]) -> dict:
    if cfg.expert_exec == "dual_path_cost":
        if sieve is None:
            raise ValueError(
                "expert_exec='dual_path_cost' needs a SieveState; resolve one "
                "via resolve_sieve_state()/default_sieve_state()"
            )
        return dual_path_split_cost(
            rows, sieve.pim_time_by_count, sieve.params,
            tail_tokens=tau, max_head=max_head,
        )
    return dual_path_split(rows, tail_tokens=tau, max_head=max_head)


def experts_ffn_dual(
    params: dict,
    buf: torch.Tensor,  # (E, C, d) capacity dispatch buffer
    rows: torch.Tensor,  # (E,) live rows per expert
    cfg: MoEConfig,
    sieve: Optional[SieveState] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sieve dual-path execution: head experts run the grouped SwiGLU
    kernel over their capacity slabs, tail experts stream their first
    ``dual_tail_tokens`` rows through the SwiGLU GEMV kernel.  Head and
    tail cover disjoint rows, so the merge is one add.  Returns
    ``(y_buf, n_exec_dropped)``."""
    E, C, d = buf.shape
    tau = int(min(max(cfg.dual_tail_tokens, 0), C))
    H = cfg.dual_max_head if 0 < cfg.dual_max_head < E else E
    split = _dual_split(rows, cfg, tau, (H if H < E else None), sieve)
    head_sizes_full = torch.where(split["head_mask"], rows, 0).to(torch.int32)

    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if H < E:
        # compact: the H most popular experts' slabs and weights
        hid = split["order"][:H]
        y_head = head_stage(buf[hid], wg[hid], wu[hid], wd[hid], head_sizes_full[hid])
        y = torch.zeros((E, C, d), dtype=y_head.dtype, device=buf.device)
        y[hid] = y_head
    else:
        y = head_stage(buf, wg, wu, wd, head_sizes_full)

    if tau > 0:
        # tail slab: every expert's first tau rows; rows of head experts
        # and rows past the live count are invalid
        live = torch.arange(tau, device=buf.device)[None, :] < torch.clamp(rows, max=tau)[:, None]
        valid = (split["tail_mask"][:, None] & live).reshape(E * tau).to(torch.int32)
        eids = torch.arange(E, dtype=torch.int32, device=buf.device).repeat_interleave(tau)
        ty = tail_stage(buf[:, :tau].reshape(E * tau, d), wg, wu, wd, eids, valid)
        y[:, :tau] += ty.reshape(E, tau, d).to(y.dtype)
    return y.to(buf.dtype), split["n_dropped"]


_EXEC_MODES = ("dense", "dual_path", "dual_path_cost")


def experts_ffn_exec(params: dict, buf: torch.Tensor, rows: torch.Tensor,
                     cfg: MoEConfig, sieve: Optional[SieveState] = None):
    """Dispatch on ``cfg.expert_exec``; returns (y_buf, n_exec_dropped)."""
    if cfg.expert_exec not in _EXEC_MODES:
        raise ValueError(
            f"unknown MoEConfig.expert_exec {cfg.expert_exec!r}; expected one of {_EXEC_MODES}"
        )
    if cfg.expert_exec == "dense":
        return experts_ffn(params, buf), torch.zeros((), dtype=torch.int32, device=buf.device)
    sieve = resolve_sieve_state(cfg, buf.shape[-1], sieve, buf.device)
    return experts_ffn_dual(params, buf, rows, cfg, sieve=sieve)


class MoEOut(NamedTuple):
    y: torch.Tensor  # (T, d)
    aux_loss: torch.Tensor
    counts: torch.Tensor  # (E,) token counts (the Sieve scheduler's input)
    n_dropped: torch.Tensor


def moe_local(params: dict, x: torch.Tensor, arch: ArchConfig,
              sieve: Optional[SieveState] = None) -> MoEOut:
    """Single-device routed-experts path."""
    cfg = arch.moe
    T = x.shape[0]
    r = route(x, params["w_router"], cfg)
    cap = capacity(T, cfg, cfg.n_experts)
    disp = dispatch(x, r, cfg.n_experts, cap)
    rows = torch.clamp(r.counts, max=cap)
    y_buf, exec_dropped = experts_ffn_exec(params, disp.buf, rows, cfg, sieve)
    y = combine(y_buf, disp.slot_of, r.weights, T)
    return MoEOut(y, r.aux_loss, r.counts, disp.n_dropped + exec_dropped)


def moe_block(params: dict, x: torch.Tensor, arch: ArchConfig,
              sieve: Optional[SieveState] = None) -> MoEOut:
    """Routed experts plus shared experts (every token visits those)."""
    cfg = arch.moe
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    sieve = resolve_sieve_state(cfg, d, sieve, x.device)
    routed = moe_local(params, xt, arch, sieve=sieve)
    y = routed.y
    if cfg.n_shared:
        sp = params["shared"]
        y = y + (F.silu(xt @ sp["w_gate"]) * (xt @ sp["w_up"])) @ sp["w_down"]
    return MoEOut(y.reshape(B, S, d), routed.aux_loss, routed.counts, routed.n_dropped)
