"""Mixture-of-Experts layer: router, capacity dispatch, the Sieve dual-path
executor and expert parallelism (counterpart of ``repro.models.moe``).

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

* Expert parallelism: on a mesh of ``torch.distributed`` ranks
  (:class:`MeshInfo`, built by :mod:`repro_torch.launch.mesh`) each rank
  holds ``E / ep`` experts.  The replicated-dispatch body routes on every
  model rank, dispatches into its local experts and sums the partial
  outputs over the model group; the all-to-all body
  (``REPRO_EP_MODE=a2a``) shards the tokens, exchanges capacity buffers
  with the expert owners and runs every (local expert, source rank)
  segment as a group of its own (:func:`experts_ffn_dual_segmented`).
  Under autograd (training on a mesh) the bodies' collectives carry the
  gradient (:mod:`.collectives`): the tokens and routing weights enter a
  rank's experts through ``collectives.enter``, and each data rank
  differentiates its own rows' aux loss, as the reference's ``pmean`` of
  the aux loss over the data axes differentiates (:func:`_aux_on_mesh`).

Every op is on fixed shapes and data-independent control flow, so a MoE
layer on one device issues no host synchronisation (the collectives of
the mesh bodies do).
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
from . import collectives as coll
from .layers import apply_mlp, he_init
from .sharding import tp_group


class MeshInfo(NamedTuple):
    """Where this rank sits on the mesh (``repro.models.moe.MeshInfo``):
    the process groups of its mesh axes and its index on each.  The default
    is one process (``LOCAL_MESH``).

    ``model_group`` holds the ranks of this rank's data row (the expert and
    sequence parallel axis), ``data_group`` the ranks that share its model
    index over the data axes that shard the batch (none when the batch is
    replicated), ``token_group`` both together (the all-to-all body's
    reductions)."""

    model_group: Optional[object] = None
    data_group: Optional[object] = None
    token_group: Optional[object] = None
    model_index: int = 0
    data_index: int = 0
    ep_size: int = 1
    dp_size: int = 1
    backend: Optional[str] = None
    device: Optional[torch.device] = None


LOCAL_MESH = MeshInfo()


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


def dispatch(x: torch.Tensor, r: RouterOut, n_experts: int, cap: int,
             expert_offset: int = 0, n_local: Optional[int] = None) -> Dispatched:
    """Scatter tokens into an (n_local, cap, d) buffer.  An assignment's slot
    is its rank among same-expert assignments in token order.

    With ``expert_offset``/``n_local`` set, only assignments to the local
    experts [offset, offset + n_local) are dispatched (the expert-parallel
    case); the others get ``slot_of = -1`` and are not counted as drops (a
    remote rank handles them)."""
    T = x.shape[0]
    k = r.expert_idx.shape[1]
    nE = n_experts if n_local is None else n_local
    if T * k * (nE + 1) > _COUNTING_DISPATCH_MAX_ELEMS:
        return dispatch_argsort(x, r, n_experts, cap, expert_offset, n_local)
    return dispatch_counting(x, r, n_experts, cap, expert_offset, n_local)


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a 2-D table.  The same rows as advanced indexing;
    under autograd its backward sums repeated indices by sorting, where
    the backward of advanced indexing walks each index's repeats one after
    another (a combine's dropped assignments all read row 0)."""
    return F.embedding(idx, table)


def _scatter(x, token_of, slot, keep, nE, cap) -> torch.Tensor:
    d = x.shape[1]
    vals = _gather_rows(x, token_of) * keep[:, None].to(x.dtype)
    buf = torch.zeros((nE * cap + 1, d), dtype=x.dtype, device=x.device)
    # dropped and remote assignments all land on the trash row nE * cap
    buf[slot.long()] = vals
    return buf[: nE * cap].reshape(nE, cap, d)


def _local_keys(r: RouterOut, n_experts: int, expert_offset: int, n_local: Optional[int]):
    """Each assignment's local expert (``nE`` for a remote one), whether it
    is local, and ``nE``."""
    nE = n_experts if n_local is None else n_local
    e_flat = r.expert_idx.reshape(-1).to(torch.int64) - expert_offset
    valid = (e_flat >= 0) & (e_flat < nE)
    return torch.where(valid, e_flat, nE), valid, nE


def dispatch_counting(x: torch.Tensor, r: RouterOut, n_experts: int, cap: int,
                      expert_offset: int = 0, n_local: Optional[int] = None) -> Dispatched:
    """Counting-scatter dispatch: pos[i] = #{j < i : e[j] == e[i]}."""
    T = x.shape[0]
    k = r.expert_idx.shape[1]
    e_key, valid, nE = _local_keys(r, n_experts, expert_offset, n_local)
    onehot = e_key[:, None] == torch.arange(nE + 1, device=x.device)[None, :]
    running = torch.cumsum(onehot.to(torch.int32), dim=0, dtype=torch.int32) - 1
    pos = torch.gather(running, 1, e_key[:, None])[:, 0]
    keep = (pos < cap) & valid
    slot = torch.where(keep, e_key.to(torch.int32) * cap + pos, nE * cap).to(torch.int32)
    token_of = torch.arange(T * k, device=x.device) // k
    buf = _scatter(x, token_of, slot, keep, nE, cap)
    slot_of = torch.where(keep, slot, -1).reshape(T, k)
    n_dropped = (~keep & valid).sum(dtype=torch.int32)  # overflow only, not remote
    return Dispatched(buf, slot_of, n_dropped)


def dispatch_argsort(x: torch.Tensor, r: RouterOut, n_experts: int, cap: int,
                     expert_offset: int = 0, n_local: Optional[int] = None) -> Dispatched:
    """Stable-sort dispatch (the original formulation, the oracle)."""
    T = x.shape[0]
    k = r.expert_idx.shape[1]
    Tk = T * k
    e_key, _, nE = _local_keys(r, n_experts, expert_offset, n_local)  # remote sort last
    order = torch.sort(e_key, stable=True).indices
    e_sorted = e_key[order]
    counts = torch.zeros((nE + 1,), dtype=torch.int64, device=x.device).index_add_(
        0, e_key, torch.ones_like(e_key)
    )
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    pos_sorted = torch.arange(Tk, device=x.device) - starts[e_sorted]
    local = e_sorted < nE
    keep = (pos_sorted < cap) & local
    slot_sorted = torch.where(keep, e_sorted * cap + pos_sorted, nE * cap)
    slot_flat = torch.empty_like(slot_sorted)
    slot_flat[order] = slot_sorted
    buf = _scatter(x, order // k, slot_sorted.to(torch.int32), keep, nE, cap)
    slot_of = torch.where(slot_flat == nE * cap, -1, slot_flat).to(torch.int32).reshape(T, k)
    n_dropped = (~keep & local).sum(dtype=torch.int32)  # overflow only, not remote
    return Dispatched(buf, slot_of, n_dropped)


def combine(y_buf: torch.Tensor, slot_of: torch.Tensor, weights: torch.Tensor,
            T: int, sum_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Each token's weighted sum of its experts' rows.  ``sum_dtype``
    (float32) returns the sum unrounded: the partial that the replicated
    dispatch body reduces over the model group before it rounds once, as
    one process rounds its whole sum once."""
    E, C, d = y_buf.shape
    flat = y_buf.reshape(E * C, d)
    idx = torch.clamp(slot_of, min=0).long()
    gathered = _gather_rows(flat, idx.reshape(-1)).reshape(T, -1, d)
    mask = (slot_of >= 0)[..., None].to(flat.dtype)
    w = weights[..., None].to(flat.dtype)
    return torch.sum(gathered * mask * w, dim=1, dtype=sum_dtype)


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


def head_stage(slab, wg, wu, wd, sizes, rhs_of_group=None):
    """Head stage: grouped SwiGLU over the capacity slab (three grouped
    matmuls in the three-call form).  ``rhs_of_group`` maps each group to
    its weight row (groups that share an expert's weights)."""
    if _fused_swiglu_default():
        return ops.swiglu_gmm_capacity(slab, wg, wu, wd, sizes, rhs_of_group)
    gate = ops.gmm_capacity(slab, wg, sizes, rhs_of_group)
    up = ops.gmm_capacity(slab, wu, sizes, rhs_of_group)
    return ops.gmm_capacity(F.silu(gate) * up, wd, sizes, rhs_of_group)


def _dual_split(rows, cfg: MoEConfig, tau: int, max_head: Optional[int],
                sieve: Optional[SieveState], weight_of_group=None) -> dict:
    if cfg.expert_exec == "dual_path_cost":
        if sieve is None:
            raise ValueError(
                "expert_exec='dual_path_cost' needs a SieveState; resolve one "
                "via resolve_sieve_state()/default_sieve_state()"
            )
        return dual_path_split_cost(
            rows, sieve.pim_time_by_count, sieve.params,
            tail_tokens=tau, max_head=max_head, weight_of_group=weight_of_group,
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


def experts_ffn_dual_segmented(
    params: dict,
    buf: torch.Tensor,  # (E, S, C, d): S capacity segments per local expert
    sizes: torch.Tensor,  # (E, S) live rows per (expert, segment)
    cfg: MoEConfig,
    sieve: Optional[SieveState] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dual-path execution over the all-to-all layout: after the exchange
    each local expert's rows arrive as one capacity segment per source
    rank, and every (expert, segment) pair is a group of its own (a hot
    expert's one-row segment from a quiet rank still takes the GEMV path).
    The groups share their expert's weights through the head kernel's
    ``rhs_of_group`` table, with no copy of the weights.

    ``cfg.dual_max_head`` counts experts, so the head budget is that many
    experts' segments; the split charges an expert's weight bytes once, at
    its most popular segment (``weight_of_group``).  The tail streams each
    segment's first ``dual_tail_tokens`` rows against the segment's
    expert.  Returns ``(y_buf, n_exec_dropped)``."""
    E, S, C, d = buf.shape
    G = E * S
    tau = int(min(max(cfg.dual_tail_tokens, 0), C))
    # head budget in segment units: H experts' worth of capacity slabs
    Hg = cfg.dual_max_head * S if 0 < cfg.dual_max_head * S < G else G
    dev = buf.device
    rows_g = sizes.reshape(G).to(torch.int32)
    e_of_g = torch.arange(E, dtype=torch.int32, device=dev).repeat_interleave(S)
    # an expert's first most popular segment charges its weight bytes
    first_seg = torch.zeros((E, S), dtype=torch.int32, device=dev).scatter_(
        1, torch.argmax(sizes, dim=1)[:, None], 1
    ).reshape(G)
    split = _dual_split(rows_g, cfg, tau, (Hg if Hg < G else None), sieve,
                        weight_of_group=first_seg)
    head_sizes_full = torch.where(split["head_mask"], rows_g, 0).to(torch.int32)

    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    slab_full = buf.reshape(G, C, d)
    if Hg < G:
        # compact: the Hg most popular segments' slabs; each keeps its
        # expert's weight row through the rhs_of_group table
        hid = split["order"][:Hg]
        y_head = head_stage(slab_full[hid], wg, wu, wd, head_sizes_full[hid], e_of_g[hid])
        y = torch.zeros((G, C, d), dtype=y_head.dtype, device=dev)
        y[hid] = y_head
    else:
        y = head_stage(slab_full, wg, wu, wd, head_sizes_full, e_of_g)

    if tau > 0:
        live = torch.arange(tau, device=dev)[None, :] < torch.clamp(rows_g, max=tau)[:, None]
        valid = (split["tail_mask"][:, None] & live).reshape(G * tau).to(torch.int32)
        ty = tail_stage(slab_full[:, :tau].reshape(G * tau, d), wg, wu, wd,
                        e_of_g.repeat_interleave(tau), valid)
        y[:, :tau] += ty.reshape(G, tau, d).to(y.dtype)
    return y.reshape(E, S, C, d).to(buf.dtype), split["n_dropped"]


_EXEC_MODES = ("dense", "dual_path", "dual_path_cost")
_DUAL_MODES = ("dual_path", "dual_path_cost")


def _check_expert_exec(cfg: MoEConfig) -> None:
    if cfg.expert_exec not in _EXEC_MODES:
        raise ValueError(
            f"unknown MoEConfig.expert_exec {cfg.expert_exec!r}; expected one of {_EXEC_MODES}"
        )


def experts_ffn_exec(params: dict, buf: torch.Tensor, rows: torch.Tensor,
                     cfg: MoEConfig, sieve: Optional[SieveState] = None):
    """Dispatch on ``cfg.expert_exec``; returns (y_buf, n_exec_dropped)."""
    _check_expert_exec(cfg)
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


def _aux_on_mesh(mean: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
    """The aux loss a mesh body returns: the value of ``mean`` (the
    all-reduced mean of the shards' aux losses, the reported metric) with
    the gradient of ``own`` (this data row's aux loss).  The reference's
    ``pmean`` over the data axes differentiates so: each data row's
    gradient is that of its own rows' aux loss, and the data-parallel mean
    of the gradients averages them."""
    return mean + (own - own.detach())


def _ep_body(params: dict, x: torch.Tensor, arch: ArchConfig, mi: MeshInfo,
             sieve: Optional[SieveState] = None) -> MoEOut:
    """Replicated-dispatch expert parallelism (``repro.models.moe._ep_body``).

    ``x`` (T, d) is this rank's data shard, the same on every rank of its
    model group; the rank holds experts [m * E_loc, (m + 1) * E_loc).  The
    router runs on every model rank (so each knows the whole routing map,
    the paper's AllGather ③), each rank dispatches only the assignments to
    its experts (⑤) and runs them (⑦), and the partial outputs are summed
    over the model group (⑨/⑩): each token's k experts live on at most k
    ranks.  Any batch size works, single-token decode included."""
    cfg = arch.moe
    E = cfg.n_experts
    E_loc = E // mi.ep_size
    T = x.shape[0]
    r = route(x, params["w_router"], cfg)
    cap = capacity(T, cfg, E)
    off = mi.model_index * E_loc
    # the replicated tokens and routing weights enter this rank's experts
    disp = dispatch(coll.enter(x, mi.model_group), r, E, cap, expert_offset=off, n_local=E_loc)
    # the rows in this rank's buffer: its slice of the routed counts, clipped
    local_rows = torch.clamp(r.counts[off:off + E_loc], max=cap)
    y_buf, exec_dropped = experts_ffn_exec(params, disp.buf, local_rows, cfg, sieve)
    y_partial = combine(y_buf, disp.slot_of, coll.enter(r.weights, mi.model_group), T,
                        sum_dtype=torch.float32)
    y, dropped = coll.all_reduce_sum([y_partial, disp.n_dropped + exec_dropped], mi.model_group)
    # global counts per expert (the Sieve scheduler's input): the router
    # saw this data shard's tokens, so sum over the data group
    counts, aux, dropped = coll.all_reduce_sum([r.counts, r.aux_loss.detach(), dropped], mi.data_group)
    return MoEOut(y.to(x.dtype), _aux_on_mesh(aux / mi.dp_size, r.aux_loss), counts, dropped)


def _ep_a2a_body(params: dict, x: torch.Tensor, arch: ArchConfig, mi: MeshInfo,
                 sieve: Optional[SieveState] = None) -> MoEOut:
    """All-to-all expert parallelism (``repro.models.moe._ep_a2a_body``,
    ``REPRO_EP_MODE=a2a``).

    ``x`` (T, d) is this rank's shard of the tokens over data x model.  The
    rank routes its own tokens into a full-E capacity buffer, sends each
    expert owner its experts' slabs (⑤: (ep, E_loc, cap, d) becomes
    (E_loc, ep, cap, d), segment s from source rank s), runs the segments,
    and the reverse exchange (⑨) brings each token's rows home for the
    combine.  The segment sizes come from the routing map gathered over the
    model group (③)."""
    cfg = arch.moe
    nm = mi.ep_size
    E = cfg.n_experts
    E_loc = E // nm
    T, d = x.shape
    # the router reads this rank's own tokens: the replicated router enters
    r = route(x, coll.enter(params["w_router"], mi.model_group), cfg)
    cap = capacity(T, cfg, E)
    disp = dispatch(x, r, E, cap)

    # ⑤ dispatch: recv[s] is source rank s's slab of this rank's experts
    recv = coll.all_to_all(disp.buf.reshape(nm, E_loc, cap, d), mi.model_group)
    buf = recv.permute(1, 0, 2, 3).contiguous()  # (E_loc, nm, cap, d)

    _check_expert_exec(cfg)
    exec_dropped = torch.zeros((), dtype=torch.int32, device=x.device)
    if cfg.expert_exec in _DUAL_MODES:
        counts_all = coll.all_gather(r.counts, mi.model_group)  # (nm, E)
        off = mi.model_index * E_loc
        sizes = torch.clamp(counts_all[:, off:off + E_loc].T, max=cap)  # (E_loc, nm)
        sieve = resolve_sieve_state(cfg, d, sieve, x.device)
        y_buf, exec_dropped = experts_ffn_dual_segmented(params, buf, sizes, cfg, sieve=sieve)
    else:
        y_buf = experts_ffn(params, buf.reshape(E_loc, nm * cap, d))

    # ⑨ combine: the reverse exchange, expert owner i's rows of this
    # rank's tokens in row i
    y_buf = y_buf.reshape(E_loc, nm, cap, d).permute(1, 0, 2, 3).contiguous()
    y_buf = coll.all_to_all(y_buf, mi.model_group).reshape(E, cap, d)
    y = combine(y_buf, disp.slot_of, r.weights, T)
    counts, aux, dropped = coll.all_reduce_sum([r.counts, r.aux_loss.detach(), disp.n_dropped + exec_dropped],
                                               mi.token_group)
    aux = aux / (mi.dp_size * nm)
    if r.aux_loss.requires_grad:
        # the data row's aux loss, the mean of its model ranks' token
        # shards', differentiated by each data rank
        aux = _aux_on_mesh(aux, coll.row_parallel_sum(r.aux_loss / nm, mi.model_group))
    return MoEOut(y, aux, counts, dropped)


def _routed_params(params: dict) -> dict:
    return {k: params[k] for k in ("w_router", "w_gate", "w_up", "w_down")}


def expert_parallel(cfg: MoEConfig, mi: MeshInfo) -> bool:
    """Whether the experts run expert-parallel on ``mi``: the model group
    has more than one rank and divides them."""
    return mi.ep_size > 1 and cfg.n_experts % mi.ep_size == 0


def moe_block(params: dict, x: torch.Tensor, arch: ArchConfig,
              mi: MeshInfo = LOCAL_MESH, sieve: Optional[SieveState] = None) -> MoEOut:
    """Routed experts (expert-parallel on a mesh) plus shared experts,
    which every token visits: on a mesh whose model group divides their
    ``n_shared * d_expert`` columns a rank holds a column slice of
    ``w_gate``/``w_up`` and the same rows of ``w_down``, and their partial
    outputs are summed over the group (column- then row-parallel).

    ``x`` is this rank's rows of the batch.  Expert parallelism runs when
    the model group has more than one rank and divides the experts;
    ``REPRO_EP_MODE=a2a`` takes the all-to-all body when the mesh also
    divides the tokens (JAX's test, on the global batch), the replicated
    dispatch body otherwise.  Every rank gets the whole ``y`` of its rows
    and the global counts."""
    cfg = arch.moe
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    sieve = resolve_sieve_state(cfg, d, sieve, x.device)
    routed_params = _routed_params(params)
    if expert_parallel(cfg, mi):
        use_a2a = os.environ.get("REPRO_EP_MODE", "psum") == "a2a" and (B * S) % mi.ep_size == 0
        if use_a2a:
            # the tokens of this data row, split over its model ranks
            n = (B * S) // mi.ep_size
            mine = coll.enter(xt, mi.model_group)[mi.model_index * n:(mi.model_index + 1) * n]
            part = _ep_a2a_body(routed_params, mine, arch, mi, sieve=sieve)
            routed = part._replace(y=coll.all_gather(part.y, mi.model_group).reshape(B * S, d))
        else:
            routed = _ep_body(routed_params, xt, arch, mi, sieve=sieve)
    else:
        routed = moe_local(routed_params, xt, arch, sieve=sieve)
    y = routed.y
    if cfg.n_shared:
        group = tp_group("shared", arch, mi)
        y = y + apply_mlp(params["shared"], xt, "swiglu", group)
    return MoEOut(y.reshape(B, S, d), routed.aux_loss, routed.counts, routed.n_dropped)
