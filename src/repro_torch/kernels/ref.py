"""Plain PyTorch versions of the kernels (counterparts of
``repro.kernels.ref``: ``fused_swiglu_gmm_ref``, ``fused_swiglu_gemv_ref``,
``gmm_ref``, ``decode_attention_ref`` and ``decode_attention_paged_ref``,
plus the split-KV partials and LSE combine of
``repro/kernels/decode_attention.py:132,178`` and the ragged layout of
``repro/kernels/ops.py:130 gmm_ragged``).  The attention versions take any
head dim and any number of query heads per kv head.

They compute what the CUDA kernels compute, in float32 from the inputs'
values: the CPU path runs them, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.  Two points follow the TPU kernels
rather than the JAX oracles: the SiLU product is cast to the input dtype
before the down projection (``repro/kernels/fused_swiglu.py:117,274``),
and a length-0 attention row gives exact zeros
(``repro/kernels/decode_attention.py:44``) instead of a uniform mean.
Neither changes a float32 result or any row the serving path produces.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30
# KV positions per tile of the TPU's split-KV partition, which the plain
# version keeps: ``n_splits`` is clamped to the tile count and each split
# covers whole tiles, as the TPU kernel clamps to its ``bt`` tiles
# (decode_attention.py:244-245).  The CUDA kernel splits over each live
# length instead (``csrc/decode_attention_split.cu``).
SPLIT_TILE = 64


def fused_swiglu_gmm_ref(
    buf: torch.Tensor,  # (G, C, K) capacity-layout dispatch buffer
    wg: torch.Tensor,  # (E, K, F)
    wu: torch.Tensor,  # (E, K, F)
    wd: torch.Tensor,  # (E, F, N)
    group_sizes: torch.Tensor,  # (G,) live rows per group
    rhs_of_group: Optional[torch.Tensor] = None,  # (G,) weight row per group
) -> torch.Tensor:
    """Grouped SwiGLU over the capacity slab; rows at or past
    ``group_sizes[g]`` are zero."""
    if rhs_of_group is not None:
        idx = rhs_of_group.long()
        wg, wu, wd = wg[idx], wu[idx], wd[idx]
    x = buf.float()
    gate = torch.einsum("gck,gkf->gcf", x, wg.float())
    up = torch.einsum("gck,gkf->gcf", x, wu.float())
    h = (F.silu(gate) * up).to(buf.dtype).float()
    y = torch.einsum("gcf,gfn->gcn", h, wd.float())
    rows = torch.arange(buf.shape[1], device=buf.device)
    live = rows[None, :] < group_sizes.to(buf.device)[:, None]
    return torch.where(live[..., None], y, 0.0).to(buf.dtype)


def fused_swiglu_gemv_ref(
    tokens: torch.Tensor,  # (S, K)
    wg: torch.Tensor,  # (E, K, F)
    wu: torch.Tensor,  # (E, K, F)
    wd: torch.Tensor,  # (E, F, N)
    expert_ids: torch.Tensor,  # (S,)
    valid: torch.Tensor,  # (S,) 1 = live row
) -> torch.Tensor:
    """Per-row SwiGLU with expert ``expert_ids[i]``; ``valid=0`` rows are
    zero."""
    idx = expert_ids.long()
    x = tokens.float()
    gate = torch.einsum("sk,skf->sf", x, wg[idx].float())
    up = torch.einsum("sk,skf->sf", x, wu[idx].float())
    h = (F.silu(gate) * up).to(tokens.dtype).float()
    y = torch.einsum("sf,sfn->sn", h, wd[idx].float())
    return torch.where((valid > 0)[:, None], y, 0.0).to(tokens.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, dh)
    cache_k: torch.Tensor,  # (B, T, Kv, dh)
    cache_v: torch.Tensor,  # (B, T, Kv, dh)
    lengths: torch.Tensor,  # (B,)
) -> torch.Tensor:
    """GQA decode attention over ``pos < lengths``; length-0 rows are zero."""
    B, H, dh = q.shape
    T, Kv = cache_k.shape[1], cache_k.shape[2]
    G = H // Kv
    qf = q.reshape(B, Kv, G, dh).float()
    s = torch.einsum("bkgd,btkd->bkgt", qf, cache_k.float()) / (dh**0.5)
    lengths = lengths.to(q.device)
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(mask[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, cache_v.float())
    o = torch.where((lengths > 0)[:, None, None, None], o, 0.0)
    return o.reshape(B, H, dh).to(q.dtype)


def gmm_ref(
    buf: torch.Tensor,  # (G, C, K) capacity-layout buffer
    rhs: torch.Tensor,  # (E, K, N)
    group_sizes: torch.Tensor,  # (G,) live rows per group
    rhs_of_group: Optional[torch.Tensor] = None,  # (G,) weight row per group
) -> torch.Tensor:
    """Grouped matmul over the capacity slab; rows at or past
    ``group_sizes[g]`` are zero."""
    if rhs_of_group is not None:
        rhs = rhs[rhs_of_group.long()]
    y = torch.einsum("gck,gkn->gcn", buf.float(), rhs.float())
    rows = torch.arange(buf.shape[1], device=buf.device)
    live = rows[None, :] < group_sizes.to(buf.device)[:, None]
    return torch.where(live[..., None], y, 0.0).to(buf.dtype)


def gmm_ragged_ref(
    lhs: torch.Tensor,  # (M, K) group-major rows, group starts bm-aligned
    rhs: torch.Tensor,  # (E, K, N)
    group_sizes: torch.Tensor,  # (E,) live rows per group
    bm: int,
) -> torch.Tensor:
    """Grouped matmul over the bm-aligned ragged layout: bm-row tile i
    belongs to the first group whose cumulative tile count passes i
    (clamped to the last group, as the TPU wrapper's searchsorted is), and
    its rows at or past that group's size are zero."""
    M, K = lhs.shape
    E = rhs.shape[0]
    sizes = group_sizes.to(lhs.device).long().clamp(min=0)
    tiles = (sizes + bm - 1) // bm
    cum = torch.cumsum(tiles, 0)
    tile = torch.arange(M // bm, device=lhs.device)
    g = torch.searchsorted(cum, tile, right=True).clamp(max=E - 1)
    first_row = (tile - (cum - tiles)[g]) * bm  # the tile's first row within its group
    y = torch.bmm(lhs.reshape(M // bm, bm, K).float(), rhs[g].float())
    live = first_row[:, None] + torch.arange(bm, device=lhs.device)[None, :] < sizes[g][:, None]
    return torch.where(live[..., None], y, 0.0).reshape(M, -1).to(lhs.dtype)


def expert_gemv_ref(
    tokens: torch.Tensor,  # (S, K)
    weights: torch.Tensor,  # (E, K, N)
    expert_ids: torch.Tensor,  # (S,)
    valid: torch.Tensor,  # (S,) 1 = live row
) -> torch.Tensor:
    """``tokens[i] @ weights[expert_ids[i]]``; ``valid=0`` rows are zero."""
    y = torch.einsum("sk,skn->sn", tokens.float(), weights[expert_ids.long()].float())
    return torch.where((valid > 0)[:, None], y, 0.0).to(tokens.dtype)


def split_span(T: int, n_splits: int):
    """(splits, positions per split) of the TPU's split-KV partition over a cache of
    ``T`` positions: whole ``SPLIT_TILE`` tiles, the last split ragged or
    empty."""
    n_tiles = -(-T // SPLIT_TILE)
    S = max(1, min(n_splits, n_tiles))
    return S, -(-n_tiles // S) * SPLIT_TILE


def decode_attention_split_partials(q, cache_k, cache_v, lengths, n_splits: int):
    """Per-split normalised partials (B, Kv, S, G, dh) and log-sum-exps
    (B, Kv, S, G), float32.  A split with no live position has ``lse =
    NEG_INF`` and a zero partial."""
    B, H, dh = q.shape
    T, Kv = cache_k.shape[1], cache_k.shape[2]
    G = H // Kv
    S, span = split_span(T, n_splits)
    pad = S * span - T
    ck = F.pad(cache_k.float(), (0, 0, 0, 0, 0, pad))
    cv = F.pad(cache_v.float(), (0, 0, 0, 0, 0, pad))
    qf = q.reshape(B, Kv, G, dh).float()
    s = torch.einsum("bkgd,btkd->bkgt", qf, ck) / (dh**0.5)
    valid = torch.arange(S * span, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    valid = valid[:, None, None].reshape(B, 1, 1, S, span)
    s = torch.where(valid, s.reshape(B, Kv, G, S, span), NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1)  # (B, Kv, G, S)
    o = torch.einsum("bkgsj,bsjkd->bksgd", p, cv.reshape(B, S, span, Kv, dh))
    o = o / torch.clamp(l, min=1e-30).permute(0, 1, 3, 2)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(torch.clamp(l, min=1e-30)), NEG_INF)
    return o, lse.permute(0, 1, 3, 2)


def combine_splits(out_p: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """LSE combine over the split axis (``_combine_splits``,
    decode_attention.py:178): empty splits get zero weight, a row with no
    live position combines to zeros.  (B, Kv, S, G, dh) -> (B, Kv, G, dh)."""
    lse_max = lse.amax(2, keepdim=True)
    w = torch.where(lse > NEG_INF * 0.5, torch.exp(lse - lse_max), 0.0)
    den = w.sum(2)
    out = (out_p.float() * w[..., None]).sum(2)
    return out / torch.clamp(den, min=1e-30)[..., None]


def decode_attention_split_ref(q, cache_k, cache_v, lengths, n_splits: int) -> torch.Tensor:
    """Split-KV decode attention: partials per split, then the combine."""
    B, H, dh = q.shape
    out_p, lse = decode_attention_split_partials(q, cache_k, cache_v, lengths, n_splits)
    return combine_splits(out_p, lse).reshape(B, H, dh).to(q.dtype)


def decode_attention_paged_ref(
    q: torch.Tensor,  # (B, H, dh)
    pool_k: torch.Tensor,  # (n_pool, page, Kv, dh) shared block pool
    pool_v: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) logical -> physical block
    lengths: torch.Tensor,  # (B,)
) -> torch.Tensor:
    """Gather each slot's pool blocks into a dense cache and attend over it
    (dead table cells point at the trash block and are masked by
    ``lengths``)."""
    B = q.shape[0]
    _, page, Kv, dh = pool_k.shape
    nb = block_tables.shape[1]
    idx = block_tables.long()
    k = pool_k[idx].reshape(B, nb * page, Kv, dh)
    v = pool_v[idx].reshape(B, nb * page, Kv, dh)
    return decode_attention_ref(q, k, v, lengths)
