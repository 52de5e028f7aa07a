"""Attention: GQA (chunked online-softmax prefill, cached decode),
DeepSeek-V2's MLA and whisper's cross-attention (counterpart of
``repro.models.attention``).

Prefill attention (:func:`flash_attention`) is plain PyTorch, as it is
plain jnp in the reference.  GQA decode attention goes through the
``decode_attention`` kernel wrapper (dense cache) or the
``decode_attention_paged`` one (paged block pool), which run the CUDA
kernels on the card and their plain versions on the CPU.  MLA decode is
the matrix-absorbed form in float32 einsums, as the reference computes it
outside any kernel; cross-attention is the plain ``flash_attention``.

On a mesh (``mi``) whose model group splits the heads
(``sharding.tp_splits``), GQA and MLA run tensor-parallel: a rank holds
its heads' slices of the projections, computes the one-process function
on a config of its ``n_heads / m`` (and ``n_kv_heads / m``) heads, and the
partial outputs of ``wo`` are summed over the group in float32
(:func:`_project_out`); its GQA cache holds its kv heads.  Whisper's
cross-attention splits by heads the same way (its own ``xattn`` layer).
The replicated input of a rank's heads (GQA's and the cross-attention's
``x`` and encoder states, MLA's latents) enters them through
``collectives.enter``, whose backward sums the heads' partial gradients.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import AttnConfig
from repro_torch.kernels import ops, ref
from . import collectives as coll
from .layers import apply_mrope, apply_rope, he_init
from .moe import LOCAL_MESH, MeshInfo
from .sharding import rank_attn

NEG_INF = -1e30


def init_gqa(gen, cfg: AttnConfig, d_model: int, dtype, device) -> dict:
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": he_init(gen, (d_model, H * dh), dtype, device),
        "wk": he_init(gen, (d_model, K * dh), dtype, device),
        "wv": he_init(gen, (d_model, K * dh), dtype, device),
        "wo": he_init(gen, (H * dh, d_model), dtype, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H * dh), ("bk", K * dh), ("bv", K * dh)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def init_mla(gen, cfg: AttnConfig, d_model: int, dtype, device) -> dict:
    m, H = cfg.mla, cfg.n_heads
    return {
        "w_dq": he_init(gen, (d_model, m.q_lora_rank), dtype, device),
        "q_norm_scale": torch.ones((m.q_lora_rank,), dtype=torch.float32, device=device),
        "w_uq": he_init(gen, (m.q_lora_rank, H * (m.qk_nope_dim + m.qk_rope_dim)), dtype, device),
        "w_dkv": he_init(gen, (d_model, m.kv_lora_rank), dtype, device),
        "kv_norm_scale": torch.ones((m.kv_lora_rank,), dtype=torch.float32, device=device),
        "w_kr": he_init(gen, (d_model, m.qk_rope_dim), dtype, device),
        "w_uk": he_init(gen, (m.kv_lora_rank, H * m.qk_nope_dim), dtype, device),
        "w_uv": he_init(gen, (m.kv_lora_rank, H * m.v_head_dim), dtype, device),
        "wo": he_init(gen, (H * m.v_head_dim, d_model), dtype, device),
    }


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, dh)
    k: torch.Tensor,  # (B, Sk, K, dh)
    v: torch.Tensor,  # (B, Sk, K, dh)
    causal: bool = True,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax blockwise attention in float32; GQA via repeated kv
    heads.  Memory is O(q_chunk * kv_chunk) per (batch, head)."""
    B, Sq, H, dh = q.shape
    _, Sk, K, _ = k.shape
    dv = v.shape[-1]
    G = H // K
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    if Sq % q_chunk or Sk % kv_chunk:
        raise ValueError(f"chunks must divide the sequence: {(Sq, q_chunk, Sk, kv_chunk)}")
    scale = 1.0 / float(dh) ** 0.5
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    qf, kf, vf = q.float(), k.float(), v.float()
    dev = q.device
    outs = []
    for q0 in range(0, Sq, q_chunk):
        q_blk = qf[:, q0:q0 + q_chunk]
        q_pos = q_offset + torch.arange(q0, q0 + q_chunk, device=dev)
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, q_chunk, dv), dtype=torch.float32, device=dev)
        for k0 in range(0, Sk, kv_chunk):
            k_blk, v_blk = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqhd,bthd->bhqt", q_blk, k_blk) * scale
            if causal:
                k_pos = torch.arange(k0, k0 + kv_chunk, device=dev)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqt,bthd->bhqd", p, v_blk)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=2)  # (B, H, Sq, dv)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # (B, 1, H, dh)
    cache_k: torch.Tensor,  # (B, T, K, dh)
    cache_v: torch.Tensor,
    length: torch.Tensor,  # (B,) valid entries incl. the current token
) -> torch.Tensor:
    """One-token GQA attention against the cache (the dense oracle)."""
    return ref.decode_attention_ref(q[:, 0], cache_k, cache_v, length)[:, None]


def _project_out(o: torch.Tensor, wo: torch.Tensor, split: bool, mi: MeshInfo) -> torch.Tensor:
    """``o @ wo``; with ``split`` (this rank holds some of the heads) the
    rank's partial summed over the model group in float32, rounded once."""
    y = o @ wo
    return coll.row_parallel_sum(y, mi.model_group) if split else y


def _rope_or_mrope(x, positions, cfg: AttnConfig, mrope_positions):
    if cfg.mrope_sections is not None and mrope_positions is not None:
        return apply_mrope(x, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
    if positions is None:
        return x
    return apply_rope(x, positions, cfg.rope_theta)


def gqa_project_qkv(
    params: dict,
    x: torch.Tensor,  # (B, S, d)
    positions: Optional[torch.Tensor],
    cfg: AttnConfig,
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, S)
    use_rope: bool = True,
):
    B, S, _ = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, K, dh)
    v = v.reshape(B, S, K, dh)
    if use_rope:
        q = _rope_or_mrope(q, positions, cfg, mrope_positions)
        k = _rope_or_mrope(k, positions, cfg, mrope_positions)
    return q, k, v


def gqa_prefill(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: AttnConfig,
    mrope_positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    mi: MeshInfo = LOCAL_MESH,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y, k, v): the output and the prompt's K/V (this rank's kv
    heads where the heads are split over ``mi``'s model group)."""
    local = rank_attn(cfg, mi)
    if local is not cfg:  # the rank's heads' columns of the projections
        x = coll.enter(x, mi.model_group)
    q, k, v = gqa_project_qkv(params, x, positions, local, mrope_positions)
    o = flash_attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)
    B, S = x.shape[:2]
    return _project_out(o.reshape(B, S, -1), params["wo"], local is not cfg, mi), k, v


def gqa_decode(
    params: dict,
    x: torch.Tensor,  # (B, 1, d)
    position: torch.Tensor,  # (B,) current position
    cache_k: torch.Tensor,  # (B, T, K, dh), updated in place
    cache_v: torch.Tensor,
    cfg: AttnConfig,
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, 1)
    use_rope: bool = True,
    mi: MeshInfo = LOCAL_MESH,
) -> torch.Tensor:
    """One decode step.  Writes the new (k, v) row at ``position`` into the
    cache in place (the JAX engine gets the same effect from buffer
    donation) and returns the attention output.  ``use_rope=False``: no
    rotation (whisper's decoder adds learned positions to its input).
    Where the heads are split over ``mi``'s model group the cache holds
    this rank's kv heads and the kernel runs at the rank's head count."""
    local = rank_attn(cfg, mi)
    q, k1, v1 = gqa_project_qkv(params, x, position[:, None], local, mrope_positions, use_rope)
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    idx = position.long().clamp(0, cache_k.shape[1] - 1)  # JAX clamps the slice start
    cache_k[rows, idx] = k1[:, 0].to(cache_k.dtype)
    cache_v[rows, idx] = v1[:, 0].to(cache_v.dtype)
    lengths = (idx + 1).to(torch.int32)
    o = ops.decode_attention(q[:, 0].contiguous(), cache_k, cache_v, lengths)
    return _project_out(o.reshape(B, 1, -1), params["wo"], local is not cfg, mi)


# ---------------------------------------------------------------------------
# Paged decode (shared block pool + per-slot block tables)
# ---------------------------------------------------------------------------


def paged_decode_attention_ref(
    q: torch.Tensor,  # (B, 1, H, dh)
    pool_k: torch.Tensor,  # (n_pool, page, Kv, dh)
    pool_v: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) int32
    lengths: torch.Tensor,  # (B,)
) -> torch.Tensor:
    """Oracle: gather each slot's blocks into a dense cache, then run the
    dense reference."""
    return ref.decode_attention_paged_ref(q[:, 0], pool_k, pool_v, block_tables, lengths)[:, None]


def paged_decode_attention_xla(
    q: torch.Tensor,  # (B, 1, H, dh)
    pool_k: torch.Tensor,  # (n_pool, page, Kv, dh)
    pool_v: torch.Tensor,
    owner: torch.Tensor,  # (n_pool,) int32 slot owning each block, -1 free
    block_pos: torch.Tensor,  # (n_pool,) int32 logical index within owner
    lengths: torch.Tensor,  # (B,)
) -> torch.Tensor:
    """Pool-major twin of the paged flash-decode (the JAX package's XLA
    twin, kept as a plain function for the tests).

    Iterates physical blocks instead of (slot, max_seq) positions: each
    pool block computes its partial (m, l, acc) against its owner's query
    and a segment reduction combines them per slot."""
    B, _, H, dh = q.shape
    n_pool, page, Kv, _ = pool_v.shape
    G = H // Kv
    dev = q.device
    qf = q.reshape(B, Kv, G, dh).float()
    own = torch.clamp(owner.long(), 0, B - 1)
    qp = qf[own]  # (n_pool, Kv, G, dh): free blocks get slot 0's q, masked
    s = torch.einsum("pkgd,ptkd->pkgt", qp, pool_k.float()) / float(dh) ** 0.5
    pos = block_pos.long()[:, None] * page + torch.arange(page, device=dev)[None, :]
    valid = (owner[:, None] >= 0) & (pos < lengths.to(dev).long()[own][:, None])
    s = torch.where(valid[:, None, None], s, NEG_INF)
    # two-pass softmax across each owner's blocks by segment reductions;
    # free blocks land in the B-th (discarded) segment
    seg = torch.where(owner >= 0, owner.long(), B)
    m_blk = s.amax(-1)  # (n_pool, Kv, G)
    m_slot = torch.full((B + 1, Kv, G), float("-inf"), device=dev).scatter_reduce_(
        0, seg[:, None, None].expand_as(m_blk), m_blk, "amax"
    )[:B]
    m_slot = torch.clamp(m_slot, min=NEG_INF)  # slots with no blocks: -inf -> finite
    m_of_blk = torch.cat([m_slot, torch.zeros((1, Kv, G), device=dev)])[seg]
    p = torch.where(valid[:, None, None], torch.exp(s - m_of_blk[..., None]), 0.0)
    l_blk = p.sum(-1)
    acc_blk = torch.einsum("pkgt,ptkd->pkgd", p, pool_v.float())
    l_slot = torch.zeros((B + 1, Kv, G), device=dev).index_add_(0, seg, l_blk)[:B]
    acc = torch.zeros((B + 1, Kv, G, dh), device=dev).index_add_(0, seg, acc_blk)[:B]
    out = acc / torch.clamp(l_slot, min=1e-30)[..., None]
    return out.reshape(B, 1, H, dh).to(q.dtype)


def gqa_decode_paged(
    params: dict,
    x: torch.Tensor,  # (B, 1, d)
    position: torch.Tensor,  # (B,) current position
    pool_k: torch.Tensor,  # (n_pool, page, Kv, dh), updated in place
    pool_v: torch.Tensor,
    paged: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # (block_tables, owner, block_pos)
    cfg: AttnConfig,
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, 1)
) -> torch.Tensor:
    """One paged decode step: write the new (k, v) row into the shared
    block pool in place, through the slot's block table, then attend over
    the slot's logical blocks only.  Idle slots resolve to the trash block
    (physical 0, owner -1), so their write never touches live data."""
    block_tables = paged[0]
    q, k1, v1 = gqa_project_qkv(params, x, position[:, None], cfg, mrope_positions)
    B = x.shape[0]
    page = pool_k.shape[1]
    pos = position.long()
    phys = torch.gather(block_tables.long(), 1, (pos // page)[:, None])[:, 0]
    off = pos % page
    pool_k[phys, off] = k1[:, 0].to(pool_k.dtype)
    pool_v[phys, off] = v1[:, 0].to(pool_v.dtype)
    lengths = (pos + 1).to(torch.int32)
    o = ops.decode_attention_paged(q[:, 0].contiguous(), pool_k, pool_v, block_tables, lengths)
    return o.reshape(B, 1, -1) @ params["wo"]


# ---------------------------------------------------------------------------
# Sequence-parallel decode (the KV cache split over the model group's ranks)
# ---------------------------------------------------------------------------


def quantize_kv_row(row: torch.Tensor):
    """Per-(token, head) int8 quantisation: row (B, 1, K, dh) -> (int8 row,
    float32 scale (B, 1, K))."""
    rf = row.float()
    scale = torch.clamp(rf.abs().amax(-1, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(rf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def _write_owned(cache: torch.Tensor, row: torch.Tensor, idx: torch.Tensor,
                 own: torch.Tensor) -> None:
    """``cache[b, idx[b]] = row[b]`` where ``own[b]``, in place, with no host
    synchronisation (an unowned slot writes its old value back)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    old = cache[rows, idx]
    keep = own.reshape((-1,) + (1,) * (old.ndim - 1))
    cache[rows, idx] = torch.where(keep, row.to(cache.dtype), old)


def gqa_decode_seqpar(
    params: dict,
    x: torch.Tensor,  # (B, 1, d): this rank's rows
    position: torch.Tensor,  # (B,) global positions
    cache_k: torch.Tensor,  # (B, T_loc, K, dh): this rank's slice of positions
    cache_v: torch.Tensor,
    cfg: AttnConfig,
    mi,  # MeshInfo
    use_rope: bool = True,
    kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (B, T_loc, K) f32 each
) -> torch.Tensor:
    """Sequence-parallel decode attention (``repro.models.attention.
    gqa_decode_seqpar``): the KV cache is split along the sequence over the
    model group, rank m holding positions [m * T_loc, (m + 1) * T_loc).

    A rank writes the new K/V row in place only if it owns the position,
    computes the partial online softmax (m, l, acc) in float32 over its
    slice, masked by global position, and the partials merge exactly over
    the group: the max of ``m``, then the sum of ``l`` and ``acc`` rescaled
    to it.  With ``kv_scales`` the cache is int8 and the
    per-(token, head) scales fold into the scores and into ``p``.  Plain
    PyTorch, as the reference is einsum work with no kernel."""
    from . import collectives as coll

    q, k1, v1 = gqa_project_qkv(params, x, position[:, None] if use_rope else None, cfg,
                                None, use_rope)
    B, T_loc, K, dh = cache_k.shape
    local = position.long() - mi.model_index * T_loc
    own = (local >= 0) & (local < T_loc)
    idx = torch.clamp(local, 0, T_loc - 1)
    int8_kv = kv_scales is not None
    if int8_kv:
        k1, k1s = quantize_kv_row(k1)
        v1, v1s = quantize_kv_row(v1)
        _write_owned(kv_scales[0], k1s[:, 0], idx, own)
        _write_owned(kv_scales[1], v1s[:, 0], idx, own)
    _write_owned(cache_k, k1[:, 0], idx, own)
    _write_owned(cache_v, v1[:, 0], idx, own)

    H = q.shape[2]
    G = H // K
    qf = q.reshape(B, K, G, dh).float()
    s = torch.einsum("bkgd,btkd->bkgt", qf, cache_k.float())
    if int8_kv:  # fold the per-(token, head) dequantisation scales in
        s = s * kv_scales[0].transpose(1, 2)[:, :, None, :]
    s = s / float(dh) ** 0.5
    gpos = mi.model_index * T_loc + torch.arange(T_loc, device=x.device)
    mask = gpos[None, :] <= position.long()[:, None]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(-1)  # (B, K, G)
    p = torch.exp(s - m[..., None])
    pv = p * kv_scales[1].transpose(1, 2)[:, :, None, :] if int8_kv else p
    l = p.sum(-1)
    acc = torch.einsum("bkgt,btkd->bkgd", pv, cache_v.float())
    # merge the partials over the group (the exact flash merge); l and acc
    # travel in one sum
    m_all = coll.all_reduce(m, mi.model_group, "max")
    corr = torch.exp(m - m_all)
    merged = coll.all_reduce(torch.cat([acc, l[..., None]], -1) * corr[..., None], mi.model_group)
    o = merged[..., :-1] / torch.clamp(merged[..., -1], min=1e-30)[..., None]
    return o.reshape(B, 1, H * dh).to(x.dtype) @ params["wo"]


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------


def _mla_q(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: AttnConfig, group=None):
    """The queries' no-RoPE and rotated parts, each (B, S, H, dim).  With
    ``group`` (the heads split over it) the whole latent ``cq`` enters the
    rank's heads' columns of ``w_uq``."""
    m = cfg.mla
    B, S, _ = x.shape
    cq = coll.enter(_rms(x @ params["w_dq"], params["q_norm_scale"]), group)
    q = (cq @ params["w_uq"]).reshape(B, S, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: AttnConfig):
    """The compressed cache rows: c_kv (B, S, kv_lora) and the rotated
    k_rope (B, S, qk_rope) that all heads share."""
    c_kv = _rms(x @ params["w_dkv"], params["kv_norm_scale"])
    k_rope = apply_rope((x @ params["w_kr"])[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_prefill(
    params: dict,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (B, S)
    cfg: AttnConfig,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    mi: MeshInfo = LOCAL_MESH,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y, c_kv, k_rope): the output and the compressed caches
    (whole on every rank: the latent is shared by all heads)."""
    local = rank_attn(cfg, mi)
    split, cfg = local is not cfg, local
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    # the latents are whole on every rank: each enters the rank's heads
    group = mi.model_group if split else None
    q_nope, q_rope = _mla_q(params, x, positions, cfg, group)
    c_kv, k_rope = _mla_latent(params, x, positions, cfg)
    c_in, kr_in = coll.enter(c_kv, group), coll.enter(k_rope, group)
    k_nope = (c_in @ params["w_uk"]).reshape(B, S, H, m.qk_nope_dim)
    v = (c_in @ params["w_uv"]).reshape(B, S, H, m.v_head_dim)
    qq = torch.cat([q_nope, q_rope], -1)
    kk = torch.cat([k_nope, kr_in[:, :, None, :].expand(B, S, H, m.qk_rope_dim)], -1)
    o = flash_attention(qq, kk, v, causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
    return _project_out(o.reshape(B, S, -1), params["wo"], split, mi), c_kv, k_rope


def mla_decode(
    params: dict,
    x: torch.Tensor,  # (B, 1, d)
    position: torch.Tensor,  # (B,)
    cache_ckv: torch.Tensor,  # (B, T, kv_lora), updated in place
    cache_kr: torch.Tensor,  # (B, T, qk_rope), updated in place
    cfg: AttnConfig,
    mi: MeshInfo = LOCAL_MESH,
) -> torch.Tensor:
    """Matrix-absorbed MLA decode: attention runs in the compressed latent
    space, in float32 as the reference computes it.  Writes the step's
    ``(c_kv, k_rope)`` row at ``position`` into the caches in place (the
    row index clamped to the cache, as ``dynamic_update_slice`` clamps its
    start) and attends over positions ``t < position + 1``.  Where the
    heads are split over ``mi``'s model group a rank attends with its
    heads over the whole latent cache, which every rank writes alike."""
    local = rank_attn(cfg, mi)
    split, cfg = local is not cfg, local
    m, H = cfg.mla, cfg.n_heads
    B, T = cache_ckv.shape[:2]
    q_nope, q_rope = _mla_q(params, x, position[:, None], cfg)
    c1, kr1 = _mla_latent(params, x, position[:, None], cfg)
    rows = torch.arange(B, device=x.device)
    idx = position.long().clamp(0, T - 1)
    cache_ckv[rows, idx] = c1[:, 0].to(cache_ckv.dtype)
    cache_kr[rows, idx] = kr1[:, 0].to(cache_kr.dtype)

    # absorb W_uk into the query: q_lat[b,h,c] = sum_n q_nope[b,h,n] W_uk[c,(h,n)]
    w_uk = params["w_uk"].reshape(-1, H, m.qk_nope_dim).float()  # (c, H, n)
    q_lat = torch.einsum("bhn,chn->bhc", q_nope[:, 0].float(), w_uk)
    ckv = cache_ckv.float()
    scale = 1.0 / float(m.qk_nope_dim + m.qk_rope_dim) ** 0.5
    s = (torch.einsum("bhc,btc->bht", q_lat, ckv)
         + torch.einsum("bhr,btr->bht", q_rope[:, 0].float(), cache_kr.float())) * scale
    mask = torch.arange(T, device=x.device)[None, :] < (position.long()[:, None] + 1)
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx_lat = torch.einsum("bht,btc->bhc", p, ckv)
    w_uv = params["w_uv"].reshape(-1, H, m.v_head_dim).float()  # (c, H, v)
    o = torch.einsum("bhc,chv->bhv", ctx_lat, w_uv)
    return _project_out(o.reshape(B, 1, -1).to(x.dtype), params["wo"], split, mi)


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------


def _divisor_chunk(n: int, target: int) -> int:
    """Largest chunk <= target that divides n (1500 -> 750, etc.)."""
    c = min(target, n)
    while n % c:
        c -= 1
    return max(c, 1)


def cross_attention(
    params: dict,
    x: torch.Tensor,  # (B, Sq, d)
    enc_k: torch.Tensor,  # (B, Se, H, dh) projected from the encoder's states
    enc_v: torch.Tensor,
    cfg: AttnConfig,
    group=None,
) -> torch.Tensor:
    """Non-causal attention of the decoder's queries over the encoder's
    K/V: the plain ``flash_attention``, as in the reference.  With
    ``group`` (the heads split over a model group) the weights and the K/V
    are this rank's heads' and the partials of ``wo`` are summed."""
    B, Sq, _ = x.shape
    q = (coll.enter(x, group) @ params["wq"]).reshape(B, Sq, -1, cfg.d_head)
    o = flash_attention(q, enc_k, enc_v, causal=False, q_chunk=_divisor_chunk(Sq, 1024),
                        kv_chunk=_divisor_chunk(enc_k.shape[1], 1024))
    return coll.row_parallel_sum(o.reshape(B, Sq, -1) @ params["wo"], group)


def init_cross_attention(gen, cfg: AttnConfig, d_model: int, dtype, device) -> dict:
    H, dh = cfg.n_heads, cfg.d_head
    return {
        "wq": he_init(gen, (d_model, H * dh), dtype, device),
        "wk": he_init(gen, (d_model, H * dh), dtype, device),
        "wv": he_init(gen, (d_model, H * dh), dtype, device),
        "wo": he_init(gen, (H * dh, d_model), dtype, device),
    }


def project_cross_kv(params: dict, enc_states: torch.Tensor, cfg: AttnConfig, group=None):
    """The encoder states' K and V, (B, Se, H, dh) each (a tensor-parallel
    rank's heads from its columns of ``wk``/``wv``, ``group`` the model
    group it splits them over)."""
    enc_states = coll.enter(enc_states, group)
    B, Se, _ = enc_states.shape
    k = (enc_states @ params["wk"]).reshape(B, Se, -1, cfg.d_head)
    v = (enc_states @ params["wv"]).reshape(B, Se, -1, cfg.d_head)
    return k, v
