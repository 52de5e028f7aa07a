"""Attention + (MoE | dense MLP) blocks (counterpart of
``repro.models.transformer``, the ``attn_mlp`` block kind with GQA or
MLA attention)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from . import attention as attn_lib
from .layers import apply_mlp, apply_norm, init_mlp, init_norm
from .moe import LOCAL_MESH, MeshInfo, MoEOut, init_moe, moe_block


class BlockAux(NamedTuple):
    """Per-layer auxiliary outputs surfaced to the Sieve engine."""

    moe_aux: torch.Tensor  # scalar load-balance loss (0 for dense)
    counts: torch.Tensor  # (E,) expert token counts (zeros(1) for dense)
    dropped: torch.Tensor  # scalar overflow-dropped tokens


def _zero_aux(device) -> BlockAux:
    return BlockAux(
        torch.zeros((), dtype=torch.float32, device=device),
        torch.zeros((1,), dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
    )


def init_attn_mlp_block(gen, arch: ArchConfig, moe: bool, dtype, device) -> dict:
    d = arch.d_model
    if arch.attn.kind == "mla":
        attn = attn_lib.init_mla(gen, arch.attn, d, dtype, device)
    elif arch.attn.kind == "gqa":
        attn = attn_lib.init_gqa(gen, arch.attn, d, dtype, device)
    else:
        raise ValueError(f"attention {arch.attn.kind!r} is not ported (gqa and mla only)")
    p = {"norm1": init_norm(d, device), "norm2": init_norm(d, device), "attn": attn}
    if moe:
        p["moe"] = init_moe(gen, arch, dtype, device)
    else:
        p["mlp"] = init_mlp(gen, d, arch.d_ff, dtype, device)
    return p


def _ffn(p: dict, x: torch.Tensor, h: torch.Tensor, arch: ArchConfig, moe: bool, sieve,
         mi: MeshInfo):
    if moe:
        out: MoEOut = moe_block(p["moe"], h, arch, mi, sieve=sieve)
        return x + out.y, BlockAux(out.aux_loss, out.counts, out.n_dropped)
    return x + apply_mlp(p["mlp"], h, arch.act), _zero_aux(x.device)


def attn_mlp_block_seq(
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,
    arch: ArchConfig,
    moe: bool,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    sieve=None,
    mrope_positions=None,  # (3, B, S): M-RoPE position streams (vlm)
    mi: MeshInfo = LOCAL_MESH,
):
    """Full-sequence block (prefill).  Returns (x, cache, aux), the cache
    ``(k, v)`` or, for MLA, ``(c_kv, k_rope)``.  On a mesh ``x`` is this
    rank's rows and the MoE is expert-parallel."""
    h = apply_norm(p["norm1"], x, arch.norm)
    if arch.attn.kind == "mla":
        a, *cache = attn_lib.mla_prefill(p["attn"], h, positions, arch.attn, q_chunk, kv_chunk)
    else:
        a, *cache = attn_lib.gqa_prefill(
            p["attn"], h, positions, arch.attn, mrope_positions, causal=True,
            q_chunk=q_chunk, kv_chunk=kv_chunk,
        )
    x = x + a
    h = apply_norm(p["norm2"], x, arch.norm)
    x, aux = _ffn(p, x, h, arch, moe, sieve, mi)
    return x, tuple(cache), aux


def attn_mlp_block_decode(
    p: dict,
    x: torch.Tensor,  # (B, 1, d)
    position: torch.Tensor,  # (B,)
    cache,  # (k, v): each (B, T, Kv, dh), or a (n_pool, page, Kv, dh) block pool;
    # MLA: (c_kv (B, T, kv_lora), k_rope (B, T, qk_rope))
    arch: ArchConfig,
    moe: bool,
    sieve=None,
    paged=None,  # (block_tables, owner, block_pos): the cache is a block pool
    mrope_positions=None,  # (3, B, 1): M-RoPE position streams (vlm)
    mi: MeshInfo = LOCAL_MESH,
    seq_par: bool = False,  # the cache is this rank's slice of positions
):
    """One-token block.  Returns (x, aux); the cache is written in place.
    ``seq_par``: the GQA cache ``(k, v)``, or int8 ``(k, v, k_scale,
    v_scale)``, holds this rank's slice of the positions, and attention
    merges over the model group (``gqa_decode_seqpar``)."""
    h = apply_norm(p["norm1"], x, arch.norm)
    if seq_par:
        scales = (cache[2], cache[3]) if len(cache) == 4 else None  # int8 KV
        a = attn_lib.gqa_decode_seqpar(p["attn"], h, position, cache[0], cache[1], arch.attn, mi,
                                       kv_scales=scales)
    elif arch.attn.kind == "mla":
        a = attn_lib.mla_decode(p["attn"], h, position, cache[0], cache[1], arch.attn)
    elif paged is not None:
        a = attn_lib.gqa_decode_paged(p["attn"], h, position, cache[0], cache[1], paged, arch.attn,
                                      mrope_positions)
    else:
        a = attn_lib.gqa_decode(p["attn"], h, position, cache[0], cache[1], arch.attn,
                                mrope_positions)
    x = x + a
    h = apply_norm(p["norm2"], x, arch.norm)
    return _ffn(p, x, h, arch, moe, sieve, mi)
