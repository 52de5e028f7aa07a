"""Transformer blocks (counterpart of ``repro.models.transformer``).

Block kinds:
  * ``attn_mlp`` — (GQA | MLA) attention + (dense MLP | MoE)   [most archs]
  * ``mamba``    — Mamba2 block                                 [zamba2]
  * ``rwkv``     — RWKV6 time mix + channel mix                 [rwkv6]
  * ``enc``/``dec`` — whisper encoder / decoder (with cross-attention)

Every block takes the rank's ``MeshInfo`` (``mi``): on a mesh its weights
are the rank's slices and its layers sum over the groups
``sharding.tp_group`` gives them.  The sequence forms write no cache: they
return it, and serve prefill and training alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from . import attention as attn_lib
from . import ssm as ssm_lib
from .layers import apply_mlp, apply_norm, init_mlp, init_norm
from .moe import LOCAL_MESH, MeshInfo, MoEOut, init_moe, moe_block
from .sharding import tp_group


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
    p = {"norm1": init_norm(d, arch.norm, device), "norm2": init_norm(d, arch.norm, device),
         "attn": attn}
    if moe:
        p["moe"] = init_moe(gen, arch, dtype, device)
    else:
        p["mlp"] = init_mlp(gen, d, arch.d_ff, arch.act, dtype, device)
    return p


def _ffn(p: dict, x: torch.Tensor, h: torch.Tensor, arch: ArchConfig, moe: bool, sieve,
         mi: MeshInfo):
    if moe:
        out: MoEOut = moe_block(p["moe"], h, arch, mi, sieve=sieve)
        return x + out.y, BlockAux(out.aux_loss, out.counts, out.n_dropped)
    # column- then row-parallel where the model group divides d_ff
    return x + apply_mlp(p["mlp"], h, arch.act, tp_group("mlp", arch, mi)), _zero_aux(x.device)


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
    rank's rows, the MoE is expert-parallel and attention and the dense FFN
    tensor-parallel where the model group divides them."""
    h = apply_norm(p["norm1"], x, arch.norm)
    if arch.attn.kind == "mla":
        a, *cache = attn_lib.mla_prefill(p["attn"], h, positions, arch.attn, q_chunk, kv_chunk, mi)
    else:
        a, *cache = attn_lib.gqa_prefill(
            p["attn"], h, positions, arch.attn, mrope_positions, causal=True,
            q_chunk=q_chunk, kv_chunk=kv_chunk, mi=mi,
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
        a = attn_lib.mla_decode(p["attn"], h, position, cache[0], cache[1], arch.attn, mi)
    elif paged is not None:
        a = attn_lib.gqa_decode_paged(p["attn"], h, position, cache[0], cache[1], paged, arch.attn,
                                      mrope_positions)
    else:
        a = attn_lib.gqa_decode(p["attn"], h, position, cache[0], cache[1], arch.attn,
                                mrope_positions, mi=mi)
    x = x + a
    h = apply_norm(p["norm2"], x, arch.norm)
    return _ffn(p, x, h, arch, moe, sieve, mi)


# ---------------------------------------------------------------------------
# mamba / rwkv blocks
# ---------------------------------------------------------------------------


def init_mamba_block(gen, arch: ArchConfig, dtype, device) -> dict:
    return {
        "norm": init_norm(arch.d_model, arch.norm, device),
        "mamba": ssm_lib.init_mamba2(gen, arch.d_model, arch.ssm, dtype, device),
    }


def mamba_block(p, x, arch: ArchConfig, state, step: bool, mi: MeshInfo = LOCAL_MESH):
    """Returns (x, new state): the sequence form from ``state`` (zeros
    when None), or with ``step`` the one-token update."""
    h = apply_norm(p["norm"], x, arch.norm)
    group = tp_group("mamba", arch, mi)
    if step:
        y, new_state = ssm_lib.mamba2_step(p["mamba"], h, arch.ssm, state, group)
    else:
        y, new_state = ssm_lib.mamba2_seq(p["mamba"], h, arch.ssm, state, group)
    return x + y, new_state


def init_rwkv_block(gen, arch: ArchConfig, dtype, device) -> dict:
    return {
        "norm1": init_norm(arch.d_model, "layernorm", device),
        "norm2": init_norm(arch.d_model, "layernorm", device),
        "rwkv": ssm_lib.init_rwkv6(gen, arch.d_model, arch.d_ff, arch.ssm, dtype, device),
    }


def rwkv_block(p, x, arch: ArchConfig, state, mi: MeshInfo = LOCAL_MESH):
    groups = (tp_group("rwkv", arch, mi), tp_group("cmix", arch, mi))
    return ssm_lib.rwkv6_block_seq(p["rwkv"], x, arch.ssm, state, (p["norm1"], p["norm2"]), groups)


# ---------------------------------------------------------------------------
# whisper encoder / decoder blocks
# ---------------------------------------------------------------------------


def init_enc_block(gen, arch: ArchConfig, dtype, device) -> dict:
    d = arch.d_model
    return {
        "norm1": init_norm(d, arch.norm, device),
        "attn": attn_lib.init_gqa(gen, arch.attn, d, dtype, device),
        "norm2": init_norm(d, arch.norm, device),
        "mlp": init_mlp(gen, d, arch.d_ff, arch.act, dtype, device),
    }


def enc_block(p, x, arch: ArchConfig, q_chunk: int = 1024, kv_chunk: int = 1024,
              mi: MeshInfo = LOCAL_MESH):
    """Non-causal self-attention (no rotation) and the MLP."""
    h = apply_norm(p["norm1"], x, arch.norm)
    a, _, _ = attn_lib.gqa_prefill(p["attn"], h, None, arch.attn, causal=False,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk, mi=mi)
    x = x + a
    h = apply_norm(p["norm2"], x, arch.norm)
    return x + apply_mlp(p["mlp"], h, arch.act, tp_group("mlp", arch, mi))


def init_dec_block(gen, arch: ArchConfig, dtype, device) -> dict:
    d = arch.d_model
    return {
        "norm1": init_norm(d, arch.norm, device),
        "attn": attn_lib.init_gqa(gen, arch.attn, d, dtype, device),
        "norm_x": init_norm(d, arch.norm, device),
        "xattn": attn_lib.init_cross_attention(gen, arch.attn, d, dtype, device),
        "norm2": init_norm(d, arch.norm, device),
        "mlp": init_mlp(gen, d, arch.d_ff, arch.act, dtype, device),
    }


def _cross_and_mlp(p, x, enc_kv, arch: ArchConfig, mi: MeshInfo):
    h = apply_norm(p["norm_x"], x, arch.norm)
    x = x + attn_lib.cross_attention(p["xattn"], h, enc_kv[0], enc_kv[1], arch.attn,
                                     tp_group("xattn", arch, mi))
    h = apply_norm(p["norm2"], x, arch.norm)
    return x + apply_mlp(p["mlp"], h, arch.act, tp_group("mlp", arch, mi))


def dec_block_seq(p, x, enc_kv, arch: ArchConfig, q_chunk: int = 512, kv_chunk: int = 512,
                  mi: MeshInfo = LOCAL_MESH):
    """Decoder prefill: causal self-attention (whisper's positions are
    learned and added to the input: no rotation), then cross-attention to
    the encoder's ``enc_kv`` and the MLP.  Returns (x, (k, v))."""
    h = apply_norm(p["norm1"], x, arch.norm)
    a, k, v = attn_lib.gqa_prefill(p["attn"], h, None, arch.attn, causal=True,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk, mi=mi)
    return _cross_and_mlp(p, x + a, enc_kv, arch, mi), (k, v)


def dec_block_decode(p, x, position, cache, enc_kv, arch: ArchConfig, mi: MeshInfo = LOCAL_MESH):
    """One decoder token: the self-attention K/V row is written into
    ``cache`` in place and attended through the decode-attention kernel."""
    h = apply_norm(p["norm1"], x, arch.norm)
    a = attn_lib.gqa_decode(p["attn"], h, position, cache[0], cache[1], arch.attn, use_rope=False, mi=mi)
    return _cross_and_mlp(p, x + a, enc_kv, arch, mi)
