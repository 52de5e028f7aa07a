"""Foundational layers: norms, dense MLP, embeddings, RoPE, M-RoPE and
sinusoidal positions (counterpart of ``repro.models.layers``).

Plain functions on tensors.  Compute runs in the activation dtype with
float32 islands where the JAX reference has them (norm statistics, rotary
phases).  The MLP, the embedding and the logits take an optional process
group: on a mesh a rank holds a slice of their weights
(:mod:`repro_torch.models.sharding`) and the group joins the partials.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import collectives as coll


def he_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """``normal * 1/sqrt(fan_in)`` (fan_in = shape[-2]), the JAX ``_he``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(fan_in**-0.5).to(dtype)


def init_norm(d: int, kind: str, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(params: dict, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, correction=0, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(f"unknown norm {kind!r}")
    y = y * params["scale"].float()
    if kind == "layernorm":
        y = y + params["bias"].float()
    return y.to(x.dtype)


def init_mlp(gen, d_model: int, d_ff: int, act: str, dtype, device) -> dict:
    p = {
        "w_up": he_init(gen, (d_model, d_ff), dtype, device),
        "w_down": he_init(gen, (d_ff, d_model), dtype, device),
    }
    if act == "swiglu":
        p["w_gate"] = he_init(gen, (d_model, d_ff), dtype, device)
    return p


def apply_mlp(params: dict, x: torch.Tensor, act: str, group=None) -> torch.Tensor:
    """The MLP; with ``group`` this rank holds columns of ``w_gate``/``w_up``
    and the same rows of ``w_down`` (column- then row-parallel), and the
    partial outputs are summed over the group."""
    x = coll.enter(x, group)
    up = x @ params["w_up"]
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown act {act!r}")
    return coll.row_parallel_sum(h @ params["w_down"], group)


def embed(table: torch.Tensor, tokens: torch.Tensor, group=None, first_row: int = 0) -> torch.Tensor:
    """``table[tokens]``.  ``F.embedding`` computes the same rows; its
    backward sums a repeated token's rows by sorting, where the backward
    of advanced indexing walks a token's repeats one after another.

    Vocab-parallel with ``group``: ``table`` holds rows ``[first_row,
    first_row + n)`` of the vocabulary, a rank looks up the tokens that
    fall there (zeros elsewhere) and the rows are summed over the group,
    exactly: one rank contributes each."""
    if group is None:
        return F.embedding(tokens, table)
    local = tokens.long() - first_row
    mine = (local >= 0) & (local < table.shape[0])
    rows = F.embedding(torch.where(mine, local, 0), table) * mine[..., None].to(table.dtype)
    return coll.row_parallel_sum(rows, group)


def lm_logits(h: torch.Tensor, table: torch.Tensor,
              w_out: Optional[torch.Tensor], group=None) -> torch.Tensor:
    """Project to the vocabulary.  ``w_out`` is None for tied embeddings.
    Vocab-parallel with ``group``: this rank's columns of the logits, then
    gathered to the whole vocabulary in rank order."""
    h = coll.enter(h, group)
    logits = h @ w_out if w_out is not None else h @ table.T
    return coll.gather_last(logits, group)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head)
    )


def apply_rope(
    x: torch.Tensor,  # (..., seq, heads, d_head)
    positions: torch.Tensor,  # (..., seq)
    theta: float,
) -> torch.Tensor:
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def apply_mrope(
    x: torch.Tensor,  # (batch, seq, heads, d_head)
    positions: torch.Tensor,  # (3, batch, seq): temporal / height / width
    theta: float,
    sections: Tuple[int, int, int],
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the d_head/2 frequency slots are split into
    (temporal, height, width) sections, each rotated by its own position
    stream.  Text tokens carry identical t/h/w positions, which reduces
    M-RoPE to :func:`apply_rope` for them."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not cover d_head/2 = {d // 2}")
    inv = rope_freqs(d, theta, x.device)
    # section id per frequency slot, and each slot's position stream
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])
    pos = positions.permute(1, 2, 0).float()[..., sec]  # (batch, seq, d/2)
    ang = pos * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def sinusoidal_positions(n_pos: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (encoder), float32."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d_model))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
