"""Plain PyTorch versions of the three kernels (counterparts of
``repro.kernels.ref``: ``fused_swiglu_gmm_ref``, ``fused_swiglu_gemv_ref``
and ``decode_attention_ref``).

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
