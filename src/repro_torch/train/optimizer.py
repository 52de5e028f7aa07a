"""AdamW, the cosine schedule and global-norm clipping (counterpart of
``repro.train.optimizer``).

The optimizer state mirrors the parameter tree, with float32 moments
whatever the parameters' dtype (or bfloat16 under ``moment_dtype``; the
update math stays float32).  :func:`adamw_update` writes the new
parameters and moments into the given tensors, where the reference's
compiled step gets the same effect from XLA's buffer donation: a
3B-parameter model at full width on one card has no room for a second
copy of its moments.

On a mesh each rank updates its own part of the tree (the slices
``repro_torch.models.sharding`` gives it) from the data-parallel mean of
the gradients; the global norm adds each split leaf's squares over the
model group and counts each replicated leaf once, so every rank clips by
the norm of the whole tree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.models import collectives as coll
from . import tree as tr


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # moment storage dtype: "float32" (default) or "bfloat16", halving the
    # optimizer state of large models (the update math stays float32)
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor  # scalar int32
    m: Any  # tree like params
    v: Any  # tree like params


def init_opt_state(params: Any, moment_dtype: Union[str, torch.dtype] = torch.float32) -> OptState:
    """Zeroed moments of ``moment_dtype`` (a torch dtype or the config's
    name, ``"float32"``/``"bfloat16"``) and step 0."""
    dt = moment_dtype if isinstance(moment_dtype, torch.dtype) else getattr(torch, moment_dtype)
    leaves = tr.leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return OptState(torch.zeros((), dtype=torch.int32, device=device),
                    tr.tree_map(zeros, params), tr.tree_map(zeros, params))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio * lr``
    at ``total_steps``; float32, on the step's device."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(grads: Any, split: Optional[Sequence[bool]] = None, group=None) -> torch.Tensor:
    """The float32 norm of the whole gradient tree.  On a mesh ``split``
    flags (in leaf order) the leaves a rank holds a slice of: their squares
    are summed over the model ``group``, the replicated leaves' counted
    once."""
    squares = [torch.sum(torch.square(g.float())) for g in tr.leaves(grads)]
    if split is None or coll.group_size(group) == 1:
        return torch.sqrt(sum(squares))
    mine = sum((s for s, f in zip(squares, split) if f), torch.zeros_like(squares[0]))
    whole = sum((s for s, f in zip(squares, split) if not f), torch.zeros_like(squares[0]))
    return torch.sqrt(coll.all_reduce(mine, group) + whole)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float):
    """(float32 grads scaled to a global norm of at most ``max_norm``, the
    norm before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tr.tree_map(lambda g: g.float() * scale, grads), gn


_NO_DECAY_SUBSTRINGS = ("norm", "bias", "scale", "A_log", "dt_bias", "mix_", "w0", "u")


def decay_mask(path) -> bool:
    """Whether the leaf at ``path`` is weight-decayed: the reference's
    rule on its key names (``repro/train/optimizer.py:63``), the port's
    list indices (``blocks/0/...``) left out so that each leaf gets the
    mask of the reference's stacked leaf.  ``"u"`` is among the
    substrings there, so ``w_up``, ``w_out``, ``w_router`` and MLA's
    ``w_uq``/``w_uk``/``w_uv`` are not decayed while ``w_gate`` and
    ``w_down`` are; the port keeps that."""
    name = "/".join(k for k in path if isinstance(k, str))
    return not any(s in name for s in _NO_DECAY_SUBSTRINGS)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: OptState,
                 grad_norm: Optional[torch.Tensor] = None):
    """One AdamW step on global-norm-clipped gradients.  Returns
    ``(params, state, {"grad_norm", "lr"})``: the tensors of ``params`` and
    of the state's moments are updated in place and returned, the step
    counter is a new tensor.  Each leaf's float32 temporaries live only
    while that leaf is updated (the clip is applied leaf by leaf, which is
    the reference's clipped tree, one leaf at a time).  ``grad_norm``: the
    tree's norm, computed by the caller (on a mesh, :func:`global_norm`
    over the model group); by default :func:`global_norm` of ``grads``."""
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = _clip_scale(gn, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    leaves = tr.leaves_with_paths(params)
    for (path, p), g, m, v in zip(leaves, tr.leaves(grads), tr.leaves(state.m), tr.leaves(state.v)):
        g = g.float() * scale
        m.copy_(b1 * m.float() + (1 - b1) * g)
        v.copy_(b2 * v.float() + (1 - b2) * g * g)
        delta = (m.float() / bc1) / (torch.sqrt(v.float() / bc2) + cfg.eps)
        if decay_mask(path):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, OptState(step, state.m, state.v), {"grad_norm": gn, "lr": lr}
