"""The train step: loss and gradients under autograd, microbatching,
optional int8 gradient compression, AdamW (counterpart of
``repro.train.train_loop``).

    loss, grads = autograd of lm.loss      # per-block remat inside LM
    optional int8 error-feedback compression (in place of the DP reduce)
    params, opt = adamw_update(...)        # in place

Microbatching splits the global batch into ``n_microbatches`` slices and
accumulates their gradients in float32, which equals the full-batch
gradient (the tests hold it so).  The step runs eagerly on the model's
device; the parameters are leaf tensors that require grad
(:func:`init_train_state`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.model import LM
from . import compression
from . import tree as tr
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state


@dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    n_microbatches: int = 1
    grad_compression: bool = False


def _loss_and_grads(lm: LM, params, batch):
    """(loss, metrics, gradient tree): a leaf the loss does not reach
    gets zeros, as ``jax.grad`` gives it."""
    leaves = tr.leaves(params)
    loss, metrics = lm.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return loss.detach(), metrics, tr.unflatten(params, grads)


def _microbatch(batch: Dict[str, Any], i: int, mb: int, B: int) -> Dict[str, Any]:
    """Rows [i * mb, (i + 1) * mb) of every batch entry: axis 0 (tokens,
    labels, a stub's ``embeds``: the VLM's patches, whisper's encoder frames
    beside its decoder tokens), or axis 1 of the (3, B, S) M-RoPE
    positions."""

    def s(x):
        if x.ndim >= 1 and x.shape[0] == B:
            return x[i * mb:(i + 1) * mb]
        if x.ndim >= 2 and x.shape[0] == 3 and x.shape[1] == B:  # mrope
            return x[:, i * mb:(i + 1) * mb]
        return x

    return {k: s(v) for k, v in batch.items()}


def _microbatched_grads(lm: LM, params, batch: Dict[str, Any], n_micro: int):
    """(loss, metrics of the last microbatch, grads): with ``n_micro > 1``
    the gradients of the slices, accumulated in float32, over
    ``n_micro``."""
    if n_micro <= 1:
        return _loss_and_grads(lm, params, batch)
    B = batch["labels"].shape[0]
    if B % n_micro:
        raise ValueError(f"batch of {B} rows does not split into {n_micro} microbatches")
    mb = B // n_micro
    acc, loss_sum, metrics = None, 0.0, None
    for i in range(n_micro):
        loss, metrics, grads = _loss_and_grads(lm, params, _microbatch(batch, i, mb, B))
        if acc is None:
            acc = tr.tree_map(lambda g: g.float(), grads)
        else:
            tr.tree_map(lambda a, g: a.add_(g.float()), acc, grads)
        loss_sum = loss_sum + loss
    return loss_sum / n_micro, metrics, tr.tree_map(lambda a: a / n_micro, acc)


def make_train_step(lm: LM, cfg: TrainConfig) -> Callable[..., Tuple]:
    """``train_step(params, opt_state, batch, residual) -> (params,
    opt_state, residual, metrics)``, the metrics those of the reference
    (``loss``, ``ce``, ``moe_aux``, ``dropped``, ``grad_norm``, ``lr``) as
    tensors on the model's device.  The parameter and moment tensors are
    updated in place."""

    def train_step(params, opt_state: OptState, batch, residual):
        loss, metrics, grads = _microbatched_grads(lm, params, batch, cfg.n_microbatches)
        if cfg.grad_compression:
            # quantise where the data-parallel all-reduce would run; the
            # residual carries the quantisation error to the next step
            cgrads, residual = compression.compress(grads, residual)
            grads = compression.decompress(cgrads)
        params, opt_state, opt_metrics = adamw_update(cfg.opt, params, grads, opt_state)
        aux = metrics["aux"]
        out = {"loss": loss, "ce": metrics["ce"].detach(), "moe_aux": aux.moe_aux.detach(),
               "dropped": aux.dropped, **opt_metrics}
        return params, opt_state, residual, out

    return train_step


def init_train_state(lm: LM, seed: int, cfg: TrainConfig):
    """``(params, opt_state, residual)``: ``lm.init(seed)`` with every
    leaf made a tensor that requires grad, zeroed moments of
    ``cfg.opt.moment_dtype``, and the compression residual (a float32
    zero scalar without compression)."""
    params = tr.tree_map(lambda p: p.requires_grad_(True), lm.init(seed))
    opt_state = init_opt_state(params, cfg.opt.moment_dtype)
    residual = (compression.init_residual(params) if cfg.grad_compression
                else torch.zeros((), dtype=torch.float32, device=lm.device))
    return params, opt_state, residual
