"""The train step: loss and gradients under autograd, microbatching, the
data-parallel reduce, optional int8 gradient compression, AdamW
(counterpart of ``repro.train.train_loop``).

    loss, grads = autograd of lm.loss      # per-block remat inside LM
    grads = float32 mean over the data group (GSPMD's data-parallel reduce)
    optional int8 error-feedback compression of the reduced gradient
    params, opt = adamw_update(...)        # in place, clipped by the global norm

Microbatching splits the global batch into ``n_microbatches`` slices and
accumulates their gradients in float32, which equals the full-batch
gradient (the tests hold it so).  The step runs eagerly on the model's
device; the parameters are leaf tensors that require grad
(:func:`init_train_state`).

On a mesh (``LM(mesh_info=...)``) every rank runs the step on the global
batch: microbatch ``i`` is global rows ``[i * mb, (i + 1) * mb)``, of which
``LM.loss`` takes the data rank's ``mb / dp`` (the reference's row order,
so each microbatch's aux loss and capacity drops are the reference's).
Each rank's gradient is that of its rows' loss, whole for the leaves it
holds whole and its slice of the split ones; their float32 mean over the
data group is the global gradient, the same on every data rank.  The clip
and the compression scales take the split leaves over the model group
and a layer stack's leaves together, as the reference's whole leaf.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import collectives as coll
from repro_torch.models.model import LM
from repro_torch.models.sharding import tp_axis
from . import compression
from . import tree as tr
from .optimizer import AdamWConfig, OptState, adamw_update, global_norm, init_opt_state

# float32 elements a data-parallel all-reduce carries at most (128 MiB): a
# bucket of leaves, or one larger leaf alone
_BUCKET = 1 << 25


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
    """(loss, metrics of the last microbatch, grads) of this rank's rows:
    with ``n_micro > 1`` the gradients of the slices of the global batch,
    accumulated in float32, over ``n_micro``."""
    if n_micro <= 1:
        return _loss_and_grads(lm, params, batch)
    B = batch["labels"].shape[0]
    if B % n_micro:
        raise ValueError(f"batch of {B} rows does not split into {n_micro} microbatches")
    mb = B // n_micro
    if mb % lm.mi.dp_size:
        raise ValueError(f"a microbatch of {mb} rows does not split over {lm.mi.dp_size} data ranks")
    acc, loss_sum, metrics = None, 0.0, None
    for i in range(n_micro):
        loss, metrics, grads = _loss_and_grads(lm, params, _microbatch(batch, i, mb, B))
        if acc is None:
            acc = tr.tree_map(lambda g: g.float(), grads)
        else:
            tr.tree_map(lambda a, g: a.add_(g.float()), acc, grads)
        loss_sum = loss_sum + loss
    return loss_sum / n_micro, metrics, tr.tree_map(lambda a: a / n_micro, acc)


def _data_mean(grads, group, n: int):
    """The float32 mean of the gradient tree over the data ``group`` of
    ``n`` ranks, leaves packed into buckets of at most ``_BUCKET``
    elements, one all-reduce each."""
    leaves = tr.leaves(grads)
    out, i = [], 0
    while i < len(leaves):
        j, size = i + 1, leaves[i].numel()
        while j < len(leaves) and size + leaves[j].numel() <= _BUCKET:
            size += leaves[j].numel()
            j += 1
        flat = coll.all_reduce(torch.cat([g.reshape(-1).float() for g in leaves[i:j]]), group).div_(n)
        at = 0
        for g in leaves[i:j]:
            out.append(flat[at:at + g.numel()].view(g.shape))
            at += g.numel()
        i = j
    return tr.unflatten(grads, out)


def _over_data(mi, loss, metrics, grads):
    """The data ranks' (loss, metrics, gradients) reduced to the global
    ones: the gradients' float32 mean (the reference's data-parallel
    reduce), the loss's and ``ce``'s mean."""
    if mi.dp_size == 1:
        return loss, metrics, grads
    loss, ce = (coll.all_reduce(t.detach().float(), mi.data_group) / mi.dp_size for t in (loss, metrics["ce"]))
    return loss, dict(metrics, ce=ce), _data_mean(grads, mi.data_group, mi.dp_size)


def loss_and_grads(lm: LM, params, batch: Dict[str, Any], n_microbatches: int = 1):
    """(loss, metrics, gradient tree) of the global batch, on a mesh the
    global values, the same on every data rank."""
    return _over_data(lm.mi, *_microbatched_grads(lm, params, batch, n_microbatches))


def split_leaves(lm: LM) -> Optional[list]:
    """On a mesh whose model group has more than one rank, whether this
    rank holds a slice of each parameter leaf (leaf order), else None:
    what the clip reads."""
    m = lm.mi.ep_size
    if m == 1:
        return None
    return [tp_axis(path, w.shape, lm.arch, m) is not None for path, w in tr.leaves_with_paths(lm.shapes())]


def make_train_step(lm: LM, cfg: TrainConfig,
                    mark: Optional[Callable[[str], None]] = None) -> Callable[..., Tuple]:
    """``train_step(params, opt_state, batch, residual) -> (params,
    opt_state, residual, metrics)``, the metrics those of the reference
    (``loss``, ``ce``, ``moe_aux``, ``dropped``, ``grad_norm``, ``lr``) as
    tensors on the model's device, on a mesh the global values on every
    rank.  The parameter, moment and residual tensors are updated in
    place.  ``mark``, where given, is called with each phase's name as the
    phase ends (``loss_and_grads``, ``data_parallel_reduce``,
    ``clip_and_compression``, ``adamw``), for a caller that times them."""
    mi = lm.mi
    split = split_leaves(lm)
    stacks = compression.stack_ids(lm.shapes())
    mark = mark or (lambda phase: None)

    def train_step(params, opt_state: OptState, batch, residual):
        loss, metrics, grads = _microbatched_grads(lm, params, batch, cfg.n_microbatches)
        mark("loss_and_grads")
        loss, metrics, grads = _over_data(mi, loss, metrics, grads)
        mark("data_parallel_reduce")
        if cfg.grad_compression:
            # the reduced gradient, quantised with one scale per whole leaf
            # of the reference's (a layer stack, over the model group); the
            # residual carries the quantisation error to the next step
            grads = compression.round_trip_(grads, residual, stacks, mi.model_group)
        gn = global_norm(grads, split, mi.model_group)
        mark("clip_and_compression")
        params, opt_state, opt_metrics = adamw_update(cfg.opt, params, grads, opt_state, grad_norm=gn)
        mark("adamw")
        aux = metrics["aux"]
        out = {"loss": loss, "ce": metrics["ce"].detach(), "moe_aux": aux.moe_aux.detach(),
               "dropped": aux.dropped, **opt_metrics}
        return params, opt_state, residual, out

    return train_step


def init_train_state(lm: LM, seed: int, cfg: TrainConfig):
    """``(params, opt_state, residual)``: ``lm.init(seed)`` with every
    leaf made a tensor that requires grad, zeroed moments of
    ``cfg.opt.moment_dtype``, and the compression residual (a float32
    zero scalar without compression).  On a mesh each is this rank's
    part."""
    params = tr.tree_map(lambda p: p.requires_grad_(True), lm.init(seed))
    opt_state = init_opt_state(params, cfg.opt.moment_dtype)
    residual = (compression.init_residual(params) if cfg.grad_compression
                else torch.zeros((), dtype=torch.float32, device=lm.device))
    return params, opt_state, residual
