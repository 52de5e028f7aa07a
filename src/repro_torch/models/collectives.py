"""The collectives the expert-, tensor- and sequence-parallel paths run
over a ``torch.distributed`` process group (the ``psum``/``pmax``/
``all_gather``/``all_to_all`` of the JAX package's ``shard_map`` bodies,
and the reductions and gathers GSPMD inserts around its tensor-parallel
layouts), with their gradients for training on a mesh.

Each takes the group of one mesh axis (``MeshInfo.model_group`` and the
like).  A group of one rank, or none, is the identity, as a collective over
an axis of size one is in JAX.  On the ``gloo`` backend a CUDA tensor is
staged through host memory around the call, which is how gloo moves device
data, and its result (or gradient) comes back on its device; ``nccl``
takes the device tensor itself.  Data movement (the all-gather and the
all-to-all) goes as raw bytes, so any dtype crosses.

Gradients follow one convention: the cotangent of an activation that
every rank of the model group holds whole (a replicated activation) is
whole and identical on each of them.  Three operators keep it:

* a **sum of ranks' partials** (:func:`row_parallel_sum`,
  :func:`all_reduce_sum`) sums forward and passes the cotangent through
  unchanged;
* a **gather** (:func:`all_gather`, :func:`gather_last`) takes the rank's
  own slice of the cotangent, with no reduction (a reduce-scatter would
  count the whole cotangent once a rank);
* the **entry of rank-specific work** (:func:`enter`) is the identity
  forward and sums the cotangent over the group backward: it marks where
  a replicated activation (or leaf) is first read by work that differs by
  rank, a column-parallel projection or the experts a rank holds.

:func:`all_to_all`'s gradient is the reverse exchange.  So each
replicated leaf's gradient comes out whole and equal on every rank of the
group, and no gradient is summed over the model group after the backward
pass.  :func:`all_reduce` (sums and maxima of statistics: metrics, the
sequence-parallel merge, compression scales) carries no gradient.  Every
sum runs in float32 and is rounded once to its input's dtype.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _tracked(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum" or "max") of ``t`` over the ranks of ``group``: a new
    tensor on ``t``'s device, with no gradient."""
    if group_size(group) == 1:
        return t
    return _reduce(t, group, op)


def _reduce(t: torch.Tensor, group, op: str) -> torch.Tensor:
    work = (t.detach().cpu() if _staged(t, group) else t.detach()).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(work, op=_OPS[op], group=group)
    return work.to(t.device)


def _sum32(t: torch.Tensor, group) -> torch.Tensor:
    """The group's float32 sum of ``t``, rounded once to ``t``'s dtype."""
    return all_reduce(t.float(), group).to(t.dtype)


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _sum32(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum32(g, ctx.group), None


def enter(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself; backward, the sum of its cotangent over ``group``.  Put
    where a replicated ``t`` enters rank-specific work, whose cotangents
    are each rank's partial."""
    if group_size(group) == 1 or not _tracked(t):
        return t
    return _Enter.apply(t, group)


def row_parallel_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of each rank's partial ``t`` (the output of a
    row-parallel layer, or a vocab-parallel lookup), added in float32 and
    rounded once to ``t``'s dtype; backward, the cotangent unchanged."""
    if group_size(group) == 1:
        return t
    return _SumPartials.apply(t, group) if _tracked(t) else _sum32(t, group)


def all_reduce_sum(parts, group) -> list:
    """The sums over ``group`` of several tensors in one collective: they
    travel as one float32 vector and come back in their own dtypes, each a
    sum of ranks' partials (:func:`row_parallel_sum`'s gradient).  An
    integer part must hold values below 2**24, where float32 is exact (the
    counts and drops of a MoE layer)."""
    if group_size(group) == 1:
        return list(parts)
    flat = row_parallel_sum(torch.cat([p.reshape(-1).float() for p in parts]), group)
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape).to(p.dtype))
        at += p.numel()
    return out


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    n = group_size(group)
    src = _bytes(t.detach())
    if _staged(t, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts).to(t.device)
    return out.view(t.dtype).reshape((n,) + tuple(t.shape))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.index = dist.get_rank(group)
        return _gather(t, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``(n, *t.shape)``: every rank's ``t`` in the group's rank order;
    backward, this rank's row of the cotangent."""
    if group_size(group) == 1:
        return t[None]
    return _Gather.apply(t, group) if _tracked(t) else _gather(t, group)


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    src = _bytes(t.detach())
    if _staged(t, group):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device).view(t.dtype).reshape(t.shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _exchange(t, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` is ``(n, ...)``: chunk ``j`` goes to the group's rank ``j``;
    row ``i`` of the result is what rank ``i`` sent this rank (JAX's
    ``all_to_all(split_axis=0, concat_axis=0)``).  Backward, the reverse
    exchange: the same call on the cotangent."""
    n = group_size(group)
    if n == 1:
        return t
    if t.shape[0] != n:
        raise ValueError(f"all_to_all needs a leading axis of {n}, got {tuple(t.shape)}")
    return _AllToAll.apply(t, group) if _tracked(t) else _exchange(t, group)


def gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` laid side by side along the last axis in the
    group's rank order: the whole vocabulary from each rank's columns of
    the logits.  Backward, this rank's columns of the cotangent."""
    n = group_size(group)
    if n == 1:
        return t
    parts = all_gather(t, group)  # (n, ..., V / n)
    return parts.movedim(0, -2).reshape(tuple(t.shape[:-1]) + (n * t.shape[-1],))
