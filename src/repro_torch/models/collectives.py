"""The collectives the expert-, tensor- and sequence-parallel paths run
over a ``torch.distributed`` process group (the ``psum``/``pmax``/
``all_gather``/``all_to_all`` of the JAX package's ``shard_map`` bodies,
and the reductions and gathers GSPMD inserts around its tensor-parallel
layouts).

Each takes the group of one mesh axis (``MeshInfo.model_group`` and the
like).  A group of one rank, or none, is the identity, as a collective over
an axis of size one is in JAX.  On the ``gloo`` backend a CUDA tensor is
staged through host memory around the call, which is how gloo moves device
data; ``nccl`` takes the device tensor itself.  Data movement (the
all-gather and the all-to-all) goes as raw bytes, so any dtype crosses.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum" or "max") of ``t`` over the ranks of ``group``: a new
    tensor on ``t``'s device."""
    if group_size(group) == 1:
        return t
    work = t.detach().cpu().clone() if _staged(t, group) else t.detach().clone()
    dist.all_reduce(work, op=_OPS[op], group=group)
    return work.to(t.device)


def all_reduce_sum(parts, group) -> list:
    """The sums over ``group`` of several tensors in one collective: they
    travel as one float32 vector and come back in their own dtypes.  An
    integer part must hold values below 2**24, where float32 is exact (the
    counts and drops of a MoE layer)."""
    if group_size(group) == 1:
        return list(parts)
    flat = all_reduce(torch.cat([p.reshape(-1).float() for p in parts]), group)
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape).to(p.dtype))
        at += p.numel()
    return out


def row_parallel_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of each rank's partial ``t`` (the output of a
    row-parallel layer, or a vocab-parallel lookup), added in float32 and
    rounded once to ``t``'s dtype."""
    if group_size(group) == 1:
        return t
    return all_reduce(t.float(), group).to(t.dtype)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``(n, *t.shape)``: every rank's ``t`` in the group's rank order."""
    n = group_size(group)
    if n == 1:
        return t[None]
    src = _bytes(t)
    if _staged(t, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts).to(t.device)
    return out.view(t.dtype).reshape((n,) + tuple(t.shape))


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` is ``(n, ...)``: chunk ``j`` goes to the group's rank ``j``;
    row ``i`` of the result is what rank ``i`` sent this rank (JAX's
    ``all_to_all(split_axis=0, concat_axis=0)``)."""
    n = group_size(group)
    if n == 1:
        return t
    if t.shape[0] != n:
        raise ValueError(f"all_to_all needs a leading axis of {n}, got {tuple(t.shape)}")
    src = _bytes(t)
    if _staged(t, group):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device).view(t.dtype).reshape(t.shape)


def gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` laid side by side along the last axis in the
    group's rank order: the whole vocabulary from each rank's columns of
    the logits."""
    n = group_size(group)
    if n == 1:
        return t
    parts = all_gather(t, group)  # (n, ..., V / n)
    return parts.movedim(0, -2).reshape(tuple(t.shape[:-1]) + (n * t.shape[-1],))
