"""int8 error-feedback gradient compression for the data-parallel
all-reduce (counterpart of ``repro.train.compression``).

Each gradient leaf is quantised to int8 with one float32 scale per
tensor (round half to even, as ``jnp.round``), and the quantisation error
is carried to the next step in a float32 residual (error feedback), which
keeps SGD-family optimizers converging.  The train step compresses and
decompresses the gradient after the data-parallel reduce, as the
reference's compiled step compresses the gradient GSPMD has already
reduced (one scale per whole leaf):

    cgrads, residual = compress(grads, residual)
    grads = decompress(cgrads)

A leaf's scale is that of the reference's leaf: the port's layers of a
stacked block tree share one (:func:`stack_ids`), and on a mesh the
ranks' slices of a split leaf share one, the model group's largest
``|g + r|``, each rank keeping its part of the residual.  The int8
values do not travel in place of the float32 reduce: that would change
the numbers, and the reference does not do it either.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.models import collectives as coll
from . import tree as tr


class CompressedGrads(NamedTuple):
    q: Any  # int8 tree
    scale: Any  # float32 scalar tree


def init_residual(params: Any) -> Any:
    return tr.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def stack_ids(params: Any) -> List[int]:
    """For each leaf of a parameter tree of the port (leaf order), the index
    of the reference's leaf it is part of.  The port holds each layer of a
    stacked block tree (``blocks``, zamba2's ``mamba_seg``, ...) as leaves
    of its own, where the reference stacks the layers into one leaf
    (``bridge.params_to_numpy`` stacks them back): the leaves whose paths
    differ only in their list indices are one."""
    ids: dict = {}
    return [ids.setdefault(tuple(k for k in path if not isinstance(k, int)), len(ids))
            for path, _ in tr.leaves_with_paths(params)]


def _scales(g32s: List[torch.Tensor], stacks: Optional[Sequence[int]], group=None) -> List[torch.Tensor]:
    """Each leaf's float32 scale: the largest ``|g + r|`` of the reference's
    leaf it is part of (``stacks``, from :func:`stack_ids`; each leaf its
    own where None) over 127.  On a mesh the largest is taken over the
    model ``group`` too, in one collective: the ranks' slices of a split
    leaf share its scale, and a leaf the ranks hold whole has the same
    values on each of them."""
    stacks = range(len(g32s)) if stacks is None else stacks
    of: dict = {}
    for i, g in zip(stacks, g32s):
        of.setdefault(i, []).append(g.abs().max())
    top = coll.all_reduce(torch.stack([torch.stack(m).max() for m in of.values()]), group, "max")
    scale = torch.clamp(top, min=1e-12) / 127.0
    at = {i: k for k, i in enumerate(of)}
    return [scale[at[i]] for i in stacks]


def _quantise_(g32: torch.Tensor, r: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 values of ``g32`` (its gradient plus residual, in float32)
    at ``scale``, exact in float32; the new residual ``g32 - q * scale`` is
    written into ``r``."""
    q = torch.clamp(torch.round(g32 / scale), -127, 127)
    r.copy_(g32 - q * scale)
    return q


def compress(grads: Any, residual: Any, stacks: Optional[Sequence[int]] = None,
             group=None) -> Tuple[CompressedGrads, Any]:
    """(int8 values and per-tensor scales, the new residual), the scales
    those of :func:`_scales`."""
    g32s = [g.float() + r for g, r in zip(tr.leaves(grads), tr.leaves(residual))]
    scales = _scales(g32s, stacks, group)
    rs = [torch.empty_like(g) for g in g32s]
    qs = [_quantise_(g, r, s).to(torch.int8) for g, r, s in zip(g32s, rs, scales)]
    unf = lambda xs: tr.unflatten(grads, xs)  # noqa: E731
    return CompressedGrads(unf(qs), unf(scales)), unf(rs)


@torch.no_grad()
def round_trip_(grads: Any, residual: Any, stacks: Optional[Sequence[int]] = None, group=None) -> Any:
    """``decompress`` of :func:`compress`, the new residual written into
    ``residual`` and each float32 gradient leaf overwritten by its round
    trip (a leaf of another dtype gets a new float32 tensor): the train
    step's form, which holds no second copy of the tree.  Returns the
    round-tripped gradient tree."""
    res = tr.leaves(residual)
    g32s = [g.add_(r) if g.dtype == torch.float32 else g.float() + r for g, r in zip(tr.leaves(grads), res)]
    scales = _scales(g32s, stacks, group)
    return tr.unflatten(grads, [torch.mul(_quantise_(g, r, s), s, out=g) for g, r, s in zip(g32s, res, scales)])


def decompress(c: CompressedGrads) -> Any:
    return tr.tree_map(lambda q, s: q.float() * s, c.q, c.scale)


def compressed_bytes(c: CompressedGrads) -> int:
    return sum(q.numel() for q in tr.leaves(c.q)) + 4 * len(tr.leaves(c.scale))
