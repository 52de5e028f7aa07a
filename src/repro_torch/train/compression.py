"""int8 error-feedback gradient compression for the data-parallel
all-reduce (counterpart of ``repro.train.compression``).

Each gradient leaf is quantised to int8 with one float32 scale per
tensor (round half to even, as ``jnp.round``), and the quantisation error
is carried to the next step in a float32 residual (error feedback), which
keeps SGD-family optimizers converging.  On one process the train step
compresses and decompresses in place of the all-reduce, as the
reference's does on one device:

    cgrads, residual = compress(grads, residual)
    grads = decompress(cgrads)
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from . import tree as tr


class CompressedGrads(NamedTuple):
    q: Any  # int8 tree
    scale: Any  # float32 scalar tree


def init_residual(params: Any) -> Any:
    return tr.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _one(g: torch.Tensor, r: torch.Tensor):
    g = g.float() + r
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale, g - q.float() * scale


def compress(grads: Any, residual: Any) -> Tuple[CompressedGrads, Any]:
    """(int8 values and per-tensor scales, the new residual)."""
    qs, scales, rs = zip(*(_one(g, r) for g, r in zip(tr.leaves(grads), tr.leaves(residual))))
    unf = lambda xs: tr.unflatten(grads, list(xs))  # noqa: E731
    return CompressedGrads(unf(qs), unf(scales)), unf(rs)


def decompress(c: CompressedGrads) -> Any:
    return tr.tree_map(lambda q, s: q.float() * s, c.q, c.scale)


def compressed_bytes(c: CompressedGrads) -> int:
    return sum(q.numel() for q in tr.leaves(c.q)) + 4 * len(tr.leaves(c.scale))
