"""Weight bridge: the JAX ``LM.init`` pytree, as numpy, to the port's
parameters, so both packages can compute from the same weights, and back
(:func:`params_to_numpy`), so trees of the port (parameters, gradients,
optimizer moments) can be compared with the reference's leaf for leaf.

The caller turns each JAX leaf into numpy first (``np.asarray``); this
module imports neither JAX nor ``repro``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.moe import LOCAL_MESH, MeshInfo
from repro_torch.models.sharding import rank_cut
from repro_torch.models.ssm import FLOAT32_LEAVES as _SSM_FLOAT32_LEAVES

# leaves the reference keeps in float32 whatever the model dtype: norm
# scales/biases, the router (repro/models/moe.py:75), MLA's latent norm
# scales (repro/models/attention.py:61, 66) and the Mamba2 and RWKV6
# leaves of repro/models/ssm.py:36-53, 265-293
_FLOAT32_LEAVES = ("scale", "bias", "w_router", "q_norm_scale", "kv_norm_scale") + _SSM_FLOAT32_LEAVES
# the scan-stacked block trees (leading layer axis), unstacked into lists
_STACKED = ("blocks", "prefix_blocks", "mamba_tail", "enc_blocks")
# zamba2's doubly stacked segments (segment axis, then block axis)
_STACKED_TWICE = ("mamba_seg",)


def _leaf(name: str, a, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.float32)))
    return t.to(device=device, dtype=torch.float32 if name in _FLOAT32_LEAVES else dtype)


def _convert(tree, device, dtype, name: str = ""):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_convert(v, device, dtype, name) for v in tree]
    return _leaf(name, tree, device, dtype)


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def _n_stacked(tree) -> int:
    """The length of the leading axis that every leaf of ``tree`` shares."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return len(np.asarray(tree))


def _as_lists(tree, depth: int):
    """A tree stacked ``depth`` times, as nested lists of per-block trees."""
    if depth == 0:
        return tree
    return [_as_lists(_unstack(tree, i), depth - 1) for i in range(_n_stacked(tree))]


def params_from_numpy(tree: Dict[str, Any], device, dtype: torch.dtype,
                      mesh_info: MeshInfo = LOCAL_MESH,
                      arch: Optional[ArchConfig] = None) -> Dict[str, Any]:
    """Convert a JAX ``LM.init`` tree (leaves as numpy arrays) into the
    port's parameter dict.  The scan-stacked block trees (leading layer
    axis, ``repro/models/model.py:124-165``: ``blocks``, a dense prefix's
    ``prefix_blocks``, zamba2's ``mamba_tail``, whisper's ``enc_blocks``)
    become lists of per-layer dicts, and zamba2's ``mamba_seg``, stacked
    over segments and then blocks, a list of lists; zamba2's
    ``shared_attn`` stays one dict.  The leaves the reference keeps in
    float32 (``_FLOAT32_LEAVES``) stay float32, other floating leaves take
    ``dtype``.  ``device`` is resolved as every entry point resolves it:
    ``"cuda"`` without a GPU raises.

    With ``mesh_info`` the result is that rank's parameters
    (``sharding.rank_cut``: its experts, and its slices of the attention
    heads, the dense and shared-expert FFNs, the Mamba2 and RWKV6 heads and
    the vocabulary where the model group divides them), cut on the host
    before anything is copied to ``device``.  On a mesh a tree with any of those layers needs
    ``arch``, which decides each layer's split (``sharding.tp_splits``)."""
    device = resolve_device(device)
    tree = rank_cut(tree, mesh_info, arch)
    depth = {**dict.fromkeys(_STACKED, 1), **dict.fromkeys(_STACKED_TWICE, 2)}
    return {k: _convert(_as_lists(v, depth.get(k, 0)), device, dtype, k) for k, v in tree.items()}


def _restack(tree, depth: int):
    """Inverse of ``_as_lists``: nested lists of per-block trees, stacked
    ``depth`` times along new leading axes."""
    if depth == 0:
        return tree
    blocks = [_restack(b, depth - 1) for b in tree]
    if isinstance(blocks[0], dict):
        return {k: _restack([b[k] for b in blocks], 1) for k in blocks[0]}
    return np.stack(blocks)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """A tree of the port's parameter layout (parameters, or gradients or
    optimizer moments of them) as the JAX ``LM.init`` tree of numpy
    arrays: the block lists stacked back along a leading layer axis,
    zamba2's ``mamba_seg`` along a segment and a block axis.  bfloat16
    leaves, which numpy cannot hold, come back as float32 (exactly)."""
    depth = {**dict.fromkeys(_STACKED, 1), **dict.fromkeys(_STACKED_TWICE, 2)}
    return {k: _restack(_to_numpy(v), depth.get(k, 0)) for k, v in params.items()}
