"""Weight bridge: the JAX ``LM.init`` pytree, as numpy, to the port's
parameters, so both packages can compute from the same weights.

The caller turns each JAX leaf into numpy first (``np.asarray``); this
module imports neither JAX nor ``repro``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.moe import LOCAL_MESH, MeshInfo
from repro_torch.models.sharding import rank_cut

# leaves the reference keeps in float32 whatever the model dtype: norm
# scales/biases, the router (repro/models/moe.py:75) and MLA's latent norm
# scales (repro/models/attention.py:61, 66)
_FLOAT32_LEAVES = ("scale", "bias", "w_router", "q_norm_scale", "kv_norm_scale")
# the scan-stacked block trees (leading layer axis), unstacked into lists
_STACKED = ("blocks", "prefix_blocks")


def _leaf(name: str, a, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.float32)))
    return t.to(device=device, dtype=torch.float32 if name in _FLOAT32_LEAVES else dtype)


def _convert(tree, device, dtype, name: str = ""):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    return _leaf(name, tree, device, dtype)


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def params_from_numpy(tree: Dict[str, Any], device, dtype: torch.dtype,
                      mesh_info: MeshInfo = LOCAL_MESH) -> Dict[str, Any]:
    """Convert a JAX ``LM.init`` tree (leaves as numpy arrays) into the
    port's parameter dict.  The scan-stacked ``tree["blocks"]`` and, with
    a dense prefix, ``tree["prefix_blocks"]`` (leading layer axis,
    ``repro/models/model.py:124-135``) become lists of per-layer dicts; the
    router and the norm scales stay float32, other floating leaves take
    ``dtype``.  ``device`` is resolved as every entry point resolves it:
    ``"cuda"`` without a GPU raises.

    With ``mesh_info`` the result is that rank's parameters
    (``sharding.rank_cut``: its experts, every other leaf whole), cut on
    the host before anything is copied to ``device``."""
    device = resolve_device(device)
    tree = rank_cut(tree, mesh_info)
    out = {k: _convert(v, device, dtype, k) for k, v in tree.items() if k not in _STACKED}
    for key in _STACKED:
        if key in tree:
            blocks = tree[key]
            n_layers = len(np.asarray(blocks["norm1"]["scale"]))
            out[key] = [_convert(_unstack(blocks, i), device, dtype) for i in range(n_layers)]
    return out
