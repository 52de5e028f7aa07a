"""What one rank of a mesh holds (counterpart of ``repro.models.sharding``'s
``param_pspecs``/``cache_pspecs``, cut to the expert-parallel path).

GSPMD's layouts become the slices a rank keeps:

* **Experts.**  The stacked ``w_gate``/``w_up``/``w_down`` of a MoE layer
  keep rows ``[m * E_loc, (m + 1) * E_loc)`` on model rank ``m`` when the
  model group divides the experts; otherwise every rank holds them all, as
  ``param_pspecs`` replicates an expert axis it cannot divide.
* **Everything else is replicated**: attention, the router, norms,
  embeddings, logits, shared experts and the dense prefix.  GSPMD shards
  those over the model axis as tensor parallelism, a layout that does not
  change the result; the port has no tensor-parallel layers yet.
* **Caches.**  A rank holds its ``B / dp`` rows of the batch and, on the
  sequence-parallel decode path, its ``T / ep`` slice of the positions.

``repro.models.shard_compat`` (a ``shard_map`` shim over JAX versions) has
no counterpart, and neither has ``LM._sp`` (a sharding constraint that
moves no value).
"""

from __future__ import annotations

import hashlib
from typing import Any

from .moe import MeshInfo

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def expert_rows(n_experts: int, mi: MeshInfo) -> slice:
    """The experts model rank ``mi.model_index`` holds."""
    if mi.ep_size <= 1 or n_experts % mi.ep_size:
        return slice(0, n_experts)
    n = n_experts // mi.ep_size
    return slice(mi.model_index * n, (mi.model_index + 1) * n)


def batch_rows(batch: int, mi: MeshInfo) -> slice:
    """The rows of a global batch that data rank ``mi.data_index`` holds."""
    if batch % mi.dp_size:
        raise ValueError(f"a batch of {batch} does not split over {mi.dp_size} data ranks; "
                         "build the MeshInfo with mesh_info_for(mesh, batch)")
    n = batch // mi.dp_size
    return slice(mi.data_index * n, (mi.data_index + 1) * n)


def seq_positions(max_seq: int, mi: MeshInfo) -> slice:
    """The positions of a sequence-parallel cache that model rank
    ``mi.model_index`` holds."""
    if max_seq % mi.ep_size:
        raise ValueError(f"a cache of {max_seq} positions does not split over {mi.ep_size} "
                         "model ranks")
    n = max_seq // mi.ep_size
    return slice(mi.model_index * n, (mi.model_index + 1) * n)


def is_expert_leaf(path) -> bool:
    """A routed expert weight stack: ``.../moe/w_gate`` and the like, not a
    shared expert's."""
    return bool(path) and path[-1] in EXPERT_LEAVES and "moe" in path and "shared" not in path


def rank_cut(tree: Any, mi: MeshInfo, path=()) -> Any:
    """This rank's part of a parameter tree (nested dicts of arrays or
    tensors, scan-stacked or not): expert stacks sliced on their expert
    axis (third from last), every other leaf as it is.  Slicing a numpy
    tree before it is copied to the card keeps the other ranks' experts
    off it."""
    if isinstance(tree, dict):
        return {k: rank_cut(v, mi, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [rank_cut(v, mi, path) for v in tree]
    if is_expert_leaf(path) and tree.ndim >= 3:
        rows = expert_rows(tree.shape[-3], mi)
        return tree[(Ellipsis, rows, slice(None), slice(None))]
    return tree


def leaf_seed(seed: int, *key) -> int:
    """A 63-bit seed for the weights named by ``key`` (a leaf's path, and an
    expert's index), the same in every process: a rank can draw its own
    experts and get the numbers a one-process model draws for them."""
    digest = hashlib.blake2b(repr((seed,) + key).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1
