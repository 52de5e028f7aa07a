"""What one rank of a mesh holds (counterpart of ``repro.models.sharding``'s
``param_pspecs``/``cache_pspecs``).

GSPMD's layouts over the ``"model"`` axis become the slices a rank keeps.
With m ranks in the model group, model rank r holds, wherever m divides
the dimension (:func:`tp_splits` decides it layer by layer from the arch,
and both :func:`tp_axis`, which cuts the leaves, and :func:`tp_group`,
which gives a layer the group it sums over, ask it):

* **Routed experts** (expert parallelism): rows ``[r * E / m, ...)`` of
  the stacked ``w_gate``/``w_up``/``w_down``.
* **Attention** (tensor parallelism): GQA's ``wq``, ``wk``, ``wv`` and
  their biases by output columns, heads ``[r * H / m, ...)`` and kv heads
  ``[r * Kv / m, ...)``, and ``wo`` by the same heads' rows; MLA's
  ``w_uq``, ``w_uk``, ``w_uv`` by heads and ``wo`` by their rows, the
  low-rank down projections ``w_dq``, ``w_dkv``, ``w_kr`` and the norms
  whole, as ``param_pspecs`` keeps them.  Zamba2's shared block and
  whisper's encoder and decoder self-attention are GQA.
* **Cross-attention** (whisper, ``xattn``): ``wq``, ``wk``, ``wv`` by the
  columns of heads ``[r * H / m, ...)`` (its K/V have H heads), ``wo`` by
  their rows.
* **Dense FFN and shared experts**: ``w_gate``/``w_up`` by columns
  ``[r * F / m, ...)``, ``w_down`` by the same rows.
* **Mamba2** (``mamba``): heads ``[r * H / m, ...)``; ``w_out`` by the
  heads' rows of ``d_inner``.
* **RWKV6 time mix** (``rwkv``): ``w_r``, ``w_k``, ``w_v``, ``w_g`` by the
  columns of heads ``[r * H / m, ...)``, ``u`` by those heads, ``w_o`` by
  their rows; **channel mix** (``cmix``): ``w_ck`` by columns ``[r * F /
  m, ...)``, ``w_cv`` by the same rows.
* **Embedding and logits** (vocab parallelism): rows ``[r * V / m, ...)``
  of the padded ``embed`` table, columns of ``w_out``.
* The router, the norms, whisper's ``dec_pos``, RWKV6's token-shift mixes
  and every other leaf whole.

A row-parallel layer's rank computes the one-process function on its
slices (``n_heads / m`` heads, ``d_ff / m`` columns) and the partial
outputs are summed over the model group in float32, rounded once
(``collectives.row_parallel_sum``).  After every such sum each model rank
holds the whole residual stream, which is what the expert-parallel bodies
take.  A vocab-parallel lookup sums masked local rows; the logits are
gathered to the whole vocabulary before the padding mask.  Mamba2's gated
RMSNorm normalises over the whole ``d_inner``: a rank sums its squares
over the group before it scales (``ssm._gated_out``).

Where the port's layout is its own (none of these changes a value, only
what a rank holds):

* **Attention is split by whole heads only, where m divides both H and
  Kv.**  Otherwise it stays whole on every rank and decode runs
  sequence-parallel over the cache (qwen3's 4 kv heads on 8 ranks; the
  hybrid and audio families keep such attention whole and replicated);
  ``param_pspecs`` then splits ``wk``/``wv`` by columns mid-head and GSPMD
  regathers, which an explicit layout cannot follow.
* **MLA's latent cache** ``(c_kv, k_rope)`` stays whole on each model rank
  for its batch rows: each rank's heads need all of it.  ``cache_pspecs``
  splits its sequence and GSPMD gathers it for the absorbed attention.
* **Mamba2's fused ``w_in``** (columns ``[z, x, B, C, dt]``): a rank holds
  its heads' ``z``, ``x`` and ``dt`` columns and ``B``/``C`` whole (one
  group), where ``param_pspecs`` cuts the fused columns evenly across
  their parts; ``conv_w``/``conv_b`` (channels ``[x, B, C]``) and the conv
  state likewise, its heads' ``x`` channels and ``B``/``C`` whole;
  ``A_log``, ``D``, ``dt_bias`` by head and ``norm_scale`` by its heads'
  channels, all of which ``param_pspecs`` keeps whole.  The SSM state goes
  by head, as ``cache_pspecs`` has it.
* **RWKV6's decay LoRA**: ``wA`` whole and ``wB`` by the columns of the
  rank's heads (``w0`` and ``ln_x_scale`` by them too), so the decay comes
  out per head with no sum; ``param_pspecs`` splits ``wA`` by columns and
  ``wB`` by rows and GSPMD sums the LoRA's partials over the whole width.
* **RWKV6's ``w_cr``** stays whole: its sigmoid gates the whole-width sum
  of the row-parallel ``w_cv``, so a rank computes the whole gate rather
  than gather it; ``param_pspecs`` splits it by columns.
* **A dimension m does not divide** leaves the leaf whole, as
  ``param_pspecs`` replicates it.

Caches: a rank holds its ``B / dp`` rows of the batch and, of a GQA cache,
``Kv / m`` kv heads where attention is split by heads
(``cache_pspecs``' head rule), or its ``T / m`` slice of the positions on
the sequence-parallel path; whisper's cross K/V its heads; Mamba2's and
RWKV6's states their heads (the token-shift states whole).
``repro.models.shard_compat`` (a ``shard_map`` shim over JAX versions) has
no counterpart, and neither has ``LM._sp`` (Megatron-SP, a sharding
constraint that moves no value).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import TYPE_CHECKING, Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, AttnConfig

if TYPE_CHECKING:  # moe.py imports this module
    from .moe import MeshInfo

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
# attention leaves split by output columns (heads), and by rows
_ATTN_COLUMNS = ("wq", "wk", "wv", "bq", "bk", "bv", "w_uq", "w_uk", "w_uv")
_ATTN_ROWS = ("wo",)


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


def heads_split(cfg: AttnConfig, m: int) -> bool:
    """Whether attention is split by heads over a model group of ``m``:
    whole heads only, and for GQA whole kv heads too."""
    if m <= 1 or cfg.kind not in ("gqa", "mla") or cfg.n_heads % m:
        return False
    return cfg.kind == "mla" or cfg.n_kv_heads % m == 0


def rank_attn(cfg: AttnConfig, mi: MeshInfo) -> AttnConfig:
    """The attention config of this rank's heads: ``n_heads / m`` and
    ``n_kv_heads / m`` where attention is split by heads, else ``cfg``."""
    m = mi.ep_size
    if not heads_split(cfg, m):
        return cfg
    kv = cfg.n_kv_heads // m if cfg.kind == "gqa" else cfg.n_kv_heads
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // m, n_kv_heads=kv)


def padded_vocab(arch: ArchConfig) -> int:
    """The embedding's rows and ``w_out``'s columns: the vocabulary padded
    to a multiple of 128."""
    return -(-arch.vocab_size // 128) * 128


TP_LAYERS = ("attn", "xattn", "mlp", "shared", "vocab", "mamba", "rwkv", "cmix")


def ssm_heads(arch: ArchConfig) -> int:
    """The heads of a Mamba2 block (``expand * d_model / head_dim``) or of
    an RWKV6 time mix (``d_model / head_dim``); 0 without SSM blocks."""
    cfg = arch.ssm
    if cfg is None:
        return 0
    width = cfg.expand * arch.d_model if cfg.kind == "mamba2" else arch.d_model
    return width // cfg.head_dim


def tp_splits(layer: str, arch: ArchConfig, m: int) -> bool:
    """Whether a model group of ``m`` splits ``layer`` of ``arch``: attention
    by heads (:func:`heads_split`), whisper's cross-attention by its heads,
    the dense FFN by ``d_ff`` columns, the shared experts by ``n_shared *
    d_expert`` columns, the vocabulary by padded rows, Mamba2 (one group)
    and the RWKV6 time mix by their heads, the RWKV6 channel mix by ``d_ff``
    columns, each where m divides it.  The one decision behind a rank's
    slices and its layers' sums."""
    if layer not in TP_LAYERS:
        raise ValueError(f"no tensor-parallel layer {layer!r}; one of {TP_LAYERS}")
    if m <= 1:
        return False
    if layer == "attn":
        return heads_split(arch.attn, m)
    if layer == "xattn":
        return arch.encdec and arch.attn.n_heads % m == 0
    if layer in ("mamba", "rwkv", "cmix"):
        kind = "mamba2" if layer == "mamba" else "rwkv6"
        if arch.ssm is None or arch.ssm.kind != kind or (layer == "mamba" and arch.ssm.n_groups != 1):
            return False
        return (arch.d_ff if layer == "cmix" else ssm_heads(arch)) % m == 0
    if layer == "shared":
        if arch.moe is None or not arch.moe.n_shared:
            return False
        width = arch.moe.n_shared * arch.moe.d_expert
    else:
        width = arch.d_ff if layer == "mlp" else padded_vocab(arch)
    return width % m == 0


def tp_group(layer: str, arch: ArchConfig, mi: MeshInfo):
    """The model group that ``layer``'s partials are summed or gathered over
    where :func:`tp_splits` splits it, else None (the one-process layer)."""
    return mi.model_group if tp_splits(layer, arch, mi.ep_size) else None


def rank_heads(layer: str, n: int, arch: ArchConfig, mi: MeshInfo) -> int:
    """This rank's share of ``n`` heads of ``layer``: ``n / m`` where the
    model group splits the layer, else ``n``."""
    return n // mi.ep_size if tp_splits(layer, arch, mi.ep_size) else n


# Mamba2 leaves cut along their last axis (the fused ones by
# :func:`tp_segments`), RWKV6 leaves by columns and by rows
_MAMBA_COLUMNS = ("w_in", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_scale")
_RWKV_COLUMNS = ("w_r", "w_k", "w_v", "w_g", "wB", "w0", "ln_x_scale")
_RWKV_ROWS = ("w_o", "u")


def _tp_leaf(keys: list):
    """The tensor-parallel layer of a leaf (its path's keys) and the axis a
    rank slices, counted from the end; None for a leaf no layer splits."""
    name = keys[-1]
    if keys == ["embed"]:
        return "vocab", -2
    if keys == ["w_out"]:
        return "vocab", -1
    if "mamba" in keys:
        return ("mamba", -1) if name in _MAMBA_COLUMNS else ("mamba", -2) if name == "w_out" else None
    if "rwkv" in keys:
        if name in ("w_ck", "w_cv"):
            return "cmix", -1 if name == "w_ck" else -2
        return ("rwkv", -1) if name in _RWKV_COLUMNS else ("rwkv", -2) if name in _RWKV_ROWS else None
    layer = ("shared" if "moe" in keys and "shared" in keys else "mlp" if "mlp" in keys
             else "xattn" if "xattn" in keys else "attn" if "attn" in keys else None)
    if layer in ("attn", "xattn"):
        return (layer, -1) if name in _ATTN_COLUMNS else (layer, -2) if name in _ATTN_ROWS else None
    if layer is not None and name in EXPERT_LEAVES:
        return layer, -2 if name == "w_down" else -1
    return None


def tp_segments(keys, arch: ArchConfig):
    """The parts of a fused leaf's split axis as ``(length, split)`` pairs,
    in order: Mamba2's ``w_in`` columns ``[z, x, B, C, dt]`` and its conv
    channels ``[x, B, C]``, where a rank holds its share of each split part
    and the unsplit ``B``/``C`` whole.  None for any other leaf (the axis
    splits evenly)."""
    if "mamba" not in keys or keys[-1] not in ("w_in", "conv_w", "conv_b"):
        return None
    H = ssm_heads(arch)
    d_inner, BC = H * arch.ssm.head_dim, 2 * arch.ssm.n_groups * arch.ssm.d_state
    if keys[-1] == "w_in":
        return (d_inner, True), (d_inner, True), (BC, False), (H, True)
    return (d_inner, True), (BC, False)


def tp_axis(path, shape, arch: Optional[ArchConfig], m: int) -> Optional[int]:
    """The axis (counted from the end) along which a rank of a model group
    of ``m`` holds a slice of the leaf at ``path`` (its keys; list indices
    and leading stacked dims are ignored), or None for a leaf it holds
    whole: ``param_pspecs``' rule cut to the layouts of the module
    docstring (a fused leaf's slice is made of its parts', as
    :func:`tp_segments` lays them out).  Routed expert stacks split by
    their own count (as :func:`expert_rows`); every other leaf as
    :func:`tp_splits` decides for its layer, so a tree with such leaves
    needs ``arch``."""
    if m <= 1 or not path:
        return None
    keys = [k for k in path if isinstance(k, str)]
    if is_expert_leaf(keys):
        return -3 if len(shape) >= 3 and shape[-3] % m == 0 else None
    leaf = _tp_leaf(keys) if keys else None
    if leaf is None:
        return None
    layer, axis = leaf
    if arch is None:
        raise ValueError(f"the split of leaf {'/'.join(keys)} depends on the {layer} layer's "
                         "dimensions: pass the arch")
    if not tp_splits(layer, arch, m):
        return None
    segments = tp_segments(keys, arch)
    widths = [n for n, split in segments if split] if segments else [shape[axis]]
    if segments and sum(n for n, _ in segments) != shape[axis] or any(n % m for n in widths):
        raise ValueError(f"leaf {'/'.join(keys)} of shape {tuple(shape)} does not split over {m} "
                         f"ranks, which the arch splits its {layer} layer over")
    return axis


def rank_slice(a, axis: int, mi: MeshInfo):
    """Model rank ``mi.model_index``'s slice of ``a`` (numpy or torch) along
    ``axis``: a view."""
    n = a.shape[axis] // mi.ep_size
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(mi.model_index * n, (mi.model_index + 1) * n)
    return a[tuple(idx)]


def rank_part(a, path, arch: Optional[ArchConfig], mi: MeshInfo):
    """This rank's part of the leaf ``a`` (numpy or torch) at ``path``: ``a``
    itself where :func:`tp_axis` keeps it whole, else the rank's slice (a
    view), or for a fused leaf the rank's slice of each split part beside
    the whole unsplit parts, joined along the axis (a copy)."""
    axis = tp_axis(path, a.shape, arch, mi.ep_size)
    if axis is None:
        return a
    segments = tp_segments([k for k in path if isinstance(k, str)], arch)
    if segments is None:
        return rank_slice(a, axis, mi)
    parts, at = [], 0
    for n, split in segments:
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(at, at + n)
        part = a[tuple(idx)]
        parts.append(rank_slice(part, axis, mi) if split else part)
        at += n
    return torch.cat(parts, dim=axis) if isinstance(a, torch.Tensor) else np.concatenate(parts, axis=axis)


def rank_join(parts, path, shape, arch: Optional[ArchConfig], m: int):
    """The whole leaf of shape ``shape`` at ``path`` from the parts
    :func:`rank_part` gives the ``m`` ranks of a model group, in the
    group's rank order (numpy or torch): the inverse of :func:`rank_part`.
    A leaf held whole is the first rank's part; a fused leaf joins each
    split part's slices and takes the unsplit parts from the first rank."""
    axis = tp_axis(path, shape, arch, m)
    if axis is None:
        return parts[0]
    cat = torch.cat if isinstance(parts[0], torch.Tensor) else np.concatenate
    segments = tp_segments([k for k in path if isinstance(k, str)], arch)
    if segments is None:
        return cat(list(parts), axis)
    pieces, at = [], 0
    for n, split in segments:
        width = n // m if split else n
        idx = [slice(None)] * len(shape)
        idx[axis] = slice(at, at + width)
        pieces.extend([part[tuple(idx)] for part in parts] if split else [parts[0][tuple(idx)]])
        at += width
    return cat(pieces, axis)


def rank_cut(tree: Any, mi: MeshInfo, arch: Optional[ArchConfig] = None, path=()) -> Any:
    """This rank's part of a parameter tree (nested dicts of arrays or
    tensors, scan-stacked or not): each leaf as :func:`rank_part` cuts it,
    every other leaf as it is.  Slicing a numpy tree before it is copied to
    the card keeps the other ranks' slices off it.  ``arch`` is needed for a
    tree with leaves of a tensor-parallel layer."""
    if isinstance(tree, dict):
        return {k: rank_cut(v, mi, arch, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [rank_cut(v, mi, arch, path) for v in tree]
    return rank_part(tree, path, arch, mi)


def leaf_seed(seed: int, *key) -> int:
    """A 63-bit seed for the weights named by ``key`` (a leaf's path, and an
    expert's index), the same in every process: a rank can draw its own
    experts and get the numbers a one-process model draws for them."""
    digest = hashlib.blake2b(repr((seed,) + key).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1
