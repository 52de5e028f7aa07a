"""LM facade: init / forward / loss / prefill / decode (counterpart of
``repro.models.model.LM``) for six families:

  * decoder-only attention (``moe``, ``dense``, ``vlm``): GQA, or
    DeepSeek-V2's MLA with its compressed ``(c_kv, k_rope)`` cache; the
    VLM's vision frontend is a stub (precomputed patch embeddings,
    :meth:`LM.stub_inputs`) and its attention rotates by M-RoPE; a MoE
    model's leading ``first_k_dense`` blocks are dense
    (``p["prefix_blocks"]``, cache ``"prefix"``), walked before the MoE
    blocks;
  * ``hybrid`` (zamba2): segments of [one shared attention+MLP block +
    (attn_every - 1) Mamba2 blocks], then a Mamba2 tail;
  * ``ssm`` (rwkv6): RWKV6 blocks;
  * ``audio`` (whisper): an encoder over stub frame embeddings, and a
    decoder with cross-attention to it.

Parameters are a dict like the JAX pytree, except that the scan-stacked
block trees become lists of per-layer dicts (zamba2's doubly stacked
``mamba_seg`` a list of segments, each a list of blocks) and each
``lax.scan`` over layers a Python loop.  Caches keep the reference's
stacked layout (a leading layer axis; zamba2's Mamba states a segment and
a block axis) and are updated in place.

On a mesh (``LM(mesh_info=...)``, from :mod:`repro_torch.launch.mesh`)
every rank runs the same entry points on the global batch, as the JAX
ones run under ``shard_map`` and GSPMD: a rank computes its rows of the
batch, holds its experts and, tensor-parallel, its slices of the
attention heads, the dense and shared-expert FFNs, the Mamba2 and RWKV6
heads, whisper's cross-attention and the vocabulary
(:mod:`repro_torch.models.sharding`), and its rows of the cache (its kv
heads where the heads are split; when a decoder-only family's kv heads do
not divide the model group, its slice of the positions:
sequence-parallel decode; its heads of the SSM states and of whisper's
cross K/V), and returns the global logits and step counts.

Training (:meth:`LM.forward`, :meth:`LM.loss`) runs every family under
autograd, on one process or on a mesh, where a rank computes the loss of
its rows of the global batch and the collectives carry the gradient
(:mod:`repro_torch.models.collectives`: each replicated leaf's gradient
comes out whole on every rank of its model group, each split leaf's as
the rank's slice); ``remat=True`` recomputes each block in the
backward pass (``torch.utils.checkpoint``, where the reference wraps its
scan bodies in ``jax.checkpoint``).  The hybrid, ssm and audio families
share one walk of their blocks between prefill and training (its
``collect_cache`` switch), and decode through the same walk with the
states written back in place.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from . import collectives as coll
from . import transformer as tf
from . import ssm
from .attention import project_cross_kv
from .layers import apply_norm, embed, init_norm, lm_logits, sinusoidal_positions
from .moe import LOCAL_MESH, MeshInfo, expert_parallel
from .sharding import (batch_rows, expert_rows, is_expert_leaf, leaf_seed, padded_vocab, rank_attn,
                       rank_heads, rank_part, seq_positions, ssm_heads, tp_group, tp_splits)
from .ssm import Mamba2State, RWKV6State
from .transformer import BlockAux


class StepAux(NamedTuple):
    """Per-step diagnostics (MoE aux loss, Sieve counts, drops)."""

    moe_aux: torch.Tensor  # scalar
    counts: torch.Tensor  # (n_blocks, E) token counts per MoE layer (Sieve input)
    dropped: torch.Tensor  # scalar


def _aggregate_aux(prefix_auxes: List[BlockAux], auxes: List[BlockAux]) -> StepAux:
    """Counts of the main blocks only; the dense prefix adds its aux loss
    and drops (both zero), as ``repro.models.model._aggregate_aux`` does."""
    every = prefix_auxes + auxes
    return StepAux(
        torch.stack([a.moe_aux for a in every]).sum(),
        torch.stack([a.counts for a in auxes]),
        torch.stack([a.dropped for a in every]).sum(),
    )


def _empty_aux(device) -> StepAux:
    """The StepAux of a model with no MoE layer."""
    return StepAux(torch.zeros((), dtype=torch.float32, device=device),
                   torch.zeros((0, 1), dtype=torch.int32, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def _zamba_layout(arch: ArchConfig) -> Tuple[int, int, int]:
    """(n_segments, mambas_per_segment, tail_mambas)."""
    per = arch.attn_every - 1
    nseg = arch.n_layers // arch.attn_every
    return nseg, per, arch.n_layers - nseg * arch.attn_every


# decoder-only families of attention + MLP/MoE blocks: the serving engine's
DECODER_FAMILIES = ("moe", "dense", "vlm")
# families whose decode cache holds state beyond K/V rows (Mamba2 and RWKV6
# states; whisper's cross K/V): driven through prefill and decode_step only
RECURRENT_FAMILIES = ("hybrid", "ssm", "audio")
PORTED_FAMILIES = DECODER_FAMILIES + RECURRENT_FAMILIES
PORTED_ATTENTION = ("gqa", "mla")
# the attention the other families' blocks take (rwkv6 has none)
_ATTENTION_OF = {"hybrid": ("gqa",), "audio": ("gqa",), "ssm": ("none",)}
DEC_POSITIONS = 448  # whisper's learned decoder positions


class LM:
    def __init__(
        self,
        arch: ArchConfig,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        q_chunk: int = 1024,
        kv_chunk: int = 1024,
        mesh_info: MeshInfo = LOCAL_MESH,
        remat: bool = False,
        loss_chunk: int = 512,
    ):
        if (arch.family not in PORTED_FAMILIES
                or arch.attn.kind not in _ATTENTION_OF.get(arch.family, PORTED_ATTENTION)):
            raise NotImplementedError(
                f"family {arch.family!r} with {arch.attn.kind!r} attention is not "
                f"ported yet (ported: {', '.join(DECODER_FAMILIES)} with "
                f"{' or '.join(PORTED_ATTENTION)} attention, hybrid and audio with gqa, "
                "ssm with none)"
            )
        self.arch = arch
        # leading dense blocks of a MoE model (DeepSeek-V2: 1)
        self.n_prefix = arch.moe.first_k_dense if arch.moe is not None else 0
        self.dtype = dtype
        self.device = resolve_device(device)
        self.q_chunk = q_chunk
        self.kv_chunk = kv_chunk
        self.mi = mesh_info
        self.remat = remat
        self.loss_chunk = loss_chunk
        # vocab padded to a multiple of 128; padded logits are masked
        self.vocab_padded = padded_vocab(arch)

    # ------------------------------------------------------------------
    def init(self, seed: int, keyed: bool = False) -> Dict[str, Any]:
        """Random weights from a seeded ``torch.Generator`` on the device.

        ``keyed`` draws every leaf, and every expert of a MoE layer, from a
        generator of its own seeded by ``(seed, its path)``: a rank then
        draws only the experts it holds, and the same numbers for them as
        a one-process model drawn keyed at the same depth.  On a mesh the
        draw is always keyed."""
        if keyed or self.mi.ep_size > 1:
            return self._keyed_init(seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return self._draw(gen, self.device)

    def _draw(self, gen: torch.Generator, dev) -> Dict[str, Any]:
        """The parameter tree drawn from ``gen`` in one sequence, on ``dev``
        (the ``"meta"`` device gives the shapes alone)."""
        arch, dtype = self.arch, self.dtype

        def normal(shape, scale):
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
            return w.mul_(scale).to(dtype)

        p: Dict[str, Any] = {
            "embed": normal((self.vocab_padded, arch.d_model), 0.02),
            "final_norm": init_norm(arch.d_model, arch.norm, dev),
        }
        if not arch.tie_embeddings:
            p["w_out"] = normal((arch.d_model, self.vocab_padded), 0.02)
        if arch.family == "hybrid":
            nseg, per, tail = _zamba_layout(arch)
            # one block applied at every segment, each with its own KV slot
            p["shared_attn"] = tf.init_attn_mlp_block(gen, arch, False, dtype, dev)
            p["mamba_seg"] = [[tf.init_mamba_block(gen, arch, dtype, dev) for _ in range(per)]
                              for _ in range(nseg)]
            if tail:
                p["mamba_tail"] = [tf.init_mamba_block(gen, arch, dtype, dev) for _ in range(tail)]
            return p
        if arch.family == "ssm":
            p["blocks"] = [tf.init_rwkv_block(gen, arch, dtype, dev) for _ in range(arch.n_layers)]
            return p
        if arch.family == "audio":
            p["enc_blocks"] = [tf.init_enc_block(gen, arch, dtype, dev) for _ in range(arch.enc_layers)]
            p["enc_norm"] = init_norm(arch.d_model, arch.norm, dev)
            p["blocks"] = [tf.init_dec_block(gen, arch, dtype, dev) for _ in range(arch.n_layers)]
            p["dec_pos"] = normal((DEC_POSITIONS, arch.d_model), 0.01)
            return p
        moe = arch.moe is not None
        if self.n_prefix:
            p["prefix_blocks"] = [
                tf.init_attn_mlp_block(gen, arch, False, dtype, dev)
                for _ in range(self.n_prefix)
            ]
        p["blocks"] = [
            tf.init_attn_mlp_block(gen, arch, moe, dtype, dev)
            for _ in range(arch.n_layers - self.n_prefix)
        ]
        return p

    def _keyed_init(self, seed: int) -> Dict[str, Any]:
        """``init(keyed=True)``: the tree of ``_draw``, each leaf drawn from
        the same distribution by a generator of its own; expert stacks only
        at this rank's rows (``sharding.expert_rows``), and the other leaves
        that the model group splits (``sharding.tp_axis``) drawn whole in
        float32 and cut to this rank's part (``sharding.rank_part``) before
        the cast, so the rank holds the numbers of a one-process keyed
        draw."""
        dev = self.device

        def normals(key, shape):
            gen = torch.Generator(device=dev)
            gen.manual_seed(leaf_seed(seed, *key))
            return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)

        def leaf(path, t):
            name = path[-1]
            if is_expert_leaf(path):
                rows = expert_rows(t.shape[0], self.mi)
                return torch.stack([normals(path + (e,), t.shape[1:]).mul_(t.shape[-2] ** -0.5).to(t.dtype)
                                    for e in range(rows.start, rows.stop)])

            def cut(w):
                return rank_part(w, path, self.arch, self.mi)

            if name in ("scale", "q_norm_scale", "kv_norm_scale", "bias", "bq", "bk", "bv"):
                fill = torch.ones if name in ("scale", "q_norm_scale", "kv_norm_scale") else torch.zeros
                return fill(cut(t).shape, dtype=t.dtype, device=dev)
            if "mamba" in path or "rwkv" in path:
                # a copy: a view would keep the whole leaf alive
                return cut(ssm.init_leaf(name, t.shape, t.dtype, dev, lambda shape: normals(path, shape))).clone()
            # embeddings, logits and the router: normal * 0.02; whisper's
            # decoder positions: * 0.01; others He
            scale = {"embed": 0.02, "w_out": 0.02, "w_router": 0.02, "dec_pos": 0.01}.get(
                name, t.shape[-2] ** -0.5)
            return cut(normals(path, t.shape)).mul(scale).to(t.dtype)

        def walk(tree, path=()):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            if isinstance(tree, list):
                return [walk(v, path + (i,)) for i, v in enumerate(tree)]
            return leaf(path, tree)

        return walk(self.shapes())

    def shapes(self) -> Dict[str, Any]:
        """The one-process parameter tree on the ``"meta"`` device: every
        leaf's whole shape and dtype, whatever the mesh (what
        ``train_loop.split_leaves`` and a mesh checkpoint read)."""
        return self._draw(torch.Generator(), "meta")

    def _caches(self, row_shapes, dtypes=None) -> Dict[str, Any]:
        """Zeroed cache leaves ``(n, *row_shape)`` for each shape of
        ``row_shapes`` (of the model dtype, or of ``dtypes``): ``"blocks"``
        for the main blocks and, with a dense prefix, ``"prefix"`` for its
        blocks."""
        dtypes = dtypes or [self.dtype] * len(row_shapes)

        def leaves(n):
            return tuple(torch.zeros((n,) + shape, dtype=dt, device=self.device)
                         for shape, dt in zip(row_shapes, dtypes))

        c = {"blocks": leaves(self.arch.n_layers - self.n_prefix)}
        if self.n_prefix:
            c["prefix"] = leaves(self.n_prefix)
        return c

    def _seq_par(self) -> bool:
        """Sequence-parallel decode (``repro.models.model.LM.
        _use_seqpar_decode``): on a mesh whose model group does not divide
        the kv heads, a GQA cache is split along the sequence over the
        group.  The reference also requires the cache length to divide
        over the group, else GSPMD gathers the cache; the port has no
        gathered layout, so ``init_cache`` and ``prefill`` refuse such a
        length instead.  (The reference's ``REPRO_SEQPAR=0``, which selects
        that GSPMD layout for comparison, has no counterpart.)"""
        a, mi = self.arch.attn, self.mi
        return (self.arch.family in DECODER_FAMILIES and a.kind == "gqa" and a.mrope_sections is None
                and mi.ep_size > 1 and a.n_kv_heads % mi.ep_size != 0)

    def _tp(self) -> bool:
        """Head-sharded attention (tensor parallelism): on a mesh whose model
        group divides the heads (and a GQA model's kv heads), a rank holds
        its heads' slices of the projections and, of a GQA cache, its kv
        heads (``sharding.tp_splits``).  The dense and shared-expert FFNs
        and the vocabulary split wherever the group divides them, whatever
        this says; ``_tp`` and ``_seq_par`` never both hold."""
        return tp_splits("attn", self.arch, self.mi.ep_size)

    def _kv_int8(self) -> bool:
        """``REPRO_KV_INT8=1``: int8 K/V with float32 per-(token, head)
        scales, for GQA decoder-only families, as the reference's
        ``init_cache`` reads it; only the sequence-parallel decode reads
        such a cache."""
        return (os.environ.get("REPRO_KV_INT8", "0") == "1"
                and self.arch.family in DECODER_FAMILIES and self.arch.attn.kind == "gqa")

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, Any]:
        """Dense per-slot caches: ``(k, v)`` of ``(n, batch, max_seq, Kv,
        dh)`` each, or for MLA ``(c_kv, k_rope)`` of ``(n, batch, max_seq,
        kv_lora)`` and ``(n, batch, max_seq, qk_rope)``; with
        ``REPRO_KV_INT8=1`` (GQA) ``(k, v, k_scale, v_scale)``, int8 K/V and
        float32 scales of ``(n, batch, max_seq, Kv)``.

        On a mesh ``batch`` and ``max_seq`` are global and the cache is this
        rank's: its rows of the batch and, for sequence-parallel decode,
        its slice of the positions.

        The other families (the reference's layouts, zeroed): hybrid
        ``{"mamba_seg": Mamba2State (n_seg, per, batch, ...), "attn": (k,
        v) (n_seg, batch, max_seq, Kv, dh), "mamba_tail": Mamba2State
        (tail, batch, ...)}``; ssm ``{"blocks": RWKV6State (n_layers,
        batch, ...)}``; audio ``{"self": (k, v) (n_layers, batch, max_seq,
        Kv, dh), "cross": (k, v) (n_layers, batch, enc_seq, H, dh)}``."""
        rows = batch_rows(batch, self.mi)
        if self.arch.family in RECURRENT_FAMILIES:
            return self._state_cache(rows.stop - rows.start, max_seq)
        if self._seq_par():
            positions = seq_positions(max_seq, self.mi)
            max_seq = positions.stop - positions.start
        return self._local_cache(rows.stop - rows.start, max_seq)

    def _local_cache(self, batch: int, max_seq: int) -> Dict[str, Any]:
        """Zeroed caches of ``batch`` rows and ``max_seq`` positions."""
        a = self.arch.attn
        if a.kind == "mla":
            m = a.mla
            return self._caches([(batch, max_seq, m.kv_lora_rank), (batch, max_seq, m.qk_rope_dim)])
        shape = (batch, max_seq, rank_attn(a, self.mi).n_kv_heads, a.d_head)
        if self._kv_int8():
            return self._caches([shape, shape, shape[:3], shape[:3]],
                                [torch.int8, torch.int8, torch.float32, torch.float32])
        return self._caches([shape, shape])

    def _kv(self, n: int, batch: int, T: int, heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = (n, batch, T, heads, self.arch.attn.d_head)
        return tuple(torch.zeros(shape, dtype=self.dtype, device=self.device) for _ in range(2))

    def _state_cache(self, batch: int, max_seq: int) -> Dict[str, Any]:
        """The zeroed decode cache of a hybrid, ssm or audio model for
        ``batch`` rows (this rank's), in this rank's heads."""
        arch, dtype, dev, mi = self.arch, self.dtype, self.device, self.mi
        a = arch.attn
        kv_heads = rank_attn(a, mi).n_kv_heads
        if arch.family == "hybrid":
            nseg, per, tail = _zamba_layout(arch)
            heads = rank_heads("mamba", ssm_heads(arch), arch, mi)

            def states(stack):
                return ssm.mamba2_init_state(batch, arch.d_model, arch.ssm, dtype, dev, stack, heads)

            c = {"mamba_seg": states((nseg, per)), "attn": self._kv(nseg, batch, max_seq, kv_heads)}
            if tail:
                c["mamba_tail"] = states((tail,))
            return c
        if arch.family == "ssm":
            return {"blocks": ssm.rwkv6_init_state(batch, arch.d_model, arch.ssm, dtype, dev, (arch.n_layers,),
                                                   rank_heads("rwkv", ssm_heads(arch), arch, mi))}
        return {"self": self._kv(arch.n_layers, batch, max_seq, kv_heads),
                "cross": self._kv(arch.n_layers, batch, arch.enc_seq, rank_heads("xattn", a.n_heads, arch, mi))}

    def init_paged_cache(self, n_pool: int, page: int) -> Dict[str, Any]:
        """Paged KV cache: per-layer shared block pools ``(n_layers, n_pool,
        page, Kv, dh)`` in place of the dense per-slot buffers.  The block
        table that maps (slot, logical block) to a pool block lives on the
        host (``serving.batching.PagedKVCache``) and arrives with each
        decode batch; physical block 0 is the trash block idle slots write
        into.  MLA's compressed cache has no paged layout (the reference
        raises too)."""
        arch = self.arch
        a = arch.attn
        if arch.family not in DECODER_FAMILIES or a.kind != "gqa":
            raise ValueError(
                "paged KV cache requires a gqa decoder-only family "
                f"(got family={arch.family}, attn={a.kind})"
            )
        if os.environ.get("REPRO_KV_INT8", "0") == "1":
            raise ValueError("paged KV cache does not support int8 KV yet")
        if self.mi != LOCAL_MESH:
            raise ValueError("the paged KV cache is the serving engine's, which runs on one "
                             "process: it has no mesh layout")
        shape = (n_pool, page, a.n_kv_heads, a.d_head)
        return self._caches([shape, shape])

    def _rank_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a global batch."""
        key = "tokens" if "tokens" in batch else "embeds"
        rows = batch_rows(batch[key].shape[0], self.mi)
        if self.mi.dp_size == 1:
            return batch
        out = dict(batch)
        for k in ("tokens", "embeds", "position", "positions", "labels"):
            if k in out:
                out[k] = out[k][rows]
        if "mrope_positions" in out:
            out["mrope_positions"] = out["mrope_positions"][:, rows]
        return out

    def _train_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a global training batch.  Raises for a MoE
        arch whose experts a mesh with more than one data rank does not
        run expert-parallel: the reference then routes the global batch
        as one (``moe_local`` under GSPMD: its capacity, drops and aux loss
        are the whole batch's), where a rank here would route its own
        rows."""
        cfg = self.arch.moe
        if cfg is not None and self.mi.dp_size > 1 and not expert_parallel(cfg, self.mi):
            raise ValueError(
                f"training {self.arch.name} on {self.mi.dp_size} data ranks needs its {cfg.n_experts} "
                f"experts split over a model group that divides them, not one of {self.mi.ep_size}: the "
                "reference routes the global batch as one otherwise, which a rank of its rows cannot")
        return self._rank_batch(batch)

    def _all_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of a per-row result, gathered over the data
        group (every rank gets the same tensor)."""
        if self.mi.dp_size == 1:
            return t
        return coll.all_gather(t, self.mi.data_group).reshape((-1,) + tuple(t.shape[1:]))

    def _decode_cache(self, prompt: Dict[str, Any], S: int, max_seq: int) -> Dict[str, Any]:
        """A decode cache of ``max_seq`` positions in this rank's layout,
        holding the prompt cache's ``S`` positions (``prefill(max_seq=)``)."""
        if max_seq < S:
            raise ValueError(f"a cache of {max_seq} positions cannot hold a {S}-token prompt")
        if self._kv_int8():
            raise ValueError("an int8 KV cache starts from init_cache: its rows are quantised "
                             "in decode only, as in the reference")
        pos = seq_positions(max_seq, self.mi) if self._seq_par() else slice(0, max_seq)
        cache = self._local_cache(prompt["blocks"][0].shape[1], pos.stop - pos.start)
        lo, hi = pos.start, min(pos.stop, S)
        if hi > lo:
            for key in cache:
                for dst, src in zip(cache[key], prompt[key]):
                    dst[:, :, : hi - lo].copy_(src[:, :, lo:hi])
        return cache

    def _vocab_group(self):
        """The model group where it splits the padded vocabulary (the
        embedding's rows, ``w_out``'s columns), else None."""
        return tp_group("vocab", self.arch, self.mi)

    def _logits(self, p, h: torch.Tensor) -> torch.Tensor:
        logits = lm_logits(h, p["embed"], p.get("w_out"), self._vocab_group())
        if self.vocab_padded != self.arch.vocab_size:
            live = torch.arange(self.vocab_padded, device=h.device) < self.arch.vocab_size
            logits = torch.where(live, logits, -1e30)
        return logits

    def _embed_tokens(self, p, tokens: torch.Tensor) -> torch.Tensor:
        """The tokens' embeddings (vocab-parallel where the model group
        splits the vocabulary)."""
        group = self._vocab_group()
        first = 0 if group is None else self.mi.model_index * p["embed"].shape[0]
        return embed(p["embed"], tokens, group, first)

    def _embed_in(self, p, batch) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Token embeddings, or the modality stub's precomputed ``embeds``,
        and the batch's M-RoPE positions (None without them)."""
        if "embeds" in batch:
            x = batch["embeds"].to(self.dtype)
        else:
            x = self._embed_tokens(p, batch["tokens"])
        return x, batch.get("mrope_positions")

    def stub_inputs(self, batch: int, seq: int, seed: int) -> Dict[str, torch.Tensor]:
        """Seeded inputs of the modality stub: ``embeds`` (batch, seq,
        d_model) standing in for the vision tower's patch embeddings or the
        audio frontend's frame embeddings; for the vision stub also
        ``mrope_positions`` (3, batch, seq) that walk the patches of two or
        more frames row by row, so the temporal, height and width streams
        differ (the counterpart of the ``vlm`` and ``audio`` entries of
        ``repro.models.model.LM.input_specs``)."""
        if self.arch.modality_stub not in ("vision_patches", "audio_frames"):
            raise ValueError(f"{self.arch.name} has no modality stub: no vision-patch stub and no "
                             "audio-frame stub")
        rng = np.random.default_rng(seed)
        emb = rng.standard_normal((batch, seq, self.arch.d_model)).astype(np.float32)
        embeds = torch.from_numpy(emb).to(device=self.device, dtype=self.dtype)
        if self.arch.modality_stub == "audio_frames":
            return {"embeds": embeds}
        side = max(1, int(np.sqrt(seq / 2)))  # patches per row and column of a frame
        s = np.arange(seq)
        grid = np.stack([s // (side * side), s // side % side, s % side])  # t, h, w
        pos = np.broadcast_to(grid[:, None, :], (3, batch, seq)).astype(np.int32)
        return {
            "embeds": embeds,
            "mrope_positions": torch.from_numpy(np.ascontiguousarray(pos)).to(self.device),
        }

    # ------------------------------------------------------------------
    def prefill(self, p, batch: Dict[str, Any], max_seq: Optional[int] = None):
        """Forward over the prompt: (last-position logits, cache of the
        prompt, StepAux).  The cache holds, under ``"blocks"`` (and
        ``"prefix"`` for a dense prefix), the prompt's K/V as ``(n, B, S,
        Kv, dh)`` tensors, or MLA's ``(c_kv, k_rope)`` as ``(n, B, S,
        kv_lora)`` and ``(n, B, S, qk_rope)``.  batch: tokens (B, S) or the
        stub's ``embeds`` (B, S, d); for the ``vlm`` family optionally
        ``mrope_positions`` (3, B, S).

        ``max_seq`` returns instead the decode cache of ``max_seq``
        positions that holds the prompt, as ``init_cache`` lays it out.  On
        a mesh the cache is this rank's: its rows of the batch, and with
        ``max_seq`` on the sequence-parallel path its slice of the
        positions; the logits and the StepAux are global.

        The other families return their decode cache (``init_cache``'s
        layout, on a mesh this rank's) with the prompt's states and K/V:
        the K/V of ``max_seq`` positions (of the prompt's by default), the
        Mamba2 and RWKV6 states after the prompt, whisper's cross K/V of its
        frames.  The audio batch is ``embeds`` (B, frames, d) and the
        decoder's ``tokens`` (B, S)."""
        if self.arch.family in RECURRENT_FAMILIES:
            return self._prefill_states(p, batch, max_seq)
        batch = self._rank_batch(batch)
        x, mrope = self._embed_in(p, batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        x, cache, aux = self._walk_attn_stack(p, x, positions, mrope, batch.get("sieve"),
                                              collect_cache=True)
        if max_seq is not None:
            cache = self._decode_cache(cache, S, max_seq)
        h = apply_norm(p["final_norm"], x, self.arch.norm)
        return self._all_rows(self._logits(p, h[:, -1:, :])), cache, aux

    def _walk_attn_stack(self, p, x, positions, mrope, sieve, collect_cache: bool):
        """The decoder-only stack, shared by prefill and training
        (``repro.models.model.LM._walk_attn_stack``): the dense prefix
        blocks, then the main blocks.  Returns ``(x, cache, StepAux)``, the
        cache (``{"prefix", "blocks"}`` of stacked per-block leaves) only
        with ``collect_cache``.  Under ``remat`` with gradients enabled each
        main block is recomputed in the backward pass, as the reference
        checkpoints its scan body (the prefix blocks are not)."""
        arch = self.arch

        def block(blk, x, moe):
            return tf.attn_mlp_block_seq(
                blk, x, positions, arch, moe, q_chunk=self.q_chunk, kv_chunk=self.kv_chunk,
                sieve=sieve, mrope_positions=mrope, mi=self.mi,
            )

        def walk(x, blocks, moe, remat):
            caches, auxes = [], []
            for blk in blocks:
                if remat:
                    x, c, aux = checkpoint(block, blk, x, moe, use_reentrant=False)
                else:
                    x, c, aux = block(blk, x, moe)
                if collect_cache:
                    caches.append(c)
                auxes.append(aux)
            return x, tuple(torch.stack(leaf) for leaf in zip(*caches)), auxes

        cache, prefix_auxes = {}, []
        if self.n_prefix:
            x, cache["prefix"], prefix_auxes = walk(x, p["prefix_blocks"], False, False)
        remat = self.remat and torch.is_grad_enabled()
        x, cache["blocks"], auxes = walk(x, p["blocks"], arch.moe is not None, remat)
        return x, (cache if collect_cache else None), _aggregate_aux(prefix_auxes, auxes)

    # ------------------------------------------------------------------
    # training: forward / loss
    # ------------------------------------------------------------------

    def forward(self, p, batch: Dict[str, Any]):
        """Full-sequence forward -> ``(h, StepAux)``, ``h`` the final-norm
        hidden states (B, S, d): the training path, differentiable in
        ``p``.  batch: ``tokens`` (B, S) or the stub's ``embeds`` (B, S, d),
        optionally ``positions`` (B, S), ``mrope_positions`` (3, B, S) and
        ``sieve``; for the audio family the encoder's ``embeds`` (B,
        frames, d) and the decoder's ``tokens`` (B, Sd), ``h`` then the
        decoder's.  On a mesh the batch is global and ``h`` holds this
        rank's rows of it (``sharding.batch_rows``); the StepAux is
        global.  With more than one data rank a MoE arch's experts must be
        expert-parallel (:meth:`_train_batch` raises otherwise)."""
        return self._forward(p, self._train_batch(batch))

    def _forward(self, p, batch: Dict[str, Any]):
        """:meth:`forward` on this rank's rows of the batch."""
        arch = self.arch
        if arch.family in RECURRENT_FAMILIES:
            x, _ = self._recurrent_seq(p, batch, collect_cache=False)
            return apply_norm(p["final_norm"], x, arch.norm), _empty_aux(x.device)
        x, mrope = self._embed_in(p, batch)
        B, S = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        x, _, aux = self._walk_attn_stack(p, x, positions, mrope, batch.get("sieve"),
                                          collect_cache=False)
        return apply_norm(p["final_norm"], x, arch.norm), aux

    def loss(self, p, batch: Dict[str, Any]):
        """Next-token cross-entropy over ``batch["labels"]`` (B, S), the
        logits computed ``loss_chunk`` positions at a time in float32 with
        the padded vocabulary masked, plus ``router_aux_coef`` times the
        MoE aux loss (``repro.models.model.LM.loss``).  Returns ``(loss,
        {"ce": ce, "aux": StepAux})``.

        On a mesh the batch is global and a rank's ``ce`` is the mean over
        the labels of its rows; where the model group splits the
        vocabulary each chunk's logits are the rank's columns, gathered to
        the whole padded vocabulary before the mask.  The MoE aux loss
        carries the gradient of this rank's rows' aux loss and the value
        of the global one (``moe._aux_on_mesh``): the mean of the data
        ranks' losses and gradients is then the reference's."""
        batch = self._train_batch(batch)
        h, aux = self._forward(p, batch)
        labels = batch["labels"]
        B, S = labels.shape
        chunk = min(self.loss_chunk, S)
        while S % chunk:
            chunk //= 2
        live = None
        if self.vocab_padded != self.arch.vocab_size:
            live = torch.arange(self.vocab_padded, device=h.device) < self.arch.vocab_size
        total = 0.0
        for s0 in range(0, S, chunk):
            logits = lm_logits(h[:, s0:s0 + chunk], p["embed"], p.get("w_out"), self._vocab_group()).float()
            if live is not None:
                logits = torch.where(live, logits, -1e30)
            gold = torch.gather(logits, -1, labels[:, s0:s0 + chunk, None].long())[..., 0]
            total = total + (torch.logsumexp(logits, -1) - gold).sum()
        ce = total / (B * S)
        aux_coef = self.arch.moe.router_aux_coef if self.arch.moe is not None else 0.0
        return ce + aux_coef * aux.moe_aux, {"ce": ce, "aux": aux}

    def decode_step(self, p, batch: Dict[str, Any], cache: Dict[str, Any]):
        """One-token step.  batch: tokens (B, 1), position (B,), optional
        sieve and ``mrope_positions`` (3, B, 1), and for a paged cache
        ``block_tables``/``pool_owner``/``pool_pos``.  Writes the step's K/V
        (MLA: its ``(c_kv, k_rope)`` row) into ``cache`` in place, the dense
        prefix's before the main blocks', and returns ``(logits, cache,
        StepAux)``.

        On a mesh the batch is global, ``cache`` is this rank's (as
        ``init_cache`` and ``prefill`` lay it out), the logits are global;
        a cache split along the sequence decodes sequence-parallel.

        The other families update every state and K/V leaf of ``cache`` (on
        a mesh this rank's) in place; whisper's decoder adds the learned
        position ``dec_pos[position % 448]``."""
        if self.arch.family in RECURRENT_FAMILIES:
            return self._decode_states(p, batch, cache)
        arch = self.arch
        batch = self._rank_batch(batch)
        x, mrope = self._embed_in(p, batch)
        position = batch["position"]
        moe = arch.moe is not None
        paged = None
        if "block_tables" in batch:
            if self.mi != LOCAL_MESH:
                raise ValueError("the paged KV cache has no mesh layout")
            paged = (batch["block_tables"], batch["pool_owner"], batch["pool_pos"])
        seq_par = paged is None and self._seq_par()
        if not seq_par and len(cache["blocks"]) == 4:
            raise ValueError("an int8 KV cache is read by sequence-parallel decode only "
                             "(a mesh whose model group does not divide the kv heads)")

        def walk(x, blocks, leaves, moe):
            auxes = []
            for i, blk in enumerate(blocks):
                x, aux = tf.attn_mlp_block_decode(
                    blk, x, position, tuple(leaf[i] for leaf in leaves), arch, moe,
                    sieve=batch.get("sieve"), paged=paged, mrope_positions=mrope,
                    mi=self.mi, seq_par=seq_par,
                )
                auxes.append(aux)
            return x, auxes

        prefix_auxes = []
        if self.n_prefix:
            x, prefix_auxes = walk(x, p["prefix_blocks"], cache["prefix"], False)
        x, auxes = walk(x, p["blocks"], cache["blocks"], moe)
        h = apply_norm(p["final_norm"], x, arch.norm)
        return self._all_rows(self._logits(p, h)), cache, _aggregate_aux(prefix_auxes, auxes)

    # ------------------------------------------------------------------
    # hybrid, ssm and audio families
    # ------------------------------------------------------------------

    def _run(self, fn, *args):
        """``fn(*args)``; under ``remat`` with gradients enabled recomputed
        in the backward pass (``torch.utils.checkpoint``), as the reference
        checkpoints its scan bodies."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _walk_mamba(self, blocks, x, states: Optional[Mamba2State], step: bool, collect_cache: bool):
        """Mamba2 blocks.  ``step``: one token from ``states`` (stacked over
        the blocks), each block's new state written back in place.  Else
        each block runs the sequence from zeros, and with ``collect_cache``
        its final state is returned, stacked (a ``Mamba2State``)."""
        new = []
        for i, blk in enumerate(blocks):
            st = Mamba2State(*(leaf[i] for leaf in states)) if step else None
            x, out = self._run(tf.mamba_block, blk, x, self.arch, st, step, self.mi)
            if step:
                for dst, src in zip(st, out):
                    dst.copy_(src)
            elif collect_cache:
                new.append(out)
        return x, (Mamba2State(*(torch.stack(leaf) for leaf in zip(*new))) if new else None)

    def _shared_attn_seq(self, blk, x, positions):
        x, kv, _ = tf.attn_mlp_block_seq(blk, x, positions, self.arch, False, q_chunk=self.q_chunk,
                                         kv_chunk=self.kv_chunk, mi=self.mi)
        return x, kv

    def _walk_hybrid_stack(self, p, x, positions, cache, collect_cache: bool, step: bool):
        """zamba2 (``repro.models.model.LM._walk_hybrid_stack``): each
        segment is the shared attention block, with the segment's own KV
        slot, then its Mamba2 blocks; the Mamba2 tail follows.  ``step``:
        one decode token at ``positions`` (B,), the K/V row and the states
        written into ``cache`` in place.  Else the sequence, every state from
        zeros: with ``collect_cache`` (prefill) returns ``(x, cache)``, the
        cache of the prompt's K/V (S positions) and final states, without
        (training) ``(x, None)``.  The shared block's weights serve every
        segment, so its gradient sums over the applications."""
        arch = self.arch
        segs, kv = [], []
        for s, seg in enumerate(p["mamba_seg"]):
            states = None
            if step:
                x, _ = tf.attn_mlp_block_decode(p["shared_attn"], x, positions,
                                                tuple(leaf[s] for leaf in cache["attn"]), arch, False,
                                                mi=self.mi)
                states = Mamba2State(*(leaf[s] for leaf in cache["mamba_seg"]))
            else:
                x, c = self._run(self._shared_attn_seq, p["shared_attn"], x, positions)
                if collect_cache:
                    kv.append(c)
            x, st = self._walk_mamba(seg, x, states, step, collect_cache)
            segs.append(st)
        tail = None
        if "mamba_tail" in p:
            x, tail = self._walk_mamba(p["mamba_tail"], x, cache["mamba_tail"] if step else None, step,
                                       collect_cache)
        if step or not collect_cache:
            return x, None
        new = {"mamba_seg": Mamba2State(*(torch.stack(leaf) for leaf in zip(*segs))),
               "attn": tuple(torch.stack(leaf) for leaf in zip(*kv))}
        if tail is not None:
            new["mamba_tail"] = tail
        return x, new

    def _walk_rwkv_stack(self, p, x, states: RWKV6State, collect_cache: bool, step: bool):
        """RWKV6 blocks from ``states`` (stacked over the blocks).
        ``step``: each block's new state written back in place.  Else with
        ``collect_cache`` the final states are returned, stacked."""
        new = []
        for i, blk in enumerate(p["blocks"]):
            st = RWKV6State(*(leaf[i] for leaf in states))
            x, out = self._run(tf.rwkv_block, blk, x, self.arch, st, self.mi)
            if step:
                for dst, src in zip(st, out):
                    dst.copy_(src)
            elif collect_cache:
                new.append(out)
        return x, (RWKV6State(*(torch.stack(leaf) for leaf in zip(*new))) if new else None)

    def _whisper_encode(self, p, frames: torch.Tensor) -> torch.Tensor:
        arch = self.arch
        x = frames.to(self.dtype)
        x = x + sinusoidal_positions(x.shape[1], arch.d_model, x.device).to(x.dtype)[None]
        for blk in p["enc_blocks"]:
            x = self._run(tf.enc_block, blk, x, arch, self.q_chunk, self.kv_chunk, self.mi)
        return apply_norm(p["enc_norm"], x, arch.norm)

    def _dec_block_seq(self, blk, x, enc):
        """One decoder block over the sequence, its cross K/V projected from
        the encoder's states: ``(x, self K/V, cross K/V)``."""
        S = x.shape[1]
        enc_kv = project_cross_kv(blk["xattn"], enc, self.arch.attn, tp_group("xattn", self.arch, self.mi))
        x, kv = tf.dec_block_seq(blk, x, enc_kv, self.arch, q_chunk=min(self.q_chunk, S),
                                 kv_chunk=min(self.kv_chunk, S), mi=self.mi)
        return x, kv, enc_kv

    def _recurrent_seq(self, p, batch: Dict[str, Any], collect_cache: bool):
        """The hybrid, ssm or audio stack over a whole sequence (this rank's
        rows): ``(x, cache)``, the cache of the prompt (K/V of its S
        positions, final states, whisper's cross K/V) with
        ``collect_cache``, else None."""
        arch = self.arch
        if arch.family == "audio":
            enc = self._whisper_encode(p, batch["embeds"])
            x = self._embed_tokens(p, batch["tokens"])
            x = x + p["dec_pos"][: x.shape[1]][None]
            kv, cross = [], []
            for blk in p["blocks"]:
                x, c, e = self._run(self._dec_block_seq, blk, x, enc)
                if collect_cache:
                    kv.append(c)
                    cross.append(e)
            if not collect_cache:
                return x, None
            return x, {"self": tuple(torch.stack(leaf) for leaf in zip(*kv)),
                       "cross": tuple(torch.stack(leaf) for leaf in zip(*cross))}
        x = self._embed_in(p, batch)[0]
        B, S = x.shape[:2]
        if arch.family == "hybrid":
            positions = batch.get("positions")
            if positions is None:
                positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
            return self._walk_hybrid_stack(p, x, positions, None, collect_cache, step=False)
        x, states = self._walk_rwkv_stack(p, x, self._state_cache(B, 0)["blocks"], collect_cache, step=False)
        return x, (None if states is None else {"blocks": states})

    def _prefill_states(self, p, batch: Dict[str, Any], max_seq: Optional[int]):
        arch = self.arch
        batch = self._rank_batch(batch)
        S = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[1]
        if max_seq is not None and max_seq < S:
            raise ValueError(f"a cache of {max_seq} positions cannot hold a {S}-token prompt")
        x, cache = self._recurrent_seq(p, batch, collect_cache=True)
        for key in ("attn", "self"):  # K/V of the prompt's positions, padded to the decode cache's
            if key in cache and max_seq is not None:
                cache[key] = tuple(F.pad(t, (0, 0, 0, 0, 0, max_seq - S)) for t in cache[key])
        h = apply_norm(p["final_norm"], x, arch.norm)
        return self._all_rows(self._logits(p, h[:, -1:, :])), cache, _empty_aux(x.device)

    def _decode_states(self, p, batch: Dict[str, Any], cache: Dict[str, Any]):
        arch = self.arch
        batch = self._rank_batch(batch)
        x, _ = self._embed_in(p, batch)
        position = batch["position"]
        if arch.family == "hybrid":
            x, _ = self._walk_hybrid_stack(p, x, position, cache, collect_cache=True, step=True)
        elif arch.family == "ssm":
            x, _ = self._walk_rwkv_stack(p, x, cache["blocks"], collect_cache=True, step=True)
        else:
            # structural clamp: the decoder has 448 learned positions
            x = x + p["dec_pos"][position.long() % p["dec_pos"].shape[0]][:, None, :]
            (sk, sv), (ck, cv) = cache["self"], cache["cross"]
            for i, blk in enumerate(p["blocks"]):
                x = tf.dec_block_decode(blk, x, position, (sk[i], sv[i]), (ck[i], cv[i]), arch, self.mi)
        h = apply_norm(p["final_norm"], x, arch.norm)
        return self._all_rows(self._logits(p, h)), cache, _empty_aux(x.device)
