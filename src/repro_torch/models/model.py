"""LM facade: init / prefill / decode for the decoder-only families
(counterpart of ``repro.models.model.LM``): ``moe``, ``dense``, and
``vlm``, whose vision frontend is a stub (precomputed patch embeddings,
:meth:`LM.stub_inputs`) and whose attention rotates by M-RoPE.  Attention
is GQA, or DeepSeek-V2's MLA with its compressed ``(c_kv, k_rope)``
cache; a MoE model's leading ``first_k_dense`` blocks are dense
(``p["prefix_blocks"]``, cache ``"prefix"``), walked before the MoE
blocks.

Parameters are a dict like the JAX pytree, except that the scan-stacked
``p["blocks"]`` and ``p["prefix_blocks"]`` become lists of per-layer
dicts and the ``lax.scan`` over layers a Python loop.  The KV cache is
updated in place.

On a mesh (``LM(mesh_info=...)``, from :mod:`repro_torch.launch.mesh`)
every rank runs the same entry points on the global batch, as the JAX
ones run under ``shard_map`` and GSPMD: a rank computes its rows of the
batch, holds its experts (:mod:`repro_torch.models.sharding`) and its rows
of the cache (and, when the kv heads do not divide the model group, its
slice of the positions: sequence-parallel decode), and returns the global
logits and step counts.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from . import collectives as coll
from . import transformer as tf
from .layers import apply_norm, embed, init_norm, lm_logits
from .moe import LOCAL_MESH, MeshInfo
from .sharding import batch_rows, expert_rows, is_expert_leaf, leaf_seed, seq_positions
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


# decoder-only families of attention + MLP/MoE blocks
PORTED_FAMILIES = ("moe", "dense", "vlm")
PORTED_ATTENTION = ("gqa", "mla")


class LM:
    def __init__(
        self,
        arch: ArchConfig,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        q_chunk: int = 1024,
        kv_chunk: int = 1024,
        mesh_info: MeshInfo = LOCAL_MESH,
    ):
        if arch.family not in PORTED_FAMILIES or arch.attn.kind not in PORTED_ATTENTION:
            raise NotImplementedError(
                f"family {arch.family!r} with {arch.attn.kind!r} attention is not "
                f"ported yet (ported: {', '.join(PORTED_FAMILIES)} with "
                f"{' or '.join(PORTED_ATTENTION)} attention)"
            )
        self.arch = arch
        # leading dense blocks of a MoE model (DeepSeek-V2: 1)
        self.n_prefix = arch.moe.first_k_dense if arch.moe is not None else 0
        self.dtype = dtype
        self.device = resolve_device(device)
        self.q_chunk = q_chunk
        self.kv_chunk = kv_chunk
        self.mi = mesh_info
        # vocab padded to a multiple of 128; padded logits are masked
        self.vocab_padded = -(-arch.vocab_size // 128) * 128

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
            "final_norm": init_norm(arch.d_model, dev),
        }
        if not arch.tie_embeddings:
            p["w_out"] = normal((arch.d_model, self.vocab_padded), 0.02)
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
        at this rank's rows (``sharding.expert_rows``)."""
        dev = self.device

        def draw(key, shape, scale, dtype):
            gen = torch.Generator(device=dev)
            gen.manual_seed(leaf_seed(seed, *key))
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
            return w.mul_(scale).to(dtype)

        def leaf(path, t):
            name = path[-1]
            if name in ("scale", "q_norm_scale", "kv_norm_scale"):
                return torch.ones(t.shape, dtype=t.dtype, device=dev)
            if name in ("bias", "bq", "bk", "bv"):
                return torch.zeros(t.shape, dtype=t.dtype, device=dev)
            if is_expert_leaf(path):
                rows = expert_rows(t.shape[0], self.mi)
                return torch.stack([draw(path + (e,), t.shape[1:], t.shape[-2] ** -0.5, t.dtype)
                                    for e in range(rows.start, rows.stop)])
            # embeddings, logits and the router: normal * 0.02; others He
            scale = 0.02 if name in ("embed", "w_out", "w_router") else t.shape[-2] ** -0.5
            return draw(path, t.shape, scale, t.dtype)

        def walk(tree, path=()):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            if isinstance(tree, list):
                return [walk(v, path + (i,)) for i, v in enumerate(tree)]
            return leaf(path, tree)

        return walk(self._draw(torch.Generator(), "meta"))

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
        return (a.kind == "gqa" and a.mrope_sections is None and mi.ep_size > 1
                and a.n_kv_heads % mi.ep_size != 0)

    def _kv_int8(self) -> bool:
        """``REPRO_KV_INT8=1``: int8 K/V with float32 per-(token, head)
        scales, for GQA decoder-only families, as the reference's
        ``init_cache`` reads it; only the sequence-parallel decode reads
        such a cache."""
        return os.environ.get("REPRO_KV_INT8", "0") == "1" and self.arch.attn.kind == "gqa"

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, Any]:
        """Dense per-slot caches: ``(k, v)`` of ``(n, batch, max_seq, Kv,
        dh)`` each, or for MLA ``(c_kv, k_rope)`` of ``(n, batch, max_seq,
        kv_lora)`` and ``(n, batch, max_seq, qk_rope)``; with
        ``REPRO_KV_INT8=1`` (GQA) ``(k, v, k_scale, v_scale)``, int8 K/V and
        float32 scales of ``(n, batch, max_seq, Kv)``.

        On a mesh ``batch`` and ``max_seq`` are global and the cache is this
        rank's: its rows of the batch and, for sequence-parallel decode,
        its slice of the positions."""
        rows = batch_rows(batch, self.mi)
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
        shape = (batch, max_seq, a.n_kv_heads, a.d_head)
        if self._kv_int8():
            return self._caches([shape, shape, shape[:3], shape[:3]],
                                [torch.int8, torch.int8, torch.float32, torch.float32])
        return self._caches([shape, shape])

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
        if a.kind != "gqa":
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
        for k in ("tokens", "embeds", "position"):
            if k in out:
                out[k] = out[k][rows]
        if "mrope_positions" in out:
            out["mrope_positions"] = out["mrope_positions"][:, rows]
        return out

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

    def _logits(self, p, h: torch.Tensor) -> torch.Tensor:
        logits = lm_logits(h, p["embed"], p.get("w_out"))
        if self.vocab_padded != self.arch.vocab_size:
            live = torch.arange(self.vocab_padded, device=h.device) < self.arch.vocab_size
            logits = torch.where(live, logits, -1e30)
        return logits

    def _embed_in(self, p, batch) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Token embeddings, or the modality stub's precomputed ``embeds``,
        and the batch's M-RoPE positions (None without them)."""
        if "embeds" in batch:
            x = batch["embeds"].to(self.dtype)
        else:
            x = embed(p["embed"], batch["tokens"])
        return x, batch.get("mrope_positions")

    def stub_inputs(self, batch: int, seq: int, seed: int) -> Dict[str, torch.Tensor]:
        """Seeded inputs of the vision-patch stub: ``embeds`` (batch, seq,
        d_model) standing in for the vision tower's patch embeddings, and
        ``mrope_positions`` (3, batch, seq) that walk the patches of two or
        more frames row by row, so the temporal, height and width streams
        differ (the counterpart of the ``vlm`` entries of
        ``repro.models.model.LM.input_specs``)."""
        if self.arch.modality_stub != "vision_patches":
            raise ValueError(f"{self.arch.name} has no vision-patch stub")
        rng = np.random.default_rng(seed)
        emb = rng.standard_normal((batch, seq, self.arch.d_model)).astype(np.float32)
        side = max(1, int(np.sqrt(seq / 2)))  # patches per row and column of a frame
        s = np.arange(seq)
        grid = np.stack([s // (side * side), s // side % side, s % side])  # t, h, w
        pos = np.broadcast_to(grid[:, None, :], (3, batch, seq)).astype(np.int32)
        return {
            "embeds": torch.from_numpy(emb).to(device=self.device, dtype=self.dtype),
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
        positions; the logits and the StepAux are global."""
        arch = self.arch
        batch = self._rank_batch(batch)
        x, mrope = self._embed_in(p, batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        moe = arch.moe is not None

        def walk(x, blocks, moe):
            caches, auxes = [], []
            for blk in blocks:
                x, c, aux = tf.attn_mlp_block_seq(
                    blk, x, positions, arch, moe, q_chunk=self.q_chunk,
                    kv_chunk=self.kv_chunk, sieve=batch.get("sieve"), mrope_positions=mrope,
                    mi=self.mi,
                )
                caches.append(c)
                auxes.append(aux)
            return x, tuple(torch.stack(leaf) for leaf in zip(*caches)), auxes

        cache, prefix_auxes = {}, []
        if self.n_prefix:
            x, cache["prefix"], prefix_auxes = walk(x, p["prefix_blocks"], False)
        x, cache["blocks"], auxes = walk(x, p["blocks"], moe)
        if max_seq is not None:
            cache = self._decode_cache(cache, S, max_seq)
        h = apply_norm(p["final_norm"], x, arch.norm)
        logits = self._all_rows(self._logits(p, h[:, -1:, :]))
        return logits, cache, _aggregate_aux(prefix_auxes, auxes)

    def decode_step(self, p, batch: Dict[str, Any], cache: Dict[str, Any]):
        """One-token step.  batch: tokens (B, 1), position (B,), optional
        sieve and ``mrope_positions`` (3, B, 1), and for a paged cache
        ``block_tables``/``pool_owner``/``pool_pos``.  Writes the step's K/V
        (MLA: its ``(c_kv, k_rope)`` row) into ``cache`` in place, the dense
        prefix's before the main blocks', and returns ``(logits, cache,
        StepAux)``.

        On a mesh the batch is global, ``cache`` is this rank's (as
        ``init_cache`` and ``prefill`` lay it out), the logits are global;
        a cache split along the sequence decodes sequence-parallel."""
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
