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
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from . import transformer as tf
from .layers import apply_norm, embed, init_norm, lm_logits
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
        # vocab padded to a multiple of 128; padded logits are masked
        self.vocab_padded = -(-arch.vocab_size // 128) * 128

    # ------------------------------------------------------------------
    def init(self, seed: int) -> Dict[str, Any]:
        """Random weights from a seeded ``torch.Generator`` on the device."""
        arch, dtype, dev = self.arch, self.dtype, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

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

    def _caches(self, row_shapes) -> Dict[str, Any]:
        """Zeroed cache leaves ``(n, *row_shape)`` for each shape of
        ``row_shapes``: ``"blocks"`` for the main blocks and, with a dense
        prefix, ``"prefix"`` for its blocks."""
        def leaves(n):
            return tuple(torch.zeros((n,) + shape, dtype=self.dtype, device=self.device)
                         for shape in row_shapes)

        c = {"blocks": leaves(self.arch.n_layers - self.n_prefix)}
        if self.n_prefix:
            c["prefix"] = leaves(self.n_prefix)
        return c

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, Any]:
        """Dense per-slot caches: ``(k, v)`` of ``(n, batch, max_seq, Kv,
        dh)`` each, or for MLA ``(c_kv, k_rope)`` of ``(n, batch, max_seq,
        kv_lora)`` and ``(n, batch, max_seq, qk_rope)``."""
        a = self.arch.attn
        if a.kind == "mla":
            m = a.mla
            return self._caches([(batch, max_seq, m.kv_lora_rank), (batch, max_seq, m.qk_rope_dim)])
        shape = (batch, max_seq, a.n_kv_heads, a.d_head)
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
        shape = (n_pool, page, a.n_kv_heads, a.d_head)
        return self._caches([shape, shape])

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
    def prefill(self, p, batch: Dict[str, Any]):
        """Forward over the prompt: (last-position logits, cache of the
        prompt, StepAux).  The cache holds, under ``"blocks"`` (and
        ``"prefix"`` for a dense prefix), the prompt's K/V as ``(n, B, S,
        Kv, dh)`` tensors, or MLA's ``(c_kv, k_rope)`` as ``(n, B, S,
        kv_lora)`` and ``(n, B, S, qk_rope)``.  batch: tokens (B, S) or the
        stub's ``embeds`` (B, S, d); for the ``vlm`` family optionally
        ``mrope_positions`` (3, B, S)."""
        arch = self.arch
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
                )
                caches.append(c)
                auxes.append(aux)
            return x, tuple(torch.stack(leaf) for leaf in zip(*caches)), auxes

        cache, prefix_auxes = {}, []
        if self.n_prefix:
            x, cache["prefix"], prefix_auxes = walk(x, p["prefix_blocks"], False)
        x, cache["blocks"], auxes = walk(x, p["blocks"], moe)
        h = apply_norm(p["final_norm"], x, arch.norm)
        logits = self._logits(p, h[:, -1:, :])
        return logits, cache, _aggregate_aux(prefix_auxes, auxes)

    def decode_step(self, p, batch: Dict[str, Any], cache: Dict[str, Any]):
        """One-token step.  batch: tokens (B, 1), position (B,), optional
        sieve and ``mrope_positions`` (3, B, 1), and for a paged cache
        ``block_tables``/``pool_owner``/``pool_pos``.  Writes the step's K/V
        (MLA: its ``(c_kv, k_rope)`` row) into ``cache`` in place, the dense
        prefix's before the main blocks', and returns ``(logits, cache,
        StepAux)``."""
        arch = self.arch
        x, mrope = self._embed_in(p, batch)
        position = batch["position"]
        moe = arch.moe is not None
        paged = None
        if "block_tables" in batch:
            paged = (batch["block_tables"], batch["pool_owner"], batch["pool_pos"])

        def walk(x, blocks, leaves, moe):
            auxes = []
            for i, blk in enumerate(blocks):
                x, aux = tf.attn_mlp_block_decode(
                    blk, x, position, tuple(leaf[i] for leaf in leaves), arch, moe,
                    sieve=batch.get("sieve"), paged=paged, mrope_positions=mrope,
                )
                auxes.append(aux)
            return x, auxes

        prefix_auxes = []
        if self.n_prefix:
            x, prefix_auxes = walk(x, p["prefix_blocks"], cache["prefix"], False)
        x, auxes = walk(x, p["blocks"], cache["blocks"], moe)
        h = apply_norm(p["final_norm"], x, arch.norm)
        return self._logits(p, h), cache, _aggregate_aux(prefix_auxes, auxes)
