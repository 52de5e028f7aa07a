"""Architecture configuration schema and registry (port's copy).

Counterpart of ``repro.configs.base``, cut to what the port serves: the
decoder-only ``moe``, ``dense`` and ``vlm`` families with GQA attention
(M-RoPE and the vision-patch stub included) or DeepSeek-V2's MLA, and
MoE models' leading dense blocks (``first_k_dense``); the ``hybrid``
(Mamba2 with a shared attention block), ``ssm`` (RWKV6) and ``audio``
(encoder-decoder, audio-frame stub) families.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class AttnConfig:
    kind: str = "gqa"  # "gqa" | "mla" | "none"
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1e6
    mla: Optional[MLAConfig] = None
    # Qwen2-VL M-RoPE: head-dim split across (temporal, height, width)
    mrope_sections: Optional[Tuple[int, int, int]] = None


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    first_k_dense: int = 0  # leading dense layers (DeepSeek-V2: 1)
    capacity_factor: float = 1.25
    # Decode batches are tiny; a capacity floor keeps serving drop-free
    # (cap = min(T, min_capacity) lower bound).
    min_capacity: int = 8
    router_aux_coef: float = 0.01
    # "dense" | "dual_path" | "dual_path_cost" — see repro.configs.base
    expert_exec: str = "dense"
    # tail threshold tau: experts with <= tau buffered rows stream through
    # the tail GEMV (the paper's PIM side)
    dual_tail_tokens: int = 1
    # head compaction budget H (0 = no budget, H = E)
    dual_max_head: int = 0


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"  # "mamba2" | "rwkv6"
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    # rwkv6
    decay_lora: int = 64
    wkv_chunk: int = 128


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # "moe" | "dense" | "vlm" | "hybrid" | "ssm" | "audio"
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: AttnConfig = field(default_factory=AttnConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    act: str = "swiglu"  # "swiglu" | "gelu"
    pos: str = "rope"  # "rope" | "mrope" | "learned" | "none"
    tie_embeddings: bool = False
    # encoder-decoder (whisper)
    encdec: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500  # encoder positions of the decode shapes (whisper)
    # hybrid (zamba2): one shared attention+MLP block applied every
    # ``attn_every`` backbone blocks (weights shared across applications)
    attn_every: int = 0
    # modality frontends are stubs: the model takes precomputed frame or
    # patch embeddings instead of raw audio or pixels
    modality_stub: Optional[str] = None  # "audio_frames" | "vision_patches"
    source: str = ""
    notes: str = ""

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (same numbers as
        ``repro.configs.base.ArchConfig.reduced``)."""
        a = self.attn
        kw: dict = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            d_ff=128,
            vocab_size=256,
        )
        if a.kind != "none":
            kw["attn"] = dataclasses.replace(
                a,
                n_heads=4,
                n_kv_heads=min(max(a.n_kv_heads, 1), 2) if a.kind == "gqa" else 0,
                d_head=16,
                mla=MLAConfig(
                    q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                    v_head_dim=16,
                )
                if a.mla is not None
                else None,
                mrope_sections=(4, 2, 2) if a.mrope_sections else None,
            )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=2, d_expert=32,
                n_shared=min(self.moe.n_shared, 1),
                first_k_dense=min(self.moe.first_k_dense, 1),
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, decay_lora=8, wkv_chunk=16
            )
        if self.encdec:
            kw["enc_layers"] = 2
            kw["enc_seq"] = 16
        if self.attn_every:
            kw["attn_every"] = 2
            kw["n_layers"] = 5
        kw.update(overrides)
        return dataclasses.replace(self, **kw)


_MODULE_OF = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "granite-3-2b": "granite_3_2b",
    "qwen1.5-0.5b": "qwen15_0_5b",
    "granite-3-8b": "granite_3_8b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "zamba2-7b": "zamba2_7b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-base": "whisper_base",
}


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULE_OF:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_MODULE_OF)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_OF[name]}")
    return mod.CONFIG
