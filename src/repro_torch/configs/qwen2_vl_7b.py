"""qwen2-vl-7b — VLM backbone, 28L d_model=3584 28H (GQA kv=4, d_head=128)
d_ff=18944 vocab=152064, M-RoPE (temporal/height/width = 16/24/24),
dynamic resolution.  [arXiv:2409.12191; hf]

The vision frontend is a STUB: ``LM.stub_inputs`` makes precomputed
patch embeddings that stand in for the token stream; M-RoPE position ids
arrive as a (3, batch, seq) tensor.

The port's copy of ``repro.configs.qwen2_vl_7b``.
"""

from .base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    d_ff=18944,
    vocab_size=152064,
    attn=AttnConfig(
        kind="gqa", n_heads=28, n_kv_heads=4, d_head=128, qkv_bias=True,
        rope_theta=1e6, mrope_sections=(16, 24, 24),
    ),
    norm="rmsnorm",
    act="swiglu",
    pos="mrope",
    modality_stub="vision_patches",
    source="arXiv:2409.12191",
)
