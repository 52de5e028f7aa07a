"""qwen1.5-0.5b — dense MHA with QKV bias, 24L d_model=1024 16H (kv=16,
d_head=64) d_ff=2816 vocab=151936.  [hf:Qwen/Qwen1.5-0.5B; hf]

The port's copy of ``repro.configs.qwen15_0_5b``.
"""

from .base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    d_ff=2816,
    vocab_size=151936,
    attn=AttnConfig(kind="gqa", n_heads=16, n_kv_heads=16, d_head=64,
                    qkv_bias=True, rope_theta=1e4),
    norm="rmsnorm",
    act="swiglu",
    pos="rope",
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
