"""rwkv6-7b (Finch) — attention-free, 32L d_model=4096 (64 heads x 64),
channel-mix d_ff=14336, vocab=65536, data-dependent decay.
[arXiv:2404.05892; hf]

The port's copy of ``repro.configs.rwkv6_7b``.
"""

from .base import ArchConfig, AttnConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    attn=AttnConfig(kind="none"),
    ssm=SSMConfig(kind="rwkv6", head_dim=64, decay_lora=64, wkv_chunk=128),
    norm="layernorm",
    act="swiglu",  # channel-mix uses squared-relu internally
    pos="none",
    source="arXiv:2404.05892",
)
