"""granite-3-2b — dense GQA, 40L d_model=2048 32H (kv=8, d_head=64)
d_ff=8192 vocab=49155.  [hf:ibm-granite/granite-3.0-2b-base; hf]

The port's copy of ``repro.configs.granite_3_2b``.
"""

from .base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    d_ff=8192,
    vocab_size=49155,
    attn=AttnConfig(kind="gqa", n_heads=32, n_kv_heads=8, d_head=64,
                    rope_theta=1e4),
    norm="rmsnorm",
    act="swiglu",
    pos="rope",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
