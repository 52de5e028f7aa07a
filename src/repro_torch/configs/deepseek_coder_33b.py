"""deepseek-coder-33b — dense llama-arch, 62L d_model=7168 56H (GQA kv=8,
d_head=128) d_ff=19200 vocab=32256.  [arXiv:2401.14196; hf]

Dense: Sieve expert partitioning inapplicable (no experts); the dense FFN
is the paper's "N = B" compute-bound case and always runs as plain matrix
products.

The port's copy of ``repro.configs.deepseek_coder_33b``.
"""

from .base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    d_ff=19200,
    vocab_size=32256,
    attn=AttnConfig(kind="gqa", n_heads=56, n_kv_heads=8, d_head=128,
                    rope_theta=1e5),
    norm="rmsnorm",
    act="swiglu",
    pos="rope",
    source="arXiv:2401.14196",
)
