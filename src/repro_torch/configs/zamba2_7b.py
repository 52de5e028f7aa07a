"""zamba2-7b — 81 blocks, d_model=3584, Mamba2 backbone (ssm_state=64) with
a SHARED attention+MLP block (32H, d_ff=14336) applied every 6th position.
vocab=32000.  [arXiv:2411.15242; unverified]

The port's copy of ``repro.configs.zamba2_7b``.  Block layout: 81 // 6 =
13 segments of [shared attention + 5 Mamba2] plus a 3-block Mamba2 tail —
13 shared-attention applications and 68 Mamba2 blocks (81 total).
"""

from .base import ArchConfig, AttnConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab_size=32000,
    attn=AttnConfig(kind="gqa", n_heads=32, n_kv_heads=32, d_head=112,
                    rope_theta=1e4),
    ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, expand=2,
                  conv_width=4),
    attn_every=6,
    norm="rmsnorm",
    act="swiglu",
    pos="rope",
    source="arXiv:2411.15242",
    notes="shared attention block weights reused at every application",
)
