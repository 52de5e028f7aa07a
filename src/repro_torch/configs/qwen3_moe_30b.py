"""qwen3-moe-30b-a3b — 48L d_model=2048 32H (GQA kv=4, d_head=128)
d_ff(expert)=768, vocab=151936, MoE 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B; hf]

The port's copy of ``repro.configs.qwen3_moe_30b``: the paper's primary
eval model, served on the cost-driven sieve dual path.
"""

from .base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    d_ff=6144,  # not used: every layer is MoE (d_expert below)
    vocab_size=151936,
    attn=AttnConfig(kind="gqa", n_heads=32, n_kv_heads=4, d_head=128,
                    rope_theta=1e6),
    moe=MoEConfig(
        n_experts=128, top_k=8, d_expert=768, n_shared=0,
        expert_exec="dual_path_cost",
    ),
    norm="rmsnorm",
    act="swiglu",
    pos="rope",
    source="hf:Qwen/Qwen3-30B-A3B",
)
