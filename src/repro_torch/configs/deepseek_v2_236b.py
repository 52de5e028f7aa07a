"""deepseek-v2-236b — 60L d_model=5120 128H, MLA kv_lora=512,
d_ff(expert)=1536, vocab=102400, MoE 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]

The port's copy of ``repro.configs.deepseek_v2_236b``: the first layer is
dense (d_ff=12288), the other 59 MoE, as in the DeepSeek-V2 paper.  MLA's
compressed latent KV cache (kv_lora + rope = 576 values per token and
layer) replaces the per-head K/V.  Ships ``expert_exec="dense"``, as the
reference does; serving runs choose the sieve dual path explicitly.
"""

from .base import ArchConfig, AttnConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    d_ff=12288,  # the dense (first_k_dense) layers
    vocab_size=102400,
    attn=AttnConfig(
        kind="mla",
        n_heads=128,
        n_kv_heads=128,
        d_head=128,
        rope_theta=1e4,
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_dim=128,
            qk_rope_dim=64,
            v_head_dim=128,
        ),
    ),
    moe=MoEConfig(
        n_experts=160, top_k=6, d_expert=1536, n_shared=2, first_k_dense=1
    ),
    norm="rmsnorm",
    act="swiglu",
    pos="rope",
    source="arXiv:2405.04434",
)
