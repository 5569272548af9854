"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 (+1 shared, DeepSeek-V3 style).
Trillion-parameter MoE (paper-table). [arXiv:2501.kimi2; unverified]
(a copy of ``repro.configs.kimi_k2_1t_a32b``)."""

from repro_torch.models.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,                   # per-expert FFN width (the assigned d_ff)
    vocab_size=163840,
    period=("attn",),
    mlp_kind="swiglu",
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048, num_shared=1),
    moe_slots=(0,),              # every layer is MoE
    remat="full",
    skip_shapes={
        "long_500k": "full attention — quadratic at 524k",
    },
)

SMOKE = ArchConfig(
    name="kimi-k2-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=256,
    period=("attn",),
    mlp_kind="swiglu",
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32, num_shared=1),
    moe_slots=(0,),
    dtype="float32",
)
