"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct; hf]
(a copy of ``repro.configs.phi3_5_moe_42b_a6_6b``)."""

from repro_torch.models.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    period=("attn",),
    mlp_kind="swiglu",
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
    moe_slots=(0,),
    remat="full",
    skip_shapes={
        "long_500k": "full attention — quadratic at 524k",
    },
)

SMOKE = ArchConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    period=("attn",),
    mlp_kind="swiglu",
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64),
    moe_slots=(0,),
    dtype="float32",
)
