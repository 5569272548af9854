"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave,
MoE every other layer. [arXiv:2403.19887; hf]
(a copy of ``repro.configs.jamba_1_5_large_398b``).

Jamba period = 8 layers: slot 3 is attention, the rest Mamba; every block
carries an FFN (``ssm_mlp``), alternating dense MLP / 16-expert MoE
(``models.moe``).  Its blocks without the experts are
``dataclasses.replace(CONFIG, moe=None, moe_slots=())``, every slot then
carrying its dense SwiGLU FFN.
"""

from repro_torch.models.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    period=("mamba", "mamba", "mamba", "attn",
            "mamba", "mamba", "mamba", "mamba"),
    mlp_kind="swiglu",
    ssm_mlp=True,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
    moe_slots=(1, 3, 5, 7),
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    remat="full",
)

SMOKE = ArchConfig(
    name="jamba-1.5-smoke",
    family="hybrid",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    period=("mamba", "mamba", "mamba", "attn",
            "mamba", "mamba", "mamba", "mamba"),
    mlp_kind="swiglu",
    ssm_mlp=True,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    moe_slots=(1, 3, 5, 7),
    ssm_state=4,
    ssm_expand=2,
    ssm_conv=4,
    dtype="float32",
)
