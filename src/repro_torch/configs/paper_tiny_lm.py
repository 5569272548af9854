"""paper-tiny-lm — CPU-scale analogue of the paper's evaluation family
(a copy of ``repro.configs.paper_tiny_lm``): the tiny dense LM, its smoke
variant, and ``MAMBA``, the tiny Mamba twin of the paper's Table 3
(Mamba-based LLM) experiments."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="paper-tiny-lm",
    family="dense",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=384,
    vocab_size=512,
    period=("attn",),
    mlp_kind="swiglu",
    dtype="float32",
)

SMOKE = ArchConfig(
    name="paper-tiny-lm-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    period=("attn",),
    mlp_kind="swiglu",
    dtype="float32",
)

# Mamba twin for the paper's Table 3 (Mamba-based LLM) experiments.
MAMBA = ArchConfig(
    name="paper-tiny-mamba",
    family="ssm",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    period=("mamba",),
    mlp_kind="none",
    ssm_state=8,
    dtype="float32",
)
