"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]
(a copy of ``repro.configs.qwen3_14b``)."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    period=("attn",),
    mlp_kind="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    remat="full",
)

SMOKE = ArchConfig(
    name="qwen3-14b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    period=("attn",),
    mlp_kind="swiglu",
    qk_norm=True,
    dtype="float32",
)
