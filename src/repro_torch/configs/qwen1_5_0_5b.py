"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936, QKV bias, tied embeddings. [hf:Qwen/Qwen1.5-0.5B; hf]
(a copy of ``repro.configs.qwen1_5_0_5b``)."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    period=("attn",),
    mlp_kind="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    skip_shapes={
        "long_500k": "full attention — quadratic at 524k",
    },
)

SMOKE = ArchConfig(
    name="qwen1.5-0.5b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    period=("attn",),
    mlp_kind="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    dtype="float32",
)
