"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
(a copy of ``repro.configs.gemma3_12b``)."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    # 5 sliding-window layers followed by 1 global layer, repeated
    period=("attn_local",) * 5 + ("attn",),
    window=1024,
    mlp_kind="geglu",
    qk_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    remat="full",
    skip_shapes={
        "long_500k": "global layers are full attention — quadratic at 524k",
    },
)

SMOKE = ArchConfig(
    name="gemma3-12b-smoke",
    family="dense",
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    period=("attn_local",) * 5 + ("attn",),
    window=8,
    mlp_kind="geglu",
    qk_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    dtype="float32",
)
