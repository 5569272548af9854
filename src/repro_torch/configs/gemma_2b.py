"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000, GeGLU, head_dim=256. [arXiv:2403.08295; hf]
(a copy of ``repro.configs.gemma_2b``)."""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    period=("attn",),
    mlp_kind="geglu",
    embed_scale=True,
    tie_embeddings=True,
    skip_shapes={
        "long_500k": "full attention — quadratic at 524k",
    },
)

SMOKE = ArchConfig(
    name="gemma-2b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=256,
    vocab_size=256,
    period=("attn",),
    mlp_kind="geglu",
    embed_scale=True,
    tie_embeddings=True,
    dtype="float32",
)
