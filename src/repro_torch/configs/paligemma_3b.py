"""paligemma-3b [vlm] — gemma-2b backbone (18L d_model=2048 8H MQA kv=1
d_ff=16384) + SigLIP patch-embedding frontend STUB, vocab=257216.
[arXiv:2407.07726; hf]

The modality frontend is a stub: ``input_specs`` provides precomputed
SigLIP patch embeddings (B, 256, 1152) which the model projects into
d_model and prepends as a bidirectional prefix (prefix-LM attention, as
in the paper).  A copy of
``repro.configs.paligemma_3b``.
"""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    period=("attn",),
    mlp_kind="geglu",
    embed_scale=True,
    tie_embeddings=True,
    frontend="patch",
    frontend_dim=1152,          # SigLIP so400m features
    frontend_len=256,           # 224px / 14px patches = 16x16
    skip_shapes={
        "long_500k": "full attention — quadratic at 524k",
    },
)

SMOKE = ArchConfig(
    name="paligemma-3b-smoke",
    family="vlm",
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
    frontend="patch",
    frontend_dim=32,
    frontend_len=8,
    dtype="float32",
)
