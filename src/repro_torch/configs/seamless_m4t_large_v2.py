"""seamless-m4t-large-v2 [audio] — enc-dec, 24L enc + 24L dec,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206. [arXiv:2308.11596; hf]

The speech frontend (w2v-BERT conformer feature extractor) is a STUB:
``input_specs`` provides precomputed frame embeddings (B, 1024 frames,
1024) which the encoder stack consumes directly.  A copy of
``repro.configs.seamless_m4t_large_v2``.
"""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,              # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    period=("dec_attn",),
    mlp_kind="gelu",
    encdec=True,
    enc_layers=24,
    frontend="audio",
    frontend_dim=1024,
    frontend_len=1024,          # speech frames after conformer downsampling
    skip_shapes={
        "long_500k": "full-attention decoder — quadratic at 524k",
    },
)

SMOKE = ArchConfig(
    name="seamless-m4t-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    period=("dec_attn",),
    mlp_kind="gelu",
    encdec=True,
    enc_layers=2,
    frontend="audio",
    frontend_dim=32,
    frontend_len=16,
    dtype="float32",
)
