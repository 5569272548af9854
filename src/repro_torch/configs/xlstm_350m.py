"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 (no FFN) vocab=50304,
mLSTM + sLSTM blocks (7:1). [arXiv:2405.04517; unverified]
(a copy of ``repro.configs.xlstm_350m``).

Runs ``long_500k``: pure recurrent state, O(1) decode memory.
"""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    period=("mlstm", "mlstm", "mlstm", "slstm",
            "mlstm", "mlstm", "mlstm", "mlstm"),
    mlp_kind="none",
    mlstm_proj=2,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="xlstm-350m-smoke",
    family="ssm",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=256,
    period=("mlstm", "mlstm", "mlstm", "slstm",
            "mlstm", "mlstm", "mlstm", "mlstm"),
    mlp_kind="none",
    mlstm_proj=2,
    tie_embeddings=True,
    dtype="float32",
)
