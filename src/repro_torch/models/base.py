"""Architecture configuration shared by the whole model zoo (a copy of
``repro.models.base``: the port imports nothing of the JAX package, and
a test holds the two field by field).

One :class:`ArchConfig` describes any of the assigned architectures:
decoder-only transformers (dense/MoE/local-global), Mamba/xLSTM SSM blocks,
hybrid interleaves, encoder-decoder, and modality-frontend stubs.

Layer structure = ``prefix`` blocks (unrolled) followed by ``periods``
repeats of ``period`` (scanned — keeps the lowered HLO O(one period) deep
regardless of depth).  Block kinds:

  attn         global causal attention
  attn_local   sliding-window attention (cfg.window)
  mamba        Mamba-1 selective SSM
  mlstm        xLSTM matrix-memory block
  slstm        xLSTM scalar-memory block (recurrent mixing)

Each block kind carries its own MLP unless the kind is self-contained
(mamba/mlstm/slstm have none by default; cfg.ssm_mlp adds one).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0           # shared (always-on) experts, DeepSeek-style
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads

    # layer layout
    prefix: Tuple[str, ...] = ()            # unrolled leading blocks
    period: Tuple[str, ...] = ("attn",)     # scanned repeating unit
    # MLP kind per attention block: swiglu | geglu | gelu | none
    mlp_kind: str = "swiglu"
    # which period/prefix slots carry a MoE MLP instead of dense (by kind)
    moe: Optional[MoEConfig] = None
    moe_slots: Tuple[int, ...] = ()         # period slot indices with MoE MLP
    moe_prefix_slots: Tuple[int, ...] = ()

    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None            # for attn_local
    rope_theta: float = 10_000.0
    embed_scale: bool = False               # gemma: h *= sqrt(d_model)
    tie_embeddings: bool = False

    # ssm details
    ssm_state: int = 16                     # mamba N
    ssm_expand: int = 2                     # d_inner = expand * d_model
    ssm_conv: int = 4
    mlstm_proj: int = 2                     # mLSTM up-projection factor
    ssm_mlp: bool = False                   # ssm blocks carry an FFN (jamba)

    # encoder-decoder
    encdec: bool = False
    enc_layers: int = 0

    # modality frontend stub ("patch" | "audio" | None)
    frontend: Optional[str] = None
    frontend_dim: int = 0                   # raw embedding dim from the stub
    frontend_len: int = 0                   # number of frontend positions

    # numerics / training
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "none"                     # none | full
    scan_layers: bool = True                # lax.scan over periods (False:
                                            # unrolled — cost-analysis runs)
    # shapes this arch skips, name -> reason (recorded in EXPERIMENTS.md)
    skip_shapes: Dict[str, str] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------
    def __post_init__(self):
        n_periodic = self.num_layers - len(self.prefix)
        if n_periodic < 0 or (self.period and n_periodic % len(self.period)):
            raise ValueError(
                f"{self.name}: {self.num_layers} layers != "
                f"{len(self.prefix)} prefix + k*{len(self.period)} period")

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def n_periods(self) -> int:
        return (self.num_layers - len(self.prefix)) // len(self.period)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, self.d_model // 16)

    def block_has_mlp(self, kind: str) -> bool:
        if kind in ("attn", "attn_local", "dec_attn", "enc_attn"):
            return self.mlp_kind != "none"
        if kind in ("mamba", "mlstm", "slstm"):
            return self.ssm_mlp and self.mlp_kind != "none"
        return False

    def slot_is_moe(self, slot: int, in_prefix: bool) -> bool:
        if self.moe is None:
            return False
        slots = self.moe_prefix_slots if in_prefix else self.moe_slots
        return slot in slots
