"""Ported architectures: ``get_config(id)`` / ``get_smoke(id)``.

Every architecture of the reference's registry: the dense decoders —
Qwen1.5-0.5B, gemma-2b (head dim 256), Qwen3-14B (qk-norm) and
Gemma3-12B (qk-norm, five sliding-window layers to one global) — the
prefix-LM paligemma-3b (gemma-2b's backbone behind a stubbed SigLIP
patch frontend), the MoE decoders phi3.5-moe (16 experts, top-2) and
kimi-k2 (384 experts, top-8, one shared expert), Jamba's hybrid with its
16 experts, the xLSTM (xlstm-350m: seven mLSTM blocks to one sLSTM), the
encoder-decoder seamless-m4t-large-v2 (a stubbed speech frontend) and
the paper's tiny LM (with its Mamba twin ``paper_tiny_lm.MAMBA``).  Ids
and aliases as the reference's registry.
"""

import importlib

from repro_torch.models.base import ArchConfig

ARCH_IDS = ("qwen3_14b", "gemma3_12b", "qwen1_5_0_5b", "gemma_2b",
            "paligemma_3b", "kimi_k2_1t_a32b", "phi3_5_moe_42b_a6_6b",
            "jamba_1_5_large_398b", "xlstm_350m", "seamless_m4t_large_v2",
            "paper_tiny_lm")

_ALIAS = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIAS.update({
    "qwen3-14b": "qwen3_14b",
    "gemma3-12b": "gemma3_12b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "gemma-2b": "gemma_2b",
    "paligemma-3b": "paligemma_3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "xlstm-350m": "xlstm_350m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
})


def canonical(arch_id: str) -> str:
    key = arch_id.strip()
    if key in ARCH_IDS:
        return key
    if key in _ALIAS:
        return _ALIAS[key]
    raise KeyError(f"unknown arch {arch_id!r}; known: "
                   f"{sorted(_ALIAS)}")


def _module(arch_id: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE


__all__ = ["ARCH_IDS", "canonical", "get_config", "get_smoke"]
