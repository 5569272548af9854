"""Ported architectures: ``get_config(id)`` / ``get_smoke(id)``.

Only the dense decoders the serve slice runs are ported; ROADMAP.md
lists the other families.
"""

import importlib

from repro_torch.models.base import ArchConfig

ARCH_IDS = ("qwen1_5_0_5b", "paper_tiny_lm")

_ALIAS = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIAS["qwen1.5-0.5b"] = "qwen1_5_0_5b"


def canonical(arch_id: str) -> str:
    key = arch_id.strip()
    if key in ARCH_IDS:
        return key
    if key in _ALIAS:
        return _ALIAS[key]
    raise KeyError(f"unknown or unported arch {arch_id!r}; ported: "
                   f"{sorted(_ALIAS)}")


def _module(arch_id: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE


__all__ = ["ARCH_IDS", "canonical", "get_config", "get_smoke"]
