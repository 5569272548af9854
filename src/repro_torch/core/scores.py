"""Per-weight saliency scores for pruning-mask selection (Solution 𝔖
family; a port of ``repro.core.scores``).  Lower score ⇒ pruned first.

  - magnitude:  |w|                        (Zhu & Gupta 2017)
  - wanda:      |w| · ‖x_j‖₂               (Sun et al. 2023)
  - obs:        w² / (2 [H⁻¹]_jj)          (paper Eq. 14 — Solution 𝔖)
  - sparsegpt:  w² / [H⁻¹]_jj²             (SparseGPT public code variant)
"""

from __future__ import annotations

import torch


def magnitude_score(w: torch.Tensor) -> torch.Tensor:
    return torch.abs(w)


def wanda_score(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """|w| · ‖x_j‖₂ per input column; diag(H)_j = 2·mean_t x_j², so
    sqrt(diag H) is the norm up to a rank-irrelevant constant."""
    norms = torch.sqrt(torch.clamp(torch.diagonal(h), min=0.0))
    return torch.abs(w) * norms[None, :]


def obs_score(w: torch.Tensor, hinv: torch.Tensor) -> torch.Tensor:
    """Paper Eq. (14): L̂ = w_ij² / (2 [H⁻¹]_jj)."""
    d = torch.clamp(torch.diagonal(hinv), min=1e-30)
    return (w.float() ** 2) / (2.0 * d[None, :])


def sparsegpt_score(w: torch.Tensor, hinv: torch.Tensor) -> torch.Tensor:
    """SparseGPT code's criterion: w² / diag(H⁻¹)²."""
    d = torch.clamp(torch.diagonal(hinv), min=1e-30)
    return (w.float() ** 2) / (d[None, :] ** 2)


SCORE_FNS = {
    "magnitude": lambda w, h, hinv: magnitude_score(w),
    "wanda": lambda w, h, hinv: wanda_score(w, h),
    "obs": lambda w, h, hinv: obs_score(w, hinv),
    "sparsegpt": lambda w, h, hinv: sparsegpt_score(w, hinv),
}


def compute_score(name: str, w: torch.Tensor, h: torch.Tensor,
                  hinv: torch.Tensor) -> torch.Tensor:
    try:
        fn = SCORE_FNS[name]
    except KeyError:
        raise ValueError(f"unknown score {name!r}; one of {sorted(SCORE_FNS)}")
    return fn(w, h, hinv)
