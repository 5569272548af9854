"""Per-weight saliency scores (lower score ⇒ pruned first).  Only the
magnitude score is ported; the Hessian-based scores wait for the prune
slice (ROADMAP.md)."""

from __future__ import annotations

import torch


def magnitude_score(w: torch.Tensor) -> torch.Tensor:
    return torch.abs(w)
