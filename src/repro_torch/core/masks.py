"""Pruning masks: boolean tensors, **True = pruned** (the paper's
convention).  Selection takes the lowest-score weights."""

from __future__ import annotations

import torch


def nm_mask_from_scores(scores: torch.Tensor, n_prune: int,
                        m_group: int) -> torch.Tensor:
    """Prune the ``n_prune`` lowest-score weights in every group of
    ``m_group`` consecutive weights along the last axis.  Ties go to the
    lower position, as ``lax.top_k`` on the negated scores does in the
    reference (a stable sort gives the same order on every device)."""
    r, c = scores.shape
    if c % m_group:
        raise ValueError(f"cols {c} not divisible by M={m_group}")
    g = scores.reshape(r, c // m_group, m_group)
    order = torch.sort(g, dim=-1, stable=True).indices[..., :n_prune]
    mask = torch.zeros(g.shape, dtype=torch.bool, device=scores.device)
    mask.scatter_(-1, order, True)
    return mask.reshape(r, c)
