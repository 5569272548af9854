"""Pruning masks (a port of ``repro.core.masks``): boolean tensors,
**True = pruned** (the paper's convention).  Selection takes the
lowest-score weights.

Tie order is the reference's on every device: ``jnp.argsort`` is stable
and ``lax.top_k`` on negated scores puts the lower index first, so every
selection here is a stable ascending sort.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ----------------------------------------------------------------------
# Unstructured: exact-count selection within a (n, S) column block
# ----------------------------------------------------------------------
def unstructured_mask_from_scores(scores: torch.Tensor,
                                  num_prune: int) -> torch.Tensor:
    """Prune exactly ``num_prune`` weights with the smallest scores,
    selected globally across the (n, S) block (rows may lose different
    counts — SparseGPT's per-block thresholding)."""
    n, s = scores.shape
    if num_prune <= 0:
        return torch.zeros((n, s), dtype=torch.bool, device=scores.device)
    if num_prune >= n * s:
        return torch.ones((n, s), dtype=torch.bool, device=scores.device)
    order = torch.sort(scores.reshape(-1), stable=True).indices
    mask = torch.zeros(n * s, dtype=torch.bool, device=scores.device)
    mask[order[:num_prune]] = True
    return mask.reshape(n, s)


def unstructured_mask_rowwise(scores: torch.Tensor,
                              per_row: int) -> torch.Tensor:
    """Prune exactly ``per_row`` lowest-score weights in every row."""
    n, s = scores.shape
    if per_row <= 0:
        return torch.zeros((n, s), dtype=torch.bool, device=scores.device)
    if per_row >= s:
        return torch.ones((n, s), dtype=torch.bool, device=scores.device)
    idx = torch.sort(scores, dim=1, stable=True).indices[:, :per_row]
    mask = torch.zeros((n, s), dtype=torch.bool, device=scores.device)
    return mask.scatter_(1, idx, True)


# ----------------------------------------------------------------------
# Semi-structured N:M from per-weight scores (Solution 𝔖 mask)
# ----------------------------------------------------------------------
def nm_mask_from_scores(scores: torch.Tensor, n_prune: int,
                        m_group: int) -> torch.Tensor:
    """Prune the ``n_prune`` lowest-score weights in every group of
    ``m_group`` consecutive weights along the last axis."""
    r, c = scores.shape
    if c % m_group:
        raise ValueError(f"cols {c} not divisible by M={m_group}")
    g = scores.reshape(r, c // m_group, m_group)
    order = torch.sort(g, dim=-1, stable=True).indices[..., :n_prune]
    mask = torch.zeros(g.shape, dtype=torch.bool, device=scores.device)
    mask.scatter_(-1, order, True)
    return mask.reshape(r, c)


# ----------------------------------------------------------------------
# Padded per-row index extraction (for the batched MRP solve)
# ----------------------------------------------------------------------
def padded_row_indices(mask: torch.Tensor, k_max: int):
    """Per-row pruned column indexes, padded to ``k_max``.

    Returns (idx (n, k_max) int64, valid (n, k_max) bool): real indices
    first, in column order; the padding tail holds unpruned columns.
    ``k_max`` must be ≥ the largest per-row count (callers size it)."""
    n, m = mask.shape
    k_max = int(k_max)
    cols = torch.arange(m, device=mask.device)[None, :]
    key = torch.where(mask, cols, cols + m)
    order = torch.sort(key, dim=1, stable=True).indices[:, :k_max]
    counts = mask.sum(dim=1)
    valid = torch.arange(k_max, device=mask.device)[None, :] < counts[:, None]
    return order, valid


def max_row_count(mask: torch.Tensor) -> int:
    """Largest pruned-per-row count (a host sync)."""
    return int(mask.sum(dim=1).max().item())


def bucket_k(k: int, step: int = 32) -> int:
    """Round k up to a bucket (the reference bounds jit recompiles)."""
    if k <= 0:
        return step
    return int(math.ceil(k / step) * step)


def validate_nm(mask, n_prune: int, m_group: int) -> bool:
    """Check that every group of M has exactly N pruned (host-side)."""
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    r, c = mask.shape
    g = np.asarray(mask).reshape(r, c // m_group, m_group)
    return bool((g.sum(-1) == n_prune).all())


def sparsity_of(mask: torch.Tensor) -> float:
    return float(mask.float().mean().item())
