"""SparseGPT (Frantar & Alistarh 2023) — the SRP-based 𝔖𝔖 baseline, and
Solution 𝔖 compensation under a given mask (𝔐𝔖).  A port of
``repro.core.sparsegpt``.

  Hinv  = chol_upper( (H + γI)⁻¹ )          # upper Cholesky factor U
  per column block [i1:i2):
    per column i (left→right):
      select pruned entries (by w²/U_ii² within block, or per N:M group)
      q     = w_i with pruned slots zeroed
      err_i = (w_i − q) / U_ii
      w[:, i:] −= err_i ⊗ U[i, i:]          # frozen left, updated right
    w[:, i2:] −= Err_block @ U[i1:i2, i2:]  # lazy trailing update

The per-column loop is sequential (each step reads the weights the
previous step wrote); here it is a Python loop of small tensor ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.sparsity import SparsitySpec


def cholesky_inv_upper(h: torch.Tensor, gamma: float = 0.01) -> torch.Tensor:
    """U with (H + γ·mean(diag)·I)⁻¹ = Uᵀ U  (SparseGPT's ``Hinv``)."""
    m = h.shape[0]
    damp = torch.clamp(gamma * torch.mean(torch.diagonal(h)), min=1e-8)
    eye = torch.eye(m, dtype=torch.float32, device=h.device)
    hd = (h + damp * eye).float()
    hinv = torch.cholesky_solve(eye, torch.linalg.cholesky_ex(hd).L)
    return torch.linalg.cholesky_ex(hinv, upper=True).L


def _column_step(w1: torch.Tensor, err1: torch.Tensor, mask1: torch.Tensor,
                 u1: torch.Tensor, i: int) -> None:
    """One inner column update in place; mask1 column i decides pruning."""
    wcol = w1[:, i]
    q = torch.where(mask1[:, i], torch.zeros_like(wcol), wcol)
    err = (wcol - q) / u1[i, i]
    w1[:, i + 1:] -= err[:, None] * u1[i, i + 1:][None, :]
    w1[:, i] = q
    err1[:, i] = err


def _sparsegpt_core(w: torch.Tensor, u: torch.Tensor,
                    mask_override: Optional[torch.Tensor], blocksize: int,
                    prune_n: int, prune_m: int, num_prune_per_block: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blocked sequential SparseGPT. Returns (w_new, mask, per-block loss)."""
    n, m = w.shape
    w = w.float().clone()
    u = u.float()
    nblocks = m // blocksize
    mask_all = torch.zeros((n, m), dtype=torch.bool, device=w.device)
    losses = torch.zeros((nblocks,), dtype=torch.float32, device=w.device)
    for b in range(nblocks):
        i1, i2 = b * blocksize, (b + 1) * blocksize
        w1 = w[:, i1:i2].clone()
        u1 = u[i1:i2, i1:i2]
        udiag = torch.diagonal(u1)
        if mask_override is not None:
            mask1 = mask_override[:, i1:i2].clone()
        elif prune_n == 0:
            # unstructured: threshold w²/U_jj² within the block, exact count
            scores = (w1 ** 2) / (udiag[None, :] ** 2)
            order = torch.sort(scores.reshape(-1), stable=True).indices
            mask1 = torch.zeros(n * blocksize, dtype=torch.bool,
                                device=w.device)
            mask1[order[:num_prune_per_block]] = True
            mask1 = mask1.reshape(n, blocksize)
        else:
            mask1 = torch.zeros((n, blocksize), dtype=torch.bool,
                                device=w.device)
        err1 = torch.zeros((n, blocksize), dtype=torch.float32,
                           device=w.device)
        for i in range(blocksize):
            if mask_override is None and prune_n > 0 and i % prune_m == 0:
                # the group's mask from the *current* (compensated) weights
                sc = (w1[:, i:i + prune_m] ** 2) / (
                    udiag[i:i + prune_m][None, :] ** 2)
                idx = torch.sort(sc, dim=1, stable=True).indices[:, :prune_n]
                mg = torch.zeros((n, prune_m), dtype=torch.bool,
                                 device=w.device)
                mask1[:, i:i + prune_m] = mg.scatter_(1, idx, True)
            _column_step(w1, err1, mask1, u1, i)
        # lazy trailing update: w[:, i2:] -= Err1 @ U[i1:i2, i2:]
        w[:, i2:] -= err1 @ u[i1:i2, i2:]
        w[:, i1:i2] = w1
        mask_all[:, i1:i2] = mask1
        losses[b] = 0.5 * torch.sum(err1 ** 2)
    w = w.masked_fill(mask_all, 0.0)
    return w, mask_all, losses


def sparsegpt_prune(w: torch.Tensor, h: torch.Tensor, spec: SparsitySpec,
                    blocksize: int = 128, gamma: float = 0.01,
                    mask_override: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full SparseGPT (𝔖𝔖), or 𝔖-compensation under a given mask (𝔐𝔖).
    Returns (w_pruned, mask, per-block losses)."""
    n, m = w.shape
    blocksize = min(blocksize, m)
    if m % blocksize:
        raise ValueError(f"cols {m} must divide by blocksize {blocksize}")
    spec.validate_block(blocksize)
    u = cholesky_inv_upper(h, gamma)
    if spec.is_semi_structured:
        pn, pm, nppb = spec.n, spec.m, 0
    else:
        pn = pm = 0
        nppb = int(round(n * blocksize * spec.rate))
    w_new, mask, losses = _sparsegpt_core(w, u, mask_override, blocksize,
                                          pn, pm, nppb)
    return w_new.to(w.dtype), mask, losses
