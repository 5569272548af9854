"""The Multiple Removal Problem (MRP) — the paper's core contribution
(a port of ``repro.core.mrp``).

Closed-form optimal solution (Sec. 4.1). For each row q with pruned
column set P, with Hinv = (2xxᵀ + γI)⁻¹:

  Eq. (13):  δw*[q,:] = − w[q,P] · (Hinv[P,P])⁻¹ · Hinv[P,:]
  Eq. (12):  L*_q     = ½ · w[q,P] · (Hinv[P,P])⁻¹ · w[q,P]ᵀ

Every row's pruned set is padded to a common k_max and solved in one
batched Cholesky solve; identity padding makes the padded solve exactly
the unpadded one.  Unlike the reference, A = Hinv[P,P] is gathered
directly as (rows, k, k) — never through a (rows, k, m) intermediate,
which at Qwen's ``mlp.wo`` would be 16 GB.

The 2:4 mask of Eq. (12) goes through ``kernels.ops.nm_select_mask``: the
``nm_select`` kernel on the card, its closed-form plain version on the
CPU.  Other N:M specs take the reference's batched ``linalg.solve`` over
all combinations.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import masks as masks_lib
from repro_torch.kernels import ops


# ----------------------------------------------------------------------
# Batched padded-row compensation (Solution 𝔐 for compensation)
# ----------------------------------------------------------------------
def _solve_rows(w_rows: torch.Tensor, hinv: torch.Tensor,
                idx: torch.Tensor, valid: torch.Tensor, exact: bool):
    """Eq. (13)/(12) for a chunk of rows: (w_rows + δw, loss per row).
    ``exact``: every slot is valid, so A needs no identity padding."""
    k = idx.shape[1]
    a = hinv[idx[:, :, None], idx[:, None, :]]                  # (c, k, k)
    if not exact:
        vv = valid[:, :, None] & valid[:, None, :]
        eye = torch.eye(k, dtype=a.dtype, device=a.device)
        a = torch.where(vv, a, eye[None])
    wp = torch.where(valid, torch.gather(w_rows, 1, idx),
                     torch.zeros((), dtype=w_rows.dtype, device=w_rows.device))
    # A is a principal submatrix of a PD matrix ⇒ PD ⇒ Cholesky solve
    chol = torch.linalg.cholesky_ex(a).L
    del a
    z = torch.cholesky_solve(wp[..., None], chol)[..., 0]        # (c, k)
    z = torch.where(valid, z, torch.zeros((), dtype=z.dtype, device=z.device))
    loss = 0.5 * torch.sum(z * wp, dim=1)
    zfull = torch.zeros_like(w_rows).scatter_add_(1, idx, z)
    return w_rows - zfull @ hinv, loss


def mrp_compensate(w: torch.Tensor, hinv: torch.Tensor, idx: torch.Tensor,
                   valid: torch.Tensor, row_chunk: Optional[int] = None,
                   exact: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply Eq. (13) compensation for the pruned sets given per row.

    w (n, m); hinv (m, m); idx / valid (n, k_max) per-row pruned columns
    and their validity; ``row_chunk`` bounds the (chunk, k, k) gather;
    ``exact``: every row prunes exactly k_max columns (N:M and
    row-balanced masks), so no slot is padding.
    Returns (w_new in w's dtype with exact zeros at the pruned slots,
    Eq. (12) loss per row (n,) f32)."""
    n, m = w.shape
    w32 = w.float()
    hinv = hinv.float()
    idx = idx.long()
    step = n if row_chunk is None or row_chunk >= n else int(row_chunk)
    outs, losses = [], []
    for r0 in range(0, n, step):
        o, l_ = _solve_rows(w32[r0:r0 + step], hinv, idx[r0:r0 + step],
                            valid[r0:r0 + step], exact)
        outs.append(o)
        losses.append(l_)
    w_new = outs[0] if len(outs) == 1 else torch.cat(outs)
    loss = losses[0] if len(losses) == 1 else torch.cat(losses)
    # exact zeros at the pruned slots (δw cancels w there analytically)
    hits = torch.zeros((n, m), dtype=torch.float32, device=w.device)
    w_new = w_new.masked_fill(hits.scatter_add_(1, idx, valid.float()) > 0,
                              0.0)
    return w_new.to(w.dtype), loss


def mrp_compensate_mask(w: torch.Tensor, hinv: torch.Tensor,
                        mask: torch.Tensor, k_max: Optional[int] = None,
                        row_chunk: Optional[int] = None, exact: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boolean mask (True = pruned) → Eq. (13).  ``k_max`` defaults to the
    bucketed per-row maximum (a host sync); ``exact``: every row prunes
    exactly ``k_max`` columns."""
    if k_max is None:
        k_max = masks_lib.bucket_k(masks_lib.max_row_count(mask))
    k_max = min(int(k_max), mask.shape[1])
    idx, valid = masks_lib.padded_row_indices(mask, k_max)
    return mrp_compensate(w, hinv, idx, valid, row_chunk=row_chunk,
                          exact=exact)


# ----------------------------------------------------------------------
# Eq. (12) losses for N:M combination enumeration (Solution 𝔐 for masks)
# ----------------------------------------------------------------------
def nm_combinations(n_prune: int, m_group: int, device="cpu") -> torch.Tensor:
    """All C(M,N) index combinations, shape (n_combos, N), int64."""
    combos = list(itertools.combinations(range(m_group), n_prune))
    return torch.tensor(np.asarray(combos, dtype=np.int64), device=device)


def nm_group_losses(w: torch.Tensor, hinv: torch.Tensor, n_prune: int,
                    m_group: int) -> torch.Tensor:
    """Eq. (12) loss of every pruning combination in every M-group,
    within-group interactions exact, groups independent (Sec. 4.2.1).
    Returns (n, G, n_combos) f32."""
    n, m = w.shape
    if m % m_group:
        raise ValueError(f"cols {m} not divisible by M={m_group}")
    g = m // m_group
    combos = nm_combinations(n_prune, m_group, w.device)        # (C, N)
    ncombo = combos.shape[0]
    w32 = w.float().reshape(n, g, m_group)
    base = (torch.arange(g, device=w.device) * m_group)[:, None]
    gcols = base + torch.arange(m_group, device=w.device)[None, :]   # (G, M)
    hg = hinv[gcols[:, :, None], gcols[:, None, :]].float()          # (G,M,M)
    a = hg[:, combos[:, :, None], combos[:, None, :]]                # (G,C,N,N)
    wc = w32[:, :, combos]                                           # (n,G,C,N)
    a_b = a[None].expand(n, g, ncombo, n_prune, n_prune)
    z = torch.linalg.solve(a_b, wc[..., None])[..., 0]
    return 0.5 * torch.sum(z * wc, dim=-1)


def select_nm_mask_mrp(w: torch.Tensor, hinv: torch.Tensor, n_prune: int,
                       m_group: int) -> torch.Tensor:
    """Solution 𝔐 mask: per group, the combination minimizing Eq. (12).
    2:4 goes through ``ops.nm_select_mask`` (the ``nm_select`` kernel on
    the card)."""
    n, m = w.shape
    if (n_prune, m_group) == (2, 4):
        return ops.nm_select_mask(w, hinv)
    losses = nm_group_losses(w, hinv, n_prune, m_group)     # (n, G, C)
    best = torch.argmin(losses, dim=-1)                     # (n, G)
    chosen = nm_combinations(n_prune, m_group, w.device)[best]   # (n,G,N)
    mask = torch.zeros((n, m // m_group, m_group), dtype=torch.bool,
                       device=w.device)
    return mask.scatter_(-1, chosen, True).reshape(n, m)


# ----------------------------------------------------------------------
# Literal per-row solution (float64 test oracle; no padding)
# ----------------------------------------------------------------------
def mrp_row_reference(w_row, hinv, pruned_cols):
    """Literal Eq. (13)/(12) for ONE row, in float64 numpy."""
    w_row = np.asarray(w_row, np.float64)
    hinv = np.asarray(hinv, np.float64)
    p = np.asarray(pruned_cols, np.int64)
    if p.size == 0:
        return w_row.copy(), 0.0
    wp = w_row[p]
    a = hinv[np.ix_(p, p)]
    z = np.linalg.solve(a, wp)
    out = w_row - z @ hinv[p, :]
    out[p] = 0.0
    return out, 0.5 * float(wp @ z)
