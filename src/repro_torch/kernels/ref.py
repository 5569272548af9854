"""Plain PyTorch versions of the kernels (the allclose ground truth, and
the path every wrapper takes for a CPU tensor).

Each function runs the op sequence of its counterpart in the JAX
package's ``kernels/ref.py``, so on f32 inputs the port's CPU path and
the reference agree to rounding.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# the C(4,2) pruning pairs of a 2:4 group, in the reference's order (the
# argmin over them takes the first minimum)
NM_COMBOS_24 = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))

# ----------------------------------------------------------------------
# 2:4 compressed format
# ----------------------------------------------------------------------
def compress_24(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (K, N) with 2:4 sparsity along K → (vals (K/2,N), idx (K/2,N)).

    Every group of 4 consecutive K-rows holds ≤2 nonzeros per column; the
    two kept entries' in-group positions go to ``idx`` (int8, ascending),
    the values to ``vals``.  A group with fewer than 2 nonzeros pads its
    unused slot with position 0 and value 0.
    """
    k, n = w.shape
    if k % 4:
        raise ValueError(f"K={k} must divide by 4")
    g = w.reshape(k // 4, 4, n)
    nz = g != 0
    rank = torch.cumsum(nz.to(torch.int32), dim=1) * nz    # 1,2 at kept slots
    pos = torch.arange(4, dtype=torch.int32, device=w.device)[None, :, None]
    four = torch.full_like(rank, 4)
    idx0 = torch.where(rank == 1, pos, four).amin(dim=1)
    idx1 = torch.where(rank == 2, pos, four).amin(dim=1)
    idx0c = torch.where(idx0 == 4, 0, idx0)
    idx1c = torch.where(idx1 == 4, 0, idx1)
    v0 = torch.gather(g, 1, idx0c[:, None, :].long())[:, 0, :]
    v1 = torch.gather(g, 1, idx1c[:, None, :].long())[:, 0, :]
    v0 = torch.where(idx0 == 4, torch.zeros_like(v0), v0)
    v1 = torch.where(idx1 == 4, torch.zeros_like(v1), v1)
    vals = torch.stack([v0, v1], dim=1).reshape(k // 2, n)
    idx = torch.stack([idx0c, idx1c], dim=1).reshape(k // 2, n).to(torch.int8)
    return vals, idx


def decompress_24(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(K/2, N) pairs → dense (K, N).  The two slots of a group are
    SUMMED into their positions: a padding slot (position 0, value 0)
    must not overwrite a real value kept at position 0."""
    k2, n = vals.shape
    g = k2 // 2
    v = vals.reshape(g, 2, n)
    ix = idx.reshape(g, 2, n).to(torch.int32)
    r = torch.arange(4, dtype=torch.int32, device=vals.device)[None, :, None]
    hit = (ix[:, :, None, :] == r[:, None, :, :]).to(vals.dtype)
    dense = torch.sum(v[:, :, None, :] * hit, dim=1)        # (g, 4, n)
    return dense.reshape(g * 4, n)


def activate(y: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """The decode-epilogue activation: None | "silu" | "gelu" (the tanh
    approximation, ``jax.nn.gelu``'s default)."""
    if activation is None:
        return y
    if activation == "silu":
        return F.silu(y)
    if activation == "gelu":
        return F.gelu(y, approximate="tanh")
    raise ValueError(f"unknown epilogue activation {activation!r}")


def nm_spmm_ref(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                activation: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ decompress(vals, idx) + bias). x: (..., K) → (..., N)
    f32.  On f32 inputs this equals the dense ``x @ w`` bit for bit."""
    w = decompress_24(vals, idx)
    y = x.float() @ w.float()
    if bias is not None:
        y = y + bias.reshape(-1).float()
    return activate(y, activation)


# ----------------------------------------------------------------------
# pruning-pass kernels
# ----------------------------------------------------------------------
def hessian_accum_ref(x: torch.Tensor) -> torch.Tensor:
    """H = 2 · x xᵀ for x (m, T) — f32."""
    x32 = x.float()
    return 2.0 * (x32 @ x32.T)


def hessian_accum_weighted_ref(x: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """H = 2 · x·diag(w)·xᵀ for x (m, T), w (T,) — f32, the weights
    applied to the left operand as the reference's ``x32 * w32``."""
    x32 = x.float()
    return 2.0 * ((x32 * w.float()[None, :]) @ x32.T)


def nm_select_losses(w: torch.Tensor, hinv: torch.Tensor) -> torch.Tensor:
    """Eq. (12) loss ½·w·A⁻¹·wᵀ of each of the 6 pruning pairs of every
    2:4 group, with A the pair's 2×2 block of Hinv inverted in closed
    form.  w: (R, C); hinv: (C, C) (only its 4×4 diagonal blocks are
    read) → (R, C/4, 6) f32, in the reference's operation order."""
    r, c = w.shape
    g = c // 4
    w32 = w.float().reshape(r, g, 4)
    cols = (torch.arange(g, device=w.device) * 4)[:, None] + torch.arange(
        4, device=w.device)[None, :]
    hg = hinv[cols[:, :, None], cols[:, None, :]].float()          # (g,4,4)
    losses = []
    for p, q in NM_COMBOS_24:
        app = hg[:, p, p][None]
        aqq = hg[:, q, q][None]
        apq = hg[:, p, q][None]
        wp = w32[:, :, p]
        wq = w32[:, :, q]
        det = app * aqq - apq * apq
        losses.append(
            0.5 * (wp * wp * aqq - 2 * wp * wq * apq + wq * wq * app) / det)
    return torch.stack(losses, dim=-1)


def nm_select_ref(w: torch.Tensor, hinv: torch.Tensor) -> torch.Tensor:
    """Solution 𝔐 2:4 mask via Eq. (12): w (R, C) paper orientation,
    hinv (C, C) → bool mask (R, C), True = pruned, exactly 2 per group
    of 4 (the first minimum in ``NM_COMBOS_24`` order on ties)."""
    r, c = w.shape
    best = torch.argmin(nm_select_losses(w, hinv), dim=-1)          # (r,g)
    # position f is pruned iff the winning pair holds it (no constant
    # table: nothing crosses from the host)
    pos = []
    for f in range(4):
        hits = [ci for ci, pair in enumerate(NM_COMBOS_24) if f in pair]
        pos.append((best == hits[0]) | (best == hits[1]) | (best == hits[2]))
    return torch.stack(pos, dim=-1).reshape(r, c)


# ----------------------------------------------------------------------
def _einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with jnp's type promotion (bf16 × f32 → f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(spec, a.to(dt), b.to(dt))


def paged_attn_ref(q: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, block_tables: torch.Tensor,
                   lengths: torch.Tensor, window: Optional[int] = None,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged GQA decode: gather each request's pages contiguous, then the
    einsum/softmax sequence of ``models.layers._sdpa``.

    q: (B, KV, G, hd); k/v_pages: (P, page_size, KV, hd); block_tables:
    (B, P_max) int32; lengths: (B,).  Returns (B, KV, G, hd) in v's
    dtype, f32 for dequantized int8 pages (idle rows, length 0, are garbage — the
    kernel writes zeros there and callers mask them).  ``k_scale`` /
    ``v_scale`` (P, page_size, KV) f32 dequantize int8 pages row-wise
    right after the gather.
    """
    b, kvh, g, hd = q.shape
    _, page_size, _, _ = k_pages.shape
    p_max = block_tables.shape[1]
    s_len = p_max * page_size
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, s_len, kvh, hd)
    v = v_pages[bt].reshape(b, s_len, kvh, hd)
    if k_scale is not None:
        ks = k_scale[bt].reshape(b, s_len, kvh)
        vs = v_scale[bt].reshape(b, s_len, kvh)
        k = k.float() * ks[..., None]
        v = v.float() * vs[..., None]
    qg = q[:, None]                                    # (B, 1, KV, G, hd)
    scores = _einsum("btkgd,bskd->bkgts", qg, k).float()
    scores = scores / math.sqrt(hd)
    kpos = torch.arange(s_len, dtype=torch.int32, device=q.device)[None, :]
    lengths = lengths.to(torch.int32)
    ok = kpos < lengths[:, None]
    if window is not None:
        ok &= kpos >= lengths[:, None] - window
    scores = torch.where(ok[:, None, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = _einsum("bkgts,bskd->btkgd", probs, v)
    return out[:, 0]                                   # (B, KV, G, hd)


# ----------------------------------------------------------------------
# full-sequence attention
# ----------------------------------------------------------------------
def flash_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, window: Optional[int] = None,
                   prefix_len: Optional[int] = None) -> torch.Tensor:
    """q: (BH, T, D), k, v: (BH, S, D), S = T when causal.  Plain softmax
    attention, f32 output.  A causal ``window`` lets query t see keys s
    with t - window < s ≤ t, and a causal ``prefix_len`` adds the keys
    s < prefix_len for every query (the reference's ``causal_mask``);
    both are ignored without ``causal``, as the reference ignores them."""
    t, d = q.shape[1], q.shape[2]
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        if window is not None:
            mask = mask & ~torch.tril(mask, diagonal=-window)
        if prefix_len:
            mask[:, :prefix_len] = True
        s = s.masked_fill(~mask[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bts,bsd->btd", p, v.float())
