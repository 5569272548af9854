"""Algorithm 1 — accurate post-training pruning (paper Sec. 4.2/4.3; a
port of ``repro.core.pruner``).

Method names follow the paper: first letter = mask solution, second =
compensation solution.

  SS  SparseGPT (baseline; sequential freezing)
  SM  𝔖 mask (Eq. 14 scores) + 𝔐 compensation (Eq. 13)   ← paper's pick
  MS  𝔐 mask (Eq. 12 combos) + 𝔖 compensation             [N:M only]
  MM  𝔐 mask + 𝔐 compensation                             [N:M only]
  magnitude / wanda  score-only baselines (no compensation)

Block loop (SM / MM): the accumulated mask grows block by block, and 𝔐
compensation re-solves Eq. (13) against the FULL accumulated mask each
block — earlier pruned weights stay exactly zero while every unpruned
weight keeps being refined.

``prune_linears`` is the serve CLI's magnitude 2:4 pass over a model's
linears (no Hessian needed).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.core import masks as masks_lib
from repro_torch.core import mrp, scores, sparsegpt
from repro_torch.core.clock import no_clock
from repro_torch.core.hessian import dampened_inverse
from repro_torch.core.sparsity import SparsitySpec

METHODS = ("magnitude", "wanda", "SS", "SM", "MS", "MM")

# the seven linears of a dense swiglu block, as serve.sparse packs them
LINEARS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
           ("mlp", "wi"), ("mlp", "wg"), ("mlp", "wo"))


@dataclasses.dataclass
class PruneResult:
    w: torch.Tensor       # pruned + compensated weights
    mask: torch.Tensor    # True = pruned
    # the reconstruction error of the result: a float, or a 0-dim device
    # tensor from a ``sync=False`` solve
    loss: Union[float, torch.Tensor]
    method: str
    spec: SparsitySpec
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def sparsity(self) -> float:
        return masks_lib.sparsity_of(self.mask)


def reconstruction_error(w0: torch.Tensor, w1: torch.Tensor,
                         h: torch.Tensor) -> float:
    """‖(w1−w0) x‖²/T = ½ tr(δw H δwᵀ) — the paper's objective."""
    return float(reconstruction_error_traced(w0, w1, h))


def reconstruction_error_traced(w0: torch.Tensor, w1: torch.Tensor,
                                h: torch.Tensor) -> torch.Tensor:
    """:func:`reconstruction_error` left on the device (no host sync)."""
    dw = (w1 - w0).float()
    return 0.5 * torch.einsum("ij,jk,ik->", dw, h.float(), dw)


# ----------------------------------------------------------------------
def _score_mask_block(wblk: torch.Tensor, h: torch.Tensor,
                      hinv: torch.Tensor, spec: SparsitySpec,
                      score_name: str, col0: int,
                      row_balanced: bool = False) -> torch.Tensor:
    """Solution 𝔖 mask for one column block (Eq. 14 / baselines)."""
    s = wblk.shape[1]
    hs = h[col0:col0 + s, col0:col0 + s]
    hinvs = hinv[col0:col0 + s, col0:col0 + s]
    sc = scores.compute_score(score_name, wblk, hs, hinvs)
    if spec.is_semi_structured:
        return masks_lib.nm_mask_from_scores(sc, spec.n, spec.m)
    if row_balanced:
        return masks_lib.unstructured_mask_rowwise(
            sc, spec.pruned_per_row_block(s))
    nppb = int(round(wblk.shape[0] * s * spec.rate))
    return masks_lib.unstructured_mask_from_scores(sc, nppb)


def prune_matrix(w: torch.Tensor, h: torch.Tensor,
                 spec: Union[str, SparsitySpec], method: str = "SM",
                 blocksize: int = 128, gamma: float = 0.01,
                 score: Optional[str] = None,
                 row_chunk: Optional[int] = None,
                 row_balanced: bool = False, clock=no_clock,
                 sync: bool = True) -> PruneResult:
    """Prune one linear layer's weight matrix, on w's device.  w: (n, m)
    paper orientation (y = w x); h: (m, m) f32 calibration Hessian.

    ``row_balanced=True`` selects an exact per-row pruned count instead
    of the per-block global count.  ``clock`` (a ``StageClock``) times the
    stages: inverse, mask, compensation, recon_error.

    ``sync=False`` (the pipelined scheduler; the reference's
    ``_prune_one(sync=False)``) leaves ``loss`` and the block losses as
    device tensors, so that the solve never waits on the card.  N:M and
    row-balanced specs then run without a host sync; an unstructured
    global count still sizes its padded solve on the host."""
    if isinstance(spec, str):
        spec = SparsitySpec.parse(spec)
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    if method in ("MS", "MM") and not spec.is_semi_structured:
        raise ValueError(
            f"Solution 𝔐 mask is combinatorial — N:M only (paper Sec. "
            f"4.2.1); got method={method} with unstructured {spec}")
    n, m = w.shape
    blocksize = min(blocksize, m)
    if m % blocksize:
        raise ValueError(f"m={m} must be divisible by blocksize={blocksize}")
    spec.validate_block(blocksize)
    w = w.contiguous()      # a transposed (in, out) store arrives as a view

    def result(w_new, mask, stats=None) -> PruneResult:
        with clock("recon_error"):
            err = reconstruction_error_traced(w, w_new, h)
        return PruneResult(w_new, mask, float(err) if sync else err, method,
                           spec, stats or {})

    # --- score-only baselines -------------------------------------------
    if method in ("magnitude", "wanda"):
        with clock("mask"):
            sc = scores.compute_score(method, w, h, None)
            if spec.is_semi_structured:
                mask = masks_lib.nm_mask_from_scores(sc, spec.n, spec.m)
            elif row_balanced:
                mask = masks_lib.unstructured_mask_rowwise(
                    sc, int(round(m * spec.rate)))
            else:
                mask = masks_lib.unstructured_mask_from_scores(
                    sc, int(round(n * m * spec.rate)))
        return result(w.masked_fill(mask, 0.0), mask)

    # --- SparseGPT (𝔖𝔖) --------------------------------------------------
    if method == "SS":
        with clock("compensation"):
            w_new, mask, _ = sparsegpt.sparsegpt_prune(w, h, spec, blocksize,
                                                       gamma)
        return result(w_new, mask)

    with clock("inverse"):
        hinv = dampened_inverse(h, gamma)

    # --- 𝔐𝔖: combo mask + SparseGPT compensation (N:M only) -------------
    if method == "MS":
        with clock("mask"):
            mask = mrp.select_nm_mask_mrp(w, hinv, spec.n, spec.m)
        with clock("compensation"):
            w_new, _, _ = sparsegpt.sparsegpt_prune(
                w, h, spec, blocksize, gamma, mask_override=mask)
        return result(w_new, mask)

    # --- 𝔖𝔐 / 𝔐𝔐: Algorithm 1 block loop with MRP compensation ----------
    score_name = score or "obs"
    static_rows = spec.is_semi_structured or row_balanced
    per_blk = spec.pruned_per_row_block(blocksize) if static_rows else None
    mask_acc = torch.zeros((n, m), dtype=torch.bool, device=w.device)
    w_cur = w
    # each block re-solves against the FULL accumulated mask, so the
    # final solve's loss is the honest summary (not a sum over blocks)
    block_losses = []
    for b in range(m // blocksize):
        c0, c1 = b * blocksize, (b + 1) * blocksize
        wblk = w_cur[:, c0:c1]
        with clock("mask"):
            if method == "SM":
                mblk = _score_mask_block(wblk, h, hinv, spec, score_name, c0,
                                         row_balanced)
            else:  # MM
                mblk = mrp.select_nm_mask_mrp(wblk, hinv[c0:c1, c0:c1],
                                              spec.n, spec.m)
            mask_acc[:, c0:c1] = mblk
        with clock("compensation"):
            k_max = (b + 1) * per_blk if static_rows else None
            # static rows prune exactly k_max columns each: no padding
            w_cur, loss_rows = mrp.mrp_compensate_mask(
                w_cur, hinv, mask_acc, k_max=k_max, row_chunk=row_chunk,
                exact=static_rows)
            block_losses.append(torch.sum(loss_rows))
    losses = ([float(x) for x in block_losses] if sync
              else list(block_losses))
    return result(w_cur, mask_acc, {"final_mrp_loss": losses[-1],
                                    "block_mrp_losses": tuple(losses)})


# ----------------------------------------------------------------------
def prune_linears(params, spec: Union[str, SparsitySpec] = "2:4",
                  linears=LINEARS):
    """Magnitude-prune ``linears`` — (sub, key) pairs, by default the seven
    of a dense block — of every layer in place to an N:M spec: a MoE
    layer's attention and shared expert, its routed experts staying dense
    (they are served dense, as the reference serves them); a recurrent
    model passes its own (``LM.block_linears``).  The weights are stored
    (in, out), so each is pruned as ``wᵀ``: the groups of M then run along
    the input dim, the axis compress_24 packs."""
    if isinstance(spec, str):
        spec = SparsitySpec.parse(spec)
    if not spec.is_semi_structured:
        raise ValueError(f"prune_linears packs N:M specs, got {spec}")
    for layer in [*params.get("prefix", []), *params["layers"]]:
        if "shared" in layer.get("moe", {}):
            layer = {**layer, "mlp": layer["moe"]["shared"]}
        for sub, name in linears:
            if sub in layer and name in layer[sub]:
                w = layer[sub][name].T
                mask = masks_lib.nm_mask_from_scores(
                    scores.magnitude_score(w), spec.n, spec.m)
                layer[sub][name] = w.masked_fill(mask, 0.0).T.contiguous()
    return params
