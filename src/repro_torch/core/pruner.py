"""Magnitude N:M pruning of one matrix and of a model's linears.

``prune_matrix`` makes the two calls that the reference's
``pruner.prune_matrix(method="magnitude")`` makes for an N:M spec —
``scores.magnitude_score`` then ``masks.nm_mask_from_scores`` — on the
tensor's device.  The other five methods (SparseGPT, the paper's 𝔖/𝔐
masks with MRP compensation) wait for the prune slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.core import masks, scores
from repro_torch.core.sparsity import SparsitySpec

# the seven linears of a dense swiglu block, as serve.sparse packs them
LINEARS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
           ("mlp", "wi"), ("mlp", "wg"), ("mlp", "wo"))


def prune_matrix(w: torch.Tensor, spec: Union[str, SparsitySpec],
                 method: str = "magnitude"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prune one weight in paper orientation (out, in), groups of M
    along the input dim.  Returns (pruned w, mask with True = pruned)."""
    if isinstance(spec, str):
        spec = SparsitySpec.parse(spec)
    if method != "magnitude" or not spec.is_semi_structured:
        raise ValueError(f"only magnitude N:M pruning is ported (got "
                         f"{method}, {spec}); ROADMAP.md slice 2 ports "
                         "the rest")
    mask = masks.nm_mask_from_scores(scores.magnitude_score(w), spec.n,
                                     spec.m)
    return torch.where(mask, torch.zeros_like(w), w), mask


def prune_linears(params, spec: Union[str, SparsitySpec] = "2:4"):
    """Magnitude-prune the seven linears of every layer in place.  The
    weights are stored (in, out), so each is pruned as ``wᵀ``: the
    groups of 4 then run along the input dim, the axis compress_24
    packs."""
    for layer in params["layers"]:
        for sub, name in LINEARS:
            if sub in layer and name in layer[sub]:
                w = layer[sub][name]
                layer[sub][name] = prune_matrix(w.T, spec)[0].T.contiguous()
    return params
