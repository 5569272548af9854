"""2:4-sparse weight packing for serving.

After N:M pruning, matrices are 50% zeros in every 4-row group along the
input dim — exactly the layout ``kernels.ops.compress_24`` packs.  Packed
leaves become ``{"vals": (K/2, N), "idx": (K/2, N) int8}``;
``models.layers.linear`` dispatches them to the nm_spmm kernels, so the
same model code serves dense or sparse weights.
"""

from __future__ import annotations

import re
from typing import Any, Sequence, Tuple

import torch

from repro_torch.kernels import ops

# matmuls worth packing by default: the FFN + attention projections
DEFAULT_SPARSE_PATTERNS = (
    r"(mlp|moe/shared)/(wi|wg|wo)$",
    r"attn/(wq|wk|wv|wo)$",
)


def linear_patterns(linears: Sequence[Tuple[str, str]]) -> Tuple[str, ...]:
    """Packing patterns for (sub, key) linears, such as a recurrent
    model's ``LM.block_linears()``, which the defaults leave dense (as the
    reference's do): ``("mlstm", "wq")`` → ``mlstm/wq$``."""
    return tuple(rf"{sub}/{key}$" for sub, key in linears)


def is_24_sparse(w: torch.Tensor) -> bool:
    """≤2 nonzeros in every 4-row group along the input dim of a (K, N)
    matrix — reduced on the tensor's device; only the verdict is read."""
    if w.dim() != 2 or w.shape[0] % 4:
        return False
    g = w.reshape(w.shape[0] // 4, 4, w.shape[1])
    return bool(((g != 0).sum(dim=1) <= 2).all())


def pack_24(w: torch.Tensor) -> dict:
    """One dense 2:4 (K, N) leaf → the packed ``{"vals", "idx"}`` dict."""
    vals, idx = ops.compress_24(w)
    return {"vals": vals, "idx": idx}


def is_packed(leaf) -> bool:
    """True for a :func:`pack_24` output."""
    return isinstance(leaf, dict) and set(leaf) == {"vals", "idx"}


def count_packed(params: Any) -> int:
    """Number of packed leaves in a param tree."""
    if is_packed(params):
        return 1
    if isinstance(params, dict):
        return sum(count_packed(v) for v in params.values())
    if isinstance(params, list):
        return sum(count_packed(v) for v in params)
    return 0


def compressed_param_tree(params: Any,
                          patterns: Sequence[str] = DEFAULT_SPARSE_PATTERNS
                          ) -> Any:
    """The serve engine's load hook: every leaf whose path matches
    ``patterns`` and verifies as 2:4 is packed; packed leaves pass
    through and everything else (biases, norms, embeddings, dense
    matmuls of an unpruned model) is returned as is.  Paths are the
    reference's with the layer index in place of ``s0``
    (``layers/3/attn/wq``)."""
    regs = [re.compile(p) for p in patterns]

    def walk(node, path):
        if is_packed(node):
            return node
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        if any(r.search(path) for r in regs) and is_24_sparse(node):
            return pack_24(node)
        return node

    return walk(params, "")
