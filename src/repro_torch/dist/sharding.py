"""Sharding rules as rank-local slicing (a port of ``repro.dist.sharding``
without its FSDP branch and its MoE dispatch specs).

In the reference a rule is a ``NamedSharding`` that tells the compiler
where each block of an array lives.  Here every process is one rank and
holds only its own block, so a rule names which dim splits over an axis
and a rank takes its contiguous block of that dim.

The prune and train paths:

  - ``row_sharding``: weight rows over ``model`` (the row-parallel layer
    solve, Remark 4.2);
  - ``batch_sharding``: rows of the global batch over the data (+pod)
    axes, pod outer — the reference's ``P(("pod", "data"))`` order;
  - ``replicated``: the whole tensor.

Tensor-parallel serving (the resident-weights layout, ``fsdp_axes=()``):

  - :func:`param_split` / :func:`param_specs` — the reference's
    ``param_specs`` rule, leaf by leaf, for the dense decoders' leaves:
    the dim of a leaf that splits over ``model``, or None.
    Up-projections (``_COL_PARALLEL``) split their out dim, ``wo`` its in
    dim (the Megatron pairing, one all-reduce a block); the embedding is
    vocab-parallel;
    the router and every vector stay whole; a dim that does not divide
    stays whole; ``head_dim`` keeps whole heads on every rank for the
    attention projections.  2:4-packed ``vals`` / ``idx`` take their
    projection's rule; a row-parallel split of them takes rows
    ``[r·K/(2·tp), …)`` and needs ``K/tp % 4 == 0`` besides (``idx``
    holds positions inside a group of 4 rows), else the leaf stays whole;
  - :func:`shard_params` — each rank's blocks, sliced once into fresh
    contiguous tensors (the kernels refuse views, and the tensor-core
    decode route wants 16-byte-aligned ``vals``);
  - :func:`kv_head_split` — the paged pool and the dense decode cache
    split their KV heads over ``model`` when they divide; where the
    reference's dense cache falls back to splitting ``hd``, the port
    keeps it whole (the same numbers).  The
    serve engine's burst state and a host-arena page blob staged for
    swap-in stay whole on every rank (the reference's replicated
    ``decode_state_specs`` / ``host_arena_stage_spec``): the arena takes
    its page shapes from the rank's pool leaves.

The reference's ``moe_dispatch_specs`` (expert parallelism), the FSDP
branch of ``param_specs``, its rules for the other families' leaves
(experts, the recurrent blocks' projections, a frontend) and its
recurrent caches' rules come with those families' tensor parallelism
(ROADMAP.md); until then ``LM.serve_tp`` refuses them under tp > 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.dist.api import axis_size
from repro_torch.dist.mesh import dp_axes_of

# Param-path patterns the reference keeps out of FSDP: the embedding and
# the LM head (kept here for the FSDP port; parameters are replicated)
FSDP_EXCLUDE_EMBED: Tuple[str, ...] = ("embed/tok", "unembed/head")


@dataclasses.dataclass(frozen=True)
class Shard:
    """Block ``index`` of ``count`` equal contiguous blocks of dim 0."""

    index: int
    count: int

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n``; the rows must divide."""
        if n % self.count:
            raise ValueError(f"{n} rows do not divide into {self.count} "
                             "shards")
        k = n // self.count
        return slice(self.index * k, (self.index + 1) * k)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x`` (a view)."""
        return x[self.rows(x.shape[0])]


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axes_shard(mesh, axes) -> Shard:
    """This rank's block over ``axes`` (one axis or several, the first
    outermost): its mesh coordinates read as one row-major index."""
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for a in _axes(axes):
        size = axis_size(mesh, a)
        index = index * size + coord[mesh.mesh_dim_names.index(a)]
        count *= size
    return Shard(index, count)


def replicated(mesh) -> Shard:
    """The whole tensor on every rank."""
    return Shard(0, 1)


def row_sharding(mesh, axis="model") -> Shard:
    """Dim 0 over ``axis`` (one mesh axis, or a tuple like ``("pod",
    "data")``): the layout of the row-parallel layer solve."""
    return axes_shard(mesh, axis)


def batch_spec(mesh, dp_axes: Optional[Sequence[str]] = None
               ) -> Tuple[str, ...]:
    """The mesh axes the batch dim is split over (the reference's
    ``P(entry)``'s entry, as a tuple; ``()`` when there is none)."""
    if dp_axes is None:
        dp_axes = dp_axes_of(mesh)
    return tuple(a for a in dp_axes if a in mesh.mesh_dim_names)


def batch_sharding(mesh, dp_axes: Optional[Sequence[str]] = None) -> Shard:
    """This rank's rows of the global batch (:func:`batch_spec`'s axes)."""
    axes = batch_spec(mesh, dp_axes)
    return axes_shard(mesh, axes) if axes else Shard(0, 1)


# ----------------------------------------------------------------------
# Tensor-parallel serving: the parameter rule
# ----------------------------------------------------------------------
# (in, out) linears whose OUT dim splits over model (column-parallel)
_COL_PARALLEL = frozenset({"wq", "wk", "wv", "wi", "wg", "head"})
# (in, out) linears whose IN dim is the model-parallel contraction
_ROW_PARALLEL = frozenset({"wo"})


def param_split(path: str, shape: Sequence[int], tp: int,
                head_dim: Optional[int] = None) -> Optional[int]:
    """The dim of the leaf at ``path`` (the port's, ``layers/3/attn/wq`` or
    ``layers/3/mlp/wo/vals``) that splits over a model axis of ``tp``
    ranks, or None: the reference's ``param_specs`` with ``fsdp_axes=()``,
    for an unstacked leaf."""
    if tp <= 1:
        return None
    parts = path.split("/")
    key = parts[-1]
    packed = (key in ("vals", "idx") and len(parts) >= 2
              and (parts[-2] in _COL_PARALLEL or parts[-2] in _ROW_PARALLEL))
    if packed:
        parts = parts[:-1]
        key = parts[-1]
    shape = tuple(shape)

    def fits(dim: int) -> Optional[int]:
        return dim if shape[dim] % tp == 0 else None

    if key == "tok" and len(shape) == 2:
        return fits(0)                                 # vocab-parallel
    if len(shape) == 2 and key in _COL_PARALLEL:
        if (head_dim is not None and key in ("wq", "wk", "wv")
                and (shape[1] // tp) % head_dim):
            return None                                # a head would split
        return fits(1)
    if len(shape) == 2 and key in _ROW_PARALLEL:
        parent = parts[-2] if len(parts) >= 2 else ""
        k_full = shape[0] * (2 if packed else 1)
        if (head_dim is not None and parent == "attn"
                and (k_full // tp) % head_dim):
            return None
        if packed and (k_full // tp) % 4:
            return None          # a rank's rows would cut a group of 4
        return fits(0)
    return None                  # the f32 router, vectors: whole


def _walk(tree: Any, path: str, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, f"{path}/{k}" if path else str(k), fn)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, f"{path}/{i}" if path else str(i), fn)
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params: Any, tp: int,
                head_dim: Optional[int] = None) -> Any:
    """:func:`param_split` over a param tree: the tree of split dims
    (None: whole)."""
    return _walk(params, "", lambda path, leaf: param_split(
        path, leaf.shape, tp, head_dim))


def model_shard(mesh, tp_axis: str = "model") -> Shard:
    """This rank's block over the model axis (``Shard(0, 1)`` without
    one)."""
    if mesh is None or tp_axis not in mesh.mesh_dim_names:
        return Shard(0, 1)
    return axes_shard(mesh, tp_axis)


def take_block(t: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    """Block ``shard.index`` of ``shard.count`` of ``t`` along ``dim``, as
    a fresh contiguous tensor (never a view of ``t``)."""
    n = t.shape[dim] // shard.count
    return t.narrow(dim, shard.index * n, n).clone(
        memory_format=torch.contiguous_format)


def shard_params(params: Any, mesh=None, *, head_dim: Optional[int] = None,
                 tp_axis: str = "model") -> Any:
    """This rank's params under :func:`param_split`: a split leaf becomes
    its block, a fresh contiguous tensor; a whole leaf is kept as it is.
    ``mesh=None`` takes the active context's; without a context, or with
    a model axis of 1, the tree comes back unchanged."""
    if mesh is None:
        from repro_torch.dist.api import current_ctx

        ctx = current_ctx()
        if ctx is None:
            return params
        mesh = ctx.mesh
    shard = model_shard(mesh, tp_axis)
    if shard.count == 1:
        return params

    def place(path, leaf):
        dim = param_split(path, leaf.shape, shard.count, head_dim)
        return leaf if dim is None else take_block(leaf, dim, shard)

    return _walk(params, "", place)


# ----------------------------------------------------------------------
# Tensor-parallel serving: the cache rules (rank-local layouts)
# ----------------------------------------------------------------------
def kv_head_split(num_kv_heads: int, tp: int) -> Optional[int]:
    """The split dim over a model axis of ``tp`` of an attention cache
    leaf — a paged pool's (num_pages, page_size, KV, hd) and its int8
    scale (num_pages, page_size, KV), or a dense decode cache's (B, S,
    KV, hd): the KV heads when they divide, else None.  The reference's
    ``paged_kv_block_specs`` has no other split; where its
    ``decode_cache_block_specs`` splits ``hd`` instead, the port keeps the
    leaf whole — a rank computes its heads' attention from whole K / V,
    the same numbers.  The page dims never split: every rank holds the
    same block tables."""
    return 2 if tp > 1 and num_kv_heads % tp == 0 else None
