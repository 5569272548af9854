"""Sharding rules as rank-local slicing (a port of ``repro.dist.sharding``
without its FSDP branch).

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
    ``param_specs`` rule, leaf by leaf: the dim of a leaf that splits
    over ``model``, or None.  Up-projections split their out dim, the
    down-projections (``wo``, ``out_proj``) their in dim (the Megatron
    pairing, one all-reduce a block); the embedding is vocab-parallel;
    the router and the attention's and MLP's vectors stay whole; a dim
    that does not divide stays whole; the attention projections — the
    self-attention's and the cross-attention's (``xattn``), the
    encoder's as the decoder's — keep whole heads of ``cfg.hd`` on every
    rank; a modality frontend's ``frontend_proj`` is column-parallel (its
    output all-gathered, ``models.layers.frontend_apply``); the encoder's
    final norm stays whole.  2:4-packed ``vals`` /
    ``idx`` take their projection's rule; a row-parallel split of them
    takes rows ``[r·K/(2·tp), …)`` and needs ``K/tp % 4 == 0`` besides
    (``idx`` holds positions inside a group of 4 rows), else the leaf
    stays whole and the layer all-gathers its input;
  - a rank-local rule holds for a whole block: a rank that holds its
    d_inner channels or its heads holds the weights, vectors and state
    rows of exactly those.  So a recurrent block decides once
    (:func:`block_splits`, the reference's state rule: Mamba when
    d_inner divides, the mLSTM in whole heads, the sLSTM in whole heads
    of a d_model that divides) and its leaves follow; where it does not
    split, every rank computes it whole with no collective.  Where the
    reference's layout is one GSPMD can run and a rank-local program
    cannot, the port's differs (:data:`RANK_LOCAL`): Mamba's vectors,
    conv taps and ``a_log``, the mLSTM's gate biases and the sLSTM's
    recurrences and forget bias take the rank's channels or heads (the
    reference keeps them whole), Mamba's ``x_proj`` is row-parallel
    (dt, B and C come out whole and bit-equal on every rank; the
    reference splits its out dim) and its ``in_proj`` gives a rank its
    block of x AND of z (:func:`shard_params`);
  - the experts (E, ·, ·) split E over ``model`` when it divides (the
    reference's shard_map condition): a rank holds E / tp of them; the
    router stays whole, so every rank routes the same bits;
    :func:`token_shards` are the reference's ``moe_dispatch_specs``
    token blocks, each routed on its own;
  - :func:`shard_params` — each rank's blocks, sliced once into fresh
    contiguous tensors (the kernels refuse views, and the tensor-core
    decode route wants 16-byte-aligned ``vals``);
  - :func:`kv_head_split` — the paged pool and the dense decode cache
    split their KV heads over ``model`` when they divide; where the
    reference's dense cache falls back to splitting ``hd``, the port
    keeps it whole (the same numbers); :func:`state_split` — the
    recurrent blocks' state rows (``paged_state_block_specs``, for the
    dense cache too: the reference's dense rule splits inside an mLSTM
    or sLSTM head, which a rank cannot compute).  The serve engine's
    burst state and a host-arena page blob staged for swap-in stay whole
    on every rank (the reference's replicated ``decode_state_specs`` /
    ``host_arena_stage_spec``): the arena takes its page shapes from the
    rank's pool leaves.

The FSDP branch of ``param_specs`` comes with the trainer's model axis
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
_COL_PARALLEL = frozenset({"wq", "wk", "wv", "wi", "wg", "wz", "wf",
                           "wo_gate", "in_proj", "dt_proj", "x_proj",
                           "frontend_proj", "head"})
# (in, out) linears whose IN dim is the model-parallel contraction
_ROW_PARALLEL = frozenset({"wo", "out_proj"})
# the blocks whose leaves follow one decision of the block (state_split)
STATE_KINDS = ("mamba", "mlstm", "slstm")
# a split recurrent block's leaves whose rank-local dim differs from the
# reference's param_specs (fsdp_axes=()), block → {leaf: dim}; its other
# leaves take the reference's dim (up-projections 1, down-projections 0,
# the norm whole).  The reference replicates the vectors and the 3-D
# recurrences (GSPMD would run a whole vector against a split operand;
# a rank cannot) and splits x_proj's out dim (GSPMD re-lays its operand
# out; here dt, B and C must come out whole on every rank)
RANK_LOCAL = {
    "mamba": {"conv_w": 0, "conv_b": 0, "dt_bias": 0, "a_log": 0, "d": 0,
              "x_proj": 0},
    "mlstm": {"bi": 0, "bf": 0},
    "slstm": {"r_z": 0, "r_i": 0, "r_f": 0, "r_o": 0, "bf": 0},
}


def block_splits(kind: str, cfg, tp: int) -> bool:
    """Whether a recurrent block of ``kind`` splits over a model axis of
    ``tp``: the reference's state rule (``paged_state_block_specs``),
    which every leaf and state row of the block then follows — Mamba
    over d_inner, the mLSTM in whole heads, the sLSTM in whole heads of
    a d_model that divides."""
    if tp <= 1:
        return False
    if kind == "mamba":
        return cfg.d_inner % tp == 0
    if kind == "mlstm":
        return cfg.num_heads % tp == 0
    if kind == "slstm":
        return cfg.num_heads % tp == 0 and cfg.d_model % tp == 0
    raise ValueError(kind)


def param_split(path: str, shape: Sequence[int], tp: int,
                cfg) -> Optional[int]:
    """The dim of the leaf at ``path`` (the port's, ``layers/3/attn/wq`` or
    ``layers/3/mlp/wo/vals``) of the model of config ``cfg`` that splits
    over a model axis of ``tp`` ranks, or None: the reference's
    ``param_specs`` with ``fsdp_axes=()`` and ``head_dim=cfg.hd``, for an
    unstacked leaf, with the rank-local rules of :data:`RANK_LOCAL` for
    the recurrent blocks.  A recurrent block's leaves follow
    :func:`block_splits`; the experts (E, ·, ·) split E when it
    divides."""
    if tp <= 1:
        return None
    head_dim = cfg.hd
    parts = path.split("/")
    key = parts[-1]
    packed = (key in ("vals", "idx") and len(parts) >= 2
              and (parts[-2] in _COL_PARALLEL or parts[-2] in _ROW_PARALLEL))
    if packed:
        parts = parts[:-1]
        key = parts[-1]
    shape = tuple(shape)
    block = parts[-2] if len(parts) >= 2 else ""

    def fits(dim: int) -> Optional[int]:
        return dim if shape[dim] % tp == 0 else None

    if block in STATE_KINDS:
        if not block_splits(block, cfg, tp):
            return None
        dim = RANK_LOCAL[block].get(key, 1 if key in _COL_PARALLEL else
                                    0 if key in _ROW_PARALLEL else None)
        if dim == 0 and packed and (shape[0] * 2 // tp) % 4:
            return None          # a rank's rows would cut a group of 4
        return dim
    if block == "moe" and len(shape) == 3 and key in ("wi", "wg", "wo"):
        return fits(0)                                 # the rank's experts
    if key == "tok" and len(shape) == 2:
        return fits(0)                                 # vocab-parallel
    if len(shape) == 2 and key in _COL_PARALLEL:
        if key in ("wq", "wk", "wv") and (shape[1] // tp) % head_dim:
            return None                                # a head would split
        return fits(1)
    if len(shape) == 2 and key in _ROW_PARALLEL:
        k_full = shape[0] * (2 if packed else 1)
        if block in ("attn", "xattn") and (k_full // tp) % head_dim:
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


def param_specs(params: Any, tp: int, cfg) -> Any:
    """:func:`param_split` over a param tree: the tree of split dims
    (None: whole)."""
    return _walk(params, "", lambda path, leaf: param_split(
        path, leaf.shape, tp, cfg))


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


def shard_params(params: Any, mesh=None, *, cfg, tp_axis: str = "model"
                 ) -> Any:
    """This rank's params under :func:`param_split` for the model of
    config ``cfg``: a split leaf becomes its block, a fresh contiguous
    tensor; a whole leaf is kept as it is.  Mamba's ``in_proj`` is x | z
    side by side, and a rank takes its block of each half.  A leaf that
    already is this rank's block (this function's output: a tree that
    another engine on the same mesh sharded) is kept as it is, so that
    sharding twice shards once.  ``mesh=None`` takes the active
    context's; without a context, or with a model axis of 1, the tree
    comes back unchanged."""
    if mesh is None:
        from repro_torch.dist.api import current_ctx

        ctx = current_ctx()
        if ctx is None:
            return params
        mesh = ctx.mesh
    shard = model_shard(mesh, tp_axis)
    if shard.count == 1:
        return params

    mark = (shard.index, shard.count)

    def place(path, leaf):
        if getattr(leaf, "rank_block", None) == mark:
            return leaf                           # already this rank's
        dim = param_split(path, leaf.shape, shard.count, cfg)
        if dim is None:
            return leaf
        if "/mamba/in_proj" in f"/{path}":                   # x | z
            block = torch.cat([take_block(half, dim, shard)
                               for half in leaf.chunk(2, dim)], dim=dim)
        else:
            block = take_block(leaf, dim, shard)
        block.rank_block = mark
        return block

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


def state_split(kind: str, cfg, tp: int) -> Dict[str, Optional[int]]:
    """The split dim of each state leaf of a recurrent block over a model
    axis of ``tp`` — the reference's ``paged_state_block_specs``, for the
    slot-pooled rows of continuous mode and the dense decode cache alike
    (leading dim: slots or batch, never split): Mamba's ``conv`` (·,
    ck-1, Di) and ``ssm`` (·, Di, N) over d_inner; the mLSTM's ``c`` (·,
    NH, hd, hd), ``n`` (·, NH, hd), ``m`` (·, NH) over whole heads; the
    sLSTM's ``c`` / ``n`` / ``h`` / ``m`` (·, D) over d_model in whole
    heads.  None everywhere where :func:`block_splits` keeps the block
    whole.  The reference's dense-cache rule splits the mLSTM's head dim
    and the sLSTM's d_model without the head condition; a rank computes
    whole heads, so the port takes the paged rule for both caches."""
    dims = {"mamba": {"conv": 2, "ssm": 1},
            "mlstm": {"c": 1, "n": 1, "m": 1},
            "slstm": {k: 1 for k in "cnhm"}}[kind]
    split = block_splits(kind, cfg, tp)
    return {k: (d if split else None) for k, d in dims.items()}


# ----------------------------------------------------------------------
# Tensor-parallel serving: the expert-parallel dispatch
# ----------------------------------------------------------------------
def token_shards(n: int, dp: int, split_rows: bool) -> List[slice]:
    """The blocks of a call's ``n`` tokens that an expert-parallel
    dispatch routes each on its own, its capacity from the block's
    count.  The reference's shard_map route routes ``dp`` contiguous
    blocks of the global B·T tokens (``moe_dispatch_specs``' token spec)
    when they divide over the data axes, and the plain route routes them
    as one: a rank whose rows are its data block (``split_rows``) holds
    exactly one block; a rank that holds every row routes all ``dp`` of
    them — with rows that were not split, a boundary may fall inside a
    row — or, where ``n`` does not divide, the call's tokens as one."""
    if split_rows or dp == 1 or n % dp:
        return [slice(0, n)]
    k = n // dp
    return [slice(i * k, (i + 1) * k) for i in range(dp)]
