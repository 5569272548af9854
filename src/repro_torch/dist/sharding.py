"""Sharding rules as rank-local slicing (a port of
``repro.dist.sharding``).

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

Training (the reference's ``param_specs`` with ``fsdp_axes``, the
trainer's layout): :func:`param_rule` gives a leaf's :class:`Rule` — its
dim over ``model`` (:func:`param_split`) and its dim over the FSDP axes
(the data (+pod) axes; :func:`fsdp_split`).  A column-parallel kernel
puts FSDP on its in dim, a row-parallel one on its out dim, ``tok`` on
dim 1, an expert stack on its ``d`` dim (``wi`` / ``wg`` dim 1, ``wo``
dim 2), any other matrix on dim 0; the router and the vectors stay
whole, and so does a dim that does not divide.  (The reference's
``fsdp_exclude`` patterns serve its XLA dry run alone, which has no
counterpart here: its trainer passes none.)  Where the port's
model dim of a rank-local leaf (:data:`RANK_LOCAL`) is the reference's
FSDP dim, the leaf stays whole over the data axes (the recurrent blocks
train under a model axis of 1 only, where no leaf has a model dim).
:func:`shard_params` with ``fsdp_axes`` takes a rank's model block, then
its FSDP block of that; :func:`gather_params` is the inverse (over the
FSDP group, then the model group), for checkpoints and tests.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.dist.api import axis_size
from repro_torch.dist.mesh import dp_axes_of

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


def _walk(tree: Any, path: str, fn, *rest):
    """``fn(path, leaf, *rest's leaves)`` over a tree (``rest``: trees of
    the same structure)."""
    if isinstance(tree, dict):
        return {k: _walk(v, f"{path}/{k}" if path else str(k), fn,
                         *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, f"{path}/{i}" if path else str(i), fn,
                                *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def param_specs(params: Any, tp: int, cfg) -> Any:
    """:func:`param_split` over a param tree: the tree of split dims
    (None: whole)."""
    return _walk(params, "", lambda path, leaf: param_split(
        path, leaf.shape, tp, cfg))


# always whole over the FSDP axes, whatever their shape (the f32 router)
_REPLICATED = frozenset({"router"})


@dataclasses.dataclass(frozen=True)
class Rule:
    """Where a leaf splits: ``tp`` its dim over the model axis, ``fsdp``
    its dim over the FSDP axes (None: whole)."""

    tp: Optional[int] = None
    fsdp: Optional[int] = None


def fsdp_split(path: str, shape: Sequence[int], dp: int,
               tp_dim: Optional[int] = None) -> Optional[int]:
    """The dim of the leaf at ``path`` that splits over FSDP axes of
    ``dp`` ranks, or None: the reference's ``param_specs`` FSDP branch
    for an unstacked dense leaf (the trainer's; it packs none) whose
    model dim is ``tp_dim``."""
    if dp <= 1:
        return None
    parts = path.split("/")
    key = parts[-1]
    shape = tuple(shape)
    if len(shape) == 3 and key in ("wi", "wg", "wo") and "moe" in parts:
        dim = 2 if key == "wo" else 1                 # the experts' d
    elif key == "tok" and len(shape) == 2:
        dim = 1
    elif len(shape) == 2 and key in _COL_PARALLEL:
        dim = 0
    elif len(shape) == 2 and key in _ROW_PARALLEL:
        dim = 1
    elif key in _REPLICATED or len(shape) < 2:
        return None
    else:
        dim = 0                                       # any other matrix
    if dim == tp_dim or shape[dim] % dp:
        return None
    return dim


def param_rule(path: str, shape: Sequence[int], cfg, tp: int, dp: int = 1
               ) -> Rule:
    """The :class:`Rule` of the leaf at ``path``: :func:`param_split`
    over a model axis of ``tp``, :func:`fsdp_split` over FSDP axes of
    ``dp``."""
    tp_dim = param_split(path, shape, tp, cfg)
    return Rule(tp_dim, fsdp_split(path, shape, dp, tp_dim))


def param_rules(params: Any, cfg, tp: int, dp: int = 1) -> Any:
    """:func:`param_rule` over a param tree (whole leaves' shapes): the
    tree of :class:`Rule` s."""
    return _walk(params, "", lambda path, leaf: param_rule(
        path, leaf.shape, cfg, tp, dp))


def grad_sums(rules: Any) -> Any:
    """The tree of bools (like ``rules``, a :func:`param_rules` tree) that
    names the whole leaves a rank applies inside a rank-local region on
    the training route: in an attention block whose query heads split
    over the model axis, every leaf held whole but the pre-norm ``ln``
    — a KV projection kept whole (one KV head, or KV heads a rank's
    query heads straddle) and its bias, a bias that ``layers.linear``
    slices to the rank's columns, the q / k-norm scales.  Each rank's
    gradient of such a leaf is its heads' part, and the trainer sums it
    over the model group.  A pre-norm scale, a bias added after the
    row-parallel sum and the embedding are applied to whole activations,
    so that every rank already holds their whole gradient."""
    def mark(tree, local):
        if isinstance(tree, dict):
            wq = tree.get("wq")
            heads = isinstance(wq, Rule) and wq.tp is not None
            return {k: mark(v, heads and k != "ln") if heads else
                    mark(v, local) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(mark(v, local) for v in tree)
        return local and tree.tp is None

    return mark(rules, False)


def fsdp_shard(mesh, fsdp_axes: Sequence[str]) -> Shard:
    """This rank's block over the FSDP axes present in ``mesh``
    (``Shard(0, 1)`` without any)."""
    axes = tuple(a for a in fsdp_axes if mesh is not None
                 and a in mesh.mesh_dim_names)
    return axes_shard(mesh, axes) if axes else Shard(0, 1)


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


def shard_params(params: Any, mesh=None, *, cfg, tp_axis: str = "model",
                 fsdp_axes: Sequence[str] = ()) -> Any:
    """This rank's params under :func:`param_rule` for the model of
    config ``cfg``: a split leaf becomes its model block (Mamba's
    ``in_proj``: its block of x and of z), then its block of that over
    ``fsdp_axes`` (none by default: the serving layout), a fresh
    contiguous tensor; a whole leaf is kept as it is.  A leaf that
    already is this rank's block (this function's output: a tree that
    another engine on the same mesh sharded) is kept as it is, so that
    sharding twice shards once.  ``mesh=None`` takes the active
    context's; without a context, or with no axis of more than one
    rank, the tree comes back unchanged."""
    if mesh is None:
        from repro_torch.dist.api import current_ctx

        ctx = current_ctx()
        if ctx is None:
            return params
        mesh = ctx.mesh
    shard = model_shard(mesh, tp_axis)
    fs = fsdp_shard(mesh, fsdp_axes)
    if shard.count == 1 and fs.count == 1:
        return params

    mark = ((shard.index, shard.count) if fs.count == 1 else
            (shard.index, shard.count, fs.index, fs.count))

    def place(path, leaf):
        if getattr(leaf, "rank_block", None) == mark:
            return leaf                           # already this rank's
        rule = param_rule(path, leaf.shape, cfg, shard.count, fs.count)
        if rule.tp is None and rule.fsdp is None:
            return leaf
        block = leaf
        if rule.tp is not None and "/mamba/in_proj" in f"/{path}":  # x | z
            block = torch.cat([take_block(half, rule.tp, shard)
                               for half in leaf.chunk(2, rule.tp)],
                              dim=rule.tp)
        elif rule.tp is not None:
            block = take_block(leaf, rule.tp, shard)
        if rule.fsdp is not None:
            block = take_block(block, rule.fsdp, fs)
        block.rank_block = mark
        return block

    return _walk(params, "", place)


def gather_params(params: Any, rules: Any, mesh, *, tp_axis: str = "model",
                  fsdp_axes: Sequence[str] = (), to_host: bool = False
                  ) -> Any:
    """The inverse of :func:`shard_params` (a collective: every rank of
    ``mesh`` calls it): each leaf's blocks all-gathered over the FSDP
    group along its ``fsdp`` dim, then over the model group along its
    ``tp`` dim, by ``rules`` (the tree of :func:`param_rules` of the
    whole params).  Every rank gets the whole tree — or, ``to_host``,
    each whole leaf is copied to the host of the main rank (None on the
    others) as soon as it is gathered, so that the device holds one
    whole leaf at a time (a checkpoint of a state that the device could
    not hold whole)."""
    from repro_torch.dist import comm

    keep = comm.is_main_rank()
    fs = fsdp_shard(mesh, fsdp_axes)
    fgroup = (comm.group_of(mesh, tuple(a for a in fsdp_axes
                                        if a in mesh.mesh_dim_names))
              if fs.count > 1 else None)
    mgroup = (comm.group_of(mesh, tp_axis)
              if model_shard(mesh, tp_axis).count > 1 else None)

    def whole(path, leaf, rule):
        if rule.fsdp is not None and fgroup is not None:
            leaf = comm.all_gather_dim(leaf, fgroup, rule.fsdp)
        if rule.tp is not None and mgroup is not None:
            parts = comm.all_gather_dim(leaf, mgroup, rule.tp)
            if "/mamba/in_proj" in f"/{path}":                # x | z
                halves = [b.chunk(2, rule.tp) for b in
                          parts.chunk(comm.size(mgroup), rule.tp)]
                parts = torch.cat([h[0] for h in halves]
                                  + [h[1] for h in halves], dim=rule.tp)
            leaf = parts
        if to_host:
            return leaf.to("cpu", copy=True) if keep else None
        return leaf

    return _walk(params, "", whole, rules)


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
