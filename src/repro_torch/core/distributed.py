"""Distributed pruning: data-parallel Hessians and row-parallel MRP
solves (a port of ``repro.core.distributed``).

Remark 4.2 (separate row computation) makes MRP pruning parallel over
weight rows: each row's compensation touches only that row's pruned set
and the (replicated) inverse Hessian.  So, over a DeviceMesh:

  - calibration: each rank of the data (+pod) axes accumulates the
    Hessians of its own calibration shard; :func:`psum_hessian` merges
    them into the token-weighted mean (``HessianAccumulator.merge``'s),
    one ``all_reduce`` per linear;
  - pruning: each rank of the ``model`` axis solves its contiguous block
    of rows against the replicated H, and the pruned rows and masks are
    ``all_gather``ed.  N:M masks are per row, so they equal the
    one-device solve's; unstructured specs take the row-balanced
    selection (an exact per-row count), so no selection crosses ranks.

No collective happens inside a layer's solve: a whole prune exchanges
one Hessian per linear, plus the gathers of the row-parallel results.
Both entry points resolve the mesh from the active ``dist`` context when
none is passed.  The Hessians stay on the device (on a ``gloo`` group a
CUDA tensor is staged through the host, ``dist.comm``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.calibration import CalibrationSet
from repro_torch.core.hessian import HessianAccumulator
from repro_torch.core.pruner import prune_matrix
from repro_torch.core.sparsity import SparsitySpec
from repro_torch.dist import comm
from repro_torch.dist.api import axis_size, current_ctx
from repro_torch.dist.sharding import row_sharding

Axes = Union[str, Sequence[str]]


def _resolve_mesh(mesh):
    if mesh is not None:
        return mesh
    ctx = current_ctx()
    if ctx is None:
        raise ValueError(
            "no mesh given and no active device context — pass mesh= or "
            "call inside repro_torch.dist.use_mesh(mesh)")
    return ctx.mesh


# ----------------------------------------------------------------------
# Hessian combination across data shards
# ----------------------------------------------------------------------
def psum_hessian(h_local: torch.Tensor,
                 count_local: Union[float, torch.Tensor], group
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-weighted mean of the ranks' Hessians over ``group``:
    H = Σ_s H_s·n_s / max(Σ_s n_s, 1), and Σ_s n_s (a 0-dim f32 tensor on
    H's device).  One ``all_reduce`` of H·n with n packed after it, so
    the count costs no second collective and no host sync."""
    m = h_local.shape[0]
    buf = torch.empty(m * m + 1, dtype=torch.float32, device=h_local.device)
    if isinstance(count_local, torch.Tensor):
        torch.mul(h_local, count_local, out=buf[:-1].view(m, m))
        buf[-1:].copy_(count_local.reshape(1))
    else:
        torch.mul(h_local, float(count_local), out=buf[:-1].view(m, m))
        buf[-1:].fill_(float(count_local))
    comm.all_reduce_(buf, group)
    total = buf[-1]
    return buf[:-1].view(m, m) / torch.clamp(total, min=1.0), total


def hessian_allreduce(mesh, h_local: torch.Tensor,
                      count_local: Union[float, torch.Tensor],
                      axis_name: Axes = "data") -> torch.Tensor:
    """This rank's (H, count) merged with every other rank's over
    ``axis_name`` (one axis, or several such as ``("pod", "data")``).
    ``mesh=None`` resolves the active context's mesh."""
    group = comm.group_of(_resolve_mesh(mesh), axis_name)
    return psum_hessian(h_local, count_local, group)[0]


def allreduce_calibration(local: CalibrationSet, mesh=None,
                          axis_name: Axes = "data") -> CalibrationSet:
    """Merge the ranks' :class:`CalibrationSet`s over the mesh's batch
    axes, where each rank holds one calibration shard of the segment:
    one :func:`psum_hessian` per linear, in sorted name order on every
    rank.  A group of one rank returns ``local`` (the reference's single
    set).  A linear some rank never saw is merged over the ranks that
    did (the reference's ``merge_many`` fallback for it): those ranks
    join its collective with H = 0 and count 0, so every rank walks the
    same collectives.  When the shards do not map one to a rank, the
    caller merges them locally (``CalibrationSet.merge_all``), as the
    reference falls back when the shard count differs from the axes'
    size."""
    mesh = _resolve_mesh(mesh)
    group = comm.group_of(mesh, axis_name)
    if comm.size(group) == 1:
        return local
    dims = {}
    for names in comm.all_gather_object(
            {n: a.dim for n, a in local.accs.items()}, group):
        dims.update(names)
    out = CalibrationSet()
    device = next(iter(local.accs.values())).h.device if local.accs else None
    for name in sorted(dims):
        acc = local.accs.get(name)
        if acc is None:
            h_loc = torch.zeros((dims[name], dims[name]),
                                dtype=torch.float32, device=device)
            h, total = psum_hessian(h_loc, 0.0, group)
        else:
            h, total = psum_hessian(acc.h, acc.count, group)
        out.accs[name] = HessianAccumulator(dims[name], h=h, count=total)
    return out


# ----------------------------------------------------------------------
# Row-parallel layer pruning
# ----------------------------------------------------------------------
def prune_matrix_sharded(w: torch.Tensor, h: torch.Tensor,
                         spec: SparsitySpec | str, mesh=None,
                         method: str = "SM", blocksize: int = 128,
                         gamma: float = 0.01, score: Optional[str] = None,
                         row_chunk: Optional[int] = None,
                         model_axis: str = "model"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-parallel prune: (w_pruned, mask), both whole on every rank.

    This rank solves its contiguous block of rows over ``model_axis``
    with ``prune_matrix(row_balanced=True)`` against the replicated
    ``h`` — no collective inside — and the blocks are gathered in rank
    order.  ``mesh=None`` resolves the active context's mesh."""
    mesh = _resolve_mesh(mesh)
    if isinstance(spec, str):
        spec = SparsitySpec.parse(spec)
    n = w.shape[0]
    n_shards = axis_size(mesh, model_axis)
    if n % n_shards:
        raise ValueError(f"rows {n} not divisible by {model_axis}={n_shards}")
    res = prune_matrix(row_sharding(mesh, model_axis).take(w), h, spec,
                       method=method, blocksize=blocksize, gamma=gamma,
                       score=score, row_chunk=row_chunk, row_balanced=True,
                       sync=False)
    group = comm.group_of(mesh, model_axis)
    w_new = comm.all_gather_rows(res.w, group)
    mask = comm.all_gather_rows(res.mask.to(torch.uint8), group).bool()
    return w_new, mask
