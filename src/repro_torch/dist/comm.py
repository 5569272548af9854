"""The collectives of the prune, train and serve paths over a DeviceMesh's
process groups.

Each wrapper takes the group of one or more mesh axes
(:func:`group_of`) and runs one ``torch.distributed`` collective on it.
On a ``nccl`` group the tensors stay on the card.  On a ``gloo`` group —
the CPU, or two ranks that share one card, which NCCL refuses — a CUDA
tensor is staged through the host: copied to the CPU, reduced there and
copied back.  That staging happens only on ``gloo`` groups.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist

_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Any] = {}
SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX


def group_of(mesh, axes):
    """The process group of this rank over mesh ``axes`` (one name, or a
    tuple such as ``("pod", "data")``, which every rank must ask for in
    the same order the first time: it is created collectively)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        size = math.prod(mesh.shape[d] for d in dims)
        ranks = mesh.mesh.permute(*rest, *dims).reshape(-1, size).tolist()
        _GROUPS[key] = dist.new_subgroups_by_enumeration(ranks)[0]
    return _GROUPS[key]


def size(group) -> int:
    return dist.get_world_size(group)


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group, op=SUM) -> torch.Tensor:
    """Reduce ``t`` over ``group`` (None: the world) in place, a sum by
    default; returns ``t``."""
    if _staged(group, t):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in group-rank order."""
    n = size(group)
    src = t.cpu() if _staged(group, t) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def all_gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the last dim, in group-rank
    order (a vocab-parallel head's logits, a rank's heads)."""
    n = size(group)
    src = t.cpu() if _staged(group, t) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=-1).to(t.device)


def all_to_all_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Split ``t``'s dim 0 into ``size(group)`` equal blocks; block ``i``
    goes to rank ``i``, and the result holds, in rank order, the block
    each rank sent here (``all_to_all_single``)."""
    src = t.cpu() if _staged(group, t) else t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device)


def all_gather_object(obj: Any, group) -> List[Any]:
    """Every rank's picklable ``obj``, in group-rank order."""
    out: List[Any] = [None] * size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj: Any, group=None, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` (a world rank) on every rank of
    ``group``."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def rank(group=None) -> int:
    """This process's rank in ``group`` (the world by default)."""
    return dist.get_rank(group)


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (the world by default)."""
    dist.barrier(group=group)


def is_main_rank() -> bool:
    """True on rank 0 of the world, and without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0
