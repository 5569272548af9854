"""The collectives of the prune, train and serve paths over a DeviceMesh's
process groups.

Each wrapper takes the group of one or more mesh axes
(:func:`group_of`) and runs one ``torch.distributed`` collective on it.
On a ``nccl`` group the tensors stay on the card.  On a ``gloo`` group —
the CPU, or two ranks that share one card, which NCCL refuses — a CUDA
tensor is staged through the host: copied to the CPU, reduced there and
copied back.  That staging happens only on ``gloo`` groups.

A :class:`Channel` is a set of groups of its own over one mesh
(:func:`open_channel`): a group for each axis, for the data axes
together and for the whole mesh, with a timeout of its own.  Two threads
that make collectives at times of their own (the serve front end's
replicas) each take a channel: on one group their collectives could
interleave differently on each rank.  Without one (None) a collective
takes the mesh's own groups.

The layers' collectives over a model axis are
:func:`copy_to_model`, :func:`reduce_from_model` and :func:`gather_last`:
``torch.autograd.Function`` s whose backward is the collective's adjoint
(the Megatron pair ``f`` / ``g``, and the logits' gather), so that the
trainer differentiates through them; serving runs them under
``no_grad``, where they are the plain collectives.  ``torch.distributed.nn.functional`` is not used: its
``all_reduce`` all-reduces the gradient too, which counts a loss that
every rank of the group computes alike once a rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Any] = {}
SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX


@dataclasses.dataclass(frozen=True, eq=False)
class Channel:
    """This rank's groups of one channel, by the mesh axes each spans,
    and their collectives' timeout in seconds (None: the backend's
    default)."""

    groups: Dict[Tuple[str, ...], Any]
    timeout: Optional[float]


def _enumeration(mesh, axes: Tuple[str, ...]) -> List[List[int]]:
    """The world ranks of every group over ``axes`` (one a row)."""
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    rest = [d for d in range(len(names)) if d not in dims]
    size = math.prod(mesh.shape[d] for d in dims)
    return mesh.mesh.permute(*rest, *dims).reshape(-1, size).tolist()


def group_of(mesh, axes, channel: Optional[Channel] = None):
    """The process group of this rank over mesh ``axes`` (one name, or a
    tuple such as ``("pod", "data")``, which every rank must ask for in
    the same order the first time: it is created collectively) — on
    ``channel`` where one is given."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if channel is not None:
        if axes not in channel.groups:
            raise KeyError(f"the channel has no group over {axes}")
        return channel.groups[axes]
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_subgroups_by_enumeration(
            _enumeration(mesh, axes))[0]
    return _GROUPS[key]


def world_of(mesh, channel: Optional[Channel] = None):
    """The group of every rank of ``mesh`` on ``channel`` (None, the
    default group, without one)."""
    return None if channel is None else group_of(mesh, mesh.mesh_dim_names,
                                                 channel)


def open_channel(mesh, timeout: Optional[float] = None) -> Channel:
    """A new channel over ``mesh``: a group over each axis, over the data
    axes together (``pod``, ``data``) and over the whole mesh, each with
    ``timeout`` seconds for its collectives (None: the backend's
    default).  Every rank must open its channels in the same order: the
    groups are created collectively."""
    from repro_torch.dist.mesh import dp_axes_of

    names = tuple(mesh.mesh_dim_names)
    wanted = [(a,) for a in names]
    for axes in (dp_axes_of(mesh), names):
        if len(axes) > 1 and axes not in wanted:
            wanted.append(axes)
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    return Channel({axes: dist.new_subgroups_by_enumeration(
        _enumeration(mesh, axes), **kw)[0] for axes in wanted}, timeout)


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


def reduce_scatter_(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``t`` over ``group``, of which this rank keeps its
    block along ``dim`` (block ``rank(group)`` of ``size(group)`` equal
    blocks): ``reduce_scatter_tensor`` on NCCL; gloo has none, so there
    it is an ``all_reduce`` (on the host for a CUDA tensor) followed by
    the rank's block.  Returns a fresh contiguous tensor."""
    n, r = size(group), rank(group)
    if n == 1:
        return t.clone(memory_format=torch.contiguous_format)
    if dist.get_backend(group) == "gloo":
        host = t.to("cpu", copy=True).contiguous()
        dist.all_reduce(host, group=group)
        k = t.shape[dim] // n
        return host.narrow(dim, r * k, k).contiguous().to(t.device)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def all_gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim``, in group-rank order
    (an FSDP block's whole leaf)."""
    n = size(group)
    if n == 1:
        return t
    src = t.cpu() if _staged(group, t) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


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


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = g.to(torch.float32, copy=True).contiguous()
        all_reduce_(g32, ctx.group)
        return g32.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the group forward, in place in ``x``'s dtype;
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        return all_reduce_(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """The ranks' blocks of the last dim concatenated forward; the
    rank's block of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return all_gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        r, k = rank(ctx.group), ctx.width
        return g[..., r * k:(r + 1) * k].contiguous(), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Where an activation that every rank of ``group`` holds alike
    enters a rank-local region (a column-parallel product): ``x``, whose
    gradient — each rank's part — is summed over ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Where a rank-local region ends (a row-parallel product, the
    vocab-parallel embedding): the ranks' partial ``x`` summed over
    ``group`` in place (``x``, a fresh contiguous product, is the sum);
    the gradient passes through whole."""
    return _ReduceFromModel.apply(x, group)


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_gather_last` with a gradient: each rank keeps its own
    block of the gathered gradient."""
    return _GatherLast.apply(x, group)


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
