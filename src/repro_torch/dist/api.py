"""Device-context API: ``use_mesh`` / ``current_ctx`` (a port of
``repro.dist.api``).

The context is an ambient, thread-local stack: code that cares about
distribution asks ``current_ctx()`` and gets either a
:class:`DistContext` (inside ``use_mesh``) or ``None``, in which case
every call site runs on one device with no collective.

    mesh = mesh_from_spec("2x1", device="cuda")   # a DeviceMesh
    with use_mesh(mesh):
        ctx = current_ctx()         # DistContext(mesh, ("data",), "model")
    current_ctx()                   # -> None again

Contexts nest: an inner ``use_mesh`` shadows the outer one, and leaving
it (by an error too) restores the outer context exactly.

Here ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` and every
process is one rank of it (SPMD): a rank holds its own activations, its
own rows of the global batch and its own calibration shard, and the
collectives it joins are explicit (``dist.comm``).  The reference's
``constrain`` (a sharding constraint on a traced array, the compiler's
hint for where an activation lives) therefore has no counterpart, nor
have its ``_seq_constrain`` / ``_dp_only_constrain`` call sites in the
model's layers: there is no compiler to place a tensor, and a tensor a
rank holds is already local.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Iterator, Optional, Sequence, Tuple

_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def axis_size(mesh, axis: str) -> int:
    """The size of one named axis of a DeviceMesh."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


@dataclasses.dataclass(frozen=True)
class DistContext:
    """Active device context: the mesh plus the axis-role assignment.

    ``dp_axes`` are the batch axes (``("pod", "data")`` on a multi-pod
    mesh, ``("data",)`` otherwise); ``tp_axis`` is the row-parallel axis
    of the layer solves (``None`` when the mesh has no ``model`` axis).
    ``dp`` / ``tp`` are the corresponding total shard counts.
    ``split_rows``: each rank holds its own rows of one batch split over
    ``dp_axes`` — where the reference runs one program over the global
    batch (the trainer's step, a static bucket split over data), so that
    a MoE layer routes the global batch (``models.moe``).  Replicated
    work (every rank the same rows) and the calibration shards (each
    shard its own program in the reference) leave it off.
    ``channel``: the groups the collectives under this context take
    (a ``dist.comm.Channel``; None: the mesh's own) — a serve replica's
    engine has a channel of its own.
    """

    mesh: object                 # torch.distributed DeviceMesh
    dp_axes: Tuple[str, ...]
    tp_axis: Optional[str]
    split_rows: bool = False
    channel: object = None       # dist.comm.Channel

    @property
    def dp(self) -> int:
        size = 1
        for a in self.dp_axes:
            size *= axis_size(self.mesh, a)
        return size

    @property
    def tp(self) -> int:
        if self.tp_axis is None:
            return 1
        return axis_size(self.mesh, self.tp_axis)


def current_ctx() -> Optional[DistContext]:
    """The innermost active :class:`DistContext`, or ``None`` outside any
    ``use_mesh`` — callers treat ``None`` as "one device, no
    collective"."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh, dp_axes: Optional[Sequence[str]] = None,
             tp_axis: Optional[str] = "model",
             split_rows: bool = False,
             channel=None) -> Iterator[DistContext]:
    """Activate ``mesh`` as the ambient device context.

    ``dp_axes`` defaults to the batch axes present in the mesh
    (``pod``/``data``); ``tp_axis`` degrades to ``None`` when the mesh has
    no such axis, so a mesh like ``(2,) ("data",)`` works too;
    ``split_rows`` and ``channel`` as :class:`DistContext`'s."""
    from repro_torch.dist.mesh import dp_axes_of

    if dp_axes is None:
        dp_axes = dp_axes_of(mesh)
    if tp_axis is not None and tp_axis not in mesh.mesh_dim_names:
        tp_axis = None
    ctx = DistContext(mesh, tuple(dp_axes), tp_axis, split_rows, channel)
    _stack().append(ctx)
    try:
        yield ctx
    finally:
        _stack().pop()
