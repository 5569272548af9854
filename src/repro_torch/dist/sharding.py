"""Sharding rules of the prune and train paths, as rank-local slicing (a
port of the part of ``repro.dist.sharding`` those paths use).

In the reference a rule is a ``NamedSharding`` that tells the compiler
where each block of an array lives.  Here every process is one rank and
holds only its own block, so a rule is a :class:`Shard`: which of
``count`` contiguous blocks of dim 0 this rank holds.

  - ``row_sharding``: weight rows over ``model`` (the row-parallel layer
    solve, Remark 4.2);
  - ``batch_sharding``: rows of the global batch over the data (+pod)
    axes, pod outer — the reference's ``P(("pod", "data"))`` order;
  - ``replicated``: the whole tensor.

The rest of the reference's rules (``param_specs`` / ``shard_params``,
the paged and decode cache specs, ``moe_dispatch_specs``) lay weights
and caches out for tensor-parallel serving, FSDP and expert parallelism,
which are not ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

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
