"""repro_torch.dist — device context and meshes over ``torch.distributed``
(a port of ``repro.dist``):

  - :mod:`repro_torch.dist.api`      — ``use_mesh`` / ``current_ctx``;
  - :mod:`repro_torch.dist.mesh`     — the process group, DeviceMesh
    construction and the ``--mesh`` CLI specs;
  - :mod:`repro_torch.dist.sharding` — rank-local row / batch shards;
  - :mod:`repro_torch.dist.comm`     — the collectives over a mesh's
    axis groups (host staging on ``gloo`` only).

The reference's ``dist.compat`` (its bridge for jax's ``shard_map``
rename and ``cost_analysis_dict``) has no counterpart: there is no
``shard_map`` and no compiled cost analysis here.

Axis-naming convention: ``pod`` (outer batch axis), ``data`` (batch),
``model`` (row-parallel layer solves).
"""

from repro_torch.dist.api import DistContext, current_ctx, use_mesh
from repro_torch.dist.mesh import (add_mesh_argument, dp_axes_of,
                                   init_process_group, make_host_mesh,
                                   make_mesh, make_production_mesh,
                                   mesh_context, mesh_from_spec, rank_device)
from repro_torch.dist.sharding import (Shard, batch_sharding, batch_spec,
                                       replicated, row_sharding)

__all__ = [
    "DistContext", "current_ctx", "use_mesh",
    "add_mesh_argument", "dp_axes_of", "init_process_group",
    "make_host_mesh", "make_mesh", "make_production_mesh", "mesh_context",
    "mesh_from_spec", "rank_device",
    "Shard", "batch_sharding", "batch_spec",
    "replicated", "row_sharding",
]
