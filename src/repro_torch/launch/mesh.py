"""Mesh construction lives in :mod:`repro_torch.dist.mesh` (the
reference's ``repro.launch.mesh`` shim)."""

from repro_torch.dist.mesh import (  # noqa: F401
    dp_axes_of,
    make_host_mesh,
    make_production_mesh,
    mesh_from_spec,
)

__all__ = [
    "dp_axes_of",
    "make_host_mesh",
    "make_production_mesh",
    "mesh_from_spec",
]
