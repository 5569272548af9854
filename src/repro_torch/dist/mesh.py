"""Mesh construction and the ``--mesh`` entry path (a port of
``repro.dist.mesh``), over ``torch.distributed``'s DeviceMesh.

Axis-naming convention (the reference's): ``pod`` (the outer batch
axis), ``data`` (batch), ``model`` (the row-parallel layer solves).

Every process is one rank.  :func:`init_process_group` starts the
default group from the environment that ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``); a
single process without them is world size 1, over an in-memory store.
The backend follows the device: ``nccl`` on the card (device
``cuda:LOCAL_RANK``), ``gloo`` when the caller asks for the CPU — or
when it names ``gloo`` itself, as two ranks that share one card must
(NCCL refuses two ranks on one device).

A mesh spec whose size differs from the world size raises, naming both.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def rank_device(device) -> torch.device:
    """The device this rank works on: ``cuda:LOCAL_RANK`` for a bare
    ``cuda`` (modulo the visible cards, so that ranks may share one),
    the device itself otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        return torch.device("cuda", local % max(1, torch.cuda.device_count()))
    return device


def init_process_group(device="cuda", backend: Optional[str] = None
                       ) -> None:
    """Start the default process group unless one is up: ``env://`` when
    ``WORLD_SIZE`` is set, else a world of one over an in-memory store.
    ``backend`` defaults to ``nccl`` for a CUDA device and ``gloo`` for
    the CPU."""
    if dist.is_initialized():
        return
    device = rank_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda",
              backend: Optional[str] = None):
    """A DeviceMesh of ``shape`` over ``axes`` covering the whole world
    (the process group is started first when it is not up)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    init_process_group(device, backend)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh {'x'.join(map(str, shape))} {axes} has "
            f"{math.prod(shape)} ranks but the process group has "
            f"world size {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(rank_device(device).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         backend: Optional[str] = None):
    """16×16 single pod (256 ranks) or 2×16×16 (512 ranks, 2 pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device, backend)


def dp_axes_of(mesh) -> Tuple[str, ...]:
    """The batch-sharding axes of a mesh (the pod/data subset present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def make_host_mesh(device="cpu", backend: Optional[str] = None):
    """1×1 mesh over this process (tests of mesh-aware code)."""
    return make_mesh((1, 1), ("data", "model"), device, backend)


def mesh_from_spec(spec: Optional[str], device="cuda",
                   backend: Optional[str] = None):
    """Resolve a ``--mesh`` CLI spec to a DeviceMesh (or ``None``).

    Accepted specs:
      ``none``/``""``/None  no mesh — one device, no process group;
      ``host``              1×1 mesh over this process;
      ``production``        16×16 single pod;
      ``production-2pod``   2×16×16 two pods;
      ``AxB`` / ``AxBxC``   explicit shape, e.g. ``2x4`` → (data, model),
                            ``2x4x4`` → (pod, data, model).
    """
    if spec is None or spec in ("", "none"):
        return None
    if spec == "host":
        return make_host_mesh(device, backend)
    if spec == "production":
        return make_production_mesh(device=device, backend=backend)
    if spec in ("production-2pod", "multipod"):
        return make_production_mesh(multi_pod=True, device=device,
                                    backend=backend)
    dims = spec.lower().split("x")
    if all(d.isdigit() for d in dims) and len(dims) in (2, 3):
        axes = ("data", "model") if len(dims) == 2 else (
            "pod", "data", "model")
        return make_mesh([int(d) for d in dims], axes, device, backend)
    raise ValueError(f"unrecognized --mesh spec {spec!r}")


def add_mesh_argument(parser) -> None:
    """Attach the shared ``--mesh`` flag to an argparse parser."""
    parser.add_argument(
        "--mesh", default="none",
        help="device mesh: none | host | production | production-2pod "
             "| AxB[xC] (see repro_torch.dist.mesh.mesh_from_spec)")


def mesh_context(spec: Optional[str], device="cuda",
                 backend: Optional[str] = None):
    """``use_mesh`` over ``mesh_from_spec(spec)`` — a null context
    (yielding ``None``) when the spec resolves to no mesh."""
    from repro_torch.dist.api import use_mesh

    mesh = mesh_from_spec(spec, device, backend)
    if mesh is None:
        return contextlib.nullcontext(None)
    return use_mesh(mesh)
