"""Solution 𝔐 2:4 mask selection (Eq. 12): the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/nm_select.py::nm_select``; the
kernel itself is ``csrc/nm_select.cu`` (its header says what bounds it on
the H100 and how the design answers that).

``nm_select(w, hinv)`` takes w (R, C) and the (C, C) inverse Hessian — or
a square block of a larger one, as a strided view: the kernel reads the
4×4 diagonal blocks in place (the TPU wrapper gathers them into (G, 16)
first).  It returns the bool mask (R, C), True = pruned, exactly 2 per
group of 4, the first minimum in ``ref.NM_COMBOS_24`` order on ties.

Dispatch is by device: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  ``nm_select.launches`` counts
kernel launches only; ``nm_select.last_kernel`` names the last launch's
route: "vector loads" (each group's weights in one 8- or 16-byte load,
Hinv's block rows in 16-byte loads) or "scalar loads" for views off those
boundaries.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import nm_select_ref

DTYPES = (torch.float32, torch.bfloat16)
THREADS = 128           # a block's threads (csrc/nm_select.cu's NT)


def plan(r: int, c: int) -> int:
    """The grid's blocks: one thread per (row, group of 4)."""
    return max(1, -(-(r * (c // 4)) // THREADS))


def _check(w: torch.Tensor, hinv: torch.Tensor) -> None:
    if w.device.type != "cuda":
        raise RuntimeError(f"nm_select: tensors on {w.device} — the kernel "
                           "runs on CUDA only (CPU tensors take the plain "
                           "version)")
    if w.dim() != 2 or w.shape[1] % 4 or w.dtype not in DTYPES:
        raise ValueError("nm_select: w must be (R, C) f32 or bf16 with C "
                         f"divisible by 4, got {tuple(w.shape)} {w.dtype}")
    c = w.shape[1]
    if (hinv.shape != (c, c) or hinv.dtype != torch.float32
            or hinv.device != w.device):
        raise ValueError(f"nm_select: hinv must be ({c}, {c}) f32 on "
                         f"{w.device}")
    for t in (w, hinv):
        if t.stride(1) != 1 or (t.shape[0] > 1 and t.stride(0) < t.shape[1]):
            raise ValueError("nm_select: w and hinv need unit column stride "
                             "and non-overlapping rows")


def _aligned(w: torch.Tensor, hinv: torch.Tensor) -> bool:
    """Whether every group of w starts on its load's width (8 bytes for
    bf16, 16 for f32) and every row of Hinv's 4×4 blocks on 16 bytes."""
    return (w.data_ptr() % (4 * w.element_size()) == 0
            and w.stride(0) % 4 == 0 and hinv.data_ptr() % 16 == 0
            and hinv.stride(0) % 4 == 0)


def nm_select_plain(w: torch.Tensor, hinv: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`nm_select`."""
    return nm_select_ref(w, hinv)


def nm_select(w: torch.Tensor, hinv: torch.Tensor) -> torch.Tensor:
    """Eq. (12) 2:4 mask: w (R, C), hinv (C, C) f32 → bool (R, C)."""
    if w.device.type == "cpu":
        return nm_select_plain(w, hinv)
    build.refuse_grad("nm_select", w, hinv)
    _check(w, hinv)
    r, c = w.shape
    out = torch.empty((r, c), dtype=torch.bool, device=w.device)
    if r == 0 or c == 0:
        return out
    vec = _aligned(w, hinv)
    code = build.library().nm_select_launch(
        w.data_ptr(), int(w.dtype == torch.bfloat16), w.stride(0),
        hinv.data_ptr(), hinv.stride(0), out.data_ptr(), r, c, plan(r, c),
        int(vec), torch.cuda.current_stream(w.device).cuda_stream)
    build.check(code, "nm_select")
    build.count_launch(nm_select)
    nm_select.last_kernel = "vector loads" if vec else "scalar loads"
    return out


nm_select.launches = 0
nm_select.last_kernel = None
