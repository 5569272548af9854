"""Calibration Hessian accumulation: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/hessian_accum.py::hessian_accum``;
the kernel itself is ``csrc/hessian_accum.cu`` (its header says what
bounds it on the H100 and how the design answers that).

``hessian_accum(x, h, alpha, beta)`` computes H ← β·H + α·2·XᵀX in place
for token-major activations X (T, m) — the captures exactly as the model
hands them over, with no transposed copy.  α = 1, β = 0 is the TPU
kernel's H = 2·x·xᵀ; α = 1/n, β = n_prev/n is the streaming mean of
``core.hessian.HessianAccumulator.update`` in one launch.

Dispatch is by device: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  ``hessian_accum.launches`` counts
kernel launches only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import hessian_accum_ref

DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor, h: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"hessian_accum: tensors on {x.device} — the "
                           "kernel runs on CUDA only (CPU tensors take the "
                           "plain version)")
    if x.dim() != 2 or x.dtype not in DTYPES or not x.is_contiguous():
        raise ValueError("hessian_accum: x must be a contiguous (T, m) f32 "
                         f"or bf16 tensor, got {tuple(x.shape)} {x.dtype}")
    m = x.shape[1]
    if (h.shape != (m, m) or h.dtype != torch.float32
            or h.device != x.device or not h.is_contiguous()):
        raise ValueError(f"hessian_accum: h must be a contiguous ({m}, {m}) "
                         f"f32 tensor on {x.device}")


def hessian_accum_plain(x: torch.Tensor, h: torch.Tensor, alpha: float = 1.0,
                        beta: float = 0.0) -> torch.Tensor:
    """Plain version of :func:`hessian_accum` (in place on ``h``)."""
    g = hessian_accum_ref(x.T)                      # 2·XᵀX, f32
    if beta == 0.0:
        return torch.mul(g, alpha, out=h)
    return h.mul_(beta).add_(g, alpha=alpha)


def hessian_accum(x: torch.Tensor, h: torch.Tensor, alpha: float = 1.0,
                  beta: float = 0.0) -> torch.Tensor:
    """H ← β·H + α·2·XᵀX in place: x (T, m) f32/bf16 token-major, h (m, m)
    f32.  With β = 0, ``h`` is written without being read.  Returns h."""
    if x.device.type == "cpu":
        return hessian_accum_plain(x, h, alpha, beta)
    _check(x, h)
    n_tok, m = x.shape
    if m == 0:
        return h
    code = build.library().hessian_accum_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), h.data_ptr(), n_tok, m,
        float(alpha), float(beta),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "hessian_accum")
    hessian_accum.launches += 1
    return h


hessian_accum.launches = 0
