"""Calibration Hessian accumulation: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/hessian_accum.py::hessian_accum``;
the kernel itself is ``csrc/hessian_accum.cu`` (its header says what
bounds it on the H100 and how the design answers that).

``hessian_accum(x, h, alpha, beta)`` computes H ← β·H + α·2·XᵀX in place
for token-major activations X (T, m) — the captures exactly as the model
hands them over, with no transposed copy.  α = 1, β = 0 is the TPU
kernel's H = 2·x·xᵀ; α = 1/n, β = n_prev/n is the streaming mean of
``core.hessian.HessianAccumulator.update`` in one launch.

On the card bf16 captures whose rows start on 16 bytes take the
tensor-core route, everything else the f32-FMA one; :func:`plan` — pure
Python, so the CPU tests reach it — picks the route and the split of the
token range, and ``hessian_accum.last_kernel`` names the route the last
launch took ("tensor cores" or "f32 FMA").

Dispatch is by device: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  ``hessian_accum.launches`` counts
kernel launches only (one a call: the product and the pass that sums
its split and mirrors the tiles).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import hessian_accum_ref

DTYPES = (torch.float32, torch.bfloat16)
TILE = {"tensor cores": 128, "f32 FMA": 64}   # output tile edge per route
CHUNK = 32              # tokens per chunk: the split's unit
BLOCKS_PER_SM = 2       # both kernels' __launch_bounds__ minimum
MIN_CHUNKS = 4          # tokens a split range keeps at least: 4 chunks
FILL = 0.9              # the smallest split whose waves are this full
MAX_WAVES = 4


class Plan(NamedTuple):
    route: str          # "tensor cores" | "f32 FMA"
    tile: int           # output tile edge
    tiles: int          # lower-triangle tiles
    split: int          # token ranges, each summed into its own partial


def plan(dtype: torch.dtype, n_tok: int, m: int, aligned: bool,
         sm_count: int) -> Plan:
    """Route and split of one launch: bf16 rows on 16 bytes (``m % 8 ==
    0`` and ``aligned``, x's pointer on 16 bytes) go to the tensor cores.
    The split is the smallest S whose tiles x S blocks fill their waves
    of ``BLOCKS_PER_SM x sm_count`` to FILL (else the fullest), with
    every range at least MIN_CHUNKS chunks and at most MAX_WAVES waves."""
    tc = dtype == torch.bfloat16 and m % 8 == 0 and aligned and n_tok > 0
    route = "tensor cores" if tc else "f32 FMA"
    nb = -(-m // TILE[route])
    tiles = nb * (nb + 1) // 2
    capacity = BLOCKS_PER_SM * sm_count
    chunks = -(-n_tok // CHUNK)
    s_max = max(1, min(chunks // MIN_CHUNKS, MAX_WAVES * capacity // tiles))
    best, best_fill = 1, 0.0
    for s in range(1, s_max + 1):
        blocks = tiles * s
        fill = blocks / (-(-blocks // capacity) * capacity)
        if fill >= FILL:
            return Plan(route, TILE[route], tiles, s)
        if fill > best_fill:
            best, best_fill = s, fill
    return Plan(route, TILE[route], tiles, best)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    build.refuse_grad("hessian_accum", x, h)
    _check(x, h)
    n_tok, m = x.shape
    if m == 0:
        return h
    p = plan(x.dtype, n_tok, m, x.data_ptr() % 16 == 0,
             _sm_count(x.device.index if x.device.index is not None
                       else torch.cuda.current_device()))
    scratch = torch.empty(p.split * p.tiles * p.tile * p.tile,
                          dtype=torch.float32, device=x.device)
    code = build.library().hessian_accum_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        int(p.route == "tensor cores"), p.split, scratch.data_ptr(),
        h.data_ptr(), n_tok, m, float(alpha), float(beta),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "hessian_accum")
    build.count_launch(hessian_accum)
    hessian_accum.last_kernel = p.route
    return h


hessian_accum.launches = 0
hessian_accum.last_kernel = None
