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

``hessian_accum_weighted(x, w, h, count)`` is the weighted streaming
mean of a MoE expert (``HessianAccumulator.update_weighted``): with c the
0-dim f32 ``count`` on the device, H ← H·c/max(c+Σw, 1e-12) +
2·Xᵀdiag(w)X/max(c+Σw, 1e-12) and c ← c + Σw, in one call that reads
nothing back to the host — a first pass sums w and forms both
coefficients on the card.  Bool weights (routing validity) zero the
dropped tokens' rows of one operand, which is exact, so bf16 keeps the
tensor cores; float weights (gate probabilities) take the f32-FMA route,
which multiplies them in f32 as the reference does.

Dispatch is by device: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  ``hessian_accum.launches`` counts
calls that launched the kernel (one a call, weighted or not: the
product, the pass that sums its split and mirrors the tiles, and for the
weighted form the pass before it that forms the coefficients).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (hessian_accum_ref,
                                     hessian_accum_weighted_ref)

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
         sm_count: int, weights: str = "none") -> Plan:
    """Route and split of one launch: bf16 rows on 16 bytes (``m % 8 ==
    0`` and ``aligned``, x's pointer on 16 bytes) with no weights or
    bool ``weights`` go to the tensor cores, float ``weights`` to the f32
    FMA.
    The split is the smallest S whose tiles x S blocks fill their waves
    of ``BLOCKS_PER_SM x sm_count`` to FILL (else the fullest), with
    every range at least MIN_CHUNKS chunks and at most MAX_WAVES waves."""
    if weights not in ("none", "bool", "float"):
        raise ValueError(f"weights={weights!r} not in none / bool / float")
    tc = (dtype == torch.bfloat16 and m % 8 == 0 and aligned and n_tok > 0
          and weights != "float")
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


def _plan_for(x: torch.Tensor, weights: str = "none"):
    """The launch's plan and its scratch: the split's partial tiles and
    two floats behind them (the weighted form's coefficients)."""
    n_tok, m = x.shape
    p = plan(x.dtype, n_tok, m, x.data_ptr() % 16 == 0,
             _sm_count(x.device.index if x.device.index is not None
                       else torch.cuda.current_device()), weights)
    scratch = torch.empty(p.split * p.tiles * p.tile * p.tile + 2,
                          dtype=torch.float32, device=x.device)
    return p, scratch


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
    p, scratch = _plan_for(x)
    code = build.library().hessian_accum_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        int(p.route == "tensor cores"), p.split, scratch.data_ptr(),
        h.data_ptr(), n_tok, m, float(alpha), float(beta),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "hessian_accum")
    build.count_launch(hessian_accum)
    hessian_accum.last_kernel = p.route
    return h


def hessian_accum_weighted_plain(x: torch.Tensor, w: torch.Tensor,
                                 h: torch.Tensor, count: torch.Tensor
                                 ) -> torch.Tensor:
    """Plain version of :func:`hessian_accum_weighted` (in place on ``h``
    and ``count``), the reference's ``_accum_update_weighted``."""
    new = count + w.float().sum()
    denom = torch.clamp(new, min=1e-12)
    g = hessian_accum_weighted_ref(x.T, w)          # 2·Xᵀdiag(w)X, f32
    h.copy_(h * (count / denom) + g / denom)
    count.copy_(new)
    return h


def _check_weights(x: torch.Tensor, w: torch.Tensor,
                   count: torch.Tensor) -> None:
    if w.shape != (x.shape[0],) or w.device != x.device:
        raise ValueError(f"hessian_accum: weights must be ({x.shape[0]},) "
                         f"on {x.device}, got {tuple(w.shape)} on {w.device}")
    if (count.shape != () or count.dtype != torch.float32
            or count.device != x.device):
        raise ValueError("hessian_accum: count must be a 0-dim f32 tensor "
                         f"on {x.device}")


def hessian_accum_weighted(x: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                           count: torch.Tensor) -> torch.Tensor:
    """The weighted streaming mean, in place on ``h`` and ``count``: x
    (T, m) f32/bf16 token-major, w (T,) bool or float ≥ 0, h (m, m) f32,
    count a 0-dim f32 tensor.  Returns h."""
    if x.device.type == "cpu":
        return hessian_accum_weighted_plain(x, w, h, count)
    build.refuse_grad("hessian_accum", x, w, h)
    _check(x, h)
    _check_weights(x, w, count)
    n_tok, m = x.shape
    if m == 0:
        return h
    kind = "bool" if w.dtype == torch.bool else "float"
    w = w.contiguous() if kind == "bool" else w.float().contiguous()
    p, scratch = _plan_for(x, kind)
    code = build.library().hessian_accum_weighted_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        int(p.route == "tensor cores"), p.split, scratch.data_ptr(),
        h.data_ptr(), n_tok, m, w.data_ptr(), 1 if kind == "bool" else 2,
        count.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "hessian_accum")
    build.count_launch(hessian_accum)
    hessian_accum.last_kernel = p.route
    return h


hessian_accum.launches = 0
hessian_accum.last_kernel = None
