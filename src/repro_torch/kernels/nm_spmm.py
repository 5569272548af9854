"""Packed 2:4 weight × activation product: the CUDA kernel's wrappers.

Replaces the TPU kernels ``repro/kernels/nm_spmm.py::nm_spmm`` and
``::nm_spmm_decode``; the kernel itself is ``csrc/nm_spmm.cu`` (its header
says what bounds it on the H100 and how the design answers that).

On the card the tiled product takes the tensor-core kernel for bf16
(``mma.sync`` on decompressed tiles, a ring filled by the Tensor Memory
Accelerator, K split over a thread-block cluster) and the f32-FMA kernel
for f32.  The skinny product takes the tensor-core kernel for bf16 whose
rows are aligned (a weight stream decompressed in registers, K split
over the warps of a block and a cluster; :func:`decode_plan`, pure
Python, decides) and the f32-FMA kernel otherwise.  ``nm_spmm.last_kernel``
and ``nm_spmm_decode.last_kernel`` name the route the last launch took
("tensor cores" or "f32 FMA").

Dispatch is by device and nothing else: a CPU tensor takes the plain
PyTorch version beside each wrapper; a CUDA tensor launches the kernel
or raises — there is no fallback.  Each wrapper counts its launches in
a plain integer (``nm_spmm.launches``), bumped only where the kernel is
launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import nm_spmm_ref

ACTIVATIONS = {None: 0, "silu": 1, "gelu": 2}
DTYPES = (torch.float32, torch.bfloat16)
DECODE_MAX_M = 128          # the decode kernel's M limit (ops dispatch split)
# the tensor-core decode kernel's block: 128 output columns, K split over
# 4 slices of 2 warps; clusters of up to 16 blocks
DECODE_BN, DECODE_SLICES, DECODE_MAX_CLUSTER = 128, 4, 16


class DecodePlan(NamedTuple):
    route: str          # "tensor cores" | "f32 FMA"
    mb: int             # 8-row batch fragments a block (tensor cores)
    row_blocks: int     # blocks along M
    cluster: int        # blocks splitting K, one cluster


def decode_plan(dtype: torch.dtype, m: int, k: int, n: int, aligned: bool,
                clusters_at: Callable[[int, int], int]) -> DecodePlan:
    """Route and shape of one ``nm_spmm_decode`` launch.  bf16 with ``n %
    8 == 0`` and ``aligned`` (vals on 16 bytes, idx and x on 8) takes the
    tensor cores; f32, and bf16 rows off those boundaries, take the FMA
    kernel.  On the tensor cores a block holds 8, 16 or 32 rows of x
    (M ≤ 8, ≤ 16, else 32 a block) and 128 columns, and K is split over
    the largest cluster (≤ 16 blocks) for which the card runs the whole
    grid at once — ``clusters_at(mb, c)``: how many clusters of c blocks
    it holds — while every warp slice keeps a 16-deep K step; where no
    cluster lets the grid run at once, no split (one block a cluster)."""
    if not (dtype == torch.bfloat16 and n % 8 == 0 and aligned):
        return DecodePlan("f32 FMA", 0, 0, 0)
    mb = 1 if m <= 8 else 2 if m <= 16 else 4
    row_blocks = -(-m // (8 * mb))
    clusters = -(-n // DECODE_BN) * row_blocks
    steps = -(-(k // 4) // 4)
    for c in range(DECODE_MAX_CLUSTER, 1, -1):
        if c * DECODE_SLICES <= steps and clusters <= clusters_at(mb, c):
            return DecodePlan("tensor cores", mb, row_blocks, c)
    return DecodePlan("tensor cores", mb, row_blocks, 1)


@functools.lru_cache(maxsize=4096)
def _decode_plan(dtype: torch.dtype, m: int, k: int, n: int, aligned: bool,
                 index: int) -> DecodePlan:
    return decode_plan(dtype, m, k, n, aligned,
                       functools.partial(_clusters_at, index))


@functools.lru_cache(maxsize=None)
def _clusters_at(index: int, mb: int, cs: int) -> int:
    """Clusters of ``cs`` decode blocks the card ``index`` runs at once."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        build.check(build.library().nm_spmm_decode_clusters(
            mb, cs, ctypes.byref(n)), "nm_spmm_decode_clusters")
    return n.value


def _check(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
           name: str) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: tensors on {x.device} — the kernel "
                           "runs on CUDA only (CPU tensors take the plain "
                           "version)")
    if x.dim() != 2 or vals.dim() != 2:
        raise ValueError(f"{name}: x (M, K) and vals (K/2, N) expected")
    m, k = x.shape
    k2, n = vals.shape
    if k2 * 2 != k or k % 4:
        raise ValueError(f"{name}: vals rows {k2} != K/2 = {k / 2} "
                         "(K must divide by 4)")
    if idx.shape != vals.shape or idx.dtype != torch.int8:
        raise ValueError(f"{name}: idx must be int8 of vals' shape")
    if x.dtype not in DTYPES or vals.dtype != x.dtype:
        raise ValueError(f"{name}: x and vals must share f32 or bf16, got "
                         f"{x.dtype} / {vals.dtype}")
    for t in (x, vals, idx):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on "
                             f"{x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ----------------------------------------------------------------------
def nm_spmm_plain(x: torch.Tensor, vals: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`nm_spmm`: decompress, then an f32 matmul."""
    return nm_spmm_ref(x, vals, idx)


def nm_spmm(x: torch.Tensor, vals: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    """y = x @ decompress_24(vals, idx): x (M, K), vals/idx (K/2, N) →
    (M, N) f32.  The tiled kernel (any M; the dispatch sends M > 128)."""
    if x.device.type == "cpu":
        return nm_spmm_plain(x, vals, idx)
    build.refuse_grad("nm_spmm", x, vals)
    _check(x, vals, idx, "nm_spmm")
    m, k = x.shape
    n = vals.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    code = build.library().nm_spmm_launch(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
        m, k, n, int(bf16), _stream(x))
    build.check(code, "nm_spmm")
    build.count_launch(nm_spmm)
    nm_spmm.last_kernel = "tensor cores" if bf16 else "f32 FMA"
    return out


nm_spmm.launches = 0
nm_spmm.last_kernel = None


# ----------------------------------------------------------------------
def nm_spmm_decode_plain(x: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         activation: Optional[str] = None) -> torch.Tensor:
    """Plain version of :func:`nm_spmm_decode`."""
    return nm_spmm_ref(x, vals, idx, bias=bias, activation=activation)


def nm_spmm_decode(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   activation: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ decompress_24(vals, idx) + bias) for skinny M ≤ 128
    (every decode step and prefill chunk): x (M, K), bias (N,) f32 or
    bf16 or None, ``activation`` None | "silu" | "gelu" → (M, N) f32,
    bias and activation fused into the kernel's epilogue."""
    if x.device.type == "cpu":
        return nm_spmm_decode_plain(x, vals, idx, bias, activation)
    build.refuse_grad("nm_spmm_decode", x, vals, bias)
    _check(x, vals, idx, "nm_spmm_decode")
    m, k = x.shape
    n = vals.shape[1]
    if m > DECODE_MAX_M:
        raise ValueError(f"nm_spmm_decode: M={m} > {DECODE_MAX_M}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown epilogue activation {activation!r}")
    bias_ptr, bias_bf16 = None, 0
    if bias is not None:
        if (bias.numel() != n or bias.dtype not in DTYPES
                or bias.device != x.device or not bias.is_contiguous()):
            raise ValueError("nm_spmm_decode: bias must be a contiguous "
                             f"({n},) f32/bf16 tensor on {x.device}")
        bias_ptr, bias_bf16 = bias.data_ptr(), int(bias.dtype == torch.bfloat16)
    aligned = (vals.data_ptr() % 16 == 0 and idx.data_ptr() % 8 == 0
               and x.data_ptr() % 8 == 0)
    index = (x.device.index if x.device.index is not None
             else torch.cuda.current_device())
    p = _decode_plan(x.dtype, m, k, n, aligned, index)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    code = build.library().nm_spmm_decode_launch(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), bias_ptr, bias_bf16,
        out.data_ptr(), m, k, n, ACTIVATIONS[activation],
        int(x.dtype == torch.bfloat16), int(p.route == "tensor cores"),
        p.mb, p.cluster, _stream(x))
    build.check(code, "nm_spmm_decode")
    build.count_launch(nm_spmm_decode)
    nm_spmm_decode.last_kernel = p.route
    return out


nm_spmm_decode.launches = 0
nm_spmm_decode.last_kernel = None
