"""Paged GQA decode attention: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/paged_attn.py::paged_attn`` (its
bf16/f32 and its int8-page variants); the kernel is ``csrc/paged_attn.cu``
(its header says what bounds it on the H100 and how the design answers
that).  A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  ``paged_attn.launches`` counts kernel launches,
``paged_attn.last_plan`` is the last launch's :class:`Plan` and
``paged_attn.last_kernel`` its route ("16-byte copies" or "scalar loads").
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attn_ref

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# csrc/paged_attn.cu's block: NW warps; a lane holds LANE_ELEMS elements of a
# K/V row (16 bytes of bf16 or int8, 32 of f32), so a row takes a
# power-of-two group of at most 32 lanes: hd ≤ 32 · LANE_ELEMS
NW = 4
LANE_ELEMS = {torch.float32: 8, torch.bfloat16: 8, torch.int8: 16}
ACC_MAX = 32           # accumulators a lane keeps: heads a block × LANE_ELEMS
ROWS_MAX = 8           # rows a lane group stages a ring stage
ROWS_TARGET = 4        # rows a lane group a split aims at
MAX_SPLIT = 8          # blocks of one cluster (the portable size)


class Plan(NamedTuple):
    split: int          # S: blocks of one cluster sharing the page range
    pages: int          # pages a split covers (the last split may run short)
    heads: int          # query heads a block (1, 2 or 4)
    head_blocks: int    # blocks along one kv head's G query heads
    lanes: int          # lanes holding one K/V row
    rows: int           # rows a lane group stages a ring stage
    stages: int         # ring stages (1, or 2 when a split needs more rows)
    blocks: int         # the grid: B × KV × head_blocks × split


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=4096)
def plan(b: int, kvh: int, g: int, hd: int, ps: int, p_max: int,
         dtype: torch.dtype) -> Plan:
    """Layout of one launch from shapes alone (never the lengths: the
    device-resident decode burst must not read them back).  ``dtype`` is
    the pages'.  A block holds up to 4 query heads (``heads ×
    LANE_ELEMS ≤ ACC_MAX``), more heads take more blocks.  The block
    table's ``p_max`` pages are split over S ≤ 8 blocks of a cluster so
    that a lane group holds about ROWS_TARGET rows, with S = ⌈p_max /
    pages⌉ (no split starts past the table).  The split depends on the
    table's width alone, not on the batch: an idle slot's blocks exit at
    once."""
    e = LANE_ELEMS[dtype]
    lanes = _pow2_at_least(-(-hd // e))
    if lanes > 32:
        raise ValueError(f"paged_attn: hd={hd} > {32 * e}: a K/V row takes "
                         f"at most 32 lanes of {e} elements")
    heads = 1
    while heads * 2 <= min(g, ACC_MAX // e):
        heads *= 2
    head_blocks = -(-g // heads)
    groups = NW * 32 // lanes
    target = max(1, groups * ROWS_TARGET // ps)
    pages = -(-p_max // min(MAX_SPLIT, -(-p_max // target)))
    s = -(-p_max // pages)
    k = -(-(pages * ps) // groups)         # rows a lane group holds
    rows = min(ROWS_MAX, k)
    return Plan(s, pages, heads, head_blocks, lanes, rows,
                1 if k <= rows else 2, b * kvh * head_blocks * s)


def paged_attn_plain(q, k_pages, v_pages, block_tables, lengths,
                     window: Optional[int] = None, k_scale=None,
                     v_scale=None) -> torch.Tensor:
    """Plain version of :func:`paged_attn`: the gather-then-softmax oracle
    in f32, with idle rows (length 0) set to the kernel's exact zeros."""
    out = paged_attn_ref(q, k_pages, v_pages, block_tables, lengths,
                         window=window, k_scale=k_scale,
                         v_scale=v_scale).float()
    live = (lengths > 0)[:, None, None, None]
    return torch.where(live, out, torch.zeros_like(out))


def paged_attn(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
               block_tables: torch.Tensor, lengths: torch.Tensor,
               window: Optional[int] = None,
               k_scale: Optional[torch.Tensor] = None,
               v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One paged GQA decode step → (B, KV, G, hd) f32.

    q: (B, KV, G, hd) f32/bf16; k/v_pages: (P, page_size, KV, hd) of q's
    dtype, or int8 with ``k_scale``/``v_scale`` (P, page_size, KV) f32;
    block_tables: (B, P_max) int32; lengths: (B,) int32 (0 = idle slot,
    which comes back as exact zeros); ``window``: attend to the last
    ``window`` keys only."""
    if q.device.type == "cpu":
        return paged_attn_plain(q, k_pages, v_pages, block_tables, lengths,
                                window, k_scale, v_scale)
    build.refuse_grad("paged_attn", q, k_pages, v_pages, k_scale, v_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_attn: tensors on {q.device} — the kernel "
                           "runs on CUDA only")
    b, kvh, g, hd = q.shape
    n_pages, ps, kv2, hd2 = k_pages.shape
    p_max = block_tables.shape[1]
    quantized = k_scale is not None
    if (kv2, hd2) != (kvh, hd) or v_pages.shape != k_pages.shape:
        raise ValueError("paged_attn: page shapes do not match q")
    if quantized != (k_pages.dtype == torch.int8) or (
            quantized and (v_scale is None or k_scale.dtype != torch.float32
                           or k_scale.shape != (n_pages, ps, kvh)
                           or v_scale.shape != k_scale.shape)):
        raise ValueError("paged_attn: int8 pages need (P, page_size, KV) "
                         "f32 k_scale and v_scale, other pages none")
    if q.dtype not in (torch.float32, torch.bfloat16) or (
            not quantized and k_pages.dtype != q.dtype):
        raise ValueError(f"paged_attn: q {q.dtype} with pages "
                         f"{k_pages.dtype} is not supported")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attn: block_tables and lengths must be int32")
    if window is not None and window < 1:
        raise ValueError(f"paged_attn: window {window} < 1")
    tensors = [q, k_pages, v_pages, block_tables, lengths]
    if quantized:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_attn: inputs must be contiguous on "
                             f"{q.device}")
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=q.device)
    if b == 0 or p_max == 0:
        out.zero_()
        return out
    p = plan(b, kvh, g, hd, ps, p_max, k_pages.dtype)
    vec = (hd % LANE_ELEMS[k_pages.dtype] == 0 and k_pages.data_ptr() % 16 == 0
           and v_pages.data_ptr() % 16 == 0)
    code = build.library().paged_attn_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, kvh, g, hd, ps, p_max, -1 if window is None else int(window),
        _KIND[q.dtype], _KIND[k_pages.dtype], p.split, p.pages, p.heads,
        p.rows, p.stages, p.lanes, int(vec),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, "paged_attn")
    build.count_launch(paged_attn)
    paged_attn.last_plan = p
    paged_attn.last_kernel = "16-byte copies" if vec else "scalar loads"
    return out


paged_attn.launches = 0
paged_attn.last_plan = None
paged_attn.last_kernel = None
