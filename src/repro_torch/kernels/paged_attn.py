"""Paged GQA decode attention: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/paged_attn.py::paged_attn`` (its
bf16/f32 and its int8-page variants); the kernel is ``csrc/paged_attn.cu``.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  ``paged_attn.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attn_ref

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_NT, _MAX_ACC = 128, 8                 # csrc/paged_attn.cu's block layout
_SMEM_LIMIT = 48 * 1024                # static launch, no opt-in


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
    if g * hd > _NT * _MAX_ACC:
        raise ValueError(f"paged_attn: G*hd={g * hd} > {_NT * _MAX_ACC}")
    if 4 * (g * hd + 2 * ps * hd + g * ps + 3 * g) > _SMEM_LIMIT:
        raise ValueError("paged_attn: page too large for shared memory")
    tensors = [q, k_pages, v_pages, block_tables, lengths]
    if quantized:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_attn: inputs must be contiguous on "
                             f"{q.device}")
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=q.device)
    code = build.library().paged_attn_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, kvh, g, hd, ps, p_max, -1 if window is None else int(window),
        _KIND[q.dtype], _KIND[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, "paged_attn")
    paged_attn.launches += 1
    return out


paged_attn.launches = 0
