"""Full-sequence attention: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attn.py::flash_attn``
(``_flash_kernel``); the kernel itself is ``csrc/flash_attn.cu`` (its
header says what bounds it on the H100 and how the design answers that).

``flash_attn(q, k, v, causal, window)`` takes the model's layouts: q
(B, T, H, hd) and k / v (B, T, KV, hd) with H a multiple of KV (head h
reads kv head h // (H / KV)), any strides with a unit last stride — the
kernel reads them in place, no transposed copy — and returns
(B, T, H, hd) f32.  The
TPU kernel's (BH, T, D) signature is the case H = KV = 1
(``ops.attention``).  Every T is exact: ragged tiles are masked, never
padded with keys that would join a non-causal softmax.  A causal
``window`` (an ``attn_local`` layer's) lets query t see keys s with
t - window < s ≤ t, the reference's ``causal_mask``; without ``causal`` it
is ignored, as the reference ignores it.

On the card bf16 inputs with head dim 32, 64, 128 or 256 and rows on
16-byte boundaries (the model's layout) take a tensor-core kernel
(``wgmma`` at hd 64, ``mma.sync`` at 32, 128 and 256 — gemma's); other
inputs (f32, other head dims up to ``MAX_HD``, or other alignments) take
the f32-FMA kernel of the same file.
``flash_attn.last_kernel`` names the route the last launch took
("tensor cores" or "f32 FMA").

Dispatch is by device: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  ``flash_attn.launches`` counts
kernel launches only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attn_ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_HD = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attn: tensors on {q.device} — the kernel "
                           "runs on CUDA only (CPU tensors take the plain "
                           "version)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attn: q must be (B, T, H, hd) and k, v "
                         f"(B, T, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, hd = q.shape
    kv = k.shape[2]
    if k.shape[:2] != (b, t) or k.shape[3] != hd or kv == 0 or h % kv:
        raise ValueError(f"flash_attn: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if hd > MAX_HD or hd % 4:
        raise ValueError(f"flash_attn: head dim {hd} must be a multiple of "
                         f"4 and at most {MAX_HD}")
    for x in (q, k, v):
        if x.dtype != q.dtype or x.dtype not in DTYPES:
            raise ValueError(f"flash_attn: q, k, v must all be f32 or all "
                             f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
        if x.device != q.device or x.stride(3) != 1:
            raise ValueError(f"flash_attn: q, k, v must lie on {q.device} "
                             "with a unit last stride")
    if window is not None and window < 1:
        raise ValueError(f"flash_attn: window {window} must be ≥ 1")


def flash_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True,
                     window: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`flash_attn`: each head's softmax attention
    through ``ref.flash_attn_ref`` on (B·H, T, hd) copies, f32."""
    b, t, h, hd = q.shape
    g = h // k.shape[2]

    def heads_first(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, hd)

    o = flash_attn_ref(heads_first(q),
                       heads_first(k.repeat_interleave(g, dim=2)),
                       heads_first(v.repeat_interleave(g, dim=2)), causal,
                       window)
    return o.reshape(b, h, t, hd).permute(0, 2, 1, 3).contiguous()


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True,
               window: Optional[int] = None) -> torch.Tensor:
    """Softmax attention, causal or not, optionally over a causal sliding
    ``window``: q (B, T, H, hd), k / v (B, T, KV, hd), f32 or bf16 →
    (B, T, H, hd) f32."""
    if q.device.type == "cpu":
        return flash_attn_plain(q, k, v, causal, window)
    build.refuse_grad("flash_attn", q, k, v)
    _check(q, k, v, window)
    b, t, h, hd = q.shape
    out = torch.empty((b, t, h, hd), dtype=torch.float32, device=q.device)
    if b == 0 or t == 0:
        return out
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    used_mma = ctypes.c_int(0)
    code = build.library().flash_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, h,
        k.shape[2], hd, strides, int(causal), int(window or 0),
        int(q.dtype == torch.bfloat16),
        ctypes.byref(used_mma),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, "flash_attn")
    build.count_launch(flash_attn)
    flash_attn.last_kernel = "tensor cores" if used_mma.value else "f32 FMA"
    return out


flash_attn.launches = 0
flash_attn.last_kernel = None
