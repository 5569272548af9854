"""Full-sequence attention: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attn.py::flash_attn``
(``_flash_kernel``); the kernel itself is ``csrc/flash_attn.cu`` (its
header says what bounds it on the H100 and how the design answers that).

``flash_attn(q, k, v, causal, window, prefix_len)`` takes the model's
layouts: q (B, T, H, hd) and k / v (B, S, KV, hd) with H a multiple of
KV (head h reads kv head h // (H / KV)), any strides with a unit last
stride — the kernel reads them in place, no transposed copy — and
returns (B, T, H, hd) f32.  S = T when ``causal``; a non-causal call
takes any S (the encoder-decoder's cross-attention: decoder queries
over the encoder's frames).  The TPU kernel's (BH, T, D) signature is
the case H = KV = 1 (``ops.attention``).  Every T and S is exact:
ragged tiles are masked, never padded with keys that would join a
non-causal softmax.  A causal ``window`` (an ``attn_local`` layer's)
lets query t see keys s with t - window < s ≤ t, and a causal
``prefix_len`` (the prefix-LM's image positions) lets every query see
the keys s < prefix_len besides — the reference's ``causal_mask``;
without ``causal`` both are ignored, as the reference ignores them.

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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: Optional[int], prefix_len: Optional[int]) -> None:
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attn: tensors on {q.device} — the kernel "
                           "runs on CUDA only (CPU tensors take the plain "
                           "version)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attn: q must be (B, T, H, hd) and k, v "
                         f"(B, S, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, hd = q.shape
    kv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kv == 0 or h % kv:
        raise ValueError(f"flash_attn: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if causal and k.shape[1] != t:
        raise ValueError(f"flash_attn: causal attention needs as many keys "
                         f"as queries, got S={k.shape[1]} for T={t}")
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
    if prefix_len is not None and prefix_len < 0:
        raise ValueError(f"flash_attn: prefix_len {prefix_len} must be ≥ 0")


def flash_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, window: Optional[int] = None,
                     prefix_len: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`flash_attn`: each head's softmax attention
    through ``ref.flash_attn_ref`` on (B·H, T, hd) and (B·H, S, hd)
    copies, f32."""
    b, t, h, hd = q.shape
    g = h // k.shape[2]
    if causal and k.shape[1] != t:
        raise ValueError(f"flash_attn: causal attention needs as many keys "
                         f"as queries, got S={k.shape[1]} for T={t}")

    def heads_first(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], hd)

    o = flash_attn_ref(heads_first(q),
                       heads_first(k.repeat_interleave(g, dim=2)),
                       heads_first(v.repeat_interleave(g, dim=2)), causal,
                       window, prefix_len)
    return o.reshape(b, h, t, hd).permute(0, 2, 1, 3).contiguous()


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True, window: Optional[int] = None,
               prefix_len: Optional[int] = None) -> torch.Tensor:
    """Softmax attention, causal or not, optionally over a causal sliding
    ``window`` and with a causal bidirectional prefix of ``prefix_len``
    keys: q (B, T, H, hd), k / v (B, S, KV, hd) (S = T when causal), f32
    or bf16 → (B, T, H, hd) f32."""
    if q.device.type == "cpu":
        return flash_attn_plain(q, k, v, causal, window, prefix_len)
    build.refuse_grad("flash_attn", q, k, v)
    _check(q, k, v, causal, window, prefix_len)
    b, t, h, hd = q.shape
    out = torch.empty((b, t, h, hd), dtype=torch.float32, device=q.device)
    if b == 0 or t == 0:
        return out
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    used_mma = ctypes.c_int(0)
    code = build.library().flash_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t,
        k.shape[1], h, k.shape[2], hd, strides, int(causal),
        int(window or 0), int(prefix_len or 0),
        int(q.dtype == torch.bfloat16), ctypes.byref(used_mma),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, "flash_attn")
    build.count_launch(flash_attn)
    flash_attn.last_kernel = "tensor cores" if used_mma.value else "f32 FMA"
    return out


flash_attn.launches = 0
flash_attn.last_kernel = None
