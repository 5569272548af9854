"""Public wrappers the model and the pruner call: packing, the packed
matmul dispatch, paged attention, full-sequence attention, the
calibration Hessian and the 2:4 Eq. (12) mask.

Dispatch follows the device of the tensors: CPU tensors take the plain
PyTorch versions, CUDA tensors the hand-written kernels, and no ``try``
ever gives way from a kernel to its plain version.  The one exception is
the explicit, scoped :func:`override_dispatch` — the counterpart of the
reference's ``ops.override_dispatch`` — which forces the plain versions
on CUDA so that a run on the card can be held against them.  Its scope
is the calling thread's: a check in the main thread reroutes none of the
serve front end's replica threads, and the other way round.

Unlike the reference (which pads weights and sequences to 128-multiples
on every call), nothing here pads: the kernels mask ragged edges
themselves.  The reference's ``attention`` pads T with zero keys that
join a non-causal softmax; :func:`attention` is exact at every T.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attn import flash_attn, flash_attn_plain
from repro_torch.kernels.hessian_accum import (hessian_accum,
                                               hessian_accum_plain,
                                               hessian_accum_weighted,
                                               hessian_accum_weighted_plain)
from repro_torch.kernels.nm_select import nm_select, nm_select_plain
from repro_torch.kernels.nm_spmm import (DECODE_MAX_M, nm_spmm,
                                         nm_spmm_decode, nm_spmm_decode_plain,
                                         nm_spmm_plain)
from repro_torch.kernels.paged_attn import paged_attn, paged_attn_plain

KERNELS = {"nm_spmm": nm_spmm, "nm_spmm_decode": nm_spmm_decode,
           "paged_attn": paged_attn, "hessian_accum": hessian_accum,
           "nm_select": nm_select, "flash_attn": flash_attn}

_LOCAL = threading.local()  # .plain: this thread's override stack


def _stack() -> list:
    st = getattr(_LOCAL, "plain", None)
    if st is None:
        st = _LOCAL.plain = []
    return st


@contextlib.contextmanager
def override_dispatch(plain: bool = True) -> Iterator[None]:
    """Inside the scope, ``plain=True`` sends this thread's CUDA tensors
    to the plain PyTorch versions instead of the kernels.  Scopes nest."""
    st = _stack()
    st.append(bool(plain))
    try:
        yield
    finally:
        st.pop()


def _plain() -> bool:
    st = _stack()
    return bool(st) and st[-1]


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset, over every
    thread (the counters are bumped under a lock)."""
    with build._COUNT_LOCK:
        return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    with build._COUNT_LOCK:
        for fn in KERNELS.values():
            fn.launches = 0


# ----------------------------------------------------------------------
def compress_24(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense 2:4-sparse (K, N) → packed (vals, idx). See ref.compress_24."""
    return ref.compress_24(w)


def nm_matmul(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *,
              activation: Optional[str] = None,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = act(x @ w_sparse + bias) for packed 2:4 weights.

    x: (..., K); vals/idx: (K/2, N) → (..., N) in ``out_dtype`` (x's
    dtype by default).  The split is the reference's: M ≤ 128 rows
    (every decode step, every 32-token prefill chunk) take the decode
    kernel with bias and activation fused; larger M takes the tiled
    kernel with the epilogue applied after.
    """
    k = x.shape[-1]
    n = vals.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    plain = _plain()
    if x2.shape[0] <= DECODE_MAX_M:
        fn = nm_spmm_decode_plain if plain else nm_spmm_decode
        y = fn(x2, vals, idx, bias, activation)
    else:
        y = (nm_spmm_plain if plain else nm_spmm)(x2, vals, idx)
        if bias is not None:
            y = y + bias.reshape(-1).float()
        y = ref.activate(y, activation)
    return y.reshape(*lead, n).to(out_dtype or x.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, window: Optional[int] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged GQA decode attention over block-table pages.

    q: (B, KV, G, hd); k/v_pages: (P, page_size, KV, hd); block_tables:
    (B, P_max) int32; lengths: (B,) int32.  Returns (B, KV, G, hd) in
    the pages' dtype, or f32 when ``k_scale``/``v_scale`` engage the int8
    pages (dequantized row-wise at load)."""
    fn = paged_attn_plain if _plain() else paged_attn
    out = fn(q, k_pages, v_pages, block_tables, lengths, window,
             k_scale, v_scale)
    if k_scale is not None:
        return out
    return out.to(v_pages.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              prefix_len: Optional[int] = None) -> torch.Tensor:
    """Softmax attention, f32 out, in either layout:

    * the reference's (BH, T, D) q with (BH, S, D) k, v → (BH, T, D);
    * the model's (B, T, H, hd) q with (B, S, KV, hd) k / v, H a
      multiple of KV → (B, T, H, hd), read in place through strides.

    S = T when ``causal``; any S otherwise (cross-attention).  A causal
    ``window`` lets query t see keys s with t - window < s ≤ t (an
    ``attn_local`` layer's band), a causal ``prefix_len`` every key
    s < prefix_len besides (the prefix-LM's bidirectional prefix)."""
    fn = flash_attn_plain if _plain() else flash_attn
    if q.dim() == 3:
        return fn(q[:, :, None], k[:, :, None], v[:, :, None],
                  causal, window, prefix_len)[:, :, 0]
    return fn(q, k, v, causal, window, prefix_len)


def hessian_update(x_tokens: torch.Tensor, h: torch.Tensor, alpha: float,
                   beta: float) -> torch.Tensor:
    """H ← β·H + α·2·XᵀX in place for token-major X (T, m): the streaming
    Hessian's one launch (``core.hessian``)."""
    fn = hessian_accum_plain if _plain() else hessian_accum
    return fn(x_tokens, h, alpha, beta)


def hessian_update_weighted(x_tokens: torch.Tensor, w: torch.Tensor,
                            h: torch.Tensor,
                            count: torch.Tensor) -> torch.Tensor:
    """The weighted streaming Hessian's one call (a MoE expert's routed
    tokens): H ← H·c/max(c+Σw, 1e-12) + 2·Xᵀdiag(w)X/max(c+Σw, 1e-12),
    c ← c + Σw, with the 0-dim count ``count`` on the tensors' device."""
    fn = hessian_accum_weighted_plain if _plain() else hessian_accum_weighted
    return fn(x_tokens, w, h, count)


def hessian_xxt(x: torch.Tensor) -> torch.Tensor:
    """H = 2·x·xᵀ for x (m, T), f32 (the reference's signature).  The
    kernel reads token-major xᵀ: a view when x is the transpose of a
    contiguous (T, m) tensor, a copy when x is a contiguous (m, T) one."""
    m = x.shape[0]
    h = torch.empty((m, m), dtype=torch.float32, device=x.device)
    return hessian_update(x.T.contiguous(), h, 1.0, 0.0)


def nm_select_mask(w: torch.Tensor, hinv: torch.Tensor) -> torch.Tensor:
    """Solution 𝔐 2:4 mask (bool, True = pruned) for paper-orientation w
    (R, C) and its (C, C) inverse Hessian — a strided block of a larger
    inverse is read in place."""
    return (nm_select_plain if _plain() else nm_select)(w, hinv)
