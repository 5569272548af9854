"""The Mamba-1 block (a port of ``repro.models.ssm``'s Mamba half):
init, the selective scan, and the block's four paths — full sequence
(training, capture, evaluation), dense-cache prefill, chunked prefill
that carries a serve slot's state in, and one decode token a row.

Conventions follow ``models.layers``: params are plain dicts, linear
weights are stored (in, out), ``caps`` records each linear's input under
``mamba.in_proj`` … ``mamba.out_proj`` (the reference's names), and the
caches are updated IN PLACE — the dense cache ``{"conv": (B, ck-1, Di),
"ssm": (B, Di, N)}`` of static mode, and in continuous mode the same
leaves with one row per serve slot (``serve.kvpool.StatePool`` resets a
row at admission).  ``a_log``, ``dt_bias`` and ``d`` are f32 in a bf16
model, and the ``ssm`` state is f32, as in the reference.

The scan is jnp in the reference (``lax.associative_scan``), not a
Pallas kernel; here it is a log-depth Hillis–Steele scan over T in torch
ops, which autograd differentiates (the trainer's route runs through
it).  It multiplies the same pairs in another order than XLA's
up-sweep/down-sweep, so the two agree to f32 rounding (relative ~1e-6 at
T = 64), not bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import random as rnd
from repro_torch.models.base import ArchConfig
from repro_torch.models.layers import (Params, _dense_init, _normal, linear,
                                       rmsnorm, rmsnorm_init, sub_keys)


def _uniform(rng, shape) -> torch.Tensor:
    if isinstance(rng, torch.Generator):
        return torch.rand(shape, generator=rng, device=rng.device,
                          dtype=torch.float32)
    return rnd.uniform(rng, shape)


def mamba_init(rng, cfg: ArchConfig, dtype) -> Params:
    """The reference's ``mamba_init``: ``split(key, 6)``, S4D-real A,
    the dt bias as the inverse softplus of dt drawn log-uniform in
    [1e-3, 1e-1] from ``ks[4]``, ``conv_w`` normal from ``ks[1]``."""
    d, di, n, r, ck = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                       cfg.ssm_conv)
    dev = rng.device
    ks = sub_keys(rng, 6)
    a = torch.arange(1, n + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(di, 1)
    in_proj = _dense_init(ks[0], d, 2 * di, dtype)
    conv_w = (_normal(ks[1], (di, ck), 1.0, torch.float32)
              / math.sqrt(ck)).to(dtype)
    x_proj = _dense_init(ks[2], di, r + 2 * n, dtype)
    dt_proj = _dense_init(ks[3], r, di, dtype, scale=r ** -0.5)
    dt_init = torch.exp(_uniform(ks[4], (di,))
                        * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))   # inverse softplus
    return {
        "ln": rmsnorm_init(d, dtype, dev),
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": dt_bias.float(),
        "a_log": torch.log(a),
        "d": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": _dense_init(
            ks[5], di, d, dtype, scale=1.0 / math.sqrt(di * 2 * cfg.num_layers)),
    }


def mamba_cache_init(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    """The decode state of one block: the conv window at ``dtype``, the
    SSM state in f32."""
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def _mamba_ssm_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, a: torch.Tensor,
                    init: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan, parallel over T.

    dt, x: (B, T, Di) f32; b, c: (B, T, N) f32; a: (Di, N) f32 (negative);
    ``init`` (B, Di, N): the carried-in state of a chunk continuation,
    replayed through the cumulative decay as ``A_{1..t}·s0``.  Returns
    (y (B, T, Di), the last state (B, Di, N)).

    The pairs (Ā_t, B̄x_t) compose as (a2·a1, a2·b1 + b2); after round s
    each position holds the composition of the 2^s positions ending at
    it, so ⌈log2 T⌉ rounds of whole-tensor products give every prefix.
    """
    abar = torch.exp(dt[..., None] * a[None, None])          # (B,T,Di,N)
    bx = (dt * x)[..., None] * b[:, :, None, :]              # (B,T,Di,N)
    t = abar.shape[1]
    shift = 1
    while shift < t:
        a_hi, b_hi = abar[:, shift:], bx[:, shift:]
        a_lo, b_lo = abar[:, :-shift], bx[:, :-shift]
        abar = torch.cat([abar[:, :shift], a_hi * a_lo], dim=1)
        bx = torch.cat([bx[:, :shift], a_hi * b_lo + b_hi], dim=1)
        shift *= 2
    states = bx
    if init is not None:
        states = states + abar * init[:, None]
    y = torch.einsum("btdn,btn->btd", states, c)
    return y, states[:, -1]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``), in its formula."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _conv(stacked: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """The depthwise causal conv: (B, T, Di, ck) windows · (Di, ck)."""
    return torch.einsum("btdk,dk->btd", stacked, conv_w)


def mamba_apply(p: Params, h: torch.Tensor, cfg: ArchConfig, *,
                caps: Optional[Dict[str, torch.Tensor]] = None,
                cache: Optional[Params] = None,
                pos: Optional[torch.Tensor] = None,
                paged: Optional[Params] = None,
                prefix: str = "mamba.") -> torch.Tensor:
    """Pre-norm Mamba mixer with residual: returns ``h + mamba(h)``; the
    cache modes update ``cache`` in place.

    Modes (the reference's ``mamba_apply``):
      full sequence (cache None): causal conv over T, the scan from zero;
      dense-cache prefill (cache given, T > 1, ``paged`` None): as the
          full sequence, and the last ck-1 conv inputs and the last state
          fill the cache;
      chunked prefill (cache given, T > 1, ``paged`` with host ints
          ``slot`` / ``start`` / ``length``): the chunk continues row
          ``slot`` of the slot-pooled state — the conv window carried in,
          the scan seeded with the carried state — and positions past
          ``length`` are identity steps (dt 0), so the carry-out is the
          state at the last valid token;
      decode (T = 1): one step of every row; with ``paged`` (continuous
          batching) ``pos`` (B,) marks live rows, and idle or prefilling
          rows (``pos`` < 0) keep their state.
    """
    di, n, r, ck = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    t = h.shape[1]
    h_in = rmsnorm(p["ln"], h, cfg.norm_eps)
    xz = linear(h_in, p["in_proj"], caps=caps, name=f"{prefix}in_proj")
    x, z = torch.split(xz, di, dim=-1)                      # (B, T, Di) each

    conv_w = p["conv_w"].float()                           # (Di, ck)
    x32 = x.float()
    chunk = cache is not None and t > 1 and paged is not None
    prefill = cache is not None and t > 1 and not chunk

    if chunk:
        slot, start, length = paged["slot"], paged["start"], paged["length"]
        conv0 = cache["conv"][slot:slot + 1]
        ssm0 = cache["ssm"][slot:slot + 1]
        # conv over [carried window ; chunk]
        xp = torch.cat([conv0.float(), x32], dim=1)
        xc = _conv(torch.stack([xp[:, i:i + t] for i in range(ck)], dim=-1),
                   conv_w)
        # carry-out: the window ending at the last VALID input
        vc = min(max(length - start, 0), t)
        new_conv = xp[:, vc:vc + ck - 1]
    elif cache is None or prefill:
        xp = torch.nn.functional.pad(x32, (0, 0, ck - 1, 0))
        xc = _conv(torch.stack([xp[:, i:i + t] for i in range(ck)], dim=-1),
                   conv_w)
        new_conv = xp[:, t:]                               # last ck-1 inputs
    else:
        # decode: conv over [cache ; x_t] (the window of the last ck inputs)
        win = torch.cat([cache["conv"].float(), x32], dim=1)
        xc = torch.einsum("btd,dt->bd", win, conv_w)[:, None, :]
        new_conv = win[:, 1:]
    xc = xc + p["conv_b"].float()[None, None]
    xc = torch.nn.functional.silu(xc)

    dbc = linear(xc.to(h.dtype), p["x_proj"], caps=caps,
                 name=f"{prefix}x_proj").float()
    dt_r, b, c = torch.split(dbc, [r, n, n], dim=-1)
    dt = linear(dt_r.to(h.dtype), p["dt_proj"], caps=caps,
                name=f"{prefix}dt_proj").float()
    dt = _softplus(dt + p["dt_bias"][None, None])
    a = -torch.exp(p["a_log"])                             # (Di, N)

    if chunk:
        # padded tail positions: dt = 0 ⇒ abar = 1, bx = 0 — identity
        # steps, so the carry-out is the state at the last valid token
        valid = (start + torch.arange(t, device=h.device)) < length
        dt = torch.where(valid[None, :, None], dt, torch.zeros_like(dt))
        y, last = _mamba_ssm_scan(dt, xc, b, c, a, init=ssm0.float())
        cache["conv"][slot] = new_conv[0].to(cache["conv"].dtype)
        cache["ssm"][slot] = last[0].to(cache["ssm"].dtype)
    elif cache is None or prefill:
        y, last = _mamba_ssm_scan(dt, xc, b, c, a)
        if prefill:
            cache["conv"].copy_(new_conv.to(cache["conv"].dtype))
            cache["ssm"].copy_(last.to(cache["ssm"].dtype))
    else:
        abar = torch.exp(dt[:, 0, :, None] * a[None])       # (B, Di, N)
        bx = (dt[:, 0] * xc[:, 0])[..., None] * b[:, 0, None, :]
        ssm = abar * cache["ssm"].float() + bx
        y = torch.einsum("bdn,bn->bd", ssm, c[:, 0])[:, None, :]
        new_conv = new_conv.to(cache["conv"].dtype)
        ssm = ssm.to(cache["ssm"].dtype)
        if paged is not None:
            # continuous batching: idle and prefilling slots keep their
            # rows (pages get this from the scrap page; state rows cannot)
            act = (pos >= 0)[:, None, None]
            new_conv = torch.where(act, new_conv, cache["conv"])
            ssm = torch.where(act, ssm, cache["ssm"])
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(ssm)

    y = y + p["d"].float()[None, None] * xc
    y = y * torch.nn.functional.silu(z.float())
    out = linear(y.to(h.dtype), p["out_proj"], caps=caps,
                 name=f"{prefix}out_proj")
    return h + out
