"""The recurrent blocks (a port of ``repro.models.ssm``): Mamba-1, and the
xLSTM's mLSTM (matrix memory) and sLSTM (scalar memory).  Each block has
the reference's init and four paths — full sequence (training, capture,
evaluation), dense-cache prefill, chunked prefill that carries a serve
slot's state in, and one decode token a row.

Conventions follow ``models.layers``: params are plain dicts, linear
weights are stored (in, out), ``caps`` records each linear's input under
the reference's names (``mamba.in_proj`` … ``mamba.out_proj``,
``mlstm.wq`` … ``mlstm.wo``, ``slstm.wz`` … ``slstm.wo``), and the caches
are updated IN PLACE — the dense cache of static mode, and in continuous
mode the same leaves with one row per serve slot
(``serve.kvpool.StatePool`` resets a row to the block's init state at
admission).  Mamba's cache is ``{"conv": (B, ck-1, Di), "ssm": (B, Di,
N)}``, the mLSTM's ``{"c": (B, NH, hd, hd), "n": (B, NH, hd), "m": (B,
NH)}`` and the sLSTM's ``{"c", "n", "h", "m"}`` each (B, D); the recurrent
state is f32 whatever the model dtype, and the stabiliser ``m`` starts at
-1e30, as in the reference.  Mamba's ``a_log``, ``dt_bias`` and ``d`` and
the mLSTM's gate projections ``wi`` / ``wf`` (D, NH) and biases are f32 in
a bf16 model; the mLSTM's gates are no prunable linears.

The scan and both xLSTM cells are jnp in the reference, not Pallas
kernels; here they are torch ops, which autograd differentiates (the
trainer's route runs through them).  The Mamba scan is a log-depth
Hillis–Steele scan over T: it multiplies the same pairs in another order
than XLA's ``associative_scan``, so the two agree to f32 rounding
(relative ~1e-6 at T = 64), not bit for bit.  The mLSTM's parallel and
chunkwise forms work in a (B, NH, T, S) layout — the reference's (B, T,
S, NH) transposed, the same operations in the same order.  The sLSTM
takes its four per-head recurrences as one batched product a step.

Tensor-parallel serving (``dist.sharding``): a block reads its rank's
width from its weights — Mamba's d_inner channels from ``in_proj`` (a
rank's block of x beside its block of z), the mLSTM's heads from
``wq``, the sLSTM's from ``r_z`` — and its state rows have that width;
the down-projections (and Mamba's ``x_proj``) go through
``layers.linear_rows``, one all-reduce each.  On one device every
weight is whole and no collective runs.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import random as rnd
from repro_torch.models.base import ArchConfig
from repro_torch.models.layers import (Params, _dense_init, _normal, linear,
                                       linear_rows, out_dim, rmsnorm,
                                       rmsnorm_init, sub_keys)


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


def mamba_cache_init(cfg: ArchConfig, batch: int, dtype, device,
                     parts: int = 1) -> Params:
    """The decode state of one block: the conv window at ``dtype``, the
    SSM state in f32; ``parts`` > 1: a rank's d_inner / parts channels
    (tensor-parallel serving, ``dist.sharding.state_split``)."""
    di = cfg.d_inner // parts
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                           device=device),
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

    Tensor-parallel (a rank's d_inner channels, ``dist.sharding``): the
    rank's blocks of x and z, conv, dt and the scan; ``x_proj`` row-
    parallel, so dt, B and C come out of an all-reduce whole and
    bit-equal on every rank; ``out_proj`` row-parallel.
    """
    n, r, ck = cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    di = out_dim(p["in_proj"]) // 2           # the rank's channels
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

    dbc = linear_rows(xc.to(h.dtype), p["x_proj"], full=cfg.d_inner,
                      caps=caps, name=f"{prefix}x_proj").float()
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
    out = linear_rows(y.to(h.dtype), p["out_proj"], full=cfg.d_inner,
                      caps=caps, name=f"{prefix}out_proj")
    return h + out


# ======================================================================
# xLSTM mLSTM (matrix memory)
# ======================================================================
# the quadratic parallel form holds (B, NH, T, T) decay and score
# matrices, so long sequences take the CHUNKWISE form (intra-chunk
# parallel, inter-chunk recurrent state), as the reference does
MLSTM_CHUNK_THRESHOLD = 8192
MLSTM_CHUNK = 1024


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, T, NH, ...) → the (B, NH, T, ...) view."""
    return x.transpose(1, 2)


def _causal(t: int, device) -> torch.Tensor:
    return torch.ones((t, t), dtype=torch.bool, device=device).tril()


def _mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logi: torch.Tensor, logf: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quadratic parallel form: D_ts = exp(F_t − F_s + logi_s − m_t)
    for s ≤ t, F = cumsum(logf), stabilised by the row max m_t.

    q (pre-scaled), k, v: (B, T, NH, hd) f32; logi, logf: (B, T, NH).
    Returns (h (B, T, NH, hd), F (B, T, NH))."""
    t = q.shape[1]
    fcum = torch.cumsum(logf, dim=1)                        # (B, T, NH)
    fh, ih = _heads(fcum), _heads(logi)                     # (B, NH, T)
    dmat = fh[..., :, None] - fh[..., None, :] + ih[..., None, :]
    dmat = dmat.masked_fill(~_causal(t, q.device), float("-inf"))
    m = dmat.amax(dim=-1, keepdim=True)                     # (B, NH, T, 1)
    dstab = torch.exp(dmat - m)                             # (B, NH, T, S)
    del dmat
    qh, kh, vh = _heads(q), _heads(k), _heads(v)            # (B, NH, T, hd)
    scores = (qh @ kh.transpose(-1, -2)) * dstab
    del dstab
    norm = torch.maximum(scores.sum(dim=-1).abs(), torch.exp(-m[..., 0]))
    y = (scores @ vh) / norm[..., None]
    return _heads(y), fcum


def _mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logi: torch.Tensor, logf: torch.Tensor, chunk: int,
                     init: Optional[Tuple[torch.Tensor, ...]] = None
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The chunkwise-parallel stabilised mLSTM: a loop over chunks of
    ``chunk`` positions carrying the state (c, n, m) — the parallel form
    inside a chunk, the carried state decayed into it.

    q (pre-scaled), k, v: (B, T, NH, hd) f32; logi, logf: (B, T, NH);
    ``init`` the carried-in (c0 (B, NH, hd, hd), n0 (B, NH, hd), m0 (B,
    NH)), the fresh state (zeros, m = -1e30) when None.  Returns (h (B, T,
    NH, hd), the final (c, n, m)).  Matches the quadratic form at
    O(T·chunk) memory."""
    b, t, nh, hd = q.shape
    assert t % chunk == 0
    if init is None:
        init = (q.new_zeros((b, nh, hd, hd)), q.new_zeros((b, nh, hd)),
                q.new_full((b, nh), -1e30))
    c0, n0, m0 = init
    qh, kh, vh = _heads(q), _heads(k), _heads(v)            # (B, NH, T, hd)
    ih, fh = _heads(logi), _heads(logf)                     # (B, NH, T)
    upper = ~_causal(chunk, q.device)
    hs = []
    for s0 in range(0, t, chunk):
        qc, kc, vc = (x[:, :, s0:s0 + chunk] for x in (qh, kh, vh))
        lic, lfc = ih[..., s0:s0 + chunk], fh[..., s0:s0 + chunk]
        fcum = torch.cumsum(lfc, dim=-1)                    # (B, NH, C)
        # intra-chunk decay D_ts = F_t − F_s + i_s (s ≤ t)
        dmat = fcum[..., :, None] - fcum[..., None, :] + lic[..., None, :]
        dmat = dmat.masked_fill(upper, float("-inf"))
        a_max = dmat.amax(dim=-1)                           # (B, NH, C)
        m_inter = fcum + m0[..., None]
        m_t = torch.maximum(a_max, m_inter)
        msafe = torch.where(torch.isfinite(m_t), m_t, torch.zeros_like(m_t))
        intra = torch.exp(dmat - msafe[..., None])
        del dmat
        scores = (qc @ kc.transpose(-1, -2)) * intra
        del intra
        w_inter = torch.exp(m_inter - msafe)                # (B, NH, C)
        num = scores @ vc + w_inter[..., None] * (qc @ c0)
        lsum = scores.sum(dim=-1) + w_inter * (qc @ n0[..., None])[..., 0]
        hs.append(num / torch.maximum(lsum.abs(),
                                      torch.exp(-msafe))[..., None])
        # the carry: decayed by the whole chunk, this chunk's keys
        # absorbed at their remaining decay
        f_all = fcum[..., -1]                               # (B, NH)
        rest = f_all[..., None] - fcum + lic                # (B, NH, C)
        m1 = torch.maximum(f_all + m0, rest.amax(dim=-1))
        wts = torch.exp(rest - m1[..., None])
        decay = torch.exp(f_all + m0 - m1)
        wk = kc * wts[..., None]                            # (B, NH, C, hd)
        c0 = decay[..., None, None] * c0 + wk.transpose(-1, -2) @ vc
        n0 = decay[..., None] * n0 + wk.sum(dim=-2)
        m0 = m1
    return _heads(torch.cat(hs, dim=2)), (c0, n0, m0)


def _mlstm_step(c0, n0, m0, q1, k1, v1, li, lf):
    """One decode step of the recurrence: the state c0 (B, NH, hd, hd), n0
    (B, NH, hd), m0 (B, NH) in f32; q1 (pre-scaled), k1, v1 (B, NH, hd);
    the gates li, lf (B, NH).  Returns (h (B, NH, hd), c1, n1, m1)."""
    m1 = torch.maximum(lf + m0, li)
    fw = torch.exp(lf + m0 - m1)[..., None]
    iw = torch.exp(li - m1)[..., None]
    c1 = fw[..., None] * c0 + iw[..., None] * (
        k1[..., :, None] * v1[..., None, :])                # (B, NH, hd, hd)
    n1 = fw * n0 + iw * k1
    num = (q1[..., None, :] @ c1)[..., 0, :]                # (B, NH, hd)
    den = torch.maximum((n1 * q1).sum(dim=-1).abs(), torch.exp(-m1))
    return num / den[..., None], c1, n1, m1


def mlstm_init(rng, cfg: ArchConfig, dtype) -> Params:
    """The reference's ``mlstm_init``: ``split(key, 6)``; the gate
    projections ``wi`` / ``wf`` are f32 (D, NH) at scale 0.1/√D, ``bi``
    zeros and ``bf`` 3.0 (the forget gate open), all f32."""
    d = cfg.d_model
    di = cfg.mlstm_proj * d
    nh = cfg.num_heads
    dev = rng.device
    ks = sub_keys(rng, 6)
    return {
        "ln": rmsnorm_init(d, dtype, dev),
        "wq": _dense_init(ks[0], d, di, dtype),
        "wk": _dense_init(ks[1], d, di, dtype),
        "wv": _dense_init(ks[2], d, di, dtype),
        "wi": _dense_init(ks[3], d, nh, torch.float32,
                          scale=0.1 / math.sqrt(d)),
        "wf": _dense_init(ks[4], d, nh, torch.float32,
                          scale=0.1 / math.sqrt(d)),
        "bi": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "bf": torch.full((nh,), 3.0, dtype=torch.float32, device=dev),
        "wo": _dense_init(
            ks[5], di, d, dtype, scale=1.0 / math.sqrt(di * 2 * cfg.num_layers)),
    }


def mlstm_head_dim(cfg: ArchConfig) -> int:
    """An mLSTM head's width, mlstm_proj·D / NH (not the attention's
    ``cfg.hd``)."""
    return cfg.mlstm_proj * cfg.d_model // cfg.num_heads


def mlstm_cache_init(cfg: ArchConfig, batch: int, dtype, device,
                     parts: int = 1) -> Params:
    """The decode state of one block, f32 whatever ``dtype``: the matrix
    memory, the normaliser and the stabiliser (-1e30: no input yet);
    ``parts`` > 1: a rank's NH / parts heads."""
    nh = cfg.num_heads // parts
    hd = mlstm_head_dim(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, nh, hd, hd), **f32),
            "n": torch.zeros((batch, nh, hd), **f32),
            "m": torch.full((batch, nh), -1e30, **f32)}


def mlstm_projections(p: Params, h: torch.Tensor, cfg: ArchConfig, *,
                      caps: Optional[Dict[str, torch.Tensor]] = None,
                      prefix: str = "mlstm.") -> Tuple[torch.Tensor, ...]:
    """The block's inputs to its cell: the pre-norm projections q
    (pre-scaled by 1/√hd), k, v (B, T, NH, hd) and the gates logi, logf
    (B, T, NH), all f32; the gates are f32 products with the f32 ``wi`` /
    ``wf``, no linears.  NH is the heads of ``wq``: a rank's whole heads
    under tensor parallelism, with its columns of ``wi`` / ``wf`` and its
    entries of ``bi`` / ``bf``."""
    hd = mlstm_head_dim(cfg)
    nh = out_dim(p["wq"]) // hd
    bsz, t, _ = h.shape
    h_in = rmsnorm(p["ln"], h, cfg.norm_eps)
    q, k, v = (linear(h_in, p[key], caps=caps, name=f"{prefix}{key}")
               .reshape(bsz, t, nh, hd).float() for key in ("wq", "wk", "wv"))
    h32 = h_in.float()
    logi = h32 @ p["wi"] + p["bi"]                          # (B, T, NH)
    logf = torch.nn.functional.logsigmoid(h32 @ p["wf"] + p["bf"])
    return q / math.sqrt(hd), k, v, logi, logf


def mlstm_apply(p: Params, h: torch.Tensor, cfg: ArchConfig, *,
                caps: Optional[Dict[str, torch.Tensor]] = None,
                cache: Optional[Params] = None,
                pos: Optional[torch.Tensor] = None,
                paged: Optional[Params] = None,
                prefix: str = "mlstm.") -> torch.Tensor:
    """Pre-norm stabilised mLSTM with residual: returns ``h + mlstm(h)``;
    the cache modes update ``cache`` in place.

    Modes (the reference's ``mlstm_apply``):
      chunked prefill (cache given, T > 1, ``paged`` with host ints
          ``slot`` / ``start`` / ``length``): one chunkwise step over the
          chunk (chunk = T) seeded with row ``slot``'s carry; positions
          past ``length`` contribute nothing (input gate exp(-inf) = 0,
          forget gate log 1 = 0);
      full sequence (cache None) and dense-cache prefill (T > 1): the
          quadratic parallel form, or the chunkwise one when T >
          MLSTM_CHUNK_THRESHOLD and T % MLSTM_CHUNK == 0; the prefill
          then fills the cache with the prompt's summary (the chunkwise
          form's final state);
      decode (T = 1): one step of the recurrence in every row; with
          ``paged`` (continuous batching) rows with ``pos`` < 0 keep
          their state.

    Tensor-parallel: a rank's whole heads (``wq`` / ``wk`` / ``wv``
    column-parallel, its state rows), ``wo`` row-parallel.
    """
    bsz, t, _ = h.shape
    di = out_dim(p["wq"])                                   # the rank's
    q, k, v, logi, logf = mlstm_projections(p, h, cfg, caps=caps,
                                            prefix=prefix)

    if cache is not None and t > 1 and paged is not None:
        slot, start, length = paged["slot"], paged["start"], paged["length"]
        valid = ((start + torch.arange(t, device=h.device))
                 < length)[None, :, None]                   # (1, T, 1)
        logi = torch.where(valid, logi, float("-inf"))
        logf = torch.where(valid, logf, 0.0)
        y, (c1, n1, m1) = _mlstm_chunkwise(
            q, k, v, logi, logf, t,
            init=tuple(cache[key][slot:slot + 1].float() for key in "cnm"))
        for key, val in zip("cnm", (c1, n1, m1)):
            cache[key][slot] = val[0].to(cache[key].dtype)
    elif cache is None or t > 1:
        if t > MLSTM_CHUNK_THRESHOLD and t % MLSTM_CHUNK == 0:
            y, last = _mlstm_chunkwise(q, k, v, logi, logf, MLSTM_CHUNK)
        else:
            y, fcum = _mlstm_parallel(q, k, v, logi, logf)
            if cache is not None:
                # prefill: the prompt summarised into the recurrent state
                dlast = fcum[:, -1:] - fcum + logi          # (B, T, NH)
                mt = dlast.amax(dim=1)                      # (B, NH)
                wk = _heads(k) * _heads(torch.exp(dlast - mt[:, None]))[
                    ..., None]                              # (B, NH, T, hd)
                last = (wk.transpose(-1, -2) @ _heads(v), wk.sum(dim=-2), mt)
        if cache is not None:
            for key, val in zip("cnm", last):
                cache[key].copy_(val.to(cache[key].dtype))
    else:
        y, c1, n1, m1 = _mlstm_step(
            cache["c"].float(), cache["n"].float(), cache["m"], q[:, 0],
            k[:, 0], v[:, 0], logi[:, 0], logf[:, 0])
        y = y[:, None]                                      # (B, 1, NH, hd)
        new = {"c": c1.to(cache["c"].dtype), "n": n1.to(cache["n"].dtype),
               "m": m1}
        if paged is not None:
            # continuous batching: idle and prefilling rows keep theirs
            act = pos >= 0
            for key, val in new.items():
                mask = act.view(-1, *([1] * (val.dim() - 1)))
                new[key] = torch.where(mask, val, cache[key])
        for key, val in new.items():
            cache[key].copy_(val)

    y = y.reshape(bsz, t, di).to(h.dtype)
    return h + linear_rows(y, p["wo"], full=cfg.mlstm_proj * cfg.d_model,
                           caps=caps, name=f"{prefix}wo")


# ======================================================================
# xLSTM sLSTM (scalar memory, sequential recurrence)
# ======================================================================
_SLSTM_REC = ("r_z", "r_i", "r_f", "r_o")


def slstm_init(rng, cfg: ArchConfig, dtype) -> Params:
    """The reference's ``slstm_init``: ``split(key, 9)``; the per-head
    recurrences ``r_*`` (NH, hd, hd) normal × 1/√hd in the model dtype,
    ``bf`` f32 (D,) at 3.0."""
    d = cfg.d_model
    nh = cfg.num_heads
    hd = d // nh
    dev = rng.device
    ks = sub_keys(rng, 9)
    p = {"ln": rmsnorm_init(d, dtype, dev)}
    for i, key in enumerate(("wz", "wi", "wf", "wo_gate")):
        p[key] = _dense_init(ks[i], d, d, dtype)
    for i, key in enumerate(_SLSTM_REC):
        p[key] = _normal(ks[4 + i], (nh, hd, hd), 1.0 / math.sqrt(hd), dtype)
    p["bf"] = torch.full((d,), 3.0, dtype=torch.float32, device=dev)
    p["wo"] = _dense_init(ks[8], d, d, dtype,
                          scale=1.0 / math.sqrt(d * 2 * cfg.num_layers))
    return p


def slstm_cache_init(cfg: ArchConfig, batch: int, dtype, device,
                     parts: int = 1) -> Params:
    """The decode state of one block, each (B, D) f32 whatever ``dtype``;
    the stabiliser ``m`` at -1e30; ``parts`` > 1: a rank's D / parts
    channels, whole heads."""
    f32 = dict(dtype=torch.float32, device=device)
    shape = (batch, cfg.d_model // parts)
    return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
            "h": torch.zeros(shape, **f32),
            "m": torch.full(shape, -1e30, **f32)}


def _slstm_rec(p: Params) -> torch.Tensor:
    """The four recurrences in f32 side by side: (NH, hd, 4·hd), z | i |
    f | o, so that one batched product a step gives all four."""
    return torch.cat([p[key].float() for key in _SLSTM_REC], dim=-1)


def _slstm_cell(rec: torch.Tensor, bf: torch.Tensor, zx, ix, fx, ox,
                state: Tuple[torch.Tensor, ...], nh: int, hd: int
                ) -> Tuple[torch.Tensor, ...]:
    """One sLSTM step (the reference's ``_slstm_cell``).  zx / ix / fx /
    ox: (B, D) pre-activations from the inputs; ``state`` = (c, n, h, m),
    each (B, D) f32; ``rec`` from :func:`_slstm_rec`; ``bf`` (D,)."""
    c0, n0, h0, m0 = state
    b = h0.shape[0]
    heads = (b, nh, hd)
    r = torch.bmm(h0.view(heads).transpose(0, 1), rec).transpose(0, 1)
    r = r.reshape(b, nh, 4, hd)                            # z, i, f, o
    z = torch.tanh(zx.view(heads) + r[:, :, 0])
    logi = ix.view(heads) + r[:, :, 1]
    logf = torch.nn.functional.logsigmoid(
        fx.view(heads) + r[:, :, 2] + bf.view(nh, hd))
    o = torch.sigmoid(ox.view(heads) + r[:, :, 3])
    lfm = logf + m0.view(heads)
    m1 = torch.maximum(lfm, logi)
    iw = torch.exp(logi - m1)
    fw = torch.exp(lfm - m1)
    c1 = fw * c0.view(heads) + iw * z
    n1 = torch.clamp(fw * n0.view(heads) + iw, min=1.0)
    h1 = o * c1 / n1
    return tuple(x.reshape(b, nh * hd) for x in (c1, n1, h1, m1))


def slstm_apply(p: Params, h: torch.Tensor, cfg: ArchConfig, *,
                caps: Optional[Dict[str, torch.Tensor]] = None,
                cache: Optional[Params] = None,
                pos: Optional[torch.Tensor] = None,
                paged: Optional[Params] = None,
                prefix: str = "slstm.") -> torch.Tensor:
    """Pre-norm sLSTM with residual, sequential over T: returns ``h +
    slstm(h)``; the cache modes update ``cache`` in place.

    Modes (the reference's ``slstm_apply``): the full sequence from the
    init state (cache None); the dense-cache prefill from the cache's
    state (T > 1); the chunked prefill (``paged`` with host ints ``slot``
    / ``start`` / ``length``) carrying row ``slot`` on, whose padded tail
    steps keep the state (their outputs repeat the last valid one, as the
    reference's where-select gives); decode (T = 1), where with ``paged``
    rows with ``pos`` < 0 keep their state.  Tensor-parallel: a rank's
    whole heads (the four gates column-parallel, its recurrences ``r_*``,
    ``bf`` entries and state rows), ``wo`` row-parallel."""
    hd = cfg.d_model // cfg.num_heads
    nh = p["r_z"].shape[0]                    # the rank's heads
    d = nh * hd
    bsz, t, _ = h.shape
    h_in = rmsnorm(p["ln"], h, cfg.norm_eps)
    gates = [linear(h_in, p[key], caps=caps, name=f"{prefix}{key}").float()
             for key in ("wz", "wi", "wf", "wo_gate")]
    rec = _slstm_rec(p)

    def steps(state, n):
        ys = []
        for i in range(n):
            state = _slstm_cell(rec, p["bf"], *(g[:, i] for g in gates),
                                state, nh, hd)
            ys.append(state[2])
        return state, ys

    if cache is not None and t > 1 and paged is not None:
        slot, start, length = paged["slot"], paged["start"], paged["length"]
        n_valid = min(max(length - start, 0), t)
        state, ys = steps(tuple(cache[key][slot:slot + 1] for key in "cnhm"),
                          n_valid)
        ys += [state[2]] * (t - n_valid)
        for key, val in zip("cnhm", state):
            cache[key][slot] = val[0]
    elif cache is None or t > 1:
        if cache is None:
            zeros = h.new_zeros((bsz, d), dtype=torch.float32)
            state = (zeros, zeros, zeros, torch.full_like(zeros, -1e30))
        else:
            state = tuple(cache[key] for key in "cnhm")
        state, ys = steps(state, t)
        if cache is not None:
            for key, val in zip("cnhm", state):
                cache[key].copy_(val)
    else:
        old = tuple(cache[key] for key in "cnhm")
        state, ys = steps(old, 1)
        if paged is not None:
            # continuous batching: idle and prefilling rows keep theirs
            act = (pos >= 0)[:, None]
            state = tuple(torch.where(act, new, o)
                          for new, o in zip(state, old))
        for key, val in zip("cnhm", state):
            cache[key].copy_(val)

    y = torch.stack(ys, dim=1)                              # (B, T, D)
    return h + linear_rows(y.to(h.dtype), p["wo"], full=cfg.d_model,
                           caps=caps, name=f"{prefix}wo")
