"""Layer library of the port's models: linear, rmsnorm, rope, GQA
attention with optional qk-norm, sliding window or bidirectional prefix
(full-sequence, dense-cache prefill and decode, chunked paged prefill,
paged decode), non-causal (an encoder's) and cross-attention (a
decoder's over the encoder's output), gated MLPs, embeddings and the
stubbed modality frontend's projection.

Conventions follow ``repro.models.layers``: params are plain dicts,
linear weights are stored (in, out), hidden states are (B, T, D).  A
linear weight may be a 2:4-packed ``{"vals", "idx"}`` dict, which goes
through ``kernels.ops.nm_matmul`` with its bias and activation.  The
full-sequence applies take ``caps``: ``None``, or a dict that collects
each linear's INPUT under the linear's name (``attn.wq`` … ``mlp.wo``,
as the reference names them) — the pruning engine's calibration capture.

The paged KV pool and the dense cache are updated IN PLACE: the cache
branches index-write the new K/V rows into the cache tensors (the JAX
code rebuilds them functionally and donates the old buffer).  Idle
decode slots and padded prompt positions write to the scrap page 0,
which attention never reads.

Params are drawn either from a ``torch.Generator`` (sequential draws) or
from a threefry key (``repro_torch.random``), which reproduces the
reference's ``jax.random`` init: the same key splits, the same normals
up to the last ulp of the inverse error function.

Tensor-parallel serving: a rank may hold its block of a param tree
(``dist.sharding.shard_params``) and run under a context whose model
axis is > 1 (``dist.use_mesh``).  A layer reads from its weights' shapes
which of them are blocks: a column-parallel linear gives the rank's
output columns (its bias is sliced to them), a row-parallel one
(:func:`linear_rows`) sums the rank's partial product over the model
group and adds the bias once, after the sum; attention runs on the
rank's query heads and KV heads — the encoder's non-causal attention and
the decoder's cross-attention too; the embedding is vocab-parallel (the
rank's rows, zeros elsewhere, summed), the frontend's projection
all-gathers its columns and the head its vocab columns, so every rank
holds the same frontend prefix, encoder output and logits.  Whole
weights run as on one device, with no collective.

The collectives of the attention, MLP, embedding and head are
``dist.comm``'s differentiable ones (the Megatron pair), so that the
dense decoders also train tensor-parallel (``differentiable=True``
under a model axis > 1); under serving's ``no_grad`` they are the plain
collectives.  ``copy_to_model`` stands where the replicated activation
enters a rank-local region — after an attention's or an MLP's pre-norm,
and after the final norm before a vocab-parallel head — so that the
ranks' parts of its gradient are summed; the row-parallel sum and the
vocab-parallel embedding's sum go through ``reduce_from_model`` and the
head's logits, like a straddling rank's query heads, through
``gather_last``.  A whole leaf that a rank applies inside such a region
(a KV projection or bias kept whole, a bias sliced in :func:`linear`,
the q / k-norm scales) gets only the rank's part of its gradient; the
trainer sums those over the model group (``dist.sharding.grad_sums``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch import random as rnd
from repro_torch.dist import comm
from repro_torch.dist.api import current_ctx
from repro_torch.kernels import ops
from repro_torch.kernels.ref import activate
from repro_torch.models.base import ArchConfig

Params = Dict[str, Any]


# ----------------------------------------------------------------------
# Param init (the reference's scales; numbers come from a torch.Generator
# or a threefry key)
# ----------------------------------------------------------------------
def sub_keys(rng, n: int) -> list:
    """``n`` sources for the sub-inits: the reference's ``split(key, n)``
    for a key; the generator itself, ``n`` times (its draws go in
    order)."""
    if isinstance(rng, torch.Generator):
        return [rng] * n
    return list(rnd.split(rng, n).unbind(0))


def _normal(rng, shape, scale: float, dtype) -> torch.Tensor:
    if isinstance(rng, torch.Generator):
        t = torch.randn(shape, generator=rng, device=rng.device,
                        dtype=torch.float32)
    else:
        t = rnd.normal(rng, shape)
    # scaled in place: a MoE's stacked experts (kimi-k2's 384 x 7168 x
    # 2048) are 22.5 GB in f32, and a second f32 copy would not fit
    return t.mul_(scale).to(dtype)


def _dense_init(rng, d_in, d_out, dtype, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _normal(rng, (d_in, d_out), scale, dtype)


class ModelGroup(NamedTuple):
    """The active context's model axis: its process group and this
    rank's place in it."""

    group: Any
    rank: int


def model_group() -> ModelGroup:
    """The model axis a rank's blocks of weights belong to; raises when
    no context with a model axis > 1 is active."""
    ctx = current_ctx()
    if ctx is None or ctx.tp <= 1:
        raise ValueError("these params hold one rank's blocks "
                         "(dist.sharding.shard_params) but no mesh with a "
                         "model axis > 1 is active (dist.use_mesh)")
    group = comm.group_of(ctx.mesh, ctx.tp_axis, ctx.channel)
    return ModelGroup(group, comm.rank(group))


def in_dim(w) -> int:
    """Rows of a linear weight (a packed one's K = 2 × its vals rows)."""
    return w["vals"].shape[0] * 2 if isinstance(w, dict) else w.shape[0]


def out_dim(w) -> int:
    """Columns of a linear weight, dense or packed."""
    return w["vals"].shape[1] if isinstance(w, dict) else w.shape[1]


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None, *,
           caps: Optional[Dict[str, torch.Tensor]] = None, name: str = "",
           activation: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ w + b), recording x under ``name`` when capturing; a
    packed ``{"vals","idx"}`` w takes the 2:4 kernels with b / activation
    fused into their epilogue.  A column-parallel ``w`` (one rank's
    block of the out dim) takes its block of a whole ``b``."""
    if caps is not None and name:
        caps[name] = x
    n = out_dim(w)
    if b is not None and b.shape[-1] != n:
        r = model_group().rank
        b = b[r * n:(r + 1) * n]
    if isinstance(w, dict):
        return ops.nm_matmul(x, w["vals"], w["idx"], b,
                             activation=activation, out_dtype=x.dtype)
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    if activation is not None:
        y = activate(y, activation)
    return y


def linear_rows(x: torch.Tensor, w, b: Optional[torch.Tensor] = None, *,
                full: int, caps: Optional[Dict[str, torch.Tensor]] = None,
                name: str = "") -> torch.Tensor:
    """x @ w + b for a down-projection of ``full`` input features: a
    whole ``w`` is :func:`linear` (a rank's block of x is all-gathered
    first); a row-parallel ``w`` (this rank's rows) multiplies this
    rank's features of x, the partial products are summed over the model
    group (in f32 for packed weights, whose kernels give f32) and ``b``
    is added once, after the sum — never in each rank's epilogue."""
    k = in_dim(w)
    if k == full:
        if x.shape[-1] != full:
            x = comm.gather_last(x, model_group().group)
        return linear(x, w, b, caps=caps, name=name)
    mg = model_group()
    if x.shape[-1] == full:
        x = x[..., mg.rank * k:(mg.rank + 1) * k]
    if caps is not None and name:
        caps[name] = x
    if isinstance(w, dict):
        y = ops.nm_matmul(x, w["vals"], w["idx"], out_dtype=torch.float32)
    else:
        y = x @ w.to(x.dtype)
    y = comm.reduce_from_model(y, mg.group)
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(x.dtype)


# ----------------------------------------------------------------------
# Norms / rope
# ----------------------------------------------------------------------
def rmsnorm_init(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., T, n, hd); positions: (..., T)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(float(theta), exps)     # a host scalar: no copy, no sync
    ang = positions[..., :, None].float() * freq          # (..., T, half)
    sin = torch.sin(ang)[..., :, None, :]                  # over heads
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ----------------------------------------------------------------------
# Attention block (GQA, optional QKV bias / qk-norm / sliding window)
# ----------------------------------------------------------------------
def attn_init(rng, cfg: ArchConfig, dtype) -> Params:
    hd, h, kv, d = cfg.hd, cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    dev = rng.device
    ks = sub_keys(rng, 6)
    p = {
        "ln": rmsnorm_init(d, dtype, dev),
        "wq": _dense_init(ks[0], d, h * hd, dtype),
        "wk": _dense_init(ks[1], d, kv * hd, dtype),
        "wv": _dense_init(ks[2], d, kv * hd, dtype),
        "wo": _dense_init(ks[3], h * hd, d, dtype,
                          scale=1.0 / math.sqrt(h * hd * 2 * cfg.num_layers)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:               # no draw: the key order stays the same
        p["q_norm"] = rmsnorm_init(hd, dtype, dev)
        p["k_norm"] = rmsnorm_init(hd, dtype, dev)
    return p


class Heads(NamedTuple):
    """The attention heads a rank runs (all of them on one device)."""

    nh: int                  # query heads of its wq
    kv: int                  # KV heads of its wk / wv, and of its cache
    q0: int                  # its first query head
    whole: bool              # its attention runs on every query head


def attn_heads(p: Params, cfg: ArchConfig) -> Heads:
    """A rank's heads, read from its ``wq`` / ``wk`` widths: whole heads
    on every rank (``param_split``'s head_dim guard).  KV heads that
    divide the model axis split with their query groups; one KV head
    stays whole and every rank's query heads read it.  Several KV heads
    that stay whole leave a rank's query heads covering a group in part:
    its attention then runs on every query head, gathered, over the whole
    K / V, and the rank keeps its own heads' outputs."""
    hd, nh, kv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    nh_l, kv_l = out_dim(p["wq"]) // hd, out_dim(p["wk"]) // hd
    if nh_l == nh and kv_l == kv:
        return Heads(nh, kv, 0, False)
    mg = model_group()
    if nh_l == nh or (kv_l < kv and nh_l * kv != nh * kv_l):
        raise ValueError(f"attention split {nh_l}/{nh} query and {kv_l}/"
                         f"{kv} KV heads: not a rule of "
                         "dist.sharding.param_split")
    return Heads(nh_l, kv_l, mg.rank * nh_l, kv_l == kv and kv > 1)


def _gather_heads(q: torch.Tensor) -> torch.Tensor:
    """(..., nh_l, hd) → every rank's heads (..., nh, hd), rank order."""
    *lead, nh_l, hd = q.shape
    full = comm.gather_last(q.reshape(*lead, nh_l * hd),
                            model_group().group)
    return full.reshape(*lead, -1, hd)


def _operands(hp: Heads, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(q, k, v, query heads, KV heads) the attention runs on for a
    rank's heads ``hp``: its own, or every query head."""
    if hp.whole:
        q = _gather_heads(q)
    return q, k, v, q.shape[-2], hp.kv


def _own_heads(hp: Heads, out: torch.Tensor, hd: int) -> torch.Tensor:
    """A (..., heads·hd) attention output cut to the rank's heads."""
    if not hp.whole:
        return out
    return out[..., hp.q0 * hd:(hp.q0 + hp.nh) * hd]


def _qkv(p, h_in: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
         caps=None, prefix: str = "attn."):
    b, t, _ = h_in.shape
    hd = cfg.hd
    nh, kv = out_dim(p["wq"]) // hd, out_dim(p["wk"]) // hd
    q = linear(h_in, p["wq"], p.get("bq"), caps=caps,
               name=f"{prefix}wq").reshape(b, t, nh, hd)
    k = linear(h_in, p["wk"], p.get("bk"), caps=caps,
               name=f"{prefix}wk").reshape(b, t, kv, hd)
    v = linear(h_in, p["wv"], p.get("bv"), caps=caps,
               name=f"{prefix}wv").reshape(b, t, kv, hd)
    if cfg.qk_norm:               # over hd, before rope (as the reference)
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with jnp's type promotion (bf16 × f32 → f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(spec, a.to(dt), b.to(dt))


def _sdpa(q, k, v, mask, nh: int, kv: int) -> torch.Tensor:
    """Grouped scaled-dot-product attention in plain matmul + softmax
    (the reference computes it outside any kernel too): the training
    forward's attention, dense-cache decode and chunked paged prefill.

    q: (B,T,H,hd), k/v: (B,S,KV,hd), mask: broadcastable to (B,KV,G,T,S).
    """
    b, t, _, hd = q.shape
    g = nh // kv
    qg = q.reshape(b, t, kv, g, hd)
    scores = _einsum("btkgd,bskd->bkgts", qg, k).float()
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = _einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, nh * hd)


# full-sequence training attention switches to the online softmax past
# this many positions (the reference's threshold and KV chunk)
ONLINE_ATTN_THRESHOLD = 8192
ONLINE_ATTN_CHUNK = 1024


def causal_mask(t: int, s: int, window: Optional[int], device,
                prefix_len: Optional[int] = None) -> torch.Tensor:
    """(T, S) bool, True where query i sees key j: j ≤ i, and i - window
    < j with a window; or j < prefix_len with a prefix (the prefix-LM's
    bidirectional prefix) — the reference's ``causal_mask``."""
    qpos = torch.arange(t, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok = ok & (kpos > qpos - window)
    if prefix_len is not None:
        ok = ok | (kpos < prefix_len)
    return ok


def _sdpa_online(q, k, v, nh: int, kv: int, window: Optional[int] = None,
                 chunk: int = ONLINE_ATTN_CHUNK,
                 prefix_len: Optional[int] = None) -> torch.Tensor:
    """Causal grouped attention by online softmax over KV chunks (the
    reference's ``_sdpa_online``): the same function as :func:`_sdpa`
    with a causal (windowed, prefixed) mask, O(T·chunk) memory, P kept in
    f32."""
    b, t, _, hd = q.shape
    g = nh // kv
    s = k.shape[1]
    if s % chunk:
        raise ValueError(f"S={s} not divisible by chunk={chunk}")
    qg = q.reshape(b, t, kv, g, hd).float() / math.sqrt(hd)
    qpos = torch.arange(t, device=q.device)
    m = torch.full((b, kv, g, t), float("-inf"), device=q.device)
    lsum = torch.zeros((b, kv, g, t), device=q.device)
    acc = torch.zeros((b, kv, g, t, hd), device=q.device)
    for ci in range(s // chunk):
        kc = k[:, ci * chunk:(ci + 1) * chunk].float()
        vc = v[:, ci * chunk:(ci + 1) * chunk].float()
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        ok = kpos[None, :] <= qpos[:, None]                    # (t, chunk)
        if window is not None:
            ok = ok & (kpos[None, :] > qpos[:, None] - window)
        if prefix_len is not None:
            ok = ok | (kpos[None, :] < prefix_len)
        sc = torch.einsum("btkgd,bckd->bkgtc", qg, kc)
        sc = torch.where(ok, sc, torch.full_like(sc, float("-inf")))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        msafe = torch.where(torch.isfinite(m_new), m_new,
                            torch.zeros_like(m_new))
        p = torch.exp(sc - msafe[..., None])
        alpha = torch.where(torch.isfinite(m), torch.exp(m - msafe),
                            torch.zeros_like(m))
        lsum = lsum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgtc,bckd->bkgtd",
                                                    p, vc)
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4)                          # (b,t,kv,g,hd)
    return out.reshape(b, t, nh * hd).to(v.dtype)


# ----------------------------------------------------------------------
# Paged KV pool writes (in place)
# ----------------------------------------------------------------------
def _paged_write(pages: torch.Tensor, vals: torch.Tensor,
                 flat_idx: torch.Tensor) -> None:
    """Write K/V rows into a paged pool at flat token slots
    (page * page_size + offset).  Duplicate slots all land on the scrap
    page 0 — garbage on garbage, never read back."""
    p_, ps_, kvh, hd = pages.shape
    pages.view(p_ * ps_, kvh, hd)[flat_idx.reshape(-1)] = (
        vals.reshape(-1, kvh, hd).to(pages.dtype))


def _paged_write_q8(pages: torch.Tensor, scales: torch.Tensor,
                    vals: torch.Tensor, flat_idx: torch.Tensor) -> None:
    """Quantizing twin of :func:`_paged_write` for int8 pages: each row
    quantizes per (token, kv-head) with scale = amax(|row|)/127 over
    head_dim, and the scale lands in the (P, page_size, KV) f32 scale
    leaf at the same flat slot."""
    p_, ps_, kvh, hd = pages.shape
    rows = vals.reshape(-1, kvh, hd).float()
    s = torch.amax(rows.abs(), dim=-1) / 127.0              # (R, KV)
    q = torch.round(rows / torch.clamp(s, min=1e-8)[..., None]).to(torch.int8)
    flat = flat_idx.reshape(-1)
    pages.view(p_ * ps_, kvh, hd)[flat] = q
    scales.view(p_ * ps_, kvh)[flat] = s


def _paged_scatter(cache: Params, k: torch.Tensor, v: torch.Tensor,
                   flat: torch.Tensor) -> None:
    """Write K/V rows into the pool leaves, quantizing when the cache
    carries scale leaves (int8 KV pages)."""
    if "k_scale" not in cache:
        _paged_write(cache["k"], k, flat)
        _paged_write(cache["v"], v, flat)
        return
    _paged_write_q8(cache["k"], cache["k_scale"], k, flat)
    _paged_write_q8(cache["v"], cache["v_scale"], v, flat)


def attn_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype,
                    device, num_kv_heads: Optional[int] = None) -> Params:
    """The dense decode cache of one layer: (B, max_len, KV, hd) K and V
    (``num_kv_heads``: a rank's KV heads, all of them by default)."""
    shape = (batch, max_len, num_kv_heads or cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_paged_cache_init(cfg: ArchConfig, num_pages: int, page_size: int,
                          dtype, device, num_kv_heads: Optional[int] = None
                          ) -> Params:
    """Paged pool leaves (``num_kv_heads`` as :func:`attn_cache_init`);
    int8 adds per-row f32 scale leaves."""
    kv, hd = num_kv_heads or cfg.num_kv_heads, cfg.hd
    shape = (num_pages, page_size, kv, hd)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        cache["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)
    return cache


# ----------------------------------------------------------------------
def attn_apply(p: Params, h: torch.Tensor, cfg: ArchConfig, *,
               cache: Optional[Params] = None,
               pos: Optional[torch.Tensor] = None,
               paged: Optional[Params] = None,
               page_size: Optional[int] = None,
               caps: Optional[Dict[str, torch.Tensor]] = None,
               prefix: str = "attn.",
               differentiable: bool = False,
               window: Optional[int] = None,
               causal: bool = True,
               prefix_len: Optional[int] = None,
               cross_kv: Optional[tuple] = None) -> torch.Tensor:
    """Pre-norm attention with residual.  Returns the new hidden state;
    cache modes update ``cache`` in place.

    Causal attention, global or — an ``attn_local`` layer, ``window``
    given — over a sliding window: query t sees keys s with
    t - window < s ≤ t; with ``prefix_len`` (the prefix-LM) every query
    also sees the keys s < prefix_len (the reference's ``causal_mask``);
    ``causal=False`` (an encoder's self-attention) sees every key.  In
    every mode:
      full-sequence (cache None): causal over T through
          ``ops.attention`` (the ``flash_attn`` kernel on the card, which
          reads q/k/v in place and applies the window itself; the
          counterpart of the reference's ``_sdpa`` and ``_sdpa_online``,
          with the probabilities kept in f32 as ``_sdpa_online`` keeps
          them); ``caps`` records the linears' inputs under
          ``{prefix}wq`` … ``{prefix}wo``.  With
          ``differentiable`` (the trainer's route) the attention is the
          reference's training math in torch ops instead — :func:`_sdpa`,
          or :func:`_sdpa_online` past ONLINE_ATTN_THRESHOLD positions —
          since the kernel has no backward;
      dense-cache prefill (cache a dense ``{"k", "v"}``, ``pos`` None):
          the full-sequence attention over the prompt, whose K/V then fill
          ``cache[:, :T]``;
      dense-cache decode (T = 1, ``pos`` a host int): this token's K/V
          written at ``pos``, attention over the cache's positions
          ≤ ``pos`` (and inside the window) in torch ops (jnp in the
          reference);
      chunked paged prefill (``paged["start"]`` given, B = 1): the chunk's
          K/V go into the pages first, then attention runs over the
          gathered slot context — earlier chunks' keys read back from
          the pool;
      paged decode (T = 1, ``pos`` (B,) with -1 marking idle slots):
          block-table attention through ``ops.paged_attention``, whose
          kernel takes the window;
      cross-attention (``cross_kv`` = the encoder's (B, S, KV, hd) K and
          V at the rank's KV heads, computed or cached by the caller): no
          rope, no cache
          update, every key visible — ``ops.attention(causal=False)``
          over S ≠ T keys, or with ``differentiable`` or in decode
          (``pos`` given) :func:`_sdpa` under an all-true mask, as the
          reference's cross branch computes it; ``caps`` records
          ``{prefix}wq`` and ``{prefix}wo``.

    int8 pages and the full-sequence branch give f32 attention output,
    which is cast back to the hidden dtype before ``wo`` so that the residual stream keeps the
    model dtype (a no-op for f32 models, where the reference's numbers
    are matched exactly).
    """
    b, t, _ = h.shape
    hd = cfg.hd
    full = cfg.num_heads * hd          # wo's input features on one device
    dev = h.device
    h_in = rmsnorm(p["ln"], h, cfg.norm_eps)

    hp = attn_heads(p, cfg)
    if hp.nh != cfg.num_heads:                          # a rank's heads
        h_in = comm.copy_to_model(h_in, model_group().group)
    if cross_kv is not None:
        q = linear(h_in, p["wq"], p.get("bq"), caps=caps,
                   name=f"{prefix}wq").reshape(b, t, hp.nh, hd)
        qa, k, v, nh, kv = _operands(hp, q, *cross_kv)
        if differentiable or pos is not None:
            seen = torch.ones((t, k.shape[1]), dtype=torch.bool, device=dev)
            out = _sdpa(qa, k, v, seen, nh, kv)
        else:
            out = ops.attention(qa, k, v, causal=False).reshape(b, t,
                                                                nh * hd)
        out = _own_heads(hp, out, hd).to(h.dtype)
        return h + linear_rows(out, p["wo"], full=full, caps=caps,
                               name=f"{prefix}wo")

    if paged is None and (cache is None or pos is None):
        positions = torch.arange(t, device=dev)[None, :]
        q, k, v = _qkv(p, h_in, cfg, positions, caps, prefix)
        qa, ka, va, nh, kv = _operands(hp, q, k, v)
        if not differentiable:
            out = ops.attention(qa, ka, va, causal=causal, window=window,
                                prefix_len=prefix_len)      # (B, T, H, hd)
            out = out.reshape(b, t, nh * hd)
        elif not causal:
            seen = torch.ones((t, t), dtype=torch.bool, device=dev)
            out = _sdpa(qa, ka, va, seen, nh, kv)
        elif t > ONLINE_ATTN_THRESHOLD:
            out = _sdpa_online(qa, ka, va, nh, kv, window, ONLINE_ATTN_CHUNK,
                               prefix_len)
        else:
            out = _sdpa(qa, ka, va,
                        causal_mask(t, t, window, dev, prefix_len), nh, kv)
        if cache is not None:                               # dense prefill
            cache["k"][:, :t] = k.to(cache["k"].dtype)
            cache["v"][:, :t] = v.to(cache["v"].dtype)
        out = _own_heads(hp, out, hd).to(h.dtype)
        return h + linear_rows(out, p["wo"], full=full, caps=caps,
                               name=f"{prefix}wo")

    if paged is None:                                       # dense decode
        if t != 1:
            raise ValueError("dense-cache decode takes one token a row")
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
        q, k1, v1 = _qkv(p, h_in, cfg, positions)
        cache["k"][:, pos] = k1[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos] = v1[:, 0].to(cache["v"].dtype)
        kpos = torch.arange(cache["k"].shape[1], device=dev)
        ok = kpos <= pos
        if window is not None:
            ok = ok & (kpos > pos - window)
        if prefix_len is not None:
            ok = ok | (kpos < prefix_len)
        qa, ka, va, nh, kv = _operands(hp, q, cache["k"], cache["v"])
        out = _own_heads(hp, _sdpa(qa, ka, va, ok, nh, kv), hd)
        return h + linear_rows(out.to(h.dtype), p["wo"], full=full)

    bt = paged["block_tables"]                               # (B, P_max)
    p_max = bt.shape[1]
    if paged.get("start") is not None:
        lengths = paged["lengths"]                           # (B,)
        tpos = paged["start"] + torch.arange(t, device=dev, dtype=torch.int32)
        positions = tpos[None, :]
        q, k, v = _qkv(p, h_in, cfg, positions)
        col = torch.clamp(tpos // page_size, max=p_max - 1)  # masked below
        page = bt[:, col.long()]                             # (B, T)
        flat = page * page_size + tpos[None, :] % page_size
        flat = torch.where(tpos[None, :] < lengths[:, None], flat,
                           torch.zeros_like(flat))
        _paged_scatter(cache, k, v, flat.long())
        s_len = p_max * page_size
        btl = bt.long()
        kc = cache["k"][btl].reshape(b, s_len, hp.kv, hd)
        vc = cache["v"][btl].reshape(b, s_len, hp.kv, hd)
        if "k_scale" in cache:
            kc = kc.float() * cache["k_scale"][btl].reshape(
                b, s_len, hp.kv)[..., None]
            vc = vc.float() * cache["v_scale"][btl].reshape(
                b, s_len, hp.kv)[..., None]
        kpos = torch.arange(s_len, device=dev, dtype=torch.int32)
        ok = kpos[None, None, :] <= positions[:, :, None]    # (B, T, S)
        if window is not None:
            ok = ok & (kpos[None, None, :] > positions[:, :, None] - window)
        qa, ka, va, nh, kv = _operands(hp, q, kc, vc)
        out = _sdpa(qa, ka, va, ok[:, None, None], nh, kv)
        out = _own_heads(hp, out, hd).to(h.dtype)
        return h + linear_rows(out, p["wo"], full=full)

    if t != 1:
        raise ValueError("paged attention: T > 1 needs a chunk start")
    wpos = torch.clamp(pos, min=0)
    q, k1, v1 = _qkv(p, h_in, cfg, wpos[:, None])
    page = torch.gather(bt, 1, (wpos // page_size)[:, None].long())[:, 0]
    flat = page * page_size + wpos % page_size
    flat = torch.where(pos >= 0, flat, torch.zeros_like(flat))  # idle → scrap
    _paged_scatter(cache, k1[:, 0], v1[:, 0], flat.long())
    lengths = torch.clamp(pos + 1, min=0).to(torch.int32)       # idle → 0
    q1, _, _, nh, kv = _operands(hp, q[:, 0], None, None)    # (B, nh, hd)
    qg = q1.reshape(b, kv, nh // kv, hd)
    out = ops.paged_attention(qg, cache["k"], cache["v"], bt, lengths,
                              window=window, k_scale=cache.get("k_scale"),
                              v_scale=cache.get("v_scale"))
    out = _own_heads(hp, out.reshape(b, 1, -1), hd).to(h.dtype)
    return h + linear_rows(out, p["wo"], full=full)


# ----------------------------------------------------------------------
# Dense MLP (swiglu / geglu / gelu; a MoE's shared expert at its own d_ff)
# ----------------------------------------------------------------------
def mlp_init(rng, cfg: ArchConfig, dtype, d_ff: Optional[int] = None
             ) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    ks = sub_keys(rng, 3)
    p = {
        "ln": rmsnorm_init(d, dtype, rng.device),
        "wi": _dense_init(ks[0], d, f, dtype),
        "wo": _dense_init(ks[1], f, d, dtype,
                          scale=1.0 / math.sqrt(f * 2 * cfg.num_layers)),
    }
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["wg"] = _dense_init(ks[2], d, f, dtype)
    return p


def mlp_apply(p, h: torch.Tensor, cfg: ArchConfig, *,
              caps: Optional[Dict[str, torch.Tensor]] = None,
              prefix: str = "mlp.", d_ff: Optional[int] = None
              ) -> torch.Tensor:
    """Pre-norm MLP with residual; ``d_ff`` (default ``cfg.d_ff``) is the
    hidden width on one device — ``wi`` / ``wg`` column-parallel and
    ``wo`` row-parallel where a rank holds their blocks."""
    h_in = rmsnorm(p["ln"], h, cfg.norm_eps)
    if out_dim(p["wi"]) != (d_ff or cfg.d_ff):          # a rank's columns
        h_in = comm.copy_to_model(h_in, model_group().group)
    # glu gates fuse their activation into the projection epilogue (a true
    # in-kernel epilogue for 2:4-packed weights)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        up = linear(h_in, p["wi"], caps=caps, name=f"{prefix}wi")
        act = linear(h_in, p["wg"], caps=caps, name=f"{prefix}wg",
                     activation="silu" if cfg.mlp_kind == "swiglu"
                     else "gelu") * up
    else:
        act = linear(h_in, p["wi"], caps=caps, name=f"{prefix}wi",
                     activation="gelu")
    return h + linear_rows(act, p["wo"], full=d_ff or cfg.d_ff, caps=caps,
                           name=f"{prefix}wo")


# ----------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------
def embed_init(rng, cfg: ArchConfig, dtype) -> Params:
    p = {"tok": _normal(rng, (cfg.vocab_size, cfg.d_model), 0.02, dtype)}
    if cfg.frontend is not None:
        k2 = rng if isinstance(rng, torch.Generator) else rnd.fold_in(rng, 1)
        p["frontend_proj"] = _dense_init(k2, cfg.frontend_dim, cfg.d_model,
                                         dtype)
    return p


def embed_scale(cfg: ArchConfig, dtype) -> float:
    """√d_model rounded to ``dtype``, as the reference's ``jnp.asarray(√d,
    dtype)``; a host float (exact in f32), so no tensor is copied to the
    card."""
    return float(torch.tensor(math.sqrt(cfg.d_model), dtype=dtype))


def embed_apply(p, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Token embeddings (× √d where the config scales them).  A rank's
    vocab rows of ``tok`` (vocab-parallel) give its tokens' rows and
    zeros elsewhere, summed over the model group: exact, one nonzero a
    position."""
    tok = p["tok"]
    n = tok.shape[0]
    if n == cfg.vocab_size:
        h = tok[tokens.long()]
    else:
        mg = model_group()
        ids = tokens.long() - mg.rank * n
        mine = (ids >= 0) & (ids < n)
        h = tok[torch.clamp(ids, 0, n - 1)]
        h = torch.where(mine[..., None], h, torch.zeros_like(h))
        h = comm.reduce_from_model(h, mg.group)
    if cfg.embed_scale:
        h = h * embed_scale(cfg, h.dtype)
    return h


def frontend_apply(p, feats: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The stubbed modality frontend: precomputed patch / frame features
    (B, F, frontend_dim) projected to d_model, in the projection's dtype.
    A plain product (no kernel stands behind it in the reference
    either).  A rank's column block of the projection gives its columns,
    all-gathered in rank order: every rank holds the same (B, F,
    d_model)."""
    w = p["frontend_proj"]
    y = feats.to(w.dtype) @ w
    if w.shape[1] != cfg.d_model:
        y = comm.all_gather_last(y, model_group().group)
    return y


def unembed_init(rng, cfg: ArchConfig, dtype) -> Params:
    p = {"ln": rmsnorm_init(cfg.d_model, dtype, rng.device)}
    if not cfg.tie_embeddings:
        p["head"] = _dense_init(rng, cfg.d_model, cfg.vocab_size, dtype)
    return p


def unembed_apply(p, embed_p, h: torch.Tensor, cfg: ArchConfig
                  ) -> torch.Tensor:
    """Logits in the model dtype (bf16 for a bf16 config, as the
    reference).  The tied head is a dense product left to torch.matmul,
    as the reference leaves it to XLA.  A rank's vocab block of the head
    (tied or not) gives its logit columns, all-gathered in rank order:
    every rank holds the same logits."""
    h = rmsnorm(p["ln"], h, cfg.norm_eps)
    head = embed_p["tok"].T if cfg.tie_embeddings else p["head"]
    if head.shape[-1] == cfg.vocab_size:
        return h @ head.to(h.dtype)
    group = model_group().group
    return comm.gather_last(comm.copy_to_model(h, group) @ head.to(h.dtype),
                            group)
