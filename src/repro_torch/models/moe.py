"""Mixture-of-Experts FFN (a port of ``repro.models.moe``).

Each token's router picks ``top_k`` experts; every expert then takes its
top-C tokens by gate (C = the capacity), runs its SwiGLU on them and the
gated outputs are added back at their tokens.  Tokens past an expert's
capacity are dropped by that expert, so a token's output depends on the
other tokens of the call: serving a MoE model is static-only, as in the
reference (``serve.engine``).

Capture mode records, per expert, the routed tokens and their validity —
``(x, valid)`` under ``moe.wi.{e}`` / ``moe.wg.{e}`` and ``(hid, valid)``
under ``moe.wo.{e}`` — so each expert's Hessian is accumulated over its
routed tokens only (``core.hessian.HessianAccumulator.update_weighted``),
and the router's input under ``moe.router``.

The expert products are batched ``torch.einsum`` s (the reference leaves
them to XLA outside any kernel).  Two orders follow the reference's so
that the same inputs give the same bits:

* top-k ties: ``jax.lax.top_k`` puts the lower index first; here a
  stable descending sort does, so the same tokens fill an expert's slots
  when many gates tie (at 0 in the per-expert selection);
* the combine: the reference's scatter-add sums a token's expert outputs
  in expert order; here each token's (at most ``top_k``) contributions are
  gathered in expert order and added one after another — no atomics, so
  the card gives the same bits run after run.

Data-parallel (a context whose data group has more than one rank and
whose ``split_rows`` says that each rank holds its rows of one global
batch — the trainer's step, a static serving bucket split over data —,
with every expert on the rank): the reference runs one program over the global batch
(GSPMD) and routes it whole, and so does :func:`moe_apply` here.  The capacity
follows the global token count; the detached gates are all-gathered in
rank order (pod outer, as ``batch_sharding`` lays rows out, so a global
token index is the rank's offset + its local index) and every expert
takes its top-C of the global tokens; a rank keeps the picks among its
own rows, whose gate values multiply from its local gates — the
router's gradient is the reference's, split by rows.  The per-expert
counts are all-reduced, so the load-balance ``frac`` is global and a
rank's aux loss is E·Σ frac·mean_local(probs): their mean over ranks is
the reference's aux (exactly so when the ranks hold equal token
counts).  Everywhere else a call routes its own tokens: replicated
work (every rank the same rows) and the pruning pipeline's calibration
shards, which the reference runs as one program a shard, each routed on
its own.

Expert-parallel (tensor-parallel serving: a rank holds its block of the
experts, ``dist.sharding.shard_params``, under a model axis > 1): the
reference's ``shard_map`` dispatch.  Every rank routes the same tokens
to the same gates (the router is whole and its input came out of an
all-reduce), takes the gate columns of its expert range, runs its
experts and sums its contributions in expert order; one all-reduce over
the model group adds the ranks' partial outputs.  The tokens are routed
in the reference's blocks (``dist.sharding.token_shards``): a rank's
rows of a bucket split over data are one block; rows every rank holds
divide into ``dp`` contiguous blocks of B·T tokens, each routed on its
own with the capacity of its count — a boundary may fall inside a row —
or, where B·T does not divide, route as one (the reference's plain
route).  The route serves only: its aux loss is that of the call's own
tokens, with no collective for the global token fractions.  Where E
does not divide, every rank holds every expert and computes the layer
whole.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.dist import comm
from repro_torch.dist.api import current_ctx
from repro_torch.dist.sharding import token_shards
from repro_torch.models.base import ArchConfig
from repro_torch.models.layers import (Params, _dense_init, _normal,
                                       mlp_apply, mlp_init, model_group,
                                       rmsnorm, rmsnorm_init, sub_keys)


def moe_init(rng, cfg: ArchConfig, dtype) -> Params:
    """The reference's ``moe_init``: ``split(key, 5)``; the router is f32
    whatever the model dtype."""
    mc = cfg.moe
    d, e, f = cfg.d_model, mc.num_experts, mc.d_ff_expert
    ks = sub_keys(rng, 5)
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(f * 2 * cfg.num_layers)
    p = {
        "ln": rmsnorm_init(d, dtype, rng.device),
        "router": _dense_init(ks[0], d, e, torch.float32),
        "wi": _normal(ks[1], (e, d, f), scale_in, dtype),
        "wg": _normal(ks[2], (e, d, f), scale_in, dtype),
        "wo": _normal(ks[3], (e, f, d), scale_out, dtype),
    }
    if mc.num_shared:
        p["shared"] = mlp_init(ks[4], cfg, dtype, d_ff=mc.num_shared * f)
    return p


def _top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: descending, the lower index
    first among equal values."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def route(x2: torch.Tensor, router_w: torch.Tensor, top_k: int,
          group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2 (N, D) → the dense renormalised gates (N, E) f32 and the GShard
    load-balance loss E·Σ_e mean(probs_e)·frac_tokens_e.  With a data
    ``group`` the token fractions are those of the global batch (the
    counts summed over it) and mean(probs) is the rank's own."""
    logits = x2.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top(probs, top_k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    gates = torch.zeros_like(probs).scatter(1, topi, topv)
    e = probs.shape[-1]
    if group is None:
        frac = torch.mean((gates > 0).float(), dim=0)
    else:
        counts = torch.cat([(gates > 0).float().sum(dim=0),
                            torch.full((1,), float(x2.shape[0]),
                                       device=x2.device)])
        comm.all_reduce_(counts, group)
        frac = counts[:e] / counts[e]
    aux = e * torch.sum(torch.mean(probs, dim=0) * frac)
    return gates, aux


def expert_ffn(xg: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
               wo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xg (E, C, D) routed tokens → (expert outputs (E, C, D), SwiGLU
    hidden (E, C, F))."""
    up = torch.einsum("ecd,edf->ecf", xg, wi.to(xg.dtype))
    gate = torch.einsum("ecd,edf->ecf", xg, wg.to(xg.dtype))
    hid = torch.nn.functional.silu(gate) * up
    return torch.einsum("ecf,efd->ecd", hid, wo.to(xg.dtype)), hid


def capacity(n: int, cfg: ArchConfig) -> int:
    """Tokens an expert takes from a call of ``n`` tokens (the float
    expression in the reference's order)."""
    mc = cfg.moe
    return max(1, int(math.ceil(n * mc.top_k / mc.num_experts
                                * mc.capacity_factor)))


def _picks(gates: torch.Tensor, cap: int, group=None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each expert's top-C tokens: (gate values (E, C), local token
    indices (E, C), valid (E, C)).  With a data ``group`` the top-C is
    taken over the global tokens (every rank's detached gates, in rank
    order) and a rank keeps the picks among its rows; the others are
    invalid, pointing at row n (past the rank's rows)."""
    n = gates.shape[0]
    if group is None:
        gv, gi = _top(gates.T, min(cap, n))
        return gv, gi, gv > 0.0
    every = comm.all_gather_rows(gates.detach(), group)       # (N, E)
    gv_all, gi_all = _top(every.T, min(cap, every.shape[0]))
    off = comm.rank(group) * n
    mine = (gi_all >= off) & (gi_all < off + n) & (gv_all > 0.0)
    gi = torch.where(mine, gi_all - off, torch.full_like(gi_all, n))
    gv = torch.gather(gates.T, 1, torch.clamp(gi, max=n - 1))
    return torch.where(mine, gv, torch.zeros_like(gv)), gi, mine


def dispatch(x2: torch.Tensor, gates: torch.Tensor, wi, wg, wo, cap: int,
             top_k: int, caps: Optional[Dict] = None,
             prefix: str = "moe.", group=None) -> torch.Tensor:
    """Top-C tokens per expert, the expert FFNs, and the gated combine
    (the reference's ``_gather_compute_scatter``; with a data ``group``
    over the global batch, see :func:`_picks`).  Returns (N, D) in the
    experts' output dtype."""
    n, d = x2.shape
    e = gates.shape[1]
    gv, gi, valid = _picks(gates, cap, group)                # (E, C)
    c = gi.shape[1]
    xg = x2[torch.clamp(gi, max=n - 1)]                      # (E, C, D)
    yo, hid = expert_ffn(xg, wi, wg, wo)
    if caps is not None:
        for k in range(e):
            caps[f"{prefix}wi.{k}"] = (xg[k], valid[k])
            caps[f"{prefix}wg.{k}"] = (xg[k], valid[k])
            caps[f"{prefix}wo.{k}"] = (hid[k], valid[k])
    yo = yo * torch.where(valid, gv, torch.zeros_like(gv))[..., None].to(
        yo.dtype)
    # combine in expert order: token t's kept slots, expert by expert
    # (an invalid pick of another rank's token lands in column n, cut off)
    dev = x2.device
    slot = torch.zeros((e, n + 1), dtype=torch.long, device=dev)
    slot.scatter_(1, gi, torch.arange(c, device=dev).expand(e, c))
    kept = torch.zeros((e, n + 1), dtype=torch.bool, device=dev)
    kept.scatter_(1, gi, valid)
    slot, kept = slot[:, :n], kept[:, :n]
    # a token has at most top_k positive gates, so at most top_k kept
    # slots; the stable sort lists them first, in expert order
    kk = min(top_k, e)
    order = torch.sort(kept.T.to(torch.uint8), dim=1, descending=True,
                       stable=True).indices[:, :kk]            # (N, kk)
    flat = order * c + torch.gather(slot.T, 1, order)
    flat = torch.where(torch.gather(kept.T, 1, order), flat,
                       torch.full_like(flat, e * c))           # the zero row
    rows = torch.cat([yo.reshape(e * c, d),
                      torch.zeros((1, d), dtype=yo.dtype, device=dev)])
    out = torch.zeros((n, d), dtype=yo.dtype, device=dev)
    for j in range(kk):
        out = out + rows[flat[:, j]]
    return out


def _expert_parallel(x2: torch.Tensor, gates: torch.Tensor, p: Params,
                     cfg: ArchConfig, ctx) -> torch.Tensor:
    """A rank's block of the experts over the call's tokens: each token
    block of :func:`~repro_torch.dist.sharding.token_shards` dispatched
    to the rank's experts with its own capacity, the ranks' partial
    outputs summed over the model group (the reference's shard_map body
    and its ``psum``)."""
    e_loc = p["wi"].shape[0]                 # the rank's block of E
    mg = model_group()
    g_loc = gates[:, mg.rank * e_loc:(mg.rank + 1) * e_loc]
    out = torch.cat([
        dispatch(x2[blk], g_loc[blk], p["wi"], p["wg"], p["wo"],
                 capacity(blk.stop - blk.start, cfg), cfg.moe.top_k)
        for blk in token_shards(x2.shape[0], ctx.dp, ctx.split_rows)])
    return comm.all_reduce_(out, mg.group)


def moe_apply(p: Params, h: torch.Tensor, cfg: ArchConfig, *,
              caps: Optional[Dict] = None, prefix: str = "moe."
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE FFN with residual: (h + moe_out, aux loss).  The
    capacity follows the call's token count n = B·T — the global batch's
    under a context of rows split over data, a token block's where a
    rank holds its block of the experts (the module docstring)."""
    mc = cfg.moe
    b, t, d = h.shape
    h_in = rmsnorm(p["ln"], h, cfg.norm_eps)
    if caps is not None:
        caps[f"{prefix}router"] = h_in
    x2 = h_in.reshape(-1, d)
    ctx = current_ctx()
    split_experts = p["wi"].shape[0] != mc.num_experts
    # the expert-parallel route serves only, and serving drops the aux:
    # it makes no data collective for the global token fractions
    group = (comm.group_of(ctx.mesh, ctx.dp_axes, ctx.channel)
             if ctx is not None and ctx.split_rows and ctx.dp > 1
             and not split_experts else None)
    gates, aux = route(x2, p["router"], mc.top_k, group)
    if split_experts:
        out2 = _expert_parallel(x2, gates, p, cfg, ctx)
    else:
        n_all = x2.shape[0] * (1 if group is None else comm.size(group))
        out2 = dispatch(x2, gates, p["wi"], p["wg"], p["wo"],
                        capacity(n_all, cfg), mc.top_k, caps, prefix, group)
    y = out2.reshape(b, t, d).to(h.dtype)
    if mc.num_shared:
        # the reference's arithmetic: the shared MLP's residual taken off
        y = y + (mlp_apply(p["shared"], h, cfg, caps=caps,
                           prefix=f"{prefix}shared.",
                           d_ff=mc.num_shared * mc.d_ff_expert) - h)
    return h + y, aux
