"""The decoder LM: init, full-sequence forward and loss (the kernel
route, and the differentiable route the trainer takes), the pruning
contract (``calib_init`` / ``prunable_segments``), the dense-cache serve
methods of static mode (``init_cache`` / ``prefill`` / ``decode_step``)
and the paged ones of continuous mode (``init_paged_cache`` /
``prefill_chunk`` / ``decode_step`` with block tables).

Ported block kinds: global attention, sliding-window attention, the
encoder-decoder's decoder block, Mamba and the xLSTM's mLSTM and sLSTM
(``period`` ⊂ {"attn", "attn_local", "dec_attn", "mamba", "mlstm",
"slstm"}), each with its FFN where ``cfg.block_has_mlp`` says so: a
dense MLP, or in the slots that ``cfg.slot_is_moe`` names a
Mixture-of-Experts (``models.moe``) — the dense decoders (qk-norm
included: Qwen3, Gemma3's 5:1 local:global period), the MoE decoders
(phi3.5-moe, kimi-k2 with its shared expert), the Mamba LM, the
Mamba/attention hybrid with its experts (Jamba), the xLSTM (7 mLSTM : 1
sLSTM), the prefix-LM (PaliGemma) and the encoder-decoder (SeamlessM4T).
An ``attn_local`` block is an ``attn`` block (the same params under
``"attn"``, the same linears, KV pages and dense cache) whose attention
sees the last ``cfg.window`` positions.

A modality frontend is a stub, as in the reference: the batch carries
precomputed features ``frontend_feats`` (B, frontend_len, frontend_dim),
which ``embed/frontend_proj`` projects to d_model.  The prefix-LM
(``cfg.frontend`` without ``cfg.encdec``) prepends them, scaled by √d, to
the text's embeddings as a bidirectional prefix: its attention layers
let every position see the frontend_len prefix positions
(``attn_apply(prefix_len=)``), and its serve positions start past them.
The encoder-decoder runs them through ``params["enc"]`` — a per-layer
list of non-causal ``enc_attn`` blocks, then ``enc/ln`` — and each
``dec_attn`` block follows its causal self-attention with
cross-attention (``"xattn"``) over that output.

The leading ``cfg.prefix`` blocks (unrolled in the reference, under
``params["prefix"]["0"]``, ...) are ``params["prefix"]``, a list of block
dicts; every block loop walks them before the period layers
(``self.kinds`` and the caches list them first), and the pruning
contract prunes each as its own segment ``prefix{i}``, with linears
named as in the reference (``attn.wq``, ``mlp.wi``, ``moe.wi.0``, ...).

Where the reference stacks the layers (L, ...) under ``layers/s{j}``
(and ``enc/layers``) for ``lax.scan``, the port keeps a per-layer list of
param dicts and loops: period layer ``i`` is slot ``i % len(period)``
of period ``i // len(period)``, ``params["layers"][i] = {"attn" | "mamba" |
"mlstm" | "slstm": {...}[, "xattn": {...}], "mlp" | "moe": {...}}``, a
MoE's experts stacked (E, ...) as the reference stacks them.  The caches
are per-layer lists too: an attention layer's paged ``{"k", "v"[,
"k_scale", "v_scale"]}`` page tensors or dense (B, max_len, KV, hd)
``{"k", "v"}`` (a decoder block's with the encoder's cross K / V
``{"xk", "xv"}`` (B, frontend_len, KV, hd), filled once at prefill), a
recurrent layer's state rows (``models.ssm``; one per serve slot when
paged); all are updated in place.  The encoder-decoder and the prefix-LM
serve from the dense cache only (static mode), as in the reference.

Under a context whose model axis is > 1 (tensor-parallel serving) the
serve methods run a rank's blocks of the params
(``dist.sharding.shard_params``): the caches hold the rank's KV heads
(``LM.cache_kv_heads``) and the rank's width of each recurrent block's
state (``LM.state_init``: Mamba's d_inner channels, whole mLSTM / sLSTM
heads, where ``dist.sharding.state_split`` splits the block), and the
layers make the collectives (``models.layers``, ``models.ssm``, the
expert-parallel dispatch of ``models.moe``).  It covers every block kind
and family: the dense decoders, the Mamba LM and Jamba's hybrid, the
xLSTM, the MoE decoders, leading prefix blocks (each by the rules of its
kind), the prefix-LM — the frontend's projection column-parallel and
all-gathered, so every rank holds the whole prefix — and the
encoder-decoder: the encoder's attention on the rank's heads with its
``wo`` and MLP row-parallel, so every rank holds the same ``enc_out``,
and each cross-attention on the rank's heads with its ``xk`` / ``xv``
cached at the rank's KV heads.

The training route (``differentiable=True``) runs under a model axis >
1 for the dense decoders (:meth:`LM.check_tp_training`): the layers'
differentiable collectives (``models.layers``), the logits all-gathered
before the loss, so that every rank of the model group computes the
same loss.  The recurrent, expert and frontend families raise there.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core.engine import LinearSpec, SegmentSpec
from repro_torch.dist.api import current_ctx
from repro_torch.dist.sharding import kv_head_split, state_split
from repro_torch.models.base import ArchConfig
from repro_torch.models.layers import (Params, attn_apply, attn_cache_init,
                                       attn_init, attn_paged_cache_init,
                                       embed_apply, embed_init, embed_scale,
                                       frontend_apply, linear, mlp_apply,
                                       mlp_init, out_dim, rmsnorm,
                                       rmsnorm_init,
                                       sub_keys, unembed_apply, unembed_init)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models import ssm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTN_KINDS = ("attn", "attn_local")
# the recurrent mixers: (init, apply, cache init) of each
STATE_BLOCKS = {
    "mamba": (ssm.mamba_init, ssm.mamba_apply, ssm.mamba_cache_init),
    "mlstm": (ssm.mlstm_init, ssm.mlstm_apply, ssm.mlstm_cache_init),
    "slstm": (ssm.slstm_init, ssm.slstm_apply, ssm.slstm_cache_init),
}
PORTED_KINDS = (*ATTN_KINDS, "dec_attn", *STATE_BLOCKS)
# the prunable linears of a block kind, in the reference's capture-name
# order (``_BLOCK_LINEARS``)
_BLOCK_LINEARS = {
    "attn": (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo")),
    "mamba": (("mamba", "in_proj"), ("mamba", "x_proj"),
              ("mamba", "dt_proj"), ("mamba", "out_proj")),
    "mlstm": (("mlstm", "wq"), ("mlstm", "wk"), ("mlstm", "wv"),
              ("mlstm", "wo")),
    "slstm": (("slstm", "wz"), ("slstm", "wi"), ("slstm", "wf"),
              ("slstm", "wo_gate"), ("slstm", "wo")),
}
_BLOCK_LINEARS["attn_local"] = _BLOCK_LINEARS["attn"]
_BLOCK_LINEARS["enc_attn"] = _BLOCK_LINEARS["attn"]
_BLOCK_LINEARS["dec_attn"] = _BLOCK_LINEARS["attn"] + (
    ("xattn", "wq"), ("xattn", "wk"), ("xattn", "wv"), ("xattn", "wo"))
_MLP_LINEARS = {"swiglu": ("wi", "wg", "wo"), "geglu": ("wi", "wg", "wo"),
                "gelu": ("wi", "wo"), "none": ()}


class LM:
    """A model of attention and recurrent blocks from one ArchConfig — a
    decoder, a prefix-LM or an encoder-decoder — on one device."""

    # block kinds whose paged serve cache is slot-pooled recurrent state
    # (serve.kvpool.StatePool resets their rows), and those whose cache is
    # KV pages (serve.kvpool.PagedKVPool pools, shares and swaps them)
    STATE_KINDS = tuple(STATE_BLOCKS)
    ATTN_KINDS = ATTN_KINDS

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if any(k not in PORTED_KINDS for k in (*cfg.prefix, *cfg.period)):
            raise ValueError(
                f"{cfg.name}: block kinds {(*cfg.prefix, *cfg.period)} "
                f"outside {PORTED_KINDS} are not ported")
        self.cfg = cfg
        # the prefix-LM's bidirectional prefix: the frontend's positions
        self.prefix_len = (cfg.frontend_len if cfg.frontend is not None
                           and not cfg.encdec else None)
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg.dtype]
        period = cfg.period
        n_period_layers = cfg.n_periods * len(period)
        # every block in forward order: the leading prefix blocks, then
        # the period layers (the caches are lists in this order too)
        self.kinds = list(cfg.prefix) + [period[i % len(period)]
                                         for i in range(n_period_layers)]
        self.moe_slots = [cfg.slot_is_moe(j, False)
                          for j in range(len(period))]
        self.prefix_moe = [cfg.slot_is_moe(i, True)
                           for i in range(len(cfg.prefix))]

    # ------------------------------------------------------------- init
    def init(self, rng) -> Params:
        """Random params at the reference's scales (``_dense_init``,
        ``embed_init``, ``ssm``'s inits, ``moe_init``) on the device of
        ``rng``: a
        ``torch.Generator`` (sequential draws), or a threefry key
        (``random.key(seed)``), which reproduces the reference's
        ``LM.init(jax.random.key(seed))`` — its key splits (``split(key,
        8)``; slot ``j`` of period ``p`` from ``split(fold_in(keys[3], j),
        n_periods)[p]``, then ``split(·, 3)`` into mixer and MLP; prefix
        block ``i`` from ``fold_in(keys[2], i)``) and its normals up to the
        last ulp."""
        cfg, dt = self.cfg, self.dtype
        keys = sub_keys(rng, 8)
        n_slots = len(cfg.period)
        n_layers = cfg.n_periods * n_slots
        if isinstance(rng, torch.Generator):
            layer_keys = [rng] * n_layers
            prefix_keys = [rng] * len(cfg.prefix)
        else:
            slot_keys = [rnd.split(rnd.fold_in(keys[3], j), cfg.n_periods)
                         for j in range(n_slots)]
            layer_keys = [slot_keys[i % n_slots][i // n_slots]
                          for i in range(n_layers)]
            prefix_keys = [rnd.fold_in(keys[2], i)
                           for i in range(len(cfg.prefix))]
        params: Params = {"embed": embed_init(keys[0], cfg, dt),
                          "unembed": unembed_init(keys[1], cfg, dt)}
        if cfg.prefix:
            params["prefix"] = [
                self._block_init(pk, kind, is_moe) for kind, pk, is_moe
                in zip(cfg.prefix, prefix_keys, self.prefix_moe)]
        params["layers"] = [
            self._block_init(lk, kind, self.moe_slots[i % n_slots])
            for i, (kind, lk) in enumerate(
                zip(self.kinds[len(cfg.prefix):], layer_keys))]
        if cfg.encdec:
            enc_keys = ([rng] * cfg.enc_layers
                        if isinstance(rng, torch.Generator)
                        else list(rnd.split(keys[4], cfg.enc_layers)))
            params["enc"] = {
                "layers": [self._block_init(k, "enc_attn", False)
                           for k in enc_keys],
                "ln": rmsnorm_init(cfg.d_model, dt, keys[4].device)}
        return params

    def _block_init(self, rng, kind: str, is_moe: bool) -> Params:
        """One block's params from ``rng`` split three ways (mixer, FFN,
        cross-attention), as the reference's ``_block_init``."""
        cfg, dt = self.cfg, self.dtype
        k_mix, k_ffn, k_x = sub_keys(rng, 3)
        if kind in STATE_BLOCKS:
            block = {kind: STATE_BLOCKS[kind][0](k_mix, cfg, dt)}
        else:
            block = {"attn": attn_init(k_mix, cfg, dt)}
            if kind == "dec_attn":
                block["xattn"] = attn_init(k_x, cfg, dt)
        if cfg.block_has_mlp(kind):
            if is_moe:
                block["moe"] = moe_init(k_ffn, cfg, dt)
            else:
                block["mlp"] = mlp_init(k_ffn, cfg, dt)
        return block

    def params_from_jax(self, flat: Dict[str, np.ndarray]) -> Params:
        """The reference's path-keyed leaves (``ckpt/store.py::_flatten``
        names: ``layers/s0/attn/wq``, ``embed/tok``, ...) → port params.
        The stacked layer axes (``layers/s{j}``, ``enc/layers``) are
        unstacked (a MoE's expert axis stays stacked, and its f32 router
        stays f32); packed ``{"vals","idx"}`` leaves stay packed."""
        cfg = self.cfg
        period = len(cfg.period)
        params: Params = {"layers": [{} for _ in range(cfg.n_periods
                                                        * period)]}
        if cfg.prefix:
            params["prefix"] = [{} for _ in cfg.prefix]
        if cfg.encdec:
            params["enc"] = {"layers": [{} for _ in range(cfg.enc_layers)]}
        for path, arr in flat.items():
            parts = path.split("/")
            if parts[0] == "layers":
                j = int(parts[1][1:])                    # "s{j}"
                for i in range(arr.shape[0]):
                    _set_path(params["layers"][i * period + j], parts[2:],
                              _to_torch(arr[i], self.device))
            elif parts[0] == "prefix" and cfg.prefix:    # "prefix/{i}"
                _set_path(params["prefix"][int(parts[1])], parts[2:],
                          _to_torch(arr, self.device))
            elif parts[:2] == ["enc", "layers"] and cfg.encdec:
                for i in range(arr.shape[0]):
                    _set_path(params["enc"]["layers"][i], parts[2:],
                              _to_torch(arr[i], self.device))
            elif parts[0] in ("embed", "unembed") or (
                    parts[0] == "enc" and cfg.encdec):
                _set_path(params, parts, _to_torch(arr, self.device))
            else:
                raise ValueError(f"leaf {path!r}: not a param of a ported "
                                 "block kind")
        return params

    def params_to_flat(self, params: Params) -> Dict[str, np.ndarray]:
        """The inverse of :meth:`params_from_jax`: port params → the
        reference's path-keyed numpy leaves, layers stacked (L, ...) under
        ``layers/s{j}`` (and ``enc/layers``), prefix blocks unstacked under
        ``prefix/{i}``.  bf16 leaves come out as the 2-byte void arrays
        that the reference's checkpoints hold."""
        period = len(self.cfg.period)
        stacks = {f"layers/s{j}": params["layers"][j::period]
                  for j in range(period)}
        if self.cfg.encdec:
            stacks["enc/layers"] = params["enc"]["layers"]
        flat: Dict[str, np.ndarray] = {}
        for name, stack in stacks.items():
            for path, _ in _leaves(stack[0]):
                flat[f"{name}/{path}"] = np.stack(
                    [_to_numpy(_get_path(lp, path.split("/")))
                     for lp in stack])
        for key in ("embed", "unembed"):
            for path, t in _leaves(params[key]):
                flat[f"{key}/{path}"] = _to_numpy(t)
        for i, block in enumerate(params.get("prefix", [])):
            for path, t in _leaves(block):
                flat[f"prefix/{i}/{path}"] = _to_numpy(t)
        if self.cfg.encdec:
            for path, t in _leaves(params["enc"]["ln"]):
                flat[f"enc/ln/{path}"] = _to_numpy(t)
        return flat

    # ---------------------------------------------------------- forward
    def _block(self, p: Params, h: torch.Tensor, kind: str, caps=None,
               name_prefix: str = "", cache=None, pos=None, paged=None,
               page_size=None, differentiable: bool = False,
               enc_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One block (mixer, then its FFN if it has one): (h, the MoE's aux
        loss or None).  The cache modes are the mixer's (``attn_apply`` /
        ``ssm.mamba_apply`` / ``mlstm_apply`` / ``slstm_apply``); a MoE FFN
        routes the call's B·T tokens.  An ``enc_attn`` block attends
        without the causal mask; a ``dec_attn`` block adds cross-attention
        over ``enc_out`` (or, in decode, over the cache's cross K / V)."""
        if kind in ATTN_KINDS or kind == "enc_attn":
            h = attn_apply(p["attn"], h, self.cfg, caps=caps,
                           prefix=f"{name_prefix}attn.", cache=cache,
                           pos=pos, paged=paged, page_size=page_size,
                           differentiable=differentiable,
                           window=(self.cfg.window if kind == "attn_local"
                                   else None),
                           causal=kind != "enc_attn",
                           prefix_len=self.prefix_len)
        elif kind == "dec_attn":
            h = attn_apply(p["attn"], h, self.cfg, caps=caps,
                           prefix=f"{name_prefix}attn.", cache=cache,
                           pos=pos, differentiable=differentiable)
            h = self._cross(p, h, caps, name_prefix, cache, pos,
                            differentiable, enc_out)
        else:
            h = STATE_BLOCKS[kind][1](p[kind], h, self.cfg, caps=caps,
                                      prefix=f"{name_prefix}{kind}.",
                                      cache=cache, pos=pos, paged=paged)
        if "moe" in p:
            return moe_apply(p["moe"], h, self.cfg, caps=caps,
                             prefix=f"{name_prefix}moe.")
        if "mlp" in p:
            h = mlp_apply(p["mlp"], h, self.cfg, caps=caps,
                          prefix=f"{name_prefix}mlp.")
        return h, None

    def _cross(self, p: Params, h: torch.Tensor, caps, name_prefix: str,
               cache, pos, differentiable: bool,
               enc_out: Optional[torch.Tensor]) -> torch.Tensor:
        """A decoder block's cross-attention: K / V from ``enc_out``
        through ``xattn.wk`` / ``wv`` (captured under those names; a
        rank's KV heads under a model axis that splits them), stored into
        the dense cache at prefill; in decode (no ``enc_out``) read back
        from it."""
        cfg = self.cfg
        if enc_out is None:
            xk, xv = cache["xk"], cache["xv"]
        else:
            b, s, _ = enc_out.shape        # the rank's KV heads' columns
            shape = (b, s, out_dim(p["xattn"]["wk"]) // cfg.hd, cfg.hd)
            xk = linear(enc_out, p["xattn"]["wk"], caps=caps,
                        name=f"{name_prefix}xattn.wk").reshape(shape)
            xv = linear(enc_out, p["xattn"]["wv"], caps=caps,
                        name=f"{name_prefix}xattn.wv").reshape(shape)
            if cache is not None:                   # prefill: stored once
                cache["xk"].copy_(xk)
                cache["xv"].copy_(xv)
        return attn_apply(p["xattn"], h, cfg, caps=caps,
                          prefix=f"{name_prefix}xattn.", pos=pos,
                          differentiable=differentiable, cross_kv=(xk, xv))

    def forward(self, params: Params, tokens: torch.Tensor,
                differentiable: bool = False,
                frontend_feats: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Full-sequence forward: tokens (B, T) → logits (B, T', V) f32,
        T' = T plus the prefix-LM's frontend_len positions (a frontend
        model takes ``frontend_feats``).  ``differentiable`` takes the
        training route: attention in torch ops (the reference's
        ``_sdpa``), which autograd can differentiate — the kernels have no
        backward and refuse inputs that require grad."""
        return self._forward(params, tokens, differentiable,
                             frontend_feats)[0]

    def _forward(self, params: Params, tokens: torch.Tensor,
                 differentiable: bool = False,
                 frontend_feats: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, the MoE layers' aux losses summed in layer order — 0
        for a model without experts), as the reference's ``forward``."""
        batch = _batch(tokens, frontend_feats)
        if differentiable:
            self.check_tp_training(self.serve_tp())
        enc_out = (self.encode(params, batch, differentiable=differentiable)
                   if self.cfg.encdec else None)
        h = self.first_hidden(params, batch)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for kind, p in zip(self.kinds, self.blocks(params)):
            h, a = self._block(p, h, kind, differentiable=differentiable,
                               enc_out=enc_out)
            if a is not None:
                aux = aux + a
        logits = unembed_apply(params["unembed"], params["embed"], h,
                               self.cfg).float()
        return logits, aux

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor],
                differentiable: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token CE + z-loss + ``router_aux_coef`` × the MoE aux loss,
        returned as the reference returns them: (loss, {"ce", "zloss",
        "aux", "tokens"}); labels < 0 are ignored.  The trainer passes
        ``differentiable=True`` (see :meth:`forward`); evaluation keeps the
        kernel route."""
        logits, aux = self._forward(params, batch["tokens"], differentiable,
                                    batch.get("frontend_feats"))
        targets = batch["labels"].long()    # text only: past the frontend
        lg = logits[:, logits.shape[1] - targets.shape[1]:][:, :-1]
        tg = targets[:, 1:]
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, torch.clamp(tg, min=0)[..., None])[..., 0]
        nll = lse - gold
        weights = (tg >= 0).float()
        denom = torch.clamp(weights.sum(), min=1.0)
        ce = (nll * weights).sum() / denom
        zloss = 1e-4 * ((lse ** 2) * weights).sum() / denom
        coef = self.cfg.moe.router_aux_coef if self.cfg.moe else 0.0
        return ce + zloss + coef * aux, {"ce": ce, "zloss": zloss,
                                         "aux": aux, "tokens": denom}

    def blocks(self, params: Params) -> List[Params]:
        """Every block's params in forward order (``self.kinds``'s): the
        prefix blocks, then the period layers."""
        return [*params.get("prefix", []), *params["layers"]]

    # ------------------------------------------------- pruning contract
    def block_linears(self) -> Tuple[Tuple[str, str], ...]:
        """The (sub, key) prunable linears of the model's mixers, each once
        in the reference's order (``_BLOCK_LINEARS`` over the prefix and
        the period)."""
        pairs = [pair for kind in (*self.cfg.prefix, *self.cfg.period)
                 for pair in _BLOCK_LINEARS[kind]]
        return tuple(dict.fromkeys(pairs))

    def first_hidden(self, params: Params,
                     batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The embedding output entering block 0; the prefix-LM's projected
        frontend features, scaled by √d in their dtype, go in front of the
        text's."""
        cfg = self.cfg
        h = embed_apply(params["embed"], batch["tokens"], cfg)
        if self.prefix_len is None:
            return h
        fh = frontend_apply(params["embed"], self._feats(batch), cfg)
        if cfg.embed_scale:
            fh = fh * embed_scale(cfg, fh.dtype)
        return torch.cat([fh.to(h.dtype), h], dim=1)

    def _feats(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = batch.get("frontend_feats")
        if feats is None:
            cfg = self.cfg
            raise ValueError(
                f"{cfg.name}: the batch needs frontend_feats (B, "
                f"{cfg.frontend_len}, {cfg.frontend_dim}) for its "
                f"{cfg.frontend} frontend stub")
        return feats

    def encode(self, params: Params, batch: Dict[str, torch.Tensor],
               differentiable: bool = False) -> torch.Tensor:
        """The encoder stack over the projected frontend features, then
        ``enc/ln`` (the encoder-decoder's)."""
        cfg = self.cfg
        h = frontend_apply(params["embed"], self._feats(batch),
                           cfg).to(self.dtype)
        for p in params["enc"]["layers"]:
            h, _ = self._block(p, h, "enc_attn",
                               differentiable=differentiable)
        return rmsnorm(params["enc"]["ln"], h, cfg.norm_eps)

    def calib_init(self, params: Params, batch: Dict[str, torch.Tensor]):
        """The calibration state entering segment 0: the hidden, or for
        the encoder-decoder ``{"h": the decoder's embedding, "enc": the
        projected frontend features}`` — encoder segments advance "enc",
        decoder segments "h", reading the normed final "enc" (the
        reference's)."""
        if not self.cfg.encdec:
            return self.first_hidden(params, batch)
        return {"h": self.first_hidden(params, batch),
                "enc": frontend_apply(params["embed"], self._feats(batch),
                                      self.cfg).to(self.dtype)}

    def prunable_segments(self) -> List[SegmentSpec]:
        """The encoder-decoder's encoder layers first, one segment each,
        ``enc{li}`` with linears ``attn.wq`` … ``attn.wo``, ``mlp.*``;
        then one segment per leading prefix block, ``prefix{i}``, its
        params the block's own (its linears as a slot's below, without
        the ``s{j}.``); then one segment per period, named ``period{i}`` as the reference
        names them; a segment's params are ``{"s{j}": params of its slot
        j}`` (and the encoder-decoder's ``"_encln"``, the encoder's final
        norm, which its decoder blocks apply to the state's "enc") and its
        linears, slot by slot, ``s{j}.attn.wq`` … ``s{j}.attn.wo`` (a
        decoder block's ``s{j}.xattn.wq`` … ``wo`` after them),
        ``s{j}.mamba.in_proj`` … ``s{j}.mamba.out_proj``, ``s{j}.mlstm.wq``
        … ``wo`` (not the f32 gates ``wi`` / ``wf``) or ``s{j}.slstm.wz`` …
        ``wo``, then ``s{j}.mlp.*`` where the slot has an MLP, or where it
        has experts ``s{j}.moe.wi.0`` … ``wi.{E-1}``, ``wg.*``, ``wo.*``
        and then the shared expert's ``s{j}.moe.shared.*`` (the
        reference's order).  The router's input is captured too
        (``s{j}.moe.router``) but pruned by no linear, as in the
        reference."""
        cfg = self.cfg
        slots = [f"s{j}" for j in range(len(cfg.period))]
        linears = [lin for sk, kind, is_moe
                   in zip(slots, cfg.period, self.moe_slots)
                   for lin in self._slot_linears((sk,), kind, is_moe)]

        def apply(seg_params, state, capture=False):
            caps = {} if capture else None
            h, enc_out = state, None
            if cfg.encdec:
                h = state["h"]
                enc_out = rmsnorm(seg_params["_encln"], state["enc"],
                                  cfg.norm_eps)
            for sk, kind in zip(slots, cfg.period):
                h, _ = self._block(seg_params[sk], h, kind, caps=caps,
                                   name_prefix=f"{sk}.", enc_out=enc_out)
            return ({**state, "h": h} if cfg.encdec else h), caps or {}

        def layer_ids(i):
            return range(i * len(slots), (i + 1) * len(slots))

        def get_params(i, params):
            sp = {sk: params["layers"][li]
                  for sk, li in zip(slots, layer_ids(i))}
            if cfg.encdec:
                sp["_encln"] = params["enc"]["ln"]
            return sp

        def set_params(i, params, seg_params):
            layers = list(params["layers"])
            for sk, li in zip(slots, layer_ids(i)):
                layers[li] = seg_params[sk]
            return {**params, "layers": layers}

        periods = [SegmentSpec(name=f"period{i}", apply=apply,
                               linears=linears,
                               get_params=functools.partial(get_params, i),
                               set_params=functools.partial(set_params, i))
                   for i in range(cfg.n_periods)]
        return self._encoder_segments() + self._prefix_segments() + periods

    def _slot_linears(self, base: Tuple[str, ...], kind: str,
                      is_moe: bool) -> List[LinearSpec]:
        """The linear specs of one block inside a segment's params at
        path ``base`` (``("s0",)`` in a period, ``()`` for a prefix
        block), named ``{base}.{sub}.{key}`` in the reference's order."""
        cfg = self.cfg
        npfx = "".join(f"{k}." for k in base)
        subs = list(_BLOCK_LINEARS[kind])
        if cfg.block_has_mlp(kind) and not is_moe:
            subs += [("mlp", key) for key in _MLP_LINEARS[cfg.mlp_kind]]
        linears = [_linear_spec((*base, sub, key), f"{npfx}{sub}.{key}",
                                self.dtype) for sub, key in subs]
        if not (cfg.block_has_mlp(kind) and is_moe):
            return linears
        linears += [_expert_spec(base, key, e, self.dtype)
                    for key in ("wi", "wg", "wo")
                    for e in range(cfg.moe.num_experts)]
        if cfg.moe.num_shared:
            linears += [_linear_spec((*base, "moe", "shared", key),
                                     f"{npfx}moe.shared.{key}", self.dtype)
                        for key in _MLP_LINEARS[cfg.mlp_kind]]
        return linears

    def _prefix_segments(self) -> List[SegmentSpec]:
        """One ``prefix{i}`` segment per leading prefix block: its params
        the block's dict (with the encoder-decoder's ``"_encln"``), its
        linears unprefixed, as the reference's."""
        cfg = self.cfg

        def apply(kind, seg_params, state, capture=False):
            caps = {} if capture else None
            h, enc_out = state, None
            if cfg.encdec:
                h = state["h"]
                enc_out = rmsnorm(seg_params["_encln"], state["enc"],
                                  cfg.norm_eps)
            h, _ = self._block(seg_params, h, kind, caps=caps,
                               enc_out=enc_out)
            return ({**state, "h": h} if cfg.encdec else h), caps or {}

        def get_params(i, params):
            sp = dict(params["prefix"][i])
            if cfg.encdec:
                sp["_encln"] = params["enc"]["ln"]
            return sp

        def set_params(i, params, seg_params):
            prefix = list(params["prefix"])
            prefix[i] = {k: v for k, v in seg_params.items()
                         if k != "_encln"}
            return {**params, "prefix": prefix}

        return [SegmentSpec(name=f"prefix{i}",
                            apply=functools.partial(apply, kind),
                            linears=self._slot_linears((), kind, is_moe),
                            get_params=functools.partial(get_params, i),
                            set_params=functools.partial(set_params, i))
                for i, (kind, is_moe)
                in enumerate(zip(cfg.prefix, self.prefix_moe))]

    def _encoder_segments(self) -> List[SegmentSpec]:
        """The encoder-decoder's ``enc{li}`` segments (none otherwise):
        the layer's params as they are, its linears ``attn.*`` and
        ``mlp.*``; the segment advances the state's "enc"."""
        cfg = self.cfg
        if not cfg.encdec:
            return []
        subs = [*_BLOCK_LINEARS["enc_attn"],
                *(("mlp", key) for key in _MLP_LINEARS[cfg.mlp_kind])]
        linears = [_linear_spec((sub, key), f"{sub}.{key}", self.dtype)
                   for sub, key in subs]

        def apply(seg_params, state, capture=False):
            caps = {} if capture else None
            enc, _ = self._block(seg_params, state["enc"], "enc_attn",
                                 caps=caps)
            return {**state, "enc": enc}, caps or {}

        def get_params(li, params):
            return params["enc"]["layers"][li]

        def set_params(li, params, seg_params):
            layers = list(params["enc"]["layers"])
            layers[li] = seg_params
            return {**params, "enc": {**params["enc"], "layers": layers}}

        return [SegmentSpec(name=f"enc{li}", apply=apply, linears=linears,
                            get_params=functools.partial(get_params, li),
                            set_params=functools.partial(set_params, li))
                for li in range(cfg.enc_layers)]

    # ------------------------------------------ tensor-parallel training
    def check_tp_training(self, tp: int) -> None:
        """Raise unless the training route runs under a model axis of
        ``tp``: any model at 1, the dense decoders (attention blocks and
        dense MLPs, no prefix blocks, experts or frontend) above it."""
        cfg = self.cfg
        dense = (set(self.kinds) <= set(ATTN_KINDS) and cfg.moe is None
                 and cfg.frontend is None and not cfg.encdec)
        if tp > 1 and not dense:
            raise ValueError(
                f"{cfg.name}: training under a model axis > 1 covers the "
                f"dense decoders; blocks {sorted(set(self.kinds))}"
                f"{' with experts' if cfg.moe is not None else ''}"
                f"{' and a frontend' if cfg.frontend is not None else ''} "
                "are not ported there yet (ROADMAP.md, Queue 1); train "
                "them on a Dx1 mesh")

    # ------------------------------------------ tensor-parallel serving
    def serve_tp(self) -> int:
        """The active context's model axis (1 without a context)."""
        ctx = current_ctx()
        return 1 if ctx is None else ctx.tp

    def cache_kv_heads(self) -> int:
        """KV heads this rank's paged pool or dense cache holds: its block
        where the rule splits them (``dist.sharding.kv_head_split``), all
        of them otherwise."""
        kv, tp = self.cfg.num_kv_heads, self.serve_tp()
        return kv if kv_head_split(kv, tp) is None else kv // tp

    # ----------------------------------------------------- dense cache
    def init_cache(self, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None
                   ) -> List[Dict[str, torch.Tensor]]:
        """The dense decode cache of static mode: one (B, max_len, KV, hd)
        K and V per attention layer (a decoder block's with its (B,
        frontend_len, KV, hd) cross K / V ``xk`` / ``xv``; KV the rank's
        heads, :meth:`cache_kv_heads`), the (B, ...) init state per
        recurrent layer.  A prefix-LM's ``max_len`` counts its frontend
        positions."""
        dt = dtype or self.dtype
        cfg = self.cfg
        kvh = self.cache_kv_heads()
        cache = []
        for kind in self.kinds:
            if kind in STATE_BLOCKS:
                cache.append(self.state_init(kind, batch, dt))
                continue
            c = attn_cache_init(cfg, batch, max_len, dt, self.device, kvh)
            if kind == "dec_attn":
                shape = (batch, cfg.frontend_len, kvh, cfg.hd)
                c["xk"] = torch.zeros(shape, dtype=dt, device=self.device)
                c["xv"] = torch.zeros(shape, dtype=dt, device=self.device)
            cache.append(c)
        return cache

    def state_init(self, kind: str, batch: int,
                   dtype) -> Dict[str, torch.Tensor]:
        """The init state of ``batch`` rows of a recurrent block ``kind``
        (the reference's ``block_cache_init``), at the rank's width under
        a model axis that splits the block (``dist.sharding.state_split``:
        d_inner / tp channels, NH / tp heads)."""
        tp = self.serve_tp()
        split = any(d is not None
                    for d in state_split(kind, self.cfg, tp).values())
        return STATE_BLOCKS[kind][2](self.cfg, batch, dtype, self.device,
                                     tp if split else 1)

    def prefill(self, params: Params, tokens: torch.Tensor,
                cache: List[Dict[str, torch.Tensor]],
                frontend_feats: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """The prompts (B, T) through the model, filling ``cache[:, :T]``
        in place (a prefix-LM's T counts its frontend positions first; an
        encoder-decoder's cross K / V fill ``xk`` / ``xv``); returns the
        last position's logits (B, V) f32.  The attention is the
        full-sequence one (``flash_attn`` on the card).  A frontend model
        takes ``frontend_feats``."""
        batch = _batch(tokens, frontend_feats)
        enc_out = self.encode(params, batch) if self.cfg.encdec else None
        h = self.first_hidden(params, batch)
        for i, (kind, p) in enumerate(zip(self.kinds, self.blocks(params))):
            h, _ = self._block(p, h, kind, cache=cache[i], enc_out=enc_out)
        logits = unembed_apply(params["unembed"], params["embed"],
                               h[:, -1:], self.cfg)
        return logits[:, 0, :].float()

    # ----------------------------------------------------------- paged
    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype: Optional[torch.dtype] = None,
                         max_slots: Optional[int] = None
                         ) -> List[Dict[str, torch.Tensor]]:
        """One (num_pages, page_size, KV, hd) K and V pool per attention
        layer (page 0 is the scrap page; serve.kvpool owns the allocator),
        ``dtype`` int8 adding the per-row f32 scale leaves; per recurrent
        layer the state rows of ``max_slots`` serve slots, at the model
        dtype when the pages are int8 (serve.kvpool.StatePool resets a
        row at admission)."""
        self._refuse_paged()
        dt = dtype or self.dtype
        state_dt = self.dtype if dt == torch.int8 else dt
        if max_slots is None and any(k in self.STATE_KINDS
                                     for k in self.kinds):
            raise ValueError(
                f"{self.cfg.name}: recurrent-state mixers need max_slots for "
                "the slot-pooled state (serve.kvpool.StatePool)")
        kvh = self.cache_kv_heads()
        return [attn_paged_cache_init(self.cfg, num_pages, page_size, dt,
                                      self.device, kvh)
                if kind in ATTN_KINDS
                else self.state_init(kind, max_slots, state_dt)
                for kind in self.kinds]

    def _refuse_paged(self) -> None:
        """The paged serve cache holds decoder-only models: the prefix-LM's
        bidirectional prefix and the encoder-decoder's cross K / V have no
        place in it (the reference's ``init_paged_cache`` refuses them
        too); they serve static."""
        cfg = self.cfg
        if cfg.encdec or cfg.frontend is not None:
            raise ValueError(f"{cfg.name}: paged decode supports plain "
                             "decoder archs only (got encdec/frontend)")

    def prefill_chunk(self, params: Params, tokens: torch.Tensor,
                      cache: List[Dict[str, torch.Tensor]], start: int,
                      length: int, block_tables: torch.Tensor, *,
                      page_size: int, slot: int = 0) -> torch.Tensor:
        """One fixed-size chunk of ONE request's prompt.

        tokens: (1, C) — prompt tokens ``start .. start+C``, zero-padded
        past ``length``; block_tables: (1, P_max); ``slot`` the request's
        serve slot.  Writes the chunk's K/V into the pages, carries slot
        ``slot``'s recurrent state forward, and returns the logits at
        position ``min(length, start+C) - 1`` (the sampling logits when
        this is the final chunk), (1, V) f32."""
        self._refuse_paged()
        h = embed_apply(params["embed"], tokens, self.cfg)
        t = h.shape[1]
        lengths = torch.full((1,), length, dtype=torch.int32,
                             device=h.device)
        paged = {"block_tables": block_tables, "lengths": lengths,
                 "start": start, "length": length, "slot": slot}
        for i, (kind, p) in enumerate(zip(self.kinds, self.blocks(params))):
            h, _ = self._block(p, h, kind, cache=cache[i], paged=paged,
                               page_size=page_size)
        idx = min(max(length - 1 - start, 0), t - 1)
        logits = unembed_apply(params["unembed"], params["embed"],
                               h[:, idx:idx + 1], self.cfg)
        return logits[:, 0, :].float()

    def decode_step(self, params: Params, token: torch.Tensor,
                    cache: List[Dict[str, torch.Tensor]], pos,
                    block_tables: Optional[torch.Tensor] = None, *,
                    page_size: Optional[int] = None) -> torch.Tensor:
        """One decode token per row: token (B,).  Paged (``block_tables``
        (B, P_max) given): ``pos`` (B,) write positions with -1 marking
        idle slots, whose state rows stay as they are.  Dense cache
        (static mode): ``pos`` the host int position every row writes (a
        prefix-LM's counts its frontend positions; an encoder-decoder's
        cross-attention reads the cached ``xk`` / ``xv``).  Returns logits
        (B, V) f32; the cache is updated in place."""
        h = embed_apply(params["embed"], token[:, None], self.cfg)
        paged = None if block_tables is None else {
            "block_tables": block_tables}
        for i, (kind, p) in enumerate(zip(self.kinds, self.blocks(params))):
            h, _ = self._block(p, h, kind, cache=cache[i], pos=pos,
                               paged=paged, page_size=page_size)
        logits = unembed_apply(params["unembed"], params["embed"], h,
                               self.cfg)
        return logits[:, 0, :].float()


# ----------------------------------------------------------------------
def _batch(tokens: torch.Tensor,
           frontend_feats: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    batch = {"tokens": tokens}
    if frontend_feats is not None:
        batch["frontend_feats"] = frontend_feats
    return batch


def _linear_spec(path: Tuple[str, ...], name: str, dtype) -> LinearSpec:
    """Weights are stored (in, out); the paper works in (out, in): get
    returns the transposed view, set stores the transpose back (a fresh
    contiguous tensor in the model dtype, along freshly copied dicts)."""

    def get(sp):
        return _get_path(sp, path).T

    def set_(sp, w):
        sp = dict(sp)
        node = sp
        for key in path[:-1]:
            node[key] = dict(node[key])
            node = node[key]
        node[path[-1]] = w.T.to(dtype).contiguous()
        return sp

    return LinearSpec(name=name, get=get, set=set_)


def _expert_spec(base: Tuple[str, ...], key: str, e: int,
                 dtype) -> LinearSpec:
    """Expert ``e`` of the stacked ``moe/{key}`` (E, in, out) of the
    block at path ``base`` (a slot ``("s0",)``, or ``()`` for a prefix
    block's own params): get returns its (out, in) view; set writes the
    transpose into a copy of the stack (the reference's ``.at[e].set``),
    so the params it was handed stay as they were."""

    def get(sp):
        return _get_path(sp, base)["moe"][key][e].T

    def set_(sp, w):
        block = dict(_get_path(sp, base))
        moe = dict(block["moe"])
        stack = moe[key].clone()
        stack[e] = w.T.to(dtype)
        moe[key] = stack
        block["moe"] = moe
        return {**sp, base[0]: block} if base else block

    npfx = "".join(f"{k}." for k in base)
    return LinearSpec(name=f"{npfx}moe.{key}.{e}", get=get, set=set_)


def _get_path(tree, parts):
    for key in parts:
        tree = tree[key]
    return tree


def _leaves(tree, prefix: str = ""):
    """(path, tensor) for every leaf of a nested dict, keys sorted."""
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], path + "/")
        else:
            yield path, tree[key]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch → numpy on the host; bf16 as 2-byte void (its bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _set_path(tree: Dict[str, Any], parts: List[str], value) -> None:
    for key in parts[:-1]:
        tree = tree.setdefault(key, {})
    tree[parts[-1]] = value


def _to_torch(arr: np.ndarray, device) -> torch.Tensor:
    """numpy → torch on ``device`` (a copy).  bf16 — the ml_dtypes
    bfloat16 that JAX hands out, or the raw 2-byte void that npz stores
    it as — is carried over bit for bit through a uint16 view."""
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)
