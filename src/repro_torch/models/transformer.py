"""The decoder LM: init, full-sequence forward and loss (the kernel
route, and the differentiable route the trainer takes), the pruning
contract (``calib_init`` / ``prunable_segments``), the dense-cache serve
methods of static mode (``init_cache`` / ``prefill`` / ``decode_step``)
and the paged ones of continuous mode (``init_paged_cache`` /
``prefill_chunk`` / ``decode_step`` with block tables).

Ported block kinds: global attention, sliding-window attention, Mamba
and the xLSTM's mLSTM and sLSTM (``period`` ⊂ {"attn", "attn_local",
"mamba", "mlstm", "slstm"}), each with its FFN where
``cfg.block_has_mlp`` says so: a dense MLP, or in the slots that
``cfg.slot_is_moe`` names a Mixture-of-Experts (``models.moe``) — the
dense decoders (qk-norm included: Qwen3, Gemma3's 5:1 local:global
period), the MoE decoders (phi3.5-moe, kimi-k2 with its shared expert),
the Mamba LM, the Mamba/attention hybrid with its experts (Jamba) and
the xLSTM (7 mLSTM : 1 sLSTM).  An ``attn_local`` block is an ``attn``
block (the same params under ``"attn"``, the same linears, KV pages and
dense cache) whose attention sees the last ``cfg.window`` positions.  No
prefix, encoder-decoder or frontend; ROADMAP.md lists them.  Where the
reference stacks the layers (L, ...) under ``layers/s{j}`` for
``lax.scan``, the port keeps a per-layer list of param dicts and loops:
layer ``i`` is slot ``i % len(period)`` of period ``i // len(period)``,
``params["layers"][i] = {"attn" | "mamba" | "mlstm" | "slstm": {...},
"mlp" | "moe": {...}}``, a MoE's experts stacked (E, ...) as the
reference stacks them.  The caches are per-layer lists too: an attention
layer's paged ``{"k", "v"[, "k_scale", "v_scale"]}`` page tensors or
dense (B, max_len, KV, hd) ``{"k", "v"}``, a recurrent layer's state rows
(``models.ssm``; one per serve slot when paged); all are updated in
place.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core.engine import LinearSpec, SegmentSpec
from repro_torch.models.base import ArchConfig
from repro_torch.models.layers import (Params, attn_apply, attn_cache_init,
                                       attn_init, attn_paged_cache_init,
                                       embed_apply, embed_init, mlp_apply,
                                       mlp_init, sub_keys, unembed_apply,
                                       unembed_init)
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
PORTED_KINDS = (*ATTN_KINDS, *STATE_BLOCKS)
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
_MLP_LINEARS = {"swiglu": ("wi", "wg", "wo"), "geglu": ("wi", "wg", "wo"),
                "gelu": ("wi", "wo"), "none": ()}


class LM:
    """A decoder of attention and recurrent blocks from one ArchConfig, on
    one device."""

    # block kinds whose paged serve cache is slot-pooled recurrent state
    # (serve.kvpool.StatePool resets their rows), and those whose cache is
    # KV pages (serve.kvpool.PagedKVPool pools, shares and swaps them)
    STATE_KINDS = tuple(STATE_BLOCKS)
    ATTN_KINDS = ATTN_KINDS

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if (cfg.prefix or cfg.encdec or cfg.frontend is not None
                or any(k not in PORTED_KINDS for k in cfg.period)):
            raise ValueError(
                f"{cfg.name}: prefix, encoder-decoder and frontend models "
                "are not ported (ROADMAP.md, Queue 1: the other families)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg.dtype]
        period = cfg.period
        self.kinds = [period[i % len(period)] for i in range(cfg.num_layers)]
        self.moe_slots = [cfg.slot_is_moe(j, False)
                          for j in range(len(period))]

    # ------------------------------------------------------------- init
    def init(self, rng) -> Params:
        """Random params at the reference's scales (``_dense_init``,
        ``embed_init``, ``ssm``'s inits, ``moe_init``) on the device of
        ``rng``: a
        ``torch.Generator`` (sequential draws), or a threefry key
        (``random.key(seed)``), which reproduces the reference's
        ``LM.init(jax.random.key(seed))`` — its key splits (``split(key,
        8)``; slot ``j`` of period ``p`` from ``split(fold_in(keys[3], j),
        n_periods)[p]``, then ``split(·, 3)`` into mixer and MLP) and its
        normals up to the last ulp."""
        cfg, dt = self.cfg, self.dtype
        keys = sub_keys(rng, 8)
        n_slots = len(cfg.period)
        if isinstance(rng, torch.Generator):
            layer_keys = [rng] * cfg.num_layers
        else:
            slot_keys = [rnd.split(rnd.fold_in(keys[3], j), cfg.n_periods)
                         for j in range(n_slots)]
            layer_keys = [slot_keys[i % n_slots][i // n_slots]
                          for i in range(cfg.num_layers)]
        params: Params = {"embed": embed_init(keys[0], cfg, dt),
                          "unembed": unembed_init(keys[1], cfg, dt)}
        params["layers"] = []
        for i, (kind, lk) in enumerate(zip(self.kinds, layer_keys)):
            k_mix, k_ffn, _ = sub_keys(lk, 3)
            block = ({"attn": attn_init(k_mix, cfg, dt)}
                     if kind in ATTN_KINDS
                     else {kind: STATE_BLOCKS[kind][0](k_mix, cfg, dt)})
            if cfg.block_has_mlp(kind):
                if self.moe_slots[i % n_slots]:
                    block["moe"] = moe_init(k_ffn, cfg, dt)
                else:
                    block["mlp"] = mlp_init(k_ffn, cfg, dt)
            params["layers"].append(block)
        return params

    def params_from_jax(self, flat: Dict[str, np.ndarray]) -> Params:
        """The reference's path-keyed leaves (``ckpt/store.py::_flatten``
        names: ``layers/s0/attn/wq``, ``embed/tok``, ...) → port params.
        The stacked layer axis is unstacked (a MoE's expert axis stays
        stacked, and its f32 router stays f32); packed ``{"vals","idx"}``
        leaves stay packed."""
        period = len(self.cfg.period)
        params: Params = {"layers": [{} for _ in range(self.cfg.num_layers)]}
        for path, arr in flat.items():
            parts = path.split("/")
            if parts[0] == "layers":
                j = int(parts[1][1:])                    # "s{j}"
                for i in range(arr.shape[0]):
                    _set_path(params["layers"][i * period + j], parts[2:],
                              _to_torch(arr[i], self.device))
            elif parts[0] in ("embed", "unembed"):
                _set_path(params, parts, _to_torch(arr, self.device))
            else:
                raise ValueError(f"leaf {path!r}: not a param of a ported "
                                 "block kind")
        return params

    def params_to_flat(self, params: Params) -> Dict[str, np.ndarray]:
        """The inverse of :meth:`params_from_jax`: port params → the
        reference's path-keyed numpy leaves, layers stacked (L, ...) under
        ``layers/s{j}``.  bf16 leaves come out as the 2-byte void arrays
        that the reference's checkpoints hold."""
        period = len(self.cfg.period)
        flat: Dict[str, np.ndarray] = {}
        for j in range(period):
            stack = params["layers"][j::period]
            for path, _ in _leaves(stack[0]):
                flat[f"layers/s{j}/{path}"] = np.stack(
                    [_to_numpy(_get_path(lp, path.split("/")))
                     for lp in stack])
        for key in ("embed", "unembed"):
            for path, t in _leaves(params[key]):
                flat[f"{key}/{path}"] = _to_numpy(t)
        return flat

    # ---------------------------------------------------------- forward
    def _block(self, p: Params, h: torch.Tensor, kind: str, caps=None,
               name_prefix: str = "", cache=None, pos=None, paged=None,
               page_size=None, differentiable: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One block (mixer, then its FFN if it has one): (h, the MoE's aux
        loss or None).  The cache modes are the mixer's (``attn_apply`` /
        ``ssm.mamba_apply`` / ``mlstm_apply`` / ``slstm_apply``); a MoE FFN
        routes the call's B·T tokens."""
        if kind in ATTN_KINDS:
            h = attn_apply(p["attn"], h, self.cfg, caps=caps,
                           prefix=f"{name_prefix}attn.", cache=cache,
                           pos=pos, paged=paged, page_size=page_size,
                           differentiable=differentiable,
                           window=(self.cfg.window if kind == "attn_local"
                                   else None))
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

    def forward(self, params: Params, tokens: torch.Tensor,
                differentiable: bool = False) -> torch.Tensor:
        """Full-sequence causal forward: tokens (B, T) → logits (B, T, V)
        f32.  ``differentiable`` takes the training route: attention in
        torch ops (the reference's ``_sdpa``), which autograd can
        differentiate — the kernels have no backward and refuse inputs
        that require grad."""
        return self._forward(params, tokens, differentiable)[0]

    def _forward(self, params: Params, tokens: torch.Tensor,
                 differentiable: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, the MoE layers' aux losses summed in layer order — 0
        for a model without experts), as the reference's ``forward``."""
        h = embed_apply(params["embed"], tokens, self.cfg)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for kind, p in zip(self.kinds, params["layers"]):
            h, a = self._block(p, h, kind, differentiable=differentiable)
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
        logits, aux = self._forward(params, batch["tokens"], differentiable)
        targets = batch["labels"].long()
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

    # ------------------------------------------------- pruning contract
    def block_linears(self) -> Tuple[Tuple[str, str], ...]:
        """The (sub, key) prunable linears of the model's mixers, each once
        in the reference's order (``_BLOCK_LINEARS`` over the period)."""
        pairs = [pair for kind in self.cfg.period
                 for pair in _BLOCK_LINEARS[kind]]
        return tuple(dict.fromkeys(pairs))

    def first_hidden(self, params: Params,
                     batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The embedding output entering block 0."""
        return embed_apply(params["embed"], batch["tokens"], self.cfg)

    def calib_init(self, params: Params,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The calibration state entering segment 0 (the hidden)."""
        return self.first_hidden(params, batch)

    def prunable_segments(self) -> List[SegmentSpec]:
        """One segment per period, named ``period{i}`` as the reference
        names them; a segment's params are ``{"s{j}": params of its slot
        j}`` and its linears, slot by slot, ``s{j}.attn.wq`` …
        ``s{j}.attn.wo``, ``s{j}.mamba.in_proj`` … ``s{j}.mamba.out_proj``,
        ``s{j}.mlstm.wq`` … ``wo`` (not the f32 gates ``wi`` / ``wf``) or
        ``s{j}.slstm.wz`` … ``wo``, then ``s{j}.mlp.*`` where the slot has
        an MLP, or where it has
        experts ``s{j}.moe.wi.0`` … ``wi.{E-1}``, ``wg.*``, ``wo.*`` and
        then the shared expert's ``s{j}.moe.shared.*`` (the reference's
        order).  The router's input is captured too (``s{j}.moe.router``)
        but pruned by no linear, as in the reference."""
        cfg = self.cfg
        slots = [f"s{j}" for j in range(len(cfg.period))]
        linears = []
        for sk, kind, is_moe in zip(slots, cfg.period, self.moe_slots):
            subs = [(sub, key) for sub, key in _BLOCK_LINEARS[kind]]
            if cfg.block_has_mlp(kind) and not is_moe:
                subs += [("mlp", key) for key in _MLP_LINEARS[cfg.mlp_kind]]
            linears += [_linear_spec((sk, sub, key), f"{sk}.{sub}.{key}",
                                     self.dtype) for sub, key in subs]
            if not (cfg.block_has_mlp(kind) and is_moe):
                continue
            linears += [_expert_spec(sk, key, e, self.dtype)
                        for key in ("wi", "wg", "wo")
                        for e in range(cfg.moe.num_experts)]
            if cfg.moe.num_shared:
                linears += [_linear_spec((sk, "moe", "shared", key),
                                         f"{sk}.moe.shared.{key}", self.dtype)
                            for key in _MLP_LINEARS[cfg.mlp_kind]]

        def apply(seg_params, h, capture=False):
            caps = {} if capture else None
            for sk, kind in zip(slots, cfg.period):
                h, _ = self._block(seg_params[sk], h, kind, caps=caps,
                                   name_prefix=f"{sk}.")
            return h, caps or {}

        def layer_ids(i):
            return range(i * len(slots), (i + 1) * len(slots))

        def get_params(i, params):
            return {sk: params["layers"][li]
                    for sk, li in zip(slots, layer_ids(i))}

        def set_params(i, params, seg_params):
            layers = list(params["layers"])
            for sk, li in zip(slots, layer_ids(i)):
                layers[li] = seg_params[sk]
            return {**params, "layers": layers}

        return [SegmentSpec(name=f"period{i}", apply=apply, linears=linears,
                            get_params=functools.partial(get_params, i),
                            set_params=functools.partial(set_params, i))
                for i in range(cfg.n_periods)]

    # ----------------------------------------------------- dense cache
    def init_cache(self, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None
                   ) -> List[Dict[str, torch.Tensor]]:
        """The dense decode cache of static mode: one (B, max_len, KV, hd)
        K and V per attention layer, the (B, ...) init state per recurrent
        layer."""
        dt = dtype or self.dtype
        return [attn_cache_init(self.cfg, batch, max_len, dt, self.device)
                if kind in ATTN_KINDS
                else self.state_init(kind, batch, dt)
                for kind in self.kinds]

    def state_init(self, kind: str, batch: int,
                   dtype) -> Dict[str, torch.Tensor]:
        """The init state of ``batch`` rows of a recurrent block ``kind``
        (the reference's ``block_cache_init``)."""
        return STATE_BLOCKS[kind][2](self.cfg, batch, dtype, self.device)

    def prefill(self, params: Params, tokens: torch.Tensor,
                cache: List[Dict[str, torch.Tensor]]) -> torch.Tensor:
        """The prompts (B, T) through the model, filling ``cache[:, :T]``
        in place; returns the last position's logits (B, V) f32.  The
        attention is the full-sequence one (``flash_attn`` on the card)."""
        h = embed_apply(params["embed"], tokens, self.cfg)
        for i, (kind, p) in enumerate(zip(self.kinds, params["layers"])):
            h, _ = self._block(p, h, kind, cache=cache[i])
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
        dt = dtype or self.dtype
        state_dt = self.dtype if dt == torch.int8 else dt
        if max_slots is None and any(k in self.STATE_KINDS
                                     for k in self.kinds):
            raise ValueError(
                f"{self.cfg.name}: recurrent-state mixers need max_slots for "
                "the slot-pooled state (serve.kvpool.StatePool)")
        return [attn_paged_cache_init(self.cfg, num_pages, page_size, dt,
                                      self.device)
                if kind in ATTN_KINDS
                else self.state_init(kind, max_slots, state_dt)
                for kind in self.kinds]

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
        h = embed_apply(params["embed"], tokens, self.cfg)
        t = h.shape[1]
        lengths = torch.full((1,), length, dtype=torch.int32,
                             device=h.device)
        paged = {"block_tables": block_tables, "lengths": lengths,
                 "start": start, "length": length, "slot": slot}
        for i, (kind, p) in enumerate(zip(self.kinds, params["layers"])):
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
        (static mode): ``pos`` the host int position every row writes.
        Returns logits (B, V) f32; the cache is updated in place."""
        h = embed_apply(params["embed"], token[:, None], self.cfg)
        paged = None if block_tables is None else {
            "block_tables": block_tables}
        for i, (kind, p) in enumerate(zip(self.kinds, params["layers"])):
            h, _ = self._block(p, h, kind, cache=cache[i], pos=pos,
                               paged=paged, page_size=page_size)
        logits = unembed_apply(params["unembed"], params["embed"], h,
                               self.cfg)
        return logits[:, 0, :].float()


# ----------------------------------------------------------------------
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


def _expert_spec(slot: str, key: str, e: int, dtype) -> LinearSpec:
    """Expert ``e`` of a slot's stacked ``moe/{key}`` (E, in, out): get
    returns its (out, in) view; set writes the transpose into a copy of
    the stack (the reference's ``.at[e].set``), so the params it was
    handed stay as they were."""

    def get(sp):
        return sp[slot]["moe"][key][e].T

    def set_(sp, w):
        moe = dict(sp[slot]["moe"])
        stack = moe[key].clone()
        stack[e] = w.T.to(dtype)
        moe[key] = stack
        return {**sp, slot: {**sp[slot], "moe": moe}}

    return LinearSpec(name=f"{slot}.moe.{key}.{e}", get=get, set=set_)


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
