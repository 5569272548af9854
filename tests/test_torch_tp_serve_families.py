"""Tensor-parallel serving of the recurrent and expert families in the
port, on the CPU: ``gloo`` groups of 2 ranks (mesh 1x2) and 4 ranks (2x2;
the xLSTM also on 1x4, one head a rank), spawned once for the module
(``tests/torch_dist_worker.py``'s ``_fam_cases``), held against the JAX
package on one device — the reference's own mesh tests fail on this jax
(ROADMAP.md, Standing notes).

* streams: ``paper-tiny-mamba`` (continuous, static), Jamba SMOKE's
  blocks without the experts (continuous, a starved pool that preempts by
  recompute, static), xlstm-350m SMOKE (continuous, static), and the
  MoE decoders phi3.5-moe, kimi-k2 (a shared expert) and Jamba SMOKE with
  its experts (static; phi3.5 sampled too, on 1x2), f32, magnitude-2:4
  pruned and packed — the recurrent blocks' linears too — with the head
  sharpened (×8) — token for token against the JAX ``ServeEngine``'s
  with the same requests and knobs; every rank's streams bit-equal.  On
  2x2 a MoE's two-row bucket splits over data and each data rank routes
  its row alone (the reference's shard_map token blocks), which the JAX
  engine's one-row buckets reproduce; and two twins whose recurrent
  blocks do not split and run whole on every rank (continuous): Jamba
  SMOKE's blocks at d_inner 63 beside a split attention and MLP (served
  dense: d_model 63 has no groups of 4), and the xLSTM SMOKE at 3 heads;
* logits of a dense prefill and a decode step, and for the paged
  families of a paged chunk and a decode step, against the JAX model's
  (on 2x2 a MoE's rows are routed each on its own, as its token
  blocks): LOGIT_TOL × max(1, max |ref|); every rank's logits bit-equal;
* the MoE layer itself on rows every rank holds — 30 tokens in two
  blocks of 15 on 2x2, a block boundary inside row 1; 15 tokens, which
  do not divide, routed as one — and on rows split over data, against
  the JAX layer on those blocks;
* a rank's state rows (pool, StatePool init rows, dense cache) and
  experts at the rank's widths: d_inner / tp, NH / tp heads, E / tp —
  the whole widths where the block does not split.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from repro.ckpt.store import _flatten
from repro.configs import get_smoke as j_get_smoke
from repro.configs.paper_tiny_lm import MAMBA as J_MAMBA
from repro.models import LM as JLM
from repro.models import moe as jmoe
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.dist.sharding import block_splits

LOGIT_TOL = 1e-5
MOE_TOL = 1e-5
WORLDS = (2, 4)
# the JAX leaves pruned 2:4 by magnitude (and packed by the port)
PRUNED = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("wi", "wg", "wo"),
          "mamba": ("in_proj", "x_proj", "dt_proj", "out_proj"),
          "mlstm": ("wq", "wk", "wv", "wo"),
          "slstm": ("wz", "wi", "wf", "wo_gate", "wo")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _magnitude_24(w):
    """Keep the two largest |w| of every 4 consecutive inputs of stacked
    (L, in, out) leaves."""
    w = np.asarray(w)
    g = np.abs(w).reshape(w.shape[0], -1, 4, w.shape[2])
    drop = np.argsort(g, axis=2, kind="stable")[:, :, :2]
    keep = np.ones(g.shape, bool)
    np.put_along_axis(keep, drop, False, axis=2)
    return jnp.asarray(w * keep.reshape(w.shape))


def _jax_model(name):
    arch, over = W.FAM_MODELS[name]
    cfg = (J_MAMBA if name == "mamba"
           else dataclasses.replace(j_get_smoke(arch), **over))
    jm = JLM(cfg)
    jp = jax.tree.map(lambda x: x, jax.jit(jm.init)(jax.random.key(0)))
    if "head" in jp["unembed"]:                          # sharpened head
        jp["unembed"]["head"] = jp["unembed"]["head"] * 8.0
    else:
        jp["embed"]["tok"] = jp["embed"]["tok"] * 8.0
    for slot in (jp["layers"].values() if name not in W.FAM_DENSE else ()):
        subs = [(slot[s], keys) for s, keys in PRUNED.items() if s in slot]
        if "moe" in slot and "shared" in slot["moe"]:
            subs.append((slot["moe"]["shared"], PRUNED["mlp"]))
        for node, keys in subs:
            for key in keys:
                node[key] = _magnitude_24(node[key])
    return jm, jp


def _logits(jm, jp, rows=False):
    """Dense prefill of the logit prompts and a decode step: both rows in
    one batch, or (``rows``) each row on its own."""
    toks = W.logit_prompts()
    nxt = np.asarray(W.DECODE_TOKENS, np.int32)
    parts = [slice(0, 2)] if not rows else [slice(0, 1), slice(1, 2)]
    pre, dec = [], []
    for s in parts:
        b = s.stop - s.start
        p, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks[s])},
                              jm.init_cache(b, 32))
        d, _ = jm.decode_step(jp, jnp.asarray(nxt[s]), cache,
                              W.LOGIT_TOKENS)
        pre.append(np.asarray(p))
        dec.append(np.asarray(d))
    return np.concatenate(pre), np.concatenate(dec)


def _moe_reference(jm, jp):
    """The reference's MoE layer on the worker's inputs, per world:
    rows every rank holds routed in the reference's token blocks (one
    block on 1x2; two on 2x2 where B·T divides), and a split batch's
    rows as each data rank holds them."""
    p = jax.tree.map(lambda x: x[0], jp["layers"]["s0"]["moe"])
    *rows, split = W.fam_moe_inputs()
    apply = jax.jit(lambda h: jmoe.moe_apply(p, h, jm.cfg)[0])

    def layer(h):
        return np.asarray(apply(jnp.asarray(h)))

    out = {}
    for world, dp in ((2, 1), (4, 2)):
        got = {}
        for h in rows:
            b, t, d = h.shape
            flat = h.reshape(1, b * t, d)
            k = b * t // dp if (b * t) % dp == 0 else b * t
            got[(b, t)] = np.concatenate(
                [layer(flat[:, i:i + k]) for i in range(0, b * t, k)],
                axis=1).reshape(b, t, d)
        n = split.shape[0] // dp
        got["split"] = {(i * n, (i + 1) * n): layer(split[i * n:(i + 1) * n])
                        for i in range(dp)}
        out[world] = got
    return out


@pytest.fixture(scope="module")
def fam():
    """The JAX side (each model's reference streams and logits) computed
    while the 2- and 4-rank groups serve the same leaves."""
    with jax.threefry_partitionable(True):
        models = {name: _jax_model(name) for name in W.FAM_MODELS}
        flats = {name: {k: np.asarray(v) for k, v in _flatten(jp).items()}
                 for name, (_, jp) in models.items()}
        ranks: dict = {}

        def spawn():
            try:
                ranks.update(W.run_groups(WORLDS, flats, None,
                                          timeout=900.0,
                                          cases="tp_families"))
            except BaseException as e:       # raised below, in the fixture
                ranks["error"] = e

        spawned = threading.Thread(target=spawn)
        spawned.start()
        reqs = [JRequest(uid=u, prompt=p, max_new_tokens=m)
                for u, p, m in W.tp_requests()]
        streams, logits = {}, {}
        for name, (jm, jp) in models.items():
            refs = {W.fam_ref(name, mode, world) for world in WORLDS
                    for mode in W.fam_modes(name, world)}
            for ref in sorted(refs):
                res = JServeEngine(jm, jp, **{**W.TP_BASE, **W.FAM_REFS[ref]}
                                   ).generate(reqs, seed=7)
                streams[name, ref] = [np.asarray(r.tokens) for r in res]
            logits[name] = _logits(jm, jp)
            if name in W.FAM_MOE:
                logits[name, "rows"] = _logits(jm, jp, rows=True)
        moe_layer = _moe_reference(*models["phi"])
        spawned.join()
    if "error" in ranks:
        raise ranks["error"]
    return dict(ranks=ranks, streams=streams, logits=logits,
                moe_layer=moe_layer)


_STREAM_CASES = [(world, name, mode) for world in WORLDS
                 for name in W.FAM_MODELS
                 for mode in W.fam_modes(name, world)]
_STREAM_CASES.append((4, "xlstm_1x4", "continuous"))


@pytest.mark.parametrize("case", _STREAM_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_streams_match_jax_engine(fam, case):
    world, name, mode = case
    base = name.replace("_1x4", "")
    want = fam["streams"][base, W.fam_ref(base, mode, world)]
    ranks = fam["ranks"][world]
    for r in ranks:
        got = r["streams"][name, mode]
        for w, g, (_, _, m) in zip(want, got, W.tp_requests()):
            assert len(g) == m
            np.testing.assert_array_equal(g, w)
        stats = r["stats"][name, mode]
        # recurrent state: no prefix index, recompute-only preemption
        assert stats["prefix_hit_tokens"] == 0
        assert stats["preempt_swap"] == 0
        if mode == "starved":
            assert stats["preempt_recompute"] > 0
    first = ranks[0]["streams"][name, mode]
    assert all(r["streams"][name, mode] == first for r in ranks)


_LOGIT_CASES = [(world, name) for world in WORLDS for name in W.FAM_MODELS]
_LOGIT_CASES.append((4, "xlstm_1x4"))


@pytest.mark.parametrize("case", _LOGIT_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_logits_match_jax_model(fam, case):
    world, name = case
    base = name.replace("_1x4", "")
    rows = base in W.FAM_MOE and world == 4
    pre, dec = fam["logits"][(base, "rows") if rows else base]
    want = {"prefill": pre, "decode": dec}
    if base not in W.FAM_MOE:
        want.update(prefill_paged=pre[:1], decode_paged=dec[:1])
    ranks = fam["ranks"][world]
    for r in ranks:
        got_all = r["logits"][name]
        assert sorted(got_all) == sorted(want)
        for key, w in want.items():
            got = got_all[key]
            scale = LOGIT_TOL * max(1.0, float(np.abs(w).max()))
            assert np.abs(got - w).max() <= scale, (key, np.abs(got - w).max())
            np.testing.assert_array_equal(got, ranks[0]["logits"][name][key])


@pytest.mark.parametrize("world", WORLDS)
def test_moe_layer_routes_the_reference_token_blocks(fam, world):
    want = fam["moe_layer"][world]
    ranks = fam["ranks"][world]
    for r in ranks:
        got = r["moe_layer"]
        for shape in W.FAM_MOE_ROWS:
            w = want[shape]
            scale = MOE_TOL * max(1.0, float(np.abs(w).max()))
            assert np.abs(got[shape] - w).max() <= scale, shape
            np.testing.assert_array_equal(got[shape],
                                          ranks[0]["moe_layer"][shape])
        w = want["split"][tuple(got["split_rows"])]
        scale = MOE_TOL * max(1.0, float(np.abs(w).max()))
        assert np.abs(got["split"] - w).max() <= scale
    # the ranks' data blocks cover the split batch
    assert {tuple(r["moe_layer"]["split_rows"]) for r in ranks} == set(
        want["split"])


_WIDTH_CASES = [(world, name) for world in WORLDS for name in W.FAM_MODELS]
_WIDTH_CASES.append((4, "xlstm_1x4"))


@pytest.mark.parametrize("case", _WIDTH_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_rank_holds_its_widths(fam, case):
    world, name = case
    cfg = W.fam_config(name.replace("_1x4", ""))
    tp = 4 if name.endswith("_1x4") else 2
    parts = {k: tp if block_splits(k, cfg, tp) else 1
             for k in ("mamba", "mlstm", "slstm")}
    di = cfg.d_inner // parts["mamba"]
    nh = cfg.num_heads // parts["mlstm"]
    hd_m = cfg.mlstm_proj * cfg.d_model // cfg.num_heads
    want = {"mamba": {"conv": (cfg.ssm_conv - 1, di),
                      "ssm": (di, cfg.ssm_state)},
            "mlstm": {"c": (nh, hd_m, hd_m), "n": (nh, hd_m), "m": (nh,)},
            "slstm": {k: (cfg.d_model // parts["slstm"],) for k in "cnhm"}}
    kinds = {k for k in cfg.period if k in want}
    for r in fam["ranks"][world]:
        widths = r["stats"][name, "widths"]
        assert set(widths["dense"]) == kinds
        for kind in kinds:
            assert widths["dense"][kind] == want[kind]
        if cfg.moe is None:
            for key in ("state", "init_rows"):
                assert set(widths[key]) == kinds
                for kind in kinds:
                    assert widths[key][kind] == want[kind]
            assert widths["experts"] == []
        else:
            e = cfg.moe.num_experts // tp
            assert widths["experts"] == [
                (e, cfg.d_model, cfg.moe.d_ff_expert)] * (
                cfg.n_periods * len(cfg.moe_slots))
