"""Mixture-of-Experts in the port, on the CPU against the JAX package:
phi3.5-moe (16 experts, top-2; SMOKE 4 experts), kimi-k2 (384 experts,
top-8, one shared expert; SMOKE 4 experts, top-2, the shared expert) and
Jamba with its experts at their ``SMOKE`` sizes.

* configs field by field, ids and aliases, and the full-width models
  accepted;
* the router (gates, the top-k tie order, the aux loss), capacity
  dropping with more than C tokens on one expert, an expert that gets no
  token, the shared expert — ``moe_apply`` against the reference's on
  the same inputs;
* the keyed init, the checkpoint leaves' round trip (the router stays
  f32 in a bf16 model);
* forward logits in f32 and bf16, the loss and its aux on both routes,
  dense-cache prefill + decode (the decode's n = B tokens drop at
  capacity);
* static greedy streams against the JAX ``ServeEngine`` with continuous
  asked (``mode == "static"``), the serve CLI's fall-back;
* two trainer steps against the reference trainer's.

Tolerances are ``tests/test_torch_dense_variants.py``'s: TOL 1e-4 on f32
logits and losses, NORMAL_ATOL on the keyed normals, W_TOL on weights.
bf16 is held differently, because the two frameworks round bf16 apart:
XLA fuses bf16 elementwise chains at f32 precision, torch rounds after
every op, so a dense bf16 layer already differs by an ulp in places and
a whole model by more (ROADMAP.md, Queue 3).  One MoE layer on one bf16
input must route identically (its gates come from an f32 router on the
same bf16 activations) and agree within two bf16 ulps of its largest
output.  In whole bf16 models of phi3.5 and kimi a token may change
experts only at a near tie that the router inputs' rounding explains,
and the logits agree within BF16_REL of their norm, the bound the same
models without experts meet.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import _flatten
from repro.configs import canonical as j_canonical
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.data import DataPipeline as JPipe
from repro.models import LM as JLM
from repro.models import moe as j_moe
from repro.optim import AdamW as JAdamW
from repro.optim.schedules import warmup_cosine as j_cosine
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch import configs
from repro_torch import random as rnd
from repro_torch.data import DataPipeline
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe
from repro_torch.models.layers import embed_apply, unembed_apply
from repro_torch.models.transformer import LM, _to_torch
from repro_torch.optim import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import TrainConfig, Trainer

MOE = ("phi3_5_moe_42b_a6_6b", "kimi_k2_1t_a32b")
ARCHS = (*MOE, "jamba_1_5_large_398b")
ALIASES = {"phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
           "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
           "jamba-1.5-large-398b": "jamba_1_5_large_398b"}
NORMAL_ATOL = 2e-6
TOL = 1e-4
W_TOL = 2e-6
LOSS_ABS = 1e-4
BF16_REL = 1.5e-2      # bf16 logits, of the norm: the dense twin reads
                       # 1.00e-2 (phi3.5) / 1.07e-2 (kimi), the MoE 1.21e-2
TRAIN_REL = 5e-5
TRAIN_ENTRY_ABS = 1e-5
TRAIN_OUTLIERS = 0.001


@pytest.fixture(autouse=True)
def partitionable():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.threefry_partitionable(True):
            yield
    finally:
        torch.set_num_threads(threads)


def _t(a):
    return _to_torch(np.asarray(a), "cpu")


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_configs_match_reference(arch):
    for port, ref in ((configs.get_config(arch), j_get_config(arch)),
                      (configs.get_smoke(arch), j_get_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    tm = LM(configs.get_config(arch), device="meta")    # full width
    assert all(tm.moe_slots)
    seg = tm.prunable_segments()[0]
    e = tm.cfg.moe.num_experts
    names = [lin.name for lin in seg.linears]
    assert names[4:4 + e] == [f"s0.moe.wi.{k}" for k in range(e)]
    assert names[4 + 3 * e - 1] == f"s0.moe.wo.{e - 1}"
    shared = ["s0.moe.shared.wi", "s0.moe.shared.wg", "s0.moe.shared.wo"]
    assert names[4 + 3 * e:] == (shared if tm.cfg.moe.num_shared else [])


def test_ids_and_aliases_match_reference():
    for name, arch in ALIASES.items():
        assert configs.canonical(name) == j_canonical(name) == arch
        assert configs.get_config(name) is configs.get_config(arch)


# ----------------------------------------------------------------------
# the MoE layer against the reference's on the same inputs
# ----------------------------------------------------------------------
def _layer(arch, dtype="float32", seed=3):
    cfg = dataclasses.replace(j_get_smoke(arch), dtype=dtype)
    p = j_moe.moe_init(jax.random.key(seed), cfg, jnp.dtype(dtype))
    return cfg, dataclasses.replace(configs.get_smoke(arch), dtype=dtype), p


def _apply_both(cfg, tcfg, p, h):
    def ref(p, h):
        caps = {}
        y, a = j_moe.moe_apply(p, h, cfg, caps=caps)
        return y, a, caps

    jy, ja, caps = jax.jit(ref)(p, h)
    tcaps = {}
    ty, ta = moe.moe_apply(jax.tree.map(_t, p), _t(h), tcfg, caps=tcaps)
    return (jy, ja, caps), (ty, ta, tcaps)


def test_route_matches_reference_with_ties():
    """Gates, top-k choice and aux, with rows whose probabilities tie
    (equal router columns): the lower expert index wins, as lax.top_k."""
    rng = np.random.default_rng(0)
    x2 = rng.standard_normal((40, 16)).astype(np.float32)
    w = rng.standard_normal((16, 6)).astype(np.float32)
    w[:, 4] = w[:, 1]                                # experts 1 and 4 tie
    w[:, 5] = w[:, 2]
    ref = jax.jit(j_moe._route, static_argnums=2)
    for k in (1, 2, 3):
        jg, ja = ref(jnp.asarray(x2), jnp.asarray(w), k)
        tg, ta = moe.route(torch.from_numpy(x2), torch.from_numpy(w), k)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(tg.numpy() > 0, np.asarray(jg) > 0)
        assert float(ta) == pytest.approx(float(ja), abs=1e-6)


@pytest.mark.parametrize("case", ["capacity_drop", "empty_expert", "plain"])
def test_moe_apply_matches_reference(case):
    """phi3.5 SMOKE's layer on 3 x 7 tokens.  capacity_drop: the router
    sends every token to expert 0 first (21 > C = 14 tokens); empty:
    expert 3's logit is about -64 for every token, so none reaches it."""
    cfg, tcfg, p = _layer("phi3_5_moe_42b_a6_6b")
    h = jax.random.normal(jax.random.key(4), (3, 7, 64))
    if case != "plain":            # positive activations: x·1 ≈ +64
        h = jnp.abs(h) + 1.0
        col = 0 if case == "capacity_drop" else 3
        p = dict(p, router=p["router"].at[:, col].set(
            1.0 if case == "capacity_drop" else -1.0))
    (jy, ja, jc), (ty, ta, tc) = _apply_both(cfg, tcfg, p, h)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)
    assert tc.keys() == jc.keys()
    for name, cap in jc.items():
        if isinstance(cap, tuple):
            np.testing.assert_array_equal(tc[name][1].numpy(),
                                          np.asarray(cap[1]), err_msg=name)
            cap = cap[0]
            got = tc[name][0]
        else:
            got = tc[name]
        np.testing.assert_allclose(got.numpy(), np.asarray(cap), rtol=TOL,
                                   atol=TOL, err_msg=name)
    c = moe.capacity(21, tcfg)
    assert c == 14
    valid = np.stack([np.asarray(jc[f"moe.wi.{e}"][1]) for e in range(4)])
    if case == "capacity_drop":
        gates, _ = moe.route(tc["moe.router"].reshape(-1, 64),
                             _t(p["router"]), 2)
        assert int((gates[:, 0] > 0).sum()) == 21 > c
        assert valid[0].all()                     # full: 7 tokens dropped
    if case == "empty_expert":
        assert not valid[3].any() and valid[:3].any()


def test_shared_expert_matches_reference():
    """kimi-k2 SMOKE's layer: routed experts plus the shared SwiGLU, added
    as y + (mlp(h) - h) in the reference's order; its linears captured
    under moe.shared.*."""
    cfg, tcfg, p = _layer("kimi_k2_1t_a32b")
    assert set(p["shared"]) == {"ln", "wi", "wg", "wo"}
    assert p["shared"]["wi"].shape == (64, 32)
    h = jax.random.normal(jax.random.key(5), (2, 9, 64))
    (jy, ja, jc), (ty, ta, tc) = _apply_both(cfg, tcfg, p, h)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)
    for name in ("moe.shared.wi", "moe.shared.wo", "moe.router"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_bf16_routes_alike(arch):
    """One bf16 layer on one bf16 input: the same experts and slots
    (validity), the same routed tokens, and outputs within two bf16 ulps
    of their largest magnitude."""
    cfg, tcfg, p = _layer(arch, "bfloat16")
    h = jax.random.normal(jax.random.key(6), (3, 7, 64)).astype(jnp.bfloat16)
    (jy, ja, jc), (ty, ta, tc) = _apply_both(cfg, tcfg, p, h)
    for e in range(cfg.moe.num_experts):
        np.testing.assert_array_equal(tc[f"moe.wi.{e}"][1].numpy(),
                                      np.asarray(jc[f"moe.wi.{e}"][1]))
        np.testing.assert_array_equal(
            tc[f"moe.wi.{e}"][0].float().numpy(),
            np.asarray(jc[f"moe.wi.{e}"][0], np.float32))
    assert ty.dtype == torch.bfloat16
    want = np.asarray(jy, np.float32)
    # two ulps at the output's largest magnitude: h + y cancels, so an
    # element's error follows its operands, not itself
    assert np.abs(ty.float().numpy() - want).max() <= (
        2 ** -7 * np.abs(want).max())
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
def _keyed(arch, dtype="float32"):
    return _keyed_built(arch, dtype)        # one cache key per (arch, dtype)


@functools.lru_cache(maxsize=None)
def _keyed_built(arch, dtype):
    with jax.threefry_partitionable(True):
        jm = JLM(dataclasses.replace(j_get_smoke(arch), dtype=dtype))
        jp = jax.jit(jm.init)(jax.random.key(0))
    tm = LM(dataclasses.replace(configs.get_smoke(arch), dtype=dtype),
            device="cpu")
    return jm, jp, tm


@pytest.mark.parametrize("arch", ARCHS)
def test_keyed_init_matches_reference(arch):
    jm, jp, tm = _keyed(arch)
    want = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    got = tm.params_to_flat(tm.init(rnd.key(0)))
    assert got.keys() == want.keys()
    slot = f"layers/s{jm.cfg.moe_slots[0]}/moe"
    assert got[f"{slot}/wi"].shape == (
        jm.cfg.n_periods, jm.cfg.moe.num_experts, jm.cfg.d_model,
        jm.cfg.moe.d_ff_expert)
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_allclose(
            g, w, rtol=0, atol=NORMAL_ATOL * max(1.0, np.abs(w).max()),
            err_msg=path)


@pytest.mark.parametrize("arch", MOE)
def test_params_round_trip_keeps_router_f32(arch):
    _, jp, tm = _keyed(arch, "bfloat16")
    flat = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    tp = tm.params_from_jax(flat)
    j = tm.cfg.moe_slots[0]
    assert tp["layers"][j]["moe"]["router"].dtype == torch.float32
    assert tp["layers"][j]["moe"]["wi"].dtype == torch.bfloat16
    back = tm.params_to_flat(tp)
    assert back.keys() == flat.keys()
    assert back[f"layers/s{j}/moe/router"].dtype == np.float32
    for k in flat:
        # bf16 comes back as the 2-byte void of the reference's checkpoints
        assert back[k].dtype.itemsize == flat[k].dtype.itemsize, k
        np.testing.assert_array_equal(back[k].view(np.uint8),
                                      flat[k].view(np.uint8), err_msg=k)


def _tokens(b=3, t=21, seed=1):
    return np.random.default_rng(seed).integers(0, 256, size=(b, t)).astype(
        np.int32)


def _rel_gap(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _forward_routed(jm, jp, tm, tp, toks):
    """Both bf16 forwards (logits, and the MoE layers' aux summed), and
    each MoE layer's routing held on both sides' router inputs (the
    reference's ``b{i}.s0.moe.router`` capture, the port's block by
    block) through the same f32 router: a token may pick other experts
    only where the reference's k-th and (k+1)-th router logits lie closer
    than twice the two inputs' logit difference for that token — a near
    tie that one bf16 rounding apart flips."""
    def ref(p, b):
        caps = {}
        logits, aux = jm.forward(p, b, caps=caps)
        return logits, aux, {k: v for k, v in caps.items()
                             if k.endswith(".moe.router")}

    jl, ja, jx = jax.jit(ref)(jp, {"tokens": jnp.asarray(toks)})
    h = embed_apply(tp["embed"], torch.from_numpy(toks), tm.cfg)
    tx, ta = {}, 0.0
    for i, (kind, p) in enumerate(zip(tm.kinds, tp["layers"])):
        caps = {}
        h, a = tm._block(p, h, kind, caps=caps)
        if "moe.router" in caps:
            tx[f"b{i}.s0.moe.router"] = caps["moe.router"]
            ta += float(a)
    tl = unembed_apply(tp["unembed"], tp["embed"], h, tm.cfg).float()
    assert tx.keys() == jx.keys() and jx
    k, d = tm.cfg.moe.top_k, tm.cfg.d_model
    for name, xj in jx.items():
        w = tp["layers"][int(name[1:name.index(".")])]["moe"]["router"]
        xj = _t(np.asarray(xj, np.float32)).reshape(-1, d)
        xt = tx[name].float().reshape(-1, d)
        lj, lt = xj @ w, xt @ w
        pick_j = moe.route(xj, w, k)[0] > 0
        pick_t = moe.route(xt, w, k)[0] > 0
        for n in torch.nonzero((pick_j != pick_t).any(-1)).flatten():
            top = lj[n].sort(descending=True).values
            assert top[k - 1] - top[k] <= 2 * (lj[n] - lt[n]).abs().max(), (
                name, int(n))
    return np.asarray(jl), tl.numpy(), float(ja), ta


@pytest.mark.parametrize("arch,dtype", [
    *((a, "float32") for a in ARCHS), *((a, "bfloat16") for a in MOE)])
def test_forward_logits_match_reference(arch, dtype):
    """f32 within TOL.  bf16 (phi3.5 and kimi; Jamba's bf16 Mamba blocks
    round apart already without experts, ROADMAP.md Queue 3): every MoE
    layer routes the same tokens to the same slots, and the logits agree
    within BF16_REL of their norm, as the same SMOKE without experts
    (``moe=None``, its own keyed init) does."""
    jm, jp, tm = _keyed(arch, dtype)
    tp = tm.params_from_jax(_flatten(jp))
    toks = _tokens()
    if dtype == "float32":
        jl, ja = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
        tl, ta = tm._forward(tp, torch.from_numpy(toks))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        assert float(ta) == pytest.approx(float(ja), abs=TOL)
        return
    want, got, ja, ta = _forward_routed(jm, jp, tm, tp, toks)
    dense = dataclasses.replace(jm.cfg, moe=None)
    with jax.threefry_partitionable(True):
        jd = JLM(dense)
        jdp = jax.jit(jd.init)(jax.random.key(0))
    td = LM(dataclasses.replace(tm.cfg, moe=None), device="cpu")
    dl = jax.jit(jd.forward)(jdp, {"tokens": jnp.asarray(toks)})[0]
    dense_gap = _rel_gap(
        td.forward(td.params_from_jax(_flatten(jdp)),
                   torch.from_numpy(toks)).numpy(), np.asarray(dl))
    gap = _rel_gap(got, want)
    assert dense_gap <= BF16_REL and gap <= BF16_REL, (gap, dense_gap)
    assert ta == pytest.approx(ja, rel=BF16_REL)


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_aux_match_reference_on_both_routes(arch):
    jm, jp, tm = _keyed(arch)
    tp = tm.params_from_jax(_flatten(jp))
    toks = _tokens(2, 33, 2)
    batch = {"tokens": toks, "labels": toks}
    jl, jmet = jax.jit(jm.loss_fn)(jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    assert float(jmet["aux"]) > 0
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for diff in (False, True):
        tl, tmet = tm.loss_fn(tp, tb, differentiable=diff)
        assert float(tl) == pytest.approx(float(jl), abs=LOSS_ABS)
        for key in ("ce", "aux"):
            assert float(tmet[key]) == pytest.approx(float(jmet[key]),
                                                     abs=LOSS_ABS), key


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_reference(arch):
    """Three prompts of 13 tokens into a dense cache, then 5 decode steps:
    each step routes n = 3 tokens at capacity 2 (phi3.5: 3·2/4·1.25)."""
    jm, jp, tm = _keyed(arch)
    tp = tm.params_from_jax(_flatten(jp))
    toks = _tokens(3, 13, 3)
    jcache = jm.init_cache(3, 24)
    tcache = tm.init_cache(3, 24)
    want, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                       jcache)
    got = tm.prefill(tp, torch.from_numpy(toks), tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    decode = jax.jit(jm.decode_step)
    for pos in range(13, 18):
        tok = np.asarray(want).argmax(-1).astype(np.int32)
        want, jcache = decode(jp, jnp.asarray(tok), jcache, jnp.int32(pos))
        got = tm.decode_step(tp, torch.from_numpy(tok), tcache, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def _sharpened(arch):
    """The keyed init with a sharpened head (×8, as
    tests/test_torch_serve.py), so that greedy streams have no near
    ties."""
    jm, jp, tm = _keyed(arch)
    jp = jax.tree.map(lambda x: x, jp)
    jp["embed"]["tok"] = jp["embed"]["tok"] * 8.0
    if "head" in jp["unembed"]:
        jp["unembed"]["head"] = jp["unembed"]["head"] * 8.0
    return jm, jp, tm, tm.params_from_jax(_flatten(jp))


def _requests():
    """Five prompts in two lengths (two static buckets of 3 and 2 rows;
    capacity bites in both) with 3–7 new tokens."""
    rng = np.random.default_rng(5)
    return [(u, rng.integers(0, 256, size=n).astype(np.int32), m)
            for u, (n, m) in enumerate(((11, 6), (11, 7), (11, 3), (17, 5),
                                        (17, 4)))]


@pytest.mark.parametrize("arch", MOE)
def test_static_streams_match_jax_engine(arch):
    jm, jp, tm, tp = _sharpened(arch)
    reqs = _requests()
    knobs = dict(max_batch=3, max_len=32, page_size=8, mode="continuous")
    jeng = JServeEngine(jm, jp, **knobs)
    assert jeng.mode == "static"
    want = jeng.generate([JRequest(uid=u, prompt=p, max_new_tokens=m)
                          for u, p, m in reqs])
    eng = ServeEngine(tm, tp, **knobs)
    assert eng.mode == "static" and eng.config.mode == "continuous"
    with pytest.raises(RuntimeError, match="continuous"):
        eng.session()
    got = eng.generate([Request(uid=u, prompt=p, max_new_tokens=m)
                        for u, p, m in reqs])
    for w, r, (_, _, m) in zip(want, got, reqs):
        assert len(r.tokens) == m
        np.testing.assert_array_equal(r.tokens, np.asarray(w.tokens))


def test_serve_cli_falls_back_to_static(capsys):
    launch_serve.main(["--arch", "phi3.5-moe-42b-a6.6b", "--smoke",
                       "--device", "cpu", "--magnitude-24", "--sparse",
                       "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "fell back to static" in out and "[static]" in out
    # attention and nothing else packed: phi3.5 has no shared expert
    assert "packed 8 2:4-sparse weights" in out
    with pytest.raises(SystemExit, match="static"):
        launch_serve.main(["--arch", "kimi-k2-1t-a32b", "--smoke",
                           "--device", "cpu", "--server", "--port", "0"])


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def test_trainer_steps_match_reference(tmp_path):
    """Two steps of phi3.5-moe-smoke from the keyed init: the loss with
    its aux term, and the router's and experts' gradients through the
    differentiable route."""
    steps = 2
    jcfg = j_get_smoke("phi3_5_moe_42b_a6_6b")
    tcfg = configs.get_smoke("phi3_5_moe_42b_a6_6b")
    common = dict(total_steps=steps, global_batch=4, seq_len=32,
                  ckpt_every=steps, log_every=1)
    jt = JTrainer(JLM(jcfg), JAdamW(lr=j_cosine(1e-3, 1, steps)),
                  JPipe(jcfg, 4, 32, seed=0),
                  JTrainConfig(out_dir=str(tmp_path / "j"), **common))
    tt = Trainer(LM(tcfg, device="cpu"),
                 AdamW(lr=warmup_cosine(1e-3, 1, steps)),
                 DataPipeline(tcfg, 4, 32, seed=0),
                 TrainConfig(out_dir=str(tmp_path / "t"), **common))
    jparams, _, _ = jt.run()
    tparams, _, info = tt.run()
    assert info["steps"] == steps and info["skipped_steps"] == 0
    logs = []
    for side in ("j", "t"):
        with open(tmp_path / side / "metrics.jsonl") as f:
            logs.append([json.loads(line) for line in f])
    assert len(logs[1]) == steps
    for key in ("loss", "aux"):
        np.testing.assert_allclose([r[key] for r in logs[1]],
                                   [r[key] for r in logs[0]], rtol=0,
                                   atol=LOSS_ABS, err_msg=key)
    want = _flatten(jparams)
    got = tt.model.params_to_flat(tparams)
    assert "layers/s0/moe/router" in got
    for path in want:
        w = np.asarray(want[path], np.float32)
        g = got[path].astype(np.float32)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= TRAIN_REL, (path, err)
        assert np.sum(np.abs(g - w) > TRAIN_ENTRY_ABS) <= (
            TRAIN_OUTLIERS * w.size), path
