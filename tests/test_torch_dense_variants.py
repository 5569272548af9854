"""The dense decoders' attention variants in the port, on the CPU against
the JAX package: gemma-2b (head dim 256, MQA, GeGLU, embed scale, tied
head), Qwen3-14B (qk-norm) and Gemma3-12B (qk-norm, five sliding-window
``attn_local`` layers to one global) at their ``SMOKE`` sizes.

* configs field by field, and every id and alias the registry takes;
* the keyed init against the reference's (``q_norm`` / ``k_norm``
  included), and the checkpoint leaves' round trip;
* the loss on both routes (the kernel route, the trainer's
  differentiable one);
* chunked paged prefill and paged decode (f32 and int8 pages) and the
  ``ServeEngine`` streams — greedy and sampled (temperature 0.8, top-k 40,
  top-p 0.9), continuous at chunk 4 and 16, static, on a starved pool,
  with int8 pages — against the JAX engine's, on prompts of 20–40 tokens
  (gemma3-12b-smoke's window is 8: the band bites in every mode);
* MM 2:4 and SM 0.5 masks at a fixed (w, H), and one period of each
  model through the whole pruning engine, with the bounds of
  ``tests/test_torch_prune_e2e.py``;
* three trainer steps against the reference trainer's.

Tolerances:

* the init: the norm scales and biases are exact; the normals come
  through XLA's ``erf_inv`` polynomial against torch's, so they are held
  to NORMAL_ATOL of each leaf's scale (``tests/test_torch_random.py``;
  an ulp of u near ±1 moves a 4σ draw by ~1e-5 of 0.02);
* logits and losses (TOL 1e-4, ``tests/test_torch_model.py``): the same
  f32 ops, CPU BLAS in another order;
* streams: none — token for token, on the sharpened heads of
  ``tests/test_torch_serve.py``;
* the trainer: ``tests/test_torch_train.py``'s bounds.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import _flatten
from repro.configs import canonical as j_canonical
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.core.engine import PruningEngine as JEngine
from repro.core.pruner import prune_matrix as j_prune_matrix
from repro.data import DataPipeline as JPipe
from repro.data import calibration_batches
from repro.models import LM as JLM
from repro.optim import AdamW as JAdamW
from repro.optim.schedules import warmup_cosine as j_cosine
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch import configs
from repro_torch import random as rnd
from repro_torch.core.engine import PruningEngine
from repro_torch.core.masks import validate_nm
from repro_torch.core.pruner import prune_matrix
from repro_torch.data import DataPipeline
from repro_torch.models.transformer import LM
from repro_torch.optim import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import TrainConfig, Trainer

ARCHS = ("gemma_2b", "qwen3_14b", "gemma3_12b")
ALIASES = {"gemma-2b": "gemma_2b", "qwen3-14b": "qwen3_14b",
           "gemma3-12b": "gemma3_12b", "gemma3_12b": "gemma3_12b"}
NORMAL_ATOL = 2e-6
TOL = 1e-4
W_TOL = 2e-6
LOSS_ABS = 1e-4
TRAIN_REL = 5e-5
TRAIN_ENTRY_ABS = 1e-5
TRAIN_OUTLIERS = 0.001
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def partitionable():
    """One torch thread (the keyed init's normals round as the tests of
    the threefry port pin them) and the partitionable threefry."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.threefry_partitionable(True):
            yield
    finally:
        torch.set_num_threads(threads)


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for port, ref in ((configs.get_config(arch), j_get_config(arch)),
                      (configs.get_smoke(arch), j_get_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.hd == ref.hd and port.n_periods == ref.n_periods
    LM(configs.get_config(arch), device="meta")      # accepted at full width


def test_ids_and_aliases_match_reference():
    for name in (*ARCHS, *ALIASES):
        assert configs.canonical(name) == j_canonical(name)
    for alias, arch in ALIASES.items():
        assert configs.get_config(alias) is configs.get_config(arch)
    tm = LM(configs.get_config("gemma3-12b"), device="meta")
    assert tm.kinds[:6] == ["attn_local"] * 5 + ["attn"]
    assert tm.cfg.window == 1024 and tm.cfg.hd == 256


# ----------------------------------------------------------------------
# params
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _keyed(arch):
    """The reference's keyed init of the smoke model, and the port's
    model with the same leaves."""
    with jax.threefry_partitionable(True):
        jm = JLM(j_get_smoke(arch))
        jp = jax.jit(jm.init)(jax.random.key(0))
    tm = LM(configs.get_smoke(arch), device="cpu")
    return jm, jp, tm


@pytest.mark.parametrize("arch", ARCHS)
def test_keyed_init_matches_reference(arch):
    jm, jp, tm = _keyed(arch)
    want = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    got = tm.params_to_flat(tm.init(rnd.key(0)))
    assert got.keys() == want.keys()
    if jm.cfg.qk_norm:
        assert "layers/s0/attn/q_norm/scale" in got
        assert got["layers/s0/attn/k_norm/scale"].shape == (
            jm.cfg.n_periods, jm.cfg.hd)
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if path.endswith("/scale"):                  # ones: exact
            np.testing.assert_array_equal(g, w, err_msg=path)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=NORMAL_ATOL * max(1.0, np.abs(w).max()),
            err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    _, jp, tm = _keyed(arch)
    flat = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    tp = tm.params_from_jax(flat)
    assert len(tp["layers"]) == tm.cfg.num_layers
    if tm.cfg.qk_norm:
        assert set(tp["layers"][-1]["attn"]["q_norm"]) == {"scale"}
    back = tm.params_to_flat(tp)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference_on_both_routes(arch):
    """At T 37 > the window: the kernel route (``ops.attention`` with the
    band) and the trainer's (``_sdpa`` with ``causal_mask``)."""
    jm, jp, tm = _keyed(arch)
    tp = tm.params_from_jax(_flatten(jp))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, size=(2, 37)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    jl, jmet = jax.jit(jm.loss_fn)(jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for diff in (False, True):
        tl, tmet = tm.loss_fn(tp, tb, differentiable=diff)
        assert float(tl) == pytest.approx(float(jl), abs=LOSS_ABS)
        assert float(tmet["ce"]) == pytest.approx(float(jmet["ce"]),
                                                  abs=LOSS_ABS)
    # the window acts: the same model with global attention everywhere
    if jm.cfg.window is not None:
        glob = LM(dataclasses.replace(tm.cfg, window=None), device="cpu")
        tl_g, _ = glob.loss_fn(tp, tb)
        assert abs(float(tl_g) - float(jl)) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chunk", [4, 16])
def test_prefill_chunks_and_decode_match_reference(arch, chunk):
    """Two requests of 29 and 22 tokens prefilled in chunks (across page
    and chunk boundaries, the window's band spanning chunks), then decode
    steps beside an idle slot: logits within TOL.  (int8 pages round a
    row one step apart where the two BLAS part in its last bit — see
    tests/test_torch_model.py — so they are held by the streams below.)"""
    jm, jp, tm = _keyed(arch)
    tp = tm.params_from_jax(_flatten(jp))
    ps, n_pages = 4, 24
    jcache = jm.init_paged_cache(n_pages, ps)
    tcache = tm.init_paged_cache(n_pages, ps)
    prefill = jax.jit(jm.prefill_chunk, static_argnames=("page_size",))
    decode = jax.jit(jm.decode_step, static_argnames=("page_size",))
    bt = np.zeros((3, 10), np.int32)
    bt[0, :9] = [3, 1, 7, 2, 11, 12, 13, 14, 15]
    bt[1, :8] = [4, 9, 5, 16, 17, 18, 19, 20]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, size=29), rng.integers(0, 256, size=22)]
    for slot, prompt in enumerate(prompts):
        for start in range(0, len(prompt), chunk):
            c = np.zeros((1, chunk), np.int32)
            piece = prompt[start:start + chunk]
            c[0, :len(piece)] = piece
            want, jcache = prefill(
                jp, {"tokens": jnp.asarray(c)}, jcache, jnp.int32(start),
                jnp.int32(len(prompt)), jnp.int32(slot),
                jnp.asarray(bt[slot:slot + 1]), page_size=ps)
            got = tm.prefill_chunk(tp, torch.from_numpy(c), tcache, start,
                                   len(prompt),
                                   torch.from_numpy(bt[slot:slot + 1]),
                                   page_size=ps)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)
    tok = np.asarray([5, 17, 0], np.int32)
    pos = np.asarray([29, 22, -1], np.int32)
    live = pos >= 0
    for _ in range(5):
        want, jcache = decode(
            jp, jnp.asarray(tok), jcache, jnp.asarray(pos),
            paged={"block_tables": jnp.asarray(bt)}, page_size=ps)
        got = tm.decode_step(tp, torch.from_numpy(tok), tcache,
                             torch.from_numpy(pos), torch.from_numpy(bt),
                             page_size=ps)
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   rtol=TOL, atol=TOL)
        tok = np.where(live, np.asarray(want).argmax(-1), 0).astype(np.int32)
        pos = np.where(live, pos + 1, -1).astype(np.int32)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def _magnitude_24(w):
    """Keep the two largest |w| of every 4 consecutive inputs: stacked
    (L, in, out) leaves, the layout both packages store."""
    w = np.asarray(w)
    g = np.abs(w).reshape(w.shape[0], -1, 4, w.shape[2])
    drop = np.argsort(g, axis=2, kind="stable")[:, :, :2]
    keep = np.ones(g.shape, bool)
    np.put_along_axis(keep, drop, False, axis=2)
    return jnp.asarray(w * keep.reshape(w.shape))


def _pruned_pair(arch):
    """The reference's keyed init with a sharpened tied head (×8, as
    ``tests/test_torch_serve.py``) and magnitude 2:4 on every linear of
    every period slot; the port gets the same dense leaves, and each
    engine packs them itself."""
    jm, jp, tm = _keyed(arch)
    jp = jax.tree.map(lambda x: x, jp)              # a tree of its own
    jp["embed"]["tok"] = jp["embed"]["tok"] * 8.0
    for slot in jp["layers"].values():
        for sub, names in (("attn", ("wq", "wk", "wv", "wo")),
                           ("mlp", ("wi", "wg", "wo"))):
            for name in names:
                slot[sub][name] = _magnitude_24(slot[sub][name])
    return jm, jp, tm, tm.params_from_jax(_flatten(jp))


@pytest.fixture(scope="module")
def pairs():
    with jax.threefry_partitionable(True):
        return {arch: _pruned_pair(arch) for arch in ARCHS}


def _requests():
    """Six prompts of 29 tokens (past gemma3-12b-smoke's window of 8,
    ragged at chunk 4 and 16; one length, so static mode compiles one
    bucket shape) with 4–9 new tokens each."""
    rng = np.random.default_rng(5)
    return [(u, rng.integers(0, 256, size=29).astype(np.int32), m)
            for u, m in enumerate((6, 9, 4, 7, 5, 8))]


SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.9)
BASE = dict(max_batch=3, max_len=64, page_size=8)
# the JAX engine's runs: its static greedy run stands for its continuous
# and starved greedy ones (its tests/test_serve_paged.py holds them
# equal), its continuous sampled run for every chunk size and
# preemption (per-(uid, step) keys)
REFS = {"greedy": dict(mode="static"),
        "greedy_int8": dict(prefill_chunk=16, kv_dtype="int8"),
        "sampled": dict(prefill_chunk=16, **SAMPLED),
        "sampled_static": dict(mode="static", **SAMPLED)}
MODES = {                          # the port's knobs, the reference's run
    "greedy_chunk4": (dict(prefill_chunk=4), "greedy"),
    "greedy_chunk16": (dict(prefill_chunk=16), "greedy"),
    "greedy_static": (REFS["greedy"], "greedy"),
    "greedy_starved": (dict(prefill_chunk=16, num_pages=9), "greedy"),
    "greedy_int8": (REFS["greedy_int8"], "greedy_int8"),
    "sampled_chunk4": (dict(prefill_chunk=4, **SAMPLED), "sampled"),
    "sampled_static": (REFS["sampled_static"], "sampled_static"),
    "sampled_starved": (dict(prefill_chunk=16, num_pages=9,
                             host_swap_pages=0, **SAMPLED), "sampled"),
}
_REF_STREAMS = {}


def _reference_streams(pairs, arch, ref):
    if (arch, ref) not in _REF_STREAMS:
        jm, jp, _, _ = pairs[arch]
        res = JServeEngine(jm, jp, **BASE, **REFS[ref]).generate(
            [JRequest(uid=u, prompt=p, max_new_tokens=m)
             for u, p, m in _requests()], seed=7)
        _REF_STREAMS[arch, ref] = [np.asarray(r.tokens) for r in res]
    return _REF_STREAMS[arch, ref]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_streams_match_jax_engine(pairs, arch, mode):
    knobs, ref = MODES[mode]
    want = _reference_streams(pairs, arch, ref)
    _, _, tm, tp = pairs[arch]
    reqs = _requests()
    eng = ServeEngine(tm, tp, **BASE, **knobs)
    got = eng.generate(
        [Request(uid=u, prompt=p, max_new_tokens=m) for u, p, m in reqs],
        seed=7)
    for w, r, (_, _, m) in zip(want, got, reqs):
        assert len(r.tokens) == m
        np.testing.assert_array_equal(r.tokens, w)
    if "starved" in mode:
        kind = "preempt_recompute" if "sampled" in mode else "preempt_swap"
        assert eng.stats[kind] > 0
    if eng.pool is not None:
        assert eng.pool.has_kv_pages and eng.n_sparse_leaves == (
            7 * tm.cfg.num_layers)
        eng.pool.check_invariants()


def test_window_changes_gemma3_streams():
    """Served again with every layer global, gemma3-12b-smoke's greedy
    streams change (its keyed init, without the sharpened head): the
    band is what the engine serves."""
    _, jp, tm = _keyed("gemma3_12b")
    tp = tm.params_from_jax(_flatten(jp))
    reqs = [Request(uid=u, prompt=p, max_new_tokens=m)
            for u, p, m in _requests()]
    knobs = dict(BASE, prefill_chunk=16)
    band = ServeEngine(tm, tp, **knobs).generate(reqs)
    glob = LM(dataclasses.replace(tm.cfg, window=None), device="cpu")
    full = ServeEngine(glob, tp, **knobs).generate(reqs)
    assert any(not np.array_equal(a.tokens, b.tokens)
               for a, b in zip(band, full))


# ----------------------------------------------------------------------
# pruning
# ----------------------------------------------------------------------
def _period_cfg(arch):
    """One period of the smoke model: gemma-2b and Qwen3-14B one layer,
    Gemma3-12B its six (five local, one global)."""
    smoke = j_get_smoke(arch)
    return len(smoke.period) if len(smoke.period) > 1 else 1


@functools.lru_cache(maxsize=None)
def _prune_setup(arch):
    layers = _period_cfg(arch)
    with jax.threefry_partitionable(True):
        jm = JLM(dataclasses.replace(j_get_smoke(arch), num_layers=layers))
        jp = jax.jit(jm.init)(jax.random.key(0))
    tm = LM(dataclasses.replace(configs.get_smoke(arch), num_layers=layers),
            device="cpu")
    calib = calibration_batches(jm.cfg, n_samples=8, seq_len=32, batch=4)
    evals = [JPipe(jm.cfg, 8, 32, seed=0).eval_batch(i) for i in range(2)]
    seg = jm.prunable_segments()[0]
    _, caps = jax.jit(functools.partial(seg.apply, capture=True))(
        seg.get_params(jp), jm.calib_init(jp, calib[0]))
    return jm, jp, tm, calib, evals, caps


def _tb(b):
    return {k: torch.from_numpy(np.array(b[k])) for k in ("tokens", "labels")}


def _ppl(loss_fn, params, batches):
    tot = cnt = 0.0
    for b in batches:
        _, m = loss_fn(params, b)
        tot += float(m["ce"]) * float(m["tokens"])
        cnt += float(m["tokens"])
    return float(np.exp(tot / cnt))


@pytest.mark.parametrize("method,spec,name", [
    ("MM", "2:4", "s0.attn.wo"), ("SM", "0.5", "s0.mlp.wo")])
@pytest.mark.parametrize("arch", ARCHS)
def test_masks_at_fixed_w_and_h_match_reference(arch, method, spec, name):
    """Layer 0's ``attn.wo`` (its input is the windowed, qk-normed
    attention) under MM 2:4 and ``mlp.wo`` under SM 0.5, each with the
    Hessian of the reference's captured input; the port's own capture of
    every linear's input within TOL."""
    jm, jp, tm, calib, _, caps = _prune_setup(arch)
    tp = tm.params_from_jax(_flatten(jp))
    seg = tm.prunable_segments()[0]
    _, tcaps = seg.apply(seg.get_params(tp),
                         tm.calib_init(tp, _tb(calib[0])), capture=True)
    assert tcaps.keys() == caps.keys()
    for key in caps:
        np.testing.assert_allclose(tcaps[key].numpy(), np.asarray(caps[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    x = np.asarray(caps[name], np.float32).reshape(
        -1, caps[name].shape[-1])
    hmat = (2.0 * x.T @ x / x.shape[0]).astype(np.float32)
    sub, key = name.split(".")[1:]
    w = np.asarray(jp["layers"]["s0"][sub][key][0]).T           # (out, in)
    jr = j_prune_matrix(jnp.asarray(w), jnp.asarray(hmat), spec,
                        method=method, blocksize=32)
    tr = prune_matrix(torch.from_numpy(w.copy()), torch.from_numpy(hmat),
                      spec, method=method, blocksize=32)
    np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask),
                                  err_msg=name)
    want = np.asarray(jr.w)
    assert np.abs(tr.w.numpy() - want).max() <= (
        W_TOL * max(1.0, np.abs(want).max())), name
    if spec == "2:4":
        assert validate_nm(tr.mask, 2, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch):
    """MM 2:4 over one period: the port's default (pipelined) engine
    against the reference's serial one."""
    jm, jp, tm, calib, evals, _ = _prune_setup(arch)
    jpr, jrep = JEngine(jm, "2:4", method="MM", blocksize=32,
                        pipeline="off").run(jp, calib)
    tpr, trep = PruningEngine(tm, "2:4", method="MM", blocksize=32).run(
        tm.params_from_jax(_flatten(jp)), [_tb(b) for b in calib])
    assert [r.name for r in trep] == [r.name for r in jrep]
    assert len(trep) == 7 * tm.cfg.num_layers
    for tr, jr in zip(trep, jrep):
        assert tr.shape == jr.shape
        assert tr.sparsity == pytest.approx(jr.sparsity, abs=1e-6)
        assert tr.recon_error == pytest.approx(jr.recon_error, rel=1e-2,
                                               abs=1e-9)
    jl, tl = _flatten(jpr), tm.params_to_flat(tpr)
    for sub, key in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                     ("attn", "wo"), ("mlp", "wi"), ("mlp", "wg"),
                     ("mlp", "wo")):
        k = f"layers/s0/{sub}/{key}"
        a, b = np.asarray(jl[k]) == 0, tl[k] == 0
        assert (a[0] == b[0]).all(), f"{k} layer 0"
        for j in range(1, len(tm.cfg.period)):
            ks = f"layers/s{j}/{sub}/{key}"
            assert ((np.asarray(jl[ks]) == 0) == (tl[ks] == 0)).mean() \
                >= 0.98, ks
    pj = _ppl(jax.jit(jm.loss_fn), jpr, evals)
    pt = _ppl(tm.loss_fn, tpr, [_tb(b) for b in evals])
    assert np.isfinite(pt) and pt == pytest.approx(pj, rel=1e-3)


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def test_trainer_steps_match_reference(tmp_path):
    """Three steps of gemma3-12b-smoke (qk-norm and the window: the
    differentiable route's new parts) from the keyed init on the
    synthetic corpus at T 32: losses within LOSS_ABS, leaves as
    tests/test_torch_train.py holds them."""
    steps = 3
    jcfg = j_get_smoke("gemma3_12b")
    tcfg = configs.get_smoke("gemma3_12b")
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
    losses = []
    for side in ("j", "t"):
        with open(tmp_path / side / "metrics.jsonl") as f:
            losses.append([json.loads(line)["loss"] for line in f])
    assert len(losses[1]) == steps
    np.testing.assert_allclose(losses[1], losses[0], rtol=0, atol=LOSS_ABS)
    want = _flatten(jparams)
    got = tt.model.params_to_flat(tparams)
    for path in want:
        w = np.asarray(want[path], np.float32)
        g = got[path].astype(np.float32)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= TRAIN_REL, (path, err)
        assert np.sum(np.abs(g - w) > TRAIN_ENTRY_ABS) <= (
            TRAIN_OUTLIERS * w.size), path


# ----------------------------------------------------------------------
# the CLIs
# ----------------------------------------------------------------------
def _cli(tmp_path, *argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", *argv], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_serve_cli_takes_gemma3(tmp_path):
    out = _cli(tmp_path, "repro_torch.launch.serve", "--arch", "gemma3-12b",
               "--smoke", "--device", "cpu", "--magnitude-24", "--sparse",
               "--requests", "3", "--max-new", "4", "--prefill-chunk", "4")
    assert "packed 42 2:4-sparse weights" in out, out


def test_prune_cli_takes_gemma3(tmp_path):
    out = _cli(tmp_path, "repro_torch.launch.prune", "--arch", "gemma3-12b",
               "--smoke", "--device", "cpu", "--method", "MS", "--sparsity",
               "2:4", "--calib-samples", "4", "--out", str(tmp_path / "p"))
    assert os.path.isdir(tmp_path / "p" / "pruned_params"), out
