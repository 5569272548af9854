"""Checks shared by ``test_torch_prefix_lm.py`` (paligemma-3b) and
``test_torch_encdec.py`` (seamless-m4t-large-v2): the port's frontend
models at their ``SMOKE`` sizes against the JAX package, with the
reference's keyed init carried across (``params_from_jax``) and inputs
made by numpy from a seed.

Tolerances:

* the init: NORMAL_ATOL of each leaf's scale (``tests/test_torch_random.py``:
  XLA's ``erf_inv`` polynomial against torch's);
* f32 logits, losses and captures: TOL 1e-4 (``tests/test_torch_model.py``:
  the same f32 ops, CPU BLAS in another order); bf16 logits: BF16_REL of
  their norm (``tests/test_torch_moe.py``'s dense bound — the two
  frameworks round bf16 at other places);
* gradients: GRAD_REL of each leaf's norm, the f32 sums of the backward
  in another order;
* streams: none, token for token on a sharpened head;
* the pruning engines: ``tests/test_torch_prune_e2e.py``'s bounds — the
  first segment's masks equal (identical inputs), ≥ 98 % of every mask
  equal after it, reconstruction errors within 1e-2 and the pruned
  perplexity within 1e-3, relative.
"""

import dataclasses
import functools

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
from repro.data import DataPipeline as JPipe
from repro.data import calibration_batches
from repro.models import LM as JLM
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.sparse import sparsify_params
from repro_torch import configs
from repro_torch import random as rnd
from repro_torch.core.engine import PruningEngine
from repro_torch.data import DataPipeline
from repro_torch.models.transformer import LM, _to_torch
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sparse import compressed_param_tree

NORMAL_ATOL = 2e-6
TOL = 1e-4
BF16_REL = 1.5e-2
GRAD_REL = 1e-4
MASK_AGREE = 0.98
RECON_REL = 1e-2
PPL_REL = 1e-3


@pytest.fixture(autouse=True)
def partitionable():
    """One torch thread (the keyed init's normals round as the threefry
    port's tests pin them) and the partitionable threefry."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.threefry_partitionable(True):
            yield
    finally:
        torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def keyed(arch, dtype="float32"):
    """The reference's keyed init of the smoke model (in ``dtype``), and
    the port's model of the same config."""
    with jax.threefry_partitionable(True):
        jm = JLM(dataclasses.replace(j_get_smoke(arch), dtype=dtype))
        jp = jax.jit(jm.init)(jax.random.key(0))
    tm = LM(dataclasses.replace(configs.get_smoke(arch), dtype=dtype),
            device="cpu")
    return jm, jp, tm


@functools.lru_cache(maxsize=None)
def j_loss(arch):
    """The reference's jitted loss of the f32 smoke model, compiled once."""
    return jax.jit(keyed(arch)[0].loss_fn)


def port_params(arch, dtype="float32"):
    _, jp, tm = keyed(arch, dtype)
    return tm.params_from_jax(_flatten(jp))


def inputs(cfg, b=2, t=9, seed=0):
    """Token ids (b, t) and frontend features (b, F, fd) f32, by numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)
    feats = 0.25 * rng.standard_normal(
        (b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return toks, feats


def j_batch(toks, feats, labels=False):
    b = {"tokens": jnp.asarray(toks), "frontend_feats": jnp.asarray(feats)}
    if labels:
        b["labels"] = b["tokens"]
    return b


def t_batch(batch):
    """A reference batch (jax or numpy leaves) as torch tensors; bf16
    features bit for bit."""
    return {k: _to_torch(np.asarray(v), "cpu") for k, v in batch.items()}


def rel_gap(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ----------------------------------------------------------------------
# configs and params
# ----------------------------------------------------------------------
def check_config_and_init(arch, alias):
    for port, ref in ((configs.get_config(arch), j_get_config(arch)),
                      (configs.get_smoke(arch), j_get_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert configs.canonical(alias) == j_canonical(alias) == arch
    LM(configs.get_config(alias), device="meta")     # accepted at full width
    _, jp, tm = keyed(arch)
    want = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    got = tm.params_to_flat(tm.init(rnd.key(0)))
    assert got.keys() == want.keys()
    assert "embed/frontend_proj" in got
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_allclose(
            g, w, rtol=0, atol=NORMAL_ATOL * max(1.0, np.abs(w).max()),
            err_msg=path)
    back = tm.params_to_flat(tm.params_from_jax(want))
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
def check_forward(arch, dtype):
    jm, jp, tm = keyed(arch, dtype)
    tp = port_params(arch, dtype)
    toks, feats = inputs(jm.cfg)
    want = np.asarray(jax.jit(jm.forward)(jp, j_batch(toks, feats))[0])
    got = tm.forward(tp, torch.from_numpy(toks),
                     frontend_feats=torch.from_numpy(feats))
    off = 0 if jm.cfg.encdec else jm.cfg.frontend_len
    assert got.dtype == torch.float32
    assert got.shape == (2, off + toks.shape[1], jm.cfg.vocab_size)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    else:
        assert rel_gap(got.numpy(), want) <= BF16_REL


def check_loss_and_grads(arch):
    """The loss on both routes (text-only targets past the frontend) and
    every leaf's gradient on the differentiable one."""
    jm, jp, tm = keyed(arch)
    toks, feats = inputs(jm.cfg, t=12, seed=1)
    jb = j_batch(toks, feats, labels=True)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, jb)
    tb = t_batch(jb)
    tp = port_params(arch)
    tl, _ = tm.loss_fn(tp, tb)
    assert float(tl) == pytest.approx(float(jl), abs=TOL)
    for _, t in _named_leaves(tp):
        t.requires_grad_(True)
    tl, tmet = tm.loss_fn(tp, tb, differentiable=True)
    assert float(tl.detach()) == pytest.approx(float(jl), abs=TOL)
    assert float(tmet["tokens"]) == float(jmet["tokens"])
    tl.backward()
    got = tm.params_to_flat(_grads(tp))
    want = {k: np.asarray(v) for k, v in _flatten(jg).items()}
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert rel_gap(got[path], w) <= GRAD_REL, path


def _named_leaves(tree, prefix=""):
    """(path, tensor) of every leaf of a nested dict / list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    return tree.grad.detach()


def check_prefill_decode(arch):
    """The prompt's prefill and three decode steps against the
    reference's (``tests/test_models.py``'s check, port against JAX); the
    encoder-decoder's cached cross K / V too."""
    jm, jp, tm = keyed(arch)
    tp = port_params(arch)
    toks, feats = inputs(jm.cfg, t=10, seed=2)
    off = 0 if jm.cfg.encdec else jm.cfg.frontend_len
    max_len = off + 16
    jcache = jm.init_cache(2, max_len)
    tcache = tm.init_cache(2, max_len)
    want, jcache = jax.jit(jm.prefill)(jp, j_batch(toks[:, :7], feats),
                                       jcache)
    got = tm.prefill(tp, torch.from_numpy(toks[:, :7]), tcache,
                     frontend_feats=torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    if jm.cfg.encdec:
        for key in ("xk", "xv"):
            np.testing.assert_allclose(
                tcache[1][key].numpy(),
                np.asarray(jcache["layers"]["s0"][key][1]), rtol=TOL,
                atol=TOL, err_msg=key)
    decode = jax.jit(jm.decode_step)
    for i in range(7, 10):
        want, jcache = decode(jp, jnp.asarray(toks[:, i]), jcache,
                              jnp.int32(off + i))
        got = tm.decode_step(tp, torch.from_numpy(toks[:, i]), tcache,
                             off + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


def check_visibility(arch):
    """Who sees whom: other frontend features move the first position's
    logits (the prefix-LM's image positions attend each other; every
    decoder position attends every frame), a later text token moves no
    earlier position — each forward held against the reference's."""
    jm, jp, tm = keyed(arch)
    tp = port_params(arch)
    fwd = jax.jit(jm.forward)
    toks, feats = inputs(jm.cfg, seed=3)
    feats2 = feats.copy()
    feats2[:, -1] += 1.0                        # the last feature row
    toks2 = toks.copy()
    toks2[:, -1] = (toks2[:, -1] + 1) % jm.cfg.vocab_size
    outs = []
    for tk, ft in ((toks, feats), (toks, feats2), (toks2, feats)):
        got = tm.forward(tp, torch.from_numpy(tk),
                         frontend_feats=torch.from_numpy(ft)).numpy()
        np.testing.assert_allclose(
            got, np.asarray(fwd(jp, j_batch(tk, ft))[0]), rtol=TOL, atol=TOL)
        outs.append(got)
    base, other_feats, other_tok = outs
    assert np.abs(other_feats[:, 0] - base[:, 0]).max() > 1e-3
    np.testing.assert_array_equal(other_tok[:, :-1], base[:, :-1])
    assert np.abs(other_tok[:, -1] - base[:, -1]).max() > 1e-3


def check_pipeline_draws(arch, seq):
    """DataPipeline's batches: the same tokens and bit-equal bf16
    frontend features, the prefix-LM's text seq - frontend_len long."""
    cfg = configs.get_smoke(arch)
    jp_, tp_ = JPipe(j_get_smoke(arch), 4, seq, seed=0), \
        DataPipeline(cfg, 4, seq, seed=0)
    t_text = seq - (0 if cfg.encdec else cfg.frontend_len)
    for want, got in ((jp_.batch_at(3), tp_.batch_at(3)),
                      (jp_.calib_batch(1), tp_.calib_batch(1))):
        assert got["tokens"].shape == (4, t_text)
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        f = got["frontend_feats"]
        assert f.dtype == torch.bfloat16
        assert f.shape == (4, cfg.frontend_len, cfg.frontend_dim)
        np.testing.assert_array_equal(
            f.view(torch.int16).numpy(),
            np.asarray(want["frontend_feats"]).view(np.int16))


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


@functools.lru_cache(maxsize=None)
def pruned_pair(arch):
    """The keyed init with a sharpened head (×8, as
    ``tests/test_torch_serve.py``) and magnitude 2:4 on every linear of
    every layer stack (the encoder's too); the port gets the same dense
    leaves, and each engine packs them itself."""
    jm, jp, tm = keyed(arch)
    jp = jax.tree.map(lambda x: x, jp)              # a tree of its own
    if jm.cfg.tie_embeddings:
        jp["embed"]["tok"] = jp["embed"]["tok"] * 8.0
    else:
        jp["unembed"]["head"] = jp["unembed"]["head"] * 8.0
    stacks = list(jp["layers"].values())
    if jm.cfg.encdec:
        stacks.append(jp["enc"]["layers"])
    for stack in stacks:
        for sub in ("attn", "xattn", "mlp"):
            for name in ("wq", "wk", "wv", "wo", "wi", "wg"):
                if name in stack.get(sub, {}):
                    stack[sub][name] = _magnitude_24(stack[sub][name])
    return jm, jp, tm, tm.params_from_jax(_flatten(jp))


def _requests(cfg):
    rng = np.random.default_rng(5)
    return [(u, rng.integers(0, cfg.vocab_size, size=7).astype(np.int32), m)
            for u, m in enumerate((6, 4, 5))]


def check_static_streams(arch):
    """Greedy streams of one static bucket, each request with its own
    frontend features through ``extra_batch``, equal to the JAX
    engine's; continuous asked, static served (the reference's
    ``paged_ok``)."""
    jm, jp, tm, tp = pruned_pair(arch)
    reqs = _requests(jm.cfg)
    feats = inputs(jm.cfg, b=3, seed=6)[1]
    kw = dict(max_batch=3, max_len=48)
    want = JServeEngine(jm, jp, mode="static", **kw,
                        extra_batch={"frontend_feats": jnp.asarray(feats)}
                        ).generate([JRequest(uid=u, prompt=p,
                                             max_new_tokens=m)
                                    for u, p, m in reqs])
    eng = ServeEngine(tm, tp, **kw,
                      extra_batch={"frontend_feats": torch.from_numpy(feats)})
    assert eng.mode == "static" and eng.config.mode == "continuous"
    assert eng.pool is None
    got = eng.generate([Request(uid=u, prompt=p, max_new_tokens=m)
                        for u, p, m in reqs])
    assert eng.n_sparse_leaves > 0
    for w, g, (_, _, m) in zip(want, got, reqs):
        assert len(g.tokens) == m
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    with pytest.raises(ValueError, match="paged decode"):
        tm.init_paged_cache(8, 4)


def check_packed_leaves(arch):
    """The serve engine's packing packs the reference's leaves: the port's
    per-layer paths, stacked back, name the reference's packed set."""
    jm, jp, tm, tp = pruned_pair(arch)
    want = {"/".join(k.split("/")[:-1]) for k in _flatten(
        sparsify_params(jp)) if k.endswith("/vals")}
    period = len(jm.cfg.period)
    got = set()
    for path, _ in _named_leaves(compressed_param_tree(tp)):
        if not path.endswith("/vals"):
            continue
        parts = path.split("/")[:-1]
        if parts[0] == "layers":
            parts[1] = f"s{int(parts[1]) % period}"
        else:                                       # enc/layers/{li}/...
            del parts[2]
        got.add("/".join(parts))
    assert got == want and want


# ----------------------------------------------------------------------
# pruning
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def prune_setup(arch, seq):
    jm, jp, tm = keyed(arch)
    calib = calibration_batches(jm.cfg, n_samples=8, seq_len=seq, batch=4)
    evals = [JPipe(jm.cfg, 8, seq, seed=0).eval_batch(i) for i in range(2)]
    return jm, jp, tm, calib, evals


@functools.lru_cache(maxsize=None)
def reference_prune(arch, seq, method, spec, pipeline):
    jm, jp, _, calib, evals = prune_setup(arch, seq)
    jpr, jrep = JEngine(jm, spec, method=method, blocksize=32,
                        pipeline=pipeline).run(jp, calib)
    tot = cnt = 0.0
    for b in evals:
        _, m = j_loss(arch)(jpr, b)
        tot += float(m["ce"]) * float(m["tokens"])
        cnt += float(m["tokens"])
    return _flatten(jpr), jrep, float(np.exp(tot / cnt))


def check_engine(arch, seq, method, spec, pipeline):
    """The port's engine against the reference's in the same mode: the
    serial one against its serial one, the pipelined one against its
    pipelined one — the two modes part by design (the stacked capture
    sums each Hessian in one pass, the serial loop as a streaming mean),
    by up to 1.6 % of a linear's reconstruction error at these sizes in
    the reference itself, past the bound."""
    jm, jp, tm, calib, evals = prune_setup(arch, seq)
    jflat, jrep, jppl = reference_prune(arch, seq, method, spec, pipeline)
    tpr, trep = PruningEngine(tm, spec, method=method, blocksize=32,
                              pipeline=pipeline).run(
        tm.params_from_jax(_flatten(jp)), [t_batch(b) for b in calib])
    assert [r.name for r in trep] == [r.name for r in jrep]
    for tr, jr in zip(trep, jrep):
        assert tr.shape == jr.shape
        assert tr.sparsity == pytest.approx(jr.sparsity, abs=1e-6)
        assert tr.recon_error == pytest.approx(jr.recon_error,
                                               rel=RECON_REL, abs=1e-9)
    tflat = tm.params_to_flat(tpr)
    first = "enc/layers" if jm.cfg.encdec else "layers/s0"
    for path, w in jflat.items():
        if not any(f"/{sub}/" in path for sub in ("attn", "xattn", "mlp")) \
                or path.endswith("scale"):
            continue
        a, b = np.asarray(w) == 0, tflat[path] == 0
        assert (a[0] == b[0]).all() or not path.startswith(first), path
        assert (a == b).mean() >= MASK_AGREE, path
    tot = cnt = 0.0
    for b in evals:
        _, m = tm.loss_fn(tpr, t_batch(b))
        tot += float(m["ce"]) * float(m["tokens"])
        cnt += float(m["tokens"])
    assert float(np.exp(tot / cnt)) == pytest.approx(jppl, rel=PPL_REL)
    return tm, tpr, trep
