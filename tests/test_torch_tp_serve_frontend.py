"""Tensor-parallel serving of the prefix-LM and the encoder-decoder in
the port, on the CPU: ``gloo`` groups of 2 ranks (mesh 1x2) and 4 ranks
(2x2), spawned once for the module (``tests/torch_dist_worker.py``'s
``_front_cases``), held against the JAX package on one device — the
reference's own mesh tests fail on this jax (ROADMAP.md, Standing
notes).

* streams: paligemma-3b SMOKE (4 query heads on one KV head, kept whole;
  ``frontend_proj`` column-parallel) and seamless-m4t-large-v2 SMOKE
  (the encoder's heads, the cross-attention's and ``xk`` / ``xv`` split
  two a rank), f32, magnitude-2:4-pruned on every layer stack (the
  encoder's too) and packed, with a sharpened head — one static bucket
  of four requests, each with its own stub features through
  ``extra_batch`` (on 2x2 the bucket's rows split over data and carry
  their feature rows) — token for token against the JAX
  ``ServeEngine``'s; every rank's streams bit-equal;
* logits of a dense prefill (with the features) and a decode step
  against the JAX model's, within LOGIT_TOL × max(1, max |ref|) (the f32
  bound of tests/frontend_parity.py: the same f32 ops, CPU BLAS in
  another order); every rank's logits bit-equal, and on 1x2 each rank's
  cross K of the first decoder block at its own two KV heads of the
  reference's;
* the twin with leading prefix blocks (an attention and a Mamba block,
  tests/test_torch_mamba_serve.py's ``PREFIX_TWIN``) on 1x2, static and
  continuous, against the JAX engine's static streams;
* a rank's bytes on 1x2: under BYTES_RATIO of the whole packed tree's,
  ``frontend_proj`` a column block.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frontend_parity as fp
import torch_dist_worker as W
from repro.ckpt.store import _flatten
from repro.models import LM as JLM
from repro.models.base import ArchConfig as JArchConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine

LOGIT_TOL = 1e-4
BYTES_RATIO = 0.6
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prefix_twin():
    """The JAX prefix-block twin, its init carried over with a sharpened
    head (tests/test_torch_mamba_serve.py's)."""
    jm = JLM(JArchConfig(**W.PREFIX_TWIN))
    jp = jax.jit(jm.init)(jax.random.key(0))
    jp["unembed"]["head"] = jp["unembed"]["head"] * 8.0
    return jm, jp


def _reference(jm, jp, feats):
    """The JAX engine's static streams (``feats``: None for a model
    without a frontend) and, for a frontend model, the logits of
    ``_front_logits``' prefill and decode step and the first decoder
    block's cached cross K."""
    reqs = [JRequest(uid=u, prompt=p, max_new_tokens=m)
            for u, p, m in W.front_requests()]
    extra = ({} if feats is None
             else {"extra_batch": {"frontend_feats": jnp.asarray(feats)}})
    res = JServeEngine(jm, jp, mode="static", **W.FRONT_BASE,
                       **extra).generate(reqs)
    streams = [np.asarray(r.tokens) for r in res]
    if feats is None:
        return streams, None
    off = W.front_offset(jm.cfg)
    batch = {"tokens": jnp.asarray(W.logit_prompts()),
             "frontend_feats": jnp.asarray(W.front_feats(jm.cfg, b=2,
                                                         seed=9))}
    pre, cache = jax.jit(jm.prefill)(
        jp, batch, jm.init_cache(2, off + W.FRONT_LOGIT_LEN))
    logits = {"prefill": np.asarray(pre)}
    if jm.cfg.encdec:
        logits["xk"] = np.asarray(cache["layers"]["s0"]["xk"][0])
    dec, _ = jax.jit(jm.decode_step)(
        jp, jnp.asarray(W.DECODE_TOKENS, jnp.int32), cache,
        jnp.int32(off + W.LOGIT_TOKENS))
    logits["decode"] = np.asarray(dec)
    return streams, logits


@pytest.fixture(scope="module")
def front():
    """The JAX side computed while the 2- and 4-rank groups serve the
    same leaves."""
    with jax.threefry_partitionable(True):
        models = {arch: fp.pruned_pair(arch)[:2] for arch in W.FRONT_ARCHS}
        models["prefix"] = _prefix_twin()
        flats = {name: {k: np.asarray(v) for k, v in _flatten(jp).items()}
                 for name, (_, jp) in models.items()}
        ranks: dict = {}

        def spawn():
            try:
                ranks.update(W.run_groups(WORLDS, flats, None,
                                          timeout=900.0,
                                          cases="tp_frontend"))
            except BaseException as e:       # raised below, in the fixture
                ranks["error"] = e

        spawned = threading.Thread(target=spawn)
        spawned.start()
        refs = {}
        for name, (jm, jp) in models.items():
            feats = (None if name == "prefix"
                     else W.front_feats(jm.cfg))
            refs[name] = _reference(jm, jp, feats)
        spawned.join()
    if "error" in ranks:
        raise ranks["error"]
    return dict(ranks=ranks, refs=refs)


def _same_streams(got, want):
    for g, w, (_, _, m) in zip(got, want, W.front_requests()):
        assert len(g) == m
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", W.FRONT_ARCHS)
def test_static_streams_match_jax_engine(front, world, arch):
    want = front["refs"][arch][0]
    ranks = front["ranks"][world]
    for r in ranks:
        _same_streams(r["streams"][arch], want)
    assert all(r["streams"][arch] == ranks[0]["streams"][arch]
               for r in ranks)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", W.FRONT_ARCHS)
def test_logits_match_jax_model(front, world, arch):
    want = front["refs"][arch][1]
    ranks = front["ranks"][world]
    for r in ranks:
        got = r["logits"][arch]
        for key in ("prefill", "decode"):
            w = want[key]
            scale = LOGIT_TOL * max(1.0, float(np.abs(w).max()))
            err = np.abs(got[key] - w).max()
            assert err <= scale, (key, err)
            np.testing.assert_array_equal(got[key],
                                          ranks[0]["logits"][arch][key])
    if world == 2 and "xk" in want:
        heads = want["xk"].shape[2] // 2
        for r in ranks:
            mine = want["xk"][:, :, r["rank"] * heads:(r["rank"] + 1)
                              * heads]
            got = r["logits"][arch]["xk"]
            assert got.shape == mine.shape
            np.testing.assert_allclose(got, mine, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL)


@pytest.mark.parametrize("mode", list(W.PREFIX_MODES))
def test_prefix_blocks_match_jax_engine(front, mode):
    want = front["refs"]["prefix"][0]
    ranks = front["ranks"][2]
    for r in ranks:
        _same_streams(r["streams"]["prefix", mode], want)
    assert ranks[0]["streams"]["prefix", mode] == \
        ranks[1]["streams"]["prefix", mode]


@pytest.mark.parametrize("arch", W.FRONT_ARCHS)
def test_rank_holds_its_blocks(front, arch):
    from repro_torch import configs

    cfg = configs.get_smoke(arch)
    for r in front["ranks"][2]:
        lay = r["layout"][arch]
        assert lay["rank_bytes"] < BYTES_RATIO * lay["whole_bytes"], lay
        assert lay["frontend_proj"] == (cfg.frontend_dim, cfg.d_model // 2)


def test_prefix_twin_config_is_the_mamba_serve_twin():
    """The worker's copy of the twin is test_torch_mamba_serve's."""
    from test_torch_mamba_serve import PREFIX_TWIN

    assert W.PREFIX_TWIN == PREFIX_TWIN
    assert dataclasses.asdict(JArchConfig(**W.PREFIX_TWIN))["prefix"] == (
        "attn", "mamba")
