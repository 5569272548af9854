"""The port's serve stack on Mamba, the Mamba/attention hybrid and a
model with leading ``cfg.prefix`` blocks (an attention and a Mamba block
before the periods, ``PREFIX_TWIN``), on the CPU against the JAX
ServeEngine: greedy streams in static mode, in
continuous mode (multi-chunk prompts) and under a starved pool that
preempts (the reference's tests/test_serve_paged.py cases), each equal
to the JAX engine's static streams — which that file holds equal to the
JAX engine's continuous and starved ones; the state
rows' reset at admission and their in-place update; the pure-recurrent
pool without pages; and the prefix cache, which the port does not build
over recurrent state — the reference does, and its cached stream leaves
the static one (ROADMAP.md, "One fault of the reference").  The prefix
twin with a MoE prefix slot also holds its keyed init and forward
logits to the reference's (within LOGITS_TOL; a MoE model serves static,
so its streams are the twin's without experts).

Tolerance: none — greedy streams are compared token for token; the
head is sharpened (×8, as the reference's serve tests do) so that CPU
BLAS reduction order cannot flip an argmax.
"""

import jax
import numpy as np
import pytest
import torch

from repro.ckpt.store import _flatten
from repro.configs.paper_tiny_lm import MAMBA as J_MAMBA
from repro.models import LM as JLM
from repro.models.base import ArchConfig as JArchConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvpool import PagedKVPool, StatePool

LOGITS_TOL = 1e-4
HYBRID = dict(name="hybrid-serve-test", family="hybrid", num_layers=4,
              d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=256, period=("mamba", "attn"), mlp_kind="swiglu",
              ssm_mlp=True, ssm_state=4, ssm_conv=4, dtype="float32")
# leading prefix blocks: an attention and a Mamba block, then the periods
PREFIX_TWIN = dict(HYBRID, name="prefix-twin", prefix=("attn", "mamba"),
                   period=("attn",))
PREFIX_MOE = dict(num_experts=4, top_k=2, d_ff_expert=32, num_shared=1)
ARCHS = {"mamba": {f: getattr(J_MAMBA, f)
                   for f in J_MAMBA.__dataclass_fields__},
         "hybrid": HYBRID, "prefix": PREFIX_TWIN}
# the reference's engine shapes (tests/test_serve_paged.py)
MODES = {"static": dict(mode="static"),
         "continuous": dict(mode="continuous", page_size=8,
                            prefill_chunk=8),
         "starved": dict(mode="continuous", page_size=8, prefill_chunk=8,
                         num_pages=6)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs several workers on the machine's
    cores, and torch's default pool of a thread a core in each of them
    oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _requests(cls, vocab, n=8):
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=rng.integers(0, vocab, size=(4, 7, 12)[i % 3],
                                           dtype=np.int32),
                max_new_tokens=(2, 5, 9, 14)[i % 4]) for i in range(n)]


@pytest.fixture(scope="module")
def served():
    """Per arch: the port's model, the JAX model's sharpened init carried
    over, and the JAX engine's static streams."""
    out = {}
    with jax.threefry_partitionable(True):
        for arch, fields in ARCHS.items():
            jm = JLM(JArchConfig(**fields))
            jp = jax.jit(jm.init)(jax.random.key(0))
            jp["unembed"]["head"] = jp["unembed"]["head"] * 8.0
            tm = LM(ArchConfig(**fields), device="cpu")
            tp = tm.params_from_jax(_flatten(jp))
            res = JServeEngine(jm, jp, max_batch=4, max_len=48,
                               mode="static").generate(
                _requests(JRequest, jm.cfg.vocab_size))
            out[arch] = (tm, tp, [np.asarray(r.tokens) for r in res])
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_streams_match_jax_engine(served, arch, mode):
    tm, tp, streams = served[arch]
    eng = ServeEngine(tm, tp, max_batch=4, max_len=48, **MODES[mode])
    res = eng.generate(_requests(Request, tm.cfg.vocab_size))
    for got, want in zip(res, streams):
        np.testing.assert_array_equal(got.tokens, want)
    if mode == "static":
        return
    # recurrent state: recompute preemption only, and no prefix index
    assert eng.state_pool is not None and not eng._swap_ok
    assert eng.pool.prefix is None
    assert eng.stats["preempt_swap"] == 0
    if mode == "starved" and arch in ("hybrid", "prefix"):
        assert eng.stats["preempt_recompute"] > 0
        assert sum(r.preemptions for r in res) > 0
    if arch == "mamba":            # no attention: nothing pages, nothing
        assert eng.stats["preemptions"] == 0        # to preempt for
    eng.pool.check_invariants()


def test_prefix_blocks_init_and_logits_match_reference():
    """The prefix twin with its Mamba prefix block's FFN a MoE (shared
    expert included): keyed init leaf for leaf (``prefix/{i}/...``) and
    forward logits."""
    from repro.models.base import MoEConfig as JMoEConfig
    from repro_torch import random as rnd
    from repro_torch.models.base import MoEConfig

    fields = dict(PREFIX_TWIN, moe_prefix_slots=(1,))
    with jax.threefry_partitionable(True):
        jm = JLM(JArchConfig(**fields, moe=JMoEConfig(**PREFIX_MOE)))
        jp = jax.jit(jm.init)(jax.random.key(0))
        tm = LM(ArchConfig(**fields, moe=MoEConfig(**PREFIX_MOE)),
                device="cpu")
        got = tm.params_to_flat(tm.init(rnd.key(0, torch.device("cpu"))))
    want = _flatten(jp)
    assert sorted(got) == sorted(want)
    assert "prefix/1/moe/shared/wi" in got and "prefix/0/attn/wq" in got
    for path in want:
        np.testing.assert_allclose(got[path], np.asarray(want[path]),
                                   rtol=0, atol=2e-6, err_msg=path)
    assert tm.kinds == ["attn", "mamba", "attn", "attn"]
    toks = np.random.default_rng(0).integers(0, 256, (2, 12)).astype(
        np.int32)
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": toks})
    tl = tm.forward(tm.params_from_jax(want), torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)


def _stem_pair(cls):
    """Two requests on one 24-token stem (page 8: three full pages)."""
    rng = np.random.default_rng(0)
    stem = rng.integers(0, 256, 24).astype(np.int32)
    return [cls(uid=i, prompt=np.concatenate(
        [stem, rng.integers(0, 256, 5).astype(np.int32)]), max_new_tokens=8)
        for i in range(2)]


STEM_ARCH = dict(HYBRID, name="hyb-prefix", num_layers=2)


@pytest.fixture(scope="module")
def stem():
    """The 2-layer (mamba, attn) hybrid's keyed init, and the JAX
    engine's static streams of the stem pair."""
    with jax.threefry_partitionable(True):
        jm = JLM(JArchConfig(**STEM_ARCH))
        jp = jax.jit(jm.init)(jax.random.key(0))
    static = JServeEngine(jm, jp, max_batch=1, max_len=64,
                          mode="static").generate(_stem_pair(JRequest))
    return jm, jp, [r.tokens for r in static]


def test_reference_prefix_cache_skips_recurrent_state(stem):
    """The fault this port does not copy: the reference builds its prefix
    index for any model with KV pages (``repro/serve/kvpool.py:183-185``),
    starts the second request's prefill at the 24 attached tokens
    (``scheduler.py:281-313``), and its Mamba rows — reset to the init
    state at admission (``engine.py:585-586``) — never see the stem, so
    the cached stream leaves the static one.  One request at a time, so
    that the first one's pages are indexed before the second arrives."""
    jm, jp, static = stem
    eng = JServeEngine(jm, jp, max_batch=1, max_len=64, page_size=8,
                       prefill_chunk=8, prefix_cache=True)
    cached = eng.generate(_stem_pair(JRequest))
    assert eng.stats["prefix_hit_tokens"] == 24
    np.testing.assert_array_equal(cached[0].tokens, static[0])
    assert not np.array_equal(cached[1].tokens, static[1])


def test_prefix_cache_off_for_recurrent_state(stem):
    """The port's engine with the prefix cache asked for (the default):
    no index over recurrent state, 0 hits, both streams equal static —
    the port's and the JAX engine's."""
    jm, jp, jax_static = stem
    tm = LM(ArchConfig(**STEM_ARCH), device="cpu")
    tp = tm.params_from_jax(_flatten(jp))
    static = ServeEngine(tm, tp, max_batch=1, max_len=64,
                         mode="static").generate(_stem_pair(Request))
    eng = ServeEngine(tm, tp, max_batch=1, max_len=64, page_size=8,
                      prefill_chunk=8)
    assert eng.config.prefix_cache and eng.pool.prefix is None
    res = eng.generate(_stem_pair(Request))
    assert eng.stats["prefix_hit_tokens"] == 0
    assert eng.stats["prefill_tok"] == sum(len(r.prompt)
                                           for r in _stem_pair(Request))
    for got, want, ref in zip(res, static, jax_static):
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.tokens, ref)


def test_state_pool_resets_slot_rows_in_place():
    tm = LM(ArchConfig(**HYBRID), device="cpu")
    pool = PagedKVPool(tm, num_pages=4, page_size=8, max_slots=3,
                       max_len=32)
    sp = StatePool(tm, pool.kv)
    assert sp.has_state and len(sp.entries) == 2       # the Mamba layers
    leaves = [t for layer in sp.entries for t in layer.values()]
    before = [t.data_ptr() for t in leaves]
    for t in leaves:
        t.fill_(7.0)
    sp.reset_slot(1)
    for t, ptr in zip(leaves, before):
        assert t.data_ptr() == ptr                  # the same tensors
        assert bool((t[1] == 0).all()) and bool((t[[0, 2]] == 7).all())
    # attention pages are not state, and a dense model has none
    assert pool.kv[1]["k"].shape[0] == 4
    assert not StatePool(LM(ArchConfig(**{**HYBRID, "period": ("attn",)}),
                            device="cpu"), pool.kv).has_state


def test_pure_recurrent_pool_has_no_pages():
    tm = LM(ArchConfig(**ARCHS["mamba"]), device="cpu")
    pool = PagedKVPool(tm, num_pages=2, page_size=8, max_slots=2,
                       max_len=64, prefix_cache=True, host_swap_pages=8)
    assert not pool.has_kv_pages and pool.has_state
    assert pool.pages_for(1000) == 0
    assert pool.prefix is None and pool.arena is None
    assert pool.page_layers == []
    assert pool.kv[0]["ssm"].dtype == torch.float32
    assert pool.kv[0]["ssm"].shape == (2, tm.cfg.d_inner, tm.cfg.ssm_state)
    # int8 pages leave the state rows at the model dtype
    hyb = LM(ArchConfig(**HYBRID), device="cpu")
    q8 = PagedKVPool(hyb, num_pages=4, page_size=8, max_slots=2, max_len=32,
                     dtype=torch.int8)
    assert q8.kv[0]["conv"].dtype == torch.float32
    assert q8.kv[1]["k"].dtype == torch.int8 and "k_scale" in q8.kv[1]
